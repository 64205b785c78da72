"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP. [arXiv:2402.16819]

32L, d_model=6144, 48H (GQA kv=8), d_ff=24576, vocab=256000.
Agent grouping G=2 (15B replica + 4 working copies exceed 16-chip HBM).
Parameters are bf16 (`param_dtype`): ~15.6 B of them, ~31 GB, which the
serving engine uses as they are (its compute-dtype cast copies nothing).
"""
from repro_torch.configs.base import ArchConfig, TrainConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="sq_relu",
    param_dtype="bfloat16",
)

# the reference also names model_parallel=8: the port runs on one device
TRAIN = TrainConfig(num_agents=8, num_walks=4, tau=0.1, rho=20.0)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="nemotron-smoke", family="dense", source=CONFIG.source,
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, mlp_type="sq_relu")
