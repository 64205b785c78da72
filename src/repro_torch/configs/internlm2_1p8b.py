"""internlm2-1.8b [dense]: GQA. [arXiv:2403.17297]

24L, d_model=2048, 16H (GQA kv=8), d_ff=8192, vocab=92544.
"""
from repro_torch.configs.base import ArchConfig, TrainConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    source="arXiv:2403.17297",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1e6,
)

# the reference also names model_parallel=2: the port runs on one device
TRAIN = TrainConfig(num_agents=16, num_walks=4, tau=0.1, rho=20.0)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="internlm2-smoke", family="dense", source=CONFIG.source,
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512)
