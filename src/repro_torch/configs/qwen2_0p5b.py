"""qwen2-0.5b [dense]: GQA with QKV bias. [arXiv:2407.10671]

24L, d_model=896, 14H (GQA kv=2), d_ff=4864, vocab=151936, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, TrainConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
)

# the reference also names model_parallel=1: the port runs on one device
TRAIN = TrainConfig(num_agents=16, num_walks=4, tau=0.1, rho=20.0)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-smoke", family="dense", source=CONFIG.source,
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, qkv_bias=True, tie_embeddings=True)
