"""qwen3-8b [dense]: GQA + qk_norm. [hf:Qwen/Qwen3-8B]

36L, d_model=4096, 32H (GQA kv=8), d_ff=12288, vocab=151936, head_dim=128,
qk-norm, SwiGLU, RMSNorm. long_500k via sliding-window override.
"""
from repro_torch.configs.base import ArchConfig, TrainConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)

# the reference also names model_parallel=8: the port runs on one device
TRAIN = TrainConfig(num_agents=16, num_walks=4, tau=0.1, rho=20.0)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-smoke", family="dense", source=CONFIG.source,
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, qk_norm=True)
