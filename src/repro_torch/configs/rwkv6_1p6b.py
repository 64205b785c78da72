"""rwkv6-1.6b [ssm]: Finch — attention-free, data-dependent decay.
[arXiv:2404.05892]

24L, d_model=2048, d_ff=7168 (channel mix), vocab=65536. Runs long_500k
natively (O(1) recurrent state).
"""
from repro_torch.configs.base import ArchConfig, TrainConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # 2048 / 64 wkv heads
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    layer_types=tuple(["rwkv"] * 24),
    rwkv_head_dim=64,
)

# the reference also names model_parallel=2: the port runs on one device
TRAIN = TrainConfig(num_agents=16, num_walks=4, tau=0.1, rho=20.0)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-smoke", family="ssm", source=CONFIG.source,
        num_layers=2, d_model=128, num_heads=2, num_kv_heads=2, d_ff=256,
        vocab_size=512, layer_types=("rwkv", "rwkv"), rwkv_head_dim=64)
