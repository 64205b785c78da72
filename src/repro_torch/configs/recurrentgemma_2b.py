"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 LRU.
[arXiv:2402.19427]

26L, d_model=2560, 10H (MQA kv=1), d_ff=7680, vocab=256000, local window
2048. Runs long_500k natively (recurrent state + bounded window).
Layer pattern: (rglru, rglru, attn) repeating -> attn at indices 2,5,...
"""
from repro_torch.configs.base import ArchConfig, TrainConfig

_TYPES = tuple("attn" if i % 3 == 2 else "rglru" for i in range(26))

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_types=_TYPES,
    attn_window=2048,
    mlp_type="gelu",
    rnn_width=2560,
    conv_width=4,
)

# the reference also names model_parallel=2: the port runs on one device
TRAIN = TrainConfig(num_agents=16, num_walks=4, tau=0.1, rho=20.0)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-smoke", family="hybrid", source=CONFIG.source,
        num_layers=3, d_model=128, num_heads=2, num_kv_heads=1, head_dim=64,
        d_ff=256, vocab_size=512, layer_types=("rglru", "rglru", "attn"),
        attn_window=32, mlp_type="gelu", rnn_width=128, conv_width=4)
