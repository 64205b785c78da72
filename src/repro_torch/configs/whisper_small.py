"""whisper-small [audio]: enc-dec, conv frontend stubbed. [arXiv:2212.04356]

12L decoder (+12L encoder), d_model=768, 12H (kv=12), d_ff=3072,
vocab=51865, LayerNorm + GeLU. Frontend stub: the batch carries 1500
precomputed frame embeddings (the conv/mel stack is out of scope, as in
the reference).
"""
from repro_torch.configs.base import ArchConfig, TrainConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    encoder_layers=12,
    encoder_seq=1500,
    frontend="audio",
)

# the reference also names model_parallel=1: the port runs on one device
TRAIN = TrainConfig(num_agents=16, num_walks=4, tau=0.1, rho=20.0)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-small-smoke", family="audio", source=CONFIG.source,
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=512, mlp_type="gelu", norm_type="layernorm",
        encoder_layers=2, encoder_seq=16, frontend="audio")
