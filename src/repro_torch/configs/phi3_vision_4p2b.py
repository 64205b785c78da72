"""phi-3-vision-4.2b [vlm]: phi3-mini LM backbone + CLIP frontend (stubbed).
[hf:microsoft/Phi-3-vision-128k-instruct]

32L, d_model=3072, 32H (kv=32), head_dim=96, d_ff=8192, vocab=32064. The
ViT and projector are a stub, as in the reference: the batch carries 1024
patch embeddings as a prefix, and the LM consumes [patches; text].
"""
from repro_torch.configs.base import ArchConfig, TrainConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision",
    num_patches=1024,
)

# the reference also names model_parallel=4: the port runs on one device
TRAIN = TrainConfig(num_agents=16, num_walks=4, tau=0.1, rho=20.0)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi3-vision-smoke", family="vlm", source=CONFIG.source,
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, frontend="vision", num_patches=8)
