"""dbrx-132b [moe]: 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]

40L, d_model=6144, 48H (GQA kv=8), per-expert d_ff=10752, vocab=100352.
Agent grouping G=8, M=2 walks, bf16 params (132B replica). One layer is
3.26 B parameters (6.52 GB in bf16), so one 80 GB card holds 4 of the 40
layers at full width beside the embedding and head.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, TrainConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    moe=MoEConfig(num_experts=16, top_k=4, num_shared_experts=0,
                  d_ff_expert=10752, capacity_factor=1.25),
    param_dtype="bfloat16",
)

# the reference also names model_parallel=8: the port runs on one device
TRAIN = TrainConfig(num_agents=2, num_walks=2, tau=0.1, rho=20.0)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="dbrx-smoke", family="moe", source=CONFIG.source,
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=0,
                      d_ff_expert=128))
