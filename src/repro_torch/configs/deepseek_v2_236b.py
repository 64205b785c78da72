"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + fine-grained MoE.
[arXiv:2405.04434]

60L, d_model=5120, 128H (MLA), per-expert d_ff=1536, vocab=102400,
160 routed experts top-6 + 2 shared. As in the reference, DeepSeek-V2's
first dense layer is modelled as MoE like the rest (one uniform stack);
MLA decode uses the absorbed latent formulation.

Agent grouping: G=8 data indices per agent, M=2 walks, bf16 params. One
layer is 3.97 B parameters (MLA 149 M, routed experts 3.78 B, shared
experts 47 M; 7.94 GB in bf16), so one 80 GB card holds 4 of the 60
layers at full width beside the 1.05 B embedding and head (16.94 B, 33.9
GB).
"""
from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      TrainConfig)

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                  d_ff_expert=1536, capacity_factor=1.25),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    param_dtype="bfloat16",
)

# paper-faithful mode (no gradient-accumulation buffer), as the reference;
# the reference also names model_parallel=16: the port runs on one device
TRAIN = TrainConfig(num_agents=2, num_walks=2, tau=0.1, rho=20.0,
                    accumulate_between_visits=False)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-smoke", family="moe", source=CONFIG.source,
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                      d_ff_expert=64),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32))
