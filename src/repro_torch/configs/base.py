"""Architecture + run configuration (copy of `repro/configs/base.py`).

`ArchConfig` and `ShapeConfig` (with the four assigned `INPUT_SHAPES`)
are the reference's schema field for field, so a config written for one
package reads the same in the other. `TrainConfig` keeps
only the fields the port's single-process trainer reads; the mesh-only
fields (model_parallel, store_copy_sum, zero_shard_tokens,
microbatch_per_agent) and the baseline's learning_rate come with the
code that reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01   # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|encdec|vlm|audio
    source: str                     # citation for the config
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads

    # layer stack: None => all 'attn' ('moe' if moe config set)
    layer_types: Optional[Tuple[str, ...]] = None

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    attn_window: int = 0            # 0 = full causal; >0 = sliding window
    long_context_window: int = 8192

    # MLP
    mlp_type: str = "swiglu"        # swiglu | gelu | sq_relu
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    # rwkv6
    rwkv_head_dim: int = 64

    # rg-lru (recurrentgemma)
    rnn_width: int = 0              # lru hidden width (0 => d_model)
    conv_width: int = 4

    # encoder-decoder (whisper): decoder uses the main fields
    encoder_layers: int = 0
    encoder_seq: int = 0
    frontend: str = "none"          # 'none' | 'audio' | 'vision'
    num_patches: int = 0

    # training
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.layer_types is None:
            kind = "moe" if self.moe is not None else "attn"
            object.__setattr__(self, "layer_types",
                               tuple([kind] * self.num_layers))
        if len(self.layer_types) != self.num_layers:
            raise ValueError(f"{self.name}: {len(self.layer_types)} layer "
                             f"types for {self.num_layers} layers")

    @property
    def supports_long_context(self) -> bool:
        """True if decode at 500k is feasible: recurrent state or windowed
        attention (native or via long_context_window override)."""
        if self.family in ("encdec", "audio"):
            return False            # whisper decoder: short trained context
        return True                 # ssm/hybrid native; attention via window


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """API-BCD decentralized training hyper-parameters."""
    num_agents: int = 16            # A: agents on the ring
    num_walks: int = 4              # M tokens
    tau: float = 0.1                # penalty parameter
    rho: float = 20.0               # gAPI-BCD proximal parameter
    accumulate_between_visits: bool = True   # beyond-paper: no idle agents
