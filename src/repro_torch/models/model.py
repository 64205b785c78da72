"""Model dispatch: build (init, train_loss) per config.

Only the dense decoder-only family is ported; the others raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable           # (generator) -> params dict
    train_loss: Callable     # (params, batch) -> (loss, metrics)


def _check_ported(cfg: ArchConfig):
    unported = []
    if cfg.family != "dense":
        unported.append(f"family {cfg.family!r}")
    if set(cfg.layer_types) != {"attn"}:
        unported.append(f"layer types {sorted(set(cfg.layer_types))}")
    if cfg.qk_norm:
        unported.append("qk_norm")
    if cfg.norm_type != "rmsnorm":
        unported.append(f"norm {cfg.norm_type!r}")
    if cfg.mlp_type != "swiglu":
        unported.append(f"mlp {cfg.mlp_type!r}")
    if unported:
        raise NotImplementedError(f"{cfg.name}: not ported to repro_torch "
                                  f"yet: {', '.join(unported)}")


def build_model(cfg: ArchConfig) -> Model:
    _check_ported(cfg)
    return Model(
        cfg=cfg,
        init=lambda generator: TF.transformer_init(cfg, generator),
        train_loss=lambda p, b: TF.train_loss(cfg, p, b),
    )
