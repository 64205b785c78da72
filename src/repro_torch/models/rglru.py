"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

A port of `repro/models/rglru.py`. Block structure (the Griffin
"recurrent block"):
    x -> [branch A: W_x -> causal conv1d (width 4) -> RG-LRU]
      -> [branch B: W_y -> GeLU]
      -> A * B -> W_out

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a xhat_t + b_a)           (recurrence gate)
    i_t = sigmoid(W_i xhat_t + b_i)           (input gate)
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * xhat_t)

The reference scans over time with `lax.scan`; the port runs the gates,
the decay and the recurrence from the two gate products on through
`kernels.ops.rglru_scan` (one CUDA kernel on the card, its plain version
`ref.rglru_gated` on the CPU), from the slot's `h`, which it advances in
place. With no state (training, from the reference's zero `init_state`)
the block takes `ops.rglru_scan_train`, whose backward is the RG-LRU
backward kernel, and writes no state. Every step keeps the reference's
order of ops and of roundings in
the compute dtype: the gates and `i * xhat` in the compute dtype, the
decay and the scale in f32, the conv as the taps' sum from 0 in order,
then the bias.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _he

LEAVES = ("conv", "h")


def rglru_init(generator, lead, cfg, dtype):
    """Block parameters with leading dims `lead` (the stacked layer axis),
    with the reference's shapes and scales (He-scaled projections, conv
    taps x0.1, zero biases, Lambda 1)."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    cw = cfg.conv_width
    dev = generator.device
    return {
        "w_x": _he(generator, lead + (d, w), dtype, d),
        "w_y": _he(generator, lead + (d, w), dtype, d),
        "conv_kernel": (torch.randn(lead + (cw, w), generator=generator,
                                    device=dev) * 0.1).to(dtype),
        "conv_bias": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "w_a": _he(generator, lead + (w, w), dtype, w),
        "b_a": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "w_i": _he(generator, lead + (w, w), dtype, w),
        "b_i": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "lamb": torch.full(lead + (w,), 1.0, dtype=dtype, device=dev),
        "w_out": _he(generator, lead + (w, d), dtype, w),
    }


def init_state(cfg, batch, lead=(), device=None, parts=1):
    """Zero recurrent state in f32: {"conv": [*lead, B, cw - 1, W] (the
    last inputs of the conv), "h": [*lead, B, W / parts]} (parts: a model
    axis's size, whose rank holds its channels of h and the whole conv
    state)."""
    w = cfg.rnn_width or cfg.d_model
    f32 = torch.float32
    return {"conv": torch.zeros(lead + (batch, cfg.conv_width - 1, w),
                                dtype=f32, device=device),
            "h": torch.zeros(lead + (batch, w // parts), dtype=f32,
                             device=device)}


def _causal_conv(params, x, conv_state):
    """x: [B,S,W]; conv_state: [B,cw-1,W] (the previous inputs). Returns
    (out [B,S,W] in x's dtype, the new conv state: the last cw - 1 inputs,
    previous ones included where S < cw - 1)."""
    kernel = params["conv_kernel"]
    cw, s = kernel.shape[0], x.shape[1]
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = 0
    for i in range(cw):     # Python's sum: 0 + t_0 + t_1 + ... in order
        out = out + full[:, i:i + s] * kernel[cw - 1 - i]
    return out + params["conv_bias"], full[:, -(cw - 1):]


def rglru_block(params, cfg, x, state, axis=None):
    """x: [B,S,D]; state: {"conv", "h"} of `init_state`'s leaves at batch B
    -> (out [B,S,D], state). `state["h"]` advances in place through the
    scan and the new conv inputs are copied into `state["conv"]`. state
    None (training): from zeros, through the differentiable
    `ops.rglru_scan_train`, returning (out, None).

    axis: a `dist.tensor_parallel.ModelAxis` whose rank holds its W_r
    channels (`w_a` [W, W_r] gives their count): `w_x` and the conv run
    whole, the gates are the rank's columns of the products of the
    conv's whole output, the scan takes the rank's W_r channels of it
    (from the axis index times W_r), and `w_out`'s partial products are
    summed over the axis."""
    xa = x @ params["w_x"]
    conv_in = (xa.new_zeros((xa.shape[0], params["conv_kernel"].shape[0] - 1,
                             xa.shape[2]))
               if state is None else state["conv"])
    xa, conv_state = _causal_conv(params, xa, conv_in)
    mine = xa
    if axis is not None:
        w_r = params["w_a"].shape[-1]
        mine = xa[..., axis.index * w_r:(axis.index + 1) * w_r]

    # the gates, the decay and the recurrence: one kernel after the GEMMs
    gates = (xa @ params["w_a"], xa @ params["w_i"], params["b_a"],
             params["b_i"], params["lamb"], mine)
    if state is None:
        h_seq = ops.rglru_scan_train(*gates)
    else:
        h_seq, _ = ops.rglru_scan(*gates, state["h"])

    yb = F.gelu(x @ params["w_y"], approximate="tanh")
    out = h_seq * yb
    out = (out @ params["w_out"] if axis is None
           else axis.row_sum(out, params["w_out"]))
    if state is None:
        return out, None
    state["conv"].copy_(conv_state)
    return out, state
