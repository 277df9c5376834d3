"""Encoder attention over all heads + o-projection + residual (K1).

Counterpart of ``multimodal_audio_search_tpu/ops/encoder_block.py::
fused_attention_o_residual`` (its default bf16 body). On a CUDA tensor
the wrapper launches the hand-written kernel ``csrc/encoder_block.cu``;
on a CPU tensor it runs ``attention_o_residual_plain``, the same math in
plain PyTorch. There is no other route: a launch that fails raises.

The int8 and head-paired variants of the TPU kernel
(``fused_encoder="int8"`` / ``"paired"``) are not ported (ROADMAP B1).
"""
from __future__ import annotations

import math

import torch

from .. import runtime


def attention_o_residual_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,  # [B, H, T, D]
    x: torch.Tensor,                                     # [B, T, H*D]
    wo: torch.Tensor, bo: torch.Tensor,                 # [H*D, H*D], [H*D]
) -> torch.Tensor:
    """x + (softmax(QK^T/sqrt(D)) V, heads merged) @ Wo + bo in plain
    PyTorch: f32 scores, softmax and products on the given inputs; the
    merged attention output is rounded to Wo's dtype before the
    o-projection and the sum to x's dtype, as the TPU kernel rounds."""
    b, h, t, d = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, v.float())                        # [B, H, T, D]
    attn = o.transpose(1, 2).reshape(b, t, h * d).to(wo.dtype)
    y = torch.matmul(attn.float(), wo.float()) + bo.float()
    return (x.float() + y).to(x.dtype)


def _launch(q, k, v, x, wo, bo) -> torch.Tensor:
    b, h, t, d = q.shape
    hd = x.shape[-1]
    if d != 64:
        raise ValueError(f"K1 takes head dim 64, got {d}")
    if h * d != hd or tuple(wo.shape) != (hd, hd) or \
            tuple(bo.shape) != (hd,):
        raise ValueError(
            f"K1 takes a square o-projection: q {tuple(q.shape)}, "
            f"x {tuple(x.shape)}, wo {tuple(wo.shape)}, bo {tuple(bo.shape)}")
    if hd % 64:
        raise ValueError(f"K1 takes H*D a multiple of 64, got {hd}")
    for name, a in (("q", q), ("k", k), ("v", v), ("x", x), ("wo", wo),
                    ("bo", bo)):
        if a.dtype != torch.bfloat16:
            raise TypeError(f"K1 takes bf16 tensors; {name} is {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"K1: {name} on {a.device}, x on {x.device}")
    if q.stride() != k.stride() or q.stride() != v.stride():
        raise ValueError("K1 takes q, k, v views with equal strides")
    sb, sh, st, sd = q.stride()
    if sd != 1 or sb % 8 or sh % 8 or st % 8:
        raise ValueError(
            f"K1 needs a unit last stride and 16-byte aligned rows; "
            f"strides {q.stride()}")
    for name, a in (("x", x), ("wo", wo), ("bo", bo)):
        if not a.is_contiguous():
            raise ValueError(f"K1 takes a contiguous {name}")
    # the kernel reads q/k/v/wo rows with 16-byte loads, x and bo with
    # 4-byte loads
    for name, a, align in (("q", q, 16), ("k", k, 16), ("v", v, 16),
                           ("wo", wo, 16), ("x", x, 4), ("bo", bo, 4)):
        if a.data_ptr() % align:
            raise ValueError(f"K1: {name} is not {align}-byte aligned")
    out = torch.empty_like(x)
    lib = runtime.kernels()
    rc = lib.mas_attn_o_residual(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sh, st,
        x.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr(),
        b, h, t, hd, math.log2(math.e) / math.sqrt(d),
        runtime.stream_handle(x.device))
    runtime.check_launch(rc, "mas_attn_o_residual")
    runtime.bump("encoder_attn_o_residual")
    return out


def fused_attention_o_residual(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    x: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
) -> torch.Tensor:
    """x + (softmax(QK^T/sqrt(D)) V merged over heads) @ Wo + bo.

    Non-causal; f32 softmax and accumulation. q/k/v are [B, H, T, D]
    (any strides with a unit last one, e.g. the head-split views of the
    q/k/v dense outputs); x is [B, T, H*D]; output [B, T, H*D] in x's
    dtype. CUDA tensors launch K1, CPU tensors take the plain version."""
    if x.device.type == "cuda":
        return _launch(q, k, v, x, wo, bo)
    if x.device.type == "cpu":
        return attention_o_residual_plain(q, k, v, x, wo, bo)
    raise ValueError(f"unsupported device {x.device}")
