"""Single-query attention over merged-head K/V (K2).

Counterpart of ``multimodal_audio_search_tpu/ops/cross_attention.py::
fused_single_query_attention``. It serves both attentions of a decode
step: cross attention over the encoder K/V (``pos=None``: every key) and
causal self attention over the KV cache (``pos``: keys 0..pos). K/V stay
in the merged [B, T, H*D] layout the k/v dense layers emit.

On a CUDA tensor the wrapper launches ``csrc/cross_attention.cu``; on a
CPU tensor it runs ``single_query_attention_plain``. The int8 variants
(``cross_attn="int8"``/``"int8_fused"``) are not ported (ROADMAP B6, B7).
"""
from __future__ import annotations

import math

import torch

from .. import runtime


def merge_heads_kv(k: torch.Tensor, v: torch.Tensor):
    """[B, H, T, D] -> ([B, T, H*D], [B, T, H*D]) merged-head layout."""
    def m(x):
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)
    return m(k), m(v)


def single_query_attention_plain(q_m, k_m, v_m, *, heads: int, pos=None):
    """Plain-PyTorch twin: f32 softmax attention of one query row per
    (batch, head); keys after ``pos`` masked. Returns [B, H*D] f32."""
    b, hd = q_m.shape
    t = k_m.shape[1]
    d = hd // heads
    q = q_m.reshape(b, heads, d).float()
    k = k_m.reshape(b, t, heads, d).float()
    v = v_m.reshape(b, t, heads, d).float()
    logits = torch.einsum("bhd,bthd->bht", q, k) / math.sqrt(d)
    if pos is not None:
        valid = torch.arange(t, device=q_m.device) <= int(pos)
        logits = logits.masked_fill(~valid[None, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bthd->bhd", p, v).reshape(b, hd)


def _launch(q_m, k_m, v_m, heads: int, n_valid: int) -> torch.Tensor:
    b, hd = q_m.shape
    t = k_m.shape[1]
    if hd != heads * 64:
        raise ValueError(f"K2 takes head dim 64: H*D={hd}, heads={heads}")
    if tuple(k_m.shape) != (b, t, hd) or tuple(v_m.shape) != (b, t, hd):
        raise ValueError(
            f"K2: q {tuple(q_m.shape)}, k {tuple(k_m.shape)}, "
            f"v {tuple(v_m.shape)}")
    for name, a in (("q", q_m), ("k", k_m), ("v", v_m)):
        if a.dtype != torch.bfloat16:
            raise TypeError(f"K2 takes bf16 tensors; {name} is {a.dtype}")
        if a.device != k_m.device:
            raise ValueError(f"K2: {name} on {a.device}, k on {k_m.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"K2 takes contiguous 16-byte aligned {name}")
    out = torch.empty((b, hd), dtype=torch.float32, device=k_m.device)
    lib = runtime.kernels()
    rc = lib.mas_single_query_attention(
        q_m.data_ptr(), k_m.data_ptr(), v_m.data_ptr(), out.data_ptr(),
        b, heads, t, hd, n_valid, 1.0 / math.sqrt(hd // heads),
        runtime.stream_handle(k_m.device))
    runtime.check_launch(rc, "mas_single_query_attention")
    runtime.bump("single_query_attention")
    return out


def fused_single_query_attention(
    q_m: torch.Tensor,    # [B, H*D] merged-head queries
    k_m: torch.Tensor,    # [B, T, H*D] merged-head keys
    v_m: torch.Tensor,    # [B, T, H*D] merged-head values
    *,
    heads: int,
    pos: int | None = None,   # attend to keys [0, pos]; None = all
) -> torch.Tensor:            # [B, H*D] f32
    """One single-query attention over a merged-head K/V buffer. ``pos``
    is a host int (the decode loop's step), passed to the kernel as an
    argument. CUDA tensors launch K2, CPU tensors take the plain twin."""
    t = k_m.shape[1]
    if pos is not None and not 0 <= int(pos) < t:
        raise ValueError(f"pos {pos} outside [0, {t})")
    if k_m.device.type == "cuda":
        n_valid = t if pos is None else int(pos) + 1
        return _launch(q_m, k_m, v_m, heads, n_valid)
    if k_m.device.type == "cpu":
        return single_query_attention_plain(q_m, k_m, v_m, heads=heads,
                                            pos=pos)
    raise ValueError(f"unsupported device {k_m.device}")
