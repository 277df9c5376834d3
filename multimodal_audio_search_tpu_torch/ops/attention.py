"""Per-(batch, head) encoder self-attention without the o-projection (K8).

Counterpart of ``multimodal_audio_search_tpu/ops/attention.py::
fused_encoder_attention`` (B9), which the JAX encoder runs on a TPU for
``fused_encoder=False`` at T >= 512; the o-projection after it stays a
plain matmul, as JAX leaves it to XLA. On a CUDA tensor the wrapper
launches ``csrc/encoder_attention.cu``'s ``encoder_attention_kernel``
(wgmma products on TMA-fed shared-memory tiles; on float32 tensors its
float32 form, ``csrc/tf32x3.cuh``'s loop: each float32 product as three
TF32 products on the tensor cores, float32-class results); on a CPU
tensor it runs ``encoder_attention_plain``, the same math in plain
PyTorch. There is no other route: a launch that fails, or a view TMA
cannot describe, raises.
"""
from __future__ import annotations

import math

import torch

from .. import runtime


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """softmax(QK^T/sqrt(D)) V for [B, H, T, D] inputs, non-causal, with
    the TPU kernel's roundings: f32 scores, p = exp(s - max) unnormalised
    and cast to V's dtype before the PV product, /l on the [T, D] output,
    the result in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


_SCALE_LOG2 = math.log2(math.e) / math.sqrt(64)
# K8's forms by input dtype (csrc/encoder_attention.cu) and the scale each
# takes: the float32 one, 3xTF32 on the tensor cores, serves a float32
# encode on the card, as the TPU kernel takes either dtype
_FORMS = {torch.bfloat16: ("mas_encoder_attention", _SCALE_LOG2),
          torch.float32: ("mas_encoder_attention_f32", 1.0 / math.sqrt(64))}


def _launch(q, k, v) -> torch.Tensor:
    b, h, t, d = q.shape
    dt = q.dtype
    if d != 64:
        raise ValueError(f"K8 takes head dim 64, got {d}")
    if dt not in _FORMS or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"K8 takes bf16 or float32 tensors of one dtype; "
                        f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev or k.shape != q.shape \
            or v.shape != q.shape:
        raise ValueError(f"K8: q {tuple(q.shape)} on {dev}, k "
                         f"{tuple(k.shape)} on {k.device}, v "
                         f"{tuple(v.shape)} on {v.device}")
    strides = q.stride()
    if k.stride() != strides or v.stride() != strides:
        raise ValueError("K8 takes q, k, v views with equal strides")
    sb, sh, st, sd = strides
    per16 = 16 // q.element_size()
    if sd != 1 or sb % per16 or sh % per16 or st % per16 \
            or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError(
            f"K8 needs 16-byte aligned views with a unit last stride and "
            f"the others multiples of 16 bytes (its TMA tensor maps and "
            f"vector loads); strides {strides}")
    # the merged [B, T, H, D] layout the o-projection reads; returned as
    # the [B, H, T, D] view, so merge_heads after it copies nothing
    out = torch.empty((b, t, h, d), dtype=dt, device=dev)
    name, scale = _FORMS[dt]
    runtime.launch(name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   sb, sh, st, out.data_ptr(), b, h, t, scale,
                   runtime.raw_stream(dev))
    runtime.bump("encoder_attention")
    return out.transpose(1, 2)


def fused_encoder_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """softmax(QK^T/sqrt(D))V for [B, H, T, D] inputs, non-causal; returns
    [B, H, T, D] in q's dtype. CUDA tensors (bf16 or float32, head dim
    64, any strides with a unit last one, e.g. the head-split views of the
    q/k/v dense outputs) launch K8, CPU tensors take the plain version."""
    runtime.refuse_grad("K8", q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v)
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v)
    raise ValueError(f"unsupported device {q.device}")
