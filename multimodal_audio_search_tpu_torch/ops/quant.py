"""Int8 decoder weights: the quantize helpers and the dequantizing matmul (K5).

Counterpart of ``multimodal_audio_search_tpu/ops/quant.py``:

  quantize_weight, quantize_dense, quantize_whisper_decoder
      numpy, with the JAX functions' arithmetic (``np.round``, half to
      even, and a true division), so codes and scales are bit-identical;
  quant_matmul (K5)
      x [M, K] @ (int8 W [K, N] in x's dtype), float32 sums, times the
      per-column scale -> [M, N] float32;
  quant_dense_apply
      a dense layer on a quantized leaf ``{"wq", "scale"[, "b"]}``: K5,
      the bias added in float32 after the product, output in
      ``out_dtype`` or x's dtype.

On a CUDA tensor K5 launches ``csrc/quant_matmul.cu``, which adds the bias
and rounds to the output dtype in its epilogue (the same values); on a CPU
tensor it runs ``quant_matmul_plain``. There is no other route: a launch
that fails raises.

Where the JAX package differs: on a non-TPU backend its
``quant_dense_apply`` multiplies by the dequantized matrix
``x @ (wq * scale)`` once rows * N > 4M, which rounds in another order
(~1e-6 relative at float32); the port keeps K5's order everywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import runtime

# M at or below which K5 takes its 32x32 tiling (decode steps); above it,
# the 128x128 one (the cross K/V projections over B * 1500 rows)
SMALL_M = 64


# ---------------------------------------------------------------- quantize
def _f32(w) -> np.ndarray:
    if torch.is_tensor(w):
        w = w.detach().cpu().float().numpy()
    return np.asarray(w, np.float32)


def quantize_weight(w) -> tuple[np.ndarray, np.ndarray]:
    """[K, N] float -> (int8 [K, N], scale [N]) symmetric per-column."""
    w = _f32(w)
    scale = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
    q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return np.ascontiguousarray(q), scale.astype(np.float32)


def quantize_dense(p: dict) -> dict:
    q, s = quantize_weight(p["w"])
    out = {"wq": torch.from_numpy(q), "scale": torch.from_numpy(s)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_whisper_decoder(params: dict) -> dict:
    """Quantize the decoder's dense layers and the tied embedding/logits
    matrix (``decoder/embed_tokens_q``: [d, V] int8, per-vocab scales);
    the lookup table ``embed_tokens`` stays dense, rounded to bf16 as the
    JAX function stores it. The encoder, layer norms and positions are
    left as they are. Returns a new tree; ``params`` is not modified."""
    dec = dict(params["decoder"])
    blocks = []
    for blk in dec["blocks"]:
        nb = dict(blk)
        for attn_key in ("self_attn", "cross_attn"):
            nb[attn_key] = {proj: quantize_dense(nb[attn_key][proj])
                            for proj in ("q", "k", "v", "o")}
        nb["mlp_in"] = quantize_dense(nb["mlp_in"])
        nb["mlp_out"] = quantize_dense(nb["mlp_out"])
        blocks.append(nb)
    dec["blocks"] = blocks
    e = _f32(dec["embed_tokens"])                         # [V, d]
    qt, st = quantize_weight(e.T)                         # [d, V], [V]
    dec["embed_tokens_q"] = {"wq": torch.from_numpy(qt),
                             "scale": torch.from_numpy(st)}
    dec["embed_tokens"] = torch.from_numpy(e).to(torch.bfloat16)
    return {**params, "decoder": dec}


def is_quantized(params) -> bool:
    """True for a Whisper tree from quantize_whisper_decoder."""
    return "embed_tokens_q" in params["decoder"]


# ------------------------------------------------------------------ kernel
def quant_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """K5 in plain PyTorch: (x @ float(wq)) * scale in float32. Every
    product of a bf16 or float32 x with an int8 code is exact in float32,
    so only the order of the sums differs from the kernel."""
    return torch.matmul(x.float(), wq.float()) * scale.float()


def _launch(x, wq, scale, bias, out_dtype: torch.dtype,
            small: bool | None = None) -> torch.Tensor:
    m, k = x.shape
    if wq.dim() != 2 or wq.shape[0] != k:
        raise ValueError(f"K5: x {tuple(x.shape)}, wq {tuple(wq.shape)}")
    n = wq.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K5 takes bf16 x; got {x.dtype}")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"K5 takes int8 wq and float32 scale; got "
                        f"{wq.dtype}, {scale.dtype}")
    if bias is not None and bias.dtype != torch.bfloat16:
        raise TypeError(f"K5 takes a bf16 bias; got {bias.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 writes float32 or bf16, not {out_dtype}")
    if tuple(scale.shape) != (n,) or (bias is not None
                                      and tuple(bias.shape) != (n,)):
        raise ValueError(f"K5: N={n}, scale {tuple(scale.shape)}")
    if k % 8:
        raise ValueError(f"K5 takes K a multiple of 8 (16-byte rows), K={k}")
    for name, a in (("x", x), ("wq", wq), ("scale", scale), ("bias", bias)):
        if a is None:
            continue
        if a.device != x.device:
            raise ValueError(f"K5: {name} on {a.device}, x on {x.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"K5 takes a contiguous 16-byte aligned {name}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if small is None:
        small = m <= SMALL_M
    lib = runtime.kernels()
    rc = lib.mas_quant_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, k, n, int(out_dtype == torch.bfloat16), int(small),
        runtime.stream_handle(x.device))
    runtime.check_launch(rc, "mas_quant_matmul")
    runtime.bump("quant_matmul")
    return out


def quant_matmul(x: torch.Tensor, wq: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(wq [K, N] int8, scale [N]) -> [M, N] float32.
    CUDA tensors launch K5, CPU tensors take the plain version."""
    if x.device.type == "cuda":
        return _launch(x, wq, scale, None, torch.float32)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, wq, scale)
    raise ValueError(f"unsupported device {x.device}")


def quant_dense_apply(p: dict, x: torch.Tensor,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Dense layer with int8 weights; x [..., K] -> [..., N] in
    ``out_dtype`` or x's dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    dt = out_dtype or x.dtype
    if x.device.type == "cuda":
        y = _launch(x2, p["wq"], p["scale"], p.get("b"), dt)
    elif x.device.type == "cpu":
        y = quant_matmul_plain(x2, p["wq"], p["scale"])
        if "b" in p:
            y = y + p["b"].float()
        y = y.to(dt)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return y.reshape(*lead, -1)
