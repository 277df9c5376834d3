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
that fails raises. ``split_plan`` picks the kernel and its K splits from
the shape: the skinny kernel for a decode step's layers (split K, partials
summed in split order), the wgmma kernel for the cross K/V projection over
the encoder rows. The tied logits (N = 51865) take the table kernel on the
transposed copy that ``logits_table`` puts in place of the codes when the
model is placed on the card; any other N % 16 != 0 takes it on a copy
made for the call.

Where the JAX package differs: on a non-TPU backend its
``quant_dense_apply`` multiplies by the dequantized matrix
``x @ (wq * scale)`` once rows * N > 4M, which rounds in another order
(~1e-6 relative at float32); the port keeps K5's order everywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import runtime

# M at or below which K5 takes its skinny kernel (a decode step's
# layers); above it, with N % 16 == 0, the wgmma one (the cross K/V
# projections over B * 1500 rows)
SMALL_M = 64
# the widest K whose x rows and table rings fit the table kernel's shared
# memory (one block a SM)
TABLE_MAX_K = 2048


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


def transposed_table(wq: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] -> [N, Kp], Kp = K rounded up to 16, the pad zero: the
    layout K5's table kernel streams in aligned 16-byte words whatever N
    is."""
    k, n = wq.shape
    t = torch.zeros((n, -(-k // 16) * 16), dtype=torch.int8,
                    device=wq.device)
    t[:, :k] = wq.t()
    return t


def logits_table(q: dict) -> dict:
    """The tied logits' leaf as the card holds it: its int8 codes [d, V]
    replaced by their transposed copy ("wq_t", transposed_table). Made
    once, when the model is placed on the card (models/whisper.py::
    prepare_params); the leaf's other entries are kept as they are. A
    width the table kernel does not take (d > TABLE_MAX_K) keeps its
    codes, and a leaf that holds its table already is returned as it
    is."""
    if "wq" not in q or q["wq"].shape[0] > TABLE_MAX_K:
        return q
    t = {k: v for k, v in q.items() if k != "wq"}
    return {**t, "wq_t": transposed_table(q["wq"])}


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


# K5's plan (csrc/quant_matmul.cu): N % 16 != 0 takes the table kernel
# ("table", on the transposed codes); otherwise M > SMALL_M takes the
# wgmma kernel ("wide") and M <= SMALL_M the skinny kernel, tiles of
# 32 rows by SB_N columns, K in SB_K steps. K is split, at most MAX_SPLITS
# ways, until the grid fills one wave of the card -- but only where a
# block would walk SPLIT_MIN_STEPS steps or more and the tiles fill under
# a quarter of the wave: a split costs a partial tile's store, a fence,
# an arrival and the last block's reduction, ~2 us on an H100, more than
# it saves below that ([2048, 512] splits 8 ways, [512, 2048] not at
# all). The splits' float32 partial tiles ([tiles, splits, 32, SB_N]) go
# to a persistent per-device scratch of SCRATCH floats (more when a
# forced split count needs it), summed in split order by the last block
# of each tile. The wave is the card's multiprocessor count
# (runtime.sm_count); WAVE, an H100 SXM's, is the default CPU tests plan
# for.
WAVE = 132
SB_N = 32
SB_K = 128
MAX_SPLITS = 8
SPLIT_MIN_STEPS = 4
SCRATCH = 1 << 22
COUNTERS = 4096
_SCRATCH: dict = {}


def split_plan(m: int, k: int, n: int, splits: int | None = None,
               wave: int = WAVE) -> tuple[str, int, int, int]:
    """K5's (regime, column tile, K splits, K steps a split) for x [m, k]
    @ W [k, n] on a card of ``wave`` multiprocessors. ``splits`` forces a
    split count on the skinny kernel (tests reach the split edges with
    it); the plan then takes the fewest splits of equal steps that cover
    K, so no split is empty. The table kernel takes K whole, in steps of
    16."""
    if n % 16:
        if k > TABLE_MAX_K:
            raise ValueError(f"K5 takes N % 16 == 0, or K <= {TABLE_MAX_K} "
                             f"for its table kernel: K={k}, N={n}")
        return "table", 16, 1, -(-k // 16)
    if m > SMALL_M and splits is None:
        return "wide", 128, 1, -(-k // 64)
    nk = -(-k // SB_K)
    if splits is None:
        tiles = -(-n // SB_N) * -(-m // 32)
        splits = 1 if nk < SPLIT_MIN_STEPS or tiles >= wave // 4 else min(
            nk, -(-wave // tiles), MAX_SPLITS, SCRATCH // (tiles * 32 * SB_N))
    steps = -(-nk // max(1, min(splits, nk)))
    return "skinny", SB_N, -(-nk // steps), steps


def _scratch(device: torch.device, floats: int) -> tuple[int, int]:
    """Pointers of the persistent split scratch (at least ``floats``
    float32, SCRATCH to start with) and the zeroed arrival counters
    (COUNTERS int32, one a tile) on ``device``; each launch leaves the
    counters zero. One set per device: K5 runs on one stream at a time."""
    ptrs = _SCRATCH.get(device)
    if ptrs is None or ptrs[2].numel() < floats:
        part = torch.empty(max(SCRATCH, floats), dtype=torch.float32,
                           device=device)
        cnt = ptrs[3] if ptrs else torch.zeros(COUNTERS, dtype=torch.int32,
                                               device=device)
        ptrs = _SCRATCH[device] = (part.data_ptr(), cnt.data_ptr(), part, cnt)
    return ptrs[0], ptrs[1]


def _check(x, w, scale, bias, out_dtype, n: int) -> None:
    """Raise on what K5 does not take (w: the codes [K, N] or the table
    [N, Kp], its shape checked by the caller): one combined test on the
    common path, the culprit named only when it fails."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K5 takes bf16 x; got {x.dtype}")
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"K5 takes int8 codes and float32 scale; got "
                        f"{w.dtype}, {scale.dtype}")
    if bias is not None and bias.dtype != torch.bfloat16:
        raise TypeError(f"K5 takes a bf16 bias; got {bias.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 writes float32 or bf16, not {out_dtype}")
    if tuple(scale.shape) != (n,) or (bias is not None
                                      and tuple(bias.shape) != (n,)):
        raise ValueError(f"K5: N={n}, scale {tuple(scale.shape)}")
    if x.shape[1] % 8:
        raise ValueError(f"K5 takes K a multiple of 8 (16-byte rows), "
                         f"K={x.shape[1]}")
    ts = (x, w, scale) if bias is None else (x, w, scale, bias)
    if all(a.device == x.device and a.is_contiguous() for a in ts) and not (
            x.data_ptr() | w.data_ptr() | scale.data_ptr()
            | (0 if bias is None else bias.data_ptr())) % 16:
        return
    for name, a in zip(("x", "codes", "scale", "bias"), ts):
        if a.device != x.device:
            raise ValueError(f"K5: {name} on {a.device}, x on {x.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"K5 takes a contiguous 16-byte aligned {name}")


def _launch(x, wq, scale, bias, out_dtype: torch.dtype,
            splits: int | None = None, wq_t=None) -> torch.Tensor:
    """K5 on the card, on the codes ``wq`` [K, N] or the transposed table
    ``wq_t`` [N, Kp] of logits_table (the table kernel; ``wq`` may then
    be None). Where split_plan picks the table kernel for codes, it runs
    on a copy made here. ``splits`` forces the skinny kernel with that
    many K splits (tests reach the split edges with it)."""
    m, k = x.shape
    dev = x.device
    if wq_t is None:
        if wq.dim() != 2 or wq.shape[0] != k:
            raise ValueError(f"K5: x {tuple(x.shape)}, wq {tuple(wq.shape)}")
        regime, bn, splits, steps = split_plan(m, k, wq.shape[1], splits,
                                               runtime.sm_count(dev))
        if regime == "table":  # on no engine path: the logits hold a table
            wq_t = transposed_table(wq)
    if wq_t is not None and (wq_t.dim() != 2 or k > TABLE_MAX_K
                             or wq_t.shape[1] != -(-k // 16) * 16):
        raise ValueError(f"K5: x {tuple(x.shape)}, table "
                         f"{tuple(wq_t.shape)}")
    w = wq if wq_t is None else wq_t
    n = w.shape[1] if wq_t is None else w.shape[0]
    _check(x, w, scale, bias, out_dtype, n)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if wq_t is not None:
        runtime.launch("mas_quant_matmul_table", dev, x.data_ptr(),
                       wq_t.data_ptr(), scale.data_ptr(),
                       None if bias is None else bias.data_ptr(),
                       out.data_ptr(), m, k, wq_t.shape[1], n,
                       int(out_dtype == torch.bfloat16),
                       runtime.sm_count(dev), runtime.raw_stream(dev))
        runtime.bump("quant_matmul")
        return out
    tiles = -(-n // bn) * -(-m // 32)
    if splits > 1 and tiles > COUNTERS:
        raise ValueError(f"K5: {splits} splits of [{m}, {n}] take "
                         f"{tiles} arrival counters, more than {COUNTERS}")
    part, cnt = _scratch(dev, splits * tiles * 32 * bn if splits > 1 else 0)
    runtime.launch("mas_quant_matmul", dev, x.data_ptr(), wq.data_ptr(),
                   scale.data_ptr(),
                   None if bias is None else bias.data_ptr(),
                   out.data_ptr(), part, cnt, m, k, n,
                   int(out_dtype == torch.bfloat16), int(regime == "wide"),
                   bn, splits, steps, runtime.raw_stream(dev))
    runtime.bump("quant_matmul")
    return out


def quant_matmul(x: torch.Tensor, wq: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(wq [K, N] int8, scale [N]) -> [M, N] float32.
    CUDA tensors launch K5, CPU tensors take the plain version."""
    runtime.refuse_grad("K5", x, wq, scale)
    if x.device.type == "cuda":
        return _launch(x, wq, scale, None, torch.float32)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, wq, scale)
    raise ValueError(f"unsupported device {x.device}")


def quant_dense_apply(p: dict, x: torch.Tensor,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Dense layer with int8 weights; x [..., K] -> [..., N] in
    ``out_dtype`` or x's dtype."""
    runtime.refuse_grad("K5", x, p.get("scale"), p.get("b"))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    dt = out_dtype or x.dtype
    if x.device.type == "cuda":
        y = _launch(x2, p.get("wq"), p["scale"], p.get("b"), dt,
                    wq_t=p.get("wq_t"))
    elif x.device.type == "cpu":
        wq = p["wq"] if "wq" in p else p["wq_t"][:, :x2.shape[1]].t()
        y = quant_matmul_plain(x2, wq, p["scale"])
        if "b" in p:
            y = y + p["b"].float()
        y = y.to(dt)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return y.reshape(*lead, -1)
