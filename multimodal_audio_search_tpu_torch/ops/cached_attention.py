"""Single-query attention over int8 K/V in the [B, H, T, D] layout (K7).

Counterpart of ``multimodal_audio_search_tpu/ops/cached_attention.py``:
``quantize_kv`` (per-(b, h, t) scales over D) and ``int8_cached_attention``
(B7), the decode cross attention of ``int8_cross_kv`` /
``cross_attn="int8"``. The scales commute with the dots, so K/V are never
dequantized:

    logits[t] = (bf16(q) . k8[t]) * ks[t] / sqrt(D)
    out       = sum_t bf16(softmax(logits)[t] * vs[t]) * v8[t]

On a CUDA tensor the wrapper launches ``csrc/cached_attention.cu``; on a
CPU tensor it runs ``int8_cached_attention_plain``, which rounds q and the
weighted probabilities to bf16 where the TPU kernel does, whatever the
input dtype. (The JAX package's CPU twin ``xla_int8_cached_attention``
does not round them; its engine takes that twin off the TPU.)
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import runtime


def div_exact(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as a true division. PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead, which can land one ulp
    away; a 0-dim tensor on a's device is divided properly."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


# elements of x quantized per pass: bounds the float32 working copy of a
# [B, T, H*D] cross K/V tensor (24.6 M elements at whisper-base, B=32) to
# 16 MB
QUANT_CHUNK = 1 << 22


def quantize_rows(x: torch.Tensor):
    """Symmetric int8 over the last axis: (int8 codes, float32 scales of
    shape x.shape[:-1]) with the JAX arithmetic: scale = max(max |x|,
    1e-12) / 127, codes = clip(round(x / scale)) (half to even). Both
    come out contiguous, whatever x's strides (e.g. a head-split view).
    Works through x's leading axis in slices of about QUANT_CHUNK
    elements, in place on one float32 copy of the slice, so the mode that
    saves memory does not spend it on temporaries."""
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    n = x.shape[0]
    step = max(1, QUANT_CHUNK * n // max(1, x.numel()))
    for i in range(0, n, step):
        xf = x[i:i + step].to(torch.float32, copy=True)
        # max |x| as max(max x, -min x): the same value, no |x| copy
        si = div_exact(torch.maximum(xf.amax(dim=-1), xf.amin(dim=-1).neg_())
                       .clamp_min_(1e-12), 127.0)
        xf.div_(si[..., None]).round_().clamp_(-127, 127)
        x8[i:i + step].copy_(xf)      # integral values: exact
        s[i:i + step] = si
    return x8, s


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """[B, H, T, D] -> (k8, ks, v8, vs) with per-(b, h, t) scales."""
    return (*quantize_rows(k), *quantize_rows(v))


def int8_cached_attention_plain(q, k8, ks, v8, vs) -> torch.Tensor:
    """B7 in plain PyTorch: q [B, H, D] (rounded to bf16), k8/v8
    [B, H, T, D] int8, ks/vs [B, H, T] -> [B, H, D] float32."""
    d = q.shape[-1]
    qb = q.to(torch.bfloat16).float()
    logits = torch.einsum("bhd,bhtd->bht", qb, k8.float()) * ks.float() \
        * (1.0 / math.sqrt(d))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    pw = (p * vs.float()).to(torch.bfloat16).float()
    return torch.einsum("bht,bhtd->bhd", pw, v8.float())


# K7's split-T plan: at most MAX_CLUSTER blocks a (b, h) (the portable
# cluster size), about KEYS_PER_BLOCK keys a block or more; T up to MAX_T
# (the one-block kernel's 48 KB of logits, kept), at most MAX_T /
# MAX_CLUSTER keys a block (its buffer of K, then V, and its logits:
# 102 KB).
MAX_CLUSTER, KEYS_PER_BLOCK, MAX_T = 8, 128, 12288
_FIT: dict = {}


def cluster_plan(t: int, cluster: int | None = None, rows: int = 1,
                 fit=None) -> tuple[int, int]:
    """(blocks a (b, h), keys a block) of K7's cluster for T = t keys and
    ``rows`` (b, h) rows: rank r takes keys [r * chunk, min(t, (r + 1) *
    chunk)), so the ranks cover every key once and a rank past the end
    holds none. An SM pulls ~30 GB/s and holds about 8 blocks of a
    cluster launch (PERF.md), so the clusters are as large as they can be
    while every row's cluster is resident at once: ``fit(c, chunk)`` is
    the clusters of c blocks of chunk keys the card holds (None: no
    limit); where none fits them all, 8 blocks. ``cluster`` forces the
    block count (the card tests use it to reach empty ranks)."""
    if not 1 <= t <= MAX_T:
        raise ValueError(f"K7 takes 1 <= T <= {MAX_T}, got {t}")
    cs = cluster
    if cs is None:
        sizes = [c for c in range(min(MAX_CLUSTER, -(-t // KEYS_PER_BLOCK)),
                                  0, -1)
                 if -(-t // c) <= MAX_T // MAX_CLUSTER]
        cs = next((c for c in sizes
                   if fit is None or fit(c, -(-t // c)) >= rows), sizes[0])
    if not 1 <= cs <= MAX_CLUSTER:
        raise ValueError(f"K7 clusters hold 1..{MAX_CLUSTER} blocks, got {cs}")
    chunk = -(-t // cs)
    if chunk > MAX_T // MAX_CLUSTER:
        raise ValueError(f"K7 blocks hold {MAX_T // MAX_CLUSTER} keys: T={t} "
                         f"over {cs} blocks")
    return cs, chunk


def _fit(dev: torch.device):
    """fit() for cluster_plan on ``dev``: the clusters of c K7 blocks of
    chunk keys the card holds at once, asked of it once per shape."""
    def fit(c: int, chunk: int) -> int:
        key = (dev, c, chunk)
        if key not in _FIT:
            out = ctypes.c_int(0)
            runtime.launch("mas_int8_cached_attention_fit", dev, c, chunk,
                           ctypes.byref(out))
            _FIT[key] = out.value
        return _FIT[key]
    return fit


def _launch(q, k8, ks, v8, vs, cluster: int | None = None) -> torch.Tensor:
    b, h, d = q.shape
    t = k8.shape[2]
    if d != 64:
        raise ValueError(f"K7 takes head dim 64, got {d}")
    if tuple(k8.shape) != (b, h, t, d) or tuple(v8.shape) != (b, h, t, d) \
            or tuple(ks.shape) != (b, h, t) or tuple(vs.shape) != (b, h, t):
        raise ValueError(
            f"K7: q {tuple(q.shape)}, k8 {tuple(k8.shape)}, v8 "
            f"{tuple(v8.shape)}, ks {tuple(ks.shape)}, vs {tuple(vs.shape)}")
    cs, chunk = cluster_plan(t, cluster, b * h, _fit(k8.device))
    for name, a, dt in (("q", q, torch.bfloat16), ("k8", k8, torch.int8),
                        ("ks", ks, torch.float32), ("v8", v8, torch.int8),
                        ("vs", vs, torch.float32)):
        if a.dtype != dt:
            raise TypeError(f"K7 takes {dt} {name}; got {a.dtype}")
        if a.device != k8.device:
            raise ValueError(f"K7: {name} on {a.device}, k8 on {k8.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"K7 takes a contiguous 16-byte aligned {name}")
    out = torch.empty((b, h, d), dtype=torch.float32, device=k8.device)
    runtime.launch(
        "mas_int8_cached_attention", k8.device,
        q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), out.data_ptr(), b, h, t, cs, chunk,
        1.0 / math.sqrt(d), runtime.stream_handle(k8.device))
    runtime.bump("int8_cached_attention")
    return out


def int8_cached_attention(
    q: torch.Tensor,       # [B, H, D]
    k8: torch.Tensor,      # [B, H, T, D] int8
    ks: torch.Tensor,      # [B, H, T] f32
    v8: torch.Tensor,      # [B, H, T, D] int8
    vs: torch.Tensor,      # [B, H, T] f32
) -> torch.Tensor:         # [B, H, D] f32
    """Single-query attention over every key of an int8 K/V cache. CUDA
    tensors launch K7 (q in bf16), CPU tensors take the plain version."""
    runtime.refuse_grad("K7", q, k8, ks, v8, vs)
    if k8.device.type == "cuda":
        return _launch(q, k8, ks, v8, vs)
    if k8.device.type == "cpu":
        return int8_cached_attention_plain(q, k8, ks, v8, vs)
    raise ValueError(f"unsupported device {k8.device}")
