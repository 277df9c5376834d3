"""Single-query attention over merged-head K/V: bf16 (K2) and int8 (K6).

Counterpart of ``multimodal_audio_search_tpu/ops/cross_attention.py``:

* ``fused_single_query_attention`` (K2, B2) serves both attentions of a
  decode step: cross attention over the encoder K/V (``pos=None``: every
  key) and causal self attention over the KV cache (``pos``: keys
  0..pos). K/V stay in the merged [B, T, H*D] layout the k/v dense layers
  emit.
* ``quantize_kv_merged`` and ``fused_single_query_attention_int8`` (K6,
  B6), the cross attention of ``cross_attn="int8_fused"``: int8 merged
  K/V with per-(b, t, head) scales; the query and the weighted
  probabilities are quantized per head inside, and both dots are
  int8 x int8 -> int32 (module of the kernel: csrc/cross_attention_int8.cu).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its ``*_plain`` version. The int8 plain version carries the kernel's
quantization of q and of the probabilities (the JAX package's CPU twin
``xla_single_query_attention_int8`` dequantizes instead, so its engine's
int8_fused numbers off the TPU are not the kernel's).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import runtime
from .cached_attention import div_exact, quantize_rows


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


# K2 stages CHUNK keys per block and splits T into ceil(n_valid / CHUNK)
# parts; the splits' (m, l, acc[64]) states go to a float32 scratch of
# STATES states per device, merged by the last split to arrive.
CHUNK = 128
STATES = 16384
_SCRATCH: dict = {}


def split_plan(n_valid: int, pairs: int) -> tuple[int, int]:
    """K2's (splits, keys per split) for ``n_valid`` keys and ``pairs``
    (batch, head) pairs: one split per CHUNK keys, as many as the scratch
    holds, at least one."""
    s = max(1, min(-(-n_valid // CHUNK), STATES // pairs))
    return s, -(-n_valid // s)


def _scratch(device: torch.device) -> tuple[int, int]:
    """Pointers of the persistent split scratch (STATES x 66 float32) and
    the zeroed arrival counters (STATES int32) on ``device``; each launch
    leaves the counters zero. One set per device: K2 runs on one stream
    at a time."""
    ptrs = _SCRATCH.get(device)
    if ptrs is None:
        part = torch.empty(STATES * 66, dtype=torch.float32, device=device)
        cnt = torch.zeros(STATES, dtype=torch.int32, device=device)
        ptrs = _SCRATCH[device] = (part.data_ptr(), cnt.data_ptr(), part, cnt)
    return ptrs[0], ptrs[1]


# K2's forms by input dtype (csrc/cross_attention.cu): the float32 one
# serves a float32 decode on the card, as the TPU kernel takes either
_FORMS = {torch.bfloat16: "mas_single_query_attention",
          torch.float32: "mas_single_query_attention_f32"}


def _launch(q_m, k_m, v_m, heads: int, n_valid: int,
            splits: int | None = None) -> torch.Tensor:
    """K2 on the card. ``splits`` overrides split_plan (tests reach the
    split edges and empty splits with it)."""
    b, hd = q_m.shape
    t = k_m.shape[1]
    if hd != heads * 64:
        raise ValueError(f"K2 takes head dim 64: H*D={hd}, heads={heads}")
    if k_m.shape != (b, t, hd) or v_m.shape != (b, t, hd):
        raise ValueError(
            f"K2: q {tuple(q_m.shape)}, k {tuple(k_m.shape)}, "
            f"v {tuple(v_m.shape)}")
    dt = q_m.dtype
    if dt not in _FORMS or k_m.dtype != dt or v_m.dtype != dt:
        raise TypeError(f"K2 takes bf16 or float32 tensors of one dtype; "
                        f"q, k, v are {q_m.dtype}, {k_m.dtype}, {v_m.dtype}")
    dev = k_m.device
    if q_m.device != dev or v_m.device != dev:
        raise ValueError(f"K2: q on {q_m.device}, k on {dev}, v on "
                         f"{v_m.device}")
    if not (q_m.is_contiguous() and k_m.is_contiguous()
            and v_m.is_contiguous()) \
            or (q_m.data_ptr() | k_m.data_ptr() | v_m.data_ptr()) % 16:
        raise ValueError("K2 takes contiguous 16-byte aligned q, k and v")
    if splits is None:
        splits, chunk = split_plan(n_valid, b * heads)
    else:
        chunk = -(-n_valid // splits)
    if splits > 1 and b * heads * splits > STATES:
        raise ValueError(f"K2: {b} x {heads} x {splits} split states exceed "
                         f"the scratch of {STATES}")
    part, cnt = _scratch(dev)
    out = torch.empty((b, hd), dtype=torch.float32, device=dev)
    runtime.launch(_FORMS[dt], dev, q_m.data_ptr(),
                   k_m.data_ptr(), v_m.data_ptr(), out.data_ptr(), part, cnt,
                   b, heads, t, hd, n_valid, splits, chunk,
                   1.0 / 8.0, runtime.raw_stream(dev))  # 1 / sqrt(64)
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
    argument. CUDA tensors (bf16 or float32) launch K2, CPU tensors take
    the plain twin."""
    runtime.refuse_grad("K2", q_m, k_m, v_m)
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


# ------------------------------------------------------------- int8 (K6)
def quantize_merged(x: torch.Tensor, heads: int):
    """[B, T, H*D] -> (int8 [B, T, H*D], scales [B, T, H]): per-(b, t,
    head) scales over each head's D values."""
    b, t, hd = x.shape
    x8, s = quantize_rows(x.reshape(b, t, heads, hd // heads))
    return x8.reshape(b, t, hd), s


def quantize_kv_merged(k_m: torch.Tensor, v_m: torch.Tensor, heads: int):
    """[B, T, H*D] -> (k8, ks, v8, vs), quantize_merged of each."""
    return (*quantize_merged(k_m, heads), *quantize_merged(v_m, heads))


def single_query_attention_int8_plain(q_m, k8, ks, v8, vs, *, heads: int,
                                      pos=None):
    """B6 in plain PyTorch, the TPU kernel's order of operations: q
    quantized per head (qs), int logits li = k8 . q8, logits =
    ((li * ks) * qs) / sqrt(D), keys after ``pos`` at -1e30, unnormalised
    p = exp(logits - max), pw = p * vs quantized per head (spw), int
    out = pw8 . v8, times spw / l. The integer dots run in float64, where
    they are exact. Returns [B, H*D] float32."""
    b, hd = q_m.shape
    t = k8.shape[1]
    d = hd // heads
    q8, qs = quantize_rows(q_m.reshape(b, heads, d))
    li = torch.einsum("bhd,bthd->bht", q8.double(),
                      k8.reshape(b, t, heads, d).double()).float()
    logits = li * ks.float().transpose(1, 2) * qs[..., None] \
        * (1.0 / math.sqrt(d))
    if pos is not None:
        valid = torch.arange(t, device=k8.device) <= int(pos)
        logits = logits.masked_fill(~valid[None, None, :], -1e30)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    pw = p * vs.float().transpose(1, 2)                      # [B, H, T]
    spw = div_exact(pw.amax(dim=-1).clamp_min(1e-20), 127.0)
    pw8 = torch.round(pw / spw[..., None]).clamp(-127, 127)
    oi = torch.einsum("bht,bthd->bhd", pw8.double(),
                      v8.reshape(b, t, heads, d).double()).float()
    return (oi * (spw / l)[..., None]).reshape(b, hd)


# K6's split-T plan: a block takes G heads of one batch row (G = 2 where H
# is even, else 1: the H100 sweep in PERF.md), a cluster of up to
# MAX_CLUSTER blocks one (b, G heads) row, at least KEYS_PER_BLOCK keys a
# block where there are enough; n_valid up to MAX_T. A block asks at most
# SMEM_LIMIT bytes (csrc/cross_attention_int8.cu's smem_bytes, mirrored
# in int8_smem_bytes). K7's cluster_plan does not serve: K6 also picks G,
# its blocks' shared memory and residency depend on G, and it takes
# clusters of up to 16.
MAX_CLUSTER, KEYS_PER_BLOCK, MAX_T = 16, 64, 12288
SMEM_LIMIT, NT = 200 * 1024, 256
_FIT: dict = {}
_PLAN: dict = {}   # int8_plan by (device, n_valid, H, B), asked once


def _align128(x: int) -> int:
    return (x + 127) // 128 * 128


def int8_smem_bytes(g: int, chunk: int) -> int:
    """The dynamic shared memory of a K6 block of g heads and chunk keys
    (csrc/cross_attention_int8.cu's smem_bytes): its V rows in whole TMA
    boxes (later the p . V partials), the scales then logits (later its
    oi), vs then the pw8 codes, and the query codes."""
    nbox = -(-chunk // 256)
    r = -(-chunk // nbox)
    r += r % 2
    v = max(-(-chunk // r) * r * g * 64, 4 * max(4 * NT, 64 * g))
    p = _align128(4 * g * max(chunk, 64))
    return _align128(v) + 2 * p + g * 64


def int8_plan(n_valid: int, heads: int, b: int = 1, fit=None,
              group: int | None = None,
              cluster: int | None = None) -> tuple[int, int, int]:
    """(G heads a block, blocks a cluster, keys a block) of K6 for n_valid
    keys, H = heads and B = b rows: rank r takes keys [r * chunk, min(
    n_valid, (r + 1) * chunk)), so the ranks cover every key once and a
    rank past the end holds none. An SM pulls ~30 GB/s and holds about 8
    blocks of a cluster launch (PERF.md), so the plan takes the largest
    cluster whose b * heads / G clusters are all resident at once:
    ``fit(g, c, chunk)`` is the clusters the card holds (None: no limit);
    where none is, the most blocks that fit in shared memory. G is 2
    where H is even (each key's 2 x 64 bytes of K and V and its two
    scales together; G = 1 reads 4 of every 32 bytes of the [B, T, H]
    scales, G = H is held to a cluster the card does not place at once:
    the sweep in PERF.md), else 1. ``group`` and ``cluster`` force G and
    the block count (the card tests and the sweep use them)."""
    if not 1 <= n_valid <= MAX_T:
        raise ValueError(f"K6 takes 1 <= n_valid <= {MAX_T}, got {n_valid}")
    g = group or (2 if heads % 2 == 0 else 1)
    if heads % g or g > 32:
        raise ValueError(f"K6 takes G | H heads a block, G <= 32: H={heads}, "
                         f"G={g}")
    if cluster is not None and not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"K6 clusters hold 1..{MAX_CLUSTER} blocks, got "
                         f"{cluster}")
    top = min(MAX_CLUSTER, -(-n_valid // KEYS_PER_BLOCK))
    sizes = [c for c in ([cluster] if cluster else range(top, 0, -1))
             if int8_smem_bytes(g, -(-n_valid // c)) <= SMEM_LIMIT]
    if not sizes:
        raise ValueError(f"K6: no block of G={g} heads holds n_valid="
                         f"{n_valid} keys over {cluster or MAX_CLUSTER} "
                         f"blocks in {SMEM_LIMIT} bytes")
    cs = next((c for c in sizes if fit is None
               or fit(g, c, -(-n_valid // c)) >= b * heads // g), sizes[0])
    return g, cs, -(-n_valid // cs)


def _fit_int8(dev: torch.device):
    """fit() for int8_plan on ``dev``, asked of the card once per shape."""
    def fit(g: int, c: int, chunk: int) -> int:
        key = (dev, g, c, chunk)
        if key not in _FIT:
            out = ctypes.c_int(0)
            runtime.launch("mas_single_query_attention_int8_fit", dev,
                           g, c, chunk, ctypes.byref(out))
            _FIT[key] = out.value
        return _FIT[key]
    return fit


# K6's forms by q's dtype (csrc/cross_attention_int8.cu): the float32 one
# reads a float32 q and quantizes it as B6's wrapper does q_m.astype(f32)
_FORMS_INT8 = {torch.bfloat16: "mas_single_query_attention_int8",
               torch.float32: "mas_single_query_attention_int8_f32"}


def _launch_int8(q_m, k8, ks, v8, vs, heads: int, n_valid: int,
                 group: int | None = None,
                 cluster: int | None = None) -> torch.Tensor:
    b, hd = q_m.shape
    t = k8.shape[1]
    if hd != heads * 64:
        raise ValueError(f"K6 takes head dim 64: H*D={hd}, heads={heads}")
    if tuple(k8.shape) != (b, t, hd) or tuple(v8.shape) != (b, t, hd) \
            or tuple(ks.shape) != (b, t, heads) \
            or tuple(vs.shape) != (b, t, heads):
        raise ValueError(
            f"K6: q {tuple(q_m.shape)}, k8 {tuple(k8.shape)}, v8 "
            f"{tuple(v8.shape)}, ks {tuple(ks.shape)}, vs {tuple(vs.shape)}")
    if q_m.dtype not in _FORMS_INT8:
        raise TypeError(f"K6 takes a bf16 or float32 q; got {q_m.dtype}")
    for name, a, dt in (("q", q_m, q_m.dtype), ("k8", k8, torch.int8),
                        ("ks", ks, torch.float32), ("v8", v8, torch.int8),
                        ("vs", vs, torch.float32)):
        if a.dtype != dt:
            raise TypeError(f"K6 takes {dt} {name}; got {a.dtype}")
        if a.device != k8.device:
            raise ValueError(f"K6: {name} on {a.device}, k8 on {k8.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"K6 takes a contiguous 16-byte aligned {name}")
    if group is None and cluster is None:   # the engine's calls: one lookup
        key = (k8.device, n_valid, heads, b)
        if key not in _PLAN:
            _PLAN[key] = int8_plan(n_valid, heads, b, _fit_int8(k8.device))
        g, cs, chunk = _PLAN[key]
    else:
        g, cs, chunk = int8_plan(n_valid, heads, b, _fit_int8(k8.device),
                                 group, cluster)
    out = torch.empty((b, hd), dtype=torch.float32, device=k8.device)
    runtime.launch(
        _FORMS_INT8[q_m.dtype], k8.device,
        q_m.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), out.data_ptr(), b, heads, t, n_valid, g, cs, chunk,
        1.0 / math.sqrt(hd // heads), runtime.stream_handle(k8.device))
    runtime.bump("single_query_attention_int8")
    return out


def fused_single_query_attention_int8(
    q_m: torch.Tensor,    # [B, H*D] float queries (quantized in here)
    k8: torch.Tensor,     # [B, T, H*D] int8
    ks: torch.Tensor,     # [B, T, H] f32 scales
    v8: torch.Tensor,     # [B, T, H*D] int8
    vs: torch.Tensor,     # [B, T, H] f32 scales
    *,
    heads: int,
    pos: int | None = None,   # attend to keys [0, pos]; None = all
) -> torch.Tensor:            # [B, H*D] f32
    """Single-query attention over merged int8 K/V. CUDA tensors launch
    K6 (its bf16 or float32 form by q's dtype), CPU tensors take the plain
    version."""
    runtime.refuse_grad("K6", q_m, k8, ks, v8, vs)
    t = k8.shape[1]
    if pos is not None and not 0 <= int(pos) < t:
        raise ValueError(f"pos {pos} outside [0, {t})")
    if k8.device.type == "cuda":
        n_valid = t if pos is None else int(pos) + 1
        return _launch_int8(q_m, k8, ks, v8, vs, heads, n_valid)
    if k8.device.type == "cpu":
        return single_query_attention_int8_plain(q_m, k8, ks, v8, vs,
                                                 heads=heads, pos=pos)
    raise ValueError(f"unsupported device {k8.device}")
