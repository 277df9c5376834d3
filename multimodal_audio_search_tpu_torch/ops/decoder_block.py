"""Fused decoder sub-blocks of one KV-cached decode step (K3, K4, K14).

Counterpart of ``multimodal_audio_search_tpu/ops/decoder_block.py``:

  fused_self_block    (K3)   x -> LN -> q/k/v -> single-query attention
                             over the cache rows t < pos + the fresh row
                             -> o-proj -> +x;  returns (x_out, k1, v1)
  fused_self_block_q  (K3-q) the same + the next sub-block's cross-LN and
                             cross q-projection; returns (.., q_cross)
  fused_mlp_block     (K4)   x -> x + fc2(gelu(fc1(LN x)))
  fused_mlp_block_o   (K4-o) x -> x + attn @ Wco + bco, then the K4 math
  fused_cross_mlp_block (K14) x -> + cross attention of LN2(x) over
                             merged K/V -> + MLP(LN3(.)); as in the JAX
                             package, no decode step calls it

On a CUDA tensor each wrapper launches a kernel; on a CPU tensor it runs
the ``*_plain`` version of the same math. There is no other route: a
launch that fails raises. The kernel is chosen by x's dtype, as the JAX
kernels cast every weight to it: bf16 tensors (with float32 layer-norm
scales, and K4-o's float32 ``attn``) launch ``csrc/decoder_block.cu``;
float32 tensors launch K3's, K3-q's, K4's, K4-o's, K3p's and K4p's
float32 forms in ``csrc/decoder_block_f32.cu`` (FFMA on the CUDA cores,
nothing rounded to bf16), so a float32 engine runs every ``fused_layer``
setting, on one device and over the mesh's model axis. K14 takes bf16
only and refuses float32, naming why. A call whose tensors mix the two
dtypes raises before any launch.

``partial=True`` (K3p, K4p) is a block's form on one rank of the mesh's
model axis (tensor parallelism): the rank holds H/mp heads (the [D,
H/mp * 64] columns of Wq/Wk/Wv, the [H/mp * 64, D] rows of Wo, a cache
of H/mp * 64 columns) or F/mp of the MLP's width, still reads the whole
x for the layer norm, and returns the float32 o-projection (K3p) or fc2
(K4p) sum without x and without bo / b2, which parallel/mesh.py::
model_sum adds once to the ranks' sum.

The ``*_plain`` functions have the JAX kernels' signatures and return
tuples, and round where they round, in the working dtype (x's): h after
the layer norm, q1/k1/v1 after the projections, the fresh-row products
q1*k1 before their per-head sum, the normalised stale-row weights p and
the fresh-row weight pn before their products with V and v1, the merged
attention output before the o-projection, gelu's output before fc2, and
each block's output. The residual sums stay float32 until the output is
rounded. Layer-norm scales and biases and the projection biases are
rounded to the working dtype first, as the JAX wrappers cast them. The
MLP's erf-GELU is the JAX kernels' Abramowitz-Stegun 7.1.26 polynomial
(|err| < 1.5e-7).

The cache is written in place: the K3 wrappers store k1/v1 into row
``pos`` of ``k_cache``/``v_cache`` (the kernel itself on the card) and
return views of that row, where the JAX caller writes the row with
``dynamic_update_slice`` after the kernel. The attention reads only the
rows t < pos and adds the fresh row in closed form, so the row is
counted once whoever writes it.

The TPU kernels' ``BC=8`` row blocking, block-diagonal ``maskf`` matmuls
and ``KV_BUDGET_BYTES`` row sizing are VMEM/Mosaic layout devices and
are not carried over.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import runtime

# A&S 7.1.26 coefficients, as in the JAX kernels
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def _r(a: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round to the working dtype, continue in float32."""
    return a.to(dt).float()


def _ln(xf: torch.Tensor, g, b, dt, eps: float) -> torch.Tensor:
    """Layer norm in float32 with dtype-rounded scale and bias."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * _r(g, dt) + _r(b, dt)


def _proj(h: torch.Tensor, w, b, dt) -> torch.Tensor:
    """h (dtype values, f32) @ W + b in float32 on dtype-rounded operands."""
    y = h @ _r(w, dt)
    return y if b is None else y + _r(b, dt)


def gelu_as(u: torch.Tensor) -> torch.Tensor:
    """erf-GELU with erf from Abramowitz-Stegun 7.1.26, float32."""
    z = u / math.sqrt(2.0)
    az = z.abs()
    t = 1.0 / (1.0 + _AS_P * az)
    a1, a2, a3, a4, a5 = _AS_A
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    erf = torch.sign(z) * (1.0 - poly * torch.exp(-az * az))
    return 0.5 * u * (1.0 + erf)


def _self_block_math(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                     k_cache, v_cache, pos: int, heads: int, eps: float,
                     partial: bool = False):
    """x_out before its rounding (f32 [B, D]; ``partial``: the float32
    o-projection alone), and k1, v1 in x's dtype. The heads' width hd is
    Wq's column count (D, or a rank's shard of it)."""
    dt = x.dtype
    b = x.shape[0]
    hd = wq.shape[1]
    d = hd // heads
    scale = 1.0 / math.sqrt(d)
    xf = x.float()
    h = _r(_ln(xf, ln_g, ln_b, dt, eps), dt)
    q1 = _r(_proj(h, wq, bq, dt), dt)
    k1 = _r(_proj(h, wk, None, dt), dt)
    v1 = _r(_proj(h, wv, bv, dt), dt)
    qh = q1.reshape(b, heads, d)
    # fresh row: per-head sum of the dtype-rounded products q1*k1
    l_new = _r(q1 * k1, dt).reshape(b, heads, d).sum(-1) * scale   # [B, H]
    kc = k_cache[:, :pos].float().reshape(b, pos, heads, d)
    vc = v_cache[:, :pos].float().reshape(b, pos, heads, d)
    logits = torch.einsum("bhd,bthd->bht", qh, kc) * scale          # t < pos
    m = torch.maximum(logits.amax(-1), l_new) if pos else l_new
    p = torch.exp(logits - m[..., None])
    pn = torch.exp(l_new - m)
    denom = p.sum(-1) + pn
    p = _r(p / denom[..., None], dt)
    pn = _r(pn / denom, dt)
    row = torch.einsum("bht,bthd->bhd", p, vc)
    attn = _r((row + pn[..., None] * v1.reshape(b, heads, d))
              .reshape(b, hd), dt)
    y = _proj(attn, wo, None, dt)
    if partial:
        return y, k1.to(dt), v1.to(dt)
    return xf + (y + _r(bo, dt)), k1.to(dt), v1.to(dt)


def self_block_plain(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                     k_cache, v_cache, pos: int, *, heads: int,
                     eps: float = 1e-5, partial: bool = False):
    """B3 in plain PyTorch. x [B, D]; k_cache/v_cache [B, L, D] hold the
    rows t < pos (row pos and later are not read). Returns (x_out, k1,
    v1), all [B, D] in x's dtype; the caches are not written.
    ``partial`` (K3p's function): wq/wk/wv [D, heads*64], wo [heads*64,
    D], caches [B, L, heads*64]; the first output is the float32
    o-projection without x and bo (bo is not read), k1/v1 [B, heads*64]."""
    xo, k1, v1 = _self_block_math(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo,
                                  bo, k_cache, v_cache, int(pos), heads, eps,
                                  partial)
    return (xo if partial else xo.to(x.dtype)), k1, v1


def self_block_q_plain(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                       cross_ln_g, cross_ln_b, wcq, bcq,
                       k_cache, v_cache, pos: int, *, heads: int,
                       eps: float = 1e-5):
    """B5a in plain PyTorch: B3, then the cross-LN of the unrounded x_out
    and the cross q-projection. Returns (x_out, k1, v1, q_cross)."""
    dt = x.dtype
    xo, k1, v1 = _self_block_math(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo,
                                  bo, k_cache, v_cache, int(pos), heads, eps)
    h2 = _r(_ln(xo, cross_ln_g, cross_ln_b, dt, eps), dt)
    qc = _proj(h2, wcq, bcq, dt)
    return xo.to(dt), k1, v1, qc.to(dt)


def _mlp_math(xf, ln_g, ln_b, w1, b1, w2, b2, dt, eps, partial=False):
    h = _r(_ln(xf, ln_g, ln_b, dt, eps), dt)
    u = _r(gelu_as(_proj(h, w1, b1, dt)), dt)
    if partial:
        return _proj(u, w2, None, dt)
    return (xf + _proj(u, w2, b2, dt)).to(dt)


def mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5,
                    partial: bool = False):
    """B4 in plain PyTorch: x + fc2(gelu(fc1(LN x))), [B, D] in x's dtype.
    ``partial`` (K4p's function): w1 [D, F'], w2 [F', D] a rank's shard;
    the float32 fc2 sum alone, without x and b2 (b2 is not read)."""
    return _mlp_math(x.float(), ln_g, ln_b, w1, b1, w2, b2, x.dtype, eps,
                     partial)


def mlp_block_o_plain(x, attn, wco, bco, ln_g, ln_b, w1, b1, w2, b2, *,
                      eps: float = 1e-5):
    """B5b in plain PyTorch: x1 = x + attn @ Wco + bco (float32, attn
    rounded to x's dtype first), then x1 + fc2(gelu(fc1(LN x1)))."""
    dt = x.dtype
    x1 = x.float() + _proj(_r(attn, dt), wco, bco, dt)
    return _mlp_math(x1, ln_g, ln_b, w1, b1, w2, b2, dt, eps)


def cross_mlp_block_plain(x, ln2_g, ln2_b, wcq, bcq, wco, bco,
                          ln3_g, ln3_b, wm1, bm1, wm2, bm2, k_m, v_m, *,
                          heads: int, eps: float = 1e-5):
    """B12 in plain PyTorch, rounding where ``_cross_mlp_kernel`` rounds:
    h = LN2(x) and q1 = h @ Wcq + bcq in x's dtype; the unnormalised p =
    exp(logits - max) in x's dtype before PV, summed into l unrounded, and
    the division by l after PV; then mlp_block_o_plain (attn rounded
    before the o-projection, x1 float32 into the MLP). x [B, D]; k_m, v_m
    [B, T, D] merged-head cross K/V. Returns [B, D] in x's dtype."""
    dt = x.dtype
    b, hd = x.shape
    t, d = k_m.shape[1], hd // heads
    h = _r(_ln(x.float(), ln2_g, ln2_b, dt, eps), dt)
    q1 = _r(_proj(h, wcq, bcq, dt), dt).reshape(b, heads, d)
    kh, vh = (a.float().reshape(b, t, heads, d) for a in (k_m, v_m))
    logits = torch.einsum("bhd,bthd->bht", q1, kh) * (1.0 / math.sqrt(d))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    of = torch.einsum("bht,bthd->bhd", _r(p, dt), vh)
    attn = (of / p.sum(-1, keepdim=True)).reshape(b, hd)
    return mlp_block_o_plain(x, attn, wco, bco, ln3_g, ln3_b, wm1, bm1, wm2,
                             bm2, eps=eps)


# ------------------------------------------------------------- card side
_COUNTERS: dict = {}
_BUFS: dict = {}
# the bf16 forms' float32 inputs: the layer-norm scales and K4-o's attn
_F32 = frozenset(("ln_g", "cross_ln_g", "attn", "ln2_g", "ln3_g"))
# the kernels without a float32 form, and why
_BF16_ONLY = {"K14": "no decode step calls it, so the float32 queue has "
                     "no row for it"}
MAX_D = 2048  # K4's widest row: its layer norm holds 8 values a thread


def _counters(device: torch.device) -> int:
    """Pointer of the zeroed int32 barrier counters of K4 (and K14, which
    runs K4's body); each launch leaves them zero again. One set per
    device: the kernels run on one stream at a time."""
    c = _COUNTERS.get(device)
    if c is None:
        t = torch.zeros(4, dtype=torch.int32, device=device)
        c = _COUNTERS[device] = (t.data_ptr(), t)
    return c[0]


def _buf(device: torch.device, name: str, numel: int,
         dtype: torch.dtype) -> int:
    """Pointer of the persistent scratch ``name`` on ``device``, at least
    ``numel`` elements; a call that needs more replaces it with a larger
    one (the allocator orders the old one's reuse on the stream)."""
    t = _BUFS.get((device, name))
    if t is None or t.numel() < numel:
        t = _BUFS[(device, name)] = torch.empty(numel, dtype=dtype,
                                                device=device)
    return t.data_ptr()


def _is_f32(kernel: str, x: torch.Tensor) -> bool:
    """Whether ``kernel`` runs its float32 form: x float32 (K3, K3-q, K4,
    K4-o, K3p, K4p; the kernels of _BF16_ONLY raise), x bf16 its bf16
    form; any other dtype raises."""
    if x.dtype == torch.bfloat16:
        return False
    if x.dtype != torch.float32:
        raise TypeError(f"{kernel} takes bf16 or float32 tensors of one "
                        f"dtype, x is {x.dtype}")
    if kernel in _BF16_ONLY:
        raise TypeError(f"{kernel} takes bf16 tensors (float32 layer-norm "
                        f"scales), x is float32: it has no float32 form, "
                        f"{_BF16_ONLY[kernel]}")
    return True


def _check(kernel: str, ref: torch.Tensor, f32: bool, **tensors) -> None:
    """Raise on a tensor the kernel does not take: every tensor float32
    (``f32``, the float32 form) or bf16 but the _F32 names; one combined
    test on the common path, the culprit named only when it fails."""
    ok, ptrs = True, 0
    for name, a in tensors.items():
        ptrs |= a.data_ptr()
        ok = ok and a.device == ref.device and a.is_contiguous() and \
            a.dtype == (torch.float32 if f32 or name in _F32
                        else torch.bfloat16)
    if ok and not ptrs % 16:
        return
    for name, a in tensors.items():
        if a.device != ref.device:
            raise ValueError(f"{kernel}: {name} on {a.device}, x on "
                             f"{ref.device}")
        want = torch.float32 if f32 or name in _F32 else torch.bfloat16
        if a.dtype != want:
            form = "float32" if f32 else "bf16 (float32 layer-norm scales)"
            raise TypeError(f"{kernel} takes {form} tensors of one dtype; "
                            f"{name} is {a.dtype}, x {ref.dtype}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{kernel} takes a contiguous 16-byte aligned "
                             f"{name}")


def _shape(kernel: str, a: torch.Tensor, want: tuple, name: str) -> None:
    if tuple(a.shape) != want:
        raise ValueError(f"{kernel}: {name} is {tuple(a.shape)}, expected "
                         f"{want}")


# K3's cluster plan. The figures mirror csrc/decoder_block.cu's k3_smem.
K3_MAX_CLUSTER = 16       # blocks a cluster: an H100's limit (> 8:
                          # a non-portable size the kernel allows)
K3_ROWS = 16              # batch rows a tile: one m16 fragment
K3_MAX_STAGES = 24        # weight-ring slots of 8 KB
K3_MIN_STAGES = 6         # a q/k/v group of three tiles and three ahead
K3_SMEM = 232448 - 1024   # an H100 block's, less the static arrays'
K3_CLUSTERS = 15          # clusters of 8 such blocks an H100 holds at once
_FIT: dict = {}


def k3_smem(d: int, l: int, stages: int, rows: int) -> int:
    """Bytes of shared memory a K3 block takes at width d, cache length l,
    ``stages`` ring slots and ``rows`` rows a tile: 1 KB to align the
    ring, the ring, the o-projection partials [rows, d + 4] float32, h
    [rows + 1, d + 8] bf16 (a zero row), q1/k1/v1 [rows, 68] float32, the
    fresh-row weights, the logits [rows, l] (or the warps' PV partials
    [8, rows, 64], the larger) and the attention output [16, 72] bf16."""
    scores = -(-max(rows * l, 8 * rows * 64) // 4) * 4
    return (1024 + stages * 64 * 64 * 2 + rows * (d + 4) * 4
            + (rows + 1) * (d + 8) * 2 + 3 * rows * 68 * 4 + K3_ROWS * 4
            + scores * 4 + K3_ROWS * 72 * 2)


def self_block_plan(b: int, heads: int, l: int, rows: int | None = None,
                    clusters: int = K3_CLUSTERS, d: int | None = None
                    ) -> tuple[int, int, int, int, int]:
    """(most heads a block, blocks a cluster, rows a tile, tiles, ring
    stages) of K3 at batch b and cache length l, on a card that holds
    ``clusters`` such clusters at once. The cluster holds CS = min(H,
    K3_MAX_CLUSTER) blocks, rank r the heads [r H / CS, (r + 1) H / CS)
    (whisper-tiny, -base and -small: one head a block; -large: 20 heads
    over 16 blocks, one or two each), and sums those heads' columns of the
    output. An SM pulls ~30 GB/s whatever the
    copy (PERF.md), and a block reads its heads' weights whole once a
    tile, so there are as many tiles as the card holds clusters: the
    fewest rows a tile (up to K3_ROWS) that keep the tiles within
    ``clusters`` (B=32 at base width on an H100: 3 rows, 11 tiles).
    ``rows`` overrides that. The ring takes what shared memory is left,
    at least K3_MIN_STAGES slots (at 16 rows, D <= 1344 at L <= 512:
    every Whisper width). ``d``: the model width where it is not heads *
    64 (K3p: a rank's heads of a wider model)."""
    d = d or heads * 64
    cs = min(heads, K3_MAX_CLUSTER)
    if rows is None:
        rows = min(K3_ROWS, max(1, -(-b // clusters)))
    if not 1 <= rows <= K3_ROWS:
        raise ValueError(f"K3 tiles hold 1..{K3_ROWS} rows, got {rows}")
    stages = min(K3_MAX_STAGES,
                 (K3_SMEM - k3_smem(d, l, 0, rows)) // (64 * 64 * 2))
    if stages < K3_MIN_STAGES:
        raise ValueError(f"K3 does not fit D={d}, L={l}, {rows} rows a "
                         f"tile in shared memory")
    return -(-heads // cs), cs, rows, -(-b // rows), stages


# The float32 decoder blocks (csrc/decoder_block_f32.cu): a weight ring of
# F32_STAGES slots of F32_SLOT floats, an input window of F32_HBUF floats,
# a partials region of F32_RED floats, five row-statistics arrays of
# F32_MAXB floats; micro-tiles of 4 rows x 8 columns, at most
# F32_MAXMT a thread of 256; K3 on clusters of K3F_CS blocks, K4 on
# clusters of K4F_CS
F32_SLOT, F32_HBUF, F32_RED, F32_MAXB = 2048, 16896, 16384, 256
F32_STAGES, F32_MAXMT, F32_NT = 11, 2, 256
F32_SMEM = 128 + 4 * (F32_STAGES * F32_SLOT + F32_HBUF + F32_RED
                      + 5 * F32_MAXB)
K3F_CS, K4F_CS = 2, 8
# clusters of two / eight such blocks an H100 holds at once (the plans'
# defaults; the wrappers ask the card)
K3F_CLUSTERS, K4F_CLUSTERS = 66, 15


class F32Plan(NamedTuple):
    """A float32 decoder block's launch: ``blocks`` in ``clusters``
    clusters of ``cluster`` blocks, every block resident at once (one a
    multiprocessor), a ring of ``stages`` weight slots, ``rows`` batch
    rows a pass over the weights and ``passes`` passes."""
    blocks: int
    cluster: int
    clusters: int
    stages: int
    rows: int
    passes: int


def f32_tile_rows(nc: int, rb: int) -> int:
    """Rows of a weight tile of ``nc`` columns when the input window holds
    ``rb`` rows (csrc/decoder_block_f32.cu's tile_rows): what a slot
    takes, and no more than a window row, in multiples of 32 (of 8 below
    32); 0 where nc does not fit a slot."""
    t = min(F32_SLOT // nc, F32_HBUF // rb - 4)
    return t // 32 * 32 if t >= 32 else t // 8 * 8


def _split(n: int, parts: int, i: int) -> tuple[int, int]:
    """Part i of [0, n) cut in ``parts`` contiguous pieces, as the
    kernels cut it: [i n / parts, (i + 1) n / parts)."""
    return i * n // parts, (i + 1) * n // parts


def _seg_fits(groups: int, parts: int, rb: int) -> bool:
    """csrc/decoder_block_f32.cu's seg_fits: ``groups`` 8-column groups
    over ``parts`` blocks fit a slot and a thread's micro-tiles at ``rb``
    rows."""
    nc = 8 * -(-groups // parts)
    return f32_tile_rows(nc, rb) >= 8 and rb * nc <= F32_MAXMT * F32_NT * 32


def self_block_f32_plan(b: int, heads: int, l: int,
                        clusters: int = K3F_CLUSTERS, d: int | None = None
                        ) -> F32Plan:
    """K3's float32 form at batch b and cache length l on a card that
    holds ``clusters`` clusters of K3F_CS blocks at once: every cluster
    the card holds (66 on an H100: all 132 multiprocessors), under a
    cooperative launch. Each block streams its share of the weights once
    a launch (``self_block_f32_partition``) over every row of the batch:
    one pass. A ValueError names the limit a shape breaks: b <= 256, l <=
    F32_RED (the logits of one attention item), and each phase's columns
    within a block's slot and micro-tiles (``_seg_fits``). ``d``: the
    model width where it is not heads * 64 (K3p: a rank's heads of a
    wider model)."""
    d = d or heads * 64
    hl = heads * 64
    bp = -(-b // 4) * 4
    if not 1 <= b <= F32_MAXB:
        raise ValueError(f"K3's float32 form takes 1..{F32_MAXB} rows, got "
                         f"B={b}")
    if not 1 <= l <= F32_RED:
        raise ValueError(f"K3's float32 form takes caches of 1..{F32_RED} "
                         f"rows (an item's logits in {F32_RED} floats), "
                         f"got L={l}")
    for what, groups in (("q/k/v", 3 * hl // 8), ("o", d // 8)):
        if not _seg_fits(groups, clusters, bp):
            raise ValueError(
                f"K3's float32 form does not fit the {what} projection at "
                f"D={d}, H={heads}, B={b} on {clusters} clusters: a "
                f"block's {8 * -(-groups // clusters)} columns exceed its "
                f"{F32_SLOT}-float slot or {F32_MAXMT} micro-tiles a "
                f"thread")
    return F32Plan(K3F_CS * clusters, K3F_CS, clusters, F32_STAGES, bp, 1)


def mlp_f32_plan(b: int, d: int, f: int, clusters: int = K4F_CLUSTERS
                 ) -> F32Plan:
    """K4's float32 form at batch b, width d and MLP width f on a card
    that holds ``clusters`` clusters of K4F_CS blocks at once (15 on an
    H100, 120 blocks), under a cooperative launch: the rows a pass are
    the most (a multiple of 4, at most 256) whose micro-tiles fit a
    thread's MAXMT at the block's widest columns (its fc1 share or its D
    / 8 / K4F_CS fc2 columns), balanced over the passes (one at B <= 64
    for every Whisper width). A ValueError names the limit a shape
    breaks."""
    if not 1 <= b <= F32_MAXB:
        raise ValueError(f"K4's float32 form takes 1..{F32_MAXB} rows, got "
                         f"B={b}")
    if d % 64 or not 64 <= d <= MAX_D or f % 16 or f < 16:
        raise ValueError(f"K4's float32 form takes D % 64 == 0, 64 <= D <= "
                         f"{MAX_D}, F % 16 == 0: D={d}, F={f}")
    ngc = -(-(f // 8) // clusters)
    nc = 8 * max(-(-ngc // K4F_CS), -(-(d // 8) // K4F_CS))
    bp = -(-b // 4) * 4
    rows = min(F32_MAXB, F32_MAXMT * F32_NT * 32 // nc // 4 * 4)
    passes = -(-bp // rows)
    rows = -(-(-(-bp // passes)) // 4) * 4
    if not (_seg_fits(ngc, K4F_CS, rows) and _seg_fits(d // 8, K4F_CS, rows)):
        raise ValueError(f"K4's float32 form does not fit D={d}, F={f} on "
                         f"{clusters} clusters of {K4F_CS}")
    return F32Plan(K4F_CS * clusters, K4F_CS, clusters, F32_STAGES, rows,
                   passes)


def rowproj_f32_plan(b: int, d: int, clusters: int = K3F_CLUSTERS
                     ) -> F32Plan:
    """K4-o's float32 row projection (x + attn @ Wco + bco): clusters of
    K3F_CS blocks, one 8-column group of the d columns at least a
    cluster, at most the clusters the card holds."""
    nc = min(clusters, d // 8)
    bp = -(-b // 4) * 4
    if not _seg_fits(d // 8, nc, bp):
        raise ValueError(f"K4-o's float32 row projection does not fit D={d} "
                         f"at B={b}")
    return F32Plan(K3F_CS * nc, K3F_CS, nc, F32_STAGES, bp, 1)


def self_block_f32_partition(plan: F32Plan, heads: int, d: int | None = None,
                             tail: bool = False) -> list[tuple]:
    """The weight tiles each block of K3's float32 form streams, as
    (block, matrix, (row0, row1), (col0, col1)) of the [in, out] matrices
    wq/wk/wv [D, H * 64], wo [H * 64, D] and, with ``tail``, wcq [D, D]:
    cluster c's 8-column groups [c n / NC, (c + 1) n / NC) of each
    projection's columns, its rank r the rows [r n_in / 2, (r + 1) n_in /
    2). The kernel's make_seg and copy_tile cut them so; each weight
    byte belongs to one block and is read once a launch."""
    d = d or heads * 64
    hl = heads * 64
    out = []
    for blk in range(plan.blocks):
        c, r = divmod(blk, plan.cluster)
        g0, g1 = _split(3 * hl // 8, plan.clusters, c)
        for g in range(g0, g1):
            m, col = divmod(8 * g, hl)
            out.append((blk, ("wq", "wk", "wv")[m],
                        _split(d, plan.cluster, r), (col, col + 8)))
        segs = [("wo", hl)] + ([("wcq", d)] if tail else [])
        for name, n_in in segs:
            g0, g1 = _split(d // 8, plan.clusters, c)
            for g in range(g0, g1):
                out.append((blk, name, _split(n_in, plan.cluster, r),
                            (8 * g, 8 * g + 8)))
    return out


def mlp_f32_partition(plan: F32Plan, d: int, f: int, head: bool = False,
                      proj: F32Plan | None = None) -> list[tuple]:
    """The weight tiles each block of K4's float32 form streams, as
    (block, matrix, (row0, row1), (col0, col1)) of w1 [D, F] and w2 [F,
    D]: cluster c the 8-column groups [c n / NC, (c + 1) n / NC) of fc1's
    F columns, rank r its share of them (all D rows) and, of w2, the rows
    of the cluster's F columns and its D / 8 / K4F_CS groups of the D
    columns. With ``head`` also K4-o's row projection's blocks (numbered
    after K4's) over wco [D, D] on ``proj``'s clusters of two. Each weight
    byte belongs to one block (K4 re-reads its tiles once a pass where
    ``plan.passes`` > 1)."""
    out = []
    for blk in range(plan.blocks):
        c, r = divmod(blk, plan.cluster)
        cf0, cf1 = _split(f // 8, plan.clusters, c)
        q0, q1 = _split(cf1 - cf0, plan.cluster, r)
        for g in range(cf0 + q0, cf0 + q1):
            out.append((blk, "w1", (0, d), (8 * g, 8 * g + 8)))
        g0, g1 = _split(d // 8, plan.cluster, r)
        for g in range(g0, g1):
            out.append((blk, "w2", (8 * cf0, 8 * cf1), (8 * g, 8 * g + 8)))
    if head:
        for blk in range(proj.blocks):
            c, r = divmod(blk, proj.cluster)
            g0, g1 = _split(d // 8, proj.clusters, c)
            for g in range(g0, g1):
                out.append((plan.blocks + blk, "wco",
                            _split(d, proj.cluster, r), (8 * g, 8 * g + 8)))
    return out


def _fit(dev: torch.device, cs: int, smem: int,
         name: str = "mas_decoder_self_block_fit") -> int:
    """The clusters of cs K3 blocks of ``smem`` bytes ``dev`` holds at
    once (``name``: the bf16 or the float32 form's query), asked of the
    card once per shape."""
    key = (dev, cs, smem, name)
    n = _FIT.get(key)
    if n is None:
        out = ctypes.c_int(0)
        runtime.launch(name, dev, cs, smem, ctypes.byref(out))
        if out.value < 1:
            raise RuntimeError(f"K3: the card holds no cluster of {cs} "
                               f"blocks of {smem} bytes")
        n = _FIT[key] = out.value
    return n


def _launch_self(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo, k_cache,
                 v_cache, pos: int, heads: int, eps: float, tail=None,
                 rows: int | None = None, partial: bool = False):
    kernel = "K3-q" if tail else "K3p" if partial else "K3"
    f32 = _is_f32(kernel, x)
    b, d = x.shape
    hd = heads * 64
    if (d != hd and not partial) or d % 64 or (tail and partial):
        raise ValueError(f"{kernel} takes head dim 64: D={d}, heads={heads}")
    l = k_cache.shape[1]
    vecs = dict(ln_g=ln_g, ln_b=ln_b)
    heads_vecs = dict(bq=bq, bv=bv)
    mats = dict(wq=wq, wk=wk, wv=wv)
    if not partial:
        vecs["bo"] = bo
    if tail:
        vecs.update(cross_ln_g=tail[0], cross_ln_b=tail[1], bcq=tail[3])
        mats["wcq"] = tail[2]
    for name, a in vecs.items():
        _shape(kernel, a, (d,), name)
    for name, a in heads_vecs.items():
        _shape(kernel, a, (hd,), name)
    for name, a in mats.items():
        _shape(kernel, a, (d, hd), name)
    _shape(kernel, wo, (hd, d), "wo")
    _shape(kernel, v_cache, (b, l, hd), "v_cache")
    _shape(kernel, k_cache, (b, l, hd), "k_cache")
    _check(kernel, x, f32, x=x, k_cache=k_cache, v_cache=v_cache, wo=wo,
           **vecs, **heads_vecs, **mats)
    if not 0 <= pos < l:
        raise ValueError(f"{kernel}: pos {pos} outside [0, {l})")
    dev = x.device
    if f32:
        # clusters of two on every multiprocessor the card holds them on;
        # the scratch holds q, then the attention output
        plan = self_block_f32_plan(b, heads, l, _fit(
            dev, K3F_CS, F32_SMEM, "mas_decoder_self_block_f32_fit"), d=d)
        tail_args = (plan.clusters, 1.0 / math.sqrt(64), eps,
                     runtime.stream_handle(dev))
        scratch = (_buf(dev, "qa32", 2 * b * hd, torch.float32),
                   _counters(dev))
    else:
        # the clusters the card holds, asked at the largest tile's size
        _, cs, _, _, st = self_block_plan(b, heads, l, K3_ROWS, d=d)
        _, _, rt, _, stages = self_block_plan(
            b, heads, l, rows, _fit(dev, cs, k3_smem(d, l, st, K3_ROWS)),
            d=d)
        tail_args = (cs, rt, stages, 1.0 / math.sqrt(64), eps,
                     runtime.stream_handle(dev))
        scratch = ()
    if partial:
        out = torch.empty(b, d, dtype=torch.float32, device=dev)
        runtime.launch(
            "mas_decoder_self_block_partial" + ("_f32" if f32 else ""), dev,
            *(a.data_ptr() for a in (x, ln_g, ln_b, wq, bq, wk, wv, bv, wo,
                                     k_cache, v_cache, out)), *scratch,
            b, d, heads, l, int(pos), *tail_args)
        runtime.bump("decoder_self_block")
        return out, k_cache[:, pos], v_cache[:, pos]
    x_out = torch.empty_like(x)
    qc = torch.empty_like(x) if tail else None
    cross = tail or (None,) * 4
    runtime.launch(
        "mas_decoder_self_block_f32" if f32 else "mas_decoder_self_block",
        dev, x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
        wq.data_ptr(), bq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        bv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), x_out.data_ptr(),
        *(_ptr(a) for a in (*cross, qc)), *scratch,
        b, heads, l, int(pos), *tail_args)
    runtime.bump("decoder_self_block_q" if tail else "decoder_self_block")
    k1, v1 = k_cache[:, pos], v_cache[:, pos]
    return (x_out, k1, v1, qc) if tail else (x_out, k1, v1)


def _ptr(a: torch.Tensor | None) -> int:
    """Device address, or 0 (NULL) for an input the variant does not take."""
    return 0 if a is None else a.data_ptr()


def _store_row(k_cache, v_cache, pos: int, k1, v1):
    k_cache[:, pos] = k1
    v_cache[:, pos] = v1
    return k_cache[:, pos], v_cache[:, pos]


def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def fused_self_block(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                     k_cache, v_cache, pos: int, *, heads: int,
                     eps: float = 1e-5, partial: bool = False):
    """B3: returns (x_out, k1, v1) [B, D] and writes k1/v1 into row
    ``pos`` of the caches (k1/v1 are views of that row). ``pos`` is a
    host int. CUDA tensors launch K3 (``partial``: K3p, whose first output
    is the float32 o-projection of the rank's heads, module docstring),
    CPU tensors take the plain version. On the card the tensors are all
    bf16 but the float32 LN scale (K3, K3p) or all float32 (their float32
    forms)."""
    runtime.refuse_grad("K3", x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                        k_cache, v_cache)
    pos = int(pos)
    if _device(x) == "cuda":
        return _launch_self(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                            k_cache, v_cache, pos, heads, eps,
                            partial=partial)
    xo, k1, v1 = self_block_plain(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                                  k_cache, v_cache, pos, heads=heads, eps=eps,
                                  partial=partial)
    return (xo, *_store_row(k_cache, v_cache, pos, k1, v1))


def fused_self_block_q(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                       cross_ln_g, cross_ln_b, wcq, bcq,
                       k_cache, v_cache, pos: int, *, heads: int,
                       eps: float = 1e-5):
    """B5a: fused_self_block + the cross-LN and cross q-projection of its
    output. Returns (x_out, k1, v1, q_cross); the cache row is written as
    in fused_self_block. CUDA tensors launch K3-q (the K3 kernel's tail
    variant), CPU tensors take the plain version."""
    runtime.refuse_grad("K3-q", x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                        cross_ln_g, cross_ln_b, wcq, bcq, k_cache, v_cache)
    pos = int(pos)
    if _device(x) == "cuda":
        return _launch_self(x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo,
                            k_cache, v_cache, pos, heads, eps,
                            tail=(cross_ln_g, cross_ln_b, wcq, bcq))
    xo, k1, v1, qc = self_block_q_plain(
        x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo, cross_ln_g, cross_ln_b,
        wcq, bcq, k_cache, v_cache, pos, heads=heads, eps=eps)
    return (xo, *_store_row(k_cache, v_cache, pos, k1, v1), qc)


def _launch_mlp(x, ln_g, ln_b, w1, b1, w2, b2, eps: float, head=None,
                partial: bool = False):
    kernel = "K4-o" if head else "K4p" if partial else "K4"
    f32 = _is_f32(kernel, x)
    b, hd = x.shape
    f = w1.shape[1]
    if hd % 64 or hd > MAX_D or f % 32 or (head and partial):
        raise ValueError(f"{kernel} takes D % 64 == 0, D <= {MAX_D} and "
                         f"F % 32 == 0: D={hd}, F={f}")
    vecs = dict(ln_g=ln_g, ln_b=ln_b) if partial else \
        dict(ln_g=ln_g, ln_b=ln_b, b2=b2)
    _shape(kernel, b1, (f,), "b1")
    _shape(kernel, w1, (hd, f), "w1")
    _shape(kernel, w2, (f, hd), "w2")
    extra = {}
    if head:
        attn, wco, bco = head
        _shape(kernel, attn, (b, hd), "attn")
        _shape(kernel, wco, (hd, hd), "wco")
        vecs["bco"] = bco
        extra = dict(attn=attn, wco=wco)
    for name, a in vecs.items():
        _shape(kernel, a, (hd,), name)
    _check(kernel, x, f32, x=x, b1=b1, w1=w1, w2=w2, **vecs, **extra)
    dev = x.device
    if f32:
        return _launch_mlp_f32(x, ln_g, ln_b, w1, b1, w2, b2, eps, head,
                               partial)
    h = _buf(dev, "h", b * hd, torch.bfloat16)
    if partial:
        out = torch.empty(b, hd, dtype=torch.float32, device=dev)
        runtime.launch(
            "mas_decoder_mlp_block_partial", dev,
            *(a.data_ptr() for a in (x, ln_g, ln_b, w1, b1, w2)), h,
            _buf(dev, "part", f // 32 * b * hd, torch.float32),
            _counters(dev), out.data_ptr(), b, hd, f, eps,
            runtime.sm_count(dev), runtime.raw_stream(dev))
        runtime.bump("decoder_mlp_block")
        return out
    out = torch.empty_like(x)
    runtime.launch(
        "mas_decoder_mlp_block", dev,
        x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        *(_ptr(a) for a in (head or (None,) * 3)),
        _buf(dev, "x32", b * hd, torch.float32) if head else 0, h,
        _buf(dev, "part", f // 32 * b * hd, torch.float32),
        _counters(dev), out.data_ptr(), b, hd, f, eps,
        runtime.sm_count(dev), runtime.raw_stream(dev))
    runtime.bump("decoder_mlp_block_o" if head else "decoder_mlp_block")
    return out


def mlp_f32_plans(dev: torch.device, b: int, d: int, f: int,
                  head: bool = False) -> tuple[F32Plan, F32Plan | None]:
    """K4's float32 plan on ``dev`` (its clusters of K4F_CS the card
    holds) and, with ``head``, K4-o's row projection's (clusters of
    K3F_CS)."""
    plan = mlp_f32_plan(b, d, f, _fit(dev, K4F_CS, F32_SMEM,
                                      "mas_decoder_self_block_f32_fit"))
    proj = rowproj_f32_plan(b, d, _fit(
        dev, K3F_CS, F32_SMEM, "mas_decoder_self_block_f32_fit")) \
        if head else None
    return plan, proj


def _launch_mlp_f32(x, ln_g, ln_b, w1, b1, w2, b2, eps: float, head,
                    partial: bool):
    """K4's, K4-o's and K4p's float32 forms (checked by _launch_mlp): the
    cluster partials [clusters, B, D] float32 in a persistent scratch."""
    b, hd = x.shape
    f = w1.shape[1]
    dev = x.device
    plan, proj = mlp_f32_plans(dev, b, hd, f, bool(head))
    part = _buf(dev, "part", plan.clusters * b * hd, torch.float32)
    out = torch.empty(b, hd, dtype=torch.float32, device=dev)
    tail = (_counters(dev), out.data_ptr(), b, hd, f, eps, plan.clusters,
            plan.rows)
    if partial:
        runtime.launch(
            "mas_decoder_mlp_block_partial_f32", dev,
            *(a.data_ptr() for a in (x, ln_g, ln_b, w1, b1, w2)), part,
            *tail, runtime.raw_stream(dev))
        runtime.bump("decoder_mlp_block")
        return out
    runtime.launch(
        "mas_decoder_mlp_block_f32", dev,
        *(a.data_ptr() for a in (x, ln_g, ln_b, w1, b1, w2, b2)),
        *(_ptr(a) for a in (head or (None,) * 3)),
        _buf(dev, "x32", b * hd, torch.float32) if head else 0, part,
        *tail, proj.clusters if head else 0, runtime.raw_stream(dev))
    runtime.bump("decoder_mlp_block_o" if head else "decoder_mlp_block")
    return out


def fused_mlp_block(x, ln_g, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5,
                    partial: bool = False):
    """B4: x + fc2(gelu(fc1(LN x))), [B, D]. CUDA tensors launch K4 (which
    takes erff for the erf of the GELU; ``partial``: K4p, the float32 fc2
    sum of a rank's F/mp columns alone, module docstring), or on float32
    tensors K4's (K4p's) float32 form (the plain version's erf
    polynomial), CPU tensors the plain version."""
    runtime.refuse_grad("K4", x, ln_g, ln_b, w1, b1, w2, b2)
    if _device(x) == "cuda":
        return _launch_mlp(x, ln_g, ln_b, w1, b1, w2, b2, eps,
                           partial=partial)
    return mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2, eps=eps,
                           partial=partial)


def fused_mlp_block_o(x, attn, wco, bco, ln_g, ln_b, w1, b1, w2, b2, *,
                      eps: float = 1e-5):
    """B5b: the cross o-projection + residual, then B4. ``attn`` is the
    cross attention's float32 output [B, D]. CUDA tensors launch K4-o
    (the K4 kernel's head variant), CPU tensors the plain version."""
    runtime.refuse_grad("K4-o", x, attn, wco, bco, ln_g, ln_b, w1, b1, w2,
                        b2)
    if _device(x) == "cuda":
        return _launch_mlp(x, ln_g, ln_b, w1, b1, w2, b2, eps,
                           head=(attn, wco, bco))
    return mlp_block_o_plain(x, attn, wco, bco, ln_g, ln_b, w1, b1, w2, b2,
                             eps=eps)


# K14's attention: split-T over a thread-block cluster of up to
# X_MAX_CLUSTER blocks a (batch row, head), at least X_KEYS_PER_BLOCK keys
# a block where there are enough; a block holds the first X_PREFIX of its
# V rows in shared memory and asks at most X_SMEM_LIMIT bytes
# (csrc/decoder_block.cu's x_smem_bytes, mirrored in cross_smem_bytes).
X_MAX_CLUSTER, X_KEYS_PER_BLOCK, X_SMEM_LIMIT = 16, 64, 200 * 1024
X_PREFIX = 320
X_ROWS = 32   # key rows a pass of the block's 256 threads
_X_FIT: dict = {}
_X_PLAN: dict = {}   # cross_plan by (device, T, H, B), asked once


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def cross_smem_bytes(chunk: int) -> int:
    """The dynamic shared memory of a K14 attention block of ``chunk``
    keys: 128 bytes to align, the first X_PREFIX of its V rows (128 bytes
    each) in whole TMA boxes of at most 256 rows, later its row groups'
    p . V partials, then the logits, later the row groups' sums."""
    p = min(chunk, X_PREFIX)
    nbox = -(-p // 256)
    r = -(-p // nbox)
    v = max(-(-p // r) * r * 128, X_ROWS * 64 * 4)
    return 128 + _align128(v) + _align128(4 * max(chunk, X_ROWS))


def cross_plan(t: int, heads: int, b: int = 1, fit=None,
               cluster: int | None = None) -> tuple[int, int]:
    """(blocks a cluster, keys a block) of K14's attention over t keys
    for b x heads (batch row, head) rows: rank r takes the keys [r chunk,
    min(t, (r + 1) chunk)), so the ranks cover every key once. ``fit(cs,
    chunk)`` is how many clusters of cs blocks the card holds at once
    (None: no limit). As K6's and K7's plans, the largest cluster whose
    b x heads clusters are all resident at once (at most X_MAX_CLUSTER,
    at least X_KEYS_PER_BLOCK keys a block where there are enough), so the
    keys stream in one wave and every multiprocessor's link is kept busy
    by several blocks (on an H100 at B=32, T=1500: 2 blocks of 750 keys
    at both Whisper widths, four blocks an SM); where none is, the
    smallest, whose blocks each stream the most keys. ``cluster`` forces
    the size (the card tests use it)."""
    if t < 1:
        raise ValueError(f"K14 attends at least one key, got T={t}")
    if cluster is not None and not 1 <= cluster <= X_MAX_CLUSTER:
        raise ValueError(f"K14 clusters hold 1..{X_MAX_CLUSTER} blocks, "
                         f"got {cluster}")
    top = min(X_MAX_CLUSTER, -(-t // X_KEYS_PER_BLOCK))
    sizes = [c for c in ([cluster] if cluster else range(top, 0, -1))
             if cross_smem_bytes(-(-t // c)) <= X_SMEM_LIMIT
             and (fit is None or fit(c, -(-t // c)) >= 1)]
    if not sizes:
        raise ValueError(f"K14: no cluster of {cluster or X_MAX_CLUSTER} "
                         f"blocks the card places holds T={t} keys in "
                         f"{X_SMEM_LIMIT} bytes a block")
    cs = next((c for c in sizes if fit is None
               or fit(c, -(-t // c)) >= b * heads), sizes[-1])
    return cs, -(-t // cs)


def _fit_cross(dev: torch.device):
    """fit() for cross_plan on ``dev``, asked of the card once per shape."""
    def fit(cs: int, chunk: int) -> int:
        key = (dev, cs, chunk)
        if key not in _X_FIT:
            out = ctypes.c_int(0)
            runtime.launch("mas_cross_mlp_attention_fit", dev, cs, chunk,
                           ctypes.byref(out))
            _X_FIT[key] = out.value
        return _X_FIT[key]
    return fit


def _launch_cross_mlp(x, ln2_g, ln2_b, wcq, bcq, wco, bco, ln3_g, ln3_b,
                      wm1, bm1, wm2, bm2, k_m, v_m, heads: int, eps: float,
                      cluster: int | None = None):
    b, hd = x.shape
    f = wm1.shape[1]
    if hd != heads * 64 or hd > MAX_D or f % 32:
        raise ValueError(f"K14 takes head dim 64, D <= {MAX_D} and F % 32 "
                         f"== 0: D={hd}, heads={heads}, F={f}")
    t = k_m.shape[1]
    vecs = dict(ln2_g=ln2_g, ln2_b=ln2_b, bcq=bcq, bco=bco, ln3_g=ln3_g,
                ln3_b=ln3_b, bm2=bm2)
    for name, a in vecs.items():
        _shape("K14", a, (hd,), name)
    for name, a in dict(wcq=wcq, wco=wco).items():
        _shape("K14", a, (hd, hd), name)
    _shape("K14", wm1, (hd, f), "wm1")
    _shape("K14", bm1, (f,), "bm1")
    _shape("K14", wm2, (f, hd), "wm2")
    _shape("K14", k_m, (b, t, hd), "k_m")
    _shape("K14", v_m, (b, t, hd), "v_m")
    _check("K14", x, _is_f32("K14", x), x=x, wcq=wcq, wco=wco, wm1=wm1,
           bm1=bm1, wm2=wm2, k_m=k_m, v_m=v_m, **vecs)
    dev = x.device
    if cluster is None:   # one lookup a shape and card
        key = (dev, t, heads, b)
        if key not in _X_PLAN:
            _X_PLAN[key] = cross_plan(t, heads, b, _fit_cross(dev))
        cs, chunk = _X_PLAN[key]
    else:
        cs, chunk = cross_plan(t, heads, b, _fit_cross(dev), cluster)
    f32 = torch.float32
    q1, out = torch.empty_like(x), torch.empty_like(x)
    runtime.launch(
        "mas_cross_mlp_block", dev,
        *(a.data_ptr() for a in (x, ln2_g, ln2_b, wcq, bcq, wco, bco, ln3_g,
                                 ln3_b, wm1, bm1, wm2, bm2, k_m, v_m, q1)),
        _buf(dev, "attn", b * hd, f32), _buf(dev, "x32", b * hd, f32),
        _buf(dev, "h", b * hd, torch.bfloat16),
        _buf(dev, "part", f // 32 * b * hd, f32), _counters(dev),
        out.data_ptr(), b, heads, t, f, cs, chunk, 1.0 / math.sqrt(64), eps,
        runtime.sm_count(dev), runtime.stream_handle(dev))
    runtime.bump("cross_mlp_block")
    return out


def fused_cross_mlp_block(x, ln2_g, ln2_b, wcq, bcq, wco, bco, ln3_g, ln3_b,
                          wm1, bm1, wm2, bm2, k_m, v_m, *, heads: int,
                          eps: float = 1e-5):
    """B12: x -> x1 = x + cross attention of LN2(x) over k_m/v_m [B, T, D]
    @ Wco + bco -> x1 + fc2(gelu(fc1(LN3 x1))), [B, D]. CUDA tensors
    launch K14 (one C call: the LN + row projection, B12's attention split
    over the keys of a thread-block cluster by cross_plan, K4-o's
    o-projection + MLP; bf16, float32 LN scales), CPU tensors the plain
    version."""
    runtime.refuse_grad("K14", x, ln2_g, ln2_b, wcq, bcq, wco, bco, ln3_g,
                        ln3_b, wm1, bm1, wm2, bm2, k_m, v_m)
    if _device(x) == "cuda":
        return _launch_cross_mlp(x, ln2_g, ln2_b, wcq, bcq, wco, bco, ln3_g,
                                 ln3_b, wm1, bm1, wm2, bm2, k_m, v_m, heads,
                                 eps)
    return cross_mlp_block_plain(x, ln2_g, ln2_b, wcq, bcq, wco, bco, ln3_g,
                                 ln3_b, wm1, bm1, wm2, bm2, k_m, v_m,
                                 heads=heads, eps=eps)
