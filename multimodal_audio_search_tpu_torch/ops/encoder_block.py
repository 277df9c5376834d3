"""Encoder attention over all heads + o-projection + residual: K1 and its
variants K9 (int8 dots), K10 (head pairs) and K11 (the division A/B).

Counterpart of ``multimodal_audio_search_tpu/ops/encoder_block.py::
fused_attention_o_residual``: its default bf16 body (K1), its
``qk_int8=True`` body (K9, ``fused_encoder="int8"``) and its
``pair_heads=True`` body (K10, ``fused_encoder="paired"``); and of the A/B
copy ``tools/profile_encoder_kernel_ab.py::fused_v2`` (K11), which places
the softmax division three ways. ``partial=True`` is each body's form on
one rank of the mesh's model axis (K1p, K9p, K10p): the rank's H/mp heads
and the [H/mp * 64, HD_out] row shard of Wo give the float32 partial
``attn_local @ Wo_rows``, without x and bo, which
parallel/mesh.py::model_sum adds once to the ranks' sum (the head shard
of the JAX kernel's non-square Wo, which the JAX kernel documents for
every body). K9p's k/v are quantized per (b, h, t) row, so a head shard's
codes and scales are the whole layer's. K10p pairs the rank's own heads
(0, 1), (2, 3), ...; ranks split heads in contiguous blocks, so these are
the whole layer's pairs. A rank with an odd head count takes K1p for
``pair_heads``, as ``encode`` takes K1 for an odd head count. On a CUDA
tensor each wrapper launches its hand-written kernel (K1, K1p, K10, K10p
and K11 ``csrc/encoder_block_wgmma.cu``: a thread-block cluster over the
heads of a 128-row tile, sized by ``cluster_plan`` for the card it runs
on; K11's "post" form is K1 itself; K9 and K9p
``csrc/encoder_block_int8.cu``); on a CPU tensor it runs the plain
PyTorch version beside it, the same math. The form is chosen by the
tensors' dtype, as the TPU kernels cast q, Wo and bo to x's: bf16 tensors
launch the kernels above, float32 tensors their float32 forms (K1, K1p,
K10, K10p ``csrc/encoder_block_f32.cu``: a cluster of ``f32_cluster(H)``
blocks over a 64-row tile (K10 whole pairs a block), each float32 product
as three TF32 products; K9, K9p the int8 loop on a float32 q into a
float32 scratch, then its 3xTF32 o-projection), any other dtype or a mix
raises. K11 takes bf16 only: it is the A/B tool's form. There is no other
route: a launch that fails, or a cluster the card cannot place, raises.
K1p, K9p and K10p (and every float32 form) count as their square bf16
forms' launches (runtime.COUNTS).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import runtime
from .cached_attention import div_exact, quantize_kv


def _merge_partial(attn, wo):
    """attn @ Wo in float32 from the [B, H, T, D] float32 attention
    output, merged and rounded to Wo's dtype before the o-projection."""
    b, h, t, d = attn.shape
    a = attn.transpose(1, 2).reshape(b, t, h * d).to(wo.dtype)
    return torch.matmul(a.float(), wo.float())


def _merge_o_residual(attn, x, wo, bo):
    """x + attn @ Wo + bo from the [B, H, T, D] float32 attention output:
    merged and rounded to Wo's dtype before the o-projection, the sum to
    x's dtype, as the TPU kernels round."""
    y = _merge_partial(attn, wo) + bo.float()
    return (x.float() + y).to(x.dtype)


def attention_o_residual_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,  # [B, H, T, D]
    x: torch.Tensor | None,                              # [B, T, HD_out]
    wo: torch.Tensor, bo: torch.Tensor | None,  # [H*D, HD_out], [HD_out]
    partial: bool = False,
) -> torch.Tensor:
    """x + (softmax(QK^T/sqrt(D)) V, heads merged) @ Wo + bo in plain
    PyTorch: f32 scores, softmax and products on the given inputs; the
    merged attention output is rounded to Wo's dtype before the
    o-projection and the sum to x's dtype, as the TPU kernel rounds.
    ``partial``: the float32 ``(...) @ Wo`` alone (K1p's function; x and
    bo are not read and may be None)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    attn = torch.matmul(p, v.float())
    if partial:
        return _merge_partial(attn, wo)
    return _merge_o_residual(attn, x, wo, bo)


def attention_o_residual_paired_plain(q, k, v, x, wo, bo,
                                      partial: bool = False) -> torch.Tensor:
    """K10's function as the TPU kernel forms it: heads 2p and 2p+1 packed
    into one [T, 2D] query, block-diagonal [2D, 2T] keys and [2T, 2D]
    values, one [T, 2T] score tile whose two halves take their own
    softmax (f32 throughout, as attention_o_residual_plain). H even.
    ``partial``: the float32 ``(...) @ Wo`` alone (K10p's function)."""
    b, h, t, d = q.shape
    qp = torch.cat([q[:, 0::2], q[:, 1::2]], dim=-1).float()  # [B,P,T,2D]
    ke, ko = k[:, 0::2].float(), k[:, 1::2].float()             # [B,P,T,D]
    z = torch.zeros_like(ke)
    kb = torch.cat([torch.cat([ke, z], dim=-1),
                    torch.cat([z, ko], dim=-1)], dim=-2)         # [B,P,2T,2D]
    vb = torch.cat([torch.cat([v[:, 0::2].float(), z], dim=-1),
                    torch.cat([z, v[:, 1::2].float()], dim=-1)], dim=-2)
    s2 = torch.matmul(qp, kb.transpose(-1, -2)) / math.sqrt(d)  # [B,P,T,2T]
    p2 = torch.cat([torch.softmax(s2[..., :t], dim=-1),
                    torch.softmax(s2[..., t:], dim=-1)], dim=-1)
    o2 = torch.matmul(p2, vb)                                    # [B,P,T,2D]
    attn = torch.stack([o2[..., :d], o2[..., d:]], dim=2)        # [B,P,2,T,D]
    attn = attn.reshape(b, h, t, d)
    if partial:
        return _merge_partial(attn, wo)
    return _merge_o_residual(attn, x, wo, bo)


# K1's and K10's clusters: at most 16 blocks (an H100's non-portable
# limit), each attending one to BLOCK_HEADS heads (K10: whole pairs) and
# projecting their 64-column output chunks
MAX_CLUSTER = 16
BLOCK_HEADS = 4
# a block's o-projection, barriers and epilogue, in units of one head's
# attention over a 128-row tile (~7 of ~17 us on an H100, PERF.md)
BLOCK_OVERHEAD = 0.45
ROWS = 128  # query rows a cluster


def cluster_plan(heads: int, batch: int, t: int, fit,
                 pair_heads: bool = False) -> int:
    """Blocks of K1's (or K10's) thread-block cluster over the heads of
    one (batch, 128-row) tile. ``fit(cs)`` is how many clusters of ``cs``
    blocks the card holds at once (cluster_fit). Each size that leaves no
    block more than BLOCK_HEADS heads (K10: two pairs) is costed as waves
    of clusters x (heads a block + BLOCK_OVERHEAD), and the cheapest, then
    the smallest, is taken: on an H100 at B=32, T=1500 that is 2 blocks
    at whisper-tiny and -base (clusters of 2 fill all 132 multiprocessors,
    larger ones 102-120), 3 at -small, 4 at -medium and 5 at -large.
    Raises past 64 heads, or on an odd head count for K10."""
    g = 2 if pair_heads else 1
    if heads % g:
        raise ValueError(f"K10 pairs heads; H={heads} is odd")
    units = heads // g
    tiles = batch * -(-t // ROWS)
    best = None
    for cs in range(1, min(units, MAX_CLUSTER) + 1):
        per_block = -(-units // cs) * g
        held = fit(cs) * cs
        if per_block > BLOCK_HEADS or held < 1:
            continue
        cost = -(-tiles * cs // held) * (per_block + BLOCK_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, cs)
    if best is None:
        raise ValueError(f"K1/K10 take 1 to {BLOCK_HEADS * MAX_CLUSTER} "
                         f"heads; H={heads}")
    return best[1]


def cluster_ranks(heads: int, cs: int,
                  pair_heads: bool = False) -> list[list[int]]:
    """The heads each rank of a cluster of ``cs`` blocks attends and whose
    64 output columns it projects, as the kernel splits them: rank r takes
    the units [r U / cs, (r + 1) U / cs) (U = H heads, or H / 2 pairs)."""
    g = 2 if pair_heads else 1
    units = heads // g
    return [[h for u in range(r * units // cs, (r + 1) * units // cs)
             for h in range(u * g, u * g + g)] for r in range(cs)]


def output_chunks(chunks: int, cs: int) -> list[list[int]]:
    """The 64-column output chunks each rank of a cluster of ``cs`` blocks
    projects, as the kernel splits them: rank r the chunks [r N / cs,
    (r + 1) N / cs) of N = ``chunks`` (HD_out / 64). K1's square form has
    N = H, so each rank projects its own heads' chunks (cluster_ranks);
    K1p's N is the layer's width, not the rank's heads'."""
    return [list(range(r * chunks // cs, (r + 1) * chunks // cs))
            for r in range(cs)]


def _card(device) -> torch.device:
    """``device`` as a CUDA device with its index (None: the current one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _fit(cs: int, pair_heads: bool, device: torch.device) -> int:
    n = ctypes.c_int(0)
    runtime.launch("mas_encoder_block_fit", device, int(pair_heads), cs,
                   ctypes.byref(n))
    return n.value


def cluster_fit(cs: int, pair_heads: bool = False, device=None) -> int:
    """The clusters of ``cs`` K1 (K10; K11's blocks are K1's) blocks the
    card ``device`` (None: the current one) holds at once
    (cudaOccupancyMaxActiveClusters), asked once per size and card."""
    return _fit(cs, pair_heads, _card(device))


@functools.lru_cache(maxsize=256)
def _plan(heads: int, batch: int, t: int, pair_heads: bool,
          device: torch.device) -> int:
    return cluster_plan(
        heads, batch, t, lambda cs: cluster_fit(cs, pair_heads, device),
        pair_heads)


def _card_plan(heads: int, batch: int, t: int, pair_heads: bool = False,
               device=None) -> int:
    """cluster_plan on the card ``device`` (None: the current one), kept
    per shape and card: two cards of a process do not share a plan."""
    return _plan(heads, batch, t, pair_heads, _card(device))


# K11's forms of the softmax division (TPU A/B tool: defer_div), by the
# code the kernel takes
AB_FORMS = {"post": 0, True: 1, False: 2}


def _check_form(defer_div) -> None:
    # by identity: 0 and 1 would otherwise pass as False and True
    if not (defer_div is False or defer_div is True or defer_div == "post"):
        raise ValueError(f"defer_div must be False, True or 'post'; got "
                         f"{defer_div!r}")


def attention_o_residual_ab_plain(q, k, v, x, wo, bo,
                                  defer_div: bool | str) -> torch.Tensor:
    """K11's function for one ``defer_div`` form, with the TPU A/B
    kernel's roundings: f32 scores and p = exp(s - max); False divides p
    by its row sum l, rounds it to V's dtype and multiplies by V; True
    rounds the unnormalised p, multiplies by V and divides the [T, D]
    output by l; "post" multiplies that output by 1/l."""
    _check_form(defer_div)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if defer_div is False:
        o = torch.matmul((p / l).to(v.dtype).float(), v.float())
    else:
        o = torch.matmul(p.to(v.dtype).float(), v.float())
        o = o / l if defer_div is True else o * (1.0 / l)
    return _merge_o_residual(o, x, wo, bo)


def _quantize_rows_exact(xf: torch.Tensor, floor: float):
    """(codes, scales) of float32 rows as the TPU kernel quantizes them:
    s = max(max |x|, floor) / 127 and codes = clip(round(x / s)), with
    true divisions; codes as float32 integers."""
    s = div_exact(xf.abs().amax(dim=-1, keepdim=True).clamp_min(floor),
                  127.0)
    return torch.round(xf / s).clamp_(-127, 127), s


def _int8_attention_heads(q, k8, ks, v8, vs) -> torch.Tensor:
    """K9's attention for [B, H, T, D] q and quantized K/V, one head at a
    time: [B, H, T, D] float32. Integer dots in float64 (exact: a PV sum
    reaches T * 127^2 > 2^24, which float32 would round), everything else
    in float32 in the TPU kernel's order."""
    d = q.shape[-1]
    outs = []
    for h in range(q.shape[1]):
        qf = q[:, h].float() * (1.0 / math.sqrt(d))
        q8, qs = _quantize_rows_exact(qf, 1e-12)
        s = torch.matmul(q8.double(), k8[:, h].double().transpose(-1, -2))
        s = s.float() * qs * ks[:, h, None, :].float()
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        pw = p * vs[:, h, None, :].float()
        p8, ps = _quantize_rows_exact(pw, 1e-30)
        pv = torch.matmul(p8.double(), v8[:, h].double()).float()
        outs.append(pv * ps)
    return torch.stack(outs, dim=1)


def int8_attention_plain(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Counterpart of the JAX ``int8_attention_xla``: [B, H, T, D] q/k/v ->
    [B, H, T, D] float32 attention with K9's quantization (K/V per
    position by quantize_kv, q and the softmax rows per row)."""
    return _int8_attention_heads(q, *quantize_kv(k, v))


def attention_o_residual_int8_plain(q, k8, ks, v8, vs, x, wo, bo,
                                    partial: bool = False) -> torch.Tensor:
    """K9 in plain PyTorch, on K9's own inputs: q [B, H, T, D], k8/v8
    [B, H, T, D] int8 and ks/vs [B, H, T] float32 from quantize_kv, x, Wo,
    bo as K1 takes them. ``partial``: the float32 ``(...) @ Wo`` alone
    (K9p's function; Wo [H*D, HD_out], x and bo unread)."""
    attn = _int8_attention_heads(q, k8, ks, v8, vs)
    if partial:
        return _merge_partial(attn, wo)
    return _merge_o_residual(attn, x, wo, bo)


def _check_widths(name, q, x, wo, bo):
    """Head dim 64 and a square o-projection, as every kernel here takes."""
    b, h, t, d = q.shape
    hd = x.shape[-1]
    if d != 64:
        raise ValueError(f"{name} takes head dim 64, got {d}")
    if h * d != hd or tuple(wo.shape) != (hd, hd) or \
            tuple(bo.shape) != (hd,):
        raise ValueError(
            f"{name} takes a square o-projection: q {tuple(q.shape)}, "
            f"x {tuple(x.shape)}, wo {tuple(wo.shape)}, bo {tuple(bo.shape)}")


# K11's forms have no float32 counterpart, and why
K11_BF16_ONLY = ("K11 is the TPU A/B tool's copy of K1 "
                 "(tools/profile_encoder_kernel_ab.py), bf16 by design")


def _check_dtypes(name, ref, **tensors) -> None:
    """Raise TypeError unless every tensor has ``ref``'s dtype, bf16 or
    float32 (the kernel's two forms)."""
    for n, a in tensors.items():
        if a.dtype not in (torch.bfloat16, torch.float32) or \
                a.dtype != ref.dtype:
            raise TypeError(f"{name} takes bf16 or float32 tensors of one "
                            f"dtype; {n} is {a.dtype}, q {ref.dtype}")


def _check_block_args(name, q, k, v, x, wo, bo):
    """The argument checks K1, K10 and K11 share; returns q's strides.
    K1 and K10 take bf16 or float32 tensors of one dtype (their two
    forms); K11 takes bf16 (K11_BF16_ONLY)."""
    _check_widths(name, q, x, wo, bo)
    tensors = dict(q=q, k=k, v=v, x=x, wo=wo, bo=bo)
    if name == "K11" and any(a.dtype != torch.bfloat16
                             for a in tensors.values()):
        n, a = next((n, a) for n, a in tensors.items()
                    if a.dtype != torch.bfloat16)
        raise TypeError(f"K11 takes bf16 tensors; {n} is {a.dtype}: it has "
                        f"no float32 form, {K11_BF16_ONLY}")
    _check_dtypes(name, q, **tensors)
    for n, a in tensors.items():
        if a.device != x.device:
            raise ValueError(f"{name}: {n} on {a.device}, x on {x.device}")
    if q.stride() != k.stride() or q.stride() != v.stride():
        raise ValueError(f"{name} takes q, k, v views with equal strides")
    _check_q_strides(name, q)
    for n, a in (("x", x), ("wo", wo), ("bo", bo)):
        if not a.is_contiguous():
            raise ValueError(f"{name} takes a contiguous {n}")
    # the kernels read q/k/v/wo rows with 16-byte loads, x and bo with
    # 4-byte loads
    for n, a, align in (("q", q, 16), ("k", k, 16), ("v", v, 16),
                        ("wo", wo, 16), ("x", x, 4), ("bo", bo, 4)):
        if a.data_ptr() % align:
            raise ValueError(f"{name}: {n} is not {align}-byte aligned")
    return q.stride()[:3]


# blocks of the float32 K1's cluster at most (a portable cluster size)
F32_MAX_CLUSTER = 8


def f32_cluster(heads: int, pair_heads: bool = False) -> int:
    """Blocks of the float32 K1's (K10's: over the H / 2 pairs) cluster
    over the heads of one (batch, 64-row) tile: as few units a block as
    eight blocks allow, spread evenly (1 a block up to 8 units; H = 12 ->
    6 blocks of 2; H = 20 -> 7 blocks of 2-3; a rank's 10 heads of
    large-v3 -> 5 blocks of 2; K10 at H = 8 -> 4 blocks of one pair)."""
    if pair_heads and heads % 2:
        raise ValueError(f"K10 pairs heads; H={heads} is odd")
    if heads < 1:
        raise ValueError(f"K1 takes at least one head; H={heads}")
    units = heads // 2 if pair_heads else heads
    return -(-units // -(-units // F32_MAX_CLUSTER))


def _check_partial_wo(name, q, wo):
    """Head dim 64 and a row shard Wo [H*64, HD_out], HD_out % 64 == 0."""
    b, h, t, d = q.shape
    if d != 64:
        raise ValueError(f"{name} takes head dim 64, got {d}")
    if wo.dim() != 2 or wo.shape[0] != h * d or wo.shape[1] % 64 or \
            wo.shape[1] < 64:
        raise ValueError(f"{name} takes Wo [H*64, HD_out] with HD_out % 64 "
                         f"== 0: q {tuple(q.shape)}, wo {tuple(wo.shape)}")


def _launch_partial(q, k, v, wo, cluster=None, pair_heads=False):
    """K1p, or K10p (``pair_heads``, H even), on clusters of ``cluster``
    blocks (default: K1's or K10's plan for the rank's heads on this
    card); returns [B, T, HD_out] float32."""
    name = "K10p" if pair_heads else "K1p"
    _check_partial_wo(name, q, wo)
    b, h, t, d = q.shape
    hdo = wo.shape[-1]
    if pair_heads and h % 2:
        raise ValueError(f"K10p pairs heads; H={h} is odd")
    _check_dtypes(name, q, q=q, k=k, v=v, wo=wo)
    for n, a in (("q", q), ("k", k), ("v", v), ("wo", wo)):
        if a.device != q.device:
            raise ValueError(f"{name}: {n} on {a.device}, q on {q.device}")
        if a.data_ptr() % 16:
            raise ValueError(f"{name}: {n} is not 16-byte aligned")
    if q.stride() != k.stride() or q.stride() != v.stride():
        raise ValueError(f"{name} takes q, k, v views with equal strides")
    _check_q_strides(name, q)
    if not wo.is_contiguous():
        raise ValueError(f"{name} takes a contiguous wo")
    dev = q.device
    f32 = q.dtype == torch.float32
    # the float32 forms (csrc/encoder_block_f32.cu): f32_cluster's plan,
    # a float32 scratch, scale 1/8
    if cluster is None:
        cluster = (f32_cluster(h, pair_heads) if f32
                   else _card_plan(h, b, t, pair_heads, dev))
    merged = torch.empty(b, t, h * d, dtype=q.dtype, device=dev)
    out = torch.empty(b, t, hdo, dtype=torch.float32, device=dev)
    sb, sh, st = q.stride()[:3]
    sym = ("mas_attn_o_residual_paired_partial" if pair_heads
           else "mas_attn_o_residual_partial") + ("_f32" if f32 else "")
    runtime.launch(sym, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), sb,
                   sh, st, merged.data_ptr(), wo.data_ptr(), out.data_ptr(),
                   b, h, t, hdo, 1.0 / math.sqrt(d) if f32
                   else math.log2(math.e) / math.sqrt(d), cluster,
                   runtime.stream_handle(dev))
    runtime.bump("encoder_attn_o_residual_paired" if pair_heads
                 else "encoder_attn_o_residual")
    return out


def _check_q_strides(name, q):
    sb, sh, st, sd = q.stride()
    if sd != 1 or sb % 8 or sh % 8 or st % 8:
        raise ValueError(
            f"{name} needs a unit last stride and 16-byte aligned rows; "
            f"strides {q.stride()}")


def _launch(q, k, v, x, wo, bo, *, pair_heads=False, form=None,
            cluster=None):
    """K1, or K10 (pair_heads), or K11 (form, a key of AB_FORMS), on
    clusters of ``cluster`` blocks (default: the plan for this shape on
    this card)."""
    name = "K10" if pair_heads else "K11" if form is not None else "K1"
    sb, sh, st = _check_block_args(name, q, k, v, x, wo, bo)
    b, h, t, d = q.shape
    if pair_heads and h % 2:
        raise ValueError(f"K10 pairs heads; H={h} is odd")
    if x.dtype == torch.float32:
        return _launch_f32(q, k, v, x, wo, bo, sb, sh, st, pair_heads)
    if cluster is None:
        cluster = _card_plan(h, b, t, pair_heads, x.device)
    out = torch.empty_like(x)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sh, st,
            x.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr(),
            b, h, t, x.shape[-1], math.log2(math.e) / math.sqrt(d))
    stream = runtime.stream_handle(x.device)
    if pair_heads:
        runtime.launch("mas_attn_o_residual_paired", x.device, *args,
                       cluster, stream)
        runtime.bump("encoder_attn_o_residual_paired")
    elif form is not None:
        runtime.launch("mas_attn_o_residual_ab", x.device, *args, cluster,
                       AB_FORMS[form], stream)
        runtime.bump("encoder_attn_o_residual_ab")
    else:
        runtime.launch("mas_attn_o_residual", x.device, *args, cluster,
                       stream)
        runtime.bump("encoder_attn_o_residual")
    return out


def _launch_f32(q, k, v, x, wo, bo, sb, sh, st, pair_heads=False):
    """K1's (K10's with ``pair_heads``) float32 form on clusters of
    f32_cluster(H) blocks, the merged attention in a [B, T, H*64] float32
    scratch."""
    b, h, t, d = q.shape
    name = "K10" if pair_heads else "K1"
    if bo.data_ptr() % 16:
        raise ValueError(f"{name}: bo is not 16-byte aligned")
    out = torch.empty_like(x)
    merged = torch.empty_like(x)
    runtime.launch("mas_attn_o_residual_paired_f32" if pair_heads
                   else "mas_attn_o_residual_f32", x.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), sb, sh, st, x.data_ptr(),
                   wo.data_ptr(), bo.data_ptr(), out.data_ptr(), b, h, t,
                   x.shape[-1], 1.0 / math.sqrt(d),
                   f32_cluster(h, pair_heads), merged.data_ptr(),
                   runtime.stream_handle(x.device))
    runtime.bump("encoder_attn_o_residual_paired" if pair_heads
                 else "encoder_attn_o_residual")
    return out


def _launch_int8(q, k8, ks, v8, vs, x, wo, bo, partial=False):
    """K9, or K9p (``partial``: x and bo None, Wo [H*64, HD_out]; returns
    [B, T, HD_out] float32); q, x, wo and bo bf16, or all float32 (the
    float32 forms: the heads into a float32 scratch, then its 3xTF32
    o-projection, one C call)."""
    name = "K9p" if partial else "K9"
    b, h, t, d = q.shape
    if partial:
        _check_partial_wo(name, q, wo)
        hd, hdo = h * d, wo.shape[1]
    else:
        _check_widths(name, q, x, wo, bo)
        hd = hdo = x.shape[-1]
    dev = q.device
    _check_dtypes(name, q, q=q, wo=wo,
                  **({} if partial else dict(x=x, bo=bo)))
    f32 = q.dtype == torch.float32
    for n, a, dt, shape in (
            ("q", q, q.dtype, (b, h, t, d)),
            ("k8", k8, torch.int8, (b, h, t, d)),
            ("ks", ks, torch.float32, (b, h, t)),
            ("v8", v8, torch.int8, (b, h, t, d)),
            ("vs", vs, torch.float32, (b, h, t)),
            ("x", x, q.dtype, (b, t, hd)),
            ("wo", wo, q.dtype, (hd, hdo)),
            ("bo", bo, q.dtype, (hd,))):
        if a is None and partial and n in ("x", "bo"):
            continue
        if a.dtype != dt:
            raise TypeError(f"{name} takes {dt} {n}; got {a.dtype}")
        if a.device != dev or tuple(a.shape) != shape:
            raise ValueError(f"{name}: {n} {tuple(a.shape)} on {a.device}; "
                             f"expected {shape} on {dev}")
        if n != "q" and (not a.is_contiguous() or a.data_ptr() % 16):
            raise ValueError(f"{name} takes a contiguous 16-byte aligned {n}")
    _check_q_strides(name, q)
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: q is not 16-byte aligned")
    sb, sh, st = q.stride()[:3]
    # the kernel's TMA maps of the scales want rows of a multiple of 16
    # bytes: a ragged T pads them (the padding is never read)
    if t % 4:
        ks, vs = (torch.nn.functional.pad(a, (0, 4 - t % 4)) for a in (ks, vs))
    # the float32 forms: the heads' float32 scratch, before the stream
    merged = torch.empty(b, t, hd, dtype=torch.float32, device=dev) \
        if f32 else None
    tail = (merged.data_ptr(),) if f32 else ()
    sfx = "_f32" if f32 else ""
    stream = runtime.stream_handle(dev)
    if partial:
        out = torch.empty(b, t, hdo, dtype=torch.float32, device=dev)
        runtime.launch(
            "mas_attn_o_residual_int8_partial" + sfx, dev,
            q.data_ptr(), sb, sh, st, k8.data_ptr(), ks.data_ptr(),
            v8.data_ptr(), vs.data_ptr(), wo.data_ptr(), out.data_ptr(), b,
            h, t, ks.shape[-1], hdo, 1.0 / math.sqrt(d), *tail, stream)
    else:
        out = torch.empty_like(x)
        runtime.launch(
            "mas_attn_o_residual_int8" + sfx, dev,
            q.data_ptr(), sb, sh, st, k8.data_ptr(), ks.data_ptr(),
            v8.data_ptr(), vs.data_ptr(), x.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), out.data_ptr(), b, h, t, ks.shape[-1], hd,
            1.0 / math.sqrt(d), *tail, stream)
    runtime.bump("encoder_attn_o_residual_int8")
    return out


def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def fused_attention_o_residual(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    x: torch.Tensor | None, wo: torch.Tensor, bo: torch.Tensor | None,
    pair_heads: bool = False, qk_int8: bool = False, partial: bool = False,
) -> torch.Tensor:
    """x + (softmax(QK^T/sqrt(D)) V merged over heads) @ Wo + bo.

    Non-causal; f32 softmax and accumulation. q/k/v are [B, H, T, D]
    (any strides with a unit last one, e.g. the head-split views of the
    q/k/v dense outputs); x is [B, T, H*D]; output [B, T, H*D] in x's
    dtype. CUDA tensors launch K1 (bf16, or its float32 form on float32
    tensors), or K9 with ``qk_int8`` (k/v quantized
    first by quantize_kv, as the TPU wrapper does; both attention dots
    int8 x int8 -> int32), or K10 with ``pair_heads`` (H even); CPU
    tensors take the plain versions. ``partial``: one rank's float32
    partial ``(...) @ Wo`` over the rank's heads, Wo [H*D, HD_out], x and
    bo unread (K1p, K9p with ``qk_int8``, K10p with ``pair_heads`` on the
    card; module docstring)."""
    runtime.refuse_grad("K1" if not (qk_int8 or pair_heads) else
                        "K9" if qk_int8 else "K10", q, k, v, x, wo, bo)
    if qk_int8 and pair_heads:
        raise ValueError("qk_int8 and pair_heads exclude each other")
    if partial:
        if qk_int8:
            return attention_o_residual_int8(q, *quantize_kv(k, v), None, wo,
                                             None, partial=True)
        if _device(q) == "cuda":
            return _launch_partial(q, k, v, wo, pair_heads=pair_heads)
        if pair_heads:
            return attention_o_residual_paired_plain(q, k, v, None, wo, None,
                                                     partial=True)
        return attention_o_residual_plain(q, k, v, None, wo, None,
                                          partial=True)
    dev = _device(x)
    if qk_int8:
        return attention_o_residual_int8(q, *quantize_kv(k, v), x, wo, bo)
    if pair_heads:
        if dev == "cuda":
            return _launch(q, k, v, x, wo, bo, pair_heads=True)
        return attention_o_residual_paired_plain(q, k, v, x, wo, bo)
    if dev == "cuda":
        return _launch(q, k, v, x, wo, bo)
    return attention_o_residual_plain(q, k, v, x, wo, bo)


def attention_o_residual_int8(q, k8, ks, v8, vs, x, wo, bo,
                              partial: bool = False) -> torch.Tensor:
    """K9 (K9p with ``partial``) on K/V that quantize_kv already
    quantized: CUDA tensors launch the kernel, CPU tensors take
    attention_o_residual_int8_plain."""
    runtime.refuse_grad("K9", q, k8, ks, v8, vs, x, wo, bo)
    if _device(q) == "cuda":
        return _launch_int8(q, k8, ks, v8, vs, x, wo, bo, partial)
    return attention_o_residual_int8_plain(q, k8, ks, v8, vs, x, wo, bo,
                                           partial)


def attention_o_residual_ab(q, k, v, x, wo, bo,
                            defer_div: bool | str) -> torch.Tensor:
    """K1's function with the softmax division placed as the TPU A/B tool
    places it (``defer_div`` False, True or "post";
    attention_o_residual_ab_plain). CUDA tensors launch K11, CPU tensors
    take the plain version."""
    runtime.refuse_grad("K11", q, k, v, x, wo, bo)
    _check_form(defer_div)
    if _device(x) == "cuda":
        return _launch(q, k, v, x, wo, bo, form=defer_div)
    return attention_o_residual_ab_plain(q, k, v, x, wo, bo, defer_div)
