"""K11's arithmetic on K1's wgmma cluster loop, emulated on the CPU.

K11 (csrc/encoder_block_wgmma.cu) is K1 with the softmax division placed
as the form says: "post" (x 1/l after PV) is K1 itself, True (/ l after
PV) divides each head's output by its row sum, and False (p / l before
PV) takes two passes over each head's keys: the first over the K tiles
alone for each row's max m and sum l (the online form K1 uses), the
second recomputing S and forming p = exp2(s c - m) / l, rounded to bf16,
for a PV product with no rescale. Every division is a row reciprocal with
one correction step (sm90.cuh div_row), which gives the true quotient
(tests/test_torch_cuda.py holds it to the division on the card), so the
emulation divides.

Here that arithmetic is emulated in float32 (128-key tiles, the threads'
order of l, the cluster plan's ranks for the o-projection) and held to
the plain twin and to the Pallas kernel in interpret mode with
MAS_ENC_DEFER set to the matching form, at ragged T and at the A/B
tool's T=500 and 1500; chip_smoke's K1 check (which holds K11 on the
card) rejects faults planted in the two-pass form; and the gap of each
form to the Pallas kernel in the same form is measured on bf16 inputs
at T=1500.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops import encoder_block as JEB
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import encoder_block as EB

torch.set_num_threads(1)
BN = 128   # keys a K/V tile
D = 64
SL2 = torch.tensor(math.log2(math.e) / math.sqrt(D), dtype=torch.float32)
# clusters of cs blocks an H100 80GB HBM3 holds at once (PERF.md)
H100_FIT = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
            10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}
# float32 emulation against float32 references: only the order of the
# sums differs (tile partial sums, the online rescale, the o-projection
# chunk by chunk)
TOL = 1e-5
FORMS = (False, True, "post")
DEFER = {False: "off", True: "div", "post": "recip"}  # MAS_ENC_DEFER


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def _tiles(q, k, v, t, unmasked_tail=False):
    """The scores of every 128-key tile (TMA's zero pad rows score 0, then
    -inf unless ``unmasked_tail``) and the zero-padded V."""
    b = q.shape[0]
    nt = -(-t // BN)
    kp = torch.zeros(b, nt * BN, D)
    vp = torch.zeros(b, nt * BN, D)
    kp[:, :t], vp[:, :t] = k, v
    s_all = q @ kp.transpose(-1, -2)
    if not unmasked_tail:
        s_all[..., t:] = -torch.inf
    return s_all, vp, nt


def _exp2_fma(s, m):
    # exp2(fma(s, scale_log2, -m)): the product exact, one rounding
    return torch.exp2((s.double() * SL2.double() - m.double()).float())


def _online(s_all, nt, t, rounding, vp=None):
    """K1's online loop: the row max m (log2 domain), the row sum l over
    the quad's four threads and, with vp, the rescaled PV sum o."""
    b = s_all.shape[0]
    m = torch.full((b, t, 1), -torch.inf)
    lt = torch.zeros(b, t, 4)
    acc = torch.zeros(b, t, D)
    pend = None
    for j in range(nt):
        s = s_all[..., j * BN:(j + 1) * BN]
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * SL2)
        c = torch.exp2(m - mn)
        p = _exp2_fma(s, mn)
        pt = p.reshape(b, t, BN // 8, 4, 2)
        rs = torch.zeros(b, t, 4)
        for jn in range(BN // 8):
            rs = rs + (pt[:, :, jn, :, 0] + pt[:, :, jn, :, 1])
        lt = lt * c + rs
        if vp is not None:
            if pend is not None:
                acc = acc + pend
            acc = acc * c
            pend = (_bf16(p) if rounding else p) @ vp[:, j * BN:(j + 1) * BN]
        m = mn
    if pend is not None:
        acc = acc + pend
    return m, (lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3]), acc


def _head(q, k, v, t, form, *, rounding, fault=None):
    """One head's [B, T, 64] output as the kernel's form computes it,
    before its bf16 rounding. ``fault`` (form False): "unmasked tail"
    (the last tile's zero pad keys in both passes), "short l" (the first
    pass's sum without the last tile)."""
    s_all, vp, nt = _tiles(q, k, v, t, unmasked_tail=fault == "unmasked tail")
    if form is not False:
        _, l, o = _online(s_all, nt, t, rounding, vp)
        return o * (1.0 / l)[..., None] if form == "post" else o / l[..., None]
    m, l, _ = _online(s_all, nt, t, rounding)
    if fault == "short l":
        _, l, _ = _online(s_all[..., :(nt - 1) * BN], nt - 1, t, rounding)
    o = torch.zeros(q.shape[0], t, D)
    for j in range(nt):      # the second pass: no rescale
        p = _exp2_fma(s_all[..., j * BN:(j + 1) * BN], m) / l[..., None]
        o = o + (_bf16(p) if rounding else p) @ vp[:, j * BN:(j + 1) * BN]
    return o


def emulate(q, k, v, x, wo, bo, form, *, cs, rounding=True, fault=None):
    """K11 in ``form`` on a cluster of ``cs`` blocks, float32; with
    ``rounding`` the kernel's bf16 roundings (P, each head's output, the
    result)."""
    q, k, v, x, wo, bo = (a.float() for a in (q, k, v, x, wo, bo))
    b, h, t, _ = q.shape
    hd = h * D
    merged = torch.zeros(b, t, hd)
    for hh in range(h):
        oh = _head(q[:, hh], k[:, hh], v[:, hh], t, form, rounding=rounding,
                   fault=fault)
        merged[..., hh * D:(hh + 1) * D] = _bf16(oh) if rounding else oh
    y = torch.zeros(b, t, hd)
    for own in EB.cluster_ranks(h, cs):
        cols = [c for hh in own for c in range(hh * D, (hh + 1) * D)]
        acc = torch.zeros(b, t, len(cols))
        for kc in range(h):
            acc = acc + merged[..., kc * D:(kc + 1) * D] @ \
                wo[kc * D:(kc + 1) * D, cols]
        y[..., cols] = acc
    out = x + (y + bo)
    return _bf16(out) if rounding else out


def _inputs(rng, b, heads, t, *, residual=True):
    hd = heads * D
    q, k, v = (rng.normal(size=(b, heads, t, D)).astype(np.float32)
               for _ in range(3))
    x = rng.normal(size=(b, t, hd)).astype(np.float32)
    wo = (rng.normal(size=(hd, hd)) / np.sqrt(hd)).astype(np.float32)
    bo = (rng.normal(size=(hd,)) * 0.1).astype(np.float32)
    if not residual:
        x, bo = np.zeros_like(x), np.zeros_like(bo)
    return q, k, v, x, wo, bo


def _pallas(monkeypatch, args, form):
    """The JAX encoder block in interpret mode with its division in
    ``form`` (MAS_ENC_DEFER, read when the kernel is traced)."""
    monkeypatch.setenv("MAS_ENC_DEFER", DEFER[form])
    jax.clear_caches()
    try:
        return torch.from_numpy(np.asarray(JEB.fused_attention_o_residual(
            *(jnp.asarray(a) for a in args),
            interpret=True)).astype(np.float32))
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("b,heads,t", [
    (1, 2, 1), (3, 2, 7), (1, 4, 129), (2, 3, 300), (1, 2, 500),
    (1, 2, 1500)])
def test_emulation_matches_plain_and_pallas(rng, monkeypatch, form, b, heads,
                                            t):
    """The float32 emulation of each form (128-key tiles, the ragged last
    one masked, False's two passes, the o-projection on the plan's
    ranks) against the plain twin and the Pallas kernel in interpret mode
    in the same form, within TOL of the output's scale: the three differ
    only in the order of float32 sums. T = 1, 7, 129, 300 leave a ragged
    last tile; 500 and 1500 are the A/B tool's contexts."""
    args = _inputs(rng, b, heads, t)
    ta = [torch.from_numpy(a) for a in args]
    cs = EB.cluster_plan(heads, b, t, H100_FIT.get)
    got = emulate(*ta, form, cs=cs, rounding=False)
    runtime.reset_counts()
    plain = EB.attention_o_residual_ab(*ta, form)   # the CPU takes the twin
    assert sum(runtime.COUNTS.values()) == 0
    for ref in (plain, _pallas(monkeypatch, args, form)):
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err < TOL, (form, err)


@pytest.mark.parametrize("fault", [None, "unmasked tail", "short l"])
def test_k11_check_rejects_two_pass_faults(fault):
    """chip_smoke.check_k1 (K11's card check) at the main path's T=1500 on
    the attention input (B=1, H=8, the plan's 2 blocks), form False: the
    kernel's arithmetic passes; the 36 zero pad keys of the last 128-key
    tile left in both passes, and a first pass whose l misses the last
    tile, each fail. Readings (max / norm of the term, limits 1 % /
    0.7 %): the kernel's arithmetic 0.46 % / 0.033 %; the faults 1.38 % /
    1.48 % and 46 % / 9.2 %."""
    gen = torch.Generator().manual_seed(12)
    q, k, v, x, wo, bo = chip_smoke.k1_inputs(gen, 1, 1500, 8,
                                              residual=False, device="cpu")
    ref = EB.attention_o_residual_ab_plain(q, k, v, x, wo, bo, False)
    got = emulate(q, k, v, x, wo, bo, False, cs=2, fault=fault)
    if fault is None:
        chip_smoke.check_k1("K11 False", got, ref, residual=False)
    else:
        with pytest.raises(AssertionError, match="attention term"):
            chip_smoke.check_k1(f"K11 {fault}", got, ref, residual=False)


@pytest.mark.parametrize("form", FORMS)
def test_k11_division_form_gap_to_pallas(rng, monkeypatch, form):
    """Each form on bf16 inputs of the attention term (x = 0, bo = 0) at
    T=1500, the emulation of the kernel's roundings against the Pallas
    kernel in interpret mode in the same form: within 1 % of the
    output's scale (each side rounds its own p to bf16, and the bf16 head
    outputs and results then round apart by a step at most). Readings
    here (max / norm of y): False 3.9e-3 / 2.1e-4, True and "post" 3.9e-3
    / 3.0e-3: in the same form the two round p alike, and only False
    divides before the rounding, as the Pallas kernel does."""
    b, heads, t = 1, 2, 1500
    args = [np.asarray(a, dtype=jnp.bfloat16) for a in _inputs(
        rng, b, heads, t, residual=False)]
    ref = _pallas(monkeypatch, args, form)
    got = emulate(*(torch.from_numpy(a.astype(np.float32)) for a in args),
                  form, cs=EB.cluster_plan(heads, b, t, H100_FIT.get))
    gap = float((got - ref).abs().max() / ref.abs().max())
    assert gap < 1e-2, gap


def test_card_plan_is_kept_per_card(monkeypatch):
    """K1's, K10's and K11's plan cache is keyed by the card: two cards
    that hold different clusters (a fake occupancy: the second places no
    cluster of 2) get their own plans, each asked of its own card, and
    neither is served the other's entry."""
    asked = []

    def fake_fit(cs, pair_heads=False, device=None):
        asked.append((device.index, cs))
        return 0 if device.index == 1 and cs == 2 else H100_FIT[cs]
    monkeypatch.setattr(EB, "cluster_fit", fake_fit)
    EB._plan.cache_clear()
    try:
        cards = [torch.device("cuda", i) for i in (0, 1)]
        plans = [EB._card_plan(8, 32, 1500, False, c) for c in cards]
        assert plans[0] == 2 and plans[1] == EB.cluster_plan(
            8, 32, 1500, lambda cs: 0 if cs == 2 else H100_FIT[cs]) != 2
        assert {i for i, _ in asked} == {0, 1}
        n = len(asked)
        assert [EB._card_plan(8, 32, 1500, False, c) for c in cards] == plans
        assert len(asked) == n and EB._plan.cache_info().currsize == 2
    finally:
        EB._plan.cache_clear()
