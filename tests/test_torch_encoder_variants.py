"""The encoder variants of the PyTorch package -- K8 (per-head encoder
attention), K9 (int8 dots), K10 (head pairs) and K11 (the softmax
division A/B) -- held to the JAX package's Pallas kernels on the CPU, and
the encoder's dispatch between them held to the JAX encoder.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version (a
CUDA kernel has no interpret mode); the Pallas kernels run in interpret
mode, as the JAX package's own tests run them. Inputs come from numpy
with a seed and feed both. Float32 throughout. Tolerances:
* K8, K10, K11: 1e-5 absolute; the math is the same, only the order of
  float32 sums differs.
* K9: 1e-5 of the output's scale plus what flipped p8 codes can move.
  Both sides compute the same integer dots and the same float32
  roundings in the same order, except exp and the order of the sum l;
  where that moves a weighted probability across a .5 boundary of its
  int8 code, one code steps by one and moves its (row, head) output by
  at most 127 * ps (max |v8| = 127). The test counts the flips (the
  codes recomputed in each framework from the same integer scores) and
  allows exactly that.
The card checks of chip_smoke.py (kernel against plain version on the
card) are held here to faults planted in float32 emulations of the
kernels at the main path's T=1500.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.ops import attention as JA
from multimodal_audio_search_tpu.ops import encoder_block as JEB
from multimodal_audio_search_tpu_torch import runtime, weights
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.ops import attention as A
from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
from multimodal_audio_search_tpu_torch.ops.cached_attention import (
    quantize_kv)

torch.set_num_threads(1)
TOL = 1e-5
NEW_KEYS = ("encoder_attention", "encoder_attn_o_residual_int8",
            "encoder_attn_o_residual_paired", "encoder_attn_o_residual_ab")
# (b, heads, t, d, blk_q): T not a multiple of blk_q (padded keys masked,
# T=40 and T=21), and the production head dim
SHAPES = [(2, 4, 40, 16, 16), (2, 4, 21, 16, 16), (1, 2, 97, 64, 32)]


def _inputs(rng, b, heads, t, d):
    hd = heads * d
    q, k, v = (rng.normal(size=(b, heads, t, d)).astype(np.float32)
               for _ in range(3))
    x = rng.normal(size=(b, t, hd)).astype(np.float32)
    wo = (rng.normal(size=(hd, hd)) / np.sqrt(hd)).astype(np.float32)
    bo = (rng.normal(size=(hd,)) * 0.1).astype(np.float32)
    return q, k, v, x, wo, bo


def _jax(*a):
    return [jnp.asarray(z) for z in a]


def _torch(*a):
    return [torch.from_numpy(z) for z in a]


def _no_launch():
    return all(runtime.COUNTS[k] == 0 for k in NEW_KEYS)


# ------------------------------------------------------------------- K8
@pytest.mark.parametrize("b,heads,t,d,blk_q", SHAPES)
def test_k8_plain_matches_pallas(rng, b, heads, t, d, blk_q):
    q, k, v, *_ = _inputs(rng, b, heads, t, d)
    ref = np.asarray(JA.fused_encoder_attention(*_jax(q, k, v), blk_q=blk_q,
                                                interpret=True))
    runtime.reset_counts()
    got = A.fused_encoder_attention(*_torch(q, k, v))
    assert got.shape == (b, heads, t, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    assert _no_launch()


# ------------------------------------------------------------------ K10
@pytest.mark.parametrize("b,heads,t,d,blk_q", SHAPES)
def test_k10_plain_matches_pallas(rng, b, heads, t, d, blk_q):
    args = _inputs(rng, b, heads, t, d)
    ref = np.asarray(JEB.fused_attention_o_residual(
        *_jax(*args), blk_q=blk_q, pair_heads=True, interpret=True))
    runtime.reset_counts()
    got = EB.fused_attention_o_residual(*_torch(*args), pair_heads=True)
    assert got.shape == (b, t, heads * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    # the same function as K1's
    np.testing.assert_allclose(
        got.numpy(), EB.attention_o_residual_plain(*_torch(*args)).numpy(),
        atol=TOL, rtol=TOL)
    assert _no_launch()


# ------------------------------------------------------------------- K9
def _p8_flips(q, k8, ks, vs):
    """p8 codes recomputed from the same integer scores with each
    framework's exp and sums (float32, the kernels' order of operations):
    the number of codes that differ per (b, h, row), and ps per (b, h,
    row), from the port's side."""
    d = q.shape[-1]
    qf = q * np.float32(1 / np.sqrt(d))
    qs = np.maximum(np.abs(qf).max(-1, keepdims=True), np.float32(1e-12)) \
        / np.float32(127)
    q8 = np.clip(np.round(qf / qs), -127, 127)
    si = np.einsum("bhqd,bhtd->bhqt", q8.astype(np.float64),
                   k8.astype(np.float64)).astype(np.float32)
    s = si * qs * ks[:, :, None, :]
    vsq = vs[:, :, None, :]

    def codes(exp, total, amax):
        p = exp(s - amax(s))
        p = p / total(p)
        pw = p * vsq
        ps = np.maximum(np.asarray(amax(pw)), np.float32(1e-30)) \
            / np.float32(127)
        return np.clip(np.round(np.asarray(pw) / ps), -127, 127), ps

    jc, _ = codes(lambda a: np.asarray(jnp.exp(jnp.asarray(a))),
                  lambda a: np.asarray(jnp.sum(jnp.asarray(a), -1,
                                               keepdims=True)),
                  lambda a: np.asarray(a).max(-1, keepdims=True))
    tc, ps = codes(lambda a: torch.exp(torch.as_tensor(a)).numpy(),
                   lambda a: torch.as_tensor(a).sum(-1, keepdim=True).numpy(),
                   lambda a: np.asarray(a).max(-1, keepdims=True))
    return (jc != tc).sum(-1), ps[..., 0]


@pytest.mark.parametrize("b,heads,t,d,blk_q", SHAPES)
def test_k9_plain_matches_pallas_and_xla(rng, b, heads, t, d, blk_q):
    """K9's twin against the Pallas kernel (qk_int8=True) and its
    attention half against int8_attention_xla, within 1e-5 of the
    output's scale plus what the counted p8 code flips can move."""
    args = _inputs(rng, b, heads, t, d)
    q, k, v, x, wo, bo = args
    k8, ks, v8, vs = (a.numpy() for a in quantize_kv(*_torch(k, v)))
    flips, ps = _p8_flips(q, k8, ks, vs)
    assert flips.sum() <= flips.size // 100     # rare, if any
    # per (b, h, row, d): one code step of a flipped code
    step = (flips * 127 * ps)[..., None] * np.ones(d)
    ref = np.asarray(JEB.int8_attention_xla(*_jax(q, k, v)))
    got = EB.int8_attention_plain(*_torch(q, k, v)).numpy()
    assert got.shape == (b, heads, t, d)
    assert np.all(np.abs(got - ref) <= TOL * np.abs(ref).max() + step)
    # through Wo: |dy| <= sum over (h, d) of |d attn| |Wo|
    dy = np.einsum("bhtd,hdj->btj", step,
                   np.abs(wo).reshape(heads, d, heads * d))
    ref = np.asarray(JEB.fused_attention_o_residual(
        *_jax(*args), blk_q=blk_q, qk_int8=True, interpret=True))
    runtime.reset_counts()
    got = EB.fused_attention_o_residual(*_torch(*args), qk_int8=True)
    assert got.shape == (b, t, heads * d) and got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - ref) <= TOL * np.abs(ref).max() + dy)
    assert _no_launch()


def test_k9_takes_quantize_kv_codes(rng):
    """The wrapper quantizes k/v with quantize_kv (the JAX wrapper's
    XLA-side step) and hands the codes to the kernel's function."""
    args = _torch(*_inputs(rng, 2, 2, 30, 64))
    q, k, v, x, wo, bo = args
    got = EB.fused_attention_o_residual(*args, qk_int8=True)
    ref = EB.attention_o_residual_int8(q, *quantize_kv(k, v), x, wo, bo)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        EB.fused_attention_o_residual(*args, qk_int8=True, pair_heads=True)


# ------------------------------------------------------------------ K11
@pytest.fixture
def clean_jax_caches():
    """MAS_ENC_DEFER is read when the JAX kernel is traced: clear the
    caches before and after, so no other test sees a form traced here."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("b,heads,t,d,blk_q", SHAPES)
def test_k11_plain_matches_pallas_forms(rng, monkeypatch, clean_jax_caches,
                                        b, heads, t, d, blk_q):
    """Each form of K11 against B1 with MAS_ENC_DEFER set to the TPU
    kernel's matching form: False = "off" (p / l before PV), True = "div"
    (pv / l), "post" = "recip" (pv * (1 / l))."""
    args = _inputs(rng, b, heads, t, d)
    runtime.reset_counts()
    for form, env in ((False, "off"), (True, "div"), ("post", "recip")):
        monkeypatch.setenv("MAS_ENC_DEFER", env)
        jax.clear_caches()
        ref = np.asarray(JEB.fused_attention_o_residual(
            *_jax(*args), blk_q=blk_q, interpret=True))
        got = EB.attention_o_residual_ab(*_torch(*args), form)
        assert got.shape == (b, t, heads * d)
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    assert _no_launch()


@pytest.mark.parametrize("form", [0, 1, "div", None])
def test_k11_refuses_unknown_forms(rng, form):
    args = _torch(*_inputs(rng, 1, 2, 8, 16))
    with pytest.raises(ValueError):
        EB.attention_o_residual_ab(*args, form)


# --------------------------------------------------------------- encode
@pytest.fixture(scope="module")
def whisper_pair():
    cfg = JW.PRESETS["test"]
    jp = JW.init_params(jax.random.PRNGKey(0), cfg)
    tp = W.prepare_params(weights.whisper_params(
        jax.tree.map(np.asarray, jp)), torch.float32, torch.device("cpu"))
    return cfg, jp, tp


@pytest.mark.parametrize("fused_attention,fused_blocks", [
    (None, False), (False, False), (True, False), (None, True),
    (None, "int8"), (None, "paired"), (False, "paired")])
def test_encode_matches_jax(whisper_pair, rng, monkeypatch, fused_attention,
                            fused_blocks):
    """Port encode against JAX encode with the same arguments: the plain
    mha, K8 (JAX's per-head kernel, in interpret mode here), K1, K9 and
    K10; 5e-5 (the model bar). The int8 path: a p8 code that flips at a .5
    boundary (exp and the order of l differ, see the module docstring)
    moves its row's attention by one code step, which the later layers
    carry: here 57 of 12800 states by up to 2.8e-4. Held to 1 % of the
    states beyond 5e-5 and 1e-3 at most (the states are LN outputs of
    unit scale)."""
    cfg, jp, tp = whisper_pair
    monkeypatch.setattr(JA, "fused_encoder_attention", functools.partial(
        JA.fused_encoder_attention, interpret=True))
    mel = rng.normal(size=(2, 80, 200)).astype(np.float32)
    ref = np.asarray(JW.encode(jp, jnp.asarray(mel), cfg,
                               fused_attention=fused_attention,
                               fused_blocks=fused_blocks))
    got = W.encode(tp, torch.from_numpy(mel), cfg,
                   fused_attention=fused_attention,
                   fused_blocks=fused_blocks).numpy()
    assert got.shape == ref.shape == (2, 100, cfg.d_model)
    if fused_blocks == "int8":
        err = np.abs(got - ref)
        assert err.max() < 1e-3 and (err > 5e-5).mean() < 0.01
    else:
        np.testing.assert_allclose(got, ref, atol=5e-5)


def _spy(monkeypatch, calls, mod, name, key):
    fn = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: (
        calls.append(key), fn(*a, **k))[1])


@pytest.mark.parametrize("heads,fused_attention,fused_blocks,kernel", [
    (4, None, False, "mha"), (4, True, False, "K8"),
    (4, None, True, "K1"), (4, None, "int8", "K9"),
    (4, None, "paired", "K10"), (3, None, "paired", "K1"),
    (4, None, "auto", "K8")])
def test_encode_dispatch(monkeypatch, rng, heads, fused_attention,
                         fused_blocks, kernel):
    """Which kernel's function each encoder layer runs: "int8" -> K9,
    "paired" -> K10 (K1 for an odd head count), True -> K1, and with
    fused_attention (None = use_fused_attention, made true here for the
    "auto" row) -> K8; else the plain mha."""
    from multimodal_audio_search_tpu_torch.models import layers as L
    cfg = W.config_for("test", d_model=heads * 16, heads=heads)
    tp = W.prepare_params(W.init_params(torch.Generator().manual_seed(0),
                                        cfg), torch.float32,
                          torch.device("cpu"))
    if fused_blocks == "auto":
        fused_blocks = False
        monkeypatch.setattr(W, "use_fused_attention", lambda t, dev: True)
    calls = []
    for mod, name, key in (
            (A, "encoder_attention_plain", "K8"),
            (EB, "attention_o_residual_plain", "K1"),
            (EB, "attention_o_residual_int8_plain", "K9"),
            (EB, "attention_o_residual_paired_plain", "K10"),
            (L, "mha", "mha")):
        _spy(monkeypatch, calls, mod, name, key)
    mel = torch.from_numpy(rng.normal(size=(1, 80, 60)).astype(np.float32))
    W.encode(tp, mel, cfg, fused_attention=fused_attention,
             fused_blocks=fused_blocks)
    assert calls == [kernel] * cfg.enc_layers


def test_use_fused_attention_rule():
    """K8 on a CUDA tensor at T >= 512, as the JAX package's
    use_pallas_attention takes its kernel on a TPU at T >= 512."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert W.use_fused_attention(512, cuda) and W.use_fused_attention(1500,
                                                                      cuda)
    assert not W.use_fused_attention(511, cuda)
    assert not W.use_fused_attention(1500, cpu)


# ------------------------------------- the card checks see their faults
def _attn_numerics(q, k, v, *, pad=0, normalise=True, norm_first=False):
    """A [B, H, T, D] float32 emulation of the kernels' flash loop: P in
    bf16 before PV and 1/l after it (or, ``norm_first``, P / l in bf16
    before PV, K11's False form); a planted fault on request: ``pad`` zero
    keys left unmasked, or no 1/l."""
    q, k, v = q.float(), k.float(), v.float()
    if pad:
        k, v = (torch.cat([a, a.new_zeros(*a.shape[:2], pad, a.shape[3])],
                          dim=2) for a in (k, v))
    s = q @ k.transpose(-1, -2) / np.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if norm_first:
        return (p / l if normalise else p).to(torch.bfloat16).float() @ v
    o = p.to(torch.bfloat16).float() @ v
    return o / l if normalise else o


def _y(attn, wo):
    """The o-projection of the kernels' bf16 merged tile, in bf16."""
    b, h, t, d = attn.shape
    a = attn.transpose(1, 2).reshape(b, t, h * d).to(torch.bfloat16)
    return (a.float() @ wo.float()).to(torch.bfloat16)


def _card_inputs(heads=2):
    """chip_smoke's K1 inputs at T=1500 (B=1) with x = 0 and bo = 0: the
    output is the attention term alone."""
    gen = torch.Generator().manual_seed(heads)
    return chip_smoke.k1_inputs(gen, 1, 1500, heads, residual=False,
                                device="cpu")


@pytest.mark.parametrize("fault", [None, "pad keys unmasked"])
def test_k8_card_check_rejects_planted_fault(fault):
    """K8 at T=1500: the kernel's roundings pass chip_smoke's check; a
    kernel that left the 36 zero-padded keys of its last 128-key tile
    unmasked fails it."""
    q, k, v, *_ = _card_inputs()
    ref = A.encoder_attention_plain(q, k, v)
    got = _attn_numerics(q, k, v, pad=36 if fault else 0).to(torch.bfloat16)
    check = functools.partial(chip_smoke.check_rel, max_lim=chip_smoke.
                              K1_Y_MAX, l2_lim=chip_smoke.K1_Y_L2)
    if fault is None:
        check("K8", got, ref)
    else:
        with pytest.raises(AssertionError, match="off its plain version"):
            check(fault, got, ref)


def _k9_numerics(q, k8, ks, v8, vs, wo, *, fault=None):
    """K9 with its softmax in float64 (the kernel's exp and order of sums
    differ from the plain version's, which may flip a p8 code), the rest
    as the plain version; a planted fault on request: "head 0's key
    scales" used for every head."""
    if fault:
        ks = ks[:, :1].expand_as(ks)
    d = q.shape[-1]
    outs = []
    for h in range(q.shape[1]):
        qf = q[:, h].float() * (1.0 / float(np.sqrt(d)))
        q8, qs = EB._quantize_rows_exact(qf, 1e-12)
        s = (q8.double() @ k8[:, h].double().transpose(-1, -2)).float() \
            * qs * ks[:, h, None, :]
        p = torch.exp(s.double() - s.double().amax(-1, keepdim=True))
        pw = (p / p.sum(-1, keepdim=True)).float() * vs[:, h, None, :]
        p8, ps = EB._quantize_rows_exact(pw, 1e-30)
        outs.append((p8.double() @ v8[:, h].double()).float() * ps)
    return _y(torch.stack(outs, dim=1), wo)


@pytest.mark.parametrize("fault", [None, "head 0's key scales"])
def test_k9_card_check_rejects_planted_fault(fault):
    q, k, v, x, wo, bo = _card_inputs()
    kv = quantize_kv(k, v)
    ref = EB.attention_o_residual_int8_plain(q, *kv, x, wo, bo)
    got = _k9_numerics(q, *kv, wo, fault=fault)
    if fault is None:
        chip_smoke.check_k1("K9", got, ref, residual=False)
    else:
        with pytest.raises(AssertionError, match="attention term"):
            chip_smoke.check_k1(fault, got, ref, residual=False)


@pytest.mark.parametrize("fault", [None, "partner's keys"])
def test_k10_card_check_rejects_planted_fault(fault):
    """K10 at T=1500: the kernel's roundings pass; a kernel that paired
    each odd head's queries with its even partner's keys fails."""
    q, k, v, x, wo, bo = _card_inputs(heads=4)
    ref = EB.attention_o_residual_paired_plain(q, k, v, x, wo, bo)
    kf = k.clone()
    if fault:
        kf[:, 1::2] = k[:, 0::2]
    got = _y(_attn_numerics(q, kf, v), wo)
    if fault is None:
        chip_smoke.check_k1("K10", got, ref, residual=False)
    else:
        with pytest.raises(AssertionError, match="attention term"):
            chip_smoke.check_k1(fault, got, ref, residual=False)


@pytest.mark.parametrize("form", [False, True, "post"])
@pytest.mark.parametrize("fault", [None, "no 1/l"])
def test_k11_card_check_rejects_planted_fault(form, fault):
    q, k, v, x, wo, bo = _card_inputs()
    ref = EB.attention_o_residual_ab_plain(q, k, v, x, wo, bo, form)
    got = _y(_attn_numerics(q, k, v, normalise=fault is None,
                            norm_first=form is False), wo)
    if fault is None:
        chip_smoke.check_k1("K11", got, ref, residual=False)
    else:
        with pytest.raises(AssertionError, match="attention term"):
            chip_smoke.check_k1(fault, got, ref, residual=False)


def test_bounds_of_the_kernels_line():
    """chip_smoke's bound(): the larger of bytes over 3.35 TB/s and
    operations over their type's peak; K1's function at the main path's
    shape is bound by operations, ~0.175 ms."""
    got = chip_smoke.attn_o_bound(32, 1500, 8)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(
        (4 * 32 * 8 * 1500 ** 2 * 64 + 2 * 32 * 1500 * 512 ** 2) / 989e9)
    int8 = chip_smoke.attn_o_bound(32, 1500, 8, int8=True)
    assert int8["bound_ms"] == pytest.approx(
        4 * 32 * 8 * 1500 ** 2 * 64 / 1979e9
        + 2 * 32 * 1500 * 512 ** 2 / 989e9)
    got = chip_smoke.bound(3.35e9, bf16=1.0)
    assert got["bound_by"] == "bytes" and got["bound_ms"] == pytest.approx(1)
