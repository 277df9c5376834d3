"""K6 (int8 merged cross attention) and K7 (int8 cached attention) of the
PyTorch package, held to the JAX package's Pallas kernels on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version (a
CUDA kernel has no interpret mode); the Pallas kernels run in interpret
mode, as the JAX package's own tests run them, on the same int8 codes
and scales (quantized from the same seeded numpy K/V by both packages,
which must agree bit for bit). Tolerances, float32:
* K7: 1e-6 relative to the output's max. Its products are exact and the
  bf16 roundings of q and of the weighted probabilities are the same on
  both sides; only exp and the order of sums differ.
* K6: 1e-6 of the max as well, with room for one int8 code of the
  weighted probabilities flipped at a .5 boundary (exp and the sum
  order differ): a flip moves one (batch, head) output by at most
  spw / l * 127 = max_t(p * vs) / l, which the test computes and allows.
The card-side checks of chip_smoke.py (kernel against plain version on
the card) are held here to faults planted in float64 emulations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops import cached_attention as JCA
from multimodal_audio_search_tpu.ops import cross_attention as JCX
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
from multimodal_audio_search_tpu_torch.ops import cross_attention as CX

torch.set_num_threads(1)
TOL = 1e-6


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


# ------------------------------------------------------------ quantizers
@pytest.mark.parametrize("shape", [(2, 4, 16, 8), (1, 3, 37, 64)])
def test_quantize_kv_bit_equal(rng, shape):
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    k[0, 0, 0] = 0.0                        # a zero row: scale 1e-12 / 127
    k[0, 0, 1, :4] = [127.0, 0.5, 1.5, -2.5]  # codes on .5 boundaries
    k[0, 0, 1, 4:] = 0.0
    ref = JCA.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    got = CA.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    for g, r in zip(got, ref):
        assert g.dtype in (torch.int8, torch.float32) and g.is_contiguous()
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    np.testing.assert_array_equal(_np(got[0])[0, 0, 1, :4], [127, 0, 2, -2])


@pytest.mark.parametrize("heads", [2, 4])
def test_quantize_kv_merged_bit_equal(rng, heads):
    k, v = (rng.normal(size=(3, 21, heads * 16)).astype(np.float32)
            for _ in range(2))
    ref = JCX.quantize_kv_merged(jnp.asarray(k), jnp.asarray(v), heads)
    got = CX.quantize_kv_merged(torch.from_numpy(k), torch.from_numpy(v),
                                heads)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


def test_quantize_takes_head_split_views(rng):
    """The int8 cross path quantizes head-split VIEWS of the k/v dense
    outputs; the codes come out contiguous, equal to a copy's."""
    km = torch.from_numpy(rng.normal(size=(2, 9, 64)).astype(np.float32))
    view = km.reshape(2, 9, 4, 16).transpose(1, 2)
    assert not view.is_contiguous()
    got = CA.quantize_kv(view, view)
    ref = CA.quantize_kv(view.contiguous(), view.contiguous())
    for g, r in zip(got, ref):
        assert g.is_contiguous()
        assert torch.equal(g, r)


def test_quantize_in_chunks_leaves_its_input(rng, monkeypatch):
    """Quantized a few rows per pass (QUANT_CHUNK), in place on a float32
    copy: the JAX codes and scales still, and the input untouched."""
    monkeypatch.setattr(CA, "QUANT_CHUNK", 200)
    k, v = (rng.normal(size=(5, 3, 11, 16)).astype(np.float32)
            for _ in range(2))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = CA.quantize_kv(tk, tv)
    ref = JCA.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    np.testing.assert_array_equal(tk.numpy(), k)
    np.testing.assert_array_equal(tv.numpy(), v)


# ------------------------------------------------------------------- K7
@pytest.mark.parametrize("b,h,t,d",[(2, 4, 37, 64), (1, 3, 8, 16),
                                     (3, 2, 129, 64)])
def test_k7_plain_matches_pallas(rng, b, h, t, d):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
            for _ in range(2))
    jq = JCA.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    ref = np.asarray(JCA.int8_cached_attention(jnp.asarray(q), *jq,
                                               interpret=True))
    tq = CA.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    runtime.reset_counts()
    got = CA.int8_cached_attention(torch.from_numpy(q), *tq)
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())
    assert runtime.COUNTS["int8_cached_attention"] == 0


def test_k7_plain_rounds_q_and_pw_to_bf16(rng):
    """The kernel's roundings: a float32 q gives what its bf16 rounding
    gives, and the result differs from the JAX package's dequantizing
    CPU twin (which rounds neither) by more than the kernel tolerance."""
    q = rng.normal(size=(2, 2, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 50, 64)).astype(np.float32)
            for _ in range(2))
    tq = CA.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    got = CA.int8_cached_attention(torch.from_numpy(q), *tq)
    via_bf16 = CA.int8_cached_attention(
        torch.from_numpy(q).bfloat16().float(), *tq)
    assert torch.equal(got, via_bf16)
    twin = np.asarray(JCA.xla_int8_cached_attention(
        jnp.asarray(q), *(jnp.asarray(_np(a)) for a in tq)))
    assert np.abs(got.numpy() - twin).max() > 10 * TOL * np.abs(twin).max()


# ------------------------------------------------------------------- K6
def _flip_bound(q_m, k8, ks, v8, vs, heads, pos):
    """The most one flipped pw8 code can move each (b, h) output:
    spw / l * 127 = max_t(p * vs) / l, per row and head -> [B, H*D]."""
    b, hd = q_m.shape
    t = k8.shape[1]
    d = hd // heads
    q8, qs = CA.quantize_rows(q_m.reshape(b, heads, d))
    li = torch.einsum("bhd,bthd->bht", q8.double(),
                      k8.reshape(b, t, heads, d).double())
    lg = li * ks.double().transpose(1, 2) * qs.double()[..., None] / d ** .5
    if pos is not None:
        lg[..., pos + 1:] = -np.inf
    p = torch.exp(lg - lg.amax(-1, keepdim=True))
    bound = (p * vs.double().transpose(1, 2)).amax(-1) / p.sum(-1)
    return bound.repeat_interleave(d, dim=-1).numpy()


@pytest.mark.parametrize("b,t,heads,d,pos", [
    (3, 40, 4, 64, None), (3, 40, 4, 64, 17), (2, 9, 2, 16, 0),
    (5, 130, 2, 64, None), (1, 21, 3, 32, 20)])
def test_k6_plain_matches_pallas(rng, b, t, heads, d, pos):
    hd = heads * d
    q = rng.normal(size=(b, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, t, hd)).astype(np.float32)
            for _ in range(2))
    jq = JCX.quantize_kv_merged(jnp.asarray(k), jnp.asarray(v), heads)
    ref = np.asarray(JCX.fused_single_query_attention_int8(
        jnp.asarray(q), *jq, heads=heads,
        pos=None if pos is None else jnp.int32(pos), interpret=True))
    tq = CX.quantize_kv_merged(torch.from_numpy(k), torch.from_numpy(v),
                               heads)
    runtime.reset_counts()
    got = CX.fused_single_query_attention_int8(
        torch.from_numpy(q), *tq, heads=heads, pos=pos)
    assert got.shape == (b, hd) and got.dtype == torch.float32
    allowed = TOL * np.abs(ref).max() + TOL * np.abs(ref) \
        + _flip_bound(torch.from_numpy(q), *tq, heads, pos)
    assert np.all(np.abs(got.numpy() - ref) <= allowed)
    assert runtime.COUNTS["single_query_attention_int8"] == 0
    # and within the JAX package's own bound of its dequantizing twin
    twin = np.asarray(JCX.xla_single_query_attention_int8(
        jnp.asarray(q), *jq, heads=heads,
        pos=None if pos is None else jnp.int32(pos)))
    assert np.linalg.norm(got.numpy() - twin) / np.linalg.norm(twin) < 0.03


def test_k6_pos_zero_is_first_value_row(rng):
    """At pos=0 only key 0 is seen: p = 1, pw8 = 127 and the output is
    v8[0] * vs[0] (the dequantized first value row), exactly."""
    q = torch.from_numpy(rng.normal(size=(2, 128)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 7, 128)).astype(np.float32))
            for _ in range(2))
    k8, ks, v8, vs = CX.quantize_kv_merged(k, v, 2)
    got = CX.fused_single_query_attention_int8(q, k8, ks, v8, vs, heads=2,
                                               pos=0)
    row = v8[:, 0].float().reshape(2, 2, 64) * vs[:, 0, :, None]
    torch.testing.assert_close(got, row.reshape(2, 128), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError):
        CX.fused_single_query_attention_int8(q, k8, ks, v8, vs, heads=2,
                                             pos=7)


# ------------------------------------- the card checks see their faults
def _k6_emulation(q_m, k8, ks, v8, vs, *, heads, pos=None, fault=None):
    """K6 with the kernel's codes: q8 in float32 as the kernel quantizes
    it, the rest in float64, so a pw8 code may land one step from the
    float32 kernel's at a .5 boundary, as the kernel's and the plain
    version's may; and a planted fault on request: "pos mask ignored" or
    "one head's qs"."""
    b, hd = q_m.shape
    t = k8.shape[1]
    d = hd // heads
    qf = q_m.float().reshape(b, heads, d)
    qs = CA.div_exact(qf.abs().amax(-1).clamp_min(1e-12), 127.0)
    if fault == "one head's qs":
        qs = qs[:, :1].expand(b, heads)
    q8 = torch.round(qf / qs[..., None]).clamp(-127, 127).double()
    qs = qs.double()
    li = torch.einsum("bhd,bthd->bht", q8,
                      k8.reshape(b, t, heads, d).double())
    lg = li * ks.double().transpose(1, 2) * qs[..., None] / d ** .5
    if pos is not None and fault != "pos mask ignored":
        lg[..., pos + 1:] = -1e30
    p = torch.exp(lg - lg.amax(-1, keepdim=True))
    pw = p * vs.double().transpose(1, 2)
    spw = pw.amax(-1).clamp_min(1e-20) / 127
    pw8 = torch.round(pw / spw[..., None]).clamp(-127, 127)
    oi = torch.einsum("bht,bthd->bhd", pw8,
                      v8.reshape(b, t, heads, d).double())
    return (oi * (spw / p.sum(-1))[..., None]).reshape(b, hd)


def _k7_emulation(q, k8, ks, v8, vs, *, fault=None):
    """K7 in float64 with the kernel's bf16 roundings of q and pw, and on
    request the planted fault "vs left out" of the weighted
    probabilities."""
    qb = q.to(torch.bfloat16).double()
    lg = torch.einsum("bhd,bhtd->bht", qb, k8.double()) * ks.double() \
        / q.shape[-1] ** .5
    p = torch.exp(lg - lg.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    pw = p if fault == "vs left out" else p * vs.double()
    pw = pw.to(torch.bfloat16).double()
    return torch.einsum("bht,bhtd->bhd", pw, v8.double())


@pytest.mark.parametrize("heads", [8, 6])
@pytest.mark.parametrize("fault", [None, "pos mask ignored",
                                   "one head's qs"])
def test_k6_card_check_rejects_planted_faults(heads, fault):
    """chip_smoke's K6 check at the main path's T=1500 (B=8 here): the
    kernel's arithmetic passes with its masked pos, and a kernel that
    ignores the mask or scales every head's logits by head 0's qs fails."""
    gen = torch.Generator().manual_seed(heads)
    args = chip_smoke.k6_inputs(gen, 8, 1500, heads, device="cpu")
    pos = chip_smoke.K6_POS
    ref = CX.single_query_attention_int8_plain(*args, heads=heads, pos=pos)
    got = _k6_emulation(*args, heads=heads, pos=pos, fault=fault)
    if fault is None:
        chip_smoke.check_rel("K6", got, ref, chip_smoke.INT8_ATT_MAX,
                             chip_smoke.INT8_ATT_L2)
    else:
        with pytest.raises(AssertionError, match="off its plain version"):
            chip_smoke.check_rel(fault, got, ref, chip_smoke.INT8_ATT_MAX,
                                 chip_smoke.INT8_ATT_L2)


@pytest.mark.parametrize("heads", [8, 6])
@pytest.mark.parametrize("fault", [None, "vs left out"])
def test_k7_card_check_rejects_planted_faults(heads, fault):
    gen = torch.Generator().manual_seed(10 + heads)
    args = chip_smoke.k7_inputs(gen, 8, 1500, heads, device="cpu")
    ref = CA.int8_cached_attention_plain(*args)
    got = _k7_emulation(*args, fault=fault)
    if fault is None:
        chip_smoke.check_rel("K7", got, ref, chip_smoke.INT8_ATT_MAX,
                             chip_smoke.INT8_ATT_L2)
    else:
        with pytest.raises(AssertionError, match="off its plain version"):
            chip_smoke.check_rel(fault, got, ref, chip_smoke.INT8_ATT_MAX,
                                 chip_smoke.INT8_ATT_L2)


# -------------------------------------- decode steps: the JAX guardrail
# whisper-base decoder widths at a short context, as the JAX package's
# own guardrail tests (tests/test_int8_kv.py, tests/test_cross_attention.py)
GUARD = dict(vocab_size=1000, d_model=512, enc_layers=1, dec_layers=2,
             heads=8, ffn=1024, enc_positions=500, dec_positions=24,
             bos_token_id=990, eos_token_id=991, pad_token_id=991,
             no_timestamps_id=993, transcribe_id=994, lang_en_id=995)


@pytest.mark.parametrize("mode", ["int8_fused", "int8"])
def test_int8_decode_steps_meet_the_jax_guardrail(rng, mode):
    """A quantized decoder (both packages' int8 weights) at B=32 over
    int8 cross K/V in the port (K6 or K7 plain, with the kernels'
    roundings) against the JAX decode step over exact float32 cross K/V:
    first-step logits within 5 % of their span and argmax agreement
    >= 0.9, the JAX package's bounds for these modes; and 8 greedy
    tokens agreeing >= 0.9 with the JAX einsum decode."""
    import jax
    from multimodal_audio_search_tpu.config import DecodeConfig as JDec
    from multimodal_audio_search_tpu.models import generate as JG
    from multimodal_audio_search_tpu.models import whisper as JW
    from multimodal_audio_search_tpu.ops.quant import (
        quantize_whisper_decoder)
    from multimodal_audio_search_tpu_torch import weights
    from multimodal_audio_search_tpu_torch.config import DecodeConfig
    from multimodal_audio_search_tpu_torch.models import generate as G
    from multimodal_audio_search_tpu_torch.models import whisper as W
    jcfg, tcfg = JW.WhisperConfig(**GUARD), W.WhisperConfig(**GUARD)
    jp = quantize_whisper_decoder(JW.init_params(jax.random.PRNGKey(1),
                                                 jcfg))
    tp = W.prepare_params(weights.whisper_params(
        jax.tree.map(np.asarray, jp)), torch.float32, torch.device("cpu"))
    b, steps = 32, 8
    enc = (rng.normal(size=(b, 500, 512)) * 0.3).astype(np.float32)
    jl, _ = JW.decode_step(jp, jnp.full((b,), jcfg.bos_token_id, jnp.int32),
                           jnp.int32(0), JW.init_cache(jcfg, b, 4,
                                                       jnp.float32),
                           JW.cross_kv(jp, jnp.asarray(enc), jcfg), jcfg)
    ckv = (W.cross_kv_merged_int8 if mode == "int8_fused"
           else W.cross_kv_quantized)(tp, torch.from_numpy(enc), tcfg)
    tl = W.decode_step(tp, torch.full((b,), tcfg.bos_token_id), 0,
                       W.init_cache(tcfg, b, 4, torch.float32,
                                    torch.device("cpu")), ckv, tcfg)
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.abs(tl - jl).max() / (jl.max() - jl.min()) < 0.05
    assert (tl.argmax(-1) == jl.argmax(-1)).mean() >= 0.9
    prefix = np.tile(np.asarray(JW.forced_prefix(jcfg), np.int32), (b, 1))
    ref = JG.generate(jp, jnp.asarray(enc), jnp.asarray(prefix), cfg=jcfg,
                      decode=JDec(max_new_tokens=steps, cross_attn="einsum"),
                      prefix_len=4, max_new_tokens=steps)
    out = G.generate(tp, torch.from_numpy(enc), torch.from_numpy(prefix),
                     cfg=tcfg, decode=DecodeConfig(max_new_tokens=steps,
                                                   cross_attn=mode),
                     max_new_tokens=steps)
    assert (out.tokens.numpy() == np.asarray(ref.tokens)).mean() >= 0.9
