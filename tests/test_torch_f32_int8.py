"""The int8 decoder on float32 against the JAX package's, on the CPU.

On the card a float32 engine with ``quantize_decoder`` runs K5's float32
forms (every dense decoder layer, the tied logits, the cross K/V
projections), K6's under ``cross_attn="int8_fused"`` and K7's under
``"int8"`` (csrc/quant_matmul.cu, cross_attention_int8.cu,
cached_attention.cu); on the CPU the same wrappers run their plain
versions, which the card tests hold those kernels to (tests/
test_torch_cuda.py -k float32). At the geometry of
tests/test_torch_f32_decoder.py (2 decoder layers, 2 heads of 64,
D=128), in float32, with JAX's B6 / B7 / B8 run as Pallas kernels in
interpret mode (its CPU twins ``xla_single_query_attention_int8`` /
``xla_int8_cached_attention`` replaced by them for the test; B8 is
interpret mode off the TPU already):

* greedy ``generate`` gives JAX's tokens and lengths, and the decode
  steps on those tokens JAX's logits within 5e-5, under both modes;
* K5's wide float32 form (2xTF32 on mma.sync m16n8k8) emulated on the
  CPU, in its order -- TF32 by bit operations, the kernel's permuted
  k-steps, each step's exact products summed rounded toward zero into a
  64-deep tile's sum, the tiles added to nearest -- is within [f32]'s
  F32_BLOCK_ATOL / RTOL of the plain version at the cross K/V
  projection's widths; one TF32 product (x's hi part alone) misses it;
* [f32]'s bound of K5's float32 function counts two TF32 products in
  every regime (the tied logits: bound by their bytes, not FFMA);
* the float32 table kernel's K limit, mirrored from the source, fits
  every Whisper width (d = 384-1280) and a ValueError names it past;
* [f32]'s float32 limit for K6 / K7 (F32_INT8_ATT_MAX / L2) passes a
  float64 emulation of the float32 forms' arithmetic at T=1500 and fails
  the planted q faults (K6's q rounded to bf16 before B6's division,
  K7's q left in float32);
* chip_smoke's [f32] checks of the float32 int8 engines (the first
  decode step against the plain versions at F32_INT8_STEP_MAX, which the
  step with the planted q fault must fail, and self-retrieval) rehearsed
  on a CPU engine, each catching a planted fault.
"""
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.models import generate as JG
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.ops import cached_attention as JCA
from multimodal_audio_search_tpu.ops import cross_attention as JCX
from multimodal_audio_search_tpu.ops.quant import (
    quantize_whisper_decoder as jquantize)
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import generate as G
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
from multimodal_audio_search_tpu_torch.ops import quant as Q
from tests.test_torch_int8_attention import _k6_emulation, _k7_emulation
from tests.test_torch_tf32x3 import mma, split

torch.set_num_threads(1)
CPU = torch.device("cpu")
B, T_ENC, NEW = 8, 100, 6
LOGITS_ATOL = 5e-5


@pytest.fixture
def pallas_int8(monkeypatch):
    """JAX's decode, off the TPU, through its int8 Pallas kernels in
    interpret mode: the module attributes it calls there replaced by B6
    and B7 (the same signatures), compiled programs cleared around it."""
    monkeypatch.setattr(JCX, "xla_single_query_attention_int8",
                        functools.partial(
                            JCX.fused_single_query_attention_int8,
                            interpret=True))
    monkeypatch.setattr(JCA, "xla_int8_cached_attention",
                        functools.partial(JCA.int8_cached_attention,
                                          interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _trees(seed):
    jc = JW.config_for("test", d_model=128, heads=2)     # head dim 64
    tc = W.config_for("test", d_model=128, heads=2)
    jq = jquantize(JW.init_params(jax.random.PRNGKey(seed), jc))
    tq = W.prepare_params(weights.whisper_params(
        jax.tree.map(np.asarray, jq)), torch.float32, CPU)
    return jc, tc, jq, tq


@pytest.mark.parametrize("mode", ["int8_fused", "int8"])
def test_f32_int8_decode_matches_jax(pallas_int8, mode):
    """The quantized decoder in float32 under ``mode``: greedy tokens and
    lengths = JAX's (B6 or B7 and B8 in interpret mode), then the decode
    steps on those tokens over each package's int8 cross K/V (merged for
    int8_fused, [B, H, T, D] for int8), logits within 5e-5 of JAX's."""
    jc, tc, jq, tq = _trees(26)
    assert Q.is_quantized(tq) and tq["decoder"]["blocks"][0]["mlp_in"][
        "b"].dtype == torch.float32
    enc = np.random.default_rng(26).normal(
        size=(B, T_ENC, jc.d_model)).astype(np.float32)
    prefix = np.tile(np.asarray(JW.forced_prefix(jc), np.int32), (B, 1))
    kw = dict(max_new_tokens=NEW, cross_attn=mode)
    ref = JG.generate(jq, jnp.asarray(enc), jnp.asarray(prefix), cfg=jc,
                      decode=jcfg.DecodeConfig(**kw),
                      prefix_len=prefix.shape[1], max_new_tokens=NEW)
    out = G.generate(tq, torch.from_numpy(enc), torch.from_numpy(prefix),
                     cfg=tc, decode=tcfg.DecodeConfig(**kw),
                     max_new_tokens=NEW)
    tokens = np.array(ref.tokens)
    np.testing.assert_array_equal(out.tokens.numpy(), tokens)
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    jckv_of, tckv_of = ((JW.cross_kv_merged_int8, W.cross_kv_merged_int8)
                        if mode == "int8_fused" else
                        (JW.cross_kv_quantized, W.cross_kv_quantized))
    jckv = jckv_of(jq, jnp.asarray(enc), jc)
    tckv = tckv_of(tq, torch.from_numpy(enc), tc)
    for (j8, *_), (t8, *_) in zip(jckv, tckv):   # the codes: bit-equal
        np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    steps = tokens.shape[1] - 1
    jcache = JW.init_cache(jc, B, steps, jnp.float32)
    tcache = W.init_cache(tc, B, steps, torch.float32, CPU)
    err = 0.0
    for pos in range(steps):
        jl, jcache = JW.decode_step(jq, jnp.asarray(tokens[:, pos]),
                                    jnp.int32(pos), jcache, jckv, jc)
        tl = W.decode_step(tq, torch.from_numpy(tokens[:, pos]).long(), pos,
                           tcache, tckv, tc)
        assert tl.dtype == torch.float32
        err = max(err, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    assert err <= LOGITS_ATOL, err


# --------------------------------------- K5's wide float32 form: 2xTF32
WIDE_TILE = 64      # K rows a tensor-core sum runs over (WB_K)
# the k order of each 16 of K in the kernel: step 0 takes physical k 4t and
# 4t + 1 (t < 4) as its eight, step 1 4t + 2 and 4t + 3
PERM16 = [4 * t + i for i in (0, 1) for t in range(4)] + \
    [4 * t + i for i in (2, 3) for t in range(4)]


def k5_wide_tf32(x, wq, scale, bias=None, passes: int = 2):
    """csrc/quant_matmul.cu's wide_f32_kernel on the CPU: x [M, K] float32
    times the codes [K, N], K in 64-deep tiles; each tile's sum starts at
    zero and takes its k-steps of 8 (k permuted inside each 16 as the
    kernel takes it), each step lo_x w then hi_x w (``passes`` 2; 1: hi_x
    w alone, one TF32 product), every step rounded once toward zero; the
    tiles' sums added to nearest in K order; then * scale (+ bias), each
    rounded to nearest."""
    m, k = x.shape
    kp = -(-k // 16) * 16
    xp = torch.zeros(m, kp)
    xp[:, :k] = x
    wp = torch.zeros(kp, wq.shape[1])
    wp[:k] = wq.float()
    perm = torch.tensor([c + p for c in range(0, kp, 16) for p in PERM16])
    xp, wp = xp[:, perm], wp[perm]
    acc = torch.zeros(m, wq.shape[1])
    for k0 in range(0, kp, WIDE_TILE):
        tile = torch.zeros_like(acc)
        for s0 in range(k0, min(k0 + WIDE_TILE, kp), 8):
            hi, lo = split(xp[:, s0:s0 + 8])
            wk = wp[s0:s0 + 8]             # the codes: exact in TF32
            if passes == 2:
                tile = mma(tile, lo, wk)
            tile = mma(tile, hi, wk)
        acc = acc + tile
    y = acc * scale
    return y if bias is None else y + bias


@pytest.mark.parametrize("m,k,n", [(96, 512, 512), (96, 384, 384),
                                   (40, 520, 48)])
def test_k5_wide_tf32_arithmetic_meets_the_f32_tolerance(m, k, n):
    """The 2xTF32 arithmetic at the cross K/V projection's widths (and a
    last K tile of 8) against the plain version, on chip_smoke's K5 inputs
    in float32: within F32_BLOCK_ATOL / RTOL; the hi product alone is
    not."""
    gen = torch.Generator().manual_seed(k + n)
    x, wq, scale, b = chip_smoke.k5_inputs(gen, m, k, n, device="cpu",
                                           dtype=torch.float32)
    ref = chip_smoke.k5_plain(x, wq, scale, b, torch.float32)
    tol = (chip_smoke.F32_BLOCK_ATOL, chip_smoke.F32_BLOCK_RTOL)
    err = chip_smoke.check_close("2xTF32", k5_wide_tf32(x, wq, scale, b),
                                 ref, *tol)
    assert err < 0.2 * tol[0], err
    with pytest.raises(AssertionError, match="outside atol"):
        chip_smoke.check_close("one TF32 product", k5_wide_tf32(
            x, wq, scale, b, passes=1), ref, *tol)


# --------------------------------------- the float32 table kernel's limit
H100_SMEM_OPTIN = 232448   # bytes a block may opt into on an H100


def _src_const(name: str) -> int:
    src = (pathlib.Path(Q.__file__).resolve().parent.parent / "csrc"
           / "quant_matmul.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


@pytest.mark.parametrize("m,k,n,by", [
    (32, 512, 2048, "bytes"), (32, 512, 51865, "bytes"),
    (48000, 512, 512, "operations")])
def test_k5_f32_bound_counts_two_tf32_products(m, k, n, by):
    """[f32]'s bound of K5's float32 function in each regime (decode
    layer, tied logits, cross K/V at whisper-base): the codes are exact in
    TF32, so the least time is the larger of the bytes and two TF32
    products an element (f32_bound with products=2). The tied logits are
    bound by their ~33 MB (~10 us), under the 25.4 us that FFMA would
    take; the cross K/V projection by its 2xTF32 operations."""
    nbytes = 4 * m * k + k * n + 4 * n + 4 * n + 4 * m * n
    flops = 2 * m * k * n
    got = chip_smoke.f32_bound(nbytes, flops, products=2)
    assert got["bound_by"] == by
    assert got["bound_ms"] == pytest.approx(1e3 * max(
        nbytes / chip_smoke.HBM_BYTES_S,
        2 * flops / chip_smoke.PEAK_OPS["tf32"]))
    ffma = chip_smoke.bound(nbytes, f32=flops)["bound_ms"]
    if n == 51865:
        assert got["bound_rate"] == "2xtf32"
        assert got["bound_ms"] == pytest.approx(0.0100, abs=2e-4)
        assert ffma == pytest.approx(0.0254, abs=2e-4)
    assert got["bound_ms"] <= ffma


@pytest.mark.parametrize("d", [384, 512, 768, 1024, 1280])
def test_f32_table_limit_fits_every_whisper_width(d):
    """The float32 table kernel holds x [32, Kp + 4] float32 and each warp
    two ring stages of 32 table rows x (T32_KP + 16) bytes in one block's
    shared memory: at every Whisper width at least 4 warps fit an H100's,
    its limit is ops/quant.py's TABLE_MAX_K_F32, and the plan raises a
    ValueError naming it past the limit (the bf16 kernel goes on to
    TABLE_MAX_K)."""
    assert _src_const("T32_MAX_K") == Q.TABLE_MAX_K_F32 == 1280
    assert _src_const("T_MAX_K") == Q.TABLE_MAX_K
    warp = _src_const("T_STAGES") * _src_const("T32_ROWS") * (
        _src_const("T32_KP") + 16)
    kp = -(-d // 16) * 16
    assert d <= Q.TABLE_MAX_K_F32
    assert (H100_SMEM_OPTIN - 32 * (kp + 4) * 4) // warp >= 4
    assert Q.split_plan(32, d, 51865, f32=True)[0] == "table"
    with pytest.raises(ValueError, match="K <= 1280 for its float32 table"):
        Q.split_plan(32, 1296, 51865, f32=True)
    assert Q.split_plan(32, 1296, 51865)[0] == "table"


# ------------------------------------ [f32]'s int8 engine checks, rehearsed
def _cpu_int8_engine(mode):
    """A toy-width float32 engine on the CPU (head dim 64) with the int8
    decoder on both models under ``mode``."""
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        DualPipelineIngest)
    from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
        WhisperTextPipeline)
    wcfg = W.config_for("test", d_model=128, heads=2)
    mel = tcfg.MelConfig(padded_seconds=2.0)
    dec = tcfg.DecodeConfig(max_new_tokens=5, cross_attn=mode)
    pipes = [WhisperTextPipeline(
        params=Q.quantize_whisper_decoder(W.init_params(
            torch.Generator().manual_seed(s), wcfg)),
        cfg=wcfg, decode=dec, mel_cfg=mel, device="cpu",
        prefix_ids=None if s == 0 else [wcfg.bos_token_id])
        for s in (0, 1)]
    emb = TextEmbedder(cfg=PRESETS["test"], device="cpu")
    cfg = tcfg.EngineConfig(ingest_batch=4, embed_dim=64)
    return AudioSearchEngine(cfg=cfg, ingest_pipeline=DualPipelineIngest(
        *pipes, emb, cfg))


@pytest.mark.parametrize("heads", [8, 6])
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_f32_int8_attention_limit_sees_q_faults(kernel, heads):
    """[f32]'s float32 limit for K6's and K7's float32 forms at the main
    path's T=1500 (B=8 here; K6 at K6_POS): a float64 emulation of the
    float32 form's arithmetic (float32 q; K6's codes by B6's division, K7's
    q and weighted probabilities rounded to bf16) passes it, and the
    planted q fault fails it by more than 10x in the L2 reading, as
    fault_reading requires on the card."""
    gen = torch.Generator().manual_seed(26 + heads)
    lim = (chip_smoke.F32_INT8_ATT_MAX, chip_smoke.F32_INT8_ATT_L2)
    if kernel == "K6":
        args = chip_smoke.k6_inputs(gen, 8, 1500, heads, device="cpu",
                                    dtype=torch.float32)
        kw = {"heads": heads, "pos": chip_smoke.K6_POS}
        ref = CX.single_query_attention_int8_plain(*args, **kw)
        sound = _k6_emulation(*args, **kw)
        bad = chip_smoke.q_bf16_plain_k6(*args, **kw)
    else:
        args = chip_smoke.k7_inputs(gen, 8, 1500, heads, device="cpu",
                                    dtype=torch.float32)
        ref = CA.int8_cached_attention_plain(*args)
        sound = _k7_emulation(*args)
        bad = chip_smoke.q_f32_plain_k7(*args)
    chip_smoke.check_rel(f"{kernel} float32", sound, ref, *lim)
    with pytest.raises(AssertionError, match="passes a planted fault"):
        chip_smoke.fault_reading(f"{kernel} float32", sound, ref, *lim)
    r = chip_smoke.fault_reading(f"{kernel} q fault", bad, ref, *lim)
    assert r["rel_l2_err"] > 10 * lim[1]
    with pytest.raises(AssertionError, match="off its plain version"):
        chip_smoke.check_rel(f"{kernel} q fault", bad, ref, *lim)


@pytest.mark.parametrize("mode", ["int8_fused", "int8"])
def test_chip_f32_int8_engine_checks_on_cpu(mode, monkeypatch):
    """chip_smoke.py's [f32] checks of a float32 int8 engine rehearsed on
    a CPU engine: its first decode step against the same step on the
    plain versions (plain_int8_kernels) passes F32_INT8_STEP_MAX, with no
    launch counted off the card, and the same step with the attention's
    planted q fault reads beyond it; the self-retrieval query ranks its
    own segment first. Planted faults are caught: K5's logits with their
    last 8 columns zeroed (a chunk of the table left out), and another
    segment first."""
    eng = _cpu_int8_engine(mode)
    asr = eng.ingest_pipeline.asr
    assert asr.dtype == torch.float32 and asr.quantized
    out = chip_smoke.f32_int8_step_check("cpu", asr, mode,
                                         np.random.default_rng(26))
    assert out["first_step_err_of_span"] == 0.0
    assert out["argmax_agreement"] == 1.0
    assert out["planted_q_fault_err_of_span"] > chip_smoke.F32_INT8_STEP_MAX
    assert not any(out["launches"].values())
    wave = (np.random.default_rng(0).normal(size=16000 * 25) * 0.3) \
        .astype(np.float32)
    eng.ingest_waveform(wave, 16000, "x.wav")
    texts = [m["asr_text"] for m in eng.store.meta]
    own, unique = chip_smoke.self_query("cpu", texts)
    hits = eng.search(texts[own])[0]
    chip_smoke.check_self_hit("cpu", hits, texts, own, unique)
    planted = [{**hits[0], "index": own + 1, "asr_text": "planted"},
               *hits[1:]]
    with pytest.raises(AssertionError, match="not first|share"):
        chip_smoke.check_self_hit("cpu", planted, texts, own, unique)
    real = Q.quant_dense_apply
    vocab = asr.cfg.vocab_size

    def dropped_chunk(p, x, out_dtype=None):
        y = real(p, x, out_dtype)
        if y.shape[-1] == vocab:
            y[..., -8:] = 0
        return y
    monkeypatch.setattr(Q, "quant_dense_apply", dropped_chunk)
    with pytest.raises(AssertionError, match="of the logits' span"):
        chip_smoke.f32_int8_step_check("cpu", asr, mode,
                                       np.random.default_rng(26))
