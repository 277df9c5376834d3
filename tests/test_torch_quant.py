"""The int8 decoder weights of the PyTorch package (ops/quant.py, K5) and
the quantized decoder, held to the JAX package on the CPU.

* quantize_weight / quantize_whisper_decoder: codes, scales and the
  bf16-rounded lookup table bit-equal to JAX's, leaf for leaf;
  weights.py carries the JAX quantized tree over unchanged.
* K5's plain version (what a CPU tensor runs) against the Pallas
  ``quant_matmul`` in interpret mode: 1e-6 of the output's max. Every
  product of an int8 code with a float32 x is exact, so only the order
  of the float32 sums differs. Where the JAX ``quant_dense_apply``
  takes its dequantizing XLA product (rows * N > 4M on the CPU), the
  order differs more: 1e-5 of the max.
* a quantized decoder's decode steps with bf16-style cross K/V (einsum,
  merged for K2): logits within 5e-5 of JAX's at float32, greedy tokens
  identical; ``fused_layer`` on a quantized decoder is refused (the JAX
  package fails there with KeyError 'w').
* chip_smoke.py's K5 check (kernel against plain version on the card)
  held to faults planted in a float64 emulation of the kernel's tiling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.models import generate as JG
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.ops import quant as JQ
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch import runtime, weights
from multimodal_audio_search_tpu_torch.models import generate as G
from multimodal_audio_search_tpu_torch.models import layers as L
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.ops import quant as Q

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, path=""):
    """(path, leaf) pairs of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# -------------------------------------------------------------- quantize
@pytest.mark.parametrize("shape", [(64, 96), (37, 513), (8, 3)])
def test_quantize_weight_bit_equal(rng, shape):
    w = rng.normal(size=shape).astype(np.float32)
    w[:, 0] = 0.0                           # scale 1e-12 / 127
    w[:, 1] = 0.0
    w[:5, 1] = [127.0, 0.5, 1.5, 2.5, -2.5]  # scale 1: codes on .5
    q, s = Q.quantize_weight(torch.from_numpy(w))
    qj, sj = JQ.quantize_weight(w)
    assert q.dtype == np.int8 and q.flags.c_contiguous
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s.view(np.int32), sj.view(np.int32))
    np.testing.assert_array_equal(q[:5, 1], [127, 0, 2, 2, -2])


@pytest.fixture(scope="module")
def trees():
    """A JAX test-preset Whisper, its JAX-quantized tree, and the port's
    quantization of the same weights."""
    cfg = JW.PRESETS["test"]
    jp = JW.init_params(jax.random.PRNGKey(4), cfg)
    jq = JQ.quantize_whisper_decoder(jp)
    tq = Q.quantize_whisper_decoder(weights.whisper_params(_np(jp)))
    return cfg, jp, jq, tq


def test_quantize_whisper_decoder_leaf_for_leaf(trees):
    _, _, jq, tq = trees
    jl, tl = dict(_leaves(_np(jq))), dict(_leaves(tq))
    assert jl.keys() == tl.keys()
    assert "/decoder/embed_tokens_q/wq" in tl
    assert "/decoder/blocks/0/cross_attn/k/wq" in tl
    assert not any(p.startswith("/decoder/blocks") and p.endswith("/w")
                   for p in tl)
    for path, ref in jl.items():
        got = tl[path]
        if ref.dtype.name == "bfloat16":    # the lookup table
            assert path == "/decoder/embed_tokens"
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          ref.astype(np.float32))
        else:
            got = got.numpy()
            assert got.dtype == ref.dtype, path
            np.testing.assert_array_equal(got.view(np.uint8),
                                          ref.view(np.uint8), err_msg=path)


def test_weights_carry_quantized_jax_tree(trees):
    """weights.whisper_params takes the JAX quantized tree: int8 leaves
    stay int8, the bf16 lookup table comes over as float32 holding its
    values, and the result equals the port's own quantization."""
    _, _, jq, tq = trees
    tj = weights.whisper_params(_np(jq))
    for (p1, a), (p2, b) in zip(_leaves(tj), _leaves(tq)):
        assert p1 == p2
        assert a.dtype == (torch.float32 if b.dtype == torch.bfloat16
                           else b.dtype), p1
        assert torch.equal(a, b.to(a.dtype)), p1
    with pytest.raises(NotImplementedError):    # int8 in the encoder
        bad = _np(jq)
        bad["encoder"]["blocks"][0]["mlp_in"] = \
            bad["decoder"]["blocks"][0]["mlp_in"]
        weights.whisper_params(bad)


def test_prepare_params_keeps_int8_and_scales(trees):
    """cast_floats keeps int8 weights int8 and every 'scale' (layer norm
    and quantization) float32; a quantized decoder gets no float32 copy
    of the embedding table; dense dispatches on "wq"."""
    cfg, _, _, tq = trees
    p = W.prepare_params(tq, torch.bfloat16, CPU)
    dec = p["decoder"]
    assert "embed_tokens_f32" not in dec
    assert dec["embed_tokens"].dtype == torch.bfloat16
    assert dec["embed_tokens_q"]["wq"].dtype == torch.int8
    assert dec["embed_tokens_q"]["scale"].dtype == torch.float32
    q = dec["blocks"][0]["self_attn"]["q"]
    assert (q["wq"].dtype, q["scale"].dtype, q["b"].dtype) == (
        torch.int8, torch.float32, torch.bfloat16)
    assert dec["blocks"][0]["self_ln"]["scale"].dtype == torch.float32
    assert p["encoder"]["blocks"][0]["mlp_in"]["w"].dtype == torch.bfloat16
    x = torch.randn(3, 2, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).bfloat16()
    got = L.dense(q, x)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, Q.quant_dense_apply(q, x))
    plain = W.prepare_params(weights.whisper_params(_np(JW.init_params(
        jax.random.PRNGKey(0), cfg))), torch.bfloat16, CPU)
    assert plain["decoder"]["embed_tokens_f32"].dtype == torch.float32


# ------------------------------------------------------------------- K5
@pytest.mark.parametrize("m,k,n,blk_n", [(10, 64, 700, 256), (33, 128, 129, 128),
                                         (1, 96, 40, 128), (70, 64, 512, 512)])
def test_k5_plain_matches_pallas(rng, m, k, n, blk_n):
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, s = Q.quantize_weight(rng.normal(size=(k, n)).astype(np.float32))
    ref = np.asarray(JQ.quant_matmul(jnp.asarray(x), jnp.asarray(q),
                                     jnp.asarray(s), blk_n=blk_n,
                                     interpret=True))
    runtime.reset_counts()
    got = Q.quant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                         torch.from_numpy(s))
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())
    assert runtime.COUNTS["quant_matmul"] == 0


@pytest.mark.parametrize("rows,n,tol", [(6, 96, TOL), (2100, 2048, 1e-5)])
def test_quant_dense_apply_matches_jax(rng, rows, n, tol):
    """Bias added in float32 after the product, leading dims kept, output
    dtype as asked. 2100 x 2048 rows * N > 4M: the JAX function takes
    its XLA dequant product there (another order of the sums)."""
    k = 64
    x = rng.normal(size=(rows // 2, 2, k)).astype(np.float32)
    q, s = Q.quantize_weight(rng.normal(size=(k, n)).astype(np.float32))
    b = rng.normal(size=n).astype(np.float32)
    jp = {"wq": jnp.asarray(q), "scale": jnp.asarray(s), "b": jnp.asarray(b)}
    tp = {"wq": torch.from_numpy(q), "scale": torch.from_numpy(s),
          "b": torch.from_numpy(b)}
    for out in (None, "f32"):
        ref = np.asarray(JQ.quant_dense_apply(
            jp, jnp.asarray(x), out_dtype=out and jnp.float32))
        got = Q.quant_dense_apply(tp, torch.from_numpy(x),
                                  out_dtype=out and torch.float32)
        assert got.shape == (rows // 2, 2, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=tol,
                                   atol=tol * np.abs(ref).max())


def _k5_emulation(x, wq, scale, b, out_dtype, fault=None):
    """K5 in float64 with the kernel's tiling, and on request a planted
    fault: "last column tile dropped" (a grid of N // BN column tiles, BN
    the plan's),
    or "scale by row" (scale[m] in place of scale[n])."""
    m, n = x.shape[0], wq.shape[1]
    acc = x.double() @ wq.double()
    s = scale.double()
    y = acc * (s[:m, None] if fault == "scale by row" else s)
    if b is not None:
        y = y + b.double()
    if fault == "last column tile dropped":
        bn = Q.split_plan(m, x.shape[1], n)[1]
        assert n % bn
        y[:, n // bn * bn:] = 0.0
    return y.to(out_dtype)


@pytest.mark.parametrize("shape,fault", [
    ((32, 384, 51865, "f32", False), None),
    ((32, 384, 51865, "f32", False), "last column tile dropped"),
    ((200, 384, 1000, "bf16", True), None),
    ((200, 384, 1000, "bf16", True), "last column tile dropped"),
    ((32, 512, 2048, "bf16", True), None),
    ((32, 512, 2048, "bf16", True), "scale by row")])
def test_k5_card_check_rejects_planted_faults(shape, fault):
    """chip_smoke's K5 check on its own inputs: the kernel's arithmetic
    (float64 here) passes, a kernel without the guard of the last, partial
    column tile (N = 51865 for the vocabulary; 1000 in the 128-wide
    tiling) or with the scale indexed by row fails."""
    m, k, n, dt, bias = shape
    out_dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator().manual_seed(n)
    x, wq, scale, b = chip_smoke.k5_inputs(gen, m, k, n, bias=bias,
                                           device="cpu")
    ref = chip_smoke.k5_plain(x, wq, scale, b, out_dtype)
    got = _k5_emulation(x, wq, scale, b, out_dtype, fault)
    if fault is None:
        chip_smoke.check_k5("K5", got, ref)
    else:
        with pytest.raises(AssertionError, match="outside atol"):
            chip_smoke.check_k5(fault, got, ref)


def test_k5_shapes_cover_the_path():
    """chip_smoke holds K5 at every dense shape of both widths' decode
    steps, at the logits, and at the cross K/V projection over B*1500
    rows, in both tilings."""
    got = {(m, k, n) for m, k, n, _, _ in chip_smoke.K5_SHAPES}
    for d, f in ((512, 2048), (384, 1536)):
        assert {(32, d, d), (32, d, f), (32, f, d), (32, d, 51865),
                (48000, d, d)} <= got
    assert {m <= Q.SMALL_M for m, *_ in got} == {True, False}


# ------------------------------------------------- the quantized decoder
@pytest.mark.parametrize("cross", ["einsum", "merged"])
def test_quantized_decode_step_matches_jax(trees, rng, cross):
    """Six cached decode steps of the quantized decoder: every dense layer
    and the logits through K5's plain version, the cross attention over
    bf16-style K/V (einsum, or merged for K2): logits within 5e-5 of the
    JAX steps at float32."""
    cfg, _, jq, tq = trees
    tp = W.prepare_params(tq, torch.float32, CPU)
    enc = rng.normal(size=(2, 100, cfg.d_model)).astype(np.float32)
    jckv = JW.cross_kv(jq, jnp.asarray(enc), cfg)
    tckv = (W.cross_kv_merged if cross == "merged" else W.cross_kv)(
        tp, torch.from_numpy(enc), cfg)
    jcache = JW.init_cache(cfg, 2, 8, jnp.float32)
    tcache = W.init_cache(cfg, 2, 8, torch.float32, CPU)
    toks = rng.integers(0, cfg.vocab_size, size=(6, 2))
    for pos in range(6):
        jl, jcache = JW.decode_step(jq, jnp.asarray(toks[pos], jnp.int32),
                                    jnp.int32(pos), jcache, jckv, cfg)
        tl = W.decode_step(tp, torch.from_numpy(toks[pos]).long(), pos,
                           tcache, tckv, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5)


@pytest.mark.parametrize("cross", ["auto", "einsum"])
def test_quantized_greedy_tokens_identical(trees, rng, cross):
    cfg, _, jq, tq = trees
    tp = W.prepare_params(tq, torch.float32, CPU)
    enc = rng.normal(size=(3, 100, cfg.d_model)).astype(np.float32)
    prefix = np.tile(np.asarray(JW.forced_prefix(cfg), np.int32), (3, 1))
    kw = dict(max_new_tokens=10, repetition_penalty=1.3,
              no_repeat_ngram_size=2)
    ref = JG.generate(jq, jnp.asarray(enc), jnp.asarray(prefix), cfg=cfg,
                      decode=jcfg.DecodeConfig(**kw), prefix_len=4,
                      max_new_tokens=10)
    out = G.generate(tp, torch.from_numpy(enc), torch.from_numpy(prefix),
                     cfg=W.PRESETS["test"],
                     decode=tcfg.DecodeConfig(cross_attn=cross, **kw),
                     max_new_tokens=10)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))


@pytest.mark.parametrize("fused", [True, "v2"])
def test_fused_layer_on_quantized_decoder_refused(trees, fused):
    """The JAX package's fused decode path fails on a quantized decoder
    (KeyError 'w'); the port refuses the combination with its reason, at
    the step, in the pipeline and in the config-built engine."""
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        make_default_ingest)
    from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline \
        import WhisperTextPipeline
    cfg, jp, jq, tq = trees
    b = 8
    jckv = JW.cross_kv(jq, jnp.zeros((b, 10, cfg.d_model)), cfg)
    with pytest.raises(KeyError, match="w"):
        JW.decode_step(jq, jnp.zeros((b,), jnp.int32), jnp.int32(0),
                       JW.init_cache(cfg, b, 4, jnp.float32), jckv, cfg,
                       fused_layer=fused)
    tp = W.prepare_params(tq, torch.float32, CPU)
    with pytest.raises(NotImplementedError, match="fused_layer"):
        W.decode_step(tp, torch.zeros(b, dtype=torch.long), 0,
                      W.init_cache(cfg, b, 4, torch.float32, CPU),
                      W.cross_kv(tp, torch.zeros(b, 10, cfg.d_model), cfg),
                      cfg, fused_layer=fused)
    with pytest.raises(NotImplementedError, match="quantize_decoder"):
        WhisperTextPipeline(params=tq, cfg=cfg, device="cpu",
                            decode=tcfg.DecodeConfig(fused_layer=fused))
    spec = tcfg.ModelSpec(family="whisper", preset="test",
                          quantize_decoder=True)
    ecfg = tcfg.EngineConfig().replace(
        asr_model=spec, caption_model=spec,
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        asr_decode=tcfg.DecodeConfig(fused_layer=fused))
    with pytest.raises(NotImplementedError, match="quantize_decoder"):
        make_default_ingest(ecfg, device="cpu")
