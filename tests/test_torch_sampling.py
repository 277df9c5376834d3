"""Sampling decode of the PyTorch package (``method="sample"``) against
the JAX package on the CPU at float32.

The port draws its Gumbel noise from a ``torch.Generator``
(models/generate.py::_gumbel); these tests replace that function with
one that replays JAX's key chain (``key, sub = split(key)`` a step,
``gumbel(sub)``), so the JAX and the port decode see the same noise:

* ``_select_next`` equals ``jax.random.categorical`` on the same noise at
  temperatures 1e-4, 0.2, 1 and 2;
* ``generate(method="sample")``: tokens and lengths identical to JAX's
  ``generate(rng=PRNGKey(s))`` for 3 seeds, with the ASR and the caption
  processors, unfused at B=3 and with ``fused_layer`` True / "v2" at B=8;
  ``with_scores`` within 1e-4;
* on the port's own generator: temperature 1e-4 is greedy, a seed
  reproduces, two seeds at temperature 2 differ, the noise is Gumbel;
* the pipeline seeds a dispatch's generator with its number (1, 2, ...), as
  JAX keys it with ``PRNGKey(self._step)``, and a sampled-ASR engine
  gives the JAX engine's texts under the replayed noise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.models import generate as JG
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import generate as G
from multimodal_audio_search_tpu_torch.models import whisper as W

torch.set_num_threads(1)
CPU = torch.device("cpu")
SCORE_ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class JaxNoise:
    """A stand-in for ``generate._gumbel`` that replays JAX's key chain:
    a new generator starts the chain at ``PRNGKey(gen.initial_seed())``,
    and each draw splits the key as JAX's decode loop does."""

    def __init__(self):
        self.gen, self.key, self.draws = None, None, 0

    def __call__(self, gen, shape, device):
        if gen is not self.gen:
            self.gen, self.key = gen, jax.random.PRNGKey(gen.initial_seed())
        self.key, sub = jax.random.split(self.key)
        self.draws += 1
        return torch.from_numpy(np.array(jax.random.gumbel(
            sub, tuple(shape), jnp.float32))).to(device)


@pytest.mark.parametrize("t", [1e-4, 0.2, 1.0, 2.0])
def test_select_next_is_jax_categorical(rng, t):
    logits = (rng.normal(size=(16, 300)) * 3).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = jax.random.categorical(key, jnp.asarray(logits) / max(t, 1e-6),
                                     axis=-1)
        noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = G._select_next(torch.from_numpy(logits), "sample", t,
                             torch.from_numpy(noise))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(G._select_next(torch.from_numpy(logits), "greedy", t,
                                      None),
                       torch.from_numpy(logits).argmax(-1))


def _run_both(monkeypatch, b, seed, kw, enc_seed=0, with_scores=False):
    cfg = JW.PRESETS["test"]
    jp = JW.init_params(jax.random.PRNGKey(11), cfg)
    tp = W.prepare_params(weights.whisper_params(_np(jp)), torch.float32,
                          CPU)
    enc = np.random.default_rng(enc_seed).normal(
        size=(b, 100, cfg.d_model)).astype(np.float32)
    prefix = np.tile(np.asarray(JW.forced_prefix(cfg), np.int32), (b, 1))
    ref = JG.generate(jp, jnp.asarray(enc), jnp.asarray(prefix), cfg=cfg,
                      decode=jcfg.DecodeConfig(method="sample", **kw),
                      prefix_len=4, max_new_tokens=10,
                      rng=jax.random.PRNGKey(seed), with_scores=with_scores)
    noise = JaxNoise()
    monkeypatch.setattr(G, "_gumbel", noise)
    out = G.generate(tp, torch.from_numpy(enc), torch.from_numpy(prefix),
                     cfg=W.PRESETS["test"],
                     decode=tcfg.DecodeConfig(method="sample", **kw),
                     max_new_tokens=10,
                     rng=torch.Generator().manual_seed(seed),
                     with_scores=with_scores)
    assert noise.draws == out.steps        # one draw a step, prefix too
    return ref, out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fused,b", [(False, 3), (True, 8), ("v2", 8)])
@pytest.mark.parametrize("penalty,ngram,t", [(1.05, 2, 0.2), (1.3, 3, 1.0)])
def test_sample_tokens_identical_to_jax(monkeypatch, seed, fused, b,
                                        penalty, ngram, t):
    kw = dict(max_new_tokens=10, temperature=t, repetition_penalty=penalty,
              no_repeat_ngram_size=ngram,
              **({"fused_layer": fused} if fused else {}))
    ref, out = _run_both(monkeypatch, b, seed, kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))


@pytest.mark.parametrize("method", ["sample", "greedy"])
def test_with_scores_matches_jax(monkeypatch, method):
    kw = dict(max_new_tokens=10, temperature=1.0, repetition_penalty=1.3,
              no_repeat_ngram_size=3)
    if method == "greedy":
        cfg = JW.PRESETS["test"]
        jp = JW.init_params(jax.random.PRNGKey(11), cfg)
        tp = W.prepare_params(weights.whisper_params(_np(jp)),
                              torch.float32, CPU)
        enc = np.random.default_rng(1).normal(
            size=(3, 100, cfg.d_model)).astype(np.float32)
        prefix = np.tile(np.asarray(JW.forced_prefix(cfg), np.int32), (3, 1))
        ref = JG.generate(jp, jnp.asarray(enc), jnp.asarray(prefix), cfg=cfg,
                          decode=jcfg.DecodeConfig(**kw), prefix_len=4,
                          max_new_tokens=10, with_scores=True)
        out = G.generate(tp, torch.from_numpy(enc), torch.from_numpy(prefix),
                         cfg=W.PRESETS["test"],
                         decode=tcfg.DecodeConfig(**kw), max_new_tokens=10,
                         with_scores=True)
    else:
        ref, out = _run_both(monkeypatch, 3, 5, kw, enc_seed=1,
                             with_scores=True)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert (out.scores < 0).all()
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               atol=SCORE_ATOL, rtol=0)


def test_scores_zero_without_with_scores(rng):
    cfg = W.PRESETS["test"]
    tp = W.prepare_params(W.init_params(torch.Generator().manual_seed(0),
                                        cfg), torch.float32, CPU)
    out = G.generate(tp, torch.from_numpy(rng.normal(
        size=(2, 100, cfg.d_model)).astype(np.float32)),
        torch.full((2, 1), cfg.bos_token_id), cfg=cfg,
        decode=tcfg.DecodeConfig(method="sample"), max_new_tokens=4)
    assert torch.equal(out.scores, torch.zeros(2))


@pytest.fixture(scope="module")
def toy():
    cfg = W.PRESETS["test"]
    jp = JW.init_params(jax.random.PRNGKey(12), JW.PRESETS["test"])
    tp = W.prepare_params(weights.whisper_params(_np(jp)), torch.float32,
                          CPU)
    enc = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 100, cfg.d_model)).astype(np.float32))
    prefix = torch.tensor([W.forced_prefix(cfg)] * 4)
    return cfg, tp, enc, prefix


def _sample(toy, t, seed, **kw):
    cfg, tp, enc, prefix = toy
    return G.generate(tp, enc, prefix, cfg=cfg, decode=tcfg.DecodeConfig(
        method="sample", temperature=t, **kw), max_new_tokens=12,
        rng=None if seed is None else torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("penalty,ngram", [(1.0, 0), (1.05, 2)])
def test_cold_sampling_is_greedy(toy, penalty, ngram):
    cfg, tp, enc, prefix = toy
    g = G.generate(tp, enc, prefix, cfg=cfg, decode=tcfg.DecodeConfig(
        repetition_penalty=penalty, no_repeat_ngram_size=ngram),
        max_new_tokens=12)
    for seed in (0, 1):
        s = _sample(toy, 1e-4, seed, repetition_penalty=penalty,
                    no_repeat_ngram_size=ngram)
        assert torch.equal(s.tokens, g.tokens)
        assert torch.equal(s.lengths, g.lengths)


def test_seed_reproduces_and_seeds_differ(toy):
    a, b = _sample(toy, 2.0, 7), _sample(toy, 2.0, 7)
    assert torch.equal(a.tokens, b.tokens) and a.steps == b.steps
    c = _sample(toy, 2.0, 8)
    assert not torch.equal(a.tokens, c.tokens)
    # rng=None is a generator seeded with 0 (JAX's PRNGKey(0) default)
    assert torch.equal(_sample(toy, 2.0, None).tokens,
                       _sample(toy, 2.0, 0).tokens)


def test_gumbel_noise_statistics():
    """Mean Euler's gamma (0.5772), standard deviation pi / sqrt(6)
    (1.2825), finite: 2e5 draws, 4 standard errors."""
    x = G._gumbel(torch.Generator().manual_seed(0), (400, 500), CPU)
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    se = 1.2825 / np.sqrt(x.numel())
    assert abs(float(x.mean()) - 0.5772157) < 4 * se
    assert abs(float(x.std()) - np.pi / np.sqrt(6)) < 0.01


def test_pipeline_seeds_each_dispatch(monkeypatch, rng):
    """WhisperTextPipeline: a "sample" dispatch seeds its generator with
    the dispatch's number (1, 2, ...), as the JAX pipeline keys its decode
    with PRNGKey(self._step)."""
    from multimodal_audio_search_tpu_torch.pipelines import (
        whisper_pipeline as WP)
    seeds = []
    real = WP.generate
    monkeypatch.setattr(WP, "generate", lambda *a, rng=None, **k: (
        seeds.append(rng.initial_seed()), real(*a, rng=rng, **k))[1])
    pipe = WP.WhisperTextPipeline(
        cfg=W.PRESETS["test"], device="cpu",
        decode=tcfg.DecodeConfig(method="sample", max_new_tokens=3),
        mel_cfg=tcfg.MelConfig(padded_seconds=2.0))
    waves = rng.normal(size=(2, 32000)).astype(np.float32) * 0.1
    pipe.transcribe_batch(waves)
    pipe.transcribe_batch(waves)
    assert seeds == [1, 2]


def test_sampled_asr_engine_matches_jax(monkeypatch, rng, tmp_path):
    """A JAX and a port engine on the same toy weights, the ASR decode
    ``asr_parity_decode()`` with method="sample" (temperature 0.2,
    penalty 1.05, n-gram 2): with the JAX key chain replayed into the
    port's noise, the same segments, ASR texts and top-10."""
    import test_torch_slice as S
    monkeypatch.setattr(G, "_gumbel", JaxNoise())
    asr_dec = dict(method="sample", temperature=0.2,
                   repetition_penalty=1.05, no_repeat_ngram_size=2)
    jeng, teng = S._make_engines()
    for eng, mod in ((jeng, jcfg), (teng, tcfg)):
        asr = eng.ingest_pipeline.asr
        asr.decode = dataclasses.replace(asr.decode, **asr_dec)
    # the JAX pipeline closed its jitted programs over its decode config
    jasr = jeng.ingest_pipeline.asr
    jeng.ingest_pipeline.asr = type(jasr)(
        params=jasr.params, cfg=jasr.cfg, decode=jasr.decode,
        mel_cfg=jasr.mel_cfg, dtype=jnp.float32, name="asr")
    S._check_engine_parity(jeng, teng, rng, tmp_path)
