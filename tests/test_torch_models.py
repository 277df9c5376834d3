"""The PyTorch package's models held to the JAX package's on the same
weights (weights.py brings the JAX param tree over as numpy arrays).

Float32 on the CPU at toy widths: Whisper's "test" preset, a 2-layer
MiniLM. Tolerances: 5e-5 absolute on encoder states and decode-step
logits (the JAX package's own bar for logits, docs/PARITY.md), 2e-5 on
layer outputs and sentence embeddings, 1e-3 on log-mel features (the
float32 DFT's summation order differs; see ops/mel.py's contract).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.config import MelConfig as JMelConfig
from multimodal_audio_search_tpu.models import layers as JL
from multimodal_audio_search_tpu.models import minilm as JM
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.ops.mel import (
    log_mel_spectrogram as jax_log_mel)
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.config import MelConfig
from multimodal_audio_search_tpu_torch.models import layers as L
from multimodal_audio_search_tpu_torch.models import minilm as M
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def whisper_pair():
    cfg = JW.PRESETS["test"]
    jp = JW.init_params(jax.random.PRNGKey(0), cfg)
    tp = W.prepare_params(weights.whisper_params(_np_tree(jp)),
                          torch.float32, CPU)
    return cfg, jp, tp


def test_layers_match(rng):
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    jd = JL.init_dense(jax.random.PRNGKey(1), 16, 8)
    td = weights.tree_to_torch(_np_tree(jd))
    ln = {"scale": rng.normal(size=16).astype(np.float32),
          "bias": rng.normal(size=16).astype(np.float32)}
    tln = weights.tree_to_torch(ln)
    tx = torch.from_numpy(x)
    for got, ref in (
            (L.dense(td, tx), JL.dense(jd, jnp.asarray(x))),
            (L.layer_norm(tln, tx), JL.layer_norm(ln, jnp.asarray(x))),
            (L.gelu(tx), JL.gelu(jnp.asarray(x)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=2e-5)


def test_log_mel_matches(rng):
    cfg = MelConfig(padded_seconds=2.0)
    wave = np.zeros((2, cfg.n_samples), np.float32)
    wave[:, :20000] = rng.normal(size=(2, 20000)) * 0.3
    got = log_mel_spectrogram(torch.from_numpy(wave), cfg)
    ref = jax_log_mel(jnp.asarray(wave), JMelConfig(padded_seconds=2.0))
    assert got.shape == (2, 80, 200)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("fused", [True, False])
def test_encoder_matches(whisper_pair, rng, fused):
    """Port encode (K1 route -> plain twin on CPU, or plain mha) vs the
    JAX einsum encoder and the JAX block kernel in interpret mode."""
    cfg, jp, tp = whisper_pair
    mel = rng.normal(size=(2, 80, 200)).astype(np.float32)
    got = W.encode(tp, torch.from_numpy(mel), cfg, fused_blocks=fused)
    ref = JW.encode(jp, jnp.asarray(mel), cfg, fused_blocks=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5)
    if fused:
        ref_k = JW.encode(jp, jnp.asarray(mel), cfg, fused_blocks=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_k),
                                   atol=5e-5)


@pytest.mark.parametrize("cross", ["merged", "einsum"])
def test_decode_step_logits_match(whisper_pair, rng, cross):
    """Six cached decode steps on the same tokens: logits within 5e-5.
    'merged' is the K2 route (merged-head cross K/V), 'einsum' the plain
    [B, H, T, D] route; JAX runs its einsum cross path and its einsum
    twin of the self-attention kernel."""
    cfg, jp, tp = whisper_pair
    enc = rng.normal(size=(2, 100, cfg.d_model)).astype(np.float32)
    jckv = JW.cross_kv(jp, jnp.asarray(enc), cfg)
    tenc = torch.from_numpy(enc)
    tckv = (W.cross_kv_merged if cross == "merged" else W.cross_kv)(
        tp, tenc, cfg)
    jcache = JW.init_cache(cfg, 2, 8, jnp.float32)
    tcache = W.init_cache(cfg, 2, 8, torch.float32, CPU)
    toks = rng.integers(0, cfg.vocab_size, size=(6, 2))
    for pos in range(6):
        jl, jcache = JW.decode_step(jp, jnp.asarray(toks[pos], jnp.int32),
                                    jnp.int32(pos), jcache, jckv, cfg)
        tl = W.decode_step(tp, torch.from_numpy(toks[pos]).long(), pos,
                           tcache, tckv, cfg)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5)
    np.testing.assert_allclose(tcache[1]["k"].numpy(),
                               np.asarray(jcache[1]["k"]), atol=5e-5)


def test_forced_prefix_and_presets():
    for name in ("tiny", "base", "small", "base.en", "test"):
        assert W.PRESETS[name].__dict__ == JW.PRESETS[name].__dict__
        assert W.forced_prefix(W.PRESETS[name]) == \
            JW.forced_prefix(JW.PRESETS[name])
    assert W.forced_prefix(W.PRESETS["base"], task="translate") == \
        JW.forced_prefix(JW.PRESETS["base"], task="translate")


def test_minilm_matches(rng):
    jcfg = JM.PRESETS["test"]
    jp = JM.init_params(jax.random.PRNGKey(3), jcfg)
    tp = weights.minilm_params(_np_tree(jp))
    ids = rng.integers(0, jcfg.vocab_size, size=(3, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    ref = JM.sentence_embed(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    got = M.sentence_embed(tp, torch.from_numpy(ids).long(),
                           torch.from_numpy(mask), M.PRESETS["test"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_weights_reject_foreign_trees():
    with pytest.raises(ValueError):
        weights.whisper_params({"embeddings": {}, "blocks": []})
    with pytest.raises(NotImplementedError):
        weights.minilm_params({"embeddings": {"x": {"wq": np.zeros(2)}},
                               "blocks": []})


def test_random_init_is_seeded():
    cfg = W.PRESETS["test"]
    a = W.init_params(torch.Generator().manual_seed(5), cfg)
    b = W.init_params(torch.Generator().manual_seed(5), cfg)
    torch.testing.assert_close(a["decoder"]["embed_tokens"],
                               b["decoder"]["embed_tokens"])
    assert tuple(a["encoder"]["conv1"]["w"].shape) == (3, 80, 64)
