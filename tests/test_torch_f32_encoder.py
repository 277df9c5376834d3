"""A float32 encoder through K1's route, against the JAX package.

On the card a float32 encode with ``fused_blocks=True`` (a float32
engine's default ``fused_encoder``) launches K1's float32 form
(``csrc/encoder_block_f32.cu``) at every T; here, on the CPU, the same
call runs its plain twin. Held to the JAX package's float32 encode with
``fused_blocks=True``: B1 in Pallas interpret mode at T <= 1024, and at
T > 1024 the JAX package's float32 reroute to the per-head kernel (B9,
interpret mode) with a plain o-projection, which the port leaves behind.
And a small float32 engine with ``fused_encoder=True`` against JAX's
float32 engine with the same setting: segments, texts, embeddings and
top-10.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.ops import attention as JA
from multimodal_audio_search_tpu.ops import encoder_block as JEB
from multimodal_audio_search_tpu_torch import runtime, weights
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
from test_torch_slice import _check_engine_parity, _make_engines

TOL = 5e-5   # the model bar of the encode tests


def _spy(monkeypatch, mod, name, calls):
    fn = getattr(mod, name)

    def spy(*a, **k):
        calls.append(name)
        return fn(*a, **k)
    monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("t", [100, 1100])
def test_float32_fused_blocks_encode_matches_jax(monkeypatch, t):
    """Port encode(fused_blocks=True) on float32 CPU tensors against JAX
    encode(fused_blocks=True) at float32 within 5e-5, at the test preset
    widened to ``t`` positions: T = 100 (JAX's B1) and T = 1100 (JAX's
    reroute to B9 + a plain o-projection). The port takes K1's route at
    both, once a layer."""
    cfg = JW.config_for("test", enc_positions=t)
    jp = JW.init_params(jax.random.PRNGKey(0), cfg)
    tp = W.prepare_params(weights.whisper_params(
        jax.tree.map(np.asarray, jp)), torch.float32, torch.device("cpu"))
    monkeypatch.setattr(JA, "fused_encoder_attention", functools.partial(
        JA.fused_encoder_attention, interpret=True))
    jcalls, tcalls = [], []
    _spy(monkeypatch, JA, "fused_encoder_attention", jcalls)
    _spy(monkeypatch, JEB, "fused_attention_o_residual", jcalls)
    _spy(monkeypatch, EB, "attention_o_residual_plain", tcalls)
    mel = np.random.default_rng(t).normal(size=(2, 80, 2 * t)).astype(
        np.float32)
    ref = np.asarray(JW.encode(jp, jnp.asarray(mel), cfg, fused_blocks=True))
    got = W.encode(tp, torch.from_numpy(mel), W.config_for(
        "test", enc_positions=t), fused_blocks=True)
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (2, t, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
    jax_kernel = ("fused_encoder_attention" if t > 1024
                  else "fused_attention_o_residual")
    assert jcalls == [jax_kernel] * cfg.enc_layers
    assert tcalls == ["attention_o_residual_plain"] * cfg.enc_layers


def test_float32_engine_fused_encoder_matches_jax(rng, tmp_path):
    """A float32 engine with fused_encoder=True in both packages (the
    port's K1 twin, JAX's B1 in interpret mode): the same segments,
    texts, embeddings and top-10; no kernel launched on the CPU (the
    counts start at 0: a test before this one in the process may have
    counted through a fake)."""
    runtime.reset_counts()
    jeng, teng = _make_engines(fused_encoder=True)
    for pipe in (teng.ingest_pipeline.asr, teng.ingest_pipeline.caption):
        assert pipe.fused_encoder_resolved is True
        assert pipe.dtype == torch.float32
    _check_engine_parity(jeng, teng, rng, tmp_path)
