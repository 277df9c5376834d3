"""The port's HTSAT-Swin + RoBERTa CLAP towers against the JAX package's
and HF's, on the CPU at float32 and the same weights: a random-init HF
ClapAudioModelWithProjection / ClapModel (every float re-randomized, so
the relative-position tables and batch-norm statistics are exercised,
tests/test_clap_htsat.py::_randomize) converted on both sides.

Geometries: TINY_AUDIO (spec 64, window 4), a padded one (grid 12 in
windows of 5, then 6), one whose second stage the window covers (grid 6
at window 6: no shift), laion's defaults, and the fused
(enable_fusion) tower with mixed is_longer rows; HF cannot run a window
shrunk below its configured size (its bias table keeps the configured
window), so that geometry is held to JAX alone. Tolerance 3e-5 (the JAX
tests' own), 5e-5 at laion's defaults."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from multimodal_audio_search_tpu.models import clap_htsat as JCH
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import clap_htsat as CH
from tests.test_clap_htsat import TINY_AUDIO, TINY_TEXT, _randomize

torch.set_num_threads(1)
GEOMETRIES = {
    "tiny": (TINY_AUDIO, 200),
    "pad": (dict(TINY_AUDIO, spec_size=48, patch_embeds_hidden_size=8,
                 depths=[2, 2], num_attention_heads=[2, 2], window_size=5,
                 hidden_size=16), 100),
    "cover": (dict(TINY_AUDIO, spec_size=48, patch_embeds_hidden_size=8,
                   depths=[2, 2], num_attention_heads=[2, 2], window_size=6,
                   hidden_size=16), 100),
    "fused": (dict(TINY_AUDIO, enable_fusion=True), 200),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _audio(kw, seed=2):
    cfg_hf = transformers.ClapAudioConfig(**kw)
    model = _randomize(transformers.ClapAudioModelWithProjection(cfg_hf),
                       seed=seed)
    cfg = CH.htsat_config_from_hf(cfg_hf)
    return model, cfg, CH.convert_clap_audio(model.state_dict(), cfg)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("n_in,n_out", [(50, 128), (200, 256), (100, 144),
                                        (1001, 1024), (16, 64)])
def test_bicubic_matrix_bit_equal(n_in, n_out):
    got = CH.bicubic_matrix(n_in, n_out)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, JCH.bicubic_matrix(n_in, n_out))


@pytest.mark.parametrize("geom", ["tiny", "pad", "default"])
def test_reshape_mel2img_and_window_helpers(rng, geom):
    """The mel image, the window partition / reverse (bit-equal: pure
    data movement), the relative-position index and the shift masks."""
    cfg = CH.HTSATConfig() if geom == "default" else \
        CH.htsat_config_from_hf(transformers.ClapAudioConfig(
            **GEOMETRIES[geom][0]))
    t = 1001 if geom == "default" else GEOMETRIES[geom][1]
    x = rng.normal(size=(2, 1, t, cfg.num_mel_bins)).astype(np.float32)
    img = CH.reshape_mel2img(torch.from_numpy(x), cfg).numpy()
    assert img.shape == (2, 1, cfg.spec_size, cfg.spec_size)
    np.testing.assert_allclose(
        img, np.asarray(JCH.reshape_mel2img(jnp.asarray(x), cfg)),
        atol=1e-5)
    ws = cfg.window_size
    g = cfg.grid_size[0]
    hp = -(-g // ws) * ws
    y = rng.normal(size=(2, hp, hp, 8)).astype(np.float32)
    win = CH._window_partition(torch.from_numpy(y), ws)
    np.testing.assert_array_equal(
        win.numpy(), np.asarray(JCH._window_partition(jnp.asarray(y), ws)))
    np.testing.assert_array_equal(
        CH._window_reverse(win, ws, hp, hp).numpy(), y)
    np.testing.assert_array_equal(CH._relative_position_index(ws),
                                  JCH._relative_position_index(ws))
    np.testing.assert_array_equal(CH._shift_mask(hp, hp, ws, ws // 2),
                                  JCH._shift_mask(hp, hp, ws, ws // 2))
    # torch.roll and jnp.roll move the map the same way
    np.testing.assert_array_equal(
        torch.roll(torch.from_numpy(y), (-2, -2), dims=(1, 2)).numpy(),
        np.asarray(jnp.roll(jnp.asarray(y), (-2, -2), axis=(1, 2))))


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_audio_tower_matches_jax_and_hf(rng, geom):
    kw, t = GEOMETRIES[geom]
    model, cfg, params = _audio(kw)
    c = 4 if cfg.enable_fusion else 1
    feats = rng.normal(size=(3, c, t, cfg.num_mel_bins)).astype(np.float32)
    longer = np.array([True, False, True]) if cfg.enable_fusion else None
    with torch.inference_mode():
        extra = {} if longer is None else {
            "is_longer": torch.from_numpy(longer[:, None])}
        want = _unit(model(torch.from_numpy(feats),
                           **extra).audio_embeds.numpy())
        got = CH.audio_embed(weights.htsat_params(params),
                             torch.from_numpy(feats), cfg,
                             is_longer=longer).numpy()
    jx = np.asarray(jax.jit(JCH.audio_embed, static_argnums=2)(
        params, jnp.asarray(feats), cfg,
        None if longer is None else jnp.asarray(longer)))
    np.testing.assert_allclose(got, want, atol=3e-5)
    np.testing.assert_allclose(got, jx, atol=3e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_window_shrink_matches_jax(rng):
    """A map smaller than the window (stage 2 at 6x6, stage 3 at 3x3 under
    window 8) shrinks the window with no shift, on JAX's init; the first
    stage pads 12 to 16."""
    cfg = CH.HTSATConfig(num_mel_bins=16, spec_size=48, patch_embed_dim=8,
                         depths=(2, 2, 2), num_heads=(2, 2, 4),
                         window_size=8, hidden_size=32, projection_dim=24)
    jp = JCH.init_audio_params(jax.random.PRNGKey(5), cfg)
    # randomize the zero-initialized tables and statistics as well
    leaves, tree = jax.tree.flatten(jp)
    keys = jax.random.split(jax.random.PRNGKey(6), len(leaves))
    jp = jax.tree.unflatten(tree, [
        jax.random.uniform(k, a.shape) + 0.5 if a.ndim == 1 else
        a + jax.random.normal(k, a.shape) * 0.05
        for k, a in zip(keys, leaves)])
    feats = rng.normal(size=(2, 1, 100, 16)).astype(np.float32)
    got = CH.audio_embed(weights.htsat_params(_np(jp)),
                         torch.from_numpy(feats), cfg).numpy()
    jx = jax.jit(JCH.audio_embed, static_argnums=2)(jp, jnp.asarray(feats),
                                                    cfg)
    np.testing.assert_allclose(got, np.asarray(jx), atol=3e-5)


def test_default_geometry_matches_jax(rng):
    """laion's defaults (64 mels, spec 256, depths 2/2/6/2, heads
    4/8/16/32, window 8: the last stage's 8x8 map is one window) on a
    10 s mel, JAX's init carried over."""
    cfg = CH.HTSATConfig()
    jp = JCH.init_audio_params(jax.random.PRNGKey(2), cfg)
    feats = rng.normal(size=(1, 1, 1001, 64)).astype(np.float32)
    got = CH.audio_embed(weights.htsat_params(_np(jp)),
                         torch.from_numpy(feats), cfg).numpy()
    assert got.shape == (1, 512)
    jx = jax.jit(JCH.audio_embed, static_argnums=2)(jp, jnp.asarray(feats),
                                                    cfg)
    np.testing.assert_allclose(got, np.asarray(jx), atol=5e-5)


def _text_model(seed=4):
    full = transformers.ClapConfig(text_config=TINY_TEXT,
                                   audio_config=TINY_AUDIO,
                                   projection_dim=24)
    return full, _randomize(transformers.ClapModel(full), seed=seed)


def test_text_tower_matches_jax_and_hf(rng):
    full, model = _text_model()
    cfg = CH.roberta_config_from_hf(transformers.ClapTextConfig(**TINY_TEXT))
    params = CH.convert_clap_text(model.state_dict(), cfg)
    ids = rng.integers(2, 120, size=(3, 12)).astype(np.int64)
    mask = np.ones((3, 12), np.int64)
    for row, n in ((1, 8), (2, 5)):
        mask[row, n:] = 0
        ids[row, n:] = 1                              # the pad token
    with torch.inference_mode():
        want = model.get_text_features(torch.from_numpy(ids),
                                       torch.from_numpy(mask)).numpy()
        got = CH.text_embed(weights.roberta_params(params),
                            torch.from_numpy(ids), torch.from_numpy(mask),
                            cfg).numpy()
    jx = np.asarray(JCH.text_embed(params, jnp.asarray(ids),
                                   jnp.asarray(mask), cfg))
    np.testing.assert_allclose(got, want, atol=3e-5)
    np.testing.assert_allclose(got, jx, atol=3e-5)
    np.testing.assert_array_equal(
        CH.roberta_positions(torch.from_numpy(ids), torch.from_numpy(mask),
                             1).numpy(),
        np.asarray(JCH.roberta_positions(jnp.asarray(ids), jnp.asarray(mask),
                                         1)))


@pytest.mark.parametrize("geom", ["tiny", "fused"])
def test_converter_trees_equal_jax(geom):
    """The converters (held copies) give JAX's trees array for array; the
    carried trees keep every leaf float32, BN statistics and bias tables
    included, and None for the last stage's downsampling; the port's
    random init has the converted shapes."""
    model, cfg, params = _audio(GEOMETRIES[geom][0])
    sd = model.state_dict()
    jtree = JCH.convert_clap_audio(sd, cfg)
    assert jax.tree.structure(params) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    tp = weights.htsat_params(params)
    assert tp["stages"][-1]["downsample"] is None
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(tp))
    mine = CH.init_audio_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == \
        jax.tree.map(lambda a: tuple(a.shape), mine)
    full, tmodel = _text_model(seed=9)
    tcfg = CH.roberta_config_from_hf(transformers.ClapTextConfig(**TINY_TEXT))
    text = CH.convert_clap_text(tmodel.state_dict(), tcfg)
    for a, b in zip(jax.tree.leaves(text), jax.tree.leaves(
            JCH.convert_clap_text(tmodel.state_dict(), tcfg))):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.map(lambda a: tuple(a.shape),
                        weights.roberta_params(text)) == jax.tree.map(
        lambda a: tuple(a.shape),
        CH.init_text_params(torch.Generator().manual_seed(1), tcfg))


def test_weights_refuse_foreign_clap_trees():
    _, cfg, params = _audio(TINY_AUDIO)
    with pytest.raises(ValueError, match="top-level keys"):
        weights.roberta_params(params)
    bad = dict(params, batch_norm=dict(params["batch_norm"],
                                       mean=np.zeros(16, np.int64)))
    with pytest.raises(ValueError, match="unexpected int64 leaf"):
        weights.htsat_params(bad)
    with pytest.raises(ValueError, match="enable_fusion"):
        CH.convert_clap_audio(
            {"audio_model.audio_encoder.patch_embed.mel_conv2d.weight": 0},
            CH.HTSATConfig())


def test_load_from_dir_roundtrip(tmp_path, rng):
    """A tiny ClapModel saved as HF does (config.json + .bin), loaded by
    the port's load_from_dir and carried by weights.py: both towers
    against HF's get_audio_features / get_text_features."""
    full, model = _text_model(seed=15)
    (tmp_path / "config.json").write_text(json.dumps(full.to_dict()))
    torch.save(model.state_dict(), tmp_path / "pytorch_model.bin")
    ap, tp, acfg, tcfg = CH.load_from_dir(str(tmp_path))
    assert acfg.window_size == 4 and tcfg.hidden == 32
    feats = rng.normal(size=(2, 1, 200, 16)).astype(np.float32)
    ids = rng.integers(2, 120, size=(2, 9)).astype(np.int64)
    mask = np.ones_like(ids)
    with torch.inference_mode():
        want_a = model.get_audio_features(torch.from_numpy(feats)).numpy()
        want_t = model.get_text_features(torch.from_numpy(ids),
                                         torch.from_numpy(mask)).numpy()
        got_a = CH.audio_embed(weights.htsat_params(ap),
                               torch.from_numpy(feats), acfg).numpy()
        got_t = CH.text_embed(weights.roberta_params(tp),
                              torch.from_numpy(ids), torch.from_numpy(mask),
                              tcfg).numpy()
    np.testing.assert_allclose(got_a, want_a, atol=3e-5)
    np.testing.assert_allclose(got_t, want_t, atol=3e-5)


def test_towers_are_differentiable(rng):
    """InfoNCE gradients reach every leaf of both towers (the training
    loops of ROADMAP A14 will take them through autograd)."""
    from multimodal_audio_search_tpu_torch.models.clap import (
        contrastive_loss)
    acfg = CH.HTSATConfig(num_mel_bins=16, spec_size=64, patch_embed_dim=16,
                          depths=(2, 2), num_heads=(2, 4), window_size=4,
                          hidden_size=32, projection_dim=24)
    tcfg = CH.RobertaConfig(vocab_size=50, hidden=32, layers=1, heads=2,
                            intermediate=64, max_positions=24,
                            projection_dim=24)
    ap = CH.init_audio_params(torch.Generator().manual_seed(3), acfg)
    tp = CH.init_text_params(torch.Generator().manual_seed(4), tcfg)
    leaves = [x for x in jax.tree.leaves((ap, tp))]
    for x in leaves:
        x.requires_grad_(True)
    feats = torch.from_numpy(
        rng.normal(size=(4, 1, 200, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(2, 50, size=(4, 10)))
    loss = contrastive_loss(CH.audio_embed(ap, feats, acfg),
                            CH.text_embed(tp, ids, torch.ones(4, 10), tcfg))
    loss.backward()
    assert torch.isfinite(loss)
    assert sum(float(x.grad.abs().sum()) for x in leaves
               if x.grad is not None) > 0
