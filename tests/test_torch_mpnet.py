"""The port's MPNet encoder (all-mpnet-base-v2) against the JAX package's
and HF's MPNetModel, on the CPU at float32 and the same weights (one
random-init HF state dict converted on both sides, or the JAX init
carried by weights.py): the relative-position buckets integer for
integer up to T=514, encode_tokens / sentence_embed with padded rows,
the converter's trees, the TextEmbedder over mpnet."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.models import mpnet as JM
from multimodal_audio_search_tpu.models.convert import (
    convert_mpnet as j_convert_mpnet)
from multimodal_audio_search_tpu.pipelines.embed import (
    TextEmbedder as JEmbedder)
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import mpnet as M
from multimodal_audio_search_tpu_torch.models.convert import (
    convert_mpnet, mpnet_config_from_hf)
from multimodal_audio_search_tpu_torch.pipelines.embed import TextEmbedder

torch.set_num_threads(1)
SMALL = dict(vocab_size=211, hidden_size=48, num_hidden_layers=3,
             num_attention_heads=4, intermediate_size=96,
             max_position_embeddings=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _hf(kwargs, seed=0):
    from transformers import MPNetConfig, MPNetModel
    hf_cfg = MPNetConfig(attention_probs_dropout_prob=0.0,
                         hidden_dropout_prob=0.0, **kwargs)
    torch.manual_seed(seed)
    return MPNetModel(hf_cfg).eval(), hf_cfg


@pytest.fixture(scope="module")
def small():
    model, hf_cfg = _hf(SMALL)
    cfg = mpnet_config_from_hf(hf_cfg)
    sd = model.state_dict()
    return model, cfg, convert_mpnet(sd, cfg), j_convert_mpnet(
        sd, JM.MPNetConfig(**cfg.__dict__))


def _inputs(rng, cfg, b, t, lengths):
    """Ids that avoid the pad id in content positions (it drives the
    position ids), the pad id at masked positions."""
    ids = rng.integers(cfg.pad_token_id + 1, cfg.vocab_size, size=(b, t))
    mask = np.ones((b, t), np.int64)
    for row, n in enumerate(lengths):
        mask[row, n:] = 0
    ids[mask == 0] = cfg.pad_token_id
    return ids, mask


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (16, 40)])
def test_buckets_equal_jax_and_hf(buckets, max_distance):
    """Every distance of a 514-token input (|rel| <= 513) lands in the
    same bucket in the port, JAX and HF, including 0 (where log(0) is
    cast before the where) and the truncating casts near each bucket's
    edge."""
    from transformers.models.mpnet.modeling_mpnet import MPNetEncoder
    t = 514
    rel = torch.arange(t)[None, :] - torch.arange(t)[:, None]
    hf = MPNetEncoder.relative_position_bucket(
        rel, num_buckets=buckets, max_distance=max_distance).numpy()
    got = M._relative_position_bucket(rel, buckets, max_distance).numpy()
    jx = np.asarray(JM._relative_position_bucket(
        jnp.asarray(rel.numpy(), jnp.int32), buckets, max_distance))
    np.testing.assert_array_equal(got, hf)
    np.testing.assert_array_equal(got, jx)
    np.testing.assert_array_equal(
        M._bucket_table(t, buckets, max_distance).numpy(), hf)
    # every bucket is reached but the one of "-0" (buckets // 2)
    assert set(np.unique(hf)) == set(range(buckets)) - {buckets // 2}


def test_position_ids_and_bias_match_jax(small, rng):
    _, cfg, params, jparams = small
    ids, _ = _inputs(rng, cfg, 3, 17, (17, 9, 4))
    np.testing.assert_array_equal(
        M._position_ids(torch.from_numpy(ids), cfg.pad_token_id).numpy(),
        np.asarray(JM._position_ids(jnp.asarray(ids), cfg.pad_token_id)))
    tp = weights.mpnet_params(_np(jparams))
    np.testing.assert_array_equal(
        M.position_bias(tp["rel_bias"], 17, cfg).numpy(),
        np.asarray(JM.position_bias(jparams["rel_bias"], 17,
                                    JM.MPNetConfig(**cfg.__dict__))))


def test_encode_matches_jax_and_hf(small, rng):
    model, cfg, params, jparams = small
    ids, mask = _inputs(rng, cfg, 3, 17, (17, 9, 4))
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids),
                    attention_mask=torch.tensor(mask)).last_hidden_state
    got = M.encode_tokens(weights.mpnet_params(params), torch.tensor(ids),
                          torch.tensor(mask), cfg).numpy()
    jx = np.asarray(JM.encode_tokens(jparams, jnp.asarray(ids),
                                     jnp.asarray(mask),
                                     JM.MPNetConfig(**cfg.__dict__)))
    for b in range(3):
        n = int(mask[b].sum())
        np.testing.assert_allclose(got[b, :n], ref.numpy()[b, :n],
                                   atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(got[b, :n], jx[b, :n], atol=5e-5)


def test_sentence_embed_matches_jax(small, rng):
    _, cfg, params, jparams = small
    ids, mask = _inputs(rng, cfg, 4, 12, (12, 7, 1, 5))
    got = M.sentence_embed(weights.mpnet_params(params), torch.tensor(ids),
                           torch.tensor(mask), cfg).numpy()
    jx = np.asarray(JM.sentence_embed(jparams, jnp.asarray(ids),
                                      jnp.asarray(mask),
                                      JM.MPNetConfig(**cfg.__dict__)))
    np.testing.assert_allclose(got, jx, atol=5e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_convert_mpnet_trees_equal_jax(small):
    """The port's converter (a held copy) gives JAX's tree array for
    array, also from 'mpnet.'- and '0.auto_model.'-prefixed keys."""
    model, cfg, params, jparams = small
    for got in (params, convert_mpnet(
            {f"0.auto_model.{k}": v for k, v in model.state_dict().items()},
            cfg)):
        assert jax.tree.structure(got) == jax.tree.structure(jparams)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_text_embedder_over_mpnet_matches_jax(small, monkeypatch):
    _, cfg, params, jparams = small
    texts = ["music with drums", "someone speaking", "rain"]
    # 32 tokens: the hash tokenizer pads with id 0, so every slot takes a
    # position id (up to max_tokens + 1 < SMALL's 64 positions)
    jemb = JEmbedder(params=jparams, cfg=JM.MPNetConfig(**cfg.__dict__),
                     model=JM, max_tokens=32)
    temb = TextEmbedder(params=weights.mpnet_params(params), cfg=cfg,
                        model=M, device="cpu", max_tokens=32)
    got = temb(texts)
    assert got.shape == (3, cfg.hidden) and temb.dim == cfg.hidden
    np.testing.assert_allclose(got, jemb(texts), atol=5e-5)
    assert temb.stats.model_name == "mpnet-torch"
    # without a cfg, the module's PRESETS["base"] (as in JAX)
    monkeypatch.setitem(M.PRESETS, "base", cfg)
    assert TextEmbedder(model=M, device="cpu").cfg is cfg


def test_init_matches_converted_shapes(small):
    _, cfg, params, _ = small
    mine = M.init_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(np.shape, weights.mpnet_params(params)) == \
        jax.tree.map(lambda a: tuple(a.shape), mine)


def test_mpnet_params_refuse_other_trees(small):
    _, _, params, _ = small
    with pytest.raises(ValueError, match="top-level keys"):
        weights.mpnet_params({"embeddings": params["embeddings"],
                              "blocks": params["blocks"]})
    bad = dict(params, rel_bias=params["rel_bias"].astype(np.int32))
    with pytest.raises(ValueError, match="unexpected int32 leaf"):
        weights.mpnet_params(bad)
    assert weights.mpnet_params(params)["rel_bias"].dtype == torch.float32


def test_base_geometry_matches_hf(rng):
    """all-mpnet-base-v2's geometry (768 wide, 12 layers, vocab 30527,
    514 positions) against HF, with a padded row."""
    model, hf_cfg = _hf(dict(max_position_embeddings=514,
                             layer_norm_eps=1e-5))
    cfg = mpnet_config_from_hf(hf_cfg)
    assert cfg == M.PRESETS["base"]
    ids, mask = _inputs(rng, cfg, 2, 24, (24, 15))
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids),
                    attention_mask=torch.tensor(mask)).last_hidden_state
    got = M.encode_tokens(
        weights.mpnet_params(convert_mpnet(model.state_dict(), cfg)),
        torch.tensor(ids), torch.tensor(mask), cfg).numpy()
    for b in range(2):
        n = int(mask[b].sum())
        np.testing.assert_allclose(got[b, :n], ref.numpy()[b, :n],
                                   atol=5e-5, rtol=1e-4)


def test_engine_loads_mpnet_weights_path(small, tmp_path, monkeypatch):
    """make_default_ingest's mpnet branch: a ModelSpec(family="mpnet")
    with a weights_path converts the checkpoint there (convert_mpnet) in
    both packages; their embedders agree within 5e-5."""
    from multimodal_audio_search_tpu import config as jcfg
    from multimodal_audio_search_tpu.pipelines.ingest import (
        make_default_ingest as j_make)
    from multimodal_audio_search_tpu_torch import config as tcfg
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        make_default_ingest)
    model, cfg, _, _ = small
    torch.save(model.state_dict(), tmp_path / "pytorch_model.bin")
    monkeypatch.setitem(M.PRESETS, "base", cfg)
    monkeypatch.setitem(JM.PRESETS, "base", JM.MPNetConfig(**cfg.__dict__))

    def config(mod):
        return mod.EngineConfig(
            asr_model=mod.ModelSpec(family="whisper", preset="test"),
            caption_model=mod.ModelSpec(family="whisper", preset="test"),
            text_embedder=mod.ModelSpec(family="mpnet", preset="base",
                                        weights_path=str(tmp_path)))
    texts = ["music with drums", "someone speaking clearly"]
    temb = make_default_ingest(config(tcfg), device="cpu").embedder
    jemb = j_make(config(jcfg)).embedder
    assert temb.model is M and temb.dim == cfg.hidden
    temb.max_tokens = jemb.max_tokens = 32
    np.testing.assert_allclose(temb(texts), jemb(texts), atol=5e-5)
    np.testing.assert_array_equal(
        temb.params["rel_bias"].numpy(),
        model.state_dict()["encoder.relative_attention_bias.weight"])
