"""The mesh's model axis (Megatron tensor parallelism), kernel by kernel
and model by model, the port against the JAX package on the CPU.

* K1's partial form (K1p, its plain twin here) rank by rank against the
  JAX encoder kernel under shard_map in interpret mode, each device its
  H/mp heads and the matching row shard of Wo (whisper-base geometry on
  the (4, 2) mesh, as tests/test_production_geometry_mesh.py runs it);
  the ranks summed by model_sum against the psum, within 2e-4;
* K3's and K4's partial twins summed over 2 and 4 ranks through
  model_sum against the JAX fused_self_block / fused_mlp_block in
  interpret mode within 5e-5 at float32 (B 8 / 33, H 4 / 6 / 8, pos 0 /
  1 / L-1), each rank's cache row against the JAX k1 / v1 columns;
* K2 on head shards (H/mp = 3 and 4) against the JAX kernel;
* shard_heads: every split leaf = JAX's addressable shard of it, the
  biases of q/k/v and mlp_in split with their columns;
* the MiniLM and MPNet TP forwards against the JAX embedders over a
  (4, 2) mesh (use_mesh), within 2e-5;
* the Whisper TP forms (encode_tp, decode_step_tp, generate_tp) against
  the one-device functions.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.models import minilm as JMini
from multimodal_audio_search_tpu.models import mpnet as JMp
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.ops import cross_attention as JCA
from multimodal_audio_search_tpu.ops import decoder_block as JDB
from multimodal_audio_search_tpu.ops import encoder_block as JEB
from multimodal_audio_search_tpu.parallel import mesh as jmesh
from multimodal_audio_search_tpu.pipelines.embed import (
    TextEmbedder as JEmbedder)
from multimodal_audio_search_tpu_torch import runtime, weights
from multimodal_audio_search_tpu_torch.config import DecodeConfig
from multimodal_audio_search_tpu_torch.models import generate as G
from multimodal_audio_search_tpu_torch.models import minilm as Mini
from multimodal_audio_search_tpu_torch.models import mpnet as Mp
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.ops import cross_attention as CA
from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
from multimodal_audio_search_tpu_torch.parallel import mesh as M
from multimodal_audio_search_tpu_torch.pipelines.embed import TextEmbedder
from multimodal_audio_search_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)
L = 12
SMALL_MPNET = dict(vocab_size=512, hidden=32, layers=2, heads=4,
                   intermediate=128, max_positions=80)
SMALL_MINILM = dict(vocab_size=512, hidden=64, layers=2, heads=4,
                    intermediate=128)
TEXTS = ["music with drums", "someone speaking", "rain on a roof",
         "a dog barks twice"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _heads(a: torch.Tensor, j: int, mp: int, axis: int) -> torch.Tensor:
    return torch.chunk(a, mp, axis)[j].contiguous()


# --------------------------------------------------------------- K1p
@pytest.fixture(scope="module")
def k1_case():
    """Whisper-base geometry (H=8, D=64, H*D=512) at T=96, B=4; the JAX
    kernel under shard_map on the (4, 2) mesh: each device's partial
    (x = 0, bo = 0 on its H/2 heads and Wo rows) and the psum of
    x/mp + partial + bo/mp."""
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(18)
    b, h, t, d = 4, 8, 96, 64
    hd = h * d
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    x = rng.normal(size=(b, t, hd)).astype(np.float32)
    wo = (rng.normal(size=(hd, hd)) / math.sqrt(hd)).astype(np.float32)
    bo = rng.normal(size=(hd,)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    mp = 2

    def parts(q, k, v, wo):
        zero = jnp.zeros((q.shape[0], q.shape[2], wo.shape[1]), q.dtype)
        part = JEB.fused_attention_o_residual(
            q, k, v, zero, wo, jnp.zeros(wo.shape[1], q.dtype), blk_q=32,
            interpret=True)
        return part[None]

    def summed(q, k, v, x, wo, bo):
        part = JEB.fused_attention_o_residual(q, k, v, x / mp, wo, bo / mp,
                                              blk_q=32, interpret=True)
        return jax.lax.psum(part, "model")

    spec_h = P("data", "model")
    jparts = jax.jit(jax.shard_map(
        parts, mesh=mesh, in_specs=(spec_h, spec_h, spec_h, P("model", None)),
        out_specs=P("model", "data"), check_vma=False))(q, k, v, wo)
    jsum = jax.jit(jax.shard_map(
        summed, mesh=mesh,
        in_specs=(spec_h, spec_h, spec_h, P("data", None), P("model", None),
                  P(None)),
        out_specs=P("data", None), check_vma=False))(q, k, v, x, wo, bo)
    return (q, k, v, x, wo, bo), np.asarray(jparts), np.asarray(jsum)


def test_k1_partial_rank_by_rank_matches_jax_shard_map(k1_case):
    (q, k, v, x, wo, bo), jparts, jsum = k1_case
    mp, hl = 2, 4
    tq, tk, tv, tx, two, tbo = map(_t, (q, k, v, x, wo, bo))
    runtime.reset_counts()
    parts = []
    for j in range(mp):
        sl = slice(j * hl, (j + 1) * hl)
        part = EB.fused_attention_o_residual(
            tq[:, sl], tk[:, sl], tv[:, sl], None, _heads(two, j, mp, 0),
            None, partial=True)
        assert part.dtype == torch.float32 and part.shape == tx.shape
        np.testing.assert_allclose(part.numpy(), jparts[j], atol=2e-4,
                                   rtol=2e-4)
        parts.append(part)
    assert sum(runtime.COUNTS.values()) == 0     # the CPU takes the twin
    out = M.model_sum(parts, tbo, tx)
    assert len(out) == mp and out[0] is out[1]   # one device, named twice
    np.testing.assert_allclose(out[0].numpy(), jsum, atol=2e-4, rtol=2e-4)
    # and the square form on the whole layer
    whole = EB.fused_attention_o_residual(tq, tk, tv, tx, two, tbo)
    np.testing.assert_allclose(out[0].numpy(), whole.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_k1_partial_refuses_the_unported_encoders():
    """The int8 and paired bodies' partial forms (K9p, K10p; refused
    before ROADMAP A13c) run on the CPU through their plain twins: a
    rank's float32 partial, Wo non-square, each the twin's value."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 4, 64, generator=g) for _ in range(3))
    wo = torch.randn(128, 192, generator=g)
    runtime.reset_counts()
    got = EB.fused_attention_o_residual(q, k, v, None, wo, None,
                                        partial=True, pair_heads=True)
    assert got.shape == (1, 4, 192) and got.dtype == torch.float32
    assert torch.equal(got, EB.attention_o_residual_paired_plain(
        q, k, v, None, wo, None, partial=True))
    got = EB.fused_attention_o_residual(q, k, v, None, wo, None,
                                        partial=True, qk_int8=True)
    assert torch.equal(got, EB.attention_o_residual_int8_plain(
        q, *EB.quantize_kv(k, v), None, wo, None, partial=True))
    assert sum(runtime.COUNTS.values()) == 0


# ------------------------------------------------------- K3p and K4p
def _block_inputs(rng, b, heads):
    d = heads * 64

    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    w = 1 / np.sqrt(d)
    selfw = [n(d, s=0.2) + 1, n(d, s=0.2), n(d, d, s=w), n(d, s=0.1),
             n(d, d, s=w), n(d, d, s=w), n(d, s=0.1), n(d, d, s=w),
             n(d, s=0.1)]
    f = 2 * d
    mlp = [n(d, s=0.2) + 1, n(d, s=0.2), n(d, f, s=w), n(f, s=0.5),
           n(f, d, s=1 / np.sqrt(f)), n(d, s=0.1)]
    return n(b, d), selfw, mlp, n(b, L, d), n(b, L, d)


def _rows(a, pad):
    return jnp.asarray(np.concatenate([a, np.zeros((pad, *a.shape[1:]),
                                                   a.dtype)]))


@functools.lru_cache(maxsize=None)
def _jax_blocks(b: int, heads: int, pos: int):
    """The inputs and the JAX kernels' outputs in interpret mode (rows
    padded to the kernels' 8-row blocks, cut back to B)."""
    rng = np.random.default_rng(1000 * b + 10 * heads + pos)
    x, selfw, mlp, kc, vc = _block_inputs(rng, b, heads)
    pad = -b % 8
    xo, k1, v1 = JDB.fused_self_block(
        _rows(x, pad), *map(jnp.asarray, selfw), _rows(kc, pad),
        _rows(vc, pad), jnp.int32(pos), heads=heads, interpret=True)
    mo = JDB.fused_mlp_block(_rows(x, pad), *map(jnp.asarray, mlp),
                             interpret=True)
    return (x, selfw, mlp, kc, vc), tuple(
        np.asarray(a)[:b] for a in (xo, k1, v1, mo))


@pytest.mark.parametrize("heads,mp", [(4, 2), (4, 4), (6, 2), (8, 2),
                                      (8, 4)])
@pytest.mark.parametrize("b", [8, 33])
@pytest.mark.parametrize("pos", [0, 1, L - 1])
def test_k3_partial_ranks_summed_match_jax(heads, mp, b, pos):
    (x, selfw, _, kc, vc), (jxo, jk1, jv1, _) = _jax_blocks(b, heads, pos)
    tx = _t(x)
    g1, b1, wq, bq, wk, wv, bv, wo, bo = map(_t, selfw)
    hl = heads // mp
    parts = []
    for j in range(mp):
        kcj, vcj = (_heads(_t(c), j, mp, 2) for c in (kc, vc))
        out, k1, v1 = DB.fused_self_block(
            tx, g1, b1, _heads(wq, j, mp, 1), _heads(bq, j, mp, 0),
            _heads(wk, j, mp, 1), _heads(wv, j, mp, 1), _heads(bv, j, mp, 0),
            _heads(wo, j, mp, 0), None, kcj, vcj, pos, heads=hl,
            partial=True)
        assert out.dtype == torch.float32 and out.shape == tx.shape
        cols = slice(j * hl * 64, (j + 1) * hl * 64)
        np.testing.assert_allclose(k1.numpy(), jk1[:, cols], atol=5e-5,
                                   rtol=5e-5)
        np.testing.assert_allclose(v1.numpy(), jv1[:, cols], atol=5e-5,
                                   rtol=5e-5)
        # the row is written in place, as the square wrapper writes it
        assert torch.equal(kcj[:, pos], k1)
        parts.append(out)
    got = M.model_sum(parts, bo, tx)[0]
    np.testing.assert_allclose(got.numpy(), jxo, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("heads,mp", [(4, 2), (4, 4), (6, 2), (8, 2),
                                      (8, 4)])
@pytest.mark.parametrize("b", [8, 33])
def test_k4_partial_ranks_summed_match_jax(heads, mp, b):
    (x, _, mlp, _, _), (_, _, _, jmo) = _jax_blocks(b, heads, 0)
    tx = _t(x)
    g, bl, w1, b1, w2, b2 = map(_t, mlp)
    parts = [DB.fused_mlp_block(tx, g, bl, _heads(w1, j, mp, 1),
                                _heads(b1, j, mp, 0), _heads(w2, j, mp, 0),
                                None, partial=True) for j in range(mp)]
    assert all(p.dtype == torch.float32 for p in parts)
    got = M.model_sum(parts, b2, tx)[0]
    np.testing.assert_allclose(got.numpy(), jmo, atol=5e-5, rtol=5e-5)


# ------------------------------------------------------------ K2
@pytest.mark.parametrize("hl", [3, 4])
@pytest.mark.parametrize("t,pos", [(150, None), (12, 0), (12, 11)])
def test_k2_on_head_shards_matches_jax(rng, hl, t, pos):
    """K2 takes merged rows of any head count: a rank's H/mp heads of
    whisper-tiny (3) and -base (4), cross keys and the self cache."""
    b = 5
    q = rng.normal(size=(b, hl * 64)).astype(np.float32)
    k, v = (rng.normal(size=(b, t, hl * 64)).astype(np.float32)
            for _ in range(2))
    got = CA.fused_single_query_attention(*map(_t, (q, k, v)), heads=hl,
                                          pos=pos)
    ref = JCA.fused_single_query_attention(
        *map(jnp.asarray, (q, k, v)), heads=hl,
        pos=None if pos is None else jnp.int32(pos), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


# ------------------------------------------------------- placement
def test_shard_heads_matches_jax_shards_and_splits_the_biases():
    jm_ = jmesh.make_mesh(8, model_parallel=2)
    tm = M.make_mesh(8, model_parallel=2, device="cpu")
    jtree = JW.init_params(jax.random.PRNGKey(0), JW.PRESETS["test"])
    ttree = weights.whisper_params(jax.tree.map(np.asarray, jtree))
    placed = M.shard_heads(ttree, tm, JW.PRESETS["test"].heads)
    assert placed.shape == (4, 2)
    grid = {d.id: pos for pos, d in np.ndenumerate(jm_.devices)}
    for p, leaf in jax.tree_util.tree_flatten_with_path(
            jmesh.shard_params(jtree, jm_))[0]:
        path = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
        whole = functools.reduce(lambda t, k: t[k], path, ttree)
        for shard in leaf.addressable_shards:
            pos = grid[shard.device.id]
            got = functools.reduce(lambda t, k: t[k], path, placed[pos])
            axis = M._head_split(path)
            if axis is not None and path[-1] == "w":
                # JAX splits these weights the same way
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(shard.data))
            elif axis is not None:
                # a bias of q/k/v/mlp_in, which JAX replicates: the
                # port splits it with its columns
                np.testing.assert_array_equal(
                    got.numpy(), torch.chunk(whole, 2)[pos[1]].numpy())
            else:
                np.testing.assert_array_equal(got.numpy(), whole.numpy())
    with pytest.raises(ValueError, match="do not split"):
        M.shard_heads(ttree, M.make_mesh(8, model_parallel=8, device="cpu"),
                      JW.PRESETS["test"].heads)


def test_model_sum_order_and_rounding():
    """Partials summed in rank order, then residual + (sum + bias),
    rounded once to the residual's dtype; a copy a rank."""
    p = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
         torch.tensor([1.0, 1.0])]
    x = torch.tensor([0.5, 0.25], dtype=torch.bfloat16)
    out = M.model_sum(p, torch.tensor([2.0, 0.0]), x)
    assert len(out) == 3 and out[0].dtype == torch.bfloat16
    assert out[0].tolist() == [3.5, 3.25]
    assert M.model_sum(p[:1], None, [x, x])[0].dtype == torch.bfloat16


# ------------------------------------------------------- embedders
@pytest.mark.parametrize("family,mp", [("minilm", 2), ("minilm", 4),
                                       ("mpnet", 2), ("mpnet", 4)])
def test_embedder_tp_matches_jax_mesh(family, mp):
    if family == "minilm":
        jmod, tmod, carry = JMini, Mini, weights.minilm_params
        jcfg_ = JMini.MiniLMConfig(**SMALL_MINILM)
        tcfg_ = Mini.MiniLMConfig(**SMALL_MINILM)
    else:
        jmod, tmod, carry = JMp, Mp, weights.mpnet_params
        jcfg_, tcfg_ = (JMp.MPNetConfig(**SMALL_MPNET),
                        Mp.MPNetConfig(**SMALL_MPNET))
    jparams = jmod.init_params(jax.random.PRNGKey(5), jcfg_)
    jemb = JEmbedder(params=jparams, cfg=jcfg_, model=jmod, max_tokens=32)
    jemb.use_mesh(jmesh.make_mesh(8, model_parallel=mp))
    temb = TextEmbedder(params=carry(jax.tree.map(np.asarray, jparams)),
                        cfg=tcfg_, model=tmod, device="cpu", max_tokens=32)
    one = temb(TEXTS)
    temb.use_mesh(M.make_mesh(8, model_parallel=mp, device="cpu"))
    assert temb._shards.shape == (8 // mp, mp)
    got = temb(TEXTS)
    np.testing.assert_allclose(got, jemb(TEXTS), atol=2e-5)
    np.testing.assert_allclose(got, one, atol=2e-5)


def test_dcn_mesh_model_axis_runs_the_embedder():
    """make_dcn_mesh's model axis: each process's data rows over their
    model devices (one process here, so both slices' rows), the TP
    embedder = the one-device one."""
    from multimodal_audio_search_tpu_torch.parallel import distributed as D
    dmesh = D.make_dcn_mesh(dcn=2, model_parallel=2, device="cpu")
    assert len(dmesh.data_devices()) == 4
    assert [len(dmesh.model_devices(i)) for i in range(4)] == [2] * 4
    cfg = Mini.MiniLMConfig(**SMALL_MINILM)
    emb = TextEmbedder(cfg=cfg, device="cpu", max_tokens=32)
    one = emb(TEXTS)
    emb.use_mesh(dmesh)
    assert emb._shards.shape == (4, 2)
    np.testing.assert_allclose(emb(TEXTS), one, atol=2e-5)


# --------------------------------------------------------- Whisper
@pytest.fixture(scope="module")
def whisper_case():
    cfg = W.PRESETS["test"]
    params = W.init_params(torch.Generator().manual_seed(4), cfg)
    params = tree_map(lambda a: a * 3.0 if a.dim() == 2 else a, params)
    prepared = W.prepare_params(params, torch.float32, torch.device("cpu"))
    mel = torch.randn(3, cfg.n_mels, 200, generator=torch.Generator()
                      .manual_seed(5))
    return cfg, prepared, mel


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("fused", [False, True])
def test_whisper_tp_forms_match_one_device(whisper_case, mp, fused):
    """encode_tp (K1p's twin with fused blocks, the plain partial
    without), decode_step_tp (K3p/K4p twins with fused_layer) and
    generate_tp against the one-device functions, float32."""
    cfg, params, mel = whisper_case
    mesh = M.make_mesh(mp, model_parallel=mp, device="cpu")
    trees = list(M.shard_heads(params, mesh, cfg.heads)[0])
    enc = W.encode(params, mel, cfg, fused_blocks=fused)
    encs = W.encode_tp(trees, mel, cfg, fused_blocks=fused)
    assert len(encs) == mp
    np.testing.assert_allclose(encs[0].numpy(), enc.numpy(), atol=5e-5,
                               rtol=5e-5)
    dec = DecodeConfig(max_new_tokens=6, fused_layer=fused)
    prefix = torch.tensor([[cfg.bos_token_id, cfg.lang_en_id]] * 8)
    enc8, encs8 = enc.repeat(3, 1, 1)[:8], [e.repeat(3, 1, 1)[:8]
                                            for e in encs]
    ckv = W.cross_kv_merged(params, enc8, cfg)
    ckvs = W.cross_kv_merged_tp(trees, encs8, cfg)
    cache = W.init_cache(cfg, 8, 8, torch.float32, "cpu")
    caches = W.init_cache_tp(trees, cfg, 8, 8, torch.float32)
    assert caches[0][0]["k"].shape == (8, 8, cfg.d_model // mp)
    tok = prefix[:, 0]
    for pos in range(3):
        lg = W.decode_step(params, tok, pos, cache, ckv, cfg,
                           fused_layer=fused)
        lg_tp = W.decode_step_tp(trees, tok, pos, caches, ckvs, cfg,
                                 fused_layer=fused)
        np.testing.assert_allclose(lg_tp.numpy(), lg.numpy(), atol=5e-5,
                                   rtol=5e-5)
        tok = lg.argmax(-1)
    one = G.generate(params, enc8, prefix, cfg=cfg, decode=dec,
                     max_new_tokens=6)
    tp = G.generate_tp(trees, encs8, prefix, cfg=cfg, decode=dec,
                       max_new_tokens=6)
    assert torch.equal(tp.tokens, one.tokens)
    assert torch.equal(tp.lengths, one.lengths) and tp.steps == one.steps
    # the einsum cross K/V format on the head shards
    ein = dataclasses.replace(dec, cross_attn="einsum")
    assert torch.equal(G.generate_tp(trees, encs8, prefix, cfg=cfg,
                                     decode=ein, max_new_tokens=6).tokens,
                       one.tokens)


@pytest.mark.parametrize("change", [dict(method="sample"),
                                    dict(method="beam", num_beams=2),
                                    dict(fused_layer="v2"),
                                    dict(cross_attn="int8_fused"),
                                    dict(int8_cross_kv=True),
                                    dict(fused_encoder="paired")])
def test_generate_tp_refuses_what_the_axis_does_not_run(whisper_case,
                                                        change):
    """What the axis refused before ROADMAP A13c now runs: each option's
    TP decode (generate_tp, or beam_generate_tp for beam) gives the
    one-device tokens, and the encoder variant its one-device states
    (the paired form within 5e-5; the int8 form where no p8 code flips,
    test_torch_tp_modes.py)."""
    from multimodal_audio_search_tpu_torch.models import beam as BM
    cfg, params, mel = whisper_case
    trees = list(M.shard_heads(params, M.make_mesh(2, model_parallel=2,
                                                   device="cpu"),
                               cfg.heads)[0])
    dec = DecodeConfig(max_new_tokens=4, **change)
    enc = W.encode(params, mel, cfg, fused_blocks=dec.fused_encoder or True)
    encs = W.encode_tp(trees, mel, cfg,
                       fused_blocks=dec.fused_encoder or True)
    if dec.fused_encoder == "paired":
        np.testing.assert_allclose(encs[1].numpy(), enc.numpy(), atol=5e-5)
    enc8, encs8 = enc.repeat(3, 1, 1)[:8], [e.repeat(3, 1, 1)[:8]
                                            for e in encs]
    prefix = torch.tensor([[cfg.bos_token_id, cfg.lang_en_id]] * 8)
    kw = dict(cfg=cfg, decode=dec, max_new_tokens=4)
    if dec.method == "beam":
        one = BM.beam_generate(params, enc8, prefix, num_beams=2, **kw)
        tp = BM.beam_generate_tp(trees, encs8, prefix, num_beams=2, **kw)
    else:
        one = G.generate(params, enc8, prefix,
                         rng=torch.Generator().manual_seed(5), **kw)
        tp = G.generate_tp(trees, encs8, prefix,
                           rng=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(tp.tokens, one.tokens)
    assert torch.equal(tp.lengths, one.lengths)
