"""The port's mesh (parallel/mesh.py) and sharded search
(parallel/sharding.py) against the JAX package's, on the CPU: JAX on its 8
virtual devices (tests/conftest.py), the port on a mesh of virtual CPU
entries, the same seeded numpy inputs.

* mesh construction, its refusals and their messages;
* the Megatron TP rule for every leaf of the test-preset Whisper and
  MiniLM trees, and shard_params' per-device shards on a (4, 2) mesh =
  JAX's addressable shards (shapes and values);
* sharded_fused_topk and sharded_fused_search_impl at dp 2/4/8 = JAX's
  (indices and valid identical, scores and sims within 1e-5), with k
  above a shard's rows, a shard with no valid row and equal scores
  across shards;
* the store's sharded device view, cached on the mesh object.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.config import EngineConfig as JEngineConfig
from multimodal_audio_search_tpu.models import minilm as JM
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.parallel import mesh as jmesh
from multimodal_audio_search_tpu.parallel import sharding as jsharding
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.config import EngineConfig
from multimodal_audio_search_tpu_torch.index.store import SegmentStore
from multimodal_audio_search_tpu_torch.parallel import mesh as M
from multimodal_audio_search_tpu_torch.parallel import sharding as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
W_ASR, W_AUDIO = 0.7, 0.3


def _index(rng, n, d=32, p_ok=0.7):
    emb = rng.normal(size=(n, 2, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    ok = rng.random((n, 2)) < p_ok
    emb[~ok] = 0.0
    return emb, ok


def _jax_search(dp, q, emb, ok, k, full=True):
    mesh = jmesh.make_mesh(dp, model_parallel=1)
    e, o = jsharding.shard_index(mesh, emb, ok)
    if full:
        fn = jsharding.sharded_fused_search(mesh, k=k)
    else:
        fn = jsharding.sharded_fused_topk(mesh, k=k)
    out = fn(jnp.asarray(q), e, o, jnp.float32(W_ASR), jnp.float32(W_AUDIO))
    return jax.tree.map(np.asarray, out)


def _port_search(dp, q, emb, ok, k, full=True):
    mesh = M.make_mesh(dp, device="cpu")
    e, o = S.shard_index(mesh, emb, ok)
    fn = (S.sharded_fused_search_impl if full else S.sharded_fused_topk)(
        mesh, k=k)
    out = fn(torch.from_numpy(q), e, o, W_ASR, W_AUDIO)
    if full:
        return {key: v.numpy() for key, v in out.items()}
    return tuple(v.numpy() for v in out)


def _same(got: dict, ref: dict) -> None:
    for key in ("indices", "valid"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert int(got["num_valid"]) == int(ref["num_valid"])
    for key in ("scores", "sims", "effective_weights"):
        np.testing.assert_allclose(got[key], ref[key], atol=1e-5,
                                   err_msg=key)


# ------------------------------------------------------------------ mesh
def test_make_mesh_shapes_and_refusals():
    m = M.make_mesh(8, model_parallel=2, device="cpu")
    assert m.shape == {"data": 4, "model": 2}
    assert m.data_devices() == [CPU] * 4
    assert M.make_mesh(device="cpu").shape == {"data": 8, "model": 1}
    one_card = M.make_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    assert one_card.data_devices() == [torch.device("cuda", 0)] * 4
    with pytest.raises(ValueError, match="divide by model_parallel"):
        M.make_mesh(6, model_parallel=4, device="cpu")
    with pytest.raises(ValueError, match="asked for"):
        M.make_mesh(3, devices=[CPU] * 2)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA devices"):
            M.make_mesh(2, device="cuda")


@pytest.mark.parametrize("dp,mp", [(3, 1), (6, 2)])
def test_non_power_of_two_data_axis_refused_with_jax_message(dp, mp):
    with pytest.raises(ValueError) as jerr:
        jmesh.mesh_from_config(JEngineConfig(data_parallel=dp,
                                             model_parallel=mp))
    with pytest.raises(ValueError) as terr:
        M.mesh_from_config(EngineConfig(data_parallel=dp, model_parallel=mp),
                           "cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jmesh.validate_data_axis(jmesh.make_mesh(6))
    with pytest.raises(ValueError) as terr:
        M.validate_data_axis(M.make_mesh(6, device="cpu"))
    assert str(terr.value) == str(jerr.value)


def test_mesh_from_config():
    assert M.mesh_from_config(EngineConfig(), "cpu") is None
    m = M.mesh_from_config(EngineConfig(data_parallel=4), "cpu")
    assert m.shape == {"data": 4, "model": 1}
    # the model axis: a (dp, mp) grid of dp * mp devices, as JAX builds it
    for dp, mp in ((2, 2), (1, 2), (4, 2), (2, 4)):
        m = M.mesh_from_config(EngineConfig(data_parallel=dp,
                                            model_parallel=mp), "cpu")
        jm_ = jmesh.mesh_from_config(JEngineConfig(data_parallel=dp,
                                                   model_parallel=mp))
        assert m.shape == {"data": dp, "model": mp} == dict(jm_.shape)
        assert len(m.data_devices()) == dp
        assert [len(m.model_devices(i)) for i in range(dp)] == [mp] * dp


def test_placement_helpers(rng):
    m = M.make_mesh(4, device="cpu")
    x = rng.normal(size=(8, 3)).astype(np.float32)
    blocks = M.data_sharded(m, x)
    assert [tuple(b.shape) for b in blocks] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), x)
    with pytest.raises(ValueError, match="does not divide"):
        M.data_sharded(m, x[:6])
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), None]}
    reps = M.replicated(m, tree)
    assert len(reps) == 4 and reps[2]["a"] is tree["a"]
    assert reps[1]["b"][1] is None


# ----------------------------------------------------------- TP rule
def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _jax_path(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _trees():
    jw = JW.init_params(jax.random.PRNGKey(0), JW.PRESETS["test"])
    jm = JM.init_params(jax.random.PRNGKey(1), JM.PRESETS["test"])
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return [(jw, weights.whisper_params(np_tree(jw))),
            (jm, weights.minilm_params(np_tree(jm)))]


def test_param_spec_matches_jax_for_every_leaf():
    for jtree, ttree in _trees():
        ref = {_jax_path(p): tuple(jmesh.whisper_param_spec(p, leaf))
               for p, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
        got = {p: M.whisper_param_spec(p, leaf) for p, leaf in _paths(ttree)}
        assert got == ref
        assert {(None, "model"), ("model", None)} <= set(got.values())


def test_shard_params_equals_jax_addressable_shards():
    jm_ = jmesh.make_mesh(8, model_parallel=2)
    tm = M.make_mesh(8, model_parallel=2, device="cpu")
    grid = {d.id: pos for pos, d in np.ndenumerate(jm_.devices)}
    for jtree, ttree in _trees():
        placed = M.shard_params(ttree, tm)
        assert placed.shape == (4, 2)
        leaves = dict(_paths(ttree))
        for p, leaf in jax.tree_util.tree_flatten_with_path(
                jmesh.shard_params(jtree, jm_))[0]:
            path = _jax_path(p)
            assert path in leaves
            for shard in leaf.addressable_shards:
                pos = grid[shard.device.id]
                got = dict(_paths(placed[pos]))[path]
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(shard.data))


# ------------------------------------------------------ sharded search
@pytest.mark.parametrize("dp", [2, 4, 8])
def test_sharded_search_matches_jax(rng, dp):
    emb, ok = _index(rng, 8 * 64)
    q = emb[77, 0] + 0.05 * rng.normal(size=32).astype(np.float32)
    q /= np.linalg.norm(q)
    _same(_port_search(dp, q, emb, ok, 10), _jax_search(dp, q, emb, ok, 10))
    s, i = _port_search(dp, q, emb, ok, 10, full=False)
    js, ji = _jax_search(dp, q, emb, ok, 10, full=False)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, atol=1e-5)


@pytest.mark.parametrize("case", ["k_above_shard_rows", "empty_shard",
                                  "ties_across_shards"])
@pytest.mark.parametrize("dp", [2, 8])
def test_sharded_search_edges_match_jax(rng, dp, case):
    """k above a shard's rows (the result holds a shard's rows, as JAX's
    does), a shard whose every row failed, and rows repeated in every
    shard (equal scores go to the lower global index)."""
    n = 4 * dp if case == "k_above_shard_rows" else 16 * dp
    emb, ok = _index(rng, n)
    q = emb[1, 0].copy()
    if case == "empty_shard":
        ok[: n // dp] = False
        emb[: n // dp] = 0.0
        q = emb[n // dp + 1, 0].copy()
    if case == "ties_across_shards":
        blk = n // dp
        for s in range(1, dp):
            emb[s * blk: s * blk + 3] = emb[:3]
            ok[s * blk: s * blk + 3] = ok[:3]
    k = 10
    got, ref = _port_search(dp, q, emb, ok, k), _jax_search(dp, q, emb, ok, k)
    _same(got, ref)
    if case == "k_above_shard_rows":
        assert len(got["indices"]) == 4
    if case == "ties_across_shards":
        top = got["scores"][0]
        tied = got["indices"][got["scores"] == top]
        assert len(tied) > 1 and list(tied) == sorted(tied)


def test_sharded_search_batch_reads_each_shard_once(rng):
    """Queries with a leading batch dim give the singles' results."""
    emb, ok = _index(rng, 256)
    mesh = M.make_mesh(4, device="cpu")
    e, o = S.shard_index(mesh, emb, ok)
    fn = S.sharded_fused_search_impl(mesh, k=10)
    qs = torch.from_numpy(emb[[3, 50, 200], 0])
    batch = fn(qs, e, o, [0.6, 0.5, 1.0], [0.4, 0.5, 0.0])
    for i, (wa, wb) in enumerate([(0.6, 0.4), (0.5, 0.5), (1.0, 0.0)]):
        one = fn(qs[i], e, o, wa, wb)
        for key, v in one.items():
            torch.testing.assert_close(batch[key][i], v, rtol=0, atol=1e-6)


# ----------------------------------------------------------------- store
def test_device_index_cache_keys_on_mesh_object(rng):
    st = SegmentStore(embed_dim=8)
    for i in range(4):
        st.add({"source": "s", "start_time": float(i)},
               rng.normal(size=8), rng.normal(size=8))
    m1 = M.make_mesh(8, device="cpu")
    emb1, ok1 = st.device_index(CPU, mesh=m1)
    key1 = st._device_view[0]
    assert any(k is m1 for k in key1)
    assert len(emb1) == 8 and sum(e.shape[0] for e in emb1) == 1024
    m2 = M.make_mesh(2, device="cpu")
    emb2, _ = st.device_index(CPU, mesh=m2)
    assert st._device_view[0] != key1 and len(emb2) == 2
    np.testing.assert_array_equal(torch.cat(emb2).numpy(),
                                  st.host_index(padded=True)[0])
    assert st.device_index(CPU, mesh=m2)[0] is emb2      # cached
