"""The port's DCN axis (parallel/distributed.py) against the JAX package's,
on the CPU.

* ``initialize`` is a no-op without a world;
* ("dcn", "data", "model") mesh shapes and refusals;
* the two-stage hierarchical top-k at (dcn, mp) = (2, 1), (2, 2), (4, 1)
  and the hierarchical IVF, in one process, = JAX's on its 8 virtual
  devices and = the flat fused_topk (indices identical, scores 1e-5);
* two processes over Gloo (dcn = 2 x data = 4, a FileStore in tmp_path),
  each holding its own half of the index, both returning the single-device
  JAX fused_topk_impl's top-k; the children import the port only, with
  jax blocked, and print their results as JSON.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.index.fusion import (fused_topk,
                                                      fused_topk_impl)
from multimodal_audio_search_tpu.index.ivf import (
    build_ivf_sharded as jbuild_ivf_sharded)
from multimodal_audio_search_tpu.parallel import distributed as JD
from multimodal_audio_search_tpu_torch.index.ivf import build_ivf_sharded
from multimodal_audio_search_tpu_torch.parallel import distributed as D

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_ASR, W_AUDIO = 0.7, 0.3


def _index(rng, n=16 * 8, d=32):
    emb = rng.normal(size=(n, 2, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    ok = rng.random((n, 2)) > 0.3
    emb[~ok] = 0.0
    return emb, ok


def _flat(q, emb, ok, k=10):
    ref = fused_topk(jnp.asarray(q), jnp.asarray(emb), jnp.asarray(ok),
                     jnp.float32(W_ASR), jnp.float32(W_AUDIO), k=k)
    return np.asarray(ref["scores"]), np.asarray(ref["indices"])


def test_initialize_is_noop_without_a_world(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert D.initialize() is False
    # a world of one from the environment alone starts nothing either
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.initialize() is False
    assert not torch.distributed.is_initialized()


def test_make_dcn_mesh_shapes():
    m = D.make_dcn_mesh(dcn=2, model_parallel=2, device="cpu")
    assert m.shape == {"dcn": 2, "data": 2, "model": 2}
    assert len(m.data_devices()) == 4 and m.world is None
    m = D.make_dcn_mesh(dcn=4, device="cpu")
    assert m.shape == {"dcn": 4, "data": 2, "model": 1}
    m = D.make_dcn_mesh(dcn=1, ici_data=4,
                        devices=[torch.device("cuda", 0)] * 4)
    assert m.shape == {"dcn": 1, "data": 4, "model": 1}
    with pytest.raises(ValueError):
        D.make_dcn_mesh(dcn=3, device="cpu")
    with pytest.raises(ValueError):
        D.make_dcn_mesh(dcn=2, ici_data=3, device="cpu")


@pytest.mark.parametrize("dcn,mp", [(2, 1), (2, 2), (4, 1)])
def test_hierarchical_topk_matches_jax_and_flat(rng, dcn, mp):
    emb, ok = _index(rng)
    jm = JD.make_dcn_mesh(dcn=dcn, model_parallel=mp)
    tm = D.make_dcn_mesh(dcn=dcn, model_parallel=mp, device="cpu")
    assert tm.shape == dict(jm.shape)
    je, jo = JD.shard_index_dcn(jm, emb, ok)
    te, to = D.shard_index_dcn(tm, emb, ok)
    jfn = JD.hierarchical_sharded_topk(jm, k=10)
    tfn = D.hierarchical_sharded_topk(tm, k=10)
    for row in (37, 90):
        q = emb[row, 1] if ok[row, 1] else emb[row, 0]
        js, ji = jfn(jnp.asarray(q), je, jo, jnp.float32(W_ASR),
                     jnp.float32(W_AUDIO))
        ts, ti = tfn(torch.from_numpy(q), te, to, W_ASR, W_AUDIO)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
        fs, fi = _flat(q, emb, ok)
        np.testing.assert_array_equal(ti.numpy(), fi)


@pytest.mark.parametrize("n_probe", [2, None])
def test_hierarchical_ivf_matches_jax(rng, n_probe):
    """Per-shard buckets (built by each package) and the two-stage merge:
    the port's = JAX's at a partial and a full probe; the full probe =
    the flat exact top-k."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    emb, ok = _index(rng)
    jm = JD.make_dcn_mesh(dcn=2, model_parallel=2)
    tm = D.make_dcn_mesh(dcn=2, model_parallel=2, device="cpu")
    jl = jbuild_ivf_sharded(emb, ok, 4, n_clusters=4)
    tl = build_ivf_sharded(emb, ok, 4, n_clusters=4, device="cpu")
    np.testing.assert_array_equal(tl.members.numpy(), np.asarray(jl.members))
    probe = n_probe or tl.n_clusters
    sh = NamedSharding(jm, P(("dcn", "data")))
    jargs = [jax.device_put(a, sh) for a in
             (jl.centroids, jl.members, jl.spill, jnp.asarray(emb),
              jnp.asarray(ok))]
    jfn = JD.hierarchical_sharded_ivf(jm, jl, k=10, n_probe=probe)
    tfn = D.hierarchical_sharded_ivf(tm, tl, k=10, n_probe=probe)
    te, to = D.shard_index_dcn(tm, emb, ok)
    for row in (37, 101):
        q = emb[row, 0] if ok[row, 0] else emb[row, 1]
        js, ji = jfn(jnp.asarray(q), *jargs, jnp.float32(W_ASR),
                     jnp.float32(W_AUDIO))
        ts, ti = tfn(torch.from_numpy(q), *tl.place(tm.data_devices()),
                     te, to, W_ASR, W_AUDIO)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
        if n_probe is None:
            fs, fi = _flat(q, emb, ok)
            keep = fs > -1e29
            np.testing.assert_array_equal(ti.numpy()[keep], fi[keep])


CHILD = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None          # the port only
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from multimodal_audio_search_tpu_torch.index.ivf import build_ivf_sharded
    from multimodal_audio_search_tpu_torch.parallel import distributed as D
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    data = np.load(tmp + "/data.npz")
    emb, ok, qs = data["emb"], data["ok"], data["qs"]
    assert D.initialize(init_method="file://" + tmp + "/pg", world_size=2,
                        rank=rank, device="cpu")
    try:
        mesh = D.make_dcn_mesh(ici_data=4, device="cpu")
        e, o = D.shard_index_dcn(mesh, emb, ok)
        layout = build_ivf_sharded(emb, ok, 8, n_clusters=4, device="cpu")
        placed = layout.place(mesh.data_devices(), first=4 * rank)
        topk = D.hierarchical_sharded_topk(mesh, k=10)
        ivf = D.hierarchical_sharded_ivf(mesh, layout, k=10,
                                         n_probe=layout.n_clusters)
        out = {"rank": rank, "shape": mesh.shape,
               "rows": [int(x.shape[0]) for x in e],
               "backend": dist.get_backend(), "topk": [], "ivf": []}
        for q in qs:
            q = torch.from_numpy(q)
            s, i = topk(q, e, o, 0.7, 0.3)
            out["topk"].append([s.tolist(), i.tolist()])
            s, i = ivf(q, *placed, e, o, 0.7, 0.3)
            out["ivf"].append([s.tolist(), i.tolist()])
    finally:
        dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


def test_two_process_gloo_matches_jax_single_device(rng, tmp_path):
    emb, ok = _index(rng, n=8 * 16)
    qs = np.stack([emb[5, 0], emb[70, 1], emb[127, 0]])
    qs /= np.maximum(np.linalg.norm(qs, axis=-1, keepdims=True), 1e-12)
    np.savez(tmp_path / "data.npz", emb=emb, ok=ok, qs=qs)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(tmp_path)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-3000:]
            line = next(ln for ln in stdout.splitlines()
                        if ln.startswith("RESULT "))
            outs.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert o["shape"] == {"dcn": 2, "data": 4, "model": 1}
        assert o["rows"] == [16] * 4 and o["backend"] == "gloo"
        for qi, q in enumerate(qs):
            ref = fused_topk_impl(jnp.asarray(q), jnp.asarray(emb),
                                  jnp.asarray(ok), jnp.float32(W_ASR),
                                  jnp.float32(W_AUDIO), k=10)
            rs, ri = np.asarray(ref["scores"]), np.asarray(ref["indices"])
            s, i = o["topk"][qi]
            np.testing.assert_array_equal(i, ri)
            np.testing.assert_allclose(s, rs, atol=1e-5)
            s, i = o["ivf"][qi]
            keep = rs > -1e29
            np.testing.assert_array_equal(np.asarray(i)[keep], ri[keep])
            np.testing.assert_allclose(np.asarray(s)[keep], rs[keep],
                                       atol=1e-5)
