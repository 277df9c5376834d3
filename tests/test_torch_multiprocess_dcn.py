"""tools/torch_multiprocess_dcn_check.py on the CPU against JAX.

Two OS processes in one Gloo group (torchrun's MASTER_ADDR / MASTER_PORT
/ WORLD_SIZE / RANK, set by the tool's parent), each holding four
virtual CPU entries of a ("dcn", "data", "model") = (2, 4, 1) mesh, with
jax blocked in the children: both print MPDCN_OK and the parent ALL OK.
Each rank's dump then holds the hierarchical sharded top-10 -- ids equal
to, scores within 1e-5 of, JAX's ``index.fusion.fused_scores`` on the
same data (the tool's ``make_data``, the JAX tool's generator) -- and the
data-parallel gradient summed across the processes, within rtol 2e-5 of
``jax.grad`` of the whole batch's loss.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import torch_multiprocess_dcn_check as T  # noqa: E402
from multimodal_audio_search_tpu.index.fusion import fused_scores  # noqa


def test_two_processes_match_jax(tmp_path):
    # jax blocked in the children: a sitecustomize on their path
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(
        "import sys\nsys.modules['jax'] = None\n"
        "sys.modules['multimodal_audio_search_tpu'] = None\n")
    dump = tmp_path / "dump"
    dump.mkdir()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(block), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)}
    p = subprocess.run(
        [sys.executable, str(ROOT / "tools" /
                             "torch_multiprocess_dcn_check.py"),
         "--device", "cpu", "--procs", "2", "--local", "4",
         "--dump", str(dump)],
        env=env, capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-2000:]
    assert "ALL OK" in p.stdout
    assert p.stdout.count("MPDCN_OK") == 2

    emb, success, query, xb, yb = T.make_data(512, 64, 2, 4)
    masked, _ = fused_scores(jnp.asarray(query), jnp.asarray(emb),
                             jnp.asarray(success), np.float32(T.W_ASR),
                             np.float32(T.W_AUDIO), 0.1)
    masked = np.asarray(masked)
    want_ids = np.argsort(-masked, kind="stable")[:T.K]
    g_ref = np.asarray(jax.grad(
        lambda w: jnp.mean((jnp.asarray(xb) @ w - jnp.asarray(yb)) ** 2))(
        jnp.zeros(64, jnp.float32)))
    for rank in range(2):
        with np.load(dump / f"rank{rank}.npz") as z:
            np.testing.assert_array_equal(z["ids"], want_ids)
            np.testing.assert_allclose(z["scores"], masked[want_ids],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(z["grad"], g_ref, rtol=2e-5,
                                       atol=1e-6)


def test_make_data_is_the_jax_tools_sequence():
    """make_data draws what tools/multiprocess_dcn_check.py draws, in its
    order, from the same seed."""
    emb, success, query, xb, yb = T.make_data(64, 8, 2, 1)
    rng = np.random.default_rng(7)
    e = rng.normal(size=(64, 2, 8)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    s = (rng.random((64, 2)) > 0.2).astype(np.float32)
    q = rng.normal(size=(8,)).astype(np.float32)
    q /= np.linalg.norm(q)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    y = x @ rng.normal(size=(8,)).astype(np.float32)
    for a, b in ((emb, e), (success, s), (query, q), (xb, x), (yb, y)):
        np.testing.assert_array_equal(a, b)
