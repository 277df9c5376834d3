"""Multi-process DCN check of the PyTorch port on one host.

The port's counterpart of tools/multiprocess_dcn_check.py. It spawns N
OS processes joined in one ``torch.distributed`` group (Gloo; the parent
sets torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, which
``parallel/distributed.py::initialize`` reads), each holding ``--local``
entries of its device (the card named ``--local`` times, or virtual CPU
entries), and each runs:

  * ``parallel.distributed.make_dcn_mesh`` -- the ("dcn", "data",
    "model") mesh whose "dcn" axis is the process rank;
  * ``hierarchical_sharded_topk`` over an index sharded across the
    processes (stage 2's all-gather crosses the process boundary);
  * one data-parallel training step on a toy least-squares regression:
    each process sums its local chunks' gradients, then the processes
    sum theirs with ``torch.distributed.all_reduce`` (Gloo, on host
    tensors: NCCL refuses two ranks on one card).

Every process checks its results against its own single-device
computation (the unsharded fused scores, the whole batch's gradient)
and prints MPDCN_OK; the parent prints ALL OK and exits 0 when every
process did. ``--dump DIR`` also writes each rank's scores, ids and
gradient to DIR/rank<r>.npz. The data are the JAX tool's (``make_data``,
seed 7); ``--rows`` / ``--dim`` scale the index (the card runs 1M x 2 x
384, the scale of chip_smoke.py's ``[mesh]``).

Usage:  python tools/torch_multiprocess_dcn_check.py [--procs 2]
            [--local 4] [--rows 512] [--dim 64] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 10
W_ASR, W_AUDIO = 0.6, 0.4
# the parent's deadline for its children, seconds (the 1M-row run takes
# ~30 s on an H100)
TIMEOUT_S = 600


def make_data(n: int, d: int, procs: int, local: int):
    """The JAX tool's index, query and regression batch, in its order
    from one generator: (emb[n, 2, d], success[n, 2] as 0/1 float32,
    query[d], x[procs * local * 4, d], y[procs * local * 4])."""
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(n, 2, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    success = (rng.random((n, 2)) > 0.2).astype(np.float32)
    query = rng.normal(size=(d,)).astype(np.float32)
    query /= np.linalg.norm(query)
    xb = rng.normal(size=(procs * local * 4, d)).astype(np.float32)
    yb = xb @ rng.normal(size=(d,)).astype(np.float32)
    return emb, success, query, xb, yb


def child(procs: int, local: int, rows: int, dim: int, device: str,
          dump: str | None) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from multimodal_audio_search_tpu_torch.index.fusion import fused_scores
    from multimodal_audio_search_tpu_torch.parallel import distributed as D

    pid = int(os.environ["RANK"])
    assert D.initialize(backend="gloo", device=device)
    assert dist.get_world_size() == procs, dist.get_world_size()
    dev = torch.device(device, 0) if device == "cuda" \
        else torch.device(device)
    mesh = D.make_dcn_mesh(dcn=procs, model_parallel=1,
                           devices=[dev] * local, device=device)
    assert mesh.shape == {"dcn": procs, "data": local, "model": 1}, \
        mesh.shape

    # --- hierarchical sharded search across the process boundary ---
    emb, success, query, xb, yb = make_data(rows, dim, procs, local)
    emb_s, suc_s = D.shard_index_dcn(mesh, emb, success)
    q = torch.from_numpy(query).to(dev)
    fn = D.hierarchical_sharded_topk(mesh, k=K)
    s, i = fn(q, emb_s, suc_s, W_ASR, W_AUDIO)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        s, i = fn(q, emb_s, suc_s, W_ASR, W_AUDIO)
        s = s.cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    s, i = s.numpy(), i.cpu().numpy()
    del emb_s, suc_s

    # single-device oracle (the same math as index.fusion.fused_scores)
    masked, _ = fused_scores(q, torch.from_numpy(emb).to(dev),
                             torch.from_numpy(success).to(dev),
                             W_ASR, W_AUDIO, 0.1)
    oi = torch.sort(masked, descending=True, stable=True)[1][:K]
    want = masked[oi].cpu().numpy()
    oi = oi.cpu().numpy()
    np.testing.assert_allclose(s, want, rtol=1e-5, atol=1e-6)
    # scores strictly decreasing here (continuous random): indices too
    np.testing.assert_array_equal(np.sort(i), np.sort(oi))
    del masked, emb

    # --- one data-parallel step whose gradient sum crosses processes ---
    w = torch.zeros(dim, device=dev, requires_grad=True)
    n_all = xb.shape[0]
    mine = np.array_split(np.arange(n_all), procs)[pid]
    grads = []
    for rows_c, d_c in zip(np.array_split(mine, local), mesh.data_devices()):
        xc = torch.from_numpy(xb[rows_c]).to(d_c)
        yc = torch.from_numpy(yb[rows_c]).to(d_c)
        wc = w.detach().to(d_c).requires_grad_(True)
        loss = ((xc @ wc - yc) ** 2).sum() / n_all
        grads.append(torch.autograd.grad(loss, wc)[0].to(dev))
    g = grads[0]
    for gc in grads[1:]:                     # rank order, first device
        g = g + gc
    g = g.detach().cpu()
    dist.all_reduce(g)                       # Gloo: host tensors
    g = g.numpy()
    x_all = torch.from_numpy(xb).to(dev)
    y_all = torch.from_numpy(yb).to(dev)
    g_ref = torch.autograd.grad(((x_all @ w - y_all) ** 2).mean(),
                                w)[0].cpu().numpy()
    np.testing.assert_allclose(g, g_ref, rtol=2e-5, atol=1e-6)

    if dump:
        np.savez(os.path.join(dump, f"rank{pid}.npz"), scores=s, ids=i,
                 grad=g)
    print(f"MPDCN_OK pid={pid} rows={rows} dim={dim} device={dev} "
          f"local={local} top1={s[0]:.4f} gnorm={np.linalg.norm(g):.4f} "
          f"search_ms_p50={sorted(walls)[len(walls) // 2]:.3f}",
          flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local", type=int, default=4)
    ap.add_argument("--port", type=int, default=0,
                    help="the group's TCP port on localhost (0: a free "
                         "one)")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card, named --local times "
                         "by every process) or cpu")
    ap.add_argument("--dump", default=None,
                    help="write each rank's scores, ids and gradient here")
    args = ap.parse_args(argv)

    if "MPDCN_CHILD" in os.environ:
        child(args.procs, args.local, args.rows, args.dim, args.device,
              args.dump)
        return 0

    port = args.port or free_port()
    procs = []
    for pid in range(args.procs):
        env = {**os.environ, "MPDCN_CHILD": "1",
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(args.procs), "RANK": str(pid)}
        cmd = [sys.executable, os.path.abspath(__file__),
               "--procs", str(args.procs), "--local", str(args.local),
               "--rows", str(args.rows), "--dim", str(args.dim),
               "--device", args.device]
        if args.dump:
            cmd += ["--dump", args.dump]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    deadline = time.monotonic() + TIMEOUT_S
    ok = True
    try:
        for pid, p in enumerate(procs):
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += f"\n(killed after {TIMEOUT_S} s)"
            if p.returncode != 0 or "MPDCN_OK" not in out:
                ok = False
                print(f"--- process {pid} FAILED (rc={p.returncode}):")
            print(out.strip(), flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("ALL OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
