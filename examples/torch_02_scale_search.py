"""Search at scale on the PyTorch port: exact fused top-k, IVF candidate
generation, and the beyond-memory host index -- all over the same
synthetic topical index.

The port's counterpart of examples/02_scale_search.py, on the card unless
``--device cpu`` is passed.

    python examples/torch_02_scale_search.py [--device cpu] [--n 20000]
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=5000)
    args = ap.parse_args()

    import torch
    from multimodal_audio_search_tpu_torch.index.bigindex import (
        HostIndex, build_host_index)
    from multimodal_audio_search_tpu_torch.index.fusion import fused_topk
    from multimodal_audio_search_tpu_torch.index.ivf import (
        build_ivf, calibrate_n_probe)
    from multimodal_audio_search_tpu_torch.index.store import SegmentStore

    dev = torch.device(args.device)
    # topical mixture (text embeddings cluster by subject)
    rng = np.random.default_rng(0)
    n, d = args.n, 64
    topics = 64
    cent = rng.normal(size=(topics, d)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=-1, keepdims=True)
    rows = cent[rng.integers(0, topics, size=n)]
    emb = (rows[:, None, :] + (0.35 / np.sqrt(d)) * rng.normal(
        size=(n, 2, d))).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    success = rng.random((n, 2)) > 0.2
    emb[~success] = 0.0
    q = (cent[7] + (0.4 / np.sqrt(d)) * rng.normal(size=d)) \
        .astype(np.float32)
    q /= np.linalg.norm(q)
    emb_d = torch.from_numpy(emb).to(dev)
    suc_d = torch.from_numpy(success).to(dev)
    q_d = torch.from_numpy(q).to(dev)

    # 1) exact: one fused pass over the whole index
    out = fused_topk(q_d, emb_d, suc_d, 0.6, 0.4, k=10)
    exact_ids = out["indices"].cpu().numpy()
    print("exact top-10:", exact_ids.tolist())

    # 2) IVF: sublinear candidate generation, exact rescoring
    ivf = build_ivf(emb, success, device=dev)
    qs = (cent[rng.integers(0, topics, size=8)]
          + (0.4 / np.sqrt(d)) * rng.normal(size=(8, d))).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    n_probe = calibrate_n_probe(ivf, emb_d, suc_d, qs,
                                target_overlap=0.95)
    run = ivf.search_fn(k=10, n_probe=n_probe)
    out = run(q_d, 0.6, 0.4, emb_d, suc_d)
    ivf_ids = out["indices"].cpu().numpy()
    frac = n_probe / ivf.n_clusters
    print(f"ivf top-10 (n_probe={n_probe}/{ivf.n_clusters}, "
          f"~{100*frac:.0f}% scanned):", ivf_ids.tolist())

    # 3) beyond memory: memmap store + int8 storage + persisted IVF
    store = SegmentStore(embed_dim=d, keep_audio=False)
    for i in range(n):
        store.add({"segment_id": f"s{i}"},
                  emb[i, 0] if success[i, 0] else None,
                  emb[i, 1] if success[i, 1] else None)
    with tempfile.TemporaryDirectory() as tdir:
        build_host_index(store, tdir, dtype="int8", device=dev)
        host = HostIndex(tdir, device=dev)
        host.build_ivf()
        s, i = host.search_ivf(q, 0.6, 0.4, k=10, n_probe=n_probe)
        print("host int8 ivf top-10:", i[s > -1e29].tolist())


if __name__ == "__main__":
    main()
