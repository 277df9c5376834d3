"""The mesh across the cards of one host, and across processes.

    python3 tools/torch_mesh_cards.py                 # every visible card
    python3 tools/torch_mesh_cards.py --device cpu --cards 4 --procs 4
    python3 tools/torch_mesh_cards.py --parts tp      # the model axis only

chip_smoke.py's ``[mesh]`` phase names one card several times; this tool
puts each data shard on a card of its own (run it on a host with several
cards, e.g. four):

1. one process, the cards as the mesh's data axis:
   chip_smoke.mesh_search_check over the ``[ann]`` data (``--rows``
   segments of MiniLM width, 16 queries; exact and IVF search = the
   unsharded scan on the first card, the two-stage merges in a group of
   one process), chip_smoke.mesh_ingest_check of the default config on a
   25 s clip (one chunk a card, against the unsplit engine on the first
   card), and the device indices the kernel library was set up on,
   which must be every card;
2. ``--procs`` processes, each holding cards / procs of the cards (its
   own in a FileStore group: NCCL, Gloo for CPU entries): the two-stage
   hierarchical top-k and IVF over (dcn procs, data cards / procs) =
   the flat exact scan on each process's first card, for every query;
3. the mesh's model axis (tensor parallelism) across cards, in one
   process: chip_smoke.mesh_ingest_check with a model axis of 2 over the
   first two cards, (dp, mp) = (1, 2), and, where the path names it,
   over four, (2, 2), under each of chip_smoke.TP_PATHS (the default
   config and fast_lossless at both; parity, "v2", the int8 decoder with
   K6 and with K7, the int8 and paired encoders at (1, 2)), against
   the unsplit engine on the first card: model_sum's copies go from card
   to card, the launch counts are every launch once a rank, the texts
   equal outside the logits' margin and the top-10 identical; the kernel
   library must have been set up on every card.

``--parts`` picks parts by name (data, procs, tp; all by default).

On CPU entries (``--device cpu``: a rehearsal) the ingest check runs the
test presets, as tests/test_torch_engine_mesh.py does. Prints one JSON
line a step, the cards' ``nvidia-smi`` lines first; raises on a failed
check.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W = (0.6, 0.4)
K = 10
QUERIES = 16


def emit(**kv) -> None:
    print(json.dumps(kv, default=str), flush=True)


def cards() -> list[str]:
    """nvidia-smi's name and power limit of every card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def ingest_config(device: str):
    """The default config on cards; the test presets on CPU entries."""
    from multimodal_audio_search_tpu_torch import config as C
    if device == "cuda":
        return C.EngineConfig()
    return C.EngineConfig(
        asr_model=C.ModelSpec(family="whisper", preset="test"),
        caption_model=C.ModelSpec(family="whisper", preset="test"),
        text_embedder=C.ModelSpec(family="minilm", preset="test"),
        embed_dim=64, ingest_batch=16, short_context=True,
        segment=C.SegmentConfig(segment_seconds=2.0,
                                min_segment_seconds=0.5),
        asr_decode=C.DecodeConfig(max_new_tokens=6),
        caption_decode=C.DecodeConfig(max_new_tokens=6))


def devices_of(device: str, n: int) -> list[torch.device]:
    if device == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")] * n


def one_process(args, card: str) -> None:
    """Part 1: every card in this process."""
    import chip_smoke as C
    from multimodal_audio_search_tpu_torch import runtime
    devs = devices_of(args.device, args.cards)
    tool = C.load_tool("torch_bench_ivf")
    t0 = time.perf_counter()
    emb, success, qs = tool.make_data(args.rows, queries=QUERIES)
    emit(step="data", rows=len(emb), seconds=time.perf_counter() - t0)
    C.mesh_search_check(card, emb, success, qs, devs)
    del emb, success
    wave = C.make_audio(25, np.random.default_rng(0))
    C.mesh_ingest_check(card, wave, ingest_config(args.device), devs)
    ready = runtime.ready_devices()
    emit(step="kernel library set up on", devices=ready)
    if args.device == "cuda" and ready != list(range(args.cards)):
        raise AssertionError(f"the kernel library was set up on {ready}, "
                             f"not on every one of {args.cards} cards")


def tensor_parallel(args, card: str) -> None:
    """Part 3: the model axis across the cards, in this process."""
    import chip_smoke as C
    from multimodal_audio_search_tpu_torch import runtime
    devs = devices_of(args.device, args.cards)
    wave = C.make_audio(25, np.random.default_rng(0))
    for label, profile, fused, int8, enc, dps in C.TP_PATHS:
        cfg = C.tp_config(label, profile, fused, int8, enc,
                          base=ingest_config(args.device))
        whole = None
        for n in (2 * dp for dp in dps):
            if n > len(devs):
                break
            t0 = time.perf_counter()
            whole = C.mesh_ingest_check(card, wave, cfg, devs[:n], mp=2,
                                        whole=whole)
            emit(step="tensor parallel", config=label, cards=n,
                 mesh={"data": n // 2, "model": 2},
                 seconds=time.perf_counter() - t0,
                 launches=whole["launches"])
    ready = runtime.ready_devices()
    emit(step="kernel library set up on", devices=ready)
    if args.device == "cuda" and ready != list(range(min(4, args.cards))):
        raise AssertionError(f"the kernel library was set up on {ready}, "
                             f"not on every card of the meshes")


def rank_main(args) -> None:
    """Part 2, one process: its cards' shards of the index, the two
    stages over the group, against the flat scan."""
    import chip_smoke as C
    import torch.distributed as dist
    from multimodal_audio_search_tpu_torch.index.fusion import fused_topk
    from multimodal_audio_search_tpu_torch.index.ivf import build_ivf_sharded
    from multimodal_audio_search_tpu_torch.parallel import distributed as D
    per = args.cards // args.world
    mine = devices_of(args.device, args.cards)[args.rank * per:
                                               (args.rank + 1) * per]
    if args.device == "cuda":
        torch.cuda.set_device(mine[0])
    emb, success, qs = C.load_tool("torch_bench_ivf").make_data(
        args.rows, queries=QUERIES)
    if not D.initialize(init_method=f"file://{args.store}",
                        world_size=args.world, rank=args.rank,
                        device=args.device):
        raise RuntimeError("no process group started")
    try:
        mesh = D.make_dcn_mesh(ici_data=per, devices=mine)
        e, o = D.shard_index_dcn(mesh, emb, success)
        layout = build_ivf_sharded(emb, success, args.world * per,
                                   device=mine[0])
        placed = layout.place(mesh.data_devices(), first=args.rank * per)
        topk = D.hierarchical_sharded_topk(mesh, k=K)
        ivf = D.hierarchical_sharded_ivf(mesh, layout, k=K,
                                         n_probe=layout.n_clusters)
        e_full = torch.from_numpy(emb).to(mine[0])
        ok_full = torch.from_numpy(success).to(mine[0])
        errs = []
        for qi, q in enumerate(torch.from_numpy(qs).to(mine[0])):
            ref = fused_topk(q, e_full, ok_full, *W, k=K)
            keep = ref["scores"] > -1e29
            for name, (s, i) in (("top-k", topk(q, e, o, *W)),
                                 ("IVF", ivf(q, *placed, e, o, *W))):
                if not torch.equal(i[keep].cpu(),
                                   ref["indices"][keep].cpu()):
                    raise AssertionError(
                        f"rank {args.rank} {name} q{qi}: {i.tolist()} != "
                        f"{ref['indices'].tolist()}")
                errs.append(float((s[keep] - ref["scores"][keep]).abs()
                                  .max()))
        if max(errs) > C.K12_ATOL:
            raise AssertionError(f"rank {args.rank}: score err "
                                 f"{max(errs):.3e}")
        print("RESULT " + json.dumps({
            "rank": args.rank, "backend": dist.get_backend(),
            "world": dist.get_world_size(), "mesh": mesh.shape,
            "devices": [str(d) for d in mesh.data_devices()],
            "rows": [int(x.shape[0]) for x in e], "queries": len(qs),
            "max_score_err": max(errs)}), flush=True)
    finally:
        dist.destroy_process_group()


def processes(args) -> None:
    """Part 2: spawn the ranks and read their results."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--device", args.device, "--cards", str(args.cards),
             "--rows", str(args.proc_rows), "--rank", str(r),
             "--world", str(args.procs), "--store", f"{tmp}/pg"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(args.procs)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=args.timeout)
                if p.returncode != 0:
                    raise AssertionError(f"rank failed ({p.returncode}):\n"
                                         f"{err[-3000:]}")
                outs.append(json.loads(next(
                    ln for ln in out.splitlines()
                    if ln.startswith("RESULT "))[len("RESULT "):]))
        finally:
            for p in procs:
                p.kill()
        emit(step="processes", seconds=time.perf_counter() - t0, ranks=outs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cards", type=int, default=None,
                    help="data devices (default: every visible card)")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--rows", type=int, default=None,
                    help="index rows (default: 1M on cards, 4096 on CPU)")
    ap.add_argument("--proc-rows", type=int, default=None,
                    help="index rows of part 2 (default: 262144 on "
                         "cards, 4096 on CPU)")
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--parts", default="data,procs,tp",
                    help="comma-separated: data, procs, tp")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 4))
    if args.device == "cuda":
        from multimodal_audio_search_tpu_torch import runtime
        runtime.select_device("cuda")
        args.cards = args.cards or torch.cuda.device_count()
    elif args.cards is None:
        args.cards = 4
    cuda = args.device == "cuda"
    args.rows = args.rows or (1_000_000 if cuda else 4096)
    args.proc_rows = args.proc_rows or (262_144 if cuda else 4096)
    if args.rank is not None:
        rank_main(args)
        return 0
    if args.cards % args.procs:
        raise SystemExit(f"{args.cards} cards do not divide into "
                         f"{args.procs} processes")
    card_lines = cards() if cuda else ["cpu"]
    for line in card_lines:
        print(line, flush=True)
    parts = args.parts.split(",")
    if "data" in parts:
        one_process(args, card_lines[0])
    if "procs" in parts:
        processes(args)
    if "tp" in parts:
        tensor_parallel(args, card_lines[0])
    emit(ok=True, cards=args.cards, procs=args.procs, parts=parts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
