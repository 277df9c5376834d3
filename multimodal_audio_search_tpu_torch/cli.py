"""Command-line interface.

Counterpart of ``multimodal_audio_search_tpu/cli.py``: the same
subcommands over the port's engine, which runs on the CUDA card.

    M=multimodal_audio_search_tpu_torch
    python -m $M ingest a.wav b.wav --index ./idx
    python -m $M search "upbeat music" --index ./idx
    python -m $M search "rain" --strategy fixed_5050 --index ./idx
    python -m $M delete a.wav --index ./idx
    python -m $M serve --port 8527 --index ./idx
    python -m $M stats --index ./idx
"""
from __future__ import annotations

import argparse
import json
import sys


def _engine(args):
    from . import AudioSearchEngine
    from .config import config_from_env
    eng = AudioSearchEngine(cfg=config_from_env())
    if args.index:
        import pathlib
        root = pathlib.Path(args.index)
        # any persisted layout: compressed npz, raw-mmap, or sharded
        if any((root / f).exists() for f in
               ("embeddings.npz", "emb.npy", "manifest.json")):
            eng.load_index(args.index)
    return eng


def main(argv: list[str] | None = None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    # SUPPRESS: the option is accepted both before and after the
    # subcommand; a subparser's default must not clobber a value the
    # main parser already bound (argparse sets subparser defaults
    # unconditionally on this Python)
    common.add_argument("--index", default=argparse.SUPPRESS,
                        help="index directory to load/save")
    p = argparse.ArgumentParser(prog="multimodal_audio_search_tpu_torch",
                                parents=[common])
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("ingest", parents=[common],
                        help="process audio files into the index")
    pi.add_argument("files", nargs="+")

    ps = sub.add_parser("search", parents=[common], help="fusion search")
    ps.add_argument("query")
    ps.add_argument("-k", type=int, default=10)
    ps.add_argument("--strategy", default="fusion",
                    help="fusion (default) | fixed_5050 | "
                         "dynamic_selection | adaptive_weighting | "
                         "audio_only | compare_all")

    pd = sub.add_parser("delete", parents=[common],
                        help="remove one source's segments from the index")
    pd.add_argument("source")

    pv = sub.add_parser("serve", parents=[common],
                        help="run the HTTP service + UI")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8527)

    sub.add_parser("stats", parents=[common], help="print stats JSON")

    args = p.parse_args(argv)
    args.index = getattr(args, "index", None)

    if args.cmd == "serve":
        from .service.server import serve
        serve(_engine(args), host=args.host, port=args.port, warmup=True)
        return 0

    eng = _engine(args)
    if args.cmd == "ingest":
        segs = eng.ingest_many(args.files, source_names=args.files)
        print(f"{len(args.files)} file(s): {len(segs)} segments "
              f"(index total {len(eng.store)})")
        if args.index:
            eng.save_index(args.index)
            print(f"saved index to {args.index}")
    elif args.cmd == "search":
        if args.strategy != "fusion":
            results, info = eng.search_strategy(
                args.query, args.strategy, args.k)
        else:
            results, info = eng.search(args.query, args.k)
        print(json.dumps({
            "weight_info": info,
            "results": [
                {k: v for k, v in r.items()
                 if k not in ("audio_data",)} for r in results],
        }, indent=2, default=str))
    elif args.cmd == "delete":
        removed = eng.delete_source(args.source)
        print(f"removed {removed} segment(s) "
              f"(index total {len(eng.store)})")
        if args.index and removed:
            eng.save_index(args.index)
            print(f"saved index to {args.index}")
    elif args.cmd == "stats":
        print(eng.export_stats_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
