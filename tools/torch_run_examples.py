"""Run the PyTorch port's examples (examples/torch_0*.py), each in its own
process, and print one JSON line an example: its exit code, wall
seconds and the lines it printed.

    python3 tools/torch_run_examples.py [--device cpu] [--only 01,04]
        [--steps N]

``--device`` is passed to every example (the card unless cpu is named);
``--steps`` to torch_04_training.py only.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def examples(only: list[str] | None = None) -> list[str]:
    paths = sorted(glob.glob(os.path.join(REPO, "examples", "torch_0*.py")))
    return [p for p in paths
            if not only or os.path.basename(p)[6:8] in only]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default=None,
                    help="comma-separated example numbers, e.g. 01,04")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    rc_all = 0
    for path in examples(args.only.split(",") if args.only else None):
        cmd = [sys.executable, path, "--device", args.device]
        if args.steps is not None and "training" in path:
            cmd += ["--steps", str(args.steps)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=args.timeout, cwd=REPO)
        wall = time.perf_counter() - t0
        rc_all = rc_all or p.returncode
        print(json.dumps({"example": os.path.basename(path),
                          "returncode": p.returncode, "seconds": wall,
                          "stdout": p.stdout.splitlines(),
                          "stderr_tail": p.stderr[-1500:]
                          if p.returncode else ""}), flush=True)
    return rc_all


if __name__ == "__main__":
    sys.exit(main())
