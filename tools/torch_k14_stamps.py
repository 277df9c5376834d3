"""Phase stamps of K14's attention (cross_attention_split_kernel) on the
card: where a call's time goes, block by block.

    python3 tools/torch_k14_stamps.py [--clusters 2,4] [--out chiprun_out]

It copies this checkout's ``multimodal_audio_search_tpu_torch`` into the
git-ignored ``multimodal_audio_search_tpu_torch/_build/stamped/``, adds
to the copy's ``csrc/decoder_block.cu`` a ``%globaltimer`` stamp a block
at entry, when q1 is ready, when the K phase ends, when the max is
exchanged, when the V prefix has landed, when p . V ends and at exit
(and the block's SM), builds the copy and runs one K14 call at B=32,
T=1500 and both chip_smoke.DEC_WIDTHS on each cluster size, queued
behind a sleep kernel after a warm-up. One JSON line per case: the span
from the first block's entry, when q1 was ready, the blocks' entries and
exits (percentiles), each phase's median and 90th percentile, the SMs
used and the blocks resident on an SM on average. It raises if the
kernel's source no longer has the lines it stamps. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import pathlib
import shutil
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "multimodal_audio_search_tpu_torch"
COPY = PKG / "_build" / "stamped"
PHASES = ("wait_q", "k_phase", "exchange", "prefix_wait", "pv", "tail")
STAMPS = r'''
__device__ unsigned long long x_stamps[8192][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define XSTAMP(i) \
  if (threadIdx.x == 0) \
    x_stamps[blockIdx.y * gridDim.x + blockIdx.x][i] = gtime();
'''
READ = '''
extern "C" int mas_x_stamps(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, x_stamps, (size_t)n * 8 * 8);
}
'''
KERNEL = "__global__ void __launch_bounds__(X_NT, 4) cross_attention_split"
# (a line of the kernel, the stamp that follows it; None: BEFORE's stamp
# goes before it)
AFTER = (
    ("  const int nbox = (np + R - 1) / R;\n",
     "  XSTAMP(0)\n  if (threadIdx.x == 0) {\n    unsigned smid;\n"
     "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(smid));\n"
     "    x_stamps[blockIdx.y * gridDim.x + blockIdx.x][7] = smid;\n  }\n"),
    ("  grid_dependency_wait();  // q1: the q-projection has finished\n",
     "  XSTAMP(1)\n"),
    ("  // 2. the cluster's max (its barriers publish sS too)\n", None),
    ("  const float m = s_gm;\n", None),
    ("  mbar_wait(&vbar, 0);\n", "  XSTAMP(4)\n"),
    ("  __syncthreads();  // the prefix and the logits are read: they take "
     "sums\n", None),
)
BEFORE = {2: 2, 3: 3, 5: 5}  # AFTER entries stamped before their line


def stamped_copy() -> pathlib.Path:
    """The package copied into COPY, its K14 attention stamped."""
    if COPY.exists():
        shutil.rmtree(COPY)
    dst = COPY / PKG.name
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    src = dst / "csrc" / "decoder_block.cu"
    text = src.read_text()
    if text.count(KERNEL) != 1:
        raise RuntimeError("K14's attention kernel not found")
    start = text.index(KERNEL)
    head, body = text[:start], text[start:]
    end = body.index("\n}\n") + 3  # the kernel's closing brace
    kern, rest = body[:end], body[end:]
    for i, (line, stamp) in enumerate(AFTER):
        if kern.count(line) != 1:
            raise RuntimeError(f"K14's attention changed: {line.strip()}")
        new = f"  XSTAMP({BEFORE[i]})\n{line}" if i in BEFORE \
            else line + stamp
        kern = kern.replace(line, new)
    kern = kern[:-2] + "  XSTAMP(6)\n}\n"  # exit, after the last sync
    src.write_text(head + STAMPS + kern + rest + READ)
    return COPY


def summary(buf: np.ndarray) -> dict:
    t = buf[:, :7].astype(np.int64)
    r = (t - t[:, 0].min()) / 1e3  # microseconds from the first entry
    ph = np.diff(r, axis=1)
    sm = buf[:, 7].astype(int)
    life = r[:, 6] - r[:, 0]
    span = float(r[:, 6].max())
    per_sm = np.bincount(sm, weights=life)
    pct = (0, 25, 50, 75, 100)
    return {
        "span_us": span,
        "q_ready_us": [float(np.percentile(r[:, 1], p))
                       for p in (0, 50, 100)],
        "entry_us_pct": [float(np.percentile(r[:, 0], p)) for p in pct],
        "exit_us_pct": [float(np.percentile(r[:, 6], p)) for p in pct],
        "phase_median_us": {k: float(np.median(ph[:, i]))
                            for i, k in enumerate(PHASES)},
        "phase_p90_us": {k: float(np.percentile(ph[:, i], 90))
                         for i, k in enumerate(PHASES)},
        "life_median_us": float(np.median(life)),
        "sms_used": int((np.bincount(sm) > 0).sum()),
        "resident_avg": float(per_sm.sum() / per_sm.size / span),
        "entries_per_5us": np.histogram(
            r[:, 0], bins=np.arange(0, span + 5, 5))[0].tolist()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", default="2")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(stamped_copy()))
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    runtime.select_device("cuda")
    lib = runtime.kernels()
    lib.mas_x_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    rows = [{"card": cs.card_line(), "torch": torch.__version__}]
    print(json.dumps(rows[0]), flush=True)
    gen = torch.Generator().manual_seed(0)
    b, t = 32, 1500
    for label, d, heads, f in cs.DEC_WIDTHS:
        a = cs.k14_inputs(gen, b, t, d, f)
        for c in (int(x) for x in args.clusters.split(",")):
            def call():
                return DB._launch_cross_mlp(*a, heads, 1e-5, cluster=c)
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            torch.cuda._sleep(20_000_000)
            call()
            torch.cuda.synchronize()
            n = b * heads * c
            buf = np.zeros((n, 8), dtype=np.uint64)
            runtime.check_launch(lib.mas_x_stamps(buf.ctypes.data, n),
                                 "mas_x_stamps")
            row = {"shape": f"{label} B={b} T={t} H={heads}", "cluster": c,
                   "blocks": n, **summary(buf)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "k14_stamps.jsonl"), "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
