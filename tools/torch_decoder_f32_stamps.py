"""Phase stamps of the float32 decoder blocks (K3 f32, K3-q f32, K4 f32,
K4-o f32's K4 launch) on the card: where a call's time goes, mark by mark.

    python3 tools/torch_decoder_f32_stamps.py [--out chiprun_out]

It copies this checkout's ``multimodal_audio_search_tpu_torch`` into the
git-ignored ``multimodal_audio_search_tpu_torch/_build/f32stamped/``,
defines in the copy's ``csrc/decoder_block_f32.cu`` the ``F32_STAMP(i)``
marks the kernels carry (empty in the package) as a ``%globaltimer``
stamp a block, builds the copy and runs one call of each kernel at B=32
(K3 at L=68, pos 67) at both chip_smoke.DEC_WIDTHS, queued behind a sleep
kernel after a warm-up (with ``--cold`` L2 emptied just before it). One
JSON line per case: the blocks' median SM
clock (clock64 cycles over %globaltimer time), and for every mark the
blocks' times from the first block's first mark (microseconds; minimum,
median, maximum), and the span to the last block's last mark. A mark
records its first pass only (a bit in shared memory; the stamps are
stores alone). K3's marks: 0 entry, 1 q/k/v products, 2 their pair sum,
3 past barrier 1, 4 attention, 5 past barrier 2, 6 o-projection
products, 7 its pair sum, 8 past barrier 3 (K3-q), 9 LN2 + Wcq products
(K3-q), 10 exit. K4's: 0 entry, 1 fc1, 2 the cluster's u whole, 3 fc2, 4
partials written, 5 past the barrier, 6 the outputs, 7 exit. Both, in
the first product (K3's q/k/v, K4's fc1): 12 the layer norm begins, 13
its rows normed, 14 a tile landed (the first), 15 the last tile's
products. (K4-o's row projection, launched first, is not stamped.)
Needs a CUDA card.
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
COPY = PKG / "_build" / "f32stamped"
NMARK = 16
STAMPS = r'''
__device__ unsigned long long f32_stamps[1024][16];
__device__ long long f32_clocks[1024][16];
__shared__ unsigned f32_seen;
// thread 0 stamps a mark's first pass (a bit in shared memory says
// which marks have passed; mark 0, the kernel's entry, clears it): plain
// stores only, so the stamps do not hold the block back
#define F32_STAMP(i)                                             \
  if (threadIdx.x == 0) {                                        \
    if ((i) == 0) f32_seen = 0;                                  \
    if (!(f32_seen & (1u << (i)))) {                             \
      unsigned long long t_;                                     \
      asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_));      \
      f32_seen |= 1u << (i);                                     \
      f32_stamps[blockIdx.x][i] = t_;                            \
      f32_clocks[blockIdx.x][i] = clock64();                     \
    }                                                            \
  }
'''
READ = '''
extern "C" int mas_f32_stamps(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, f32_stamps, (size_t)n * 16 * 8);
}
extern "C" int mas_f32_clocks(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, f32_clocks, (size_t)n * 16 * 8);
}
extern "C" int mas_f32_stamps_clear(void) {
  static unsigned long long zero[1024][16];
  return (int)cudaMemcpyToSymbol(f32_stamps, zero, sizeof(zero));
}
'''


def stamped_copy() -> pathlib.Path:
    """The package copied into COPY, its float32 decoder kernels
    stamped."""
    if COPY.exists():
        shutil.rmtree(COPY)
    dst = COPY / PKG.name
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    src = dst / "csrc" / "decoder_block_f32.cu"
    text = src.read_text()
    if "F32_STAMP(0)" not in text or "#ifndef F32_STAMP" not in text:
        raise RuntimeError("decoder_block_f32.cu carries no F32_STAMP marks")
    src.write_text(STAMPS + text + READ)
    return COPY


def sm_mhz(buf: np.ndarray, clk: np.ndarray) -> float:
    """The blocks' median SM clock between their first and last marks:
    clock64 cycles over %globaltimer nanoseconds."""
    rates = []
    for t, c in zip(buf, clk):
        i = np.flatnonzero(t)
        a, b = i[np.argmin(t[i])], i[np.argmax(t[i])]
        if t[b] > t[a]:
            rates.append((c[b] - c[a]) / float(t[b] - t[a]) * 1e3)
    return float(np.median(rates)) if rates else float("nan")


def summary(buf: np.ndarray) -> dict:
    """Per mark: the blocks' stamps from the first block's first mark."""
    t = buf.astype(np.float64)
    t[buf == 0] = np.nan
    t0 = np.nanmin(t)
    r = (t - t0) / 1e3
    marks = {}
    for i in range(NMARK):
        col = r[:, i]
        if np.all(np.isnan(col)):
            continue
        marks[str(i)] = [float(np.nanmin(col)), float(np.nanmedian(col)),
                         float(np.nanmax(col))]
    return {"span_us": float(np.nanmax(r)), "marks_us_min_med_max": marks}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--cold", action="store_true",
                    help="empty L2 before the stamped call (a 128 MB "
                         "buffer written), as an engine's decode step finds "
                         "a layer's float32 weights")
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
    lib.mas_f32_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mas_f32_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mas_f32_stamps_clear.argtypes = []
    rows = [{"card": cs.card_line(), "torch": torch.__version__}]
    print(json.dumps(rows[0]), flush=True)
    gen = torch.Generator().manual_seed(0)
    f32 = torch.float32
    flush = torch.empty(32 << 20, dtype=f32, device="cuda") if args.cold \
        else None
    b, l, pos = 32, 68, 67
    for label, d, heads, f in cs.DEC_WIDTHS:
        x, selfw, tail, kc, vc = cs.k3_inputs(gen, b, l, d, dtype=f32)
        xm, mlp, head = cs.k4_inputs(gen, b, d, f, dtype=f32)
        calls = (
            ("K3 f32", lambda: DB.fused_self_block(x, *selfw, kc, vc, pos,
                                                   heads=heads)),
            ("K3-q f32", lambda: DB.fused_self_block_q(
                x, *selfw, *tail, kc, vc, pos, heads=heads)),
            ("K4 f32", lambda: DB.fused_mlp_block(xm, *mlp)),
            ("K4-o f32", lambda: DB.fused_mlp_block_o(xm, *head, *mlp)))
        for name, call in calls:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            runtime.check_launch(lib.mas_f32_stamps_clear(),
                                 "mas_f32_stamps_clear")
            torch.cuda._sleep(20_000_000)
            if flush is not None:
                flush.fill_(1.0)
            call()
            torch.cuda.synchronize()
            buf = np.zeros((1024, NMARK), dtype=np.uint64)
            runtime.check_launch(lib.mas_f32_stamps(buf.ctypes.data, 1024),
                                 "mas_f32_stamps")
            clk = np.zeros((1024, NMARK), dtype=np.int64)
            runtime.check_launch(lib.mas_f32_clocks(clk.ctypes.data, 1024),
                                 "mas_f32_clocks")
            used = buf[:, 0] != 0
            row = {"kernel": name, "shape": f"{label} B={b} D={d}",
                   "l2": "emptied" if args.cold else "warm",
                   "blocks": int(used.sum()),
                   "sm_mhz": sm_mhz(buf[used], clk[used]),
                   **summary(buf[used])}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "decoder_f32_stamps.jsonl"),
                  "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
