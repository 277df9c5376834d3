"""Device policy, the hand-written kernels' build, and their launch counts.

* Device: ``select_device("cuda")`` raises when no card is present; the
  port never moves itself to the CPU. The CPU is used only when a caller
  asks for it by name (the parity tests do).
* Dtype: bf16 parameters and activations on CUDA, as the JAX pipeline
  runs on its accelerator (``pipelines/whisper_pipeline.py``); float32 on
  the CPU, where the parity tests run.
* Kernels: every ``csrc/*.cu`` file is compiled with ``nvcc`` for
  ``sm_90a`` into one shared library with a plain C interface, at first
  use, and loaded with ``ctypes``. The build lands in ``_build/`` beside
  this file (git-ignored), keyed by a hash of the sources and flags, so a
  changed source is never served by a stale library.
* Counts: each kernel wrapper adds one to its entry in ``COUNTS`` where
  it launches, and nowhere else; a run reads them to show which kernels
  the main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset_counts()
COUNTS: dict[str, int] = {
    "encoder_attn_o_residual": 0,
    "single_query_attention": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# filled by the first build: {"seconds", "library", "command", "log"}
build_info: dict = {}


def select_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device``; raise if it names CUDA and there is no card.

    Selecting CUDA turns TF32 off for float32 matmuls and convolutions
    (PyTorch's cuDNN default is TF32), so float32 work on the card keeps
    full float32 precision, as the JAX package's float32 paths do."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def bump(name: str) -> None:
    COUNTS[name] += 1


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for c in cands:
        p = pathlib.Path(c) / "bin" / "nvcc"
        if c and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.mas_attn_o_residual.argtypes = [
        p, p, p, ll, ll, ll,      # q, k, v and their shared strides
        p, p, p, p,               # x, wo, bo, out
        i, i, i, i,               # B, H, T, HD
        f, p]                     # scale * log2(e), stream
    lib.mas_attn_o_residual.restype = i
    lib.mas_attn_o_residual_init.argtypes = []
    lib.mas_attn_o_residual_init.restype = i
    lib.mas_single_query_attention.argtypes = [
        p, p, p, p,               # q, k, v, out
        i, i, i, i, i,            # B, H, T, HD, n_valid
        f, p]                     # scale, stream
    lib.mas_single_query_attention.restype = i


def kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library.

    Called by the wrappers on their CUDA path only; importing this module
    builds nothing. Raises if the card is not an sm_90 part or nvcc
    fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        cap = torch.cuda.get_device_capability()
        if cap != (9, 0):
            raise RuntimeError(
                f"kernels are built for sm_90a (Hopper); this card is "
                f"sm_{cap[0]}{cap[1]}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libmas_kernels_{_source_key()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(so),
               *[str(s) for s in _sources()]]
        t0 = time.perf_counter()
        log = ""
        if not so.exists():
            tmp = so.with_suffix(f".tmp{os.getpid()}.so")
            cmd[cmd.index(str(so))] = str(tmp)
            res = subprocess.run(cmd, capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                    f"{log}")
            tmp.replace(so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        check_launch(lib.mas_attn_o_residual_init(),
                     "mas_attn_o_residual_init")
        build_info.update(seconds=time.perf_counter() - t0, library=str(so),
                          command=" ".join(cmd), log=log)
        _lib = lib
        return lib


def check_launch(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
