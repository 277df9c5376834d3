"""Device policy, the hand-written kernels' build, and their launch counts.

* Device: ``select_device("cuda")`` raises when no card is present; the
  port never moves itself to the CPU. The CPU is used only when a caller
  asks for it by name (the parity tests do).
* Dtype: bf16 parameters and activations on CUDA, as the JAX pipeline
  runs on its accelerator (``pipelines/whisper_pipeline.py``); float32 on
  the CPU, where the parity tests run.
* Kernels: every ``csrc/*.cu`` file is compiled with ``nvcc`` for
  ``sm_90a`` (one ``nvcc`` per source, all started together) and the
  objects are linked into one shared library with a plain C interface,
  at first use, and loaded with ``ctypes``. The build lands in
  ``_build/`` beside this file (git-ignored), keyed by a hash of the
  sources and flags, so a changed source is never served by a stale
  library.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset_counts()
COUNTS: dict[str, int] = {
    "encoder_attn_o_residual": 0,
    "single_query_attention": 0,
    "decoder_self_block": 0,
    "decoder_self_block_q": 0,
    "decoder_mlp_block": 0,
    "decoder_mlp_block_o": 0,
    "quant_matmul": 0,
    "single_query_attention_int8": 0,
    "int8_cached_attention": 0,
    "encoder_attention": 0,
    "encoder_attn_o_residual_int8": 0,
    "encoder_attn_o_residual_paired": 0,
    "encoder_attn_o_residual_ab": 0,
    "fused_scores": 0,
    "stream_read": 0,
    "cross_mlp_block": 0,
}

# called once for each device, the first time a kernel is asked for on it:
# the kernels' shared-memory limits and cluster sizes (attributes CUDA
# keeps per device) and the tensor-map encoder (K8, K5)
INIT = ("mas_attn_o_residual_int8_init",
        "mas_encoder_attention_init", "mas_encoder_block_init",
        "mas_encoder_block_f32_init",
        "mas_quant_matmul_init",
        "mas_decoder_mlp_block_init", "mas_int8_cached_attention_init",
        "mas_decoder_self_block_init", "mas_decoder_block_f32_init",
        "mas_single_query_attention_int8_init", "mas_cross_mlp_block_init")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# the device indices INIT has run on
_ready: set[int] = set()
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


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ValueError where autograd would record a call of ``kernel``:
    grad enabled and an input that requires grad. A kernel's output has
    no ``grad_fn`` (the launch goes through ctypes), so under autograd it
    would cut the graph and its inputs would train with no gradient,
    silently; the JAX kernels have no VJP either. Every wrapper of an
    encoder or decoder kernel asks this first, on every device, so the
    CPU twins refuse what the card would."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise ValueError(
            f"{kernel} has no backward: an input requires grad, and the "
            f"kernel's output would not carry it. Train through the plain "
            f"path (encode(fused_attention=False), decode_train), or call "
            f"the kernel under torch.no_grad()")


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
    block = [p, p, p, ll, ll, ll,  # q, k, v and their shared strides
             p, p, p, p,           # x, wo, bo, out
             i, i, i, i,           # B, H, T, HD
             f]                    # scale * log2(e)
    for name in ("mas_attn_o_residual", "mas_attn_o_residual_paired"):
        getattr(lib, name).argtypes = [*block, i, p]  # cluster, stream
        getattr(lib, name).restype = i
    # K1's float32 form: scale 1/8 in place of scale * log2(e); cluster,
    # the merged scratch, stream
    lib.mas_attn_o_residual_f32.argtypes = [*block, i, p, p]
    lib.mas_attn_o_residual_f32.restype = i
    for name in INIT:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.mas_encoder_block_fit.argtypes = [i, i, p]  # paired, cluster, out
    lib.mas_encoder_block_fit.restype = i
    # cluster, the division's form, stream
    lib.mas_attn_o_residual_ab.argtypes = [*block, i, i, p]
    lib.mas_attn_o_residual_ab.restype = i
    for name in ("mas_attn_o_residual_partial",
                 "mas_attn_o_residual_paired_partial"):  # K1p, K10p
        getattr(lib, name).argtypes = [
            p, p, p, ll, ll, ll,  # q, k, v and their shared strides
            p, p, p,              # merged scratch, wo rows, out (float32)
            i, i, i, i,           # B, H, T, HD_out
            f, i, p]              # scale * log2(e), cluster, stream
        getattr(lib, name).restype = i
    lib.mas_attn_o_residual_int8.argtypes = [
        p, ll, ll, ll,            # q and its strides
        p, p, p, p,               # k8, ks, v8, vs
        p, p, p, p,               # x, wo, bo, out
        i, i, i, i, i,            # B, H, T, the scales' row length, HD
        f, p]                     # scale, stream
    lib.mas_attn_o_residual_int8.restype = i
    lib.mas_attn_o_residual_int8_partial.argtypes = [
        p, ll, ll, ll,            # q and its strides
        p, p, p, p,               # k8, ks, v8, vs
        p, p,                     # wo rows, out (float32)
        i, i, i, i, i,            # B, H, T, the scales' row length, HD_out
        f, p]                     # scale, stream
    lib.mas_attn_o_residual_int8_partial.restype = i
    lib.mas_k9_division_check.argtypes = [p, p, p, ll, p]  # x, d, bad, n
    lib.mas_k9_division_check.restype = i
    lib.mas_encoder_attention.argtypes = [
        p, p, p, ll, ll, ll,      # q, k, v and their shared strides
        p,                        # out [B, T, H, 64]
        i, i, i,                  # B, H, T
        f, p]                     # scale * log2(e), stream
    lib.mas_encoder_attention.restype = i
    lib.mas_encoder_attention_f32.argtypes = \
        lib.mas_encoder_attention.argtypes       # scale in place of scale_log2
    lib.mas_encoder_attention_f32.restype = i
    lib.mas_single_query_attention.argtypes = [
        p, p, p, p, p, p,         # q, k, v, out, split scratch, counters
        i, i, i, i, i,            # B, H, T, HD, n_valid
        i, i,                     # splits, keys per split
        f, p]                     # scale, stream
    lib.mas_single_query_attention.restype = i
    lib.mas_single_query_attention_f32.argtypes = \
        lib.mas_single_query_attention.argtypes
    lib.mas_single_query_attention_f32.restype = i
    lib.mas_decoder_self_block.argtypes = [
        p, p, p, p, p, p, p, p, p, p,  # x, g1, b1, wq, bq, wk, wv, bv, wo, bo
        p, p, p,                  # k/v caches, x_out
        p, p, p, p, p,            # g2, b2, wcq, bcq, q_cross (K3-q)
        i, i, i, i,               # B, H, L, pos
        i, i, i,                  # cluster blocks, rows a tile, ring stages
        f, f, p]                  # scale, eps, stream
    lib.mas_decoder_self_block.restype = i
    # K3's float32 form: the same arguments (cluster blocks, rows a tile,
    # ring slots as its plan gives them)
    lib.mas_decoder_self_block_f32.argtypes = \
        lib.mas_decoder_self_block.argtypes
    lib.mas_decoder_self_block_f32.restype = i
    lib.mas_decoder_self_block_partial.argtypes = [
        p, p, p, p, p, p, p, p, p,  # x, g1, b1, wq, bq, wk, wv, bv, wo
        p, p, p,                  # k/v caches, out (float32)
        i, i, i, i, i,            # B, D, H, L, pos
        i, i, i,                  # cluster blocks, rows a tile, ring stages
        f, f, p]                  # scale, eps, stream
    lib.mas_decoder_self_block_partial.restype = i
    for name in ("mas_decoder_self_block_fit",
                 "mas_decoder_self_block_f32_fit",
                 "mas_int8_cached_attention_fit"):
        getattr(lib, name).argtypes = [i, i, p]  # cluster, smem, out
        getattr(lib, name).restype = i
    lib.mas_decoder_mlp_block.argtypes = [
        p, p, p, p, p, p, p,      # x, g, b, w1, b1, w2, b2
        p, p, p, p,               # attn, wco, bco, x32 (K4-o)
        p, p, p, p,               # h, partials, counters, out
        i, i, i,                  # B, D, F
        f, i, p]                  # eps, multiprocessors, stream
    lib.mas_decoder_mlp_block.restype = i
    # K4's float32 form: the same arguments (h a [D, B rounded up to 32]
    # float32 scratch, partials [F / 16, B, D])
    lib.mas_decoder_mlp_block_f32.argtypes = \
        lib.mas_decoder_mlp_block.argtypes
    lib.mas_decoder_mlp_block_f32.restype = i
    lib.mas_decoder_mlp_block_partial.argtypes = [
        p, p, p, p, p, p,         # x, g, b, w1, b1, w2
        p, p, p, p,               # h, partials, counters, out (float32)
        i, i, i,                  # B, D, F
        f, i, p]                  # eps, multiprocessors, stream
    lib.mas_decoder_mlp_block_partial.restype = i
    lib.mas_quant_matmul.argtypes = [
        p, p, p, p, p,            # x, wq, scale, bias (or null), out
        p, p,                     # split scratch, counters
        i, i, i, i,               # M, K, N, out_bf16
        i, i, i, i,               # wide, column tile, splits, steps
        p]                        # stream
    lib.mas_quant_matmul.restype = i
    lib.mas_quant_matmul_table.argtypes = [
        p, p, p, p, p,            # x, wt [N, Kp], scale, bias (or null), out
        i, i, i, i, i,            # M, K, Kp, N, out_bf16
        i, p]                     # multiprocessors, stream
    lib.mas_quant_matmul_table.restype = i
    lib.mas_single_query_attention_int8.argtypes = [
        p, p, p, p, p, p,         # q, k8, ks, v8, vs, out
        i, i, i, i,               # B, H, T, n_valid
        i, i, i,                  # heads a block, cluster blocks, keys a block
        f, p]                     # scale, stream
    lib.mas_single_query_attention_int8.restype = i
    lib.mas_single_query_attention_int8_fit.argtypes = [i, i, i, p]
    lib.mas_single_query_attention_int8_fit.restype = i
    lib.mas_int8_cached_attention.argtypes = [
        p, p, p, p, p, p,         # q, k8, ks, v8, vs, out
        i, i, i, i, i,            # B, H, T, cluster blocks, keys a block
        f, p]                     # scale, stream
    lib.mas_int8_cached_attention.restype = i
    # K5's, K6's and K7's float32 forms: x / q float32 (K5's bias float32),
    # the same arguments
    for name in ("mas_quant_matmul", "mas_quant_matmul_table",
                 "mas_single_query_attention_int8",
                 "mas_int8_cached_attention"):
        getattr(lib, name + "_f32").argtypes = getattr(lib, name).argtypes
        getattr(lib, name + "_f32").restype = i
    lib.mas_fused_scores.argtypes = [
        p, p, p,                  # q, emb, success
        f, f, f,                  # asr weight, audio weight, threshold
        p, ll, i, i,              # out, N, D, bf16 index
        p]                        # stream
    lib.mas_fused_scores.restype = i
    lib.mas_stream_read.argtypes = [
        p, p, ll, i, i,           # x, sums, rows, cols, passes
        p]                        # stream
    lib.mas_stream_read.restype = i
    lib.mas_cross_mlp_block.argtypes = [
        p, p, p, p, p, p, p,      # x, g2, b2, wcq, bcq, wco, bco
        p, p, p, p, p, p,         # g3, b3, w1, b1, w2, b2
        p, p,                     # k, v
        p, p, p, p, p, p, p,      # q1, attn, x32, h, partials, counters, out
        i, i, i, i,               # B, H, T, F
        i, i,                     # cluster blocks, keys a block
        f, f, i, p]               # scale, eps, multiprocessors, stream
    lib.mas_cross_mlp_block.restype = i
    lib.mas_cross_mlp_attention_fit.argtypes = [i, i, p]  # cluster, keys, out
    lib.mas_cross_mlp_attention_fit.restype = i


def _build(so: pathlib.Path) -> tuple[str, str]:
    """Compile each source to an object (all nvcc processes at once), then
    link them into ``so``. Returns the commands and the compilers' output;
    raises on the first failure."""
    tag = f".tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}{tag}.o" for s in _sources()]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(_sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [pr.communicate()[0] for pr in procs]
    tmp = so.with_suffix(f"{tag}.so")
    link = [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
            *map(str, objs)]
    log = "".join(outs)
    try:
        for c, pr, out in zip(cmds, procs, outs):
            if pr.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({pr.returncode}):\n{' '.join(c)}\n{out}")
        res = subprocess.run(link, capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(link)}\n{log}")
        tmp.replace(so)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "\n".join(" ".join(c) for c in [*cmds, link]), log


def _index(device) -> int:
    """The index of a CUDA ``device`` (None or an index-less device: the
    current one)."""
    if isinstance(device, int):
        return device
    if device is not None and torch.device(device).index is not None:
        return torch.device(device).index
    return torch.cuda.current_device()


def kernels(device=None) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library, and set
    ``device`` up for it (once per device index): the sm_90 check and the
    INIT functions, run with ``device`` current. ``device`` None is the
    current device.

    Called through ``launch`` by the wrappers on their CUDA path only;
    importing this module builds nothing. Raises if the card is not an
    sm_90 part or nvcc fails."""
    global _lib
    idx = _index(device)
    if idx in _ready:
        return _lib
    with _lock:
        if idx in _ready:
            return _lib
        cap = torch.cuda.get_device_capability(idx)
        if cap != (9, 0):
            raise RuntimeError(
                f"kernels are built for sm_90a (Hopper); card {idx} is "
                f"sm_{cap[0]}{cap[1]}")
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so = BUILD_DIR / f"libmas_kernels_{_source_key()}.so"
            t0 = time.perf_counter()
            cmd, log = _build(so) if not so.exists() else ("", "")
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            build_info.update(seconds=time.perf_counter() - t0,
                              library=str(so), command=cmd, log=log)
        else:
            lib = _lib
        with torch.cuda.device(idx):
            for name in INIT:
                check_launch(getattr(lib, name)(), name)
        _lib = lib
        _ready.add(idx)
        return lib


def ready_devices() -> list[int]:
    """The device indices the library has been set up on."""
    return sorted(_ready)


def launch(name: str, device: torch.device, *args) -> None:
    """Call the library's ``name`` (a kernel's launch or a plan's
    occupancy query) with ``args`` on ``device``, the device of the
    tensors it reads: the library set up for that device, the call made
    with it current (a launch runs on the current device, and the
    per-device attributes and occupancy queries read it), and a non-zero
    return raised. Every wrapper goes through here."""
    lib = kernels(device)
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args)
    check_launch(rc, name)


def check_launch(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The multiprocessors of a CUDA ``device`` (with its index set, as a
    tensor's device has), read once: the one place the kernels' launch
    plans learn the card's size."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def raw_stream(device: torch.device) -> int:
    """The current stream of a CUDA ``device`` (with its index set, as a
    tensor's device has) as a plain int, without building a Stream."""
    return torch._C._cuda_getCurrentRawStream(device.index)
