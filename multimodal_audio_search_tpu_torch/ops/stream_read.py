"""Streaming read of a bf16 slab (K13): the device-memory rate that the
search's roofline share divides by (``utils/calibrate.py``).

Counterpart of the Pallas kernel in ``bench.py::calibrate`` (``rd``): the
TPU kernel's grid walks ``passes`` times over a [rows * n_chunk, cols]
bf16 slab, adds each [rows, cols] block's column sums into a float32
accumulator and keeps the first 128 columns, so its output is [1, 128]
= passes x the column sums of x[:, :128]. It sums all ``cols`` columns
before it keeps 128, so every byte is read; K13 does the same.

``stream_read_sums`` returns all ``cols`` sums (the card check compares
every one of them: a kernel reading only the first 128 columns would
report four times the real rate at 512 columns and still return the
right [1, 128]); ``stream_read`` keeps the first 128, as the TPU kernel
does. On a CUDA tensor they launch ``csrc/stream_read.cu``; on a CPU
tensor they run the plain version.
"""
from __future__ import annotations

import torch

from .. import runtime

KEEP = 128   # columns the TPU kernel keeps


def stream_read_sums_plain(x: torch.Tensor, passes: int) -> torch.Tensor:
    """[cols] float32: ``passes`` x the column sums of ``x``, reading x
    once per pass as the kernel does."""
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for _ in range(passes):
        out += x.float().sum(dim=0)
    return out


def _launch(x: torch.Tensor, passes: int) -> torch.Tensor:
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise TypeError(f"K13 takes a bf16 [rows, cols] slab, got {x.dtype} "
                        f"{tuple(x.shape)}")
    rows, cols = x.shape
    if cols % 8 or not 8 <= cols <= 2048 or not x.is_contiguous() \
            or x.data_ptr() % 16 or rows < 1 or passes < 1:
        raise ValueError(f"K13 takes a contiguous 16-byte aligned slab with "
                         f"cols % 8 == 0, 8 <= cols <= 2048, rows >= 1 and "
                         f"passes >= 1: {tuple(x.shape)}, passes={passes}")
    sums = torch.zeros(cols, dtype=torch.float32, device=x.device)
    runtime.launch("mas_stream_read", x.device, x.data_ptr(),
                   sums.data_ptr(), rows, cols, int(passes),
                   runtime.stream_handle(x.device))
    runtime.bump("stream_read")
    return sums


def stream_read_sums(x: torch.Tensor, passes: int) -> torch.Tensor:
    """[cols] float32 column sums of ``x`` times ``passes``; a CUDA tensor
    launches K13 (reading x ``passes`` times), a CPU tensor takes the
    plain version."""
    if x.device.type == "cuda":
        return _launch(x, passes)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return stream_read_sums_plain(x, passes)


def stream_read(x: torch.Tensor, passes: int) -> torch.Tensor:
    """The TPU kernel's function: [1, 128] float32, ``passes`` x the column
    sums of x[:, :128], every column read."""
    return stream_read_sums(x, passes)[:KEEP].reshape(1, KEEP)


def stream_read_plain(x: torch.Tensor, passes: int) -> torch.Tensor:
    """B11 in plain PyTorch: the [1, 128] the TPU kernel returns."""
    return stream_read_sums_plain(x, passes)[:KEEP].reshape(1, KEEP)
