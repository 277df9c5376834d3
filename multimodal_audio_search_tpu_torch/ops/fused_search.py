"""Fused search scoring (K12).

Counterpart of ``multimodal_audio_search_tpu/ops/fused_search.py``: one
pass over the device-resident [N, 2, D] index computes, per segment,
both cosine sims against the unit query, the availability-renormalised
weight fusion, the any-positive-sim rule and the strict relevance
threshold, and writes the masked score (NEG_INF where invalid), ready
for a top-k.

``fused_scores_kernel`` launches ``csrc/fused_search.cu`` on a CUDA
tensor and runs ``fused_scores_plain`` on a CPU tensor; a launch that
fails raises. The TPU kernel pads N to its block (a Mosaic tiling rule);
K12 takes any N. As in the JAX package, the engine's searcher scores
with the plain ``index/fusion.py``; the search-at-scale tool
(``tools/torch_bench_search_scale.py``) runs K12.
"""
from __future__ import annotations

import torch

from .. import runtime
from ..index.fusion import fused_scores


def fused_scores_plain(query, emb, success, asr_weight, audio_weight, *,
                       threshold: float = 0.1) -> torch.Tensor:
    """B10 in plain PyTorch: index/fusion.py's masked scores, [N] f32."""
    return fused_scores(query, emb, success, asr_weight, audio_weight,
                        threshold)[0]


def _launch(query, emb, success, asr_weight, audio_weight, threshold):
    if emb.dim() != 3 or emb.shape[1] != 2:
        raise ValueError(f"K12 takes emb [N, 2, D], got {tuple(emb.shape)}")
    n, _, d = emb.shape
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K12 takes a float32 or bfloat16 index, got "
                        f"{emb.dtype}")
    if (d * emb.element_size()) % 16 or not emb.is_contiguous() \
            or emb.data_ptr() % 16:
        raise ValueError(f"K12 takes a contiguous 16-byte aligned index "
                         f"with 16-byte rows, got D={d} in {emb.dtype}")
    if success.dtype != torch.bool or tuple(success.shape) != (n, 2) \
            or not success.is_contiguous():
        raise ValueError(f"K12 takes success as a contiguous bool [N, 2], "
                         f"got {success.dtype} {tuple(success.shape)}")
    if tuple(query.shape) != (d,):
        raise ValueError(f"K12: query is {tuple(query.shape)}, expected "
                         f"({d},)")
    for name, a in (("success", success), ("query", query)):
        if a.device != emb.device:
            raise ValueError(f"K12: {name} on {a.device}, emb on "
                             f"{emb.device}")
    dev = emb.device
    q = query.to(torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    runtime.launch("mas_fused_scores", dev, q.data_ptr(), emb.data_ptr(),
                   success.data_ptr(), float(asr_weight),
                   float(audio_weight), float(threshold), out.data_ptr(), n,
                   d, int(emb.dtype == torch.bfloat16),
                   runtime.stream_handle(dev))
    runtime.bump("fused_scores")
    return out


def fused_scores_kernel(query, emb, success, asr_weight, audio_weight, *,
                        threshold: float = 0.1) -> torch.Tensor:
    """Masked fused scores [N] float32 of the unit ``query`` [D] over
    ``emb`` [N, 2, D] (float32 or bf16) with ``success`` [N, 2] bool and
    the query's two weights (numbers). CUDA tensors launch K12, CPU
    tensors take the plain version."""
    if emb.device.type == "cuda":
        return _launch(query, emb, success, asr_weight, audio_weight,
                       threshold)
    if emb.device.type != "cpu":
        raise ValueError(f"unsupported device {emb.device}")
    return fused_scores_plain(query, emb, success, asr_weight, audio_weight,
                              threshold=threshold)
