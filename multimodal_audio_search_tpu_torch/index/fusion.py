"""Batched weighted-fusion scoring (the search hot path), in plain torch.

Counterpart of ``multimodal_audio_search_tpu/index/fusion.py``:

    sims[N, 2]  = emb[N, 2, D] @ q[D]          (embeddings pre-L2-normalized)
    eff[N, 2]   = weights * success, renormalized per row
    score[N]    = sum(eff * sims, -1)
    valid[N]    = any(sims > 0) & (total_weight > 0) & (score > threshold)
    top-k over score masked by valid

A query may carry leading batch dims (q [Q, D] with weights [Q]): the
index is then read once for all Q queries, as the JAX package's vmap of
``fused_topk_impl`` reads it (``FusionSearcher.search_batch``). The
Pallas version of the scoring (B10) is ``ops/fused_search.py`` (K12).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12):
    """L2-normalize along ``axis`` (zero vectors stay zero)."""
    n = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=eps)


def _weights(asr_weight, audio_weight, device) -> torch.Tensor:
    """[..., 2] float32 (asr, audio) from numbers or [Q] tensors."""
    return torch.stack([torch.as_tensor(w, dtype=torch.float32,
                                        device=device)
                        for w in (asr_weight, audio_weight)], dim=-1)


def fused_scores(query_emb, emb, success, asr_weight, audio_weight,
                 threshold: float = 0.1):
    """Return (score[..., N] with invalid rows at NEG_INF, valid bool)."""
    q = query_emb.float()
    sims = torch.einsum("npd,...d->...np", emb.float(), q)     # [..., N, 2]
    w = _weights(asr_weight, audio_weight, emb.device)
    eff = w[..., None, :] * success.float()                   # [..., N, 2]
    total = eff.sum(dim=-1)                                   # [..., N]
    eff = eff / total.clamp(min=1e-30)[..., None]
    score = (eff * sims).sum(dim=-1)                          # [..., N]
    any_pos = (sims > 0.0).any(dim=-1)
    valid = any_pos & (total > 0.0) & (score > threshold)
    return torch.where(valid, score, torch.full_like(score, NEG_INF)), valid


def fused_topk(query_emb, emb, success, asr_weight, audio_weight, *,
               k: int = 10, threshold: float = 0.1) -> dict[str, torch.Tensor]:
    """One-shot fused search over the whole index: top-k indices/scores
    plus per-hit sims and effective weights. Invalid rows score NEG_INF;
    callers drop them host-side. Leading query dims carry through."""
    masked, valid = fused_scores(query_emb, emb, success, asr_weight,
                                 audio_weight, threshold)
    k = min(k, masked.shape[-1])
    # a stable descending sort: equal scores keep index order, the tie
    # rule of lax.top_k (torch.topk leaves ties unordered)
    top_scores, top_idx = torch.sort(masked, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    sims = torch.einsum("...kpd,...d->...kp", emb[top_idx].float(),
                        query_emb.float())
    w = _weights(asr_weight, audio_weight, emb.device)
    eff = w[..., None, :] * success[top_idx].float()
    eff = eff / eff.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return {
        "indices": top_idx,
        "scores": top_scores,
        "valid": valid.gather(-1, top_idx),
        "sims": sims,                # [..., k, 2] (asr, audio)
        "effective_weights": eff,    # [..., k, 2]
        "num_valid": valid.sum(dim=-1),
    }
