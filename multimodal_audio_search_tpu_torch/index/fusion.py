"""Batched weighted-fusion scoring (the search hot path), in plain torch.

Counterpart of ``multimodal_audio_search_tpu/index/fusion.py``:

    sims[N, 2]  = emb[N, 2, D] @ q[D]          (embeddings pre-L2-normalized)
    eff[N, 2]   = weights * success, renormalized per row
    score[N]    = sum(eff * sims, -1)
    valid[N]    = any(sims > 0) & (total_weight > 0) & (score > threshold)
    top-k over score masked by valid

The JAX package has a Pallas version of the scoring (ops/fused_search.py,
B10) that no path of it calls; this port has none either (ROADMAP B10).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def fused_scores(query_emb, emb, success, asr_weight: float,
                 audio_weight: float, threshold: float = 0.1):
    """Return (score[N] with invalid rows at NEG_INF, valid[N] bool)."""
    q = query_emb.float()
    sims = torch.einsum("npd,d->np", emb.float(), q)           # [N, 2]
    w = torch.tensor([asr_weight, audio_weight], dtype=torch.float32,
                     device=emb.device)
    eff = w[None, :] * success.float()                         # [N, 2]
    total = eff.sum(dim=-1)                                    # [N]
    eff = eff / total.clamp(min=1e-30)[:, None]
    score = (eff * sims).sum(dim=-1)                           # [N]
    any_pos = (sims > 0.0).any(dim=-1)
    valid = any_pos & (total > 0.0) & (score > threshold)
    return torch.where(valid, score, torch.full_like(score, NEG_INF)), valid


def fused_topk(query_emb, emb, success, asr_weight: float,
               audio_weight: float, *, k: int = 10,
               threshold: float = 0.1) -> dict[str, torch.Tensor]:
    """One-shot fused search over the whole index: top-k indices/scores
    plus per-hit sims and effective weights. Invalid rows score NEG_INF;
    callers drop them host-side."""
    masked, valid = fused_scores(query_emb, emb, success, asr_weight,
                                 audio_weight, threshold)
    k = min(k, masked.shape[0])
    # a stable descending sort: equal scores keep index order, the tie
    # rule of lax.top_k (torch.topk leaves ties unordered)
    top_scores, top_idx = torch.sort(masked, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    sims = torch.einsum("kpd,d->kp", emb[top_idx].float(), query_emb.float())
    w = torch.tensor([asr_weight, audio_weight], dtype=torch.float32,
                     device=emb.device)
    eff = w[None, :] * success[top_idx].float()
    eff = eff / eff.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return {
        "indices": top_idx,
        "scores": top_scores,
        "valid": valid[top_idx],
        "sims": sims,                # [k, 2] (asr, audio)
        "effective_weights": eff,    # [k, 2]
        "num_valid": valid.sum(),
    }
