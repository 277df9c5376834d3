"""Beam-search decoding with HF semantics (the caption parity mode).

Counterpart of ``multimodal_audio_search_tpu/models/beam.py::
beam_generate``, rule for rule: the reference decodes captions with
num_beams=2, repetition_penalty=1.3, no_repeat_ngram_size=3,
length_penalty=1.0, early_stopping=True (audio_search.py:366-375).

  * the encoder output is repeated to B*k rows, and the cross K/V is made
    from the repeated rows, so the decode kernels see B*k rows;
  * each step: log-softmax -> repetition penalty and n-gram ban on the
    log-probabilities (the processors run after the log-softmax here, on
    the logits in greedy) -> cumulative scores -> the top 2k over
    (beam, token), ties to the lower index as ``lax.top_k`` breaks them;
  * EOS candidates ranked < k finalize a hypothesis scored
    sum_logprobs / (pos + 2) ** length_penalty (the prefix counted); the
    first k non-EOS candidates are the next beams; a row with k
    hypotheses is done and keeps its beams;
  * the end: running beams (scored by (pos + 1) ** length_penalty) fill a
    row's empty hypothesis slots, and the best hypothesis is returned.

The JAX ``lax.while_loop`` becomes a Python loop with one host sync a
step; ``pos`` is a host int, so a forced-prefix step is a host branch.
The self-attention cache is reordered by parent beam IN PLACE
(``copy_``), since the fused kernels write it in place at ``pos`` and
keep their tensor maps by address. ``decode.fused_layer`` passes through
to ``decode_step`` as in greedy; the JAX function calls the unfused step
(ROADMAP, deliberate differences).

``beam_generate_tp`` is the same search over one data row's model axis
(models/whisper.py::decode_step_tp): B*k rows on every rank, the
scores, tokens and hypotheses on the first rank's device, and each
rank's cache reordered in place by the parents, copied to its device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DecodeConfig
from .generate import (_select_cross_kv, apply_repetition_penalty,
                       ban_repeated_ngrams, check_supported)
from .whisper import (WhisperConfig, decode_step, decode_step_tp, init_cache,
                      init_cache_tp)

NEG_INF = -1e9


class BeamOut(NamedTuple):
    tokens: torch.Tensor    # [B, prefix+max_new] int64
    lengths: torch.Tensor   # [B] int64, generated length incl. EOS
    scores: torch.Tensor    # [B] f32 normalized best-hypothesis score
    steps: int              # decode steps run (each = one decode_step)


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest entries of each row of ``x``, ties to the lower
    index (``lax.top_k``'s rule, which ``torch.topk`` does not promise).
    Returns (values, indices)."""
    values, order = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], order[:, :k]


@torch.inference_mode()
def beam_generate(params, enc_out: torch.Tensor, prefix: torch.Tensor, *,
                  cfg: WhisperConfig, decode: DecodeConfig,
                  max_new_tokens: int, num_beams: int = 2) -> BeamOut:
    """Beam search over ``enc_out`` [B, T, d] with the forced prompt
    ``prefix`` [B, P] (module docstring)."""
    check_supported(decode)
    b, k = enc_out.shape[0], num_beams
    total = prefix.shape[1] + max_new_tokens
    ckv = _select_cross_kv(params, enc_out.repeat_interleave(k, dim=0), cfg,
                           decode)
    cache = init_cache(cfg, b * k, total, enc_out.dtype, enc_out.device)

    def step(token, pos):
        return decode_step(params, token, pos, cache, ckv, cfg,
                           fused_layer=decode.fused_layer)
    return _beam_loop(step, [cache], b, enc_out.device, prefix, cfg=cfg,
                      decode=decode, max_new_tokens=max_new_tokens,
                      num_beams=k)


@torch.inference_mode()
def beam_generate_tp(trees, encs: list, prefix: torch.Tensor, *,
                     cfg: WhisperConfig, decode: DecodeConfig,
                     max_new_tokens: int, num_beams: int = 2) -> BeamOut:
    """``beam_generate`` over one data row's model axis: ``trees`` the
    ranks' head shards, ``encs`` the encoder output on each rank's device
    (models/whisper.py::encode_tp); each step is decode_step_tp over the
    B*k rows, and every rank's cache follows the parents (module
    docstring)."""
    check_supported(decode)
    b, k = encs[0].shape[0], num_beams
    total = prefix.shape[1] + max_new_tokens
    ckvs = _select_cross_kv(trees, [e.repeat_interleave(k, dim=0)
                                    for e in encs], cfg, decode, tp=True)
    caches = init_cache_tp(trees, cfg, b * k, total, encs[0].dtype)

    def step(token, pos):
        return decode_step_tp(trees, token, pos, caches, ckvs, cfg,
                              fused_layer=decode.fused_layer)
    return _beam_loop(step, caches, b, encs[0].device, prefix, cfg=cfg,
                      decode=decode, max_new_tokens=max_new_tokens,
                      num_beams=k)


def _beam_loop(step, caches: list, b: int, dev, prefix: torch.Tensor, *,
               cfg: WhisperConfig, decode: DecodeConfig, max_new_tokens: int,
               num_beams: int) -> BeamOut:
    """beam_generate's search on ``dev`` over ``step(token [B*k], pos)``
    -> logits [B*k, vocab]; ``caches`` the self-attention caches (one, or
    one a rank) that step writes, reordered by parent after each step."""
    k = num_beams
    prefix_len = prefix.shape[1]
    total = prefix_len + max_new_tokens
    lp = decode.length_penalty
    eos, pad = cfg.eos_token_id, cfg.pad_token_id
    tokens = torch.full((b * k, total), pad, dtype=torch.long, device=dev)
    tokens[:, :prefix_len] = prefix.to(device=dev, dtype=torch.long) \
        .repeat_interleave(k, dim=0)
    beam_scores = torch.tensor([0.0] + [NEG_INF] * (k - 1),
                               device=dev).repeat(b)             # [B*k]
    # the finalized hypotheses of each row
    hyp_tokens = torch.full((b, k, total), pad, dtype=torch.long,
                            device=dev)
    hyp_scores = torch.full((b, k), NEG_INF, device=dev)
    hyp_len = torch.zeros((b, k), dtype=torch.long, device=dev)
    n_hyps = torch.zeros(b, dtype=torch.long, device=dev)

    rows = torch.arange(b, device=dev)
    rank = torch.arange(2 * k, device=dev).expand(b, 2 * k)
    ar = torch.arange(total, device=dev)
    pos = 0
    while pos < total - 1:
        logits = step(tokens[:, pos], pos)
        if pos + 1 < prefix_len:    # forced prompt: the tokens are there
            pos += 1
            continue
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = apply_repetition_penalty(
            logp, tokens, (ar <= pos)[None, :].expand(b * k, total),
            decode.repetition_penalty)
        logp = ban_repeated_ngrams(
            logp, tokens, torch.full((b * k,), pos + 1, device=dev),
            decode.no_repeat_ngram_size)
        v = logp.shape[-1]
        cand = (beam_scores[:, None] + logp).reshape(b, k * v)
        top_s, top_i = top_k_stable(cand, 2 * k)                 # [B, 2k]
        src_beam = top_i // v
        tok = top_i % v
        is_eos = tok == eos

        # finalize EOS candidates ranked < k unless the row is done; the
        # hypothesis holds pos + 2 tokens (the prefix and the EOS)
        row_done = n_hyps >= k
        fin = is_eos & (rank < k) & ~row_done[:, None]
        norm = top_s / float(pos + 2) ** lp
        for idx in range(k):        # candidates ranked >= k never finalize
            take = fin[:, idx]
            score = torch.where(take, norm[:, idx], NEG_INF)
            worst = hyp_scores.argmin(dim=1)                    # [B]
            do = take & (score > hyp_scores[rows, worst])
            seq = tokens[rows * k + src_beam[:, idx]]           # [B, total]
            seq[:, pos + 1] = eos
            hyp_tokens[rows, worst] = torch.where(
                do[:, None], seq, hyp_tokens[rows, worst])
            hyp_scores[rows, worst] = torch.where(
                do, score, hyp_scores[rows, worst])
            hyp_len[rows, worst] = torch.where(
                do, pos + 2 - prefix_len, hyp_len[rows, worst])
            n_hyps += take.long()
        n_hyps.clamp_(max=k)

        # the first k non-EOS candidates by rank are the next beams
        order = torch.argsort(torch.where(is_eos, 2 * k + rank, rank),
                              dim=1, stable=True)
        pick = order[:, :k]                                      # [B, k]
        new_parent = rows[:, None] * k + src_beam.gather(1, pick)
        keep = row_done[:, None]            # done rows keep their beams
        parent = torch.where(
            keep, torch.arange(b * k, device=dev).reshape(b, k),
            new_parent).reshape(-1)
        tokens = tokens[parent]
        tokens[:, pos + 1] = torch.where(keep, pad,
                                         tok.gather(1, pick)).reshape(-1)
        beam_scores = torch.where(keep, beam_scores.reshape(b, k),
                                  top_s.gather(1, pick)).reshape(-1)
        # reorder the self-attention cache(s) by parent beam, in place;
        # rows past pos are not written yet
        for cache in caches:
            idx = parent.to(cache[0]["k"].device)
            for layer in cache:
                for c in (layer["k"], layer["v"]):
                    c[:, :pos + 1].copy_(c[:, :pos + 1].index_select(0, idx))
        pos += 1
        if bool((n_hyps >= k).all()):     # the one host sync per step
            break

    # flush the running beams into the rows' empty hypothesis slots
    run_norm = beam_scores.reshape(b, k) / float(pos + 1) ** lp
    need = hyp_scores <= NEG_INF / 2
    merged_scores = torch.where(need, run_norm, hyp_scores)
    merged_tokens = torch.where(need[:, :, None], tokens.reshape(b, k, total),
                                hyp_tokens)
    merged_len = torch.where(need, pos + 1 - prefix_len, hyp_len)
    best = merged_scores.argmax(dim=1)
    return BeamOut(tokens=merged_tokens[rows, best],
                   lengths=merged_len[rows, best],
                   scores=merged_scores[rows, best], steps=pos)
