"""Greedy KV-cached generation for Whisper.

Counterpart of ``multimodal_audio_search_tpu/models/generate.py::generate``
(greedy path) with its HF-semantics logits processors. The JAX
``lax.while_loop`` becomes a Python loop; its early exit (every row has
emitted EOS) is checked on the host once per step -- one device sync per
step. ``pos`` is a host int handed to the kernels as an argument.

Not ported (ROADMAP A4/A9): ``method="sample"``, beam search, int8 cross
K/V, ``fused_layer``, ``scan_layers``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DecodeConfig
from .whisper import (WhisperConfig, cross_kv, cross_kv_merged, decode_step,
                      init_cache)

NEG_INF = -1e9


# ------------------------------------------------------------ logits rules
def apply_repetition_penalty(logits, tokens, valid, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor semantics: for every token id
    present in the (valid) history, positive scores are divided by
    ``penalty`` and negative ones multiplied by it.
    logits [B, V], tokens [B, L], valid [B, L] bool."""
    if penalty == 1.0:
        return logits
    b, v = logits.shape
    oob = torch.where(valid, tokens, torch.full_like(tokens, v))
    seen = torch.zeros(b, v + 1, dtype=torch.bool, device=logits.device)
    seen.scatter_(1, oob, True)
    seen = seen[:, :v]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def ban_repeated_ngrams(logits, tokens, cur_len: torch.Tensor, n: int):
    """HF NoRepeatNGramLogitsProcessor semantics: ban any token that would
    complete an n-gram already in the history. tokens [B, L] with
    ``cur_len`` [B] valid entries; the last n-1 form the probe."""
    if n <= 0:
        return logits
    b, l = tokens.shape
    v = logits.shape[1]
    dev = logits.device
    rows = torch.arange(b, device=dev)[:, None]
    if n == 1:  # HF semantics: ban every token already generated
        valid = torch.arange(l, device=dev)[None, :] < cur_len[:, None]
        oob = torch.where(valid, tokens, torch.full_like(tokens, v))
        mask = torch.zeros(b, v + 1, dtype=torch.bool, device=dev)
        mask.scatter_(1, oob, True)
        return logits.masked_fill(mask[:, :v], NEG_INF)
    ar = torch.arange(n - 1, device=dev)
    probe_idx = (cur_len[:, None] - (n - 1) + ar[None, :]).clamp(0, l - 1)
    probe = tokens[rows, probe_idx]                            # [B, n-1]
    pos = torch.arange(l, device=dev)
    win_idx = (pos[:, None] + ar[None, :]).clamp(0, l - 1)     # [L, n-1]
    win = tokens[:, win_idx]                                   # [B, L, n-1]
    match = (win == probe[:, None, :]).all(dim=-1)             # [B, L]
    in_range = (pos[None, :] + n - 1) <= (cur_len[:, None] - 1)
    active = (cur_len >= (n - 1))[:, None] & match & in_range
    banned_tok = tokens[:, (pos + n - 1).clamp(0, l - 1)]      # [B, L]
    bi = torch.where(active, banned_tok, torch.full_like(banned_tok, v))
    mask = torch.zeros(b, v + 1, dtype=torch.bool, device=dev)
    mask.scatter_(1, bi, True)
    return logits.masked_fill(mask[:, :v], NEG_INF)


# ----------------------------------------------------------------- decoding
def _select_cross_kv(params, enc_out, cfg, decode: DecodeConfig):
    """Decode cross K/V format (DecodeConfig.cross_attn): "auto"/"fused"
    give the merged-head format that K2 reads; "einsum" the [B,H,T,D]
    format of the plain path."""
    mode = decode.cross_attn
    if mode in ("int8", "int8_fused") or decode.int8_cross_kv:
        raise NotImplementedError(
            "int8 cross K/V is not ported (ROADMAP B6/B7)")
    if mode in ("auto", "fused"):
        return cross_kv_merged(params, enc_out, cfg)
    if mode == "einsum":
        return cross_kv(params, enc_out, cfg)
    raise ValueError(f"unknown cross_attn {mode!r}")


def check_supported(decode: DecodeConfig) -> None:
    """Raise on decode options this port does not run yet."""
    if decode.method != "greedy":
        raise NotImplementedError(
            f"method={decode.method!r} is not ported; greedy only "
            f"(ROADMAP A4)")
    if decode.fused_layer:
        raise NotImplementedError(
            "fused_layer is not ported (ROADMAP A9, kernels B3-B5)")
    if decode.scan_layers:
        raise NotImplementedError("scan_layers is not ported (ROADMAP)")
    if decode.fused_encoder not in (None, True, False):
        raise NotImplementedError(
            f"fused_encoder={decode.fused_encoder!r} is not ported "
            f"(ROADMAP B1 variants)")
    if decode.cross_attn in ("int8", "int8_fused") or decode.int8_cross_kv:
        raise NotImplementedError(
            "int8 cross K/V is not ported (ROADMAP B6/B7)")


class DecodeOut(NamedTuple):
    tokens: torch.Tensor    # [B, prefix+max_new] int64 (pad after EOS)
    lengths: torch.Tensor   # [B] int64, generated length incl. EOS
    steps: int              # decode steps run (each = one decode_step)


@torch.inference_mode()
def generate(params, enc_out: torch.Tensor, prefix: torch.Tensor, *,
             cfg: WhisperConfig, decode: DecodeConfig,
             max_new_tokens: int) -> DecodeOut:
    """Batched KV-cached greedy generation. ``prefix`` [B, P] is the
    forced decoder prompt; the loop stops when every row has emitted EOS
    or the buffer is full."""
    check_supported(decode)
    b = enc_out.shape[0]
    prefix_len = prefix.shape[1]
    total = prefix_len + max_new_tokens
    dev = enc_out.device
    ckv = _select_cross_kv(params, enc_out, cfg, decode)
    cache = init_cache(cfg, b, total, enc_out.dtype, dev)
    tokens = torch.full((b, total), cfg.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, :prefix_len] = prefix.to(device=dev, dtype=torch.long)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    ar = torch.arange(total, device=dev)
    pos = 0
    while pos < total - 1:
        logits = decode_step(params, tokens[:, pos], pos, cache, ckv, cfg)
        logits = apply_repetition_penalty(
            logits, tokens, (ar <= pos)[None, :].expand(b, total),
            decode.repetition_penalty)
        logits = ban_repeated_ngrams(
            logits, tokens, torch.full((b,), pos + 1, device=dev),
            decode.no_repeat_ngram_size)
        nxt = logits.argmax(dim=-1)
        in_prefix = pos + 1 < prefix_len
        if in_prefix:  # the forced prompt overrides the model's choice
            nxt = tokens[:, pos + 1]
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id),
                          nxt)
        tokens[:, pos + 1] = nxt
        if not in_prefix:
            finished = finished | (nxt == cfg.eos_token_id)
        pos += 1
        if bool(finished.all()):   # the one host sync per step
            break
    gen = tokens[:, prefix_len:]
    is_eos = gen == cfg.eos_token_id
    any_eos = is_eos.any(dim=1)
    first_eos = is_eos.int().argmax(dim=1)
    lengths = torch.where(any_eos, first_eos + 1,
                          torch.full_like(first_eos, max_new_tokens))
    return DecodeOut(tokens=tokens, lengths=lengths.long(), steps=pos)
