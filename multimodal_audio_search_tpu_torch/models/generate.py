"""KV-cached generation for Whisper: greedy and sampling.

Counterpart of ``multimodal_audio_search_tpu/models/generate.py::generate``
with its HF-semantics logits processors. The JAX ``lax.while_loop``
becomes a Python loop; its early exit (every row has emitted EOS) is
checked on the host once per step -- one device sync per step. ``pos`` is
a host int handed to the kernels as an argument. Beam search is
``models/beam.py``.

Sampling (``method="sample"``) draws the next token as
``jax.random.categorical`` does, ``argmax(logits / t + gumbel)``, with the
Gumbel noise from an explicit ``torch.Generator`` on the logits' device
(``_gumbel``). The noise is drawn on every step, the forced-prefix steps
included, as JAX splits its key on every step; the stream is the
generator's, not JAX's (ROADMAP, deliberate differences).

``decode.fused_layer`` passes through to ``decode_step`` (the fused
sub-block kernels K3/K4, ops/decoder_block.py); ``decode.cross_attn`` and
``decode.int8_cross_kv`` pick the cross K/V format (bf16 merged for K2,
int8 merged for K6, int8 [B, H, T, D] for K7, or the einsum format).

``generate_tp`` is the same loop over one data row's model axis
(models/whisper.py::decode_step_tp, each rank's heads on its device),
greedy or sampling: the logits, the noise and every rule of the loop stay
on the first rank's device, so a sampled row draws the noise it draws
without the axis. Beam search over the axis is models/beam.py::
beam_generate_tp.

Not ported: ``scan_layers``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DecodeConfig
from .whisper import (WhisperConfig, cross_kv, cross_kv_merged,
                      cross_kv_merged_int8, cross_kv_merged_int8_tp,
                      cross_kv_merged_tp, cross_kv_quantized,
                      cross_kv_quantized_tp, cross_kv_tp, decode_step,
                      decode_step_tp, init_cache, init_cache_tp)

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
def _select_cross_kv(params, enc_out, cfg, decode: DecodeConfig,
                     tp: bool = False):
    """Decode cross K/V format (DecodeConfig.cross_attn), in the JAX
    function's order: "int8_fused" -> merged int8 (K6); "int8" or
    ``int8_cross_kv`` -> int8 [B,H,T,D] (K7); "auto"/"fused" -> the
    merged-head format that K2 reads; "einsum" -> the [B,H,T,D] format
    of the plain path. ``tp``: ``params`` a data row's rank trees and
    ``enc_out`` the encoder output on each rank's device; each rank's
    K/V over its heads (the ``*_tp`` forms)."""
    mode = decode.cross_attn
    if mode == "int8_fused":
        fns = (cross_kv_merged_int8, cross_kv_merged_int8_tp)
    elif decode.int8_cross_kv or mode == "int8":
        fns = (cross_kv_quantized, cross_kv_quantized_tp)
    elif mode in ("auto", "fused"):
        fns = (cross_kv_merged, cross_kv_merged_tp)
    elif mode == "einsum":
        fns = (cross_kv, cross_kv_tp)
    else:
        raise ValueError(f"unknown cross_attn {mode!r}")
    return fns[tp](params, enc_out, cfg)


METHODS = ("greedy", "sample", "beam")


def check_supported(decode: DecodeConfig, quantized: bool = False) -> None:
    """Raise on an unknown decode ``method`` (ValueError), on decode
    options this port does not run yet, on an unknown ``fused_encoder``,
    and on ``fused_layer`` over a ``quantized`` (int8) decoder, which the
    JAX package cannot run either (models/whisper.py, module
    docstring). The mesh's model axis runs every option these allow."""
    if decode.method not in METHODS:
        raise ValueError(
            f"method={decode.method!r}: one of {', '.join(METHODS)}")
    if decode.scan_layers:
        raise NotImplementedError("scan_layers is not ported (ROADMAP)")
    fe = decode.fused_encoder
    if not (fe is None or fe is True or fe is False or fe in ("int8",
                                                              "paired")):
        raise NotImplementedError(
            f"fused_encoder={fe!r}: the JAX package knows None, True, "
            f"False, 'int8' and 'paired'")
    if quantized and decode.fused_layer:
        raise NotImplementedError(
            f"fused_layer={decode.fused_layer!r} with quantize_decoder: "
            f"the fused sub-block kernels take bf16 weights, and the JAX "
            f"package has no int8 form of them; set fused_layer=False")


class DecodeOut(NamedTuple):
    tokens: torch.Tensor    # [B, prefix+max_new] int64 (pad after EOS)
    lengths: torch.Tensor   # [B] int64, generated length incl. EOS
    steps: int              # decode steps run (each = one decode_step)
    scores: torch.Tensor    # [B] f32 summed logprob (0 unless with_scores)


def _gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in
    [finfo(float32).tiny, 1) as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=gen, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min_(torch.finfo(
        torch.float32).tiny)))


def _select_next(logits, method: str, temperature: float, noise):
    """The next token: ``argmax(logits / max(t, 1e-6) + noise)`` for
    "sample" (``jax.random.categorical`` on the same noise), argmax of
    the logits otherwise."""
    if method == "sample":
        return (logits / max(temperature, 1e-6) + noise).argmax(dim=-1)
    return logits.argmax(dim=-1)


@torch.inference_mode()
def generate(params, enc_out: torch.Tensor, prefix: torch.Tensor, *,
             cfg: WhisperConfig, decode: DecodeConfig,
             max_new_tokens: int, rng: torch.Generator | None = None,
             with_scores: bool = False,
             noise_rows: tuple[int, int] | None = None) -> DecodeOut:
    """Batched KV-cached generation, greedy or sampling
    (``decode.method``; beam search is models/beam.py). ``prefix`` [B, P]
    is the forced decoder prompt; the loop stops when every row has
    emitted EOS or the buffer is full. ``rng``: the sampling generator,
    on ``enc_out``'s device; None = one seeded with 0, as JAX's
    ``PRNGKey(0)`` default. ``with_scores`` sums the log-softmax of the
    processed logits at each generated token (prefix and finished steps
    left out) into ``DecodeOut.scores``. ``noise_rows`` (first, total):
    these B rows are rows first.. of a batch of ``total`` rows split over
    a mesh; each step draws the whole batch's noise and takes theirs, so
    they sample as they would in the whole batch."""
    check_supported(decode)
    if decode.method == "beam":
        raise ValueError("method='beam' decodes with models/beam.py::"
                         "beam_generate")
    total = prefix.shape[1] + max_new_tokens
    ckv = _select_cross_kv(params, enc_out, cfg, decode)
    cache = init_cache(cfg, enc_out.shape[0], total, enc_out.dtype,
                       enc_out.device)

    def step(token, pos):
        return decode_step(params, token, pos, cache, ckv, cfg,
                           fused_layer=decode.fused_layer)
    return _decode_loop(step, enc_out.shape[0], enc_out.device, prefix,
                        cfg=cfg, decode=decode,
                        max_new_tokens=max_new_tokens, rng=rng,
                        with_scores=with_scores, noise_rows=noise_rows)


@torch.inference_mode()
def generate_tp(trees, encs: list, prefix: torch.Tensor, *,
                cfg: WhisperConfig, decode: DecodeConfig,
                max_new_tokens: int, rng: torch.Generator | None = None,
                with_scores: bool = False,
                noise_rows: tuple[int, int] | None = None) -> DecodeOut:
    """``generate`` over one data row's model axis: ``trees`` the ranks'
    head shards (parallel/mesh.py::shard_heads), ``encs`` the encoder
    output on each rank's device (models/whisper.py::encode_tp); each
    step is decode_step_tp, whose logits, tokens and every rule of the
    loop stay on the first rank's device. Greedy or sampling: ``rng`` (on
    the first rank's device) draws one noise row set a step, there, as
    ``generate`` draws it, and ``noise_rows`` as generate's. Every cross
    K/V format of ``decode`` runs on the ranks' heads."""
    check_supported(decode)
    if decode.method == "beam":
        raise ValueError("method='beam' decodes with models/beam.py::"
                         "beam_generate_tp")
    total = prefix.shape[1] + max_new_tokens
    enc0 = encs[0]
    ckvs = _select_cross_kv(trees, encs, cfg, decode, tp=True)
    caches = init_cache_tp(trees, cfg, enc0.shape[0], total, enc0.dtype)

    def step(token, pos):
        return decode_step_tp(trees, token, pos, caches, ckvs, cfg,
                              fused_layer=decode.fused_layer)
    return _decode_loop(step, enc0.shape[0], enc0.device, prefix, cfg=cfg,
                        decode=decode, max_new_tokens=max_new_tokens,
                        rng=rng, with_scores=with_scores,
                        noise_rows=noise_rows)


def _decode_loop(step, b: int, dev, prefix: torch.Tensor, *,
                 cfg: WhisperConfig, decode: DecodeConfig,
                 max_new_tokens: int, rng: torch.Generator | None = None,
                 with_scores: bool = False,
                 noise_rows: tuple[int, int] | None = None) -> DecodeOut:
    """generate's loop on ``dev`` over ``step(token [B], pos)`` -> logits
    [B, vocab] (generate's docstring)."""
    prefix_len = prefix.shape[1]
    total = prefix_len + max_new_tokens
    tokens = torch.full((b, total), cfg.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, :prefix_len] = prefix.to(device=dev, dtype=torch.long)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    scores = torch.zeros(b, dtype=torch.float32, device=dev)
    sample = decode.method == "sample"
    if sample and rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    ar = torch.arange(total, device=dev)
    pos = 0
    while pos < total - 1:
        logits = step(tokens[:, pos], pos)
        logits = apply_repetition_penalty(
            logits, tokens, (ar <= pos)[None, :].expand(b, total),
            decode.repetition_penalty)
        logits = ban_repeated_ngrams(
            logits, tokens, torch.full((b,), pos + 1, device=dev),
            decode.no_repeat_ngram_size)
        # a draw on every step, the prefix's too, as JAX splits its key
        noise = None
        if sample:
            lo, rows = noise_rows or (0, b)
            noise = _gumbel(rng, (rows, logits.shape[1]), dev)[lo: lo + b]
        nxt = _select_next(logits, decode.method, decode.temperature, noise)
        in_prefix = pos + 1 < prefix_len
        if in_prefix:  # the forced prompt overrides the model's choice
            nxt = tokens[:, pos + 1]
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id),
                          nxt)
        if with_scores and not in_prefix:
            logprob = torch.log_softmax(logits, dim=-1).gather(
                1, nxt[:, None])[:, 0]
            scores += torch.where(finished, 0.0, logprob)
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
    return DecodeOut(tokens=tokens, lengths=lengths.long(), steps=pos,
                     scores=scores)
