"""Whisper encoder-decoder as plain PyTorch functions, tiny/base/small.

Counterpart of ``multimodal_audio_search_tpu/models/whisper.py``: the same
architecture (HF WhisperForConditionalGeneration parity), the same param
keys and layouts, the same presets. What the port keeps of the JAX
package's paths:

  * ``encode``: the fused-block form (K1 for self-attention + o-proj +
    residual, ops/encoder_block.py) and the plain form (``mha``); the conv
    stem as shifted-slice patches + ONE matmul, not ``F.conv1d``, which
    would route through cuDNN's TF32 default on the card.
  * decoding: merged-head cross K/V [B, T, H*D] and a merged-head self
    cache [B, L, H*D]; K2 (ops/cross_attention.py) serves both attentions
    of a step. The [B, H, T, D] einsum format stays for
    ``cross_attn="einsum"``.

The cache is updated IN PLACE (``cache[:, pos] = row``), where JAX builds
a new array per step; nothing else holds the old cache.

Not ported (ROADMAP A9/A13): ``fused_layer`` (B3-B5), int8 K/V (B6/B7),
``scan_layers``, tensor-parallel meshes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import layers as L


@dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865          # multilingual
    d_model: int = 512
    enc_layers: int = 6
    dec_layers: int = 6
    heads: int = 8
    ffn: int = 2048
    n_mels: int = 80
    enc_positions: int = 1500
    dec_positions: int = 448
    ln_eps: float = 1e-5
    # special ids (multilingual layout; HF generation_config)
    bos_token_id: int = 50258        # <|startoftranscript|>
    eos_token_id: int = 50257        # <|endoftext|>
    pad_token_id: int = 50257
    no_timestamps_id: int = 50363
    transcribe_id: int = 50359
    lang_en_id: int = 50259


PRESETS = {
    "tiny": WhisperConfig(d_model=384, enc_layers=4, dec_layers=4,
                          heads=6, ffn=1536),
    "base": WhisperConfig(d_model=512, enc_layers=6, dec_layers=6,
                          heads=8, ffn=2048),
    "small": WhisperConfig(d_model=768, enc_layers=12, dec_layers=12,
                           heads=12, ffn=3072),
}
PRESETS["large-v3"] = WhisperConfig(
    d_model=1280, enc_layers=32, dec_layers=32, heads=20, ffn=5120,
    n_mels=128, vocab_size=51866, bos_token_id=50258, eos_token_id=50257,
    pad_token_id=50257, no_timestamps_id=50364, transcribe_id=50360,
    lang_en_id=50259)
_EN = dict(vocab_size=51864, bos_token_id=50257, eos_token_id=50256,
           pad_token_id=50256, no_timestamps_id=50362,
           transcribe_id=50358, lang_en_id=50258)
PRESETS.update({
    "tiny.en": WhisperConfig(d_model=384, enc_layers=4, dec_layers=4,
                             heads=6, ffn=1536, **_EN),
    "base.en": WhisperConfig(d_model=512, enc_layers=6, dec_layers=6,
                             heads=8, ffn=2048, **_EN),
    "small.en": WhisperConfig(d_model=768, enc_layers=12, dec_layers=12,
                              heads=12, ffn=3072, **_EN),
})
# toy dims for the CPU tests (same as the JAX package's "test" preset)
PRESETS["test"] = WhisperConfig(
    vocab_size=512, d_model=64, enc_layers=2, dec_layers=2, heads=4,
    ffn=128, enc_positions=100, dec_positions=32, bos_token_id=500,
    eos_token_id=501, pad_token_id=501, no_timestamps_id=502,
    transcribe_id=503, lang_en_id=504)


def config_for(preset: str, **overrides) -> WhisperConfig:
    return dataclasses.replace(PRESETS[preset], **overrides)


# --------------------------------------------------------------------- init
def _init_block(gen: torch.Generator, cfg: WhisperConfig, cross: bool):
    blk = {
        "self_attn": L.init_mha(gen, cfg.d_model, k_bias=False),
        "self_ln": L.init_layer_norm(cfg.d_model),
        "mlp_in": L.init_dense(gen, cfg.d_model, cfg.ffn),
        "mlp_out": L.init_dense(gen, cfg.ffn, cfg.d_model),
        "mlp_ln": L.init_layer_norm(cfg.d_model),
    }
    if cross:
        blk["cross_attn"] = L.init_mha(gen, cfg.d_model, k_bias=False)
        blk["cross_ln"] = L.init_layer_norm(cfg.d_model)
    return blk


def init_params(gen: torch.Generator, cfg: WhisperConfig):
    """Random init (float32, CPU) with the JAX package's shapes and
    scales; the numbers differ from jax.random's for the same seed."""
    d = cfg.d_model
    enc = {
        "conv1": {"w": torch.randn(3, cfg.n_mels, d, generator=gen) * 0.02,
                  "b": torch.zeros(d)},
        "conv2": {"w": torch.randn(3, d, d, generator=gen) * 0.02,
                  "b": torch.zeros(d)},
        "positions": torch.randn(cfg.enc_positions, d, generator=gen) * 0.02,
        "blocks": [_init_block(gen, cfg, cross=False)
                   for _ in range(cfg.enc_layers)],
        "ln": L.init_layer_norm(d),
    }
    dec = {
        "embed_tokens": torch.randn(cfg.vocab_size, d, generator=gen) * 0.02,
        "positions": torch.randn(cfg.dec_positions, d, generator=gen) * 0.02,
        "blocks": [_init_block(gen, cfg, cross=True)
                   for _ in range(cfg.dec_layers)],
        "ln": L.init_layer_norm(d),
    }
    return {"encoder": enc, "decoder": dec}


def prepare_params(params, dtype: torch.dtype, device: torch.device):
    """Place a param tree for serving: floats in ``dtype`` on ``device``
    (LN scales stay float32), plus a float32 copy of the tied embedding
    table for the logits (see _tied_logits)."""
    p = L.cast_floats(params, dtype, device)
    p["decoder"]["embed_tokens_f32"] = \
        p["decoder"]["embed_tokens"].float()
    return p


# ------------------------------------------------------------------ encoder
def _conv1d(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    """x: [B, T, C_in], w: [k, C_in, C_out], SAME-1 padding like HF, as
    shifted-slice patches + ONE matmul (the JAX package's lowering). Tap
    i multiplies input position t*stride - 1 + i."""
    k, cin, cout = p["w"].shape
    t_out = (x.shape[1] - 1) // stride + 1
    xp = F.pad(x, (0, 0, 1, 1))
    patches = torch.cat(
        [xp[:, off: off + stride * (t_out - 1) + 1: stride]
         for off in range(k)], dim=-1)                 # [B, T_out, k*C_in]
    w = p["w"].to(x.dtype).reshape(k * cin, cout)
    return L.dense({"w": w, "b": p["b"]}, patches)


def encode(params, mel: torch.Tensor, cfg: WhisperConfig,
           fused_blocks: bool = True) -> torch.Tensor:
    """[B, n_mels, frames] log-mel -> [B, frames/2, d] encoder states.

    ``fused_blocks`` routes self-attention + o-proj + residual through
    K1 (ops/encoder_block.py; the plain twin on CPU tensors). False runs
    the plain ``mha`` path, as the JAX package's fused_encoder=False."""
    from ..ops.encoder_block import fused_attention_o_residual
    enc = params["encoder"]
    x = mel.transpose(1, 2)                           # [B, T, n_mels]
    x = L.gelu(_conv1d(enc["conv1"], x, 1))
    x = L.gelu(_conv1d(enc["conv2"], x, 2))           # [B, T/2, d]
    x = x + enc["positions"][: x.shape[1]][None].to(x.dtype)
    for blk in enc["blocks"]:
        h = L.layer_norm(blk["self_ln"], x, cfg.ln_eps)
        if fused_blocks:
            a = blk["self_attn"]
            q = L.split_heads(L.dense(a["q"], h), cfg.heads)
            k = L.split_heads(L.dense(a["k"], h), cfg.heads)
            v = L.split_heads(L.dense(a["v"], h), cfg.heads)
            x = fused_attention_o_residual(
                q, k, v, x, a["o"]["w"], a["o"]["b"])
        else:
            x = x + L.mha(blk["self_attn"], h, h, cfg.heads)
        h = L.layer_norm(blk["mlp_ln"], x, cfg.ln_eps)
        x = x + L.dense(blk["mlp_out"], L.gelu(L.dense(blk["mlp_in"], h)))
    return L.layer_norm(enc["ln"], x, cfg.ln_eps)


# ------------------------------------------------------------------ decoder
def cross_kv(params, enc_out: torch.Tensor, cfg: WhisperConfig):
    """Per-layer cross-attention K/V in the [B, H, T, D] einsum format."""
    return [tuple(L.split_heads(L.dense(blk["cross_attn"][n], enc_out),
                                cfg.heads) for n in ("k", "v"))
            for blk in params["decoder"]["blocks"]]


def cross_kv_merged(params, enc_out: torch.Tensor, cfg: WhisperConfig):
    """Per-layer merged-head [B, T, H*D] cross K/V for K2: the k/v dense
    outputs as they are (their feature order is head-major already)."""
    return [(L.dense(blk["cross_attn"]["k"], enc_out),
             L.dense(blk["cross_attn"]["v"], enc_out))
            for blk in params["decoder"]["blocks"]]


def _cross_attend(blk, h, ckv_entry, cfg: WhisperConfig):
    """Cross-attention for one block; the K/V format picks the path:
    3-D merged K/V -> K2, 4-D [B, H, T, D] -> einsum."""
    from ..ops.cross_attention import fused_single_query_attention
    k, v = ckv_entry
    q = L.dense(blk["cross_attn"]["q"], h)              # [B, 1, D]
    if k.dim() == 3:
        if q.shape[1] != 1:
            raise ValueError("merged cross-attention is single-query")
        o = fused_single_query_attention(q[:, 0], k, v, heads=cfg.heads)
        attn = o[:, None, :].to(h.dtype)
    else:
        attn = L.merge_heads(L.attention_scores(
            L.split_heads(q, cfg.heads), k, v))
    return L.dense(blk["cross_attn"]["o"], attn)


def _tied_logits(dec, x: torch.Tensor) -> torch.Tensor:
    """h @ E^T -> [B, vocab] float32. The JAX package multiplies bf16
    operands with float32 accumulation and a float32 result; the port
    multiplies the same bf16 values upcast to float32 (exact products,
    float32 sums, TF32 off), so the logits are not rounded to bf16
    before the argmax."""
    return torch.matmul(x.float(), dec["embed_tokens_f32"].t())


# ----------------------------------------------------------- cached decode
def _self_attend_cached(q1, k, v, pos: int, cfg: WhisperConfig):
    """Single-query causal attention over the merged cache: q1 [B, D],
    k/v [B, L, D] -> [B, D] f32, keys 0..pos (K2)."""
    from ..ops.cross_attention import fused_single_query_attention
    return fused_single_query_attention(q1, k, v, heads=cfg.heads, pos=pos)


def init_cache(cfg: WhisperConfig, batch: int, max_len: int, dtype,
               device):
    """Merged-head self-attention KV cache: [B, max_len, d_model]."""
    return [{"k": torch.zeros(batch, max_len, cfg.d_model, dtype=dtype,
                              device=device),
             "v": torch.zeros(batch, max_len, cfg.d_model, dtype=dtype,
                              device=device)}
            for _ in range(cfg.dec_layers)]


def decode_step(params, token: torch.Tensor, pos: int, cache, ckv,
                cfg: WhisperConfig) -> torch.Tensor:
    """One KV-cached decode step (the JAX package's non-fused_layer
    branch). token [B] int64, pos a host int; ``cache`` (from init_cache)
    is written in place at row ``pos``. Returns logits [B, vocab] f32."""
    dec = params["decoder"]
    dtype = cache[0]["k"].dtype
    x = (dec["embed_tokens"][token][:, None, :].float()
         + dec["positions"][pos][None, None, :].float()).to(dtype)
    for blk, layer_cache, ckv_entry in zip(dec["blocks"], cache, ckv):
        h = L.layer_norm(blk["self_ln"], x, cfg.ln_eps)
        # dense outputs ARE the merged-head layout: one row write each
        layer_cache["k"][:, pos] = L.dense(blk["self_attn"]["k"], h)[:, 0]
        layer_cache["v"][:, pos] = L.dense(blk["self_attn"]["v"], h)[:, 0]
        q1 = L.dense(blk["self_attn"]["q"], h)[:, 0, :]
        attn = _self_attend_cached(q1, layer_cache["k"], layer_cache["v"],
                                   pos, cfg)
        x = x + L.dense(blk["self_attn"]["o"], attn[:, None, :].to(dtype))
        h = L.layer_norm(blk["cross_ln"], x, cfg.ln_eps)
        x = x + _cross_attend(blk, h, ckv_entry, cfg)
        h = L.layer_norm(blk["mlp_ln"], x, cfg.ln_eps)
        x = x + L.dense(blk["mlp_out"], L.gelu(L.dense(blk["mlp_in"], h)))
    x = L.layer_norm(dec["ln"], x, cfg.ln_eps)
    return _tied_logits(dec, x[:, 0, :])


_WHISPER_LANG_CODES: tuple[str, ...] | None = None


def _language_codes() -> tuple[str, ...]:
    """Whisper's language-token ordering, read from the local
    transformers install when present (token <|code|> = lang_en_id +
    index); English alone otherwise."""
    global _WHISPER_LANG_CODES
    if _WHISPER_LANG_CODES is None:
        try:
            from transformers.models.whisper.tokenization_whisper import (
                LANGUAGES)
            _WHISPER_LANG_CODES = tuple(LANGUAGES.keys())
        except ImportError:
            _WHISPER_LANG_CODES = ("en",)
    return _WHISPER_LANG_CODES


def language_token_id(cfg: WhisperConfig, language: str) -> int:
    """Token id of ``<|language|>`` (offset from <|en|>)."""
    if language == "en":
        return cfg.lang_en_id
    codes = _language_codes()
    n_langs = 100 if cfg.vocab_size >= 51866 else 99
    if language not in codes[:n_langs]:
        raise ValueError(
            f"unknown Whisper language {language!r} for vocab "
            f"{cfg.vocab_size} ({n_langs} languages)")
    return cfg.lang_en_id + codes.index(language)


def forced_prefix(cfg: WhisperConfig, task: str = "transcribe",
                  language: str = "en") -> list[int]:
    """Decoder prompt: <sot> <lang> <task> <notimestamps>; English-only
    checkpoints (vocab 51864) take no language/task tokens."""
    if cfg.vocab_size == 51864:  # *.en models
        return [cfg.bos_token_id, cfg.no_timestamps_id]
    if task == "transcribe":
        task_id = cfg.transcribe_id
    elif task == "translate":
        task_id = cfg.transcribe_id - 1  # <|translate|> precedes it
    else:
        raise ValueError(f"unknown Whisper task {task!r}")
    return [cfg.bos_token_id, language_token_id(cfg, language), task_id,
            cfg.no_timestamps_id]
