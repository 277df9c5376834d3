"""Whisper encoder-decoder as plain PyTorch functions, tiny/base/small.

Counterpart of ``multimodal_audio_search_tpu/models/whisper.py``: the same
architecture (HF WhisperForConditionalGeneration parity), the same param
keys and layouts, the same presets. What the port keeps of the JAX
package's paths:

  * ``encode``: the fused-block forms (K1 for self-attention + o-proj +
    residual, K9 with int8 dots, K10 over head pairs; ops/encoder_block.py),
    the per-head fused attention (K8, ops/attention.py) and the plain form
    (``mha``); the conv stem as shifted-slice patches + ONE matmul, not
    ``F.conv1d``, which would route through cuDNN's TF32 default on the
    card.
  * decoding: merged-head cross K/V [B, T, H*D] and a merged-head self
    cache [B, L, H*D]; K2 (ops/cross_attention.py) serves both attentions
    of a step. The [B, H, T, D] einsum format stays for
    ``cross_attn="einsum"``.
  * ``fused_layer`` (ops/decoder_block.py): True runs each layer's self
    sub-block through K3 and its MLP sub-block through K4, with K2 for the
    cross attention between them; "v2" (with merged cross K/V) runs K3-q,
    whose tail emits the cross query, K2 on that query, and K4-o, whose
    head applies the cross o-projection -- three launches per layer.

  * ``decode_train``: the teacher-forced full-sequence decode that
    training differentiates (training/finetune.py), plain PyTorch with
    the [B, H, T, D] cross K/V; no kernel. ``decode_train_tp`` is its
    form over the model axis, and training runs ``encode_tp`` with
    ``fused_attention=False, fused_blocks=False`` (plain partials).

  * the int8 memory mode: a decoder from ops/quant.py::
    quantize_whisper_decoder runs every dense layer and the tied logits
    through K5; ``cross_kv_merged_int8`` (K6, ``cross_attn="int8_fused"``)
    and ``cross_kv_quantized`` (K7, ``"int8"`` / ``int8_cross_kv``) hold
    the cross K/V in int8, and ``_cross_attend`` picks the kernel from the
    K/V format, as the JAX function does.

The cache is updated IN PLACE (``cache[:, pos] = row``), where JAX builds
a new array per step; nothing else holds the old cache.

Where the JAX package's gate differs: its ``decode_step`` computes
``fused_layer = fused_layer and B % 8 == 0``, which turns "v2" into True,
so its v2 branch never runs (ROADMAP, faults in the reference). The port
keeps the value and takes the v2 branch. With a quantized decoder the JAX
fused path reads ``a["q"]["w"]``, which quantization removed, and fails
with ``KeyError: 'w'``; the port refuses ``fused_layer`` on a quantized
decoder with a clear error (there is no fused int8 path to match).

Tensor parallelism (the mesh's model axis, parallel/mesh.py): the
``*_tp`` functions take the per-rank param trees of one data row
(parallel/mesh.py::shard_heads, each tree on its rank's device) and run
each rank's H/mp heads and F/mp of the MLP on its device from this one
process. Every row-parallel product (self-attention o, cross-attention
o, mlp_out) ends in ``model_sum``: the ranks' float32 partials from the
encoder kernels' or K3's or K4's partial form on the card (K1p, K9p,
K10p, K3p, K4p), from K5 on an int8 decoder's row shards, or from the
plain partials (layers.dense_partial), summed in rank order, + bias +
residual, rounded once. K2, K6 and K7 run each rank's heads unchanged,
and K5 each column shard (bias added, in the model dtype). The logits
are computed on the first rank only (an int8 decoder's logits table
lies there alone); the chosen tokens go to every rank for the next
embedding lookup. ``fused_layer="v2"`` runs the True form over the axis
(decode_step_tp). The single-device functions are unchanged.

Not ported (ROADMAP A13): ``scan_layers``.
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
    (LN and quantization scales stay float32, int8 weights int8), plus a
    float32 copy of the tied embedding table for the logits (see
    _tied_logits) -- unless the decoder is quantized, whose logits come
    from the int8 table: a float32 copy would cost more than the mode
    saves (106 MB at whisper-base). On the card a quantized decoder's
    int8 table is replaced by its transposed copy, which K5's table
    kernel reads (ops/quant.py::logits_table; held once, 26.5 MB at
    whisper-base)."""
    p = L.cast_floats(params, dtype, device)
    dec = p["decoder"]
    if "embed_tokens_q" not in dec:
        dec["embed_tokens_f32"] = dec["embed_tokens"].float()
    elif torch.device(device).type == "cuda":
        from ..ops.quant import logits_table
        dec["embed_tokens_q"] = logits_table(dec["embed_tokens_q"])
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


def use_fused_attention(t: int, device: torch.device) -> bool:
    """The JAX package's dispatch rule for the per-head encoder attention
    kernel (its ``use_pallas_attention``, "real TPU and T >= 512"), on the
    card: K8 for a CUDA tensor at T >= 512."""
    return device.type == "cuda" and t >= 512


def encode(params, mel: torch.Tensor, cfg: WhisperConfig,
           fused_attention: bool | None = None,
           fused_blocks: bool | str = False) -> torch.Tensor:
    """[B, n_mels, frames] log-mel -> [B, frames/2, d] encoder states.

    Dispatch as the JAX function's (CPU tensors take each kernel's plain
    twin):
      * ``fused_blocks`` True: self-attention + o-proj + residual through
        K1 (ops/encoder_block.py; its float32 form for a float32 encode,
        at every T); "int8" through K9 (int8 dots; it
        outranks "paired"); "paired" through K10, or K1 for an odd head
        count (each, on float32, its float32 form).
      * otherwise ``fused_attention`` routes self-attention through K8
        (ops/attention.py) and a plain o-projection; None means
        ``use_fused_attention`` (a CUDA tensor at T >= 512). False runs
        the plain ``mha`` path.
    The JAX function's TPU-only VMEM gates (the float32 / T > 1024 reroute
    and the 13 MiB "paired" gate) are left behind (ROADMAP)."""
    from ..ops.attention import fused_encoder_attention
    from ..ops.encoder_block import fused_attention_o_residual
    enc = params["encoder"]
    x = mel.transpose(1, 2)                           # [B, T, n_mels]
    x = L.gelu(_conv1d(enc["conv1"], x, 1))
    x = L.gelu(_conv1d(enc["conv2"], x, 2))           # [B, T/2, d]
    x = x + enc["positions"][: x.shape[1]][None].to(x.dtype)
    if fused_attention is None:
        fused_attention = bool(fused_blocks) or use_fused_attention(
            x.shape[1], x.device)
    qk_int8 = fused_blocks == "int8"
    pair = fused_blocks == "paired" and cfg.heads % 2 == 0
    for blk in enc["blocks"]:
        h = L.layer_norm(blk["self_ln"], x, cfg.ln_eps)
        a = blk["self_attn"]
        if fused_blocks or fused_attention:
            q, k, v = (L.split_heads(L.dense(a[n], h), cfg.heads)
                       for n in ("q", "k", "v"))
        if fused_blocks:
            x = fused_attention_o_residual(
                q, k, v, x, a["o"]["w"], a["o"]["b"], pair_heads=pair,
                qk_int8=qk_int8)
        elif fused_attention:
            attn = L.merge_heads(fused_encoder_attention(q, k, v))
            x = x + L.dense(a["o"], attn)
        else:
            x = x + L.mha(a, h, h, cfg.heads)
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


def cross_kv_quantized(params, enc_out: torch.Tensor, cfg: WhisperConfig):
    """Per-layer int8 cross K/V (k8, ks, v8, vs) in the [B, H, T, D]
    layout, scales [B, H, T] (K7): computed once per segment batch, read
    every step at half the bytes of bf16. Each k/v projection is
    quantized and freed before the next is computed."""
    from ..ops.cached_attention import quantize_rows
    return [tuple(q for n in ("k", "v") for q in quantize_rows(
        L.split_heads(L.dense(blk["cross_attn"][n], enc_out), cfg.heads)))
        for blk in params["decoder"]["blocks"]]


def cross_kv_merged_int8(params, enc_out: torch.Tensor,
                         cfg: WhisperConfig):
    """Per-layer merged-head int8 cross K/V (k8, ks, v8, vs), [B, T, H*D]
    with scales [B, T, H] (K6); the k/v dense outputs are merged-head
    already. Each projection is quantized and freed before the next."""
    from ..ops.cross_attention import quantize_merged
    return [tuple(q for n in ("k", "v") for q in quantize_merged(
        L.dense(blk["cross_attn"][n], enc_out), cfg.heads))
        for blk in params["decoder"]["blocks"]]


def _cross_attend(blk, h, ckv_entry, cfg: WhisperConfig):
    """Cross-attention for one block; the K/V format picks the path, as
    in the JAX function: (k, v) 3-D merged -> K2; (k8, ks, v8, vs) 3-D
    merged -> K6; (k8, ks, v8, vs) 4-D [B, H, T, D] -> K7; (k, v) 4-D ->
    einsum."""
    return L.dense(blk["cross_attn"]["o"],
                   _cross_attention(blk, h, ckv_entry, cfg.heads))


def _cross_attention(blk, h, ckv_entry, heads: int) -> torch.Tensor:
    """_cross_attend's merged attention output [B, 1, heads*64] in h's
    dtype, before the o-projection (``heads``: the block's, or a rank's
    head shard)."""
    from ..ops.cached_attention import int8_cached_attention
    from ..ops.cross_attention import (fused_single_query_attention,
                                       fused_single_query_attention_int8)
    q = L.dense(blk["cross_attn"]["q"], h)              # [B, 1, D]
    merged = ckv_entry[0].dim() == 3
    if (merged or len(ckv_entry) == 4) and q.shape[1] != 1:
        raise ValueError("merged and int8 cross-attention are "
                         "single-query (decode steps); use cross_kv()")
    if merged and len(ckv_entry) == 4:
        o = fused_single_query_attention_int8(q[:, 0], *ckv_entry,
                                              heads=heads)
        return o[:, None, :].to(h.dtype)
    if merged:
        o = fused_single_query_attention(q[:, 0], *ckv_entry, heads=heads)
        return o[:, None, :].to(h.dtype)
    if len(ckv_entry) == 4:
        o = int8_cached_attention(L.split_heads(q, heads)[:, :, 0],
                                  *ckv_entry)
        return L.merge_heads(o[:, :, None, :].to(h.dtype))
    return L.merge_heads(L.attention_scores(L.split_heads(q, heads),
                                            *ckv_entry))


def decode_train(params, enc_out: torch.Tensor, tokens: torch.Tensor,
                 cfg: WhisperConfig) -> torch.Tensor:
    """Teacher-forced full-sequence decode -> [B, T, vocab] float32
    logits: causal self-attention over the whole prefix (JAX's
    ``causal_bias``) and cross-attention over ``cross_kv``, all in plain
    PyTorch, so autograd differentiates it (no kernel is launched)."""
    dec = params["decoder"]
    t = tokens.shape[1]
    x = dec["embed_tokens"][tokens.long()] + dec["positions"][:t][None]
    x = x.to(enc_out.dtype)
    bias = L.causal_bias(t, t, device=x.device)
    for blk, ckv_entry in zip(dec["blocks"], cross_kv(params, enc_out, cfg)):
        a = blk["self_attn"]
        # pre-norm: self q/k/v from the layer-normed hidden
        h = L.layer_norm(blk["self_ln"], x, cfg.ln_eps)
        q, k, v = (L.split_heads(L.dense(a[n], h), cfg.heads)
                   for n in ("q", "k", "v"))
        x = x + L.dense(a["o"], L.merge_heads(
            L.attention_scores(q, k, v, bias)))
        h = L.layer_norm(blk["cross_ln"], x, cfg.ln_eps)
        x = x + _cross_attend(blk, h, ckv_entry, cfg)
        h = L.layer_norm(blk["mlp_ln"], x, cfg.ln_eps)
        x = x + L.dense(blk["mlp_out"], L.gelu(L.dense(blk["mlp_in"], h)))
    x = L.layer_norm(dec["ln"], x, cfg.ln_eps)
    return _tied_logits(dec, x)


def _tied_logits(dec, x: torch.Tensor) -> torch.Tensor:
    """h @ E^T -> [..., vocab] float32. The JAX package multiplies bf16
    operands with float32 accumulation and a float32 result; the port
    multiplies the same bf16 values upcast to float32 (exact products,
    float32 sums, TF32 off), so the logits are not rounded to bf16
    before the argmax. A quantized decoder takes K5 on the int8 table. A
    tree that prepare_params did not place (training) has no float32
    table: its table is rounded to x's dtype and upcast here."""
    if "embed_tokens_q" in dec:
        from ..ops.quant import quant_dense_apply
        return quant_dense_apply(dec["embed_tokens_q"], x,
                                 out_dtype=torch.float32)
    table = dec.get("embed_tokens_f32")
    if table is None:
        table = dec["embed_tokens"].to(x.dtype).float()
    return torch.matmul(x.float(), table.t())


# ----------------------------------------------------------- cached decode
def _self_attend_cached(q1, k, v, pos: int, cfg: WhisperConfig):
    """Single-query causal attention over the merged cache: q1 [B, D],
    k/v [B, L, D] -> [B, D] f32, keys 0..pos (K2)."""
    from ..ops.cross_attention import fused_single_query_attention
    return fused_single_query_attention(q1, k, v, heads=cfg.heads, pos=pos)


def init_cache(cfg: WhisperConfig, batch: int, max_len: int, dtype,
               device, width: int | None = None):
    """Merged-head self-attention KV cache: [B, max_len, d_model]
    (``width``: a rank's head shard's, H/mp * 64)."""
    width = width or cfg.d_model
    return [{"k": torch.zeros(batch, max_len, width, dtype=dtype,
                              device=device),
             "v": torch.zeros(batch, max_len, width, dtype=dtype,
                              device=device)}
            for _ in range(cfg.dec_layers)]


def _self_args(blk) -> tuple:
    """The self sub-block's LN and bf16 q/k/v/o weights, as K3 takes them."""
    a = blk["self_attn"]
    return (blk["self_ln"]["scale"], blk["self_ln"]["bias"], a["q"]["w"],
            a["q"]["b"], a["k"]["w"], a["v"]["w"], a["v"]["b"], a["o"]["w"],
            a["o"]["b"])


def _mlp_args(blk) -> tuple:
    """The MLP sub-block's LN and bf16 weights, as K4 takes them."""
    return (blk["mlp_ln"]["scale"], blk["mlp_ln"]["bias"],
            blk["mlp_in"]["w"], blk["mlp_in"]["b"], blk["mlp_out"]["w"],
            blk["mlp_out"]["b"])


def decode_step(params, token: torch.Tensor, pos: int, cache, ckv,
                cfg: WhisperConfig, fused_layer: bool | str = False
                ) -> torch.Tensor:
    """One KV-cached decode step. token [B] int64, pos a host int;
    ``cache`` (from init_cache) is written in place at row ``pos``.
    ``fused_layer`` (False / True / "v2", taken only when B % 8 == 0)
    picks the fused sub-block kernels (module docstring). Returns logits
    [B, vocab] f32."""
    from ..ops import decoder_block as DB
    dec = params["decoder"]
    if fused_layer and "embed_tokens_q" in dec:
        raise NotImplementedError(
            "fused_layer with an int8-quantized decoder: the fused "
            "sub-block kernels take bf16 weights and the JAX package has "
            "no int8 form of them (its fused path fails with KeyError "
            "'w'); use fused_layer=False with quantize_decoder")
    dtype = cache[0]["k"].dtype
    x = (dec["embed_tokens"][token][:, None, :].float()
         + dec["positions"][pos][None, None, :].float()).to(dtype)
    fused = bool(fused_layer) and x.shape[0] % 8 == 0
    v2 = (fused and fused_layer == "v2" and len(ckv[0]) == 2
          and ckv[0][0].dim() == 3)
    for blk, layer_cache, ckv_entry in zip(dec["blocks"], cache, ckv):
        a = blk["self_attn"]
        if v2:
            from ..ops.cross_attention import fused_single_query_attention
            c = blk["cross_attn"]
            x1, _, _, qc = DB.fused_self_block_q(
                x[:, 0], *_self_args(blk), blk["cross_ln"]["scale"],
                blk["cross_ln"]["bias"], c["q"]["w"], c["q"]["b"],
                layer_cache["k"], layer_cache["v"], pos, heads=cfg.heads,
                eps=cfg.ln_eps)
            attn = fused_single_query_attention(qc, *ckv_entry,
                                                heads=cfg.heads)
            x = DB.fused_mlp_block_o(x1, attn, c["o"]["w"], c["o"]["b"],
                                     *_mlp_args(blk), eps=cfg.ln_eps)[:, None]
            continue
        if fused:
            x = DB.fused_self_block(
                x[:, 0], *_self_args(blk), layer_cache["k"],
                layer_cache["v"], pos, heads=cfg.heads,
                eps=cfg.ln_eps)[0][:, None]
        else:
            h = L.layer_norm(blk["self_ln"], x, cfg.ln_eps)
            # dense outputs ARE the merged-head layout: one row write each
            layer_cache["k"][:, pos] = L.dense(a["k"], h)[:, 0]
            layer_cache["v"][:, pos] = L.dense(a["v"], h)[:, 0]
            q1 = L.dense(a["q"], h)[:, 0, :]
            attn = _self_attend_cached(q1, layer_cache["k"],
                                       layer_cache["v"], pos, cfg)
            x = x + L.dense(a["o"], attn[:, None, :].to(dtype))
        h = L.layer_norm(blk["cross_ln"], x, cfg.ln_eps)
        x = x + _cross_attend(blk, h, ckv_entry, cfg)
        if fused:
            x = DB.fused_mlp_block(x[:, 0], *_mlp_args(blk),
                                   eps=cfg.ln_eps)[:, None]
        else:
            h = L.layer_norm(blk["mlp_ln"], x, cfg.ln_eps)
            x = x + L.dense(blk["mlp_out"],
                            L.gelu(L.dense(blk["mlp_in"], h)))
    x = L.layer_norm(dec["ln"], x, cfg.ln_eps)
    return _tied_logits(dec, x[:, 0, :])


# ------------------------------------------------- tensor parallelism (TP)
def _tp_devices(trees) -> list[torch.device]:
    """Each rank's device: where its tree's token table lies."""
    return [t["decoder"]["embed_tokens"].device for t in trees]


def _tp_heads(trees, cfg: WhisperConfig) -> int:
    """The heads of a rank's shard (H / mp)."""
    if cfg.heads % len(trees):
        raise ValueError(f"{cfg.heads} heads do not split into "
                         f"{len(trees)} ranks")
    return cfg.heads // len(trees)


def encode_tp(trees, mel: torch.Tensor, cfg: WhisperConfig,
              fused_attention: bool | None = None,
              fused_blocks: bool | str = False) -> list[torch.Tensor]:
    """``encode`` over one data row's model axis: ``trees`` the ranks'
    head shards (parallel/mesh.py::shard_heads), ``mel`` on the first
    rank's device. The conv stem runs on the first rank; each layer's
    attention runs each rank's heads on its device -- K1p (``fused_blocks``
    True), K9p ("int8"), K10p ("paired": the rank's heads in pairs, or
    K1p where a rank holds an odd count, as ``encode`` takes K1 for an odd
    head count), K8 and a plain partial o-projection
    (``fused_attention``), or the plain partial -- and the MLP each rank's
    F/mp columns, each ending in model_sum. Returns the encoder output on
    every rank's device (rank order)."""
    from ..ops.attention import fused_encoder_attention
    from ..ops.encoder_block import fused_attention_o_residual
    from ..parallel.mesh import model_sum
    devs, hl = _tp_devices(trees), _tp_heads(trees, cfg)
    qk_int8 = fused_blocks == "int8"
    pair = fused_blocks == "paired" and hl % 2 == 0
    enc0 = trees[0]["encoder"]
    x = mel.transpose(1, 2)
    x = L.gelu(_conv1d(enc0["conv1"], x, 1))
    x = L.gelu(_conv1d(enc0["conv2"], x, 2))
    x = x + enc0["positions"][: x.shape[1]][None].to(x.dtype)
    if fused_attention is None:
        fused_attention = bool(fused_blocks) or use_fused_attention(
            x.shape[1], x.device)
    xs = [x.to(d) for d in devs]
    for i, blk0 in enumerate(enc0["blocks"]):
        parts = []
        for t, xj in zip(trees, xs):
            blk = t["encoder"]["blocks"][i]
            h = L.layer_norm(blk["self_ln"], xj, cfg.ln_eps)
            a = blk["self_attn"]
            if fused_blocks or fused_attention:
                q, k, v = (L.split_heads(L.dense(a[n], h), hl)
                           for n in ("q", "k", "v"))
            if fused_blocks:
                parts.append(fused_attention_o_residual(
                    q, k, v, None, a["o"]["w"], None, pair_heads=pair,
                    qk_int8=qk_int8, partial=True))
            elif fused_attention:
                parts.append(L.dense_partial(a["o"]["w"], L.merge_heads(
                    fused_encoder_attention(q, k, v))))
            else:
                parts.append(L.mha_partial(a, h, h, hl))
        xs = model_sum(parts, blk0["self_attn"]["o"]["b"], xs)
        parts = []
        for t, xj in zip(trees, xs):
            blk = t["encoder"]["blocks"][i]
            h = L.layer_norm(blk["mlp_ln"], xj, cfg.ln_eps)
            parts.append(L.dense_partial(
                blk["mlp_out"]["w"], L.gelu(L.dense(blk["mlp_in"], h))))
        xs = model_sum(parts, blk0["mlp_out"]["b"], xs)
    out = L.layer_norm(enc0["ln"], xs[0], cfg.ln_eps)
    return [out.to(d) for d in devs]


def decode_train_tp(trees, encs: list, tokens: torch.Tensor,
                    cfg: WhisperConfig) -> torch.Tensor:
    """``decode_train`` over one data row's model axis, plain PyTorch
    under autograd: ``encs`` the encoder output on every rank's device
    (encode_tp), ``tokens`` on the first rank's. The token and position
    embedding run on the first rank; each layer's causal self-attention
    and cross-attention (over the rank's own ``cross_kv`` heads) run each
    rank's H/mp heads (layers.mha_partial, the plain partials), the MLP
    each rank's F/mp columns, each ending in model_sum; the final layer
    norm and the tied logits run on the first rank. Returns [B, T, vocab]
    float32 logits there."""
    from ..parallel.mesh import model_sum
    devs, hl = _tp_devices(trees), _tp_heads(trees, cfg)
    dec0 = trees[0]["decoder"]
    t = tokens.shape[1]
    x = dec0["embed_tokens"][tokens.long()] + dec0["positions"][:t][None]
    xs = [x.to(encs[0].dtype).to(d) for d in devs]
    biases = [L.causal_bias(t, t, device=d) for d in devs]
    ckvs = cross_kv_tp(trees, encs, cfg)
    for i, blk0 in enumerate(dec0["blocks"]):
        blks = [tr["decoder"]["blocks"][i] for tr in trees]
        parts = []
        for blk, xj, bias in zip(blks, xs, biases):
            h = L.layer_norm(blk["self_ln"], xj, cfg.ln_eps)
            parts.append(L.mha_partial(blk["self_attn"], h, h, hl, bias))
        xs = model_sum(parts, blk0["self_attn"]["o"]["b"], xs)
        parts = []
        for blk, xj, ckv in zip(blks, xs, ckvs):
            h = L.layer_norm(blk["cross_ln"], xj, cfg.ln_eps)
            parts.append(L.dense_partial(
                blk["cross_attn"]["o"]["w"],
                _cross_attention(blk, h, ckv[i], hl)))
        xs = model_sum(parts, blk0["cross_attn"]["o"]["b"], xs)
        parts = []
        for blk, xj in zip(blks, xs):
            h = L.layer_norm(blk["mlp_ln"], xj, cfg.ln_eps)
            parts.append(L.dense_partial(
                blk["mlp_out"]["w"], L.gelu(L.dense(blk["mlp_in"], h))))
        xs = model_sum(parts, blk0["mlp_out"]["b"], xs)
    x = L.layer_norm(dec0["ln"], xs[0], cfg.ln_eps)
    return _tied_logits(dec0, x)


def _tp_local(trees, encs: list, cfg: WhisperConfig, fn) -> list:
    """``fn(tree, enc, cfg)`` on each rank, cfg's heads the rank's
    H/mp."""
    local = dataclasses.replace(cfg, heads=_tp_heads(trees, cfg))
    return [fn(t, e, local) for t, e in zip(trees, encs)]


def cross_kv_merged_tp(trees, encs: list, cfg: WhisperConfig) -> list:
    """Each rank's cross_kv_merged over its heads: [B, T, H/mp * 64]
    cross K/V a layer, on its device (column-parallel k/v projections)."""
    return _tp_local(trees, encs, cfg, cross_kv_merged)


def cross_kv_tp(trees, encs: list, cfg: WhisperConfig) -> list:
    """Each rank's cross_kv (the [B, H/mp, T, 64] einsum format)."""
    return _tp_local(trees, encs, cfg, cross_kv)


def cross_kv_quantized_tp(trees, encs: list, cfg: WhisperConfig) -> list:
    """Each rank's cross_kv_quantized (K7's int8 [B, H/mp, T, 64] K/V and
    [B, H/mp, T] scales): quantized per (b, h, t) row, so a rank's codes
    and scales are the whole layer's for its heads."""
    return _tp_local(trees, encs, cfg, cross_kv_quantized)


def cross_kv_merged_int8_tp(trees, encs: list, cfg: WhisperConfig) -> list:
    """Each rank's cross_kv_merged_int8 (K6's int8 [B, T, H/mp * 64] K/V
    and [B, T, H/mp] scales), quantized per (b, t, head) as the whole
    layer's."""
    return _tp_local(trees, encs, cfg, cross_kv_merged_int8)


def init_cache_tp(trees, cfg: WhisperConfig, batch: int, max_len: int,
                  dtype) -> list:
    """Each rank's self-attention cache, [B, max_len, d_model / mp] (its
    H/mp heads) a layer, on its device."""
    _tp_heads(trees, cfg)
    return [init_cache(cfg, batch, max_len, dtype, d,
                       cfg.d_model // len(trees))
            for d in _tp_devices(trees)]


def _row_partial(p, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel layer's float32 share on one rank, without its
    bias: K5 on an int8 leaf's row shard of codes (the whole per-column
    scale), layers.dense_partial on a float one."""
    if "wq" in p:
        from ..ops.quant import quant_matmul
        y = quant_matmul(x.reshape(-1, x.shape[-1]), p["wq"], p["scale"])
        return y.reshape(*x.shape[:-1], -1)
    return L.dense_partial(p["w"], x)


def decode_step_tp(trees, token: torch.Tensor, pos: int, caches: list,
                   ckvs: list, cfg: WhisperConfig,
                   fused_layer: bool | str = False) -> torch.Tensor:
    """``decode_step`` over one data row's model axis: ``caches`` and
    ``ckvs`` a rank's each (init_cache_tp, and a ``cross_kv_*_tp``: the
    cross K/V format picks K2, K6 or K7 on the rank's heads, as
    _cross_attend does), written in place at row ``pos``; ``token`` [B]
    on the first rank's device, copied to every rank for its embedding
    lookup. Each sub-block runs each rank's heads (or F/mp MLP columns)
    on its device and ends in model_sum: ``fused_layer`` True (B % 8 ==
    0) takes K3p for the self sub-block and K4p for the MLP, with the
    cross attention between them; otherwise K2 for the self attention and
    the plain partials. An int8 decoder runs every dense layer through K5:
    q/k/v and mlp_in on their column shards (bias added), o and mlp_out
    on their row shards (float32, no bias, ending in model_sum), and the
    logits from its table on the first rank; ``fused_layer`` with it
    raises, as in decode_step. ``fused_layer="v2"`` runs the True form
    here: K3-q's tail needs the layer norm of the summed x_out, and
    K4-o's head adds the summed cross o-projection before the MLP's layer
    norm, and neither sum exists inside one rank's kernel (the JAX
    decode_step, whose gate turns "v2" into True, computes the same).
    Returns the logits [B, vocab] float32 on the first rank's device."""
    from ..ops import decoder_block as DB
    from ..ops.cross_attention import fused_single_query_attention
    from ..parallel.mesh import model_sum
    if fused_layer and "embed_tokens_q" in trees[0]["decoder"]:
        raise NotImplementedError(
            "fused_layer with an int8-quantized decoder: the fused "
            "sub-block kernels take bf16 weights (decode_step); use "
            "fused_layer=False with quantize_decoder")
    devs, hl = _tp_devices(trees), _tp_heads(trees, cfg)
    dtype = caches[0][0]["k"].dtype
    xs = []
    for t, d in zip(trees, devs):
        dec = t["decoder"]
        xs.append((dec["embed_tokens"][token.to(d)][:, None, :].float()
                   + dec["positions"][pos][None, None, :].float()).to(dtype))
    fused = bool(fused_layer) and xs[0].shape[0] % 8 == 0
    for i, blk0 in enumerate(trees[0]["decoder"]["blocks"]):
        parts = []
        for t, xj, cache in zip(trees, xs, caches):
            blk, lc = t["decoder"]["blocks"][i], cache[i]
            if fused:
                parts.append(DB.fused_self_block(
                    xj[:, 0], *_self_args(blk), lc["k"], lc["v"], pos,
                    heads=hl, eps=cfg.ln_eps, partial=True)[0][:, None])
                continue
            a = blk["self_attn"]
            h = L.layer_norm(blk["self_ln"], xj, cfg.ln_eps)
            lc["k"][:, pos] = L.dense(a["k"], h)[:, 0]
            lc["v"][:, pos] = L.dense(a["v"], h)[:, 0]
            attn = fused_single_query_attention(
                L.dense(a["q"], h)[:, 0, :], lc["k"], lc["v"], heads=hl,
                pos=pos)
            parts.append(_row_partial(a["o"], attn[:, None, :].to(dtype)))
        xs = model_sum(parts, blk0["self_attn"]["o"]["b"], xs)
        parts = []
        for t, xj, ckv in zip(trees, xs, ckvs):
            blk = t["decoder"]["blocks"][i]
            h = L.layer_norm(blk["cross_ln"], xj, cfg.ln_eps)
            parts.append(_row_partial(blk["cross_attn"]["o"],
                                      _cross_attention(blk, h, ckv[i], hl)))
        xs = model_sum(parts, blk0["cross_attn"]["o"]["b"], xs)
        parts = []
        for t, xj in zip(trees, xs):
            blk = t["decoder"]["blocks"][i]
            if fused:
                parts.append(DB.fused_mlp_block(
                    xj[:, 0], *_mlp_args(blk), eps=cfg.ln_eps,
                    partial=True)[:, None])
                continue
            h = L.layer_norm(blk["mlp_ln"], xj, cfg.ln_eps)
            parts.append(_row_partial(
                blk["mlp_out"], L.gelu(L.dense(blk["mlp_in"], h))))
        xs = model_sum(parts, blk0["mlp_out"]["b"], xs)
    dec0 = trees[0]["decoder"]
    x = L.layer_norm(dec0["ln"], xs[0], cfg.ln_eps)
    return _tied_logits(dec0, x[:, 0, :])


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
