"""MiniLM sentence encoder (all-MiniLM-L6-v2) as plain PyTorch functions.

Counterpart of ``multimodal_audio_search_tpu/models/minilm.py``: a
post-layernorm BERT encoder (LN eps 1e-12, learned absolute positions,
token-type embeddings, erf-GELU) -> attention-masked mean pooling -> L2
normalisation. Same param keys and layouts.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import layers as L


@dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_positions: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12


PRESETS = {
    "L6": MiniLMConfig(),
    "test": MiniLMConfig(vocab_size=512, hidden=64, layers=2, heads=4,
                         intermediate=128),
}


def init_params(gen: torch.Generator, cfg: MiniLMConfig = MiniLMConfig()):
    """Random init (float32, CPU) with the JAX package's shapes/scales."""
    emb = {
        "word": torch.randn(cfg.vocab_size, cfg.hidden, generator=gen) * 0.02,
        "position": torch.randn(cfg.max_positions, cfg.hidden,
                                generator=gen) * 0.02,
        "token_type": torch.randn(cfg.type_vocab, cfg.hidden,
                                  generator=gen) * 0.02,
        "ln": L.init_layer_norm(cfg.hidden),
    }
    blocks = [{
        "attn": L.init_mha(gen, cfg.hidden),
        "attn_ln": L.init_layer_norm(cfg.hidden),
        "mlp_in": L.init_dense(gen, cfg.hidden, cfg.intermediate),
        "mlp_out": L.init_dense(gen, cfg.intermediate, cfg.hidden),
        "mlp_ln": L.init_layer_norm(cfg.hidden),
    } for _ in range(cfg.layers)]
    return {"embeddings": emb, "blocks": blocks}


def encode_tokens(params, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor,
                  cfg: MiniLMConfig = MiniLMConfig()) -> torch.Tensor:
    """[B, T] ids + mask -> [B, T, H] hidden states (BERT encoder)."""
    emb = params["embeddings"]
    t = input_ids.shape[1]
    x = emb["word"][input_ids] + emb["position"][:t][None]
    if cfg.type_vocab:
        x = x + emb["token_type"][0][None, None]
    x = L.layer_norm(emb["ln"], x, cfg.ln_eps)
    bias = L.padding_bias(attention_mask)
    for blk in params["blocks"]:
        a = L.mha(blk["attn"], x, x, cfg.heads, bias)
        x = L.layer_norm(blk["attn_ln"], x + a, cfg.ln_eps)
        h = L.dense(blk["mlp_out"], L.gelu(L.dense(blk["mlp_in"], x)))
        x = L.layer_norm(blk["mlp_ln"], x + h, cfg.ln_eps)
    return x


def sentence_embed(params, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor,
                   cfg: MiniLMConfig = MiniLMConfig()) -> torch.Tensor:
    """[B, T] -> [B, H] unit-norm sentence embeddings (mean pool + L2)."""
    h = encode_tokens(params, input_ids, attention_mask, cfg).float()
    m = attention_mask.float()[:, :, None]
    pooled = (h * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)
