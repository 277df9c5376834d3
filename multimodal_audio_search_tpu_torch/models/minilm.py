"""MiniLM sentence encoder (all-MiniLM-L6-v2) as plain PyTorch functions.

Counterpart of ``multimodal_audio_search_tpu/models/minilm.py``: a
post-layernorm BERT encoder (LN eps 1e-12, learned absolute positions,
token-type embeddings, erf-GELU) -> attention-masked mean pooling -> L2
normalisation. Same param keys and layouts; ``mean_pool`` and
``sentence_projection`` (the sentence-transformers Dense head) as in
JAX. ``encode_tokens_tp`` / ``sentence_embed_tp`` run the encoder over
one data row's model axis (parallel/mesh.py): each rank's head shard
and F/mp of the MLP on its device, every row-parallel product ending in
``model_sum``.
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
    # all-MiniLM-L6-v2 (the reference's default embedder)
    "L6": MiniLMConfig(),
    # the JAX package's all-mpnet-base-v2-shaped BERT stand-in
    "base768": MiniLMConfig(hidden=768, layers=12, heads=12,
                            intermediate=3072),
    # clip-ViT-B-32-multilingual-v1's text tower: a 6-layer multilingual
    # DistilBERT (no token-type embeddings); the engine serves its
    # mean-pooled 768-D output, as the JAX engine does (the upstream
    # model's 768->512 projection is ``sentence_projection``)
    "clip512_text": MiniLMConfig(vocab_size=119_547, hidden=768, layers=6,
                                 heads=12, intermediate=3072, type_vocab=0),
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
    return unit_mean_pool(encode_tokens(params, input_ids, attention_mask,
                                        cfg), attention_mask)


def unit_mean_pool(h: torch.Tensor, attention_mask: torch.Tensor
                   ) -> torch.Tensor:
    """mean_pool, then L2-normalised: the sentence embedding of the
    encoder's hidden states."""
    pooled = mean_pool(h, attention_mask)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def encode_layers_tp(trees, x: torch.Tensor, biases: list, heads: int,
                     eps: float) -> torch.Tensor:
    """The post-LN layer stack over one data row's model axis: ``trees``
    the ranks' head shards (parallel/mesh.py::shard_heads) with their
    ``blocks``, ``x`` the embedded rows on the first rank's device,
    ``biases`` each rank's additive attention bias on its device. Each
    rank attends its heads (layers.mha_partial) and runs its F/mp MLP
    columns; the partials meet in model_sum and each rank normalises its
    copy. Returns the hidden states on the first rank's device."""
    from ..parallel.mesh import model_sum
    mp = len(trees)
    if heads % mp:
        raise ValueError(f"{heads} heads do not split into {mp} ranks")
    xs = [x.to(b.device) for b in biases]
    for i, blk0 in enumerate(trees[0]["blocks"]):
        parts = [L.mha_partial(t["blocks"][i]["attn"], xj, xj, heads // mp,
                               bj) for t, xj, bj in zip(trees, xs, biases)]
        xs = [L.layer_norm(t["blocks"][i]["attn_ln"], xj, eps) for t, xj in
              zip(trees, model_sum(parts, blk0["attn"]["o"]["b"], xs))]
        parts = [L.dense_partial(t["blocks"][i]["mlp_out"]["w"], L.gelu(
            L.dense(t["blocks"][i]["mlp_in"], xj)))
            for t, xj in zip(trees, xs)]
        xs = [L.layer_norm(t["blocks"][i]["mlp_ln"], xj, eps) for t, xj in
              zip(trees, model_sum(parts, blk0["mlp_out"]["b"], xs))]
    return xs[0]


def encode_tokens_tp(trees, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor,
                     cfg: MiniLMConfig = MiniLMConfig()) -> torch.Tensor:
    """encode_tokens over one data row's model axis (encode_layers_tp):
    ``trees`` the ranks' head shards, ids and mask on the first rank's
    device, where the embedding stem runs; the [B, T, H] hidden states on
    that device. Plain PyTorch, so autograd differentiates it (the CLAP
    text tower's training, training/clap.py)."""
    emb = trees[0]["embeddings"]
    t = input_ids.shape[1]
    x = emb["word"][input_ids] + emb["position"][:t][None]
    if cfg.type_vocab:
        x = x + emb["token_type"][0][None, None]
    x = L.layer_norm(emb["ln"], x, cfg.ln_eps)
    bias = L.padding_bias(attention_mask)
    biases = [bias.to(tr["embeddings"]["word"].device) for tr in trees]
    return encode_layers_tp(trees, x, biases, cfg.heads, cfg.ln_eps)


def sentence_embed_tp(trees, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor,
                      cfg: MiniLMConfig = MiniLMConfig()) -> torch.Tensor:
    """sentence_embed over one data row's model axis (encode_tokens_tp):
    the embeddings on the first rank's device."""
    return unit_mean_pool(encode_tokens_tp(trees, input_ids, attention_mask,
                                           cfg), attention_mask)


def sentence_projection(params, pooled: torch.Tensor,
                        tanh: bool = False) -> torch.Tensor:
    """sentence-transformers Dense head (e.g. the 768->512 CLIP projection
    of clip-ViT-B-32-multilingual-v1): linear (+optional tanh) + L2 norm.
    ``params`` is a models.layers dense tree ({"w","b"})."""
    z = L.dense(params, pooled).float()
    if tanh:
        z = torch.tanh(z)
    return z / z.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def mean_pool(h: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Attention-masked mean pooling ([B,T,H], [B,T]) -> [B,H] float32."""
    m = attention_mask.float()[:, :, None]
    return (h.float() * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
