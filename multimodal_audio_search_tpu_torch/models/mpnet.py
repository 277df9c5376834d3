"""MPNet sentence encoder (all-mpnet-base-v2) as plain PyTorch functions.

Counterpart of ``multimodal_audio_search_tpu/models/mpnet.py``: the
minilm/BERT layer stack with RoBERTa-style position ids (consecutive
from ``pad_token_id + 1`` over non-pad tokens, ``pad_token_id`` at
padding; no token types) and a T5-style relative position bias -- one
shared ``[rel_buckets, heads]`` table, bucketed bidirectionally with
``rel_max_distance`` -- added to every layer's attention scores. Same
param keys and layouts; weights convert from any HF ``MPNetModel`` with
``models/convert.py::convert_mpnet``.

``sentence_embed_tp`` runs the encoder over one data row's model axis
(minilm.encode_layers_tp), each rank with its heads' columns of the
position bias table.

The bucket table of a length T is computed once on the CPU in float32
and cached, then moved to the params' device: the buckets are integers
that JAX and HF compute with a float32 log, and the card's division by a
scalar (a multiply by the reciprocal) could move one across a boundary.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from . import layers as L
from .minilm import encode_layers_tp, unit_mean_pool


@dataclass(frozen=True)
class MPNetConfig:
    vocab_size: int = 30527
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 514
    pad_token_id: int = 1          # also the padding_idx of the embeddings
    rel_buckets: int = 32
    rel_max_distance: int = 128
    ln_eps: float = 1e-5


PRESETS = {
    # sentence-transformers/all-mpnet-base-v2 geometry
    "base": MPNetConfig(),
}


def init_params(gen: torch.Generator, cfg: MPNetConfig = MPNetConfig()):
    """Random init (float32, CPU) with the JAX package's shapes/scales."""
    emb = {
        "word": torch.randn(cfg.vocab_size, cfg.hidden, generator=gen) * 0.02,
        "position": torch.randn(cfg.max_positions, cfg.hidden,
                                generator=gen) * 0.02,
        "ln": L.init_layer_norm(cfg.hidden),
    }
    rel_bias = torch.randn(cfg.rel_buckets, cfg.heads, generator=gen) * 0.02
    blocks = [{
        "attn": L.init_mha(gen, cfg.hidden),
        "attn_ln": L.init_layer_norm(cfg.hidden),
        "mlp_in": L.init_dense(gen, cfg.hidden, cfg.intermediate),
        "mlp_out": L.init_dense(gen, cfg.intermediate, cfg.hidden),
        "mlp_ln": L.init_layer_norm(cfg.hidden),
    } for _ in range(cfg.layers)]
    return {"embeddings": emb, "rel_bias": rel_bias, "blocks": blocks}


def _relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5/MPNet bidirectional bucketing of ``memory_pos - context_pos``
    (transformers MPNetEncoder.relative_position_bucket semantics). As in
    JAX and HF, log(0) at distance 0 is cast to an integer before the
    ``where`` discards it, and the cast truncates toward zero."""
    n = -rel_pos
    num_buckets //= 2
    ret = (n < 0).to(torch.int32) * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_if_large)


@functools.lru_cache(maxsize=16)
def _bucket_table(t: int, num_buckets: int,
                  max_distance: int) -> torch.Tensor:
    """[T, T] bucket of (memory, context) pairs, on the CPU (a normal
    tensor even when first asked for under inference mode)."""
    with torch.inference_mode(False):
        pos = torch.arange(t)
        return _relative_position_bucket(pos[None, :] - pos[:, None],
                                         num_buckets, max_distance)


def position_bias(rel_bias: torch.Tensor, t: int,
                  cfg: MPNetConfig) -> torch.Tensor:
    """[1, H, T, T] additive attention bias shared by every layer."""
    bucket = _bucket_table(t, cfg.rel_buckets, cfg.rel_max_distance)
    values = rel_bias[bucket.to(rel_bias.device)]           # [T, T, H]
    return values.permute(2, 0, 1)[None]


def _position_ids(input_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """RoBERTa-style: consecutive ids starting at pad_id + 1 for non-pad
    tokens, pad_id at padding (create_position_ids_from_input_ids)."""
    mask = (input_ids != pad_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_id


def encode_tokens(params, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor,
                  cfg: MPNetConfig = MPNetConfig()) -> torch.Tensor:
    """[B, T] ids + mask -> [B, T, H] hidden states."""
    emb = params["embeddings"]
    t = input_ids.shape[1]
    pos_ids = _position_ids(input_ids, cfg.pad_token_id)
    x = emb["word"][input_ids] + emb["position"][pos_ids]
    x = L.layer_norm(emb["ln"], x, cfg.ln_eps)
    bias = L.padding_bias(attention_mask) \
        + position_bias(params["rel_bias"], t, cfg).float()
    for blk in params["blocks"]:
        a = L.mha(blk["attn"], x, x, cfg.heads, bias)
        x = L.layer_norm(blk["attn_ln"], x + a, cfg.ln_eps)
        h = L.dense(blk["mlp_out"], L.gelu(L.dense(blk["mlp_in"], x)))
        x = L.layer_norm(blk["mlp_ln"], x + h, cfg.ln_eps)
    return x


def sentence_embed(params, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor,
                   cfg: MPNetConfig = MPNetConfig()) -> torch.Tensor:
    """[B, T] -> [B, H] unit-norm sentence embeddings (mean pool + L2),
    the sentence-transformers all-mpnet-base-v2 head."""
    return unit_mean_pool(encode_tokens(params, input_ids, attention_mask,
                                        cfg), attention_mask)


def sentence_embed_tp(trees, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor,
                      cfg: MPNetConfig = MPNetConfig()) -> torch.Tensor:
    """sentence_embed over one data row's model axis: ``trees`` the
    ranks' head shards (parallel/mesh.py::shard_heads, which splits the
    [buckets, heads] bias table by head), ids and mask on the first
    rank's device; the embeddings on that device."""
    emb = trees[0]["embeddings"]
    t = input_ids.shape[1]
    pos_ids = _position_ids(input_ids, cfg.pad_token_id)
    x = emb["word"][input_ids] + emb["position"][pos_ids]
    x = L.layer_norm(emb["ln"], x, cfg.ln_eps)
    pad = L.padding_bias(attention_mask)
    biases = [pad.to(tr["rel_bias"].device)
              + position_bias(tr["rel_bias"], t, cfg).float()
              for tr in trees]
    return unit_mean_pool(encode_layers_tp(trees, x, biases, cfg.heads,
                                           cfg.ln_eps), attention_mask)
