"""CLAP-style dual-tower audio/text embedding (the historical v1 capability).

Counterpart of ``multimodal_audio_search_tpu/models/clap.py``: the
lightweight trainable tower pair that ``pipelines/clap_ingest.py``
searches with (weight parity with laion's checkpoints is
``models/clap_htsat.py``):

  * audio tower: log-mel -> patches of ``patch_frames`` frames -> dense
    patch embedding + learned positions -> pre-norm transformer ->
    attention pooling with a learned query -> 512-D projection;
  * text tower: the MiniLM backbone (models/minilm.py) -> mean pool ->
    linear projection;
  * both L2-normalised into one space. ``contrastive_loss`` is the
    symmetric InfoNCE the JAX training loop minimises; autograd gives its
    gradient (the training loop: training/clap.py);
  * ``audio_embed_tp`` / ``text_embed_tp``: both towers over one data
    row's model axis (parallel/mesh.py), plain PyTorch, for training
    over ``model_parallel > 1``.

Same param keys and layouts as the JAX tree.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import layers as L
from .minilm import MiniLMConfig, encode_tokens, encode_tokens_tp


@dataclass(frozen=True)
class ClapConfig:
    embed_dim: int = 512
    d_model: int = 256
    layers: int = 4
    heads: int = 4
    ffn: int = 1024
    n_mels: int = 80
    patch_frames: int = 10       # 10 mel frames per patch (100 ms)
    max_patches: int = 300       # 30 s / 100 ms
    ln_eps: float = 1e-5


def init_audio_tower(gen: torch.Generator, cfg: ClapConfig = ClapConfig()):
    """Random init (float32, CPU) with the JAX package's shapes/scales."""
    d = cfg.d_model
    return {
        "patch": L.init_dense(gen, cfg.n_mels * cfg.patch_frames, d),
        "positions": torch.randn(cfg.max_patches, d, generator=gen) * 0.02,
        "blocks": [{
            "self_attn": L.init_mha(gen, d),
            "self_ln": L.init_layer_norm(d),
            "mlp_in": L.init_dense(gen, d, cfg.ffn),
            "mlp_out": L.init_dense(gen, cfg.ffn, d),
            "mlp_ln": L.init_layer_norm(d),
        } for _ in range(cfg.layers)],
        "ln": L.init_layer_norm(d),
        "pool_q": torch.randn(1, d, generator=gen) * 0.02,
        "proj": L.init_dense(gen, d, cfg.embed_dim),
    }


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / z.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def _patch_embed(params, mel: torch.Tensor, cfg: ClapConfig):
    """[B, n_mels, T] log-mel -> [B, T / patch_frames, d_model] patch
    embeddings + positions."""
    b, m, t = mel.shape
    pf = cfg.patch_frames
    n_patch = t // pf
    x = mel[:, :, : n_patch * pf].reshape(b, m, n_patch, pf)
    x = x.permute(0, 2, 1, 3).reshape(b, n_patch, m * pf)
    x = L.dense(params["patch"], x)
    return x + params["positions"][:n_patch][None].to(x.dtype)


def _pool_project(params, x: torch.Tensor, cfg: ClapConfig):
    """The tower's head: final layer norm, attention pooling with the
    learned query, projection, L2 normalisation."""
    b = x.shape[0]
    x = L.layer_norm(params["ln"], x, cfg.ln_eps)
    q = params["pool_q"][None].to(x.dtype).expand(b, 1, x.shape[-1])
    w = torch.softmax(torch.matmul(q.float(), x.float().transpose(1, 2)),
                      dim=-1)                                 # [B, 1, T]
    pooled = torch.matmul(w.to(x.dtype), x)[:, 0]
    return _unit(L.dense(params["proj"], pooled).float())


def audio_embed(params, mel: torch.Tensor,
                cfg: ClapConfig = ClapConfig()) -> torch.Tensor:
    """[B, n_mels, T] log-mel -> [B, embed_dim] unit-norm embeddings."""
    x = _patch_embed(params, mel, cfg)
    for blk in params["blocks"]:
        h = L.layer_norm(blk["self_ln"], x, cfg.ln_eps)
        x = x + L.mha(blk["self_attn"], h, h, cfg.heads)
        h = L.layer_norm(blk["mlp_ln"], x, cfg.ln_eps)
        x = x + L.dense(blk["mlp_out"], L.gelu(L.dense(blk["mlp_in"], h)))
    return _pool_project(params, x, cfg)


def audio_embed_tp(trees, mel: torch.Tensor,
                   cfg: ClapConfig = ClapConfig()) -> torch.Tensor:
    """audio_embed over one data row's model axis (parallel/mesh.py):
    ``trees`` the ranks' head shards of the audio tower, ``mel`` on the
    first rank's device. The patch embedding and positions run on the
    first rank; each block's attention runs each rank's H/mp heads
    (layers.mha_partial) and its MLP each rank's F/mp columns, each
    ending in model_sum; the final layer norm, pooling and projection
    run on the first rank. Plain PyTorch (training); the embeddings on
    the first rank's device."""
    from ..parallel.mesh import model_sum
    mp = len(trees)
    if cfg.heads % mp:
        raise ValueError(f"{cfg.heads} heads do not split into {mp} ranks")
    hl = cfg.heads // mp
    x = _patch_embed(trees[0], mel, cfg)
    xs = [x.to(t["patch"]["w"].device) for t in trees]
    for i, blk0 in enumerate(trees[0]["blocks"]):
        blks = [t["blocks"][i] for t in trees]
        parts = []
        for blk, xj in zip(blks, xs):
            h = L.layer_norm(blk["self_ln"], xj, cfg.ln_eps)
            parts.append(L.mha_partial(blk["self_attn"], h, h, hl))
        xs = model_sum(parts, blk0["self_attn"]["o"]["b"], xs)
        parts = []
        for blk, xj in zip(blks, xs):
            h = L.layer_norm(blk["mlp_ln"], xj, cfg.ln_eps)
            parts.append(L.dense_partial(
                blk["mlp_out"]["w"], L.gelu(L.dense(blk["mlp_in"], h))))
        xs = model_sum(parts, blk0["mlp_out"]["b"], xs)
    return _pool_project(trees[0], xs[0], cfg)


def init_text_projection(gen: torch.Generator, text_cfg: MiniLMConfig,
                         cfg: ClapConfig = ClapConfig()):
    return L.init_dense(gen, text_cfg.hidden, cfg.embed_dim)


def text_embed(bert_params, proj_params, input_ids, attention_mask,
               text_cfg: MiniLMConfig,
               cfg: ClapConfig = ClapConfig()) -> torch.Tensor:
    """Text tower: MiniLM backbone -> mean pool -> projection -> L2."""
    h = encode_tokens(bert_params, input_ids, attention_mask, text_cfg)
    return _text_head(proj_params, h, attention_mask)


def text_embed_tp(bert_trees, proj_params, input_ids, attention_mask,
                  text_cfg: MiniLMConfig,
                  cfg: ClapConfig = ClapConfig()) -> torch.Tensor:
    """text_embed over one data row's model axis: ``bert_trees`` the
    ranks' head shards of the backbone (minilm.encode_tokens_tp), the
    pooling and ``proj_params`` (the first rank's) on the first rank's
    device."""
    h = encode_tokens_tp(bert_trees, input_ids, attention_mask, text_cfg)
    return _text_head(proj_params, h, attention_mask)


def _text_head(proj_params, h: torch.Tensor,
               attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pool of the backbone's states -> projection -> L2."""
    h = h.float()
    m = attention_mask.float()[:, :, None]
    pooled = (h * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
    return _unit(L.dense(proj_params, pooled))


def contrastive_loss(audio_z: torch.Tensor, text_z: torch.Tensor,
                     temperature: float = 0.07) -> torch.Tensor:
    """Symmetric InfoNCE over a batch of (audio, text) pairs."""
    logits = audio_z @ text_z.T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    la = optax_softmax_ce(logits, labels)
    lt = optax_softmax_ce(logits.T, labels)
    return 0.5 * (la + lt)


def optax_softmax_ce(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of integer ``labels`` (the JAX module's
    hand-written form of optax's)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[torch.arange(logits.shape[0], device=logits.device),
                 labels].mean()
