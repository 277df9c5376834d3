"""AudioToTextEmbeddingBridge -- the lightweight trainable audio embedder.

Counterpart of ``multimodal_audio_search_tpu/models/bridge.py``: an MLP
mapping 128-D classic DSP features (``ops/audio_features.py``) into the
384-D MiniLM text-embedding space, 128 -> 256 -> 512 -> 384 with ReLU +
dropout and a Tanh output, L2-normalised; Xavier-scaled init and a
fitted-then-fixed feature standardisation. Same param keys and layouts.
The forward pass is here; the training loop is training/bridge.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import layers as L


@dataclass(frozen=True)
class BridgeConfig:
    in_dim: int = 128
    hidden: tuple = (256, 512)
    out_dim: int = 384
    dropout: float = 0.2
    xavier_init: bool = True
    standardize: bool = True


def init_params(gen: torch.Generator, cfg: BridgeConfig = BridgeConfig()):
    """Random init (float32, CPU) with the JAX package's shapes/scales."""
    dims = (cfg.in_dim, *cfg.hidden, cfg.out_dim)
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        std = math.sqrt(2.0 / (d_in + d_out)) if cfg.xavier_init else 0.02
        layers.append(L.init_dense(gen, d_in, d_out, std=std))
    return {"layers": layers,
            # running feature statistics for standardization
            "feat_mean": torch.zeros(cfg.in_dim),
            "feat_std": torch.ones(cfg.in_dim)}


def apply(params, feats: torch.Tensor, cfg: BridgeConfig = BridgeConfig(),
          *, train: bool = False,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """[B, 128] features -> [B, 384] unit-norm bridge embeddings. Dropout
    is on only with ``train`` and a ``generator`` (on the features'
    device) to draw its masks from."""
    x = feats.float()
    if cfg.standardize:
        # the fitted scaler is fixed: no gradient reaches its statistics
        mean = params["feat_mean"].detach()
        std = params["feat_std"].detach()
        x = (x - mean) / torch.clamp(std, min=1e-6)
    n = len(params["layers"])
    for i, lyr in enumerate(params["layers"]):
        x = L.dense(lyr, x)
        if i < n - 1:
            x = torch.relu(x)
            if train and cfg.dropout > 0.0 and generator is not None:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) < 1.0 - cfg.dropout
                x = torch.where(keep, x / (1.0 - cfg.dropout),
                                torch.zeros_like(x))
        else:
            x = torch.tanh(x)
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
