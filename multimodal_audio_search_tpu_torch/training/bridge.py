"""Bridge-network training: align DSP features to the text-embedding space.

Counterpart of ``multimodal_audio_search_tpu/training/bridge.py``: MSE
between bridge(audio_features) and the text embedding of the segment's
transcript, Adam (optax's, training/finetune.py::Optimizer) at lr 1e-3,
50 epochs of batches of 64 drawn from ``np.random.default_rng(seed)``'s
permutations (the last batch of an epoch topped up from the epoch's
head, as in JAX), the feature standardisation fitted on the training set
and held fixed (models/bridge.py detaches it, so Adam leaves it as it
is). Dropout draws its masks from a ``torch.Generator`` seeded with
``seed`` on the device (JAX's come from its key chain: with dropout on,
the two packages' runs differ by their masks). The features and targets
go to the device once; each batch is gathered there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MelConfig
from ..models import bridge as B
from ..ops.audio_features import audio_feature_vector
from .finetune import Optimizer, grad_leaves, grads_of


def fit_feature_stats(params, feats: np.ndarray):
    """Set standardization statistics from training features [N, 128]."""
    params = dict(params)
    params["feat_mean"] = torch.as_tensor(
        np.asarray(feats.mean(axis=0), np.float32))
    std = feats.std(axis=0)
    params["feat_std"] = torch.as_tensor(
        np.asarray(np.where(std > 1e-6, std, 1.0), np.float32))
    return params


def train_bridge(
    feats: np.ndarray,            # [N, 128] audio features
    targets: np.ndarray,          # [N, 384] unit-norm text embeddings
    cfg: B.BridgeConfig = B.BridgeConfig(),
    epochs: int = 50,             # lightweight_audio_search.py:183
    lr: float = 1e-3,             # lightweight_audio_search.py:181
    batch_size: int = 64,
    seed: int = 0,
    *,
    init_params=None,
    device: str | torch.device = "cuda",
):
    """Returns (params, per-epoch losses). ``init_params`` None:
    B.init_params from ``seed``."""
    from .. import runtime
    dev = runtime.select_device(device)
    params = init_params if init_params is not None \
        else B.init_params(torch.Generator().manual_seed(seed), cfg)
    if cfg.standardize:
        params = fit_feature_stats(params, feats)
    params = {"layers": [{k: v.to(dev) for k, v in lyr.items()}
                         for lyr in params["layers"]],
              "feat_mean": params["feat_mean"].to(dev),
              "feat_std": params["feat_std"].to(dev)}
    opt = Optimizer(lr)
    opt_state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x_all = torch.as_tensor(np.asarray(feats, np.float32)).to(dev)
    y_all = torch.as_tensor(np.asarray(targets, np.float32)).to(dev)

    n = len(feats)
    rng_np = np.random.default_rng(seed)
    losses = []
    for _ in range(epochs):
        order = rng_np.permutation(n)
        ep = torch.zeros((), dtype=torch.float64, device=dev)
        steps = 0
        for lo in range(0, n, batch_size):
            idx = order[lo: lo + batch_size]
            if len(idx) < batch_size:      # keep shapes static: reuse head
                idx = np.concatenate([idx, order[: batch_size - len(idx)]])
            sel = torch.as_tensor(idx).to(dev)
            xb, yb = x_all[sel], y_all[sel]
            with torch.enable_grad():
                tree, leaves = grad_leaves(params)
                pred = B.apply(tree, xb, cfg, train=True, generator=gen)
                loss = ((pred - yb) ** 2).sum(dim=-1).mean()
                grads = grads_of(loss, leaves)
            params, opt_state = opt.update(grads, opt_state, params)
            ep = ep + loss.detach().double()
            steps += 1
        losses.append(float(ep) / max(steps, 1))
    return params, losses


def features_for_waves(
    waves: np.ndarray, mel_cfg: MelConfig = MelConfig(),
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """[B, n_samples] padded waves -> [B, 128] features (host numpy),
    computed on ``device``."""
    from .. import runtime
    dev = runtime.select_device(device)
    with torch.inference_mode():
        f = audio_feature_vector(torch.as_tensor(
            np.asarray(waves, np.float32)).to(dev), mel_cfg)
    return f.cpu().numpy()
