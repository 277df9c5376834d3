"""Text -> sentence embedding pipeline (384-D MiniLM by default).

Counterpart of ``multimodal_audio_search_tpu/pipelines/embed.py``: a
sentence encoder module (``models.minilm`` by default, ``models.mpnet``
for all-mpnet-base-v2) with tokenization and power-of-two batch buckets.
Runs in float32 on either device, as the JAX package's embedder does
(its default dtype). ``use_mesh`` replicates the parameters on a mesh's
data devices and splits each batch bucket (at least max(8, dp) rows)
over them, as the JAX package shards its embed batches; with a model
axis, each data row's chunk runs over that row's model devices, the
parameters sharded by heads (parallel/mesh.py::shard_heads, the
module's ``sentence_embed_tp``), or replicated where the heads or the
MLP width do not divide the axis.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..models import minilm
from ..models.layers import cast_floats
from ..models.tokenizer import load_tokenizer
from ..service.stats import PipelineStats
from ..utils.batching import bucket_pow2 as _bucket


class TextEmbedder:
    """embed(texts) -> [n, hidden] unit-norm float32 embeddings (numpy)."""

    def __init__(
        self,
        params=None,
        cfg: minilm.MiniLMConfig | None = None,
        tokenizer=None,
        max_tokens: int = 64,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        stats: PipelineStats | None = None,
        device: torch.device | str = "cuda",
        model=None,
    ):
        """``model`` is the encoder module (default models.minilm); any
        module exposing init_params(gen, cfg) and sentence_embed(params,
        ids, mask, cfg) works, e.g. models.mpnet. Its default ``cfg`` is
        MiniLMConfig() for minilm and the module's PRESETS["base"] else."""
        from .. import runtime
        self.device = runtime.select_device(device)
        model = model or minilm
        if cfg is None:
            cfg = minilm.MiniLMConfig() if model is minilm \
                else model.PRESETS["base"]
        self.cfg = cfg
        self.model = model
        if params is None:
            params = model.init_params(
                torch.Generator().manual_seed(seed), self.cfg)
        self.params = cast_floats(params, dtype, self.device)
        self.tokenizer = tokenizer or load_tokenizer(
            vocab_size=self.cfg.vocab_size)
        self.max_tokens = max_tokens
        self.stats = stats if stats is not None else PipelineStats(
            "Text Embedder", f"{model.__name__.rsplit('.', 1)[-1]}-torch")
        self.stats.embedding_dim = self.cfg.hidden
        self.mesh = None
        self._replicas = None
        self._shards = None

    def use_mesh(self, mesh) -> None:
        """Split embed batches over ``mesh``'s data devices, the
        parameters replicated on each or, with a model axis, sharded by
        heads over each data row's model devices (module docstring). A
        data axis that is not a power of two raises ValueError."""
        from ..parallel.mesh import (model_axis_fits, replicated,
                                     shard_heads, validate_data_axis)
        validate_data_axis(mesh)
        mp = mesh.shape.get("model", 1)
        self.mesh = mesh
        self._replicas = self._shards = None
        if mp > 1 and model_axis_fits(self.cfg, mp):
            self._shards = shard_heads(self.params, mesh, self.cfg.heads)
        else:
            self._replicas = replicated(mesh, self.params)

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    @torch.inference_mode()
    def embed_device(self, texts: Sequence[str]) -> torch.Tensor:
        """[n, hidden] float32 embeddings left on the device (with a mesh,
        gathered to its first data device)."""
        ids, mask = self.tokenizer.encode(list(texts), self.max_tokens)
        devs = [self.device] if self.mesh is None \
            else self.mesh.data_devices()
        b = _bucket(len(texts), max(8, len(devs)))
        if b > len(texts):  # pad rows (masked out; results sliced away)
            pad = b - len(texts)
            ids = np.pad(ids, ((0, pad), (0, 0)))
            mask = np.pad(mask, ((0, pad), (0, 0)))
            mask[len(texts):, 0] = 1  # avoid 0/0 in mean pooling
        # one contiguous block of rows a data device (or data row)
        embed = self.model.sentence_embed
        params = self._replicas or [self.params]
        if self._shards is not None:
            embed = self.model.sentence_embed_tp
            params = [list(row) for row in self._shards]
        outs = [embed(p, i.to(d, torch.long), m.to(d), self.cfg)
                for p, i, m, d in zip(
                    params,
                    torch.chunk(torch.as_tensor(ids), len(devs)),
                    torch.chunk(torch.as_tensor(mask), len(devs)), devs)]
        return torch.cat([o.to(devs[0]) for o in outs])[: len(texts)]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.cfg.hidden), np.float32)
        t0 = time.perf_counter()
        out = self.embed_device(texts).cpu().numpy()
        self.stats.update(time.perf_counter() - t0, success=True,
                          n=len(texts))
        return out
