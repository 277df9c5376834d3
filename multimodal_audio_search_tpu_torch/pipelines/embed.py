"""Text -> 384D embedding pipeline.

Counterpart of ``multimodal_audio_search_tpu/pipelines/embed.py``: MiniLM
with tokenization and power-of-two batch buckets. Runs in float32 on
either device, as the JAX package's embedder does (its default dtype).
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
    ):
        from .. import runtime
        self.device = runtime.select_device(device)
        self.cfg = cfg or minilm.MiniLMConfig()
        if params is None:
            params = minilm.init_params(
                torch.Generator().manual_seed(seed), self.cfg)
        self.params = cast_floats(params, dtype, self.device)
        self.tokenizer = tokenizer or load_tokenizer(
            vocab_size=self.cfg.vocab_size)
        self.max_tokens = max_tokens
        self.stats = stats if stats is not None else PipelineStats(
            "Text Embedder", "minilm-torch")
        self.stats.embedding_dim = self.cfg.hidden

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    @torch.inference_mode()
    def embed_device(self, texts: Sequence[str]) -> torch.Tensor:
        """[n, hidden] float32 embeddings left on the device."""
        ids, mask = self.tokenizer.encode(list(texts), self.max_tokens)
        b = _bucket(len(texts), 8)
        if b > len(texts):  # pad rows (masked out; results sliced away)
            pad = b - len(texts)
            ids = np.pad(ids, ((0, pad), (0, 0)))
            mask = np.pad(mask, ((0, pad), (0, 0)))
            mask[len(texts):, 0] = 1  # avoid 0/0 in mean pooling
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        return minilm.sentence_embed(self.params, ids, mask,
                                     self.cfg)[: len(texts)]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.cfg.hidden), np.float32)
        t0 = time.perf_counter()
        out = self.embed_device(texts).cpu().numpy()
        self.stats.update(time.perf_counter() - t0, success=True,
                          n=len(texts))
        return out
