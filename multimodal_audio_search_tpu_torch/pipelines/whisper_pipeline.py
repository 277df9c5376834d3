"""Audio -> text extraction pipeline (shared by ASR and captioning).

Counterpart of ``multimodal_audio_search_tpu/pipelines/whisper_pipeline.py``:
log-mel -> encoder -> KV-cached greedy generation for a whole segment
batch; the ASR and caption instances differ only in weights, decode
config and decoder prompt. Batches pad up to power-of-two buckets, as
the JAX package pads them for its compiled programs.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..config import DecodeConfig, MelConfig
from ..models import whisper as W
from ..models.generate import check_supported, generate
from ..models.tokenizer import load_tokenizer
from ..ops.mel import log_mel_spectrogram
from ..service.stats import PipelineStats
from ..utils.batching import bucket_pow2 as _bucket


class WhisperTextPipeline:
    """transcribe_batch(waves[B, n_samples]) -> list[str]."""

    def __init__(
        self,
        params=None,
        cfg: W.WhisperConfig | None = None,
        tokenizer=None,
        decode: DecodeConfig | None = None,
        mel_cfg: MelConfig | None = None,
        prefix_ids: Sequence[int] | None = None,
        dtype: torch.dtype | None = None,
        seed: int = 0,
        stats: PipelineStats | None = None,
        name: str = "whisper",
        device: torch.device | str = "cuda",
    ):
        """``params``: a float32 param tree of torch tensors (see
        weights.py to bring JAX params over); None = random init from
        ``torch.Generator().manual_seed(seed)``. ``dtype`` defaults to
        the device's policy (runtime.default_dtype)."""
        from .. import runtime
        self.device = runtime.select_device(device)
        self.dtype = dtype or runtime.default_dtype(self.device)
        self.cfg = cfg or W.PRESETS["base"]
        if params is None:
            params = W.init_params(torch.Generator().manual_seed(seed),
                                   self.cfg)
        self.params = W.prepare_params(params, self.dtype, self.device)
        self.decode = decode or DecodeConfig(max_new_tokens=64)
        check_supported(self.decode)
        self.mel_cfg = mel_cfg or MelConfig(n_mels=self.cfg.n_mels)
        self.tokenizer = tokenizer or load_tokenizer(
            vocab_size=self.cfg.vocab_size, add_cls_sep=False,
            pad_id=self.cfg.pad_token_id, eos_id=self.cfg.eos_token_id)
        self.prefix_ids = tuple(
            prefix_ids if prefix_ids is not None
            else W.forced_prefix(self.cfg))
        self.stats = stats if stats is not None else PipelineStats(
            f"{name} pipeline", name)
        self.name = name
        # None = auto: K1 (its plain twin on the CPU); False = plain mha
        fused = self.decode.fused_encoder
        self.fused_encoder_resolved = True if fused is None else bool(fused)
        # decode steps of the most recent dispatch (a step runs each
        # decoder layer's two attentions once), and running totals
        self.last_steps = 0
        self.total_steps = 0
        self.dispatches = 0

    def batch_floor(self) -> int:
        return 8

    @torch.inference_mode()
    def dispatch_mel(self, mel: torch.Tensor):
        """Encode + generate on device-resident mel [B, n_mels, frames]
        (float32). Returns (tokens, lengths) device tensors; kernels are
        queued on the current stream, the host syncs once per decode
        step for the early exit."""
        b = mel.shape[0]
        prefix = torch.tensor(self.prefix_ids, dtype=torch.long,
                              device=self.device).expand(b, -1)
        enc = W.encode(self.params, mel.to(self.dtype), self.cfg,
                       fused_blocks=self.fused_encoder_resolved)
        out = generate(self.params, enc, prefix, cfg=self.cfg,
                       decode=self.decode,
                       max_new_tokens=self.decode.max_new_tokens)
        self.last_steps = out.steps
        self.total_steps += out.steps
        self.dispatches += 1
        return out.tokens, out.lengths

    def transcribe_batch(self, waves: np.ndarray) -> list[str]:
        """waves: [B, mel_cfg.n_samples] float32 (already padded)."""
        t0 = time.perf_counter()
        n = len(waves)
        b = _bucket(n, self.batch_floor())
        if b > n:
            waves = np.pad(waves, ((0, b - n), (0, 0)))
        with torch.inference_mode():
            w = torch.as_tensor(np.asarray(waves, np.float32),
                                device=self.device)
            tokens, lengths = self.dispatch_mel(
                log_mel_spectrogram(w, self.mel_cfg))
        texts = self.texts_from_tokens(
            tokens.cpu().numpy(), lengths.cpu().numpy(), n)
        self.stats.update(time.perf_counter() - t0, success=True, n=n)
        return texts

    def texts_from_tokens(self, tokens: np.ndarray, lengths: np.ndarray,
                          n: int) -> list[str]:
        texts = []
        p = len(self.prefix_ids)
        for i in range(n):
            # lengths includes the EOS token when one was emitted; the
            # tokenizer's skip_special_tokens drops it
            gen = tokens[i, p: p + int(lengths[i])]
            texts.append(self.tokenizer.decode(
                gen, skip_special_tokens=True).strip())
        return texts
