"""Assembled CLAP search path (the historical v1 architecture).

Counterpart of ``multimodal_audio_search_tpu/pipelines/clap_ingest.py``:
audio is embedded directly, with no transcription. A waveform is cut into
``chunk_seconds`` chunks (a tail shorter than ``min_seconds`` is
dropped), resampled to ``sample_rate`` where it differs, and embedded
in batches of 32 (padded to a power-of-two bucket) by the log-mel
frontend (``ops/mel.py``) and the v1 audio tower (``models/clap.py``) on
the device; each 512-D row lands in the store's AUDIO slot (ASR slot
empty). A text query goes through the MiniLM text tower and its
projection, and is ranked by a masked dot over the AUDIO slot and a
stable descending sort (``lax.top_k``'s tie rule: equal scores keep
index order).

The index is a ``SegmentStore``, so persistence, deletion and the device
view come with it; a store saved by either package loads in the other.
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..config import MelConfig
from ..index.store import AUDIO, SegmentStore
from ..models import clap as C
from ..models.layers import cast_floats
from ..models.minilm import MiniLMConfig
from ..models.minilm import init_params as init_minilm
from ..models.tokenizer import load_tokenizer
from ..ops.mel import log_mel_spectrogram
from ..utils.batching import bucket_pow2 as _bucket

BATCH = 32


class ClapSearch:
    """ingest(wave) -> 512D audio-embedding index; search(text) -> hits."""

    def __init__(
        self,
        audio_params=None,
        text_params=None,
        proj_params=None,
        acfg: C.ClapConfig | None = None,
        tcfg: MiniLMConfig | None = None,
        tokenizer=None,
        store: SegmentStore | None = None,
        chunk_seconds: float = 10.0,
        min_seconds: float = 1.0,
        sample_rate: int = 16_000,
        max_tokens: int = 64,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device: torch.device | str = "cuda",
    ):
        """Random init from ``seed`` for any params not given (float32,
        CPU trees as ``weights.py`` makes them otherwise); the params are
        placed on ``device`` in ``dtype``."""
        from .. import runtime
        self.device = runtime.select_device(device)
        self.acfg = acfg or C.ClapConfig()
        self.tcfg = tcfg or MiniLMConfig()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        if audio_params is None:
            audio_params = C.init_audio_tower(gen, self.acfg)
        if text_params is None:
            text_params = init_minilm(gen, self.tcfg)
        if proj_params is None:
            proj_params = C.init_text_projection(gen, self.tcfg, self.acfg)
        self.audio_params = cast_floats(audio_params, dtype, self.device)
        self.text_params = cast_floats(text_params, dtype, self.device)
        self.proj_params = cast_floats(proj_params, dtype, self.device)
        self.tokenizer = tokenizer or load_tokenizer(
            vocab_size=self.tcfg.vocab_size)
        self.store = store if store is not None else SegmentStore(
            embed_dim=self.acfg.embed_dim, keep_audio=False)
        self.chunk_seconds = chunk_seconds
        self.min_seconds = min_seconds
        self.sample_rate = sample_rate
        self.max_tokens = max_tokens
        self.mel_cfg = MelConfig(n_mels=self.acfg.n_mels,
                                 padded_seconds=chunk_seconds,
                                 sample_rate=sample_rate)
        self._last_search_s = 0.0

    @torch.inference_mode()
    def embed_batch(self, waves: np.ndarray) -> torch.Tensor:
        """[B, n_samples] float32 waveforms -> [B, embed_dim] unit-norm
        float32 embeddings on the device."""
        x = torch.as_tensor(waves, dtype=torch.float32, device=self.device)
        mel = log_mel_spectrogram(x, self.mel_cfg).to(self.dtype)
        return C.audio_embed(self.audio_params, mel, self.acfg)

    @torch.inference_mode()
    def embed_query(self, query: str) -> torch.Tensor:
        """[embed_dim] unit-norm float32 text embedding on the device."""
        ids, mask = self.tokenizer.encode([query], self.max_tokens)
        return C.text_embed(
            self.text_params, self.proj_params,
            torch.as_tensor(ids, dtype=torch.long, device=self.device),
            torch.as_tensor(mask, device=self.device), self.tcfg,
            self.acfg)[0]

    # --------------------------------------------------------------- ingest
    def ingest_waveform(self, wave: np.ndarray, sr: int,
                        source_name: str = "clap") -> list[int]:
        """Chunk + batch-embed; returns store row indices."""
        if sr != self.sample_rate:
            from ..audio.resample import resample_best
            wave = resample_best(wave, sr, self.sample_rate)
            sr = self.sample_rate
        n = int(self.chunk_seconds * sr)
        keep = int(self.min_seconds * sr)
        pieces, times = [], []
        for lo in range(0, len(wave), n):
            piece = wave[lo: lo + n]
            if len(piece) < keep:      # >=1 s keep rule
                continue
            pieces.append(piece)
            times.append((lo / sr, (lo + len(piece)) / sr))
        if not pieces:
            return []
        rows: list[int] = []
        n_samples = self.mel_cfg.n_samples
        for lo in range(0, len(pieces), BATCH):
            chunk = pieces[lo: lo + BATCH]
            batch = np.zeros((_bucket(len(chunk)), n_samples), np.float32)
            for i, p in enumerate(chunk):
                batch[i, : min(len(p), n_samples)] = p[:n_samples]
            emb = self.embed_batch(batch)[: len(chunk)].cpu().numpy()
            for i, e in enumerate(emb):
                t0, t1 = times[lo + i]
                rows.append(self.store.add(
                    {"source": source_name, "start_time": t0,
                     "end_time": t1, "duration": t1 - t0,
                     "asr_text": "", "audio_description": ""},
                    None, e))
        return rows

    # --------------------------------------------------------------- search
    @torch.inference_mode()
    def search(self, query: str, k: int = 10) -> list[dict[str, Any]]:
        """Text -> CLAP text tower -> cosine ranking over the audio index
        (the historical Audio Only strategy)."""
        if len(self.store) == 0:
            return []
        t0 = time.perf_counter()
        q = self.embed_query(query)
        emb, ok = self.store.device_index(self.device)
        scores = emb[:, AUDIO].float() @ q
        scores = torch.where(ok[:, AUDIO], scores,
                             torch.full_like(scores, -torch.inf))
        k_eff = min(k, len(self.store))
        vals, idx = torch.sort(scores, descending=True, stable=True)
        vals, idx = vals[:k_eff].cpu().numpy(), idx[:k_eff].cpu().numpy()
        hits = []
        for score, i in zip(vals, idx):
            if not np.isfinite(score) or i >= len(self.store):
                continue
            row = dict(self.store.meta[int(i)])
            row["similarity"] = float(score)
            row["index"] = int(i)
            hits.append(row)
        self._last_search_s = time.perf_counter() - t0
        return hits
