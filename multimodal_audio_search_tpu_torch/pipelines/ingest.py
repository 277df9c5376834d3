"""Dual-pipeline ingest assembly (the reference's hot path, batched).

Counterpart of ``multimodal_audio_search_tpu/pipelines/ingest.py``.
Behavioral contract (audio_search.py:223-307): decode/resample -> peak-
conditional normalization -> 10 s windows (drop < 3 s) -> per segment run
ASR and captioning -> validate texts -> embed valid texts -> keep the
segment iff at least one pipeline produced text.

Per batch of segments the waveform crosses to the device ONCE, as int16
at the true segment length (``transfer_dtype="int16"``, the default) or
float32, from a pinned host buffer with a non-blocking copy. The device
dequantizes, zero-pads to the mel context and computes the log-mel that
both Whisper models share, then runs ASR and captioning. Every
surviving text of the waveform embeds in one MiniLM batch.

Differences from the JAX package:
  * only the int16 and float32 transfer codecs are ported (ROADMAP A10);
  * the two Whisper pipelines must share one mel config (the JAX
    package's separate-mel branch has no caller in the port);
  * a failing batch raises instead of being retried and then degraded to
    "no text": a kernel build or launch error must not be swallowed;
  * ``last_trace["dispatch"]`` holds encode + decode (PyTorch runs them
    eagerly, with one host sync per decode step), ``"wait"`` only the
    copy of the tokens back to the host.
"""
from __future__ import annotations

import itertools
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.decode import load_audio
from ..config import EngineConfig
from ..service.stats import StatsRegistry
from .embed import TextEmbedder
from .validators import validate_asr_text, validate_audio_description
from .whisper_pipeline import WhisperTextPipeline

TRANSFER_DTYPES = ("int16", "float32")


class DualPipelineIngest:
    def __init__(
        self,
        asr: WhisperTextPipeline,
        caption: WhisperTextPipeline,
        embedder: TextEmbedder,
        cfg: EngineConfig | None = None,
        stats: StatsRegistry | None = None,
    ):
        self.asr = asr
        self.caption = caption
        self.embedder = embedder
        self.cfg = cfg or EngineConfig()
        if self.cfg.transfer_dtype not in TRANSFER_DTYPES:
            raise NotImplementedError(
                f"transfer_dtype={self.cfg.transfer_dtype!r} is not ported; "
                f"options {TRANSFER_DTYPES} (ROADMAP A10)")
        if asr.mel_cfg != caption.mel_cfg or asr.device != caption.device:
            raise ValueError(
                "the ASR and caption pipelines must share one mel config "
                "and one device (both consume the same device log-mel)")
        self.stats = stats
        self.device = asr.device
        # monotonic across every file this pipeline ingests, so segment ids
        # never collide within one store
        self._seg_counter = itertools.count()
        self.last_trace: dict[str, float] = {}

    def process_file(
        self, src, source_name: str = "upload"
    ) -> list[dict[str, Any]]:
        wave, sr = load_audio(src, self.cfg.audio.sample_rate)
        return self.process_waveform(wave, sr, source_name)

    def _encode_transfer(self, chunk, b: int, seg_len: int,
                         scale: np.float32) -> torch.Tensor:
        """Host side: [b, seg_len] int16 (or float32) batch, the deferred
        normalization scale applied, in a pinned buffer on CUDA."""
        int16 = self.cfg.transfer_dtype == "int16"
        pin = self.device.type == "cuda"
        buf = torch.zeros((b, seg_len),
                          dtype=torch.int16 if int16 else torch.float32,
                          pin_memory=pin)
        q = buf.numpy()
        for i, w in enumerate(chunk):
            m = min(len(w), seg_len)
            wn = w[:m] * scale if scale != 1.0 else w[:m]
            if int16:
                # nan_to_num: NaN -> 0 (clip(NaN) would cast an undefined
                # int16 code); the assignment truncates toward zero
                q[i, :m] = np.clip(np.nan_to_num(wn), -1.0, 1.0) * 32767.0
            else:
                q[i, :m] = np.nan_to_num(wn)
        return buf

    def _device_mel(self, qd: torch.Tensor) -> torch.Tensor:
        """Device side: dequantize, zero-pad to the mel context, log-mel
        (float32 [B, n_mels, frames])."""
        from ..ops.mel import log_mel_spectrogram
        mel_cfg = self.asr.mel_cfg
        w = qd.float() / 32767.0 if qd.dtype == torch.int16 else qd.float()
        w = F.pad(w, (0, mel_cfg.n_samples - w.shape[1]))
        return log_mel_spectrogram(w, mel_cfg)

    @torch.inference_mode()
    def process_waveform(
        self, wave: np.ndarray, sr: int, source_name: str = "waveform"
    ) -> list[dict[str, Any]]:
        """Returns reference-shaped segment records (audio_search.py:275-294).

        Records carry raw segment audio for playback parity; drop them via
        SegmentStore(keep_audio=False) if undesired."""
        cfg = self.cfg
        t_wall0 = time.perf_counter()
        tr = {k: 0.0 for k in (
            "resample", "segment", "quantize", "put", "dispatch",
            "wait", "detok", "validate", "embed", "build")}
        self.last_trace = tr
        target_sr = self.asr.mel_cfg.sample_rate
        if sr != target_sr:
            from ..audio.resample import resample_best
            t0 = time.perf_counter()
            wave = resample_best(wave, sr, target_sr)
            sr = target_sr
            tr["resample"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # normalization is a factor folded into the transfer quantize and
        # the stored segment copies, not a pass over the waveform
        from ..audio.segment import peak_scale, segment_windows
        wave = np.ascontiguousarray(wave, np.float32)
        scale = np.float32(peak_scale(wave, cfg.audio))
        wins = segment_windows(len(wave), sr, cfg.segment)
        waves = [wave[w.start_sample: w.start_sample + w.length]
                 for w in wins]
        tr["segment"] = time.perf_counter() - t0
        if not wins:
            return []
        from ..utils.batching import bucket_pow2 as _bucket
        seg_len = min(int(cfg.segment.segment_seconds * sr),
                      self.asr.mel_cfg.n_samples)

        batch_texts: list[tuple[int, int, list, list, list, list]] = []
        for lo in range(0, len(wins), cfg.ingest_batch):
            hi = min(lo + cfg.ingest_batch, len(wins))
            n = hi - lo
            t0 = time.perf_counter()
            b = _bucket(n, self.asr.batch_floor())
            q = self._encode_transfer(waves[lo:hi], b, seg_len, scale)
            tp = time.perf_counter()
            tr["quantize"] += tp - t0
            qd = q.to(self.device, non_blocking=True)
            td = time.perf_counter()
            tr["put"] += td - tp
            mel = self._device_mel(qd)
            a_tok, a_len = self.asr.dispatch_mel(mel)
            c_tok, c_len = self.caption.dispatch_mel(mel)
            tw = time.perf_counter()
            tr["dispatch"] += tw - td
            a_tok, a_len = a_tok.cpu().numpy(), a_len.cpu().numpy()
            c_tok, c_len = c_tok.cpu().numpy(), c_len.cpu().numpy()
            tk = time.perf_counter()
            tr["wait"] += tk - tw
            asr_texts = self.asr.texts_from_tokens(a_tok, a_len, n)
            t1 = time.perf_counter()
            cap_texts = self.caption.texts_from_tokens(c_tok, c_len, n)
            tr["detok"] += time.perf_counter() - tk
            t2 = time.perf_counter()
            asr_ok = [bool(validate_asr_text(t, cfg.validator))
                      for t in asr_texts]
            cap_ok = [bool(validate_audio_description(t, cfg.validator))
                      for t in cap_texts]
            tr["validate"] += time.perf_counter() - t2
            if self.stats is not None:
                self.stats.pipelines["asr_pipeline"].update_batch(
                    t1 - t0, asr_ok.count(True), asr_ok.count(False))
                self.stats.pipelines["audio_pipeline"].update_batch(
                    t2 - t1, cap_ok.count(True), cap_ok.count(False))
            batch_texts.append((lo, hi, asr_texts, cap_texts, asr_ok, cap_ok))

        # one embed batch for every surviving text in the whole file
        te = time.perf_counter()
        to_embed: list[str] = []
        slots: list[tuple[int, int]] = []  # (waveform segment idx, slot)
        for lo, hi, asr_texts, cap_texts, asr_ok, cap_ok in batch_texts:
            for i in range(hi - lo):
                if asr_ok[i]:
                    slots.append((lo + i, 0))
                    to_embed.append(asr_texts[i])
                if cap_ok[i]:
                    slots.append((lo + i, 1))
                    to_embed.append(cap_texts[i])
        embs = self.embedder(to_embed) if to_embed else \
            np.zeros((0, self.embedder.dim), np.float32)
        emb_map = {s: embs[j] for j, s in enumerate(slots)}
        tb = time.perf_counter()
        tr["embed"] += tb - te

        records: list[dict[str, Any]] = []
        for lo, hi, asr_texts, cap_texts, asr_ok, cap_ok in batch_texts:
            for i in range(hi - lo):
                w = wins[lo + i]
                a_text = asr_texts[i] if asr_ok[i] else ""
                c_text = cap_texts[i] if cap_ok[i] else ""
                if not (a_text.strip() or c_text.strip()):
                    continue  # audio_search.py:274
                records.append({
                    "segment_id": f"seg_{next(self._seg_counter)}",
                    "source": source_name,
                    "start_time": w.start_time,
                    "end_time": w.end_time,
                    "duration": w.duration,
                    "asr_text": a_text,
                    "asr_embedding": emb_map.get((lo + i, 0)),
                    "asr_success": asr_ok[i],
                    "audio_description": c_text,
                    "audio_embedding": emb_map.get((lo + i, 1)),
                    "audio_success": cap_ok[i],
                    # stored playback audio is the NORMALIZED segment
                    "audio_data": waves[lo + i] * scale
                    if scale != 1.0 else waves[lo + i],
                    "sample_rate": sr,
                })
        tr["build"] += time.perf_counter() - tb
        tr["wall"] = time.perf_counter() - t_wall0
        return records


def make_default_ingest(
    cfg: EngineConfig | None = None,
    stats: StatsRegistry | None = None,
    seed: int = 0,
    dtype: torch.dtype | None = None,
    device: torch.device | str = "cuda",
) -> DualPipelineIngest:
    """Build the reference-configured dual pipeline with random-init
    weights from ``seed`` (whisper-base ASR with the en/transcribe prompt,
    whisper-tiny captioner with a bare <sot> prompt, MiniLM-L6)."""
    from ..config import MelConfig
    from ..models import whisper as W
    from ..models.minilm import PRESETS as MLM_PRESETS
    cfg = cfg or EngineConfig()
    for spec in (cfg.asr_model, cfg.caption_model, cfg.text_embedder):
        if spec.weights_path:
            raise NotImplementedError(
                "loading converted checkpoints is not ported yet "
                "(ROADMAP A17); weights come from the seed")
        if spec.quantize_decoder:
            raise NotImplementedError(
                "quantize_decoder is not ported (ROADMAP A9, kernel B8)")
    if cfg.text_embedder.family != "minilm":
        raise NotImplementedError(
            f"embedder family {cfg.text_embedder.family!r} is not ported "
            f"(ROADMAP A11)")
    if cfg.data_parallel * cfg.model_parallel != 1:
        raise NotImplementedError(
            "meshes (data_parallel/model_parallel) are not ported "
            "(ROADMAP A13)")
    stats_reg = stats or StatsRegistry()
    mel_cfg = MelConfig(
        padded_seconds=cfg.segment.segment_seconds,
        sample_rate=cfg.audio.sample_rate,
    ) if cfg.short_context else MelConfig(sample_rate=cfg.audio.sample_rate)

    def load_whisper(spec, decode, name, prefix):
        return WhisperTextPipeline(
            cfg=W.PRESETS[spec.preset], decode=decode, dtype=dtype,
            seed=seed, name=name, prefix_ids=prefix, mel_cfg=mel_cfg,
            device=device)

    asr_prefix = W.forced_prefix(
        W.PRESETS[cfg.asr_model.preset], task=cfg.asr_task,
        language=cfg.asr_language)
    asr = load_whisper(cfg.asr_model, cfg.asr_decode, "asr", asr_prefix)
    cap_cfg = W.PRESETS[cfg.caption_model.preset]
    caption = load_whisper(cfg.caption_model, cfg.caption_decode,
                           "caption", [cap_cfg.bos_token_id])
    embedder = TextEmbedder(
        cfg=MLM_PRESETS[cfg.text_embedder.preset], seed=seed,
        stats=stats_reg.pipelines["text_embedder"], device=device)
    return DualPipelineIngest(asr, caption, embedder, cfg, stats_reg)
