"""Audio -> text extraction pipeline (shared by ASR and captioning).

Counterpart of ``multimodal_audio_search_tpu/pipelines/whisper_pipeline.py``:
log-mel -> encoder -> KV-cached generation for a whole segment batch;
the ASR and caption instances differ only in weights, decode config and
decoder prompt. Batches pad up to power-of-two buckets, as the JAX
package pads them for its compiled programs.

The decode follows ``decode.method``: greedy and "sample" through
``generate`` (a dispatch's sampling generator is seeded with the
dispatch's number, 1, 2, ..., as JAX keys it with ``PRNGKey(self._step)``),
"beam" through ``beam_generate`` with ``decode.num_beams``. The JAX
pipeline always calls ``generate``, whose argmax makes its "beam" greedy
(ROADMAP, known faults in the reference); the port does not copy that.

``use_mesh`` runs the pipeline over a mesh's data axis
(parallel/mesh.py): a replica of the parameters on each data device, the
batch bucket (at least max(8, dp) rows) cut into dp contiguous chunks,
each encoded and decoded on its own device. Every chunk's encoder is
queued before any decode starts; the decode loops then run one after
another, since each syncs the host once a step. Sampling draws each
chunk's Gumbel rows out of the whole batch's noise, so a chunk's rows
get the noise they get without a mesh.

With a model axis (``model_parallel > 1``) each data row's chunk runs
over that row's model devices: the parameters placed by the head-aligned
TP rule (parallel/mesh.py::shard_heads), the encoder by models/whisper.py
::encode_tp, and the decode by models/generate.py::generate_tp (greedy
and sampling, the noise drawn on the row's first model device as without
the axis) or models/beam.py::beam_generate_tp. Every decode option runs
there. A model whose head count (or MLP width) does not divide the axis
keeps a whole replica on each row's first model device, as without a
model axis.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..config import DecodeConfig, MelConfig
from ..models import whisper as W
from ..models.beam import beam_generate, beam_generate_tp
from ..models.generate import check_supported, generate, generate_tp
from ..models.tokenizer import load_tokenizer
from ..ops.mel import log_mel_spectrogram
from ..ops.quant import is_quantized
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
        weights.py to bring JAX params over), with the decoder int8 if it
        went through ops/quant.py::quantize_whisper_decoder; None =
        random init from ``torch.Generator().manual_seed(seed)``.
        ``dtype`` defaults to the device's policy
        (runtime.default_dtype)."""
        from .. import runtime
        self.device = runtime.select_device(device)
        self.dtype = dtype or runtime.default_dtype(self.device)
        self.cfg = cfg or W.PRESETS["base"]
        if params is None:
            params = W.init_params(torch.Generator().manual_seed(seed),
                                   self.cfg)
        self.params = W.prepare_params(params, self.dtype, self.device)
        self.decode = decode or DecodeConfig(max_new_tokens=64)
        self.quantized = is_quantized(params)
        check_supported(self.decode, quantized=self.quantized)
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
        # None = auto: K1 (its plain twin on the CPU), as the JAX package
        # resolves it on its accelerator; False, True, "int8" and "paired"
        # pass through to encode(fused_blocks=...), which dispatches on the
        # value (False: K8 on the card at T >= 512, plain mha elsewhere)
        fused = self.decode.fused_encoder
        self.fused_encoder_resolved = True if fused is None else fused
        # decode steps of the most recent dispatch_mel (a step runs each
        # decoder layer's two attentions once, over B * num_beams rows
        # under beam search; summed over a mesh's chunks), and running
        # totals; ``dispatches`` counts encoder runs (one per chunk under
        # a mesh), ``calls`` the dispatch_mel calls, which seed sampling
        self.last_steps = 0
        self.total_steps = 0
        self.dispatches = 0
        self.calls = 0
        self.mesh = None
        self._replicas = None
        self._shards = None

    def use_mesh(self, mesh) -> None:
        """Run this pipeline over ``mesh``: batches split over its data
        devices, the parameters replicated on each, or with a model axis
        sharded by heads over each data row's model devices (module
        docstring). A data axis that is not a power of two raises
        ValueError."""
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
    def model_parallel(self) -> int:
        """The ranks a data row's chunk runs over (1: a whole replica)."""
        return 1 if self._shards is None else self._shards.shape[1]

    def batch_floor(self) -> int:
        """The smallest batch bucket: the data chunks must divide it and,
        under ``decode.fused_layer``, each chunk keeps a multiple of 8
        rows, decode_step's gate for the fused sub-blocks (JAX gates on
        the whole batch), so a split batch takes K3/K4 as the whole one
        does. Under beam search a chunk decodes its rows x num_beams,
        a multiple of 8 whenever the chunk's rows are."""
        if self.mesh is None:
            return 8
        dp = len(self.mesh.data_devices())
        return 8 * dp if self.decode.fused_layer else max(8, dp)

    def _decode(self, params, enc, prefix, noise_rows):
        """Decode one batch (or chunk) of encoder output on its device
        (``params`` a row's list of rank trees and ``enc`` its list of
        per-rank outputs under a model axis)."""
        kw = dict(cfg=self.cfg, decode=self.decode,
                  max_new_tokens=self.decode.max_new_tokens)
        tp = self._shards is not None
        if self.decode.method == "beam":
            return (beam_generate_tp if tp else beam_generate)(
                params, enc, prefix, num_beams=self.decode.num_beams, **kw)
        dev = enc[0].device if tp else enc.device
        rng = torch.Generator(device=dev).manual_seed(self.calls) \
            if self.decode.method == "sample" else None
        return (generate_tp if tp else generate)(
            params, enc, prefix, rng=rng, noise_rows=noise_rows, **kw)

    @torch.inference_mode()
    def dispatch_mel(self, mel):
        """Encode + decode on device-resident mel [B, n_mels, frames]
        (float32) by ``decode.method`` (module docstring). Returns
        (tokens, lengths) device tensors; kernels are queued on the
        current stream, the host syncs once per decode step for the
        early exit. With a mesh, ``mel`` is a list of one chunk a data
        device (or one batch, which is split); every chunk's encoder is
        queued first, and the chunks' tokens and lengths are gathered in
        order to the first data device."""
        self.calls += 1
        replicas = self._replicas or [self.params]
        if self._shards is not None:   # one list of rank trees a data row
            replicas = [list(row) for row in self._shards]
        if isinstance(mel, (list, tuple)):
            chunks = list(mel)
        else:
            chunks = list(torch.chunk(mel, len(replicas)))
        if len(chunks) != len(replicas):
            raise ValueError(f"{len(chunks)} chunks of mel for "
                             f"{len(replicas)} data devices")
        b = sum(m.shape[0] for m in chunks)
        encs, lo = [], 0
        for params, m in zip(replicas, chunks):
            prefix = torch.tensor(self.prefix_ids, dtype=torch.long,
                                  device=m.device).expand(m.shape[0], -1)
            encode = W.encode_tp if self._shards is not None else W.encode
            enc = encode(params, m.to(self.dtype), self.cfg,
                         fused_blocks=self.fused_encoder_resolved)
            encs.append((params, enc, prefix, (lo, b)))
            lo += m.shape[0]
        outs = [self._decode(*e) for e in encs]
        self.last_steps = sum(o.steps for o in outs)
        self.total_steps += self.last_steps
        self.dispatches += len(outs)
        dev = outs[0].tokens.device
        return (torch.cat([o.tokens.to(dev) for o in outs]),
                torch.cat([o.lengths.to(dev) for o in outs]))

    def transcribe_batch(self, waves: np.ndarray) -> list[str]:
        """waves: [B, mel_cfg.n_samples] float32 (already padded)."""
        t0 = time.perf_counter()
        n = len(waves)
        b = _bucket(n, self.batch_floor())
        if b > n:
            waves = np.pad(waves, ((0, b - n), (0, 0)))
        devs = [self.device] if self.mesh is None \
            else self.mesh.data_devices()
        with torch.inference_mode():
            w = torch.from_numpy(np.asarray(waves, np.float32))
            tokens, lengths = self.dispatch_mel([
                log_mel_spectrogram(c.to(d), self.mel_cfg)
                for c, d in zip(torch.chunk(w, len(devs)), devs)])
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
