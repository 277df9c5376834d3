"""Procedural audio/caption pairs + self-trained captioner weights.

Counterpart of ``multimodal_audio_search_tpu/training/synth.py``: the
framework as its own weights supplier. Random-init weights give
degenerate transcripts; a captioner trained here on procedural clips
(tones, sweeps, noise bursts, with deterministic captions over an exact
word vocabulary) transcribes the grammar, the oracle a change of the
numerics is judged by.

The clip generator and the vocabulary (``_tone`` ... ``make_clip``,
``SynthVocab``) are copies of the JAX module's numpy code, held
identical by tests/test_torch_copies.py, so one seed gives both packages
the same clips. ``train_synth_captioner`` runs training/finetune.py's
step (over a mesh with ``mesh``: its data axis, and its model axis with
the state in rank trees, where JAX replicates over that axis; both
compute the same function) on the card unless the caller asks for the
CPU, and hands back the whole tree; ``transcribe`` decodes through the
serving pipeline (``synth_pipeline``: pipelines/whisper_pipeline.py),
whose kernels it therefore runs on the card: K1 with
``fused_encoder=None`` (or True), K2 in every decode step;
``synth_pipeline`` over a mesh with a model axis, K1p and K2 on head
shards. It decodes in the device's dtype (bf16 on the card, where K1 and
K2 take bf16; float32 on the CPU) unless ``dtype`` says otherwise; JAX's
decodes in float32. A float32 decode on the card runs K2's float32 form
and, with ``fused_encoder=False`` at T >= 512, K8's: the float32 rows of
tools/torch_synth_drift.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..models import whisper as W

SAMPLE_RATE = 16_000

# event name -> synthesis function(dur_samples, rng) -> waveform
_TONES = {"low": 220.0, "mid": 880.0, "high": 3520.0}


def _tone(freq: float, n: int) -> np.ndarray:
    t = np.arange(n) / SAMPLE_RATE
    env = np.minimum(1.0, np.minimum(t, t[::-1]) * 40.0)   # 25 ms ramps
    return (0.4 * np.sin(2 * np.pi * freq * t) * env).astype(np.float32)


def _noise(n: int, rng: np.random.Generator) -> np.ndarray:
    return (0.25 * rng.normal(size=n)).astype(np.float32)


def _sweep(n: int) -> np.ndarray:
    t = np.arange(n) / SAMPLE_RATE
    f0, f1 = 300.0, 3000.0
    phase = 2 * np.pi * (f0 * t + (f1 - f0) * t * t
                         / (2 * t[-1] if n > 1 else 1.0))
    env = np.minimum(1.0, np.minimum(t, t[::-1]) * 40.0)
    return (0.4 * np.sin(phase) * env).astype(np.float32)


EVENTS = ("low tone", "mid tone", "high tone", "noise", "sweep")


def render_event(name: str, n: int, rng: np.random.Generator) -> np.ndarray:
    if name.endswith("tone"):
        return _tone(_TONES[name.split()[0]], n)
    if name == "noise":
        return _noise(n, rng)
    if name == "sweep":
        return _sweep(n)
    raise ValueError(name)


def make_clip(
    rng: np.random.Generator,
    clip_seconds: float = 1.0,
    n_events: tuple[int, int] = (1, 3),
) -> tuple[np.ndarray, str]:
    """One clip: 1-3 sequential events filling clip_seconds, caption =
    event names joined by 'then' ("low tone then noise")."""
    k = int(rng.integers(n_events[0], n_events[1] + 1))
    names = [EVENTS[int(rng.integers(len(EVENTS)))] for _ in range(k)]
    n = int(clip_seconds * SAMPLE_RATE)
    per = n // k
    wave = np.concatenate(
        [render_event(nm, per, rng) for nm in names])
    wave = np.pad(wave, (0, n - len(wave)))
    return wave, " then ".join(names)


class SynthVocab:
    """Exact word<->id vocabulary for the synth grammar, shaped like the
    pipeline tokenizer protocol (encode / decode / specials)."""

    WORDS = ("low", "mid", "high", "tone", "noise", "sweep", "then")

    def __init__(self, cfg: W.WhisperConfig):
        self.vocab_size = cfg.vocab_size
        self.pad_id = cfg.pad_token_id
        self.eos_id = cfg.eos_token_id
        self.bos_id = cfg.bos_token_id
        self._w2i = {w: 10 + i for i, w in enumerate(self.WORDS)}
        self._i2w = {i: w for w, i in self._w2i.items()}
        self._special = {cfg.pad_token_id, cfg.eos_token_id,
                         cfg.bos_token_id, cfg.no_timestamps_id,
                         cfg.transcribe_id, cfg.lang_en_id}

    def words_to_ids(self, text: str) -> list[int]:
        return [self._w2i[w] for w in text.split()]

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self._special:
                continue
            out.append(self._i2w.get(i, f"<{i}>"))
        return " ".join(out)


@dataclass
class SynthModel:
    params: dict
    cfg: W.WhisperConfig
    vocab: SynthVocab
    mel_seconds: float
    losses: list
    n_events: tuple[int, int] = (1, 3)

    @property
    def max_new(self) -> int:
        """Decode budget covering the grammar: k two-word events +
        (k-1) 'then's + <eot>."""
        k = self.n_events[1]
        return 2 * k + (k - 1) + 1


def synth_batch(rng: np.random.Generator, batch: int, cfg: W.WhisperConfig,
                vocab: SynthVocab, clip_seconds: float, n_samples: int,
                n_events: tuple[int, int]):
    """One training batch of procedural clips, as the JAX loop draws it:
    (waves [B, n_samples] float32, padded to the mel context; tokens
    [B, L] int32, <sot> words <eot> then pad; loss_mask [B, L-1])."""
    waves, texts = zip(*(make_clip(rng, clip_seconds, n_events)
                         for _ in range(batch)))
    waves = np.stack(waves)
    # log_mel expects waves at the full mel context length
    waves = np.pad(waves, ((0, 0), (0, n_samples - waves.shape[1])))
    kmax = n_events[1]
    max_words = kmax * 2 + (kmax - 1)    # k two-word events + k-1 'then's
    tok_len = 1 + max_words + 1          # <sot> words <eot>
    tokens = np.full((batch, tok_len), cfg.pad_token_id, np.int32)
    mask = np.zeros((batch, tok_len - 1), np.float32)
    for i, t in enumerate(texts):
        ids = [cfg.bos_token_id] + vocab.words_to_ids(t) \
            + [cfg.eos_token_id]
        tokens[i, : len(ids)] = ids
        mask[i, : len(ids) - 1] = 1.0
    return waves, tokens, mask


def train_synth_captioner(
    steps: int = 400,
    batch: int = 16,
    clip_seconds: float = 1.0,
    mel_seconds: float = 2.0,
    preset: str = "test",
    seed: int = 0,
    lr: float = 3e-4,
    mesh=None,
    n_events: tuple[int, int] = (1, 3),
    dtype=None,
    params_init=None,
    save_cb=None,
    save_every: int = 0,
    transfer_int16: bool = False,
    device: str | torch.device = "cuda",
) -> SynthModel:
    """Train the preset captioner on procedural clips until transcripts
    are non-degenerate. Prompt = <sot>; tokens = <sot> words <eot>; the
    clips drawn from ``np.random.default_rng(seed)`` exactly as the JAX
    function draws them, AdamW under warmup_cosine (warmup min(20,
    max(1, steps // 4)), no decay), as JAX's.

    ``mesh``: a parallel/mesh.py mesh the step runs over (the batch
    split over its data rows; the parameters replicated, or, over a model
    axis the preset splits into, rank trees on the first row's model
    devices, training/loop.py::place_params; in place of ``device``).
    ``dtype`` casts the parameters for training (e.g. torch.bfloat16;
    layer-norm scales stay float32); the mel is cast to it.
    ``params_init`` resumes from trained parameters (optimizer and
    schedule restart). ``save_cb(step, params, losses)`` fires every
    ``save_every`` steps with the whole parameters. ``transfer_int16`` ships
    each step's waveforms as int16 and dequantizes on the device (the
    ingest default's round trip). Production geometry: ``preset="tiny",
    clip_seconds=10, mel_seconds=30, n_events=(2, 6)``."""
    from .. import runtime
    from ..config import MelConfig
    from ..models import layers as L
    from ..ops.mel import log_mel_spectrogram
    from ..parallel.mesh import gather_heads
    from .finetune import TrainConfig, make_train_step
    from .loop import place_params

    cfg = W.PRESETS[preset]
    if mel_seconds * 50 > cfg.enc_positions:
        raise ValueError(
            f"mel_seconds={mel_seconds} exceeds preset '{preset}' context "
            f"({cfg.enc_positions / 50:.0f} s)")
    dev = mesh.data_devices()[0] if mesh is not None \
        else runtime.select_device(device)
    if dev.type == "cuda":
        runtime.select_device(dev)
    vocab = SynthVocab(cfg)
    mel_cfg = MelConfig(padded_seconds=mel_seconds)
    params = (params_init if params_init is not None
              else W.init_params(torch.Generator().manual_seed(seed), cfg))
    params = place_params(L.cast_floats(params, dtype or torch.float32, dev),
                          mesh, (cfg,), print, "train_synth_captioner")
    tcfg = TrainConfig(learning_rate=lr, schedule="warmup_cosine",
                       warmup_steps=min(20, max(1, steps // 4)),
                       total_steps=steps, weight_decay=0.0)
    train_step, opt = make_train_step(cfg, tcfg, mesh=mesh)
    opt_state = opt.init_ranks(params)

    rng = np.random.default_rng(seed)
    losses = []
    for step in range(steps):
        waves, tokens, mask = synth_batch(rng, batch, cfg, vocab,
                                          clip_seconds, mel_cfg.n_samples,
                                          n_events)
        if transfer_int16:
            q = torch.as_tensor(
                (np.clip(waves, -1.0, 1.0) * 32767.0).astype(np.int16))
            w = q.to(dev).float() / 32767.0
        else:
            w = torch.as_tensor(waves).to(dev)
        b = {"mel": log_mel_spectrogram(w, mel_cfg),
             "tokens": tokens, "loss_mask": mask}
        params, opt_state, metrics = train_step(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        if save_cb is not None and save_every and (step + 1) % save_every == 0:
            save_cb(step + 1, gather_heads(params), losses)
    return SynthModel(params=gather_heads(params), cfg=cfg, vocab=vocab,
                      mel_seconds=mel_seconds, losses=losses,
                      n_events=n_events)


def synth_pipeline(
    model: SynthModel,
    mel_seconds: float | None = None,
    max_new: int | None = None,
    dtype=None,
    fused_encoder: bool | str | None = False,
    device: str | torch.device | None = None,
    mesh=None,
    *,
    fused_layer: bool | str = False,
    cross_attn: str = "auto",
    int8_cross_kv: bool = False,
):
    """The serving pipeline ``transcribe`` decodes through: the PRODUCTION
    WhisperTextPipeline (the engine's), greedy, prompted by <sot>, at an
    optionally overridden mel context (the short_context lever), compute
    dtype (default: the device's, runtime.default_dtype), or encoder path
    (``fused_encoder`` None or True: K1; "int8": K9; "paired": K10;
    False: the plain encoder, or K8 on the card at T >= 512).
    ``fused_layer``, ``cross_attn`` and ``int8_cross_kv`` go to the
    DecodeConfig (True: K3 + K4; "v2": K3-q + K4-o; "int8_fused": K6;
    "int8": K7; the last two over a decoder from ops/quant.py::
    quantize_whisper_decoder, whose dense layers take K5). ``device``:
    where to decode (default: where the model's parameters lie);
    ``mesh``: decode over it (WhisperTextPipeline.use_mesh: over a model
    axis each rank's heads, K1p and K2 on head shards)."""
    from ..config import DecodeConfig, MelConfig
    from ..pipelines.whisper_pipeline import WhisperTextPipeline

    if device is None:
        device = model.params["decoder"]["embed_tokens"].device
    pipe = WhisperTextPipeline(
        params=model.params, cfg=model.cfg, tokenizer=model.vocab,
        decode=DecodeConfig(max_new_tokens=model.max_new if max_new is None
                            else max_new,
                            fused_encoder=fused_encoder,
                            fused_layer=fused_layer, cross_attn=cross_attn,
                            int8_cross_kv=int8_cross_kv),
        mel_cfg=MelConfig(
            padded_seconds=mel_seconds or model.mel_seconds),
        prefix_ids=[model.cfg.bos_token_id],
        dtype=dtype, name="synth", device=device)
    if mesh is not None:
        pipe.use_mesh(mesh)
    return pipe


def pad_waves(waves, n_samples: int) -> np.ndarray:
    """Each wave cut or zero-padded to ``n_samples``: [n, n_samples]."""
    pad = np.zeros((len(waves), n_samples), np.float32)
    for i, w in enumerate(waves):
        m = min(len(w), n_samples)
        pad[i, :m] = w[:m]
    return pad


def transcribe(
    model: SynthModel,
    waves: np.ndarray,
    mel_seconds: float | None = None,
    max_new: int | None = None,
    dtype=None,
    fused_encoder: bool | str | None = False,
    device: str | torch.device | None = None,
    **decode,
) -> list[str]:
    """Greedy transcripts of ``waves`` through synth_pipeline (its
    arguments, ``decode`` its keyword-only decode fields; one device)."""
    pipe = synth_pipeline(model, mel_seconds, max_new, dtype, fused_encoder,
                          device, **decode)
    return pipe.transcribe_batch(pad_waves(waves, pipe.mel_cfg.n_samples))
