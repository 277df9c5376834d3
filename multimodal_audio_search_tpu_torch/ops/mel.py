"""Whisper log-mel frontend.

Counterpart of ``multimodal_audio_search_tpu/ops/mel.py``. The numpy half
(``hann_window``, ``mel_filterbank``, the slaney/htk helpers and
``_dft_mel_weights``) is copied verbatim and held to its original by a
test. The device half (``stft_frames``, ``log_mel_spectrogram``) keeps
the JAX package's formulation: framing from strided chunk views, the
windowed real DFT as ONE float32 matmul against the window-scaled DFT
basis, the mel projection as another, then the log/clamp/scale epilogue.
The JAX package leaves these products to XLA; here they are
``torch.matmul`` in full float32 (TF32 off, see runtime.select_device).

Numerical contract (as the JAX package's, parity-tested against it):
  * n_fft 400, hop 160, periodic Hann, reflect center-padding of n_fft//2
  * power spectrum, last STFT frame dropped -> 3000 frames for 30 s audio
  * slaney-scale, slaney-normalized 80-bin mel filterbank, fmax 8 kHz
  * log10(max(., 1e-10)); per-sample clamp at global max - 8; (x + 4) / 4
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MelConfig


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window / HF)."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))) \
        .astype(np.float64)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        f * 3.0 / 200.0)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel,
        1000.0 * np.exp(logstep * (m - min_log_mel)),
        m * 200.0 / 3.0)


def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_mels: int = 80, n_fft: int = 400, sample_rate: int = 16_000,
    fmin: float = 0.0, fmax: float | None = None,
    mel_scale: str = "slaney", norm: str | None = "slaney",
) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular filterbank.

    Defaults match Whisper's (slaney scale, slaney 2/bandwidth norm);
    ``mel_scale="htk", norm=None`` matches ClapFeatureExtractor's fusion
    filterbank (one triangle construction serves both)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    to_mel, to_hz = {
        "slaney": (_hz_to_mel_slaney, _mel_to_hz_slaney),
        "htk": (_hz_to_mel_htk, _mel_to_hz_htk),
    }[mel_scale]
    mel_pts = np.linspace(
        to_mel(np.float64(fmin)), to_mel(np.float64(fmax)), n_mels + 2)
    hz_pts = to_hz(mel_pts)
    # triangular filters between consecutive center frequencies
    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]         # [F, n_mels+2]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up)).T          # [n_mels, F]
    if norm == "slaney":
        # slaney normalization: 2 / bandwidth
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb = fb * enorm[:, None]
    return fb.astype(np.float64)


@functools.lru_cache(maxsize=8)
def _dft_mel_weights(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """(stft_filters [n_fft, 2*n_freqs], mel [n_freqs, n_mels]) in float32.

    The STFT filters bake the Hann window into the real-DFT basis so framing
    + windowing + DFT is a single strided conv / matmul.
    """
    n_fft = cfg.n_fft
    n_freqs = n_fft // 2 + 1
    win = hann_window(n_fft)
    t = np.arange(n_fft)[:, None]                 # [n_fft, 1]
    k = np.arange(n_freqs)[None, :]               # [1, n_freqs]
    ang = -2.0 * np.pi * t * k / n_fft
    basis = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)  # [n_fft, 2F]
    filt = win[:, None] * basis                       # float64
    mel = mel_filterbank(cfg.n_mels, n_fft, cfg.sample_rate).T
    return filt, mel


_BASIS_CACHE: dict = {}


def _device_weights(cfg: MelConfig, device: torch.device):
    """(stft filters [n_fft, 2F], mel [F, n_mels]) float32 on ``device``,
    built once per (cfg, device)."""
    key = (cfg, str(device))
    if key not in _BASIS_CACHE:
        filt, mel = _dft_mel_weights(cfg)
        _BASIS_CACHE[key] = (
            torch.as_tensor(filt, dtype=torch.float32, device=device),
            torch.as_tensor(mel, dtype=torch.float32, device=device))
    return _BASIS_CACHE[key]


def stft_frames(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[B, L] (already center-padded) -> [B, n_frames, n_fft] frames built
    from hop-sized chunk views and shifted-chunk concats (no gather)."""
    bsz = x.shape[0]
    c = -(-n_fft // hop)                          # chunks per frame
    n_frames = (x.shape[1] - n_fft) // hop + 1
    n_chunks = n_frames - 1 + c
    lp = n_chunks * hop
    # pad-or-truncate to a whole number of chunks: every kept frame ends
    # at (t*hop + n_fft) <= n_chunks*hop
    x2 = F.pad(x, (0, lp - x.shape[1])) if lp >= x.shape[1] else x[:, :lp]
    ch = x2.reshape(bsz, n_chunks, hop)
    return torch.cat([ch[:, i: i + n_frames] for i in range(c)],
                     dim=-1)[..., :n_fft]         # [B, n_frames, n_fft]


def log_mel_spectrogram(wave: torch.Tensor,
                        cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[B, n_samples] float32 -> [B, n_mels, n_frames] Whisper features
    (float32). ``wave`` is already padded/truncated to ``cfg.n_samples``.
    """
    filt, mel = _device_weights(cfg, wave.device)
    n_fft, hop = cfg.n_fft, cfg.hop_length
    half = n_fft // 2
    n_freqs = n_fft // 2 + 1
    x = wave.float()
    x = F.pad(x[:, None, :], (half, half), mode="reflect")[:, 0, :]
    frames = stft_frames(x, n_fft, hop)           # [B, n_frames, n_fft]
    spec = torch.matmul(frames, filt)             # [B, n_frames, 2F]
    spec = spec[:, :-1]                           # HF drops the last frame
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    power = re * re + im * im                     # [B, T, F]
    melspec = torch.matmul(power, mel).transpose(1, 2)   # [B, n_mels, T]
    log_spec = torch.log10(torch.clamp(melspec, min=1e-10))
    gmax = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, gmax - 8.0)
    return (log_spec + 4.0) / 4.0
