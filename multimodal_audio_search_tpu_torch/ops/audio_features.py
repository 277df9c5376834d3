"""Classic DSP features for the lightweight bridge path, in PyTorch.

Counterpart of ``multimodal_audio_search_tpu/ops/audio_features.py``:
13 MFCCs + spectral centroid / bandwidth / rolloff + zero-crossing rate,
mean-pooled over frames and zero-padded to 128-D (the reference's
librosa feature vector), on the device from the mel frontend's DFT basis
(``ops/mel.py::_dft_mel_weights``, ``stft_frames``) as float32 matmuls.
``_dct_ortho`` is copied and held to the original by
``tests/test_torch_copies.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MelConfig
from .mel import _dft_mel_weights, mel_filterbank, stft_frames

FEATURE_DIM = 128  # zero-padded (lightweight_audio_search.py:108-114)


def _dct_ortho(n_out: int, n_in: int) -> np.ndarray:
    """DCT-II with ortho norm (librosa/scipy convention) as a matrix."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    m *= np.sqrt(2.0 / n_in)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(cfg: MelConfig, n_mfcc: int, device: str):
    """(DFT basis [n_fft, 2F], 128-mel filterbank [128, F], DCT
    [n_mfcc, 128], bin frequencies [F]) on ``device``, float32."""
    filt_np, _ = _dft_mel_weights(cfg)
    n_freqs = cfg.n_fft // 2 + 1
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (filt_np,
                           mel_filterbank(128, cfg.n_fft, cfg.sample_rate),
                           _dct_ortho(n_mfcc, 128),
                           np.linspace(0.0, cfg.sample_rate / 2.0, n_freqs,
                                       dtype=np.float32)))


def audio_feature_vector(wave: torch.Tensor, cfg: MelConfig = MelConfig(),
                         n_mfcc: int = 13) -> torch.Tensor:
    """[B, n_samples] float32 -> [B, 128]: mean-pooled MFCC + centroid +
    bandwidth + rolloff + ZCR, zero-padded."""
    filt, mel, dct, freqs = _tables(cfg, n_mfcc, str(wave.device))
    n_fft, hop = cfg.n_fft, cfg.hop_length
    n_freqs = n_fft // 2 + 1
    x = wave.float()
    x = F.pad(x[:, None, :], (n_fft // 2, n_fft // 2),
              mode="reflect")[:, 0, :]
    spec = torch.matmul(stft_frames(x, n_fft, hop), filt).transpose(1, 2)
    re, im = spec[:, :n_freqs], spec[:, n_freqs:]
    power = re * re + im * im                           # [B, F, T]
    mag = torch.sqrt(torch.clamp(power, min=1e-20))

    # MFCC: mel power -> dB -> DCT-II(ortho) -> first n_mfcc
    melspec = torch.matmul(mel, power)                  # [B, 128, T]
    db = 10.0 * torch.log10(torch.clamp(melspec, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    mfcc = torch.matmul(dct, db)                        # [B, 13, T]

    f = freqs[None, :, None]
    norm = torch.clamp(mag.sum(dim=1, keepdim=True), min=1e-10)
    centroid = (f * mag).sum(dim=1, keepdim=True) / norm   # [B, 1, T]
    bandwidth = torch.sqrt(
        (mag * (f - centroid) ** 2).sum(dim=1, keepdim=True) / norm)
    # rolloff: lowest freq bin holding >= 85% cumulative energy
    cum = torch.cumsum(mag, dim=1)
    thresh = 0.85 * cum[:, -1:, :]
    roll_idx = torch.argmax((cum >= thresh).to(torch.uint8), dim=1)
    rolloff = roll_idx.float() * (cfg.sample_rate / 2.0) / (n_freqs - 1)

    # zero-crossing rate per frame on the unpadded signal, as a mean over
    # hop-aligned chunks (the JAX package's approximation of librosa's
    # frame view)
    w = wave.float()
    flips = torch.diff(torch.sign(w), dim=1).abs() > 0
    usable = (w.shape[1] - 1) // hop * hop
    fl = flips[:, :usable].reshape(w.shape[0], -1, hop)
    zcr_frames = fl.float().mean(dim=2)

    feats = torch.cat([
        mfcc.mean(dim=2),                                   # [B, 13]
        centroid[:, 0, :].mean(dim=1, keepdim=True),
        bandwidth[:, 0, :].mean(dim=1, keepdim=True),
        rolloff.mean(dim=1, keepdim=True),
        zcr_frames.mean(dim=1, keepdim=True),
    ], dim=1)                                               # [B, 17]
    return F.pad(feats, (0, FEATURE_DIM - feats.shape[1]))
