"""ClapFeatureExtractor-parity log-mel frontend for the CLAP towers.

A copy of ``multimodal_audio_search_tpu/audio/clap_features.py`` (numpy
only; ``tests/test_torch_copies.py`` holds it to the original) over the
numpy half of the port's ``ops/mel.py``. It reimplements HF's
``ClapFeatureExtractor`` for laion's checkpoints:

  * unfused (rand_trunc): 1024-point STFT, hop 480, periodic Hann,
    reflect centre padding, power spectrum, 64 slaney mel filters over
    0..14 kHz at 48 kHz, 10*log10(max(mel, 1e-10)); short clips
    "repeatpad" to 10 s, long clips a crop at ``crop_offset``;
  * fused (``clap_fusion_features`` / ``clap_fusion_batch``): HTK
    filters, the bilinear global shrink plus three crops of a longer
    clip, and HF's forced ``is_longer`` on an all-short batch.

The mel is computed on the host: [1001, 64] float32 is smaller than the
10 s of 48 kHz audio it replaces, and the HTSAT tower
(``models/clap_htsat.py``) runs on the device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..ops.mel import hann_window, mel_filterbank

SAMPLE_RATE = 48_000
N_FFT = 1024
HOP = 480
N_MELS = 64
FMIN = 0.0
FMAX = 14_000.0
MAX_LENGTH_S = 10
MAX_SAMPLES = MAX_LENGTH_S * SAMPLE_RATE


@lru_cache(maxsize=1)
def _mel_matrix() -> np.ndarray:
    """[n_freqs, n_mels] slaney filterbank, float64 (HF computes in f64)."""
    return mel_filterbank(N_MELS, N_FFT, SAMPLE_RATE, FMIN, FMAX).T


@lru_cache(maxsize=1)
def _mel_matrix_htk() -> np.ndarray:
    """[n_freqs, n_mels] HTK-scale UN-normalized filterbank — what
    ClapFeatureExtractor's *fusion* paths use (its ``self.mel_filters``
    is built with mel_scale='htk', norm=None; only rand_trunc uses the
    slaney one)."""
    return mel_filterbank(N_MELS, N_FFT, SAMPLE_RATE, FMIN, FMAX,
                          mel_scale="htk", norm=None).T


def _pad_short(wave: np.ndarray, max_length: int, padding: str) -> np.ndarray:
    if len(wave) >= max_length:
        return wave
    if padding == "repeat":
        n = max_length // len(wave)
        wave = np.tile(wave, n + 1)[:max_length]
    elif padding == "repeatpad":
        n = max_length // len(wave)
        wave = np.tile(wave, max(n, 1))
    elif padding != "pad":
        raise ValueError(f"unknown padding mode {padding!r}")
    return np.pad(wave, (0, max_length - len(wave)))


def clap_log_mel(
    wave_48k: np.ndarray,
    max_length: int = MAX_SAMPLES,
    padding: str = "repeatpad",
    crop_offset: int = 0,
) -> np.ndarray:
    """48 kHz float waveform -> [n_frames, 64] float32 log-mel.

    n_frames = max_length // hop + 1 (1001 for the 10 s default).
    """
    wave = np.asarray(wave_48k, np.float64)
    if wave.ndim != 1:
        raise ValueError("clap_log_mel expects mono [n] audio")
    if len(wave) > max_length:
        crop_offset = min(max(crop_offset, 0), len(wave) - max_length)
        wave = wave[crop_offset:crop_offset + max_length]
    else:
        wave = _pad_short(wave, max_length, padding)

    half = N_FFT // 2
    padded = np.pad(wave, (half, half), mode="reflect")
    n_frames = (len(padded) - N_FFT) // HOP + 1
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = padded[idx] * hann_window(N_FFT)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2      # [T, n_freqs]
    mel = spec @ _mel_matrix()                            # [T, 64]
    return (10.0 * np.log10(np.maximum(mel, 1e-10))).astype(np.float32)


def clap_input_features(
    wave_48k: np.ndarray, crop_offset: int = 0
) -> np.ndarray:
    """Waveform -> [1, 1, T, 64] model input (ClapAudioModel layout)."""
    return clap_log_mel(wave_48k, crop_offset=crop_offset)[None, None]


# ------------------------------------------------ fusion (fused checkpoint)
@lru_cache(maxsize=8)
def bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] matrix reproducing torch bilinear interpolation with
    align_corners=False (what ClapFeatureExtractor._random_mel_fusion's
    interpolate call uses for the global mel shrink)."""
    m = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    for tap, w in ((0, 1.0 - frac), (1, frac)):
        idx = np.clip(lo + tap, 0, n_in - 1)
        np.add.at(m, (np.arange(n_out), idx), w)
    return m.astype(np.float32)


def _raw_mel(wave: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """STFT+mel of the wave as-is (no pad/crop): [n_frames, 64] f32."""
    half = N_FFT // 2
    padded = np.pad(wave, (half, half), mode="reflect")
    n_frames = (len(padded) - N_FFT) // HOP + 1
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = padded[idx] * hann_window(N_FFT)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = spec @ filters
    return (10.0 * np.log10(np.maximum(mel, 1e-10))).astype(np.float32)


def clap_fusion_features(
    wave_48k: np.ndarray,
    max_length: int = MAX_SAMPLES,
    padding: str = "repeatpad",
    chunk_idx: tuple[int, int, int] | None = None,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, bool]:
    """``truncation="fusion"`` input for enable_fusion checkpoints
    (laion/clap-htsat-fused): -> ([1, 4, chunk_frames, 64], is_longer).

    Mirrors ClapFeatureExtractor._get_input_mel / _random_mel_fusion:

      * audio <= max_length: padded like the unfused path, the mel
        repeated over 4 channels, is_longer False;
      * longer: the full mel is computed once; channels are a bilinear
        align_corners=False time-shrink of the whole mel (global) plus
        three chunk_frames crops drawn from the front/middle/back thirds
        of the valid starts. HF draws the crop starts with np.random;
        pass ``rng`` (or explicit ``chunk_idx`` starts) — default is the
        first start of each third, deterministic.
    """
    wave = np.asarray(wave_48k, np.float64)
    if wave.ndim != 1:
        raise ValueError("clap_fusion_features expects mono [n] audio")
    chunk_frames = max_length // HOP + 1
    if len(wave) <= max_length:
        mel = _raw_mel(_pad_short(wave, max_length, padding),
                       _mel_matrix_htk())
        return np.stack([mel] * 4)[None], False
    mel = _raw_mel(wave, _mel_matrix_htk())
    total = mel.shape[0]
    if chunk_frames == total:        # HF corner case: barely longer
        return np.stack([mel] * 4)[None], False
    ranges = np.array_split(np.arange(0, total - chunk_frames + 1), 3)
    ranges = [r if len(r) else np.array([0]) for r in ranges]
    if chunk_idx is None:
        if rng is not None:
            chunk_idx = tuple(int(rng.choice(r)) for r in ranges)
        else:
            chunk_idx = tuple(int(r[0]) for r in ranges)
    crops = [mel[i: i + chunk_frames] for i in chunk_idx]
    shrink = bilinear_matrix(total, chunk_frames) @ mel
    return np.stack([shrink] + crops)[None].astype(np.float32), True


def clap_fusion_batch(
    waves_48k: list[np.ndarray],
    max_length: int = MAX_SAMPLES,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Batch assembly with HF's quirk: ``ClapFeatureExtractor.__call__``
    forces ONE clip's is_longer to True when no clip in the batch
    exceeds max_length ("if sum(is_longer) == 0: is_longer[rand_idx] =
    True") — so a single short clip ALWAYS runs the AFF fusion path on
    its 4 repeated mels. The index is drawn with np.random in HF; pass
    ``rng`` or get index 0, deterministic."""
    if not waves_48k:
        chunk_frames = max_length // HOP + 1
        return (np.zeros((0, 4, chunk_frames, N_MELS), np.float32),
                np.zeros(0, bool))
    feats, longer = zip(*(clap_fusion_features(w, max_length, rng=rng)
                          for w in waves_48k))
    is_longer = np.asarray(longer, bool)
    if not is_longer.any():
        idx = int(rng.integers(len(is_longer))) if rng is not None else 0
        is_longer[idx] = True
    return np.concatenate(feats, axis=0), is_longer
