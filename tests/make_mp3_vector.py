"""Remake the committed MP3 test vector and its fingerprint.

    python tests/make_mp3_vector.py

Writes ``tests/data/vector_16k_mono.mp3``: 14 s of a seeded numpy signal
(two pieces of different pitch and noise level, so the 10 s and 4 s
segments an ingest cuts from it differ), encoded by libmp3lame
(tests/lame_fixture.py) as MPEG-2 Layer III, 16 kHz mono, 32 kbps; and
``tests/data/vector_16k_mono.json``: the sample count, the rate and the
RMS of each 1024-sample block of the JAX package's native decode
(``multimodal_audio_search_tpu/audio/mp3_native.py``). The port's decode
is held to that fingerprint (tests/test_torch_audio.py, chip_smoke.py's
``[audio]`` phase).
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
MP3 = DATA / "vector_16k_mono.mp3"
FINGERPRINT = DATA / "vector_16k_mono.json"
RATE, SECONDS, KBPS, SEED = 16000, 14, 32, 14
BLOCK = 1024


def signal() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    t = np.arange(10 * RATE) / RATE
    pieces = []
    for i, f in enumerate((220.0, 330.0)):
        am = 0.6 + 0.4 * np.sin(2 * np.pi * (0.5 + i) * t)
        pieces.append(0.3 * am * np.sin(2 * np.pi * f * t)
                      + rng.normal(size=t.size) * 0.02 * (1 + 3 * i))
    return np.clip(np.concatenate(pieces)[: SECONDS * RATE], -0.9, 0.9) \
        .astype(np.float32)


def fingerprint(pcm: np.ndarray, rate: int) -> dict:
    """{"samples", "rate", "block", "rms"}: the RMS of each BLOCK-sample
    block (the last block may be shorter), in float64."""
    x = np.asarray(pcm, np.float64)
    rms = [float(np.sqrt(np.mean(x[i: i + BLOCK] ** 2)))
           for i in range(0, len(x), BLOCK)]
    return {"samples": int(len(x)), "rate": int(rate), "block": BLOCK,
            "rms": rms}


def main() -> int:
    sys.path.insert(0, str(HERE.parent))
    sys.path.insert(0, str(HERE))
    from lame_fixture import encode
    from multimodal_audio_search_tpu.audio import mp3_native
    data = encode(signal(), RATE, bitrate=KBPS, mode=3)
    DATA.mkdir(exist_ok=True)
    MP3.write_bytes(data)
    pcm, rate = mp3_native.decode_mp3_native(data)
    FINGERPRINT.write_text(json.dumps(fingerprint(pcm, rate)) + "\n")
    print(f"{MP3.name}: {len(data)} bytes, {len(pcm)} samples at {rate} Hz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
