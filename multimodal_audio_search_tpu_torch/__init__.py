"""Multimodal audio search on PyTorch and CUDA (NVIDIA Hopper).

The port of ``multimodal_audio_search_tpu`` (JAX/Pallas), which stays
beside it as the reference. Same subpackage and module names, same
config, same param pytree keys, same on-disk index format; the two
Pallas kernels of the default ingest path are hand-written CUDA kernels
here (``csrc/``, built with nvcc for sm_90a at first use).

Public surface:

    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    engine = AudioSearchEngine(device="cuda")
    segments = engine.ingest("clip.wav")
    hits, weights = engine.search("upbeat music with drums", k=10)

This package imports torch and never jax.
"""

from .config import EngineConfig, default_config  # noqa: F401
from .service.api import AudioSearchEngine  # noqa: F401

__version__ = "0.1.0"
__all__ = ["AudioSearchEngine", "EngineConfig", "default_config"]
