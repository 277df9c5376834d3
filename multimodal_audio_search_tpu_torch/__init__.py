"""Multimodal audio search on PyTorch and CUDA (NVIDIA Hopper).

The port of ``multimodal_audio_search_tpu`` (JAX/Pallas), which stays
beside it as the reference. Same subpackage and module names, same
config, same param pytree keys, same on-disk index format; every Pallas
kernel of the JAX package is a hand-written CUDA kernel here (``csrc/``,
built with nvcc for sm_90a at first use).

Public surface:

    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    engine = AudioSearchEngine(device="cuda")
    engine.load_all_models(warmup=True)
    segments = engine.ingest("clip.wav")
    engine.ingest_many(["a.wav", "b.wav"])
    hits, weights = engine.search("upbeat music with drums", k=10)
    batch = engine.search_batch(["rain on a roof", "a guitar solo"])
    hits, info = engine.search_strategy("rain", "compare_all")
    rows = engine.search_combined("rain", mode="asr")
    text = engine.transcribe_long("lecture.wav")
    engine.delete_source("a.wav")
    engine.save_index("idx")          # or store.save_incremental("idx")
    engine.reconfigure(asr_preset="small")

The HTTP service and UI (``service/server.py``) and the CLI
(``python -m multimodal_audio_search_tpu_torch ingest|search|delete|serve|
stats``) run the same engine; ``pipelines/streaming.py`` commits live
audio as it arrives.

This package imports torch and never jax.
"""

from .config import EngineConfig, default_config  # noqa: F401
from .service.api import AudioSearchEngine  # noqa: F401

__version__ = "0.1.0"
__all__ = ["AudioSearchEngine", "EngineConfig", "default_config"]
