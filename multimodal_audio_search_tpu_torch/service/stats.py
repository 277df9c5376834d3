"""Observability: per-pipeline counters and system resource snapshots.

Covers both generations of the reference's telemetry:
  * production ``PipelineStats``/``SystemStats`` (audio_search.py:23-85) —
    call counts, total/avg time, success rate, model size, load time,
    psutil/device polling,
  * the historical timestamped operation log with per-op detail dicts and
    CSV export (streamlit_app_backup.py:80-98, 1350-1413).

Unlike the reference's str()-based "JSON" export (a latent bug,
audio_search.py:1022-1027), ``export_json`` is real json.dumps.

Counterpart of ``multimodal_audio_search_tpu/service/stats.py``; the
system snapshot reads torch.cuda instead of jax.devices(), and the JAX
profiler wrapper (ProfilerSession) is not ported.
"""
from __future__ import annotations

import json
import platform
import time
from dataclasses import asdict, dataclass, field
from typing import Any


@dataclass
class PipelineStats:
    """Parity fields with audio_search.py:23-48 (+ batched-call count)."""

    pipeline_name: str
    model_name: str
    total_calls: int = 0
    total_items: int = 0
    total_processing_time: float = 0.0
    avg_processing_time: float = 0.0
    success_rate: float = 1.0
    successful_extractions: int = 0
    failed_extractions: int = 0
    embedding_dim: int | None = None
    model_size_mb: float = 0.0
    load_time: float = 0.0

    def update(self, processing_time: float, success: bool,
               n: int = 1) -> None:
        self.update_batch(processing_time, n if success else 0,
                          0 if success else n)

    def update_batch(self, processing_time: float, successes: int,
                     failures: int) -> None:
        self.total_calls += 1
        self.total_items += successes + failures
        self.total_processing_time += processing_time
        self.avg_processing_time = \
            self.total_processing_time / self.total_calls
        self.successful_extractions += successes
        self.failed_extractions += failures
        denom = self.successful_extractions + self.failed_extractions
        self.success_rate = self.successful_extractions / max(denom, 1)


@dataclass
class SystemStats:
    """Resource snapshot (audio_search.py:50-85): host memory via psutil
    when installed, the card's name and memory via torch.cuda."""

    cpu_percent: float = 0.0
    memory_percent: float = 0.0
    memory_used_gb: float = 0.0
    memory_total_gb: float = 0.0
    accelerator: str = "none"
    device_count: int = 0
    hbm_used_mb: float = 0.0
    hbm_total_mb: float = 0.0
    platform_info: str = ""
    python_version: str = ""
    torch_version: str = ""

    def update(self) -> None:
        try:
            import psutil
            self.cpu_percent = psutil.cpu_percent(interval=0.0)
            mem = psutil.virtual_memory()
            self.memory_percent = mem.percent
            self.memory_used_gb = mem.used / 1024 ** 3
            self.memory_total_gb = mem.total / 1024 ** 3
        except ImportError:
            pass
        import torch
        self.torch_version = torch.__version__
        if torch.cuda.is_available():
            self.device_count = torch.cuda.device_count()
            self.accelerator = torch.cuda.get_device_name(0)
            self.hbm_used_mb = torch.cuda.memory_allocated(0) / 1024 ** 2
            self.hbm_total_mb = \
                torch.cuda.get_device_properties(0).total_memory / 1024 ** 2
        self.platform_info = f"{platform.system()} {platform.release()}"
        self.python_version = platform.python_version()


@dataclass
class MetricEvent:
    ts: float
    operation: str
    duration_s: float
    details: dict[str, Any] = field(default_factory=dict)


class MetricsLog:
    """Historical-style operation log (streamlit_app_backup.py:80-90)."""

    def __init__(self, capacity: int = 100_000):
        self.events: list[MetricEvent] = []
        self.capacity = capacity

    def log(self, operation: str, duration_s: float, **details: Any) -> None:
        if len(self.events) >= self.capacity:
            self.events.pop(0)
        self.events.append(
            MetricEvent(time.time(), operation, duration_s, details))

    def summary(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        for e in self.events:
            s = out.setdefault(
                e.operation, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += e.duration_s
            s["max_s"] = max(s["max_s"], e.duration_s)
        for s in out.values():
            s["avg_s"] = s["total_s"] / max(s["count"], 1)
        return out


class StatsRegistry:
    """The engine's stats registry (audio_search.py:103-108 equivalent)."""

    def __init__(self, model_names: dict[str, str] | None = None):
        names = model_names or {}
        self.pipelines = {
            "asr_pipeline": PipelineStats(
                "ASR Pipeline", names.get("asr", "whisper-base-torch")),
            "audio_pipeline": PipelineStats(
                "Audio Analysis Pipeline",
                names.get("caption", "whisper-tiny-captioning-torch")),
            "text_embedder": PipelineStats(
                "Text Embedder", names.get("embedder", "minilm-torch")),
            "search_pipeline": PipelineStats(
                "Search Pipeline", "Fused cosine top-k"),
        }
        self.system = SystemStats()
        self.log = MetricsLog()

    def export_json(self, extra: dict[str, Any] | None = None) -> str:
        self.system.update()
        payload = {
            "system": asdict(self.system),
            "models": {k: asdict(v) for k, v in self.pipelines.items()},
            "operations": self.log.summary(),
        }
        if extra:
            payload.update(extra)
        return json.dumps(payload, indent=2)
