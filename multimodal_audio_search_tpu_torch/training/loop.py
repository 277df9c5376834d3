"""Training loop driver: fine-tune a Whisper captioner end to end.

Counterpart of ``multimodal_audio_search_tpu/training/loop.py``: the mesh
(parallel/mesh.py, its data axis: parameters replicated, batches split
into contiguous chunks, training/finetune.py), the train step, background
batch prefetch (utils/loader.py) and step checkpoints with resume
(utils/checkpoint.py, the JAX package's file format: a JAX run's
checkpoint resumes here). ``model_parallel > 1`` raises ValueError
(ROADMAP A14b). The parameters and the optimizer state live on the first
data device; a resumed run loads them there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable

import torch

from ..models import whisper as W
from ..parallel.mesh import make_mesh, refuse_model_axis
from ..utils.checkpoint import TrainCheckpointer
from ..utils.loader import PrefetchLoader
from ..utils.tree import tree_map
from .finetune import TrainConfig, make_train_step


@dataclass
class TrainResult:
    params: object
    steps: int
    losses: list


def train_mesh(n_devices, model_parallel: int, device, entry: str):
    """The data-axis mesh a training loop runs over, and its first data
    device (``model_parallel > 1`` refused by name)."""
    from .. import runtime
    refuse_model_axis(model_parallel, training=entry)
    mesh = make_mesh(n_devices, device=runtime.select_device(device))
    return mesh, mesh.data_devices()[0]


def finetune_captioner(
    batches: Iterable[dict],          # {"mel", "tokens", "loss_mask"} numpy
    cfg: W.WhisperConfig,
    tcfg: TrainConfig | None = None,
    init_params=None,
    n_devices: int | None = None,
    model_parallel: int = 1,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 100,
    resume: bool = True,
    log_fn: Callable[[str], None] = print,
    prefetch: int = 2,
    fast_forward_data: bool = False,
    *,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """``n_devices`` data devices of ``device`` (every card, or 8 virtual
    CPU entries, as parallel/mesh.py::make_mesh); ``init_params`` None:
    W.init_params from seed 0."""
    tcfg = tcfg or TrainConfig()
    mesh, dev = train_mesh(n_devices, model_parallel, device,
                           "finetune_captioner")
    params = init_params if init_params is not None \
        else W.init_params(torch.Generator().manual_seed(0), cfg)
    params = tree_map(lambda x: x.to(dev), params)
    train_step, opt = make_train_step(cfg, tcfg, mesh=mesh)
    params, step, losses = run_steps(
        train_step, params, opt.init(params), batches, checkpoint_dir,
        checkpoint_every, resume, log_fn, prefetch, fast_forward_data,
        lambda m: f"gnorm={float(m['grad_norm']):.3f}")
    return TrainResult(params=params, steps=step, losses=losses)


def run_steps(train_step, params, opt_state, batches: Iterable[dict],
              checkpoint_dir: str | None, checkpoint_every: int,
              resume: bool, log_fn: Callable[[str], None], prefetch: int,
              fast_forward_data: bool,
              log_metrics: Callable[[dict], str]) -> tuple:
    """The loop every training entry point runs: resume from the newest
    checkpoint under ``checkpoint_dir`` (if any, and ``resume``), one
    ``train_step`` a prefetched batch, a log line every 10 steps (the
    loss, ``log_metrics(metrics)`` and the rate), a checkpoint every
    ``checkpoint_every`` steps and at the end. Returns (params, the last
    step, the losses of the steps run here)."""
    ck = TrainCheckpointer(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    if ck is not None and resume and ck.latest_step() is not None:
        # restored leaves land on the template's devices: the parameters
        # and moments on the first data device, the counts on the host
        params, restored_opt, meta = ck.restore(params, opt_state)
        if restored_opt is not None:
            opt_state = restored_opt
        start_step = meta["step"]
        log_fn(f"resumed from step {start_step}")
        if fast_forward_data:
            # opt-in for callers that pass the SAME full-dataset iterator on
            # resume: skip the start_step batches already consumed so the
            # step<->sample alignment holds. Callers that pass only the
            # remaining data keep the default (no skipping).
            it = iter(batches)
            for _ in range(start_step):
                if next(it, None) is None:
                    break
            batches = it

    losses = []
    step = start_step
    t_start = time.perf_counter()
    for batch in PrefetchLoader(batches, depth=prefetch):
        params, opt_state, metrics = train_step(params, opt_state, batch)
        step += 1
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 10 == 0:
            rate = (step - start_step) / (time.perf_counter() - t_start)
            log_fn(f"step {step}: loss={loss:.4f} {log_metrics(metrics)} "
                   f"({rate:.2f} steps/s)")
        if ck is not None and step % checkpoint_every == 0:
            ck.save(step, params, opt_state, {"loss": loss})
    if ck is not None:
        ck.save(step, params, opt_state,
                {"loss": losses[-1] if losses else None})
    return params, step, losses
