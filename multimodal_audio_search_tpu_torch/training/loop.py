"""Training loop driver: fine-tune a Whisper captioner end to end.

Counterpart of ``multimodal_audio_search_tpu/training/loop.py``: the
(data, model) mesh (parallel/mesh.py; batches split into contiguous
chunks, one a data row, training/finetune.py), the train step,
background batch prefetch (utils/loader.py) and step checkpoints with
resume (utils/checkpoint.py, the JAX package's file format: a JAX run's
checkpoint resumes here, and the other way round). The loop carries
the parameters and the optimizer state as rank trees (parallel/mesh.py::
as_ranks): with ``model_parallel > 1`` on the first data row's model
devices (``shard_heads``' layout, each rank its shard of the split
leaves and of Adam's moments), otherwise one rank on the first data
device. A checkpoint holds the whole leaves, gathered on the host, as
JAX's ``np.asarray`` gathers them; a resumed run reads them on the host
and moves each rank's block to its device, so no card ever holds the
whole state, at whatever axis the run resumes. A model whose heads or
MLP width do not divide the axis trains unsharded on each data row's
first model device, which is logged (JAX's GSPMD would split inside a
head). The entry points hand back the whole parameters (gathered).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable

import torch

from ..models import whisper as W
from ..parallel.mesh import (as_ranks, gather_heads, make_mesh,
                             model_axis_fits, shard_heads, shard_like)
from ..utils.checkpoint import TrainCheckpointer
from ..utils.loader import PrefetchLoader
from ..utils.tree import tree_map
from .finetune import TrainConfig, make_train_step


@dataclass
class TrainResult:
    params: object
    steps: int
    losses: list


def train_mesh(n_devices, model_parallel: int, device, devices=None):
    """The (data, model) mesh a training loop runs over: ``devices`` as
    given (entries may repeat: one card named twice), else ``n_devices``
    of ``device`` (parallel/mesh.py::make_mesh), ``model_parallel`` a
    data row."""
    from .. import runtime
    for d in [device] if devices is None else devices:
        runtime.select_device(d)
    return make_mesh(n_devices, model_parallel=model_parallel,
                     devices=devices, device=device)


def place_params(params, mesh, cfgs, log_fn: Callable[[str], None],
                 entry: str):
    """The rank trees a training run starts from, over ``mesh``: on the
    first data row's model devices (shard_heads) where every model
    config of ``cfgs`` splits into the model axis; otherwise one rank,
    the whole tree on the first data device, each data row's first model
    device running a replica (logged under ``entry`` where the axis is
    more than 1). Without a mesh: one rank, where ``params`` lie."""
    if mesh is None:
        return as_ranks([params])
    mp = mesh.shape["model"]
    if mp > 1 and all(model_axis_fits(c, mp) for c in cfgs):
        row = make_mesh(mp, model_parallel=mp, devices=mesh.model_devices(0))
        return shard_heads(params, row, cfgs[0].heads)[0]
    if mp > 1:
        log_fn(f"{entry}: the model does not split into {mp} model "
               f"shards (heads or MLP width); training unsharded on each "
               f"data row's first model device")
    dev = mesh.data_devices()[0]
    return as_ranks([tree_map(lambda x: x.to(dev), params)])


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
    devices=None,
) -> TrainResult:
    """``n_devices`` devices of ``device`` (every card, or 8 virtual CPU
    entries, as parallel/mesh.py::make_mesh), or ``devices`` as named
    (entries may repeat: chip_smoke.py's checkpoint check runs (1, 2) on
    one card named twice), ``model_parallel`` a data row;
    ``init_params`` None: W.init_params from seed 0.
    ``TrainResult.params``: the whole tree."""
    tcfg = tcfg or TrainConfig()
    mesh = train_mesh(n_devices, model_parallel, device, devices)
    params = init_params if init_params is not None \
        else W.init_params(torch.Generator().manual_seed(0), cfg)
    params = place_params(params, mesh, (cfg,), log_fn,
                          "finetune_captioner")
    train_step, opt = make_train_step(cfg, tcfg, mesh=mesh)
    params, step, losses = run_steps(
        train_step, params, opt.init_ranks(params), batches, checkpoint_dir,
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
    ``checkpoint_every`` steps and at the end. ``params`` and
    ``opt_state``: rank trees (as_ranks). Returns (the whole parameters,
    gathered on the first rank's device; the last step; the losses of the
    steps run here)."""
    ck = TrainCheckpointer(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    if ck is not None and resume and ck.latest_step() is not None:
        params, restored_opt, meta = restore_ranks(ck, params, opt_state)
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
            save_ranks(ck, step, params, opt_state, {"loss": loss})
    if ck is not None:
        save_ranks(ck, step, params, opt_state,
                   {"loss": losses[-1] if losses else None})
    return gather_heads(params), step, losses


def save_ranks(ck: TrainCheckpointer, step: int, params, opt_state,
               metadata: dict) -> None:
    """``ck.save`` of rank trees: their whole leaves, gathered on the
    host (JAX's keys and shapes, whatever the axis)."""
    def host(trees):
        return gather_heads([tree_map(lambda x: x.cpu(), t) for t in trees])
    ck.save(step, host(params), host(opt_state), metadata)


def restore_ranks(ck: TrainCheckpointer, params, opt_state) -> tuple:
    """``ck.restore`` of the newest step into rank trees: the whole
    leaves read on the host, each rank's block moved to the device of its
    template leaf (parallel/mesh.py::shard_like; the counts stay on the
    host). Returns (params, opt_state or None where the step has none,
    the step's metadata)."""
    def host(trees):
        # the structure alone: a leaf loads on its template leaf's device
        return tree_map(lambda x: torch.empty(0) if torch.is_tensor(x)
                        else x, trees[0])
    whole, whole_opt, meta = ck.restore(host(params), host(opt_state))
    return (shard_like(whole, params),
            None if whole_opt is None else shard_like(whole_opt, opt_state),
            meta)
