"""Whisper fine-tuning (the framework's training subsystem).

Counterpart of ``multimodal_audio_search_tpu/training/finetune.py``: a
teacher-forced cross-entropy step over plain PyTorch under autograd
(``encode(fused_attention=False)`` and ``decode_train``: no kernel is
launched, and a kernel wrapper refuses an input that requires grad,
runtime.refuse_grad), with optax's AdamW chain written as functions on
the port's trees of tensors (``Optimizer``) rather than ``torch.optim``:

  * its state is optax's, NamedTuple for NamedTuple (``EmptyState``,
    ``ScaleByAdamState`` with ``count``, ``mu``, ``nu`` in the
    parameters' dtype, ``ScaleByScheduleState``, ``MaskedState``), so a
    checkpoint's keys are the ones JAX writes for the same chain
    (``1/0/.count``, ``1/0/.mu/<path>``, ``1/0/.nu/<path>``,
    ``1/2/.count`` for ``make_optimizer``) and a JAX run resumes here;
  * the learning rate of a step is the schedule at the count BEFORE the
    step (optax's ``scale_by_schedule``): under warmup the first update
    has lr 0;
  * ``clip_by_global_norm`` scales by ``max_norm / ||g||`` only when
    ``||g|| >= max_norm`` (``clip_grad_norm_`` divides by ``||g|| +
    1e-6``);
  * a frozen leaf (zero gradient) still takes AdamW's decoupled decay,
    as under optax (training/clap.py's frozen text backbone).

``make_train_step(..., mesh=)`` runs a step over a mesh's data axis
(parallel/mesh.py): the batch split into contiguous chunks, one replica
of the parameters a chunk's device, each chunk's ``sum(nll * mask)``
divided by the WHOLE batch's ``sum(mask)`` (JAX's global masked mean,
never a mean of chunk means), the chunks' gradients summed in rank order
on the first data device, where the optimizer runs; the next step
replicates the updated parameters again. The model axis is not trained
(ROADMAP A14b: its partial kernels have no backward).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models import whisper as W
from ..utils.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                          tree_unflatten)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.98
    grad_clip: float = 1.0
    label_smoothing: float = 0.0
    # LR schedule: "constant", or "warmup_cosine" (linear warmup ->
    # cosine decay to end_lr_frac * learning_rate over total_steps —
    # the standard production fine-tuning schedule)
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 10_000
    end_lr_frac: float = 0.1


# ------------------------------------------------------------ schedules
def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, decay_steps: int,
            alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError('The cosine_decay_schedule requires positive '
                         f'decay_steps, got decay_steps={decay_steps}.')

    def schedule(count: int) -> float:
        c = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps)
                                / decay_steps))
        return init * ((1 - alpha) * c + alpha)
    return schedule


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> lr, optax's formulas: constant, linear warmup, or
    warmup_cosine (optax.warmup_cosine_decay_schedule from 0 to the peak
    over max(warmup_steps, 1) steps, then a cosine to end_lr_frac x the
    peak at total_steps)."""
    if cfg.schedule == "constant":
        if cfg.warmup_steps > 0:
            return _linear(0.0, cfg.learning_rate, cfg.warmup_steps)
        lr = cfg.learning_rate
        return lambda count: lr
    if cfg.schedule == "warmup_cosine":
        warm = max(cfg.warmup_steps, 1)
        peak = cfg.learning_rate
        end = peak * cfg.end_lr_frac
        up = _linear(0.0, peak, warm)
        down = _cosine(peak, cfg.total_steps - warm,
                       0.0 if peak == 0.0 else end / peak)
        return lambda count: up(count) if count < warm \
            else down(count - warm)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


# ------------------------------------------------- optax's chain, on trees
class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor          # int32, on the CPU
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor          # int32, on the CPU


class MaskedState(NamedTuple):
    inner_state: Any


_INT32_MAX = 2 ** 31 - 1


def _count(c: int) -> torch.Tensor:
    return torch.tensor(min(c, _INT32_MAX), dtype=torch.int32)


def _aligned(tree, like) -> list:
    """``tree``'s leaves in the order of ``like``'s, matched by path (a
    state carried from JAX holds its dicts in sorted key order)."""
    by_path = dict(tree_leaves_with_path(tree))
    return [by_path[p] for p, _ in tree_leaves_with_path(like)]


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: the square root of the sum of every leaf's
    squares, in float32 (each leaf's norm, then the norm of those; the
    leaves on one device)."""
    gs = [g.float() for g in tree_leaves(grads)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(lr, b1, b2,
    eps, weight_decay, mask))`` (``grad_clip`` None: no clip;
    ``weight_decay`` None: ``adam``), over trees of tensors.

    ``init(params)`` -> the optax state; ``update(grads, state, params)``
    -> (new params, new state): optax's update and ``apply_updates`` in
    one, under no_grad (``norm``: the gradients' global norm, where the
    caller has it). ``learning_rate``: a float or a schedule (step ->
    lr, read at the step's count before it is incremented).
    ``decay_mask(leaf)`` picks the leaves that take the decay."""

    def __init__(self, learning_rate, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float | None = None,
                 decay_mask: Callable | None = None,
                 grad_clip: float | None = None):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_mask = decay_mask
        self.grad_clip = grad_clip

    def init(self, params):
        def zeros(p):
            return torch.zeros_like(p)
        adam = ScaleByAdamState(_count(0), tree_map(zeros, params),
                                tree_map(zeros, params))
        lr_state = ScaleByScheduleState(_count(0)) if callable(self.lr) \
            else EmptyState()
        if self.weight_decay is None:
            inner = (adam, lr_state)
        else:
            decay = MaskedState(EmptyState()) if self.decay_mask \
                else EmptyState()
            inner = (adam, decay, lr_state)
        return inner if self.grad_clip is None else (EmptyState(), inner)

    @torch.no_grad()
    def update(self, grads, state, params, norm=None):
        inner = state if self.grad_clip is None else state[1]
        adam, lr_state = inner[0], inner[-1]
        p = tree_leaves(params)
        g = tree_leaves(grads)
        dev = p[0].device
        if self.grad_clip is not None:
            norm = global_norm(grads) if norm is None else norm
            if not float(norm) < self.grad_clip:
                g = [(t / norm.to(t.device, t.dtype)) * self.grad_clip
                     for t in g]
        b1, b2 = self.b1, self.b2
        mu = [m.to(dev) for m in _aligned(adam.mu, params)]
        nu = [n.to(dev) for n in _aligned(adam.nu, params)]
        mu = torch._foreach_add(torch._foreach_mul(mu, b1), g, alpha=1 - b1)
        nu = torch._foreach_mul(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        count = min(int(adam.count) + 1, _INT32_MAX)
        # the bias corrections in float32, as optax's decay ** count
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if self.weight_decay is not None:
            sel = [i for i, leaf in enumerate(p)
                   if self.decay_mask is None or self.decay_mask(leaf)]
            if sel:
                torch._foreach_add_([u[i] for i in sel], [p[i] for i in sel],
                                    alpha=self.weight_decay)
        if callable(self.lr):
            lr = float(self.lr(int(lr_state.count)))
            lr_state = ScaleByScheduleState(_count(int(lr_state.count) + 1))
        else:
            lr = float(self.lr)
        torch._foreach_mul_(u, -lr)
        new_p = torch._foreach_add(p, u)
        adam = ScaleByAdamState(_count(count), tree_unflatten(params, mu),
                                tree_unflatten(params, nu))
        inner = (adam, *inner[1:-1], lr_state)
        state = inner if self.grad_clip is None else (state[0], inner)
        return tree_unflatten(params, new_p), state


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay))."""
    return Optimizer(make_schedule(cfg), b1=cfg.b1, b2=cfg.b2,
                     weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)


# ------------------------------------------------------------ gradients
def grad_leaves(tree):
    """(``tree`` with each float leaf a fresh autograd leaf sharing its
    storage, those leaves). A leaf made inside ``torch.inference_mode``
    (a pipeline's) is copied first: such a tensor cannot be saved for
    backward."""
    def fresh(t):
        t = t.clone() if t.is_inference() else t.detach()
        return t.requires_grad_() if t.is_floating_point() else t
    out = tree_map(fresh, tree)
    return out, [t for t in tree_leaves(out) if t.requires_grad]


def grads_of(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf for each leaf; zeros where the loss does not reach
    the leaf (a frozen or unused leaf), as JAX's gradient is."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(gs, leaves)]


def sum_in_rank_order(parts: list, device) -> list:
    """Per-leaf sums of the ranks' gradient lists, in rank order, on
    ``device`` (the first data device)."""
    total = [g.to(device) for g in parts[0]]
    for gs in parts[1:]:
        total = [a + g.to(device) for a, g in zip(total, gs)]
    return total


def nll_sum(params, mel: torch.Tensor, tokens: torch.Tensor,
            loss_mask: torch.Tensor, cfg: W.WhisperConfig,
            label_smoothing: float = 0.0) -> torch.Tensor:
    """sum(nll * loss_mask) of the teacher-forced next-token predictions
    (caption_loss before its division)."""
    # fused_attention=False: training differentiates the encoder, and the
    # kernels have no backward (on the card encode would take K8 at
    # T >= 512; its wrapper refuses an input that requires grad)
    enc = W.encode(params, mel, cfg, fused_attention=False)
    logits = W.decode_train(params, enc, tokens[:, :-1], cfg)   # [B,T-1,V]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return (nll * loss_mask.float()).sum()


def caption_loss(
    params, mel: torch.Tensor, tokens: torch.Tensor,
    loss_mask: torch.Tensor, cfg: W.WhisperConfig,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Teacher-forced next-token cross-entropy.

    tokens [B, T] includes the decoder prompt; loss_mask [B, T-1] selects
    which next-token predictions count (0 on prompt/padding). A masked
    mean: sum(nll * m) / max(sum(m), 1); label smoothing mixes in
    -mean(logp) over the vocabulary."""
    m = loss_mask.float()
    return nll_sum(params, mel, tokens, loss_mask, cfg, label_smoothing) \
        / torch.clamp(m.sum(), min=1.0)


def _batch_on(batch: dict, device, dtype) -> dict:
    """The batch's arrays as tensors on ``device``, the mel in the
    parameters' dtype (the conv stem multiplies in the mel's)."""
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    out["mel"] = out["mel"].to(dtype)
    return out


def loss_and_grads(params, batch: dict, cfg: W.WhisperConfig,
                   label_smoothing: float = 0.0, mesh=None):
    """(caption_loss, its gradient tree) of ``batch`` ({"mel", "tokens",
    "loss_mask"}, arrays or tensors). ``mesh``: the step over its data
    axis (module docstring); the loss and gradients on the first data
    device."""
    dev = tree_leaves(params)[0].device
    dtype = params["encoder"]["conv1"]["w"].dtype
    denom = torch.clamp(torch.as_tensor(batch["loss_mask"]).float().sum(),
                        min=1.0)
    with torch.inference_mode(False), torch.enable_grad():
        if mesh is None or len(mesh.data_devices()) == 1:
            b = _batch_on(batch, dev, dtype)
            tree, leaves = grad_leaves(params)
            loss = nll_sum(tree, b["mel"], b["tokens"], b["loss_mask"], cfg,
                           label_smoothing) / denom.to(dev)
            grads = grads_of(loss, leaves)
        else:
            from ..parallel.mesh import data_sharded
            devs = mesh.data_devices()
            chunks = {k: data_sharded(mesh, torch.as_tensor(v))
                      for k, v in batch.items()}
            losses, parts = [], []
            for i, d in enumerate(devs):
                tree, leaves = grad_leaves(
                    tree_map(lambda x, d=d: x.to(d), params))
                mel = chunks["mel"][i].to(dtype)
                s = nll_sum(tree, mel, chunks["tokens"][i],
                            chunks["loss_mask"][i], cfg,
                            label_smoothing) / denom.to(d)
                parts.append(grads_of(s, leaves))
                losses.append(s.detach())
            loss = losses[0].to(dev)
            for s in losses[1:]:
                loss = loss + s.to(dev)
            grads = sum_in_rank_order(parts, dev)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(
    cfg: W.WhisperConfig,
    tcfg: TrainConfig | None = None,
    mesh=None,
):
    """Returns (train_step, opt) where train_step(params, opt_state, batch)
    -> (params, opt_state, metrics): the new parameters and state (the
    old tensors are left to the caller), metrics {"loss", "grad_norm"} as
    0-dim tensors, ``grad_norm`` the global norm BEFORE clipping.
    ``mesh``: the step over its data axis (module docstring)."""
    tcfg = tcfg or TrainConfig()
    opt = make_optimizer(tcfg)

    def train_step(params, opt_state, batch) -> tuple[Any, Any, dict]:
        loss, grads = loss_and_grads(params, batch, cfg,
                                     tcfg.label_smoothing, mesh)
        gnorm = global_norm(grads)
        params, opt_state = opt.update(grads, opt_state, params, gnorm)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt
