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

``make_train_step(..., mesh=)`` runs a step over a mesh (parallel/
mesh.py): the batch split into contiguous chunks, one a data row, each
chunk's ``sum(nll * mask)`` divided by the WHOLE batch's ``sum(mask)``
(JAX's global masked mean, never a mean of chunk means), one backward
over every row. A step works on rank trees (parallel/mesh.py::as_ranks,
in ``shard_heads``' layout, on the first data row's model devices): each
rank holds its shard of every split leaf and a replica of every other,
in the parameters and in Adam's ``mu`` and ``nu``; without a model axis
there is one rank, which holds the whole tree on the first data device.
``loss_and_grads`` and a train step also take one tree, as one rank, and
hand one tree back. Row i runs its chunk on copies of the rank trees on
its own model devices (over the model axis models/whisper.py::encode_tp
with the plain partials and ``decode_train_tp``); a split leaf's
gradient on rank j is the sum over rows of rank j's, and a leaf that is
not split gets the sum over every (row, rank), the same sum on every
rank (JAX's psum of a replicated parameter's gradient: the layer norms,
the conv stem, the embeddings, the row-parallel biases).
``rank_global_norm`` counts each split leaf's shards once and each
replicated leaf once, and the optimizer updates each rank's tree with
the same norm, count and learning rate (``Optimizer.update_ranks``), so
the replicas stay bit-equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models import whisper as W
from ..parallel.mesh import as_ranks, data_sharded, is_ranks, split_leaves
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


def rank_global_norm(grads) -> torch.Tensor:
    """global_norm of the whole tree that rank trees (as_ranks) hold: each
    split leaf by its shards, every other leaf once (rank 0's). Each
    rank's leaf norms are taken on its own device; only those scalars
    move, to rank 0's device, where they are combined in leaf order (one
    rank: global_norm's value bit for bit)."""
    split = split_leaves(grads[0])
    norms = []
    for j, g in enumerate(grads):
        own = [x.float() for x, s in zip(tree_leaves(g), split) if s or not j]
        norms.append(iter(torch._foreach_norm(own) if own else ()))
    dev = tree_leaves(grads[0])[0].device
    return torch.linalg.vector_norm(torch.stack([
        next(norms[j]).to(dev) for s in split
        for j in (range(len(grads)) if s else (0,))]))


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(lr, b1, b2,
    eps, weight_decay, mask))`` (``grad_clip`` None: no clip;
    ``weight_decay`` None: ``adam``), over trees of tensors.

    ``init(params)`` -> the optax state; ``update(grads, state, params)``
    -> (new params, new state): optax's update and ``apply_updates`` in
    one, under no_grad (``norm``: the gradients' global norm, where the
    caller has it). ``init_ranks`` / ``update_ranks``: the same over rank
    trees (as_ranks), each rank its own state, every rank the same update
    with the whole tree's norm. ``learning_rate``: a float or a schedule
    (step -> lr, read at the step's count before it is incremented).
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

    def init_ranks(self, params) -> np.ndarray:
        return as_ranks([self.init(p) for p in params])

    def update_ranks(self, grads, state, params, norm) -> tuple:
        out = [self.update(g, st, p, norm)
               for g, st, p in zip(grads, state, params)]
        return as_ranks([o[0] for o in out]), as_ranks([o[1] for o in out])

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


def grad_rows(params, mesh) -> list:
    """For each data row of ``mesh`` (one without a mesh), (its trees,
    their autograd leaves), each a list with one entry a rank: the row's
    copies of ``params`` on its model devices as fresh autograd leaves
    (grad_leaves; a copy on the device the parameters lie on shares
    their storage). ``params``: rank trees (as_ranks); one rank is a
    replica a row, on the row's first model device."""
    if mesh is None:
        devices = [[None] * len(params)]
    else:
        devices = [mesh.model_devices(i)[:len(params)]
                   for i in range(len(mesh.data_devices()))]
        if len(params) not in (1, len(mesh.model_devices(0))):
            raise ValueError(f"{len(params)} rank trees for a model axis "
                             f"of {len(mesh.model_devices(0))}")
    rows = []
    for devs in devices:
        pairs = [grad_leaves(t if d is None else
                             tree_map(lambda x, d=d: x.to(d), t))
                 for t, d in zip(params, devs)]
        rows.append(([t for t, _ in pairs], [lv for _, lv in pairs]))
    return rows


def sum_rank_grads(params, parts: list) -> np.ndarray:
    """The gradient of rank trees (as_ranks) from ``parts[i][j]``, row i
    rank j's gradient leaves: a split leaf's on rank j the sum over rows
    of rank j's, in row order, on rank j's device; every other leaf the
    sum over every (row, rank), rows in order and ranks in order within
    each, the same sum on every rank."""
    mp = len(params)
    out = [[None] * len(parts[0][0]) for _ in range(mp)]
    for k, split in enumerate(split_leaves(params[0])):
        if split:
            for j in range(mp):
                g = parts[0][j][k]
                for row in parts[1:]:
                    g = g + row[j][k].to(g.device)
                out[j][k] = g
            continue
        g = parts[0][0][k]
        for i, row in enumerate(parts):
            for j in range(mp):
                if i or j:
                    g = g + row[j][k].to(g.device)
        for j in range(mp):
            out[j][k] = g.to(parts[0][j][k].device)
    return as_ranks([tree_unflatten(p, gs) for p, gs in zip(params, out)])


def row_grads(loss: torch.Tensor, params, rows: list) -> np.ndarray:
    """d loss / d rank trees ``params`` through every row of grad_rows
    (one backward), by sum_rank_grads: a replica's gradient (one rank) is
    the sum over the rows in row order on the first data device."""
    gs = iter(grads_of(loss, [t for _, lvs in rows for lv in lvs
                              for t in lv]))
    parts = [[[next(gs) for _ in lv] for lv in lvs] for _, lvs in rows]
    return sum_rank_grads(params, parts)


def batch_rows(batch: dict, mesh, device) -> dict:
    """{key: [a chunk a data row]}: the batch's arrays as tensors, one
    contiguous chunk a data row of ``mesh`` on the row's first model
    device, or the whole batch on ``device`` without a mesh."""
    if mesh is None:
        return {k: [torch.as_tensor(v).to(device)] for k, v in batch.items()}
    return {k: data_sharded(mesh, torch.as_tensor(v))
            for k, v in batch.items()}


def accepts_one_tree(step: Callable) -> Callable:
    """``step(params, opt_state, batch)`` over rank trees (as_ranks),
    taking one tree and its state as well, as one rank, and handing one
    tree and state back for them."""
    def train_step(params, opt_state, batch):
        if is_ranks(params):
            return step(params, opt_state, batch)
        params, opt_state, metrics = step(
            as_ranks([params]), as_ranks([opt_state]), batch)
        return params[0], opt_state[0], metrics
    return train_step


def nll_sum(trees: list, mel: torch.Tensor, tokens: torch.Tensor,
            loss_mask: torch.Tensor, cfg: W.WhisperConfig,
            label_smoothing: float = 0.0) -> torch.Tensor:
    """sum(nll * loss_mask) of the teacher-forced next-token predictions
    (caption_loss before its division). ``trees``: one data row's rank
    trees (one: encode + decode_train; more: encode_tp +
    decode_train_tp), the inputs on the first rank's device."""
    # fused_attention=False, fused_blocks=False: training differentiates
    # the encoder, and the kernels have no backward (on the card encode
    # would take K8 at T >= 512; its wrapper refuses an input that
    # requires grad)
    if len(trees) > 1:
        encs = W.encode_tp(trees, mel, cfg, fused_attention=False,
                           fused_blocks=False)
        logits = W.decode_train_tp(trees, encs, tokens[:, :-1], cfg)
    else:
        enc = W.encode(trees[0], mel, cfg, fused_attention=False)
        logits = W.decode_train(trees[0], enc, tokens[:, :-1], cfg)
    targets = tokens[:, 1:].long()                              # [B,T-1]
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
    return nll_sum([params], mel, tokens, loss_mask, cfg, label_smoothing) \
        / torch.clamp(m.sum(), min=1.0)


def loss_and_grads(params, batch: dict, cfg: W.WhisperConfig,
                   label_smoothing: float = 0.0, mesh=None):
    """(caption_loss, its gradient) of ``batch`` ({"mel", "tokens",
    "loss_mask"}, arrays or tensors). ``params``: rank trees, or one tree
    (as one rank; its gradient one tree); ``mesh``: the step over its
    rows (module docstring). The loss on the first data device, the
    gradient in the parameters' layout."""
    if not is_ranks(params):
        loss, grads = loss_and_grads(as_ranks([params]), batch, cfg,
                                     label_smoothing, mesh)
        return loss, grads[0]
    dev = tree_leaves(params[0])[0].device
    dtype = params[0]["encoder"]["conv1"]["w"].dtype
    denom = torch.clamp(torch.as_tensor(batch["loss_mask"]).float().sum(),
                        min=1.0)
    cols = batch_rows(batch, mesh, dev)
    with torch.inference_mode(False), torch.enable_grad():
        rows = grad_rows(params, mesh)
        loss = None
        for i, (trees, _) in enumerate(rows):
            s = nll_sum(trees, cols["mel"][i].to(dtype), cols["tokens"][i],
                        cols["loss_mask"][i], cfg, label_smoothing)
            s = (s / denom.to(s.device)).to(dev)
            loss = s if loss is None else loss + s
        grads = row_grads(loss, params, rows)
    return loss.detach(), grads


def make_train_step(
    cfg: W.WhisperConfig,
    tcfg: TrainConfig | None = None,
    mesh=None,
):
    """Returns (train_step, opt) where train_step(params, opt_state, batch)
    -> (params, opt_state, metrics): the new parameters and state (the
    old tensors are left to the caller), metrics {"loss", "grad_norm"} as
    0-dim tensors, ``grad_norm`` the global norm BEFORE clipping.
    ``params`` rank trees with their state (``opt.init_ranks``), or one
    tree with its own; ``mesh``: the step over its rows (module
    docstring)."""
    tcfg = tcfg or TrainConfig()
    opt = make_optimizer(tcfg)

    def train_step(params, opt_state, batch) -> tuple[Any, Any, dict]:
        loss, grads = loss_and_grads(params, batch, cfg,
                                     tcfg.label_smoothing, mesh)
        gnorm = rank_global_norm(grads)
        params, opt_state = opt.update_ranks(grads, opt_state, params, gnorm)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return accepts_one_tree(train_step), opt
