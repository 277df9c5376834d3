"""CLAP contrastive training recipe: (audio, caption) pairs -> dual towers.

Counterpart of ``multimodal_audio_search_tpu/training/clap.py``: given
(mel, tokenized caption) pairs it trains the v1 audio tower + text
projection (and optionally the MiniLM backbone) of models/clap.py with
the symmetric InfoNCE objective, a learnable temperature (``log_temp``,
its scale capped at 1 / min_temperature), optax's AdamW chain
(training/finetune.py::Optimizer: global-norm clip, decoupled decay on
leaves of more than one dimension only), background prefetch and step
checkpoints with resume, in JAX's file format.

``train_text_backbone=False`` is JAX's ``stop_gradient``: the backbone's
gradient is zero, so Adam moves it by nothing, but the decoupled decay
still shrinks its matrices every step, as optax's ``add_decayed_weights``
does (``torch.optim`` would skip a parameter whose ``.grad`` is None).

Over a mesh's data axis the batch splits into contiguous chunks, each
tower runs a chunk on its device with that device's replica, and the
embeddings are copied, still tracked by autograd, to the first data
device, where the InfoNCE logits span the WHOLE batch (as JAX's loss over
a data-sharded batch does); one backward reaches every replica, whose
gradients are summed in rank order there. ``model_parallel > 1`` raises
ValueError (ROADMAP A14b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch

from ..models import clap as C
from ..models.minilm import MiniLMConfig, PRESETS as MLM_PRESETS
from ..models.minilm import init_params as init_minilm
from ..utils.tree import tree_map, tree_unflatten
from .finetune import (Optimizer, global_norm, grad_leaves, grads_of,
                       sum_in_rank_order)


@dataclass(frozen=True)
class ClapTrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    init_temperature: float = 0.07     # CLIP init; learned thereafter
    min_temperature: float = 0.01      # clamp (CLIP caps logit scale)
    train_text_backbone: bool = True


def init_clap_params(gen: torch.Generator, acfg: C.ClapConfig,
                     tcfg: MiniLMConfig) -> dict:
    """Random init (float32, CPU); ``log_temp`` = log(1 / 0.07), as the
    JAX function sets it."""
    return {
        "audio": C.init_audio_tower(gen, acfg),
        "text_backbone": init_minilm(gen, tcfg),
        "text_proj": C.init_text_projection(gen, tcfg, acfg),
        "log_temp": torch.log(torch.tensor(1.0 / 0.07, dtype=torch.float32)),
    }


def clap_optimizer(tc: ClapTrainConfig) -> Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    weight_decay=..., mask=ndim > 1))."""
    return Optimizer(tc.learning_rate, weight_decay=tc.weight_decay,
                     decay_mask=lambda leaf: leaf.dim() > 1,
                     grad_clip=tc.grad_clip)


def make_clap_train_step(acfg: C.ClapConfig, tcfg: MiniLMConfig,
                         train_cfg: ClapTrainConfig | None = None,
                         mesh=None):
    """(train_step, optimizer). Batch: {"mel" [B, n_mels, T],
    "input_ids" [B, L], "attention_mask" [B, L]} (arrays or tensors) ->
    metrics with loss, in-batch retrieval accuracy (audio->text top-1),
    temperature and the gradients' global norm before clipping.
    ``mesh``: the step over its data axis (module docstring)."""
    tc = train_cfg or ClapTrainConfig()
    opt = clap_optimizer(tc)

    def embeddings(p, mel, ids, mask):
        az = C.audio_embed(p["audio"], mel, acfg)
        tb = p["text_backbone"] if tc.train_text_backbone \
            else tree_map(lambda t: t.detach(), p["text_backbone"])
        tz = C.text_embed(tb, p["text_proj"], ids, mask, tcfg, acfg)
        return az, tz

    def train_step(params, opt_state, batch):
        dev = params["log_temp"].device
        dtype = params["audio"]["patch"]["w"].dtype
        cap = torch.tensor(1.0 / tc.min_temperature, dtype=torch.float32,
                           device=dev)
        if mesh is None:
            devs = [dev]
            cols = {k: [torch.as_tensor(v)] for k, v in batch.items()}
        else:
            from ..parallel.mesh import data_sharded
            devs = mesh.data_devices()
            cols = {k: data_sharded(mesh, v) for k, v in batch.items()}
        with torch.inference_mode(False), torch.enable_grad():
            replicas, azs, tzs = [], [], []
            for i, d in enumerate(devs):
                tree, leaves = grad_leaves(
                    tree_map(lambda x, d=d: x.to(d), params))
                replicas.append((tree, leaves))
                az, tz = embeddings(
                    tree, cols["mel"][i].to(d, dtype),
                    cols["input_ids"][i].to(d).long(),
                    cols["attention_mask"][i].to(d))
                azs.append(az.to(dev))
                tzs.append(tz.to(dev))
            az, tz = torch.cat(azs), torch.cat(tzs)
            scale = torch.minimum(torch.exp(replicas[0][0]["log_temp"]), cap)
            logits = az @ tz.T * scale
            labels = torch.arange(logits.shape[0], device=dev)
            la = C.optax_softmax_ce(logits, labels)
            lt = C.optax_softmax_ce(logits.T, labels)
            loss = 0.5 * (la + lt)
            # one backward reaches every replica; each replica's share
            gs = grads_of(loss, [t for _, lv in replicas for t in lv])
            n = len(replicas[0][1])
            parts = [gs[i * n:(i + 1) * n] for i in range(len(replicas))]
        grads = tree_unflatten(params, sum_in_rank_order(parts, dev))
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        gnorm = global_norm(grads)
        metrics = {"loss": loss.detach(), "in_batch_acc": acc.detach(),
                   "temperature": (1.0 / scale).detach(), "grad_norm": gnorm}
        params, opt_state = opt.update(grads, opt_state, params, gnorm)
        return params, opt_state, metrics

    return train_step, opt


def train_clap(
    batches: Iterable[dict],          # numpy {mel, input_ids, attention_mask}
    acfg: C.ClapConfig | None = None,
    tcfg: MiniLMConfig | None = None,
    train_cfg: ClapTrainConfig | None = None,
    init_params=None,
    n_devices: int | None = None,
    model_parallel: int = 1,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 100,
    resume: bool = True,
    log_fn: Callable[[str], None] = print,
    prefetch: int = 2,
    *,
    device: str | torch.device = "cuda",
):
    """Full production loop (data-axis mesh + prefetch + checkpoints),
    as training/loop.py's; returns (params, steps, losses).
    ``init_params`` None: init_clap_params from seed 0."""
    from .loop import run_steps, train_mesh
    acfg = acfg or C.ClapConfig()
    tcfg = tcfg or MLM_PRESETS["L6"]
    mesh, dev = train_mesh(n_devices, model_parallel, device, "train_clap")
    params = init_params if init_params is not None else \
        init_clap_params(torch.Generator().manual_seed(0), acfg, tcfg)
    params = tree_map(lambda x: x.to(dev), params)
    train_step, opt = make_clap_train_step(acfg, tcfg, train_cfg, mesh=mesh)
    return run_steps(
        train_step, params, opt.init(params), batches, checkpoint_dir,
        checkpoint_every, resume, log_fn, prefetch, False,
        lambda m: f"acc={float(m['in_batch_acc']):.2f} "
                  f"T={float(m['temperature']):.3f}")
