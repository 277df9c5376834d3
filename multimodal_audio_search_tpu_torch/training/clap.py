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

Over a mesh the batch splits into contiguous chunks, one a data row,
each tower runs a chunk on the row's devices, and the embeddings are
copied, still tracked by autograd, to the first data device, where the
InfoNCE logits span the WHOLE batch (as JAX's loss over a data-sharded
batch does); one backward reaches every row. Over the data axis alone
a row holds a replica (one rank), whose gradients are summed in row
order there; over the model axis the state is rank trees
(training/finetune.py: each rank's shard of the towers' split leaves and
of Adam's moments), the towers run as models/clap.py::audio_embed_tp and
text_embed_tp, and
``log_temp``, the patch embedding, the pooling, the projections and the
layer norms are replicated leaves whose gradient is summed over every
(row, rank). ``train_text_backbone=False`` detaches each rank's
backbone shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch

from ..models import clap as C
from ..models.minilm import MiniLMConfig, PRESETS as MLM_PRESETS
from ..models.minilm import init_params as init_minilm
from ..utils.tree import tree_map
from .finetune import (Optimizer, accepts_one_tree, batch_rows, grad_rows,
                       rank_global_norm, row_grads)


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
    ``params``: rank trees with their state (``opt.init_ranks``), or one
    tree with its own; ``mesh``: the step over its rows (module
    docstring)."""
    tc = train_cfg or ClapTrainConfig()
    opt = clap_optimizer(tc)

    def embeddings(trees, mel, ids, mask):
        """The row's audio and text embeddings: ``trees`` its rank trees
        (one without a model axis)."""
        tbs = [t["text_backbone"] if tc.train_text_backbone
               else tree_map(lambda x: x.detach(), t["text_backbone"])
               for t in trees]
        if len(trees) > 1:
            az = C.audio_embed_tp([t["audio"] for t in trees], mel, acfg)
            tz = C.text_embed_tp(tbs, trees[0]["text_proj"], ids, mask,
                                 tcfg, acfg)
        else:
            az = C.audio_embed(trees[0]["audio"], mel, acfg)
            tz = C.text_embed(tbs[0], trees[0]["text_proj"], ids, mask,
                              tcfg, acfg)
        return az, tz

    def train_step(params, opt_state, batch):
        dev = params[0]["log_temp"].device
        dtype = params[0]["audio"]["patch"]["w"].dtype
        cap = torch.tensor(1.0 / tc.min_temperature, dtype=torch.float32,
                           device=dev)
        cols = batch_rows(batch, mesh, dev)
        with torch.inference_mode(False), torch.enable_grad():
            rows = grad_rows(params, mesh)
            azs, tzs = [], []
            for i, (trees, _) in enumerate(rows):
                az, tz = embeddings(
                    trees, cols["mel"][i].to(dtype),
                    cols["input_ids"][i].long(), cols["attention_mask"][i])
                azs.append(az.to(dev))
                tzs.append(tz.to(dev))
            az, tz = torch.cat(azs), torch.cat(tzs)
            scale = torch.minimum(torch.exp(rows[0][0][0]["log_temp"]), cap)
            logits = az @ tz.T * scale
            labels = torch.arange(logits.shape[0], device=dev)
            la = C.optax_softmax_ce(logits, labels)
            lt = C.optax_softmax_ce(logits.T, labels)
            loss = 0.5 * (la + lt)
            grads = row_grads(loss, params, rows)
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        gnorm = rank_global_norm(grads)
        metrics = {"loss": loss.detach(), "in_batch_acc": acc.detach(),
                   "temperature": (1.0 / scale).detach(), "grad_norm": gnorm}
        params, opt_state = opt.update_ranks(grads, opt_state, params, gnorm)
        return params, opt_state, metrics

    return accepts_one_tree(train_step), opt


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
    """Full production loop (mesh + prefetch + checkpoints), as
    training/loop.py's; returns (params, steps, losses), the parameters
    whole (gathered from the model axis's ranks). ``init_params`` None:
    init_clap_params from seed 0."""
    from .loop import place_params, run_steps, train_mesh
    acfg = acfg or C.ClapConfig()
    tcfg = tcfg or MLM_PRESETS["L6"]
    mesh = train_mesh(n_devices, model_parallel, device)
    params = init_params if init_params is not None else \
        init_clap_params(torch.Generator().manual_seed(0), acfg, tcfg)
    params = place_params(params, mesh, (acfg, tcfg), log_fn, "train_clap")
    train_step, opt = make_clap_train_step(acfg, tcfg, train_cfg, mesh=mesh)
    return run_steps(
        train_step, params, opt.init_ranks(params), batches, checkpoint_dir,
        checkpoint_every, resume, log_fn, prefetch, False,
        lambda m: f"acc={float(m['in_batch_acc']):.2f} "
                  f"T={float(m['temperature']):.3f}")
