"""Pytree checkpointing (model params + optimizer state).

Counterpart of ``multimodal_audio_search_tpu/utils/checkpoint.py``, over
the port's trees of tensors (utils/tree.py):

  * ``save_pytree`` / ``load_pytree``: any params / optimizer-state tree
    to a single npz whose keys are JAX's ``_path_str`` of each leaf, so a
    parameter tree, and the optimizer state of the same optax chain
    (training/finetune.py), load both ways between the two packages;
  * ``TrainCheckpointer``: numbered step checkpoints with retention and a
    LATEST pointer, for the training loops in training/.

A bfloat16 leaf is written as JAX writes one (2-byte ``|V2`` records:
numpy has no bfloat16, ml_dtypes' has no descriptor of its own) and read
back as bfloat16, with no ml_dtypes: a file's ``|V2`` records are taken
as bfloat16 bits. (The JAX ``load_pytree`` hands such a leaf back as a
void array; ROADMAP, known faults in the reference.)
"""
from __future__ import annotations

import json
import pathlib
import re
from typing import Any

import numpy as np
import torch

from .tree import path_str, tree_leaves_with_path, tree_map

_V2 = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_V2)
    return t.numpy()


def _from_numpy(a: np.ndarray, like) -> torch.Tensor:
    """The file's array as a tensor: its own dtype, or bfloat16 for 2-byte
    void records; on ``like``'s device where ``like`` is a tensor."""
    a = np.ascontiguousarray(a).reshape(a.shape)   # 0-dim stays 0-dim
    if a.dtype == _V2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if torch.is_tensor(like):
        t = t.to(like.device)
    return t


def save_pytree(tree: Any, path: str | pathlib.Path) -> None:
    flat = {path_str(p): _to_numpy(leaf)
            for p, leaf in tree_leaves_with_path(tree)}
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_pytree(template: Any, path: str | pathlib.Path) -> Any:
    """Load into the structure of ``template`` (shapes and dtypes from the
    file; bfloat16 for 2-byte void records; each leaf on the device of
    the template's leaf)."""
    z = np.load(pathlib.Path(path), allow_pickle=False)
    paths = iter(path_str(p) for p, _ in tree_leaves_with_path(template))

    def restore(leaf):
        key = next(paths)
        if key not in z:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _from_numpy(z[key], leaf)
    return tree_map(restore, template)


class TrainCheckpointer:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, params: Any, opt_state: Any = None,
             metadata: dict | None = None) -> pathlib.Path:
        p = self.dir / f"step_{step:08d}"
        save_pytree(params, p.with_suffix(".params.npz"))
        if opt_state is not None:
            save_pytree(opt_state, p.with_suffix(".opt.npz"))
        (p.with_suffix(".meta.json")).write_text(
            json.dumps({"step": step, **(metadata or {})}))
        (self.dir / "LATEST").write_text(str(step))
        self._gc()
        return p

    def latest_step(self) -> int | None:
        f = self.dir / "LATEST"
        return int(f.read_text()) if f.exists() else None

    def restore(self, params_template: Any, opt_template: Any = None,
                step: int | None = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        p = self.dir / f"step_{step:08d}"
        params = load_pytree(params_template, p.with_suffix(".params.npz"))
        opt = None
        if opt_template is not None and \
                p.with_suffix(".opt.npz").exists():
            opt = load_pytree(opt_template, p.with_suffix(".opt.npz"))
        meta = json.loads(p.with_suffix(".meta.json").read_text())
        return params, opt, meta

    def _gc(self) -> None:
        steps = sorted({
            int(m.group(1))
            for f in self.dir.glob("step_*.params.npz")
            if (m := re.match(r"step_(\d+)\.params", f.name))})
        for s in steps[: -self.keep]:
            for suffix in (".params.npz", ".opt.npz", ".meta.json"):
                f = self.dir / f"step_{s:08d}{suffix}"
                if f.exists():
                    f.unlink()
