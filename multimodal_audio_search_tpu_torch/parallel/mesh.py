"""Device mesh construction and placement.

Counterpart of ``multimodal_audio_search_tpu/parallel/mesh.py``. JAX's
mesh is single-controller within a host: one process drives every device
of it. So is this one: a ``Mesh`` is a grid of ``torch.device`` entries
with named axes, and the sharded paths (parallel/sharding.py, the
pipelines' ``use_mesh``, index/store.py's sharded view) loop over its
data-axis devices from one process, as FAISS's ``IndexShards`` does. It
is not ``torch.distributed.DeviceMesh``, which takes one process per
device. The axes:

  * ``data`` shards ingest batches and the index's N axis, in contiguous
    blocks (``data_sharded``); replicas of the parameters sit on each
    data device (``replicated``);
  * ``model`` (Megatron tensor parallelism over attention heads and FFN
    width): ``whisper_param_spec`` and ``shard_params`` give JAX's rule
    and each device's shards; ``shard_heads`` is the rule the port
    executes (whole heads, biases of the row-parallel layers kept whole),
    and the models' TP forms (models/whisper.py, minilm.py, mpnet.py) run
    each data row's ranks on its ``model_devices`` from this one process,
    ending each row-parallel product in ``model_sum`` -- the port's psum
    over "model". A model whose head count does not divide the axis runs
    unsharded on the row's first model device (JAX's GSPMD splits a head
    there; ROADMAP, deliberate differences). Training keeps each rank's
    shard of the parameters and of the optimizer's moments on that rank;
    ``gather_heads`` rebuilds the whole leaves (checkpoints, the serving
    pipeline), ``shard_like`` splits whole leaves again onto the ranks;
  * ``dcn`` (parallel/distributed.py): the process rank.

On the CPU a mesh holds n virtual entries of the CPU (the counterpart of
the JAX tests' 8 virtual XLA CPU devices). A caller may name one card
more than once (``devices=[cuda:0] * 4``), which runs every sharded path
on that card; without ``devices=`` a mesh never repeats a card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.tree import (tree_leaves_with_path, tree_map,
                          tree_map_with_path)

# the virtual CPU entries a CPU mesh holds by default (the JAX test rig's
# device count)
CPU_DEVICES = 8


class Mesh:
    """A grid of devices with named axes.

    ``devices``: an object array of ``torch.device``; ``axis_names``: one
    name per grid axis; ``shape``: {name: size}. ``process_index`` is this
    process's position on a "dcn" axis (0 without one) and ``world`` the
    process group's size when the mesh was built inside one (None: the
    whole mesh lives in this process). Hashed and compared by identity,
    so a cache keyed on a mesh holds the mesh itself."""

    def __init__(self, devices, axis_names, process_index: int = 0,
                 world: int | None = None):
        grid = np.array(devices, dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = torch.device(grid[pos])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid takes "
                             f"{grid.ndim} axis names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.process_index = process_index
        self.world = world

    def _rows(self) -> np.ndarray:
        """This process's devices as [data rows, model]: with a "dcn"
        axis and no process group, every slice's rows (dcn-major); inside
        a group, this process's slice."""
        grid = self.devices
        if "model" in self.axis_names:
            grid = np.moveaxis(grid, self.axis_names.index("model"), -1)
        else:
            grid = grid[..., None]
        if "dcn" in self.axis_names and self.world is not None:
            grid = grid[self.process_index]
        return grid.reshape(-1, grid.shape[-1])

    def data_devices(self) -> list[torch.device]:
        """This process's data-axis devices, in shard order (the model
        axis at index 0): the device of each index block and batch chunk.
        With a "dcn" axis and no process group, every slice's devices
        (dcn-major); inside a group, this process's slice."""
        return list(self._rows()[:, 0])

    def model_devices(self, row: int) -> list[torch.device]:
        """The model-axis devices of data row ``row`` (an index into
        data_devices(), whose device is the first of them), in rank
        order."""
        return list(self._rows()[row])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.data_devices()]})"


def _devices(n: int | None, device) -> list[torch.device]:
    """n devices of type ``device``: every visible card (refusing more
    than there are), or ``CPU_DEVICES`` virtual CPU entries."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * (n or CPU_DEVICES)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    have = torch.cuda.device_count()
    n = n or have
    if n > have:
        raise ValueError(f"asked for {n} devices, have {have} CUDA "
                         f"devices (pass devices= to name them)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              devices=None, device="cuda") -> Mesh:
    """A ("data", "model") mesh of ``n_devices``: ``devices`` as given
    (entries may repeat), else every visible card of ``device`` (at most
    the cards there are) or, for "cpu", that many virtual CPU entries."""
    devs = list(devices) if devices is not None \
        else _devices(n_devices, device)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    if n % model_parallel:
        raise ValueError("n_devices must divide by model_parallel")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devs[:n]]
    return Mesh(grid.reshape(n // model_parallel, model_parallel),
                ("data", "model"))


_POW2 = ("sharded batch and index buckets are powers of two, so dp must "
         "be one of 1, 2, 4, 8, ...")


def validate_data_axis(mesh: Mesh) -> None:
    """Reject a mesh whose 'data' axis is not a power of two, with the
    error ``mesh_from_config`` raises: batch buckets double from a floor
    of max(8, dp) and the index capacity is a power of two, so a dp like
    6 would fail later at the first split."""
    dp = mesh.shape.get("data", 1)
    if dp & (dp - 1):
        raise ValueError(f"mesh 'data' axis = {dp} is not a power of "
                         f"two; {_POW2}")


def mesh_from_config(cfg, device="cuda") -> Mesh | None:
    """Engine knob -> mesh: ``EngineConfig.data_parallel`` x
    ``model_parallel`` devices of ``device`` (never one card twice: more
    than the visible cards raise) as a ("data", "model") grid; 1 x 1
    returns None, single-device execution. ``data_parallel`` must be a
    power of two."""
    dp = getattr(cfg, "data_parallel", 1) or 1
    mp = getattr(cfg, "model_parallel", 1) or 1
    if dp & (dp - 1):
        raise ValueError(f"data_parallel={dp} is not a power of two; "
                         f"{_POW2}")
    if dp * mp <= 1:
        return None
    return make_mesh(dp * mp, model_parallel=mp, device=device)


def replicated(mesh: Mesh, tree) -> list:
    """One copy of ``tree`` (a tensor or a tree of them) on each data
    device; a copy on the device the tensor already lies on is the tensor
    itself."""
    return [tree_map(lambda x: x.to(d) if torch.is_tensor(x) else x, tree)
            for d in mesh.data_devices()]


def data_sharded(mesh: Mesh, x) -> list[torch.Tensor]:
    """``x`` (a tensor or array) split on axis 0 into one contiguous block
    per data device, each on its device."""
    devs = mesh.data_devices()
    x = torch.as_tensor(x)
    if x.shape[0] % len(devs):
        raise ValueError(f"{tuple(x.shape)} does not divide into "
                         f"{len(devs)} data shards on axis 0")
    return [c.to(d) for c, d in zip(torch.chunk(x, len(devs)), devs)]


# ----------------------------------------------------- TP param shardings
def whisper_param_spec(path: tuple, leaf) -> tuple:
    """The Megatron TP rule for the Whisper/MiniLM param trees, as the
    JAX PartitionSpec's entries: column-parallel (the output dim on
    'model': (None, "model")) for attention q/k/v and mlp_in,
    row-parallel (("model", None)) for attention o and mlp_out, weights
    only; everything else replicated (()). ``path``: the dict keys and
    list indices (as strings, utils/tree.py) down to the leaf."""
    if "w" in path:
        if any(k in path for k in ("q", "k", "v", "mlp_in")):
            return (None, "model")
        if any(k in path for k in ("o", "mlp_out")):
            return ("model", None)
    return ()


def shard_params(params, mesh: Mesh) -> np.ndarray:
    """Apply the TP rule: an object array over the mesh's grid whose
    entry at each device is the param tree that device holds, each leaf
    its block of the model axis (by the device's index on it) on that
    device; a leaf whose dim does not divide falls back to a replica."""
    axes = mesh.axis_names
    mp = mesh.shape.get("model", 1)
    out = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(out.shape):
        dev = mesh.devices[pos]
        j = pos[axes.index("model")] if "model" in axes else 0

        def place(path, leaf, dev=dev, j=j):
            if not torch.is_tensor(leaf):
                return leaf
            spec = whisper_param_spec(path, leaf)
            if spec:
                axis = 0 if spec[0] == "model" else 1
                if leaf.dim() >= 2 and leaf.shape[axis] % mp == 0:
                    leaf = torch.chunk(leaf, mp, axis)[j]
            return leaf.to(dev)
        out[pos] = tree_map_with_path(place, params)
    return out


# ------------------------------------------------ TP execution (model axis)
def _head_split(path: tuple) -> int | None:
    """The axis ``shard_heads`` splits a leaf on (None: whole): columns of
    attention q/k/v and mlp_in weights, their biases, rows of attention o
    and mlp_out weights, and MPNet's [buckets, heads] position bias by
    head. An int8 decoder's leaves (ops/quant.py::quantize_whisper_decoder)
    split the same way: the codes ``wq`` as ``w``, q/k/v's and mlp_in's
    per-column ``scale`` with their columns; o's and mlp_out's scale stays
    whole (per output column, which a row shard keeps)."""
    key = path[-1] if path else None
    if "rel_bias" in path:
        return 1
    if any(k in path for k in ("q", "k", "v", "mlp_in")):
        return {"w": 1, "wq": 1, "b": 0, "scale": 0}.get(key)
    if any(k in path for k in ("o", "mlp_out")) and key in ("w", "wq"):
        return 0
    return None


def model_axis_fits(cfg, mp: int) -> bool:
    """Whether a model of ``cfg`` (its ``heads`` and its MLP width,
    ``ffn`` or ``intermediate``) splits into ``mp`` head shards: whole
    heads and an equal share of the MLP a rank."""
    width = getattr(cfg, "ffn", None) or getattr(cfg, "intermediate")
    return cfg.heads % mp == 0 and width % mp == 0


def _rank_leaf(path: tuple, leaf, j: int, mp: int):
    """Rank ``j``'s block of ``leaf`` out of ``mp`` (_head_split's axis;
    the whole leaf where it is not split)."""
    axis = _head_split(path) if torch.is_tensor(leaf) else None
    if axis is None:
        return leaf
    if leaf.shape[axis] % mp:
        raise ValueError(f"{path}: {tuple(leaf.shape)} does not split "
                         f"into {mp} on axis {axis}")
    return torch.chunk(leaf, mp, axis)[j].contiguous()


def shard_heads(params, mesh: Mesh, heads: int) -> np.ndarray:
    """The head-aligned TP placement the port executes: an object array
    over the mesh's [data rows, model] (``Mesh._rows``) whose entry is the
    param tree that device holds, each split leaf its contiguous block of
    the model axis (attention q/k/v columns and biases by whole heads,
    mlp_in columns and bias, attention o and mlp_out rows; o's and
    mlp_out's biases whole, added once by ``model_sum``), every other leaf
    whole, all on that device; an int8 decoder's codes and scales by the
    same rule (_head_split), and its tied logits table
    (``decoder/embed_tokens_q``, K5's) on the first rank only, which
    computes the logits. Any tree whose leaves sit under the parameters'
    paths splits the same way (an optimizer state's moments). Raises
    unless ``heads`` divides the model axis (the caller runs such a model
    unsharded)."""
    rows = mesh._rows()
    mp = rows.shape[1]
    if heads % mp:
        raise ValueError(f"{heads} heads do not split into {mp} model "
                         f"shards")
    out = np.empty(rows.shape, dtype=object)
    for (i, j), dev in np.ndenumerate(rows):
        def place(path, leaf, dev=dev, j=j):
            leaf = _rank_leaf(path, leaf, j, mp)
            return leaf.to(dev) if torch.is_tensor(leaf) else leaf
        tree = params
        if j and isinstance(params, dict) and \
                "embed_tokens_q" in params.get("decoder", {}):
            tree = {**params, "decoder": {
                k: v for k, v in params["decoder"].items()
                if k != "embed_tokens_q"}}
        out[i, j] = tree_map_with_path(place, tree)
    return out


def gather_heads(trees):
    """The inverse of ``shard_heads``: ``trees`` one data row's rank trees
    (a list, or as_ranks' array), each split leaf's rank blocks
    concatenated in rank order on _head_split's axis, on the first rank's
    device; every other leaf rank 0's, where it lies. Returns the whole
    tree."""
    trees = list(trees)
    if len(trees) == 1:
        return trees[0]
    others = [dict(tree_leaves_with_path(t)) for t in trees[1:]]

    def whole(path, leaf):
        axis = _head_split(path) if torch.is_tensor(leaf) else None
        if axis is None:
            return leaf
        return torch.cat([leaf] + [o[path].to(leaf.device) for o in others],
                         axis)
    return tree_map_with_path(whole, trees[0])


def shard_like(whole, trees) -> np.ndarray:
    """``whole`` (a tree of whole leaves: a checkpoint's) split as
    ``trees`` (one data row's rank trees) are: rank j's block of each
    split leaf, every leaf on the device of ``trees[j]``'s leaf at its
    path (a host count stays on the host). Returns a 1-D object array."""
    leaves = dict(tree_leaves_with_path(whole))
    mp = len(trees)

    def rank(j: int, tree):
        def place(path, like):
            leaf = _rank_leaf(path, leaves[path], j, mp)
            return leaf.to(like.device) if torch.is_tensor(like) else leaf
        return tree_map_with_path(place, tree)
    return as_ranks([rank(j, t) for j, t in enumerate(trees)])


def as_ranks(trees) -> np.ndarray:
    """``trees`` (one data row's rank trees, in rank order) as the 1-D
    object array training carries: its state over the model axis."""
    out = np.empty(len(trees), dtype=object)
    for j, tree in enumerate(trees):
        out[j] = tree
    return out


def is_ranks(x) -> bool:
    """Whether ``x`` is such an array of rank trees (as_ranks)."""
    return isinstance(x, np.ndarray) and x.dtype == object


def split_leaves(tree) -> list[bool]:
    """For each leaf of ``tree`` (tree_leaves' order), whether
    ``shard_heads`` splits it over the model axis."""
    return [torch.is_tensor(x) and _head_split(p) is not None
            for p, x in tree_leaves_with_path(tree)]


def model_sum(partials: list, bias, residual) -> list:
    """The port's psum over "model": the ranks' float32 partials (each on
    its rank's device, in rank order) summed in that order on the first
    rank's device, then ``residual + (sum + bias)`` in float32 (bias None:
    none), rounded once to the residual's dtype; the result copied to
    every rank's device (a list in rank order; on a device named twice
    the same tensor). ``residual``: a tensor, or the list of its replicas
    (the first is read)."""
    if isinstance(residual, (list, tuple)):
        residual = residual[0]
    dev = partials[0].device
    y = partials[0].float()
    for p in partials[1:]:
        y = y + p.to(dev).float()
    if bias is not None:
        y = y + bias.to(dev).float()
    out = (residual.to(dev).float() + y).to(residual.dtype)
    return [out.to(p.device) for p in partials]
