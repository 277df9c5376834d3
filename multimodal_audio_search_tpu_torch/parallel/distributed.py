"""Multi-process (DCN) scale-out: process init, the ("dcn", "data",
"model") mesh and the two-stage sharded search.

Counterpart of ``multimodal_audio_search_tpu/parallel/distributed.py``
over ``torch.distributed``:

  * ``initialize()`` starts the process group from explicit arguments or
    torchrun's environment (MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
    RANK; the JAX package reads JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID), NCCL for CUDA and Gloo for the
    CPU, and is a no-op without a world, so one entry point serves one
    process and many.
  * ``make_dcn_mesh(dcn, ici_data, model)``: the "dcn" axis is the
    process rank; each process holds its own data x model devices (its
    row of the grid). With one process it is a reshape of the device
    list, as in JAX: every slice then lives in this process. Its model
    axis runs tensor parallelism inside the process over each data
    row's ``Mesh.model_devices`` (the pipelines' use_mesh), as JAX's
    "model" rides ICI inside a slice.
  * ``hierarchical_sharded_topk`` / ``hierarchical_sharded_ivf`` shard
    the index over both data axes and merge candidates in two stages:
    stage 1 merges the local data shards inside the process (k finalists
    a slice), stage 2 gathers the k finalists of every slice over the
    process group (``all_gather_into_tensor``) and merges them. The
    traffic between processes is k scores and indices a slice and query,
    whatever the index size. Gloo's all-gather takes CPU tensors only:
    under Gloo the finalists (a few hundred bytes) go to the host for
    stage 2; under NCCL they stay on the device. A mesh built without a
    process group runs stage 2 in this process over its slices.

Merge tie rule as parallel/sharding.py's: equal scores go to the lower
global index (slices in rank order, shards in order, a stable sort).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..index.ivf import ivf_shard_tops
from .mesh import Mesh, _devices
from .sharding import merge_topk, shard_tops


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, device="cuda") -> bool:
    """Start torch.distributed's process group; returns True if one runs.

    The arguments fall back to torchrun's environment (the init method
    ``tcp://MASTER_ADDR:MASTER_PORT``, WORLD_SIZE, RANK). Without an init
    method, or with a world of one process from the environment alone,
    this is a no-op returning False; a one-process group starts only
    when the caller passes ``init_method``. ``backend`` defaults to
    "nccl" for a CUDA ``device`` and "gloo" for the CPU."""
    env = os.environ
    explicit = init_method is not None
    if init_method is None and env.get("MASTER_ADDR") and \
            env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world_size = world_size if world_size is not None else \
        int(env.get("WORLD_SIZE", "0") or 0)
    rank = rank if rank is not None else int(env.get("RANK", "0") or 0)
    if init_method is None or world_size < 1 or \
            (world_size == 1 and not explicit):
        return False
    backend = backend or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def _world() -> int | None:
    """The process group's size, None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def make_dcn_mesh(dcn: int | None = None, ici_data: int | None = None,
                  model_parallel: int = 1, devices=None,
                  device="cuda") -> Mesh:
    """The ("dcn", "data", "model") mesh. ``dcn`` defaults to the process
    group's size (1 without one), ``ici_data`` to what fills the rest.

    Inside a process group, ``devices`` (default: ``ici_data`` x
    ``model_parallel`` of ``device``'s, or every visible card, or
    CPU_DEVICES virtual CPU entries) are this process's
    data x model devices, its row of the grid, and ``dcn`` must equal the
    group's size; every row names its process's devices as that process
    sees them (the same names on like hosts). Without a group,
    ``devices`` is the whole flat list, reshaped."""
    world = _world()
    dcn = dcn or world or 1
    if world is not None:
        if dcn != world:
            raise ValueError(f"dcn={dcn} but the process group holds "
                             f"{world} processes")
        local = list(devices) if devices is not None else _devices(
            ici_data * model_parallel if ici_data else None, device)
        per = len(local)
    else:
        devs = list(devices) if devices is not None else \
            _devices(None, device)
        if len(devs) % dcn:
            raise ValueError(f"{len(devs)} devices do not divide into "
                             f"dcn={dcn}")
        per = len(devs) // dcn
    if per % model_parallel:
        raise ValueError("per-dcn devices must divide by model_parallel")
    ici_data = ici_data or per // model_parallel
    if ici_data * model_parallel != per:
        raise ValueError(f"dcn({dcn}) x data({ici_data}) x "
                         f"model({model_parallel}) != {dcn * per} devices")
    flat = local * dcn if world is not None else devs
    grid = np.empty(len(flat), dtype=object)
    grid[:] = [torch.device(d) for d in flat]
    return Mesh(grid.reshape(dcn, ici_data, model_parallel),
                ("dcn", "data", "model"),
                process_index=dist.get_rank() if world is not None else 0,
                world=world)


def _first_shard(mesh: Mesh) -> int:
    """The global shard index of this process's first data device."""
    return mesh.process_index * mesh.shape["data"] \
        if mesh.world is not None else 0


def dcn_data_sharded(mesh: Mesh, x) -> list[torch.Tensor]:
    """``x`` split on axis 0 over both data axes: this process's blocks,
    one on each of its data devices (all of them without a process
    group)."""
    x = torch.as_tensor(x)
    n_shards = mesh.shape["dcn"] * mesh.shape["data"]
    if x.shape[0] % n_shards:
        raise ValueError(f"{tuple(x.shape)} does not divide into "
                         f"{n_shards} shards on axis 0")
    blocks = torch.chunk(x, n_shards)
    devs = mesh.data_devices()
    first = _first_shard(mesh)
    return [b.to(d) for b, d in zip(blocks[first:first + len(devs)], devs)]


def shard_index_dcn(mesh: Mesh, emb, success):
    return dcn_data_sharded(mesh, emb), dcn_data_sharded(mesh, success)


def _two_stage(mesh: Mesh, tops: list, ids: list, kk: int):
    """Stage 1: merge each slice's data shards; stage 2: merge the
    slices' k finalists, over the process group when the mesh has one.
    Returns (scores[kk], indices[kk]) on the first data device."""
    dev = mesh.data_devices()[0]
    dp = mesh.shape["data"]
    finals = [merge_topk(tops[c:c + dp], [ids[c:c + dp]], kk, dev)
              for c in range(0, len(tops), dp)]
    if mesh.world is None:
        return tuple(merge_topk([f[0] for f in finals],
                                [[f[1] for f in finals]], kk, dev))
    s1, i1 = finals[0]
    # one collective: scores and indices as float64 rows (both exact)
    mine = torch.stack([s1.double(), i1.double()], dim=-1)
    if dist.get_backend() == "gloo":
        mine = mine.cpu()
    every = torch.empty((mesh.world * kk, 2), dtype=mine.dtype,
                        device=mine.device)
    dist.all_gather_into_tensor(every, mine.contiguous())
    every = every.to(dev).reshape(mesh.world, kk, 2)
    s, i = merge_topk([every[r, :, 0].float() for r in range(mesh.world)],
                      [[every[r, :, 1].long() for r in range(mesh.world)]],
                      kk, dev)
    return s, i


def hierarchical_sharded_topk(mesh: Mesh, k: int = 10,
                              threshold: float = 0.1):
    """Two-stage sharded fused search over a ("dcn", "data", "model")
    mesh: fn(query[D], emb shards, success shards, w_asr, w_audio) ->
    (scores[k], global indices[k]), the shards as ``shard_index_dcn``
    places them (this process's). Same merge math as
    parallel/sharding.py; equal to the single-device fused_topk."""
    def fn(query, emb, success, w_asr, w_audio):
        tops = shard_tops(query, emb, success, w_asr, w_audio, k=k,
                          threshold=threshold, first=_first_shard(mesh))
        return _two_stage(mesh, [t[2] for t in tops], [t[4] for t in tops],
                          tops[0][2].shape[-1])

    return fn


def hierarchical_sharded_ivf(mesh: Mesh, layout, k: int = 10,
                             n_probe: int = 8, threshold: float = 0.1):
    """IVF candidate generation under the ("dcn", "data", "model") mesh:
    each shard probes its OWN buckets and rescores exactly (index/ivf.py's
    local_candidate_scores), then candidates merge in the two stages of
    ``hierarchical_sharded_topk``. ``layout``: an index/ivf.py
    ShardedIVF whose shard order is the dcn-major order of the shards
    (build_ivf_sharded over dcn*data blocks, or this process's blocks).
    fn(query, cent, members, spill, emb, success, w_asr, w_audio) ->
    (scores[k], global indices[k]); every index-shaped argument a list of
    this process's shards (misses: index -1, score NEG_INF)."""
    n_probe_ = min(n_probe, layout.n_clusters)

    def fn(query, cent, members, spill, emb, success, w_asr, w_audio):
        tops = ivf_shard_tops(query, cent, members, spill, emb, success,
                              w_asr, w_audio, k=k, n_probe=n_probe_,
                              threshold=threshold, first=_first_shard(mesh))
        return _two_stage(mesh, [t[2] for t in tops], [t[4] for t in tops],
                          tops[0][2].shape[-1])

    return fn
