"""Bring the JAX package's parameters over to the port.

Both packages use one weight format: the param pytree of nested dicts and
lists under the same keys, with the layouts of
``multimodal_audio_search_tpu/models/convert.py`` (dense W is [in, out],
conv W is [k, in, out]). The JAX side hands its tree over as numpy
arrays -- ``jax.tree.map(np.asarray, params)`` -- so this module needs
neither jax nor a copy of its code; a tree saved with numpy loads the
same way.

A Whisper tree from the JAX ``ops/quant.py::quantize_whisper_decoder``
(int8 ``wq`` with float32 ``scale`` in every decoder dense layer, the
``decoder/embed_tokens_q`` logits table and a bf16 ``embed_tokens``)
comes over as it is: int8 leaves stay int8, the bf16 table becomes
float32 holding the same values. Quantized leaves anywhere else (the
encoder, MiniLM) are refused: the JAX package makes none.

The secondary models' trees (MPNet, the CLAP towers of
``models/clap_htsat.py`` and ``models/clap.py``, the bridge) hold float
leaves only -- BN running statistics and relative-bias tables included,
carried as float32 -- and ``None`` where a Swin stage has no
downsampling; any other leaf is refused.

The training trees come over too: ``clap_train_params`` (the CLAP
recipe's {audio, text_backbone, text_proj, log_temp},
training/clap.py) and ``opt_state`` (an optax state -- its NamedTuples
named ``EmptyState``, ``ScaleByAdamState``, ``ScaleByScheduleState``,
``MaskedState`` -- as the port's state of the same names,
training/finetune.py; counts stay int32 on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

_WHISPER_TOP = {"encoder", "decoder"}
_MINILM_TOP = {"embeddings", "blocks"}
_MPNET_TOP = {"embeddings", "rel_bias", "blocks"}
_HTSAT_TOP = {"batch_norm", "patch_embed", "norm", "proj", "stages"}
_ROBERTA_TOP = {"embeddings", "blocks", "pooler", "proj"}
_CLAP_TOWER_TOP = {"patch", "positions", "blocks", "ln", "pool_q", "proj"}
_BRIDGE_TOP = {"layers", "feat_mean", "feat_std"}
_CLAP_TRAIN_TOP = {"audio", "text_backbone", "text_proj", "log_temp"}


def tree_to_torch(tree):
    """Nested dicts/lists/tuples of array-likes -> the same nesting of
    torch tensors on the CPU (floating leaves as float32; integer leaves
    keep their dtype)."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v) for v in tree]
    if tree is None:
        return None
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating) or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    # ascontiguousarray makes a 0-dim array 1-dim: keep the shape
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))


def _check(tree, top: set[str], what: str, quantized_ok: str = "") -> None:
    """Check the top-level keys; refuse int8 leaves outside the subtree
    named ``quantized_ok``."""
    if not isinstance(tree, dict) or set(tree) != top:
        got = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"not a {what} param tree: top-level keys {got}")

    def walk(t, path):
        if isinstance(t, dict):
            if "wq" in t and not (quantized_ok
                                  and path.startswith(f"/{quantized_ok}/")):
                raise NotImplementedError(
                    f"int8-quantized weights at {path}: the JAX package "
                    f"quantizes only the Whisper decoder")
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
    walk(tree, "")


def whisper_params(tree):
    """A JAX Whisper param tree (numpy leaves) -> the port's float32
    torch tree, ready for ``WhisperTextPipeline(params=...)``; a tree
    with an int8 decoder keeps it (module docstring)."""
    _check(tree, _WHISPER_TOP, "Whisper", quantized_ok="decoder")
    return tree_to_torch(tree)


def minilm_params(tree):
    """A JAX MiniLM param tree (numpy leaves) -> the port's float32
    torch tree, ready for ``TextEmbedder(params=...)``."""
    _check(tree, _MINILM_TOP, "MiniLM")
    return tree_to_torch(tree)


def _float_params(tree, top: set[str], what: str):
    """Check the top-level keys and that every leaf is a float array (or
    None); -> the float32 torch tree."""
    _check(tree, top, what)

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        elif t is not None:
            dt = np.asarray(t).dtype
            if not (np.issubdtype(dt, np.floating) or dt.name == "bfloat16"):
                raise ValueError(f"{what} param tree: unexpected {dt} leaf "
                                 f"at {path}")
    walk(tree, "")
    return tree_to_torch(tree)


def mpnet_params(tree):
    """A JAX MPNet tree (models/mpnet.py; numpy leaves) -> the port's
    float32 torch tree, ready for ``TextEmbedder(model=mpnet)``."""
    return _float_params(tree, _MPNET_TOP, "MPNet")


def htsat_params(tree):
    """A JAX HTSAT-Swin audio tower tree (models/clap_htsat.py) -> the
    port's float32 torch tree."""
    return _float_params(tree, _HTSAT_TOP, "HTSAT")


def roberta_params(tree):
    """A JAX CLAP RoBERTa text tower tree (models/clap_htsat.py) -> the
    port's float32 torch tree."""
    return _float_params(tree, _ROBERTA_TOP, "RoBERTa")


def clap_tower_params(tree):
    """A JAX v1 CLAP audio tower tree (models/clap.py) -> the port's
    float32 torch tree."""
    return _float_params(tree, _CLAP_TOWER_TOP, "CLAP audio tower")


def bridge_params(tree):
    """A JAX bridge MLP tree (models/bridge.py) -> the port's float32
    torch tree."""
    return _float_params(tree, _BRIDGE_TOP, "bridge")


def clap_train_params(tree):
    """A JAX CLAP training tree (training/clap.py::init_clap_params:
    the v1 audio tower, the MiniLM backbone, the text projection and the
    0-dim ``log_temp``) -> the port's float32 torch tree."""
    if not isinstance(tree, dict) or set(tree) != _CLAP_TRAIN_TOP:
        got = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"not a CLAP training tree: top-level keys {got}")
    return {"audio": clap_tower_params(tree["audio"]),
            "text_backbone": minilm_params(tree["text_backbone"]),
            "text_proj": _float_params(tree["text_proj"], {"w", "b"},
                                       "text projection"),
            "log_temp": tree_to_torch(tree["log_temp"])}


def opt_state(tree):
    """A JAX optax state (numpy leaves; optax's NamedTuples and the
    chain's tuples) -> the port's optimizer state of the same structure
    (training/finetune.py): float leaves float32, counts int32, all on
    the CPU (the optimizer moves the moments to the parameters'
    device)."""
    from .training import finetune as FT
    from .utils.tree import is_state
    states = {c.__name__: c for c in (FT.EmptyState, FT.ScaleByAdamState,
                                      FT.ScaleByScheduleState,
                                      FT.MaskedState)}

    def walk(t):
        if is_state(t):
            cls = states.get(type(t).__name__)
            if cls is None or tuple(cls._fields) != tuple(t._fields):
                raise ValueError(f"optimizer state {type(t).__name__} "
                                 f"{t._fields} has no counterpart in the "
                                 f"port")
            return cls(*(walk(getattr(t, f)) for f in t._fields))
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return tree_to_torch(t)
    return walk(tree)
