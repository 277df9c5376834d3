"""Bring the JAX package's parameters over to the port.

Both packages use one weight format: the param pytree of nested dicts and
lists under the same keys, with the layouts of
``multimodal_audio_search_tpu/models/convert.py`` (dense W is [in, out],
conv W is [k, in, out]). The JAX side hands its tree over as numpy
arrays -- ``jax.tree.map(np.asarray, params)`` -- so this module needs
neither jax nor a copy of its code; a tree saved with numpy loads the
same way.
"""
from __future__ import annotations

import numpy as np
import torch

_WHISPER_TOP = {"encoder", "decoder"}
_MINILM_TOP = {"embeddings", "blocks"}


def tree_to_torch(tree):
    """Nested dicts/lists/tuples of array-likes -> the same nesting of
    torch tensors on the CPU (floating leaves as float32; integer leaves
    keep their dtype)."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v) for v in tree]
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(tree, top: set[str], what: str) -> None:
    if not isinstance(tree, dict) or set(tree) != top:
        got = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"not a {what} param tree: top-level keys {got}")

    def walk(t, path):
        if isinstance(t, dict):
            if "wq" in t:
                raise NotImplementedError(
                    f"int8-quantized weights at {path} are not ported "
                    f"(ROADMAP A9, kernel B8)")
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
    walk(tree, "")


def whisper_params(tree):
    """A JAX Whisper param tree (numpy leaves) -> the port's float32
    torch tree, ready for ``WhisperTextPipeline(params=...)``."""
    _check(tree, _WHISPER_TOP, "Whisper")
    return tree_to_torch(tree)


def minilm_params(tree):
    """A JAX MiniLM param tree (numpy leaves) -> the port's float32
    torch tree, ready for ``TextEmbedder(params=...)``."""
    _check(tree, _MINILM_TOP, "MiniLM")
    return tree_to_torch(tree)
