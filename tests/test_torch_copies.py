"""The PyTorch package copies the framework-free host modules of the JAX
package instead of importing them (importing any JAX submodule runs the
JAX package's __init__, which imports jax). Each copy must stay the
original: compared as syntax trees with import statements and the module
docstring left out, so only those may differ."""
import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "multimodal_audio_search_tpu"
PORT_PKG = ROOT / "multimodal_audio_search_tpu_torch"

COPIED = [
    "config.py",
    "utils/batching.py",
    "audio/wav.py",
    "audio/resample.py",
    "audio/segment.py",
    "models/tokenizer.py",
    "pipelines/validators.py",
    "index/lexicon.py",
    "index/analyzer.py",
    "utils/roofline.py",
]
MEL_FUNCS = ["hann_window", "_hz_to_mel_slaney", "_mel_to_hz_slaney",
             "_hz_to_mel_htk", "_mel_to_hz_htk", "mel_filterbank",
             "_dft_mel_weights"]


class _StripImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None


def _normalized(tree: ast.Module) -> str:
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant) and \
            isinstance(body[0].value.value, str):
        body = body[1:]                     # module docstring
    mod = _StripImports().visit(ast.Module(body=body, type_ignores=[]))
    return ast.dump(mod, include_attributes=False)


def _parse(p: pathlib.Path) -> ast.Module:
    return ast.parse(p.read_text(), filename=str(p))


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_original(rel):
    assert _normalized(_parse(PORT_PKG / rel)) == \
        _normalized(_parse(JAX_PKG / rel)), rel


@pytest.mark.parametrize("name", MEL_FUNCS)
def test_mel_numpy_half_matches_original(name):
    def fn(p):
        for node in _parse(p).body:
            if isinstance(node, ast.FunctionDef) and node.name == name:
                return ast.dump(node, include_attributes=False)
        raise AssertionError(f"{name} missing from {p}")
    assert fn(PORT_PKG / "ops/mel.py") == fn(JAX_PKG / "ops/mel.py")


def test_strip_catches_a_change(tmp_path):
    """The comparison is not vacuous: a one-token edit is caught."""
    src = (JAX_PKG / "utils/batching.py").read_text()
    edited = tmp_path / "b.py"
    edited.write_text(src.replace("b *= 2", "b *= 3"))
    assert _normalized(_parse(edited)) != \
        _normalized(_parse(JAX_PKG / "utils/batching.py"))


def test_port_sources_never_import_jax():
    """No module of the port names jax in an import (test (g) below
    checks the transitive closure by running with jax blocked)."""
    for p in PORT_PKG.rglob("*.py"):
        for node in ast.walk(_parse(p)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib") and \
                    not n.startswith("multimodal_audio_search_tpu.") and \
                    n != "multimodal_audio_search_tpu", (p, n)
