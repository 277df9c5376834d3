"""The PyTorch package copies the framework-free host modules of the JAX
package instead of importing them (importing any JAX submodule runs the
JAX package's __init__, which imports jax). Each copy must stay the
original: compared as syntax trees with import statements and the module
docstring left out, so only those may differ."""
import ast
import pathlib
import re

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
    "models/convert.py",
    "pipelines/validators.py",
    "index/lexicon.py",
    "index/analyzer.py",
    "utils/roofline.py",
    "utils/loader.py",
    "index/eval.py",
    "index/strategies.py",
    "index/combined.py",
    "pipelines/longform.py",
    "pipelines/streaming.py",
    "__main__.py",
    "audio/mp3.py",
    "audio/clap_features.py",
]
# the native loaders' build step: the port builds into its own _build/
# under a per-process temporary name (os.replace into place), after
# asking for g++; the flags, sources and source hash stay JAX's
_BUILD_STEP = [
    ('_BUILD = _REPO / "native" / "build"',
     '_BUILD = pathlib.Path(__file__).resolve().parents[1] / "_build"'),
    ("        _BUILD.mkdir(parents=True, exist_ok=True)\n",
     '        if shutil.which("g++") is None:\n'
     "            _failed = True\n"
     "            return None\n"
     "        _BUILD.mkdir(parents=True, exist_ok=True)\n"),
    ('tmp = so.with_suffix(".so.tmp")',
     'tmp = so.with_suffix(f".so.tmp{os.getpid()}")'),
]
# the port's native.py hands arrays to C by ctypes.cast of the address:
# numpy's data_as leaves a reference cycle behind every call
_NO_DATA_AS = [(re.compile(r"(\w+)\.ctypes\.data_as\("),
                r"ctypes.cast(\1.ctypes.data, ")]
# near-copies: (original, port) source substitutions that name each
# deliberate difference; after them the two must be the same tree. A
# compiled pattern replaces every match (at least one).
NEAR_COPIES = {
    "audio/native.py": _BUILD_STEP + _NO_DATA_AS,
    "audio/mp3_native.py": _BUILD_STEP,
    "audio/ffdecode.py": _BUILD_STEP,
    # the package a user registers decoders with
    "audio/decode.py": [
        ('f"multimodal_audio_search_tpu.audio.decode.register_decoder")',
         'f"multimodal_audio_search_tpu_torch.audio.decode.'
         'register_decoder")')],
    # tokenizers is imported once assets are found: a weights-only
    # directory takes the hash fallback without the package
    "models/tokenizer.py": [
        ("    from tokenizers import Tokenizer\n"
         "    p = pathlib.Path(path)\n"
         '    if (p / "tokenizer.json").exists():\n',
         "    p = pathlib.Path(path)\n"
         '    if (p / "tokenizer.json").exists():\n'
         "        # ``tokenizers`` is imported only once there are assets "
         "to read:\n"
         "        # a directory of weights alone raises FileNotFoundError, "
         "and the\n"
         "        # hash fallback serves it, on a host without the package\n"
         "        from tokenizers import Tokenizer\n"),
        ("        from tokenizers import Tokenizer\n"
         "        p = pathlib.Path(path)\n"
         '        if not p.is_dir() and p.suffix == ".json":\n',
         "        p = pathlib.Path(path)\n"
         '        if not p.is_dir() and p.suffix == ".json":\n'
         "            from tokenizers import Tokenizer\n")],
    "cli.py": [('prog="multimodal_audio_search_tpu"',
                'prog="multimodal_audio_search_tpu_torch"')],
    "service/server.py": [
        # the UI's software card
        ("['JAX',s.jax_version]", "['PyTorch',s.torch_version]"),
        # serve(): the JAX package's TPU-only compilation cache
        ("    from ..utils.compile_cache import enable_from_env\n"
         "    enable_from_env()                   # MAS_COMPILE_CACHE=<dir> "
         "opt-in\n", ""),
        # serve()'s docstring names the reference by its path on the
        # machine the JAX package was written on
        ("/root/reference/audio_search.py", "the reference's audio_search.py"),
    ],
}
MEL_FUNCS = ["hann_window", "_hz_to_mel_slaney", "_mel_to_hz_slaney",
             "_hz_to_mel_htk", "_mel_to_hz_htk", "mel_filterbank",
             "_dft_mel_weights",
             # the mel transfer codecs' host half
             "mel_seg_frames", "_host_mel_fb", "_host_mel_padded",
             "host_log_mel", "_native_mel_codes", "encode_mel16",
             "_relative_codes", "encode_mel12", "encode_mel8"]
# the host-half constants those functions read
MEL_CONSTANTS = ["MEL_LOG_LO", "_MEL_CODE_SCALE", "MEL_REL_RANGE",
                 "_MEL12_SCALE", "_MEL8_SCALE"]
# the waveform codecs' host encoders in pipelines/ingest.py
INGEST_FUNCS = ["_mulaw_lut", "_pack_int12"]
# the IVF bucket packing in index/ivf.py (numpy)
IVF_FUNCS = ["pack_buckets"]
# the secondary models' numpy halves and configs, by module: the CLAP
# towers' configs, bicubic resize, static Swin geometry and HF
# converters; the MFCC's DCT; the embedders' and towers' configs
MODEL_DEFS = [
    *(("models/clap_htsat.py", n) for n in (
        "HTSATConfig", "RobertaConfig", "_cubic_weights", "bicubic_matrix",
        "_relative_position_index", "_shift_mask", "_np", "_lin", "_ln",
        "htsat_config_from_hf", "roberta_config_from_hf",
        "convert_clap_audio", "convert_clap_text", "load_from_dir")),
    ("ops/audio_features.py", "_dct_ortho"),
    ("ops/audio_features.py", "FEATURE_DIM"),
    ("models/mpnet.py", "MPNetConfig"),
    ("models/mpnet.py", "PRESETS"),
    ("models/minilm.py", "MiniLMConfig"),
    ("models/minilm.py", "PRESETS"),
    ("models/clap.py", "ClapConfig"),
    ("models/bridge.py", "BridgeConfig"),
    # the parity tool's reference-stack ranking (numpy)
    ("index/search.py", "reference_fusion_oracle"),
]
# the synthetic captioner's numpy half (training/synth.py): the clip
# generator and the word vocabulary, so one seed gives both packages the
# same clips and token ids
SYNTH_FUNCS = ["SAMPLE_RATE", "_TONES", "_tone", "_noise", "_sweep",
               "EVENTS", "render_event", "make_clip", "SynthVocab"]
# the drift tools' verbatim copies: (JAX tool, port tool, name), each
# held to its own original (eval_context's token_f1 lowercases,
# synth_drift's does not)
TOOL_COPIES = [("synth_drift", "torch_synth_drift", "token_f1"),
               ("synth_drift", "torch_synth_drift", "int16_roundtrip"),
               ("eval_context", "torch_eval_context", "token_f1"),
               ("compare_modes", "torch_compare_modes", "QUERIES"),
               # the weights-day chain and the soak
               ("parity_eval", "torch_parity_eval", "token_f1"),
               ("parity_eval", "torch_parity_eval", "QUERIES"),
               ("soak", "torch_soak", "make_wav")]
# their near-copies: the function with its imports left out (the round
# trips import the port's pipelines/ingest.py) after the named
# substitutions; make_index stores bf16 as its bits without ml_dtypes
TOOL_NEAR_COPIES = {
    ("synth_drift", "torch_synth_drift", "mulaw_roundtrip"): [],
    ("synth_drift", "torch_synth_drift", "int12_roundtrip"): [],
    ("bigindex_drift", "torch_bigindex_drift", "make_index"): [
        ("ml_dtypes.bfloat16", "np.uint16"),
        ("        else:\n            emb[lo:hi] = x.astype(np_dtype)\n",
         '        elif dtype == "bfloat16":\n'
         "            emb[lo:hi] = _bf16_bits(x)\n"
         "        else:\n"
         "            emb[lo:hi] = x.astype(np_dtype)\n")],
    ("build_tokenizer", "torch_build_tokenizer", "build_dir"): [],
}
# the port's drift tools, which the import scan must reach
DRIFT_TOOLS = ["torch_synth_drift", "torch_bigindex_drift",
               "torch_compare_modes", "torch_eval_context"]
# the modules of ROADMAP A14, which the import scan must reach
A14_MODULES = ["training/__init__.py", "training/finetune.py",
               "training/loop.py", "training/synth.py", "training/bridge.py",
               "training/clap.py", "utils/checkpoint.py", "utils/tree.py"]
# the modules of ROADMAP A11, which the import scan must reach
A11_MODULES = ["models/mpnet.py", "models/clap.py", "models/clap_htsat.py",
               "models/bridge.py", "audio/clap_features.py",
               "ops/audio_features.py", "pipelines/clap_ingest.py"]


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


def _near_copy_pair(rel: str, src: str | None = None) -> tuple[str, str]:
    """(original with its named differences applied, port) as normalized
    trees; ``src`` replaces the port's source (the planted-edit case)."""
    orig = (JAX_PKG / rel).read_text()
    for a, b in NEAR_COPIES[rel]:
        if isinstance(a, re.Pattern):
            orig, n = a.subn(b, orig)
            assert n >= 1, (rel, a.pattern)
            continue
        assert orig.count(a) == 1, (rel, a)
        orig = orig.replace(a, b)
    port = src if src is not None else (PORT_PKG / rel).read_text()
    return (_normalized(ast.parse(orig)), _normalized(ast.parse(port)))


@pytest.mark.parametrize("rel", sorted(NEAR_COPIES))
def test_near_copy_differs_only_where_named(rel):
    """The port's cli.py and service/server.py are the JAX modules but for
    the program name, the UI's version entry, the compilation cache and
    a path in serve()'s docstring (the /api/profile route is the same
    code over the port's ProfilerSession); the native audio loaders but
    for their build step; audio/decode.py but for the package its error
    message names. Comments and the module docstring may differ."""
    orig, port = _near_copy_pair(rel)
    assert port == orig, rel


def test_near_copy_catches_a_change():
    """The server comparison is not vacuous: one token changed in a status
    code is caught."""
    src = (PORT_PKG / "service/server.py").read_text()
    assert src.count('"ingest queue full — "\n') == 1
    edited = src.replace('"retry later"}, 429)', '"retry later"}, 503)')
    assert edited != src
    orig, port = _near_copy_pair("service/server.py", edited)
    assert port != orig


def _top_level(p: pathlib.Path, name: str) -> str:
    """The function ``name`` of module ``p``, or the assignment that
    binds it, as a syntax tree."""
    for node in _parse(p).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                node.name == name:
            return ast.dump(node, include_attributes=False)
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names = [n.id for t in targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)]
            if name in names:
                return ast.dump(node, include_attributes=False)
    raise AssertionError(f"{name} missing from {p}")


@pytest.mark.parametrize("name", MEL_FUNCS)
def test_mel_numpy_half_matches_original(name):
    assert _top_level(PORT_PKG / "ops/mel.py", name) == \
        _top_level(JAX_PKG / "ops/mel.py", name)


@pytest.mark.parametrize("name", MEL_CONSTANTS)
def test_mel_constants_match_original(name):
    assert _top_level(PORT_PKG / "ops/mel.py", name) == \
        _top_level(JAX_PKG / "ops/mel.py", name)


@pytest.mark.parametrize("name", INGEST_FUNCS + ["_MULAW_LUT"])
def test_ingest_encoders_match_original(name):
    rel = "pipelines/ingest.py"
    assert _top_level(PORT_PKG / rel, name) == _top_level(JAX_PKG / rel, name)


@pytest.mark.parametrize("name", IVF_FUNCS)
def test_ivf_host_functions_match_original(name):
    rel = "index/ivf.py"
    assert _top_level(PORT_PKG / rel, name) == _top_level(JAX_PKG / rel, name)


@pytest.mark.parametrize("name", SYNTH_FUNCS)
def test_synth_numpy_half_matches_original(name):
    rel = "training/synth.py"
    assert _top_level(PORT_PKG / rel, name) == _top_level(JAX_PKG / rel, name)


@pytest.mark.parametrize("rel,name", MODEL_DEFS)
def test_model_numpy_halves_match_original(rel, name):
    assert _top_level(PORT_PKG / rel, name) == _top_level(JAX_PKG / rel, name)


@pytest.mark.parametrize("orig,port,name", TOOL_COPIES)
def test_drift_tool_copy_matches_original(orig, port, name):
    tools = ROOT / "tools"
    assert _top_level(tools / f"{port}.py", name) == \
        _top_level(tools / f"{orig}.py", name)


def _stripped_def(src: str, name: str, subs=()) -> str:
    """The top-level definition ``name`` of source ``src`` after the
    substitutions ``subs`` (each must match once), with its imports left
    out, as a syntax tree."""
    for node in ast.parse(src).body:
        if getattr(node, "name", None) == name:
            text = ast.get_source_segment(src, node)
            break
    else:
        raise AssertionError(f"{name} missing")
    for a, b in subs:
        assert text.count(a) == 1, (name, a)
        text = text.replace(a, b)
    return _normalized(ast.parse(text))


@pytest.mark.parametrize("orig,port,name", sorted(TOOL_NEAR_COPIES))
def test_drift_tool_near_copy_differs_only_where_named(orig, port, name):
    tools = ROOT / "tools"
    want = _stripped_def((tools / f"{orig}.py").read_text(), name,
                         TOOL_NEAR_COPIES[orig, port, name])
    assert _stripped_def((tools / f"{port}.py").read_text(), name) == want


def test_drift_tool_near_copy_catches_a_change():
    """The function comparison is not vacuous: one constant changed in
    make_index is caught."""
    src = (ROOT / "tools/torch_bigindex_drift.py").read_text()
    edited = src.replace("0.3 * rng.normal", "0.31 * rng.normal")
    assert edited != src
    key = ("bigindex_drift", "torch_bigindex_drift", "make_index")
    want = _stripped_def((ROOT / "tools/bigindex_drift.py").read_text(),
                         "make_index", TOOL_NEAR_COPIES[key])
    assert _stripped_def(edited, "make_index") != want


def test_strip_catches_a_change(tmp_path):
    """The comparison is not vacuous: a one-token edit is caught."""
    src = (JAX_PKG / "utils/batching.py").read_text()
    edited = tmp_path / "b.py"
    edited.write_text(src.replace("b *= 2", "b *= 3"))
    assert _normalized(_parse(edited)) != \
        _normalized(_parse(JAX_PKG / "utils/batching.py"))


# the weights-day, soak, DCN and example tools and the examples, which
# the import scan and the blocked-jax import must reach
LAST_TOOL_SOURCES = ["tools/torch_build_tokenizer.py",
                "tools/torch_weights_day.py", "tools/torch_parity_eval.py",
                "tools/torch_soak.py", "tools/torch_multiprocess_dcn_check.py",
                "tools/torch_run_examples.py",
                "examples/torch_01_basic_search.py",
                "examples/torch_02_scale_search.py",
                "examples/torch_03_multichip.py",
                "examples/torch_04_training.py", "examples/torch_05_service.py"]


def _port_sources() -> list[pathlib.Path]:
    """The port's modules, its card script, its tools and examples."""
    return [*PORT_PKG.rglob("*.py"), ROOT / "chip_smoke.py",
            *sorted((ROOT / "tools").glob("torch_*.py")),
            *sorted((ROOT / "examples").glob("torch_*.py"))]


def _forbidden_imports(p: pathlib.Path) -> list[str]:
    """The imports of ``p`` that name jax, jaxlib, ml_dtypes (which comes
    with jax; the card's machine has none) or the JAX package."""
    bad = []
    for node in ast.walk(_parse(p)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
                or n.split(".")[0] == "multimodal_audio_search_tpu"]
    return bad


def test_port_sources_never_import_jax():
    """No module of the port, nor chip_smoke.py or tools/torch_*.py, names
    jax, ml_dtypes or the JAX package in an import (test (g) below checks
    the transitive closure by running with jax blocked)."""
    srcs = _port_sources()
    assert ROOT / "tools" / "torch_bench_ivf.py" in srcs
    assert {ROOT / "tools" / f"{t}.py" for t in DRIFT_TOOLS} <= set(srcs)
    assert {PORT_PKG / rel for rel in A11_MODULES + A14_MODULES} <= set(srcs)
    assert {ROOT / rel for rel in LAST_TOOL_SOURCES} <= set(srcs)
    for p in srcs:
        assert _forbidden_imports(p) == [], p


def test_import_scan_catches_ml_dtypes(tmp_path):
    """The scan is not vacuous: an import of ml_dtypes, inside a function
    too, and one from the JAX package are caught."""
    p = tmp_path / "m.py"
    p.write_text("def f():\n    import ml_dtypes\n"
                 "from multimodal_audio_search_tpu.index import ivf\n")
    assert sorted(_forbidden_imports(p)) == [
        "ml_dtypes", "multimodal_audio_search_tpu.index"]


def test_last_tools_and_examples_import_with_jax_blocked():
    """Each of LAST_TOOL_SOURCES imports (as a module, its main not
    run) in a process where any import of jax or of the JAX package
    fails, the module-level imports of the tools it loads included."""
    import subprocess
    import sys
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['multimodal_audio_search_tpu'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for rel in {LAST_TOOL_SOURCES!r}:\n"
        f"    p = {str(ROOT)!r} + '/' + rel\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        'm_' + rel.replace('/', '_')[:-3], p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import tools.torch_weights_day, tools.torch_build_tokenizer\n"
        "import multimodal_audio_search_tpu_torch.service.server\n"
        "print('imported', len(" + repr(LAST_TOOL_SOURCES) + "))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == f"imported {len(LAST_TOOL_SOURCES)}"
