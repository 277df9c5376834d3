"""The tokenizer import order (a fault of the reference; ROADMAP §3).

The JAX ``models/tokenizer.py`` imports ``tokenizers`` in
``build_from_checkpoint_dir`` and ``HFTokenizerWrapper.from_path`` before
it looks for tokenizer assets, so on a host without the package an engine
given any ``weights_path`` raises ModuleNotFoundError, a directory of
weights alone included, for which ``load_tokenizer`` promises the hash
fallback. The port looks first: a weights-only directory takes the hash
tokenizer, while a directory WITH assets still raises (a real BPE is
never replaced by the hash tokenizer without a word). With the package
present both modules load the same tokenizers.
"""
import json
import sys

import numpy as np
import pytest

from multimodal_audio_search_tpu.models import tokenizer as JT
from multimodal_audio_search_tpu_torch.models import tokenizer as PT
from tokenizer_fixture import make_minilm_style_dir, make_whisper_style_dir

TEXTS = ["hello world", "the world says hello", ""]


@pytest.fixture()
def no_tokenizers(monkeypatch):
    """Any import of ``tokenizers`` now raises ModuleNotFoundError."""
    monkeypatch.setitem(sys.modules, "tokenizers", None)


def _weights_only(root):
    d = root / "weights_only"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "whisper"}))
    (d / "pytorch_model.bin").write_bytes(b"")
    return d


def _asset_dir(root, kind):
    """A checkpoint directory carrying one kind of tokenizer assets."""
    if kind == "vocab.txt":
        return make_minilm_style_dir(root)
    d = make_whisper_style_dir(root)
    if kind == "tokenizer.json":
        tok = JT.build_from_checkpoint_dir(d)
        out = root / "json_ckpt"
        out.mkdir()
        tok.save(str(out / "tokenizer.json"))
        return out
    return d


def test_reference_raises_on_weights_only_dir(no_tokenizers, tmp_path):
    with pytest.raises(ModuleNotFoundError):
        JT.load_tokenizer(str(_weights_only(tmp_path)))


def test_port_takes_hash_fallback_on_weights_only_dir(no_tokenizers,
                                                      tmp_path):
    d = _weights_only(tmp_path)
    with pytest.raises(FileNotFoundError):
        PT.build_from_checkpoint_dir(d)
    tok = PT.load_tokenizer(str(d), vocab_size=512, add_cls_sep=False,
                            pad_id=7, eos_id=9)
    assert isinstance(tok, PT.HashWordTokenizer)
    want = PT.load_tokenizer(vocab_size=512, add_cls_sep=False, pad_id=7,
                             eos_id=9)
    for a, b in zip(tok.encode(TEXTS, 16), want.encode(TEXTS, 16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["tokenizer.json", "bpe", "vocab.txt"])
def test_port_raises_on_dir_with_assets(tmp_path, monkeypatch, kind):
    d = _asset_dir(tmp_path, kind)              # built with the package
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ModuleNotFoundError):
        PT.load_tokenizer(str(d))
    if kind == "tokenizer.json":
        with pytest.raises(ModuleNotFoundError):
            PT.HFTokenizerWrapper.from_path(d / "tokenizer.json")


@pytest.mark.parametrize("kind", ["tokenizer.json", "bpe", "vocab.txt"])
def test_port_loads_the_reference_tokenizer(tmp_path, kind):
    """With the package, both load the assets into equal tokenizers."""
    d = _asset_dir(tmp_path, kind)
    jt, pt = JT.load_tokenizer(str(d)), PT.load_tokenizer(str(d))
    assert isinstance(pt, PT.HFTokenizerWrapper)
    for a, b in zip(jt.encode(TEXTS, 16), pt.encode(TEXTS, 16)):
        np.testing.assert_array_equal(a, b)
    ids = jt.encode(TEXTS[:1], 16)[0][0]
    assert jt.decode(ids) == pt.decode(ids)
