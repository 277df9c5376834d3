"""tools/torch_parity_eval.py against tools/parity_eval.py on the CPU.

Both tools hardcode whisper-base, whisper-tiny and MiniLM-L6, so both
packages' ``PRESETS["base"]`` and ``["tiny"]`` are put at toy widths with
the positions the HF reference needs (1500 encoder positions for its
30 s features, 448 decoder positions for its generation length), over
random-init HF checkpoints saved with a WhisperFeatureExtractor and a
word-level byte-BPE vocabulary (each id decodes to a word, so the toy
decoders' texts pass the validators and segments survive; five whisper
specials). MiniLM is a random-init BertModel at L6's published widths
with a vocab.txt that holds the decoders' words. The JAX tool's
pipelines run at float32 (they default to bf16), as the port's on the
CPU. On the tool's synthetic tone and
noise the two reports are equal field for field: the reference stack
(HF transformers + sentence-transformers) is the same, and our stacks
give the same transcripts, captions and top-10s. With ``transformers``
or ``sentence_transformers`` blocked the port's tool exits naming it.
"""
import json
import sys

import jax.numpy as jnp
import pytest
import torch

from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu_torch.models import whisper as W

WHISPER_KW = dict(vocab_size=270, d_model=32, enc_layers=1, dec_layers=1,
                  heads=2, ffn=64, enc_positions=1500, dec_positions=448,
                  bos_token_id=266, eos_token_id=265, pad_token_id=265,
                  lang_en_id=267, transcribe_id=268, no_timestamps_id=269)
SPECIALS = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>",
            "<|transcribe|>", "<|notimestamps|>"]
# caption keywords among the words, so some captions pass their gate
WORDS = ["music", "sound", "noise", "drums", "guitar", "speech", "voice",
         "singing", "birds", "rain", "wind", "engine", "dog", "bell",
         "tone", "beat", "song", "speaking", "person", "weather"]


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    from transformers import (
        BertConfig, BertModel, WhisperConfig,
        WhisperForConditionalGeneration, WhisperFeatureExtractor,
        WhisperProcessor, WhisperTokenizer)
    tmp = tmp_path_factory.mktemp("parity")
    words = WORDS + [f"w{i}" for i in range(265 - len(WORDS))]
    vocab = {"Ġ" + w: i for i, w in enumerate(words)}
    dirs = {}
    for seed, name in enumerate(("asr", "cap")):
        torch.manual_seed(seed)
        hf = WhisperConfig(
            vocab_size=270, d_model=32, encoder_layers=1, decoder_layers=1,
            encoder_attention_heads=2, decoder_attention_heads=2,
            encoder_ffn_dim=64, decoder_ffn_dim=64,
            max_source_positions=1500, max_target_positions=448,
            num_mel_bins=80, bos_token_id=265, eos_token_id=265,
            pad_token_id=265, decoder_start_token_id=266,
            suppress_tokens=[], begin_suppress_tokens=[], init_std=0.3)
        d = tmp / name
        WhisperForConditionalGeneration(hf).save_pretrained(d)
        (d / "vocab.json").write_text(json.dumps(vocab))
        (d / "merges.txt").write_text("#version: 0.2\n")
        (d / "added_tokens.json").write_text(json.dumps(
            {t: 265 + i for i, t in enumerate(SPECIALS)}))
        WhisperProcessor(WhisperFeatureExtractor(),
                         WhisperTokenizer.from_pretrained(str(d))
                         ).save_pretrained(d)
        dirs[name] = str(d)
    torch.manual_seed(5)
    mini = tmp / "mini"
    BertModel(BertConfig(vocab_size=30522, hidden_size=384,
                         num_hidden_layers=6, num_attention_heads=12,
                         intermediate_size=1536)).save_pretrained(mini)
    specials = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    query_words = ("upbeat music with drums a person speaking clearly "
                   "guitar solo what did they say about the weather "
                   "ambient background noise someone singing song").split()
    # the decoders' words too, so the embedder tells the texts apart
    lines = specials + list(dict.fromkeys(query_words + words))
    lines += [f"v{i}" for i in range(30522 - len(lines))]
    (mini / "vocab.txt").write_text("\n".join(lines) + "\n")
    dirs["mini"] = str(mini)
    dirs["tmp"] = tmp
    return dirs


@pytest.fixture()
def toy_presets():
    """Both packages' base and tiny presets at the stand-ins' widths."""
    saved = [(mod, {k: mod.PRESETS[k] for k in ("base", "tiny")})
             for mod in (JW, W)]
    for mod, _ in saved:
        for name in ("base", "tiny"):
            mod.PRESETS[name] = mod.WhisperConfig(**WHISPER_KW)
    yield
    for mod, old in saved:
        mod.PRESETS.update(old)


def test_reports_equal_jax(standins, toy_presets, monkeypatch):
    import multimodal_audio_search_tpu.pipelines.whisper_pipeline as JWP
    import tools.parity_eval as jpe
    import tools.torch_parity_eval as tpe

    class F32(JWP.WhisperTextPipeline):
        def __init__(self, *a, **k):
            k.setdefault("dtype", jnp.float32)
            super().__init__(*a, **k)

    monkeypatch.setattr(JWP, "WhisperTextPipeline", F32)
    tmp = standins["tmp"]
    monkeypatch.setattr(sys, "argv", [
        "parity_eval.py", "--whisper-base", standins["asr"],
        "--captioner", standins["cap"], "--minilm", standins["mini"],
        "--out", str(tmp / "jax.json")])
    assert jpe.main() == 0
    with open(tmp / "jax.json") as f:
        want = json.load(f)
    got = tpe.run(standins["asr"], standins["cap"], standins["mini"],
                  out=str(tmp / "port.json"), device="cpu")
    with open(tmp / "port.json") as f:
        assert json.load(f) == got
    assert got == want
    assert len(got["segments"]) == 6
    assert any(s["ours_asr"] for s in got["segments"])
    assert any(s["ours_cap"] for s in got["segments"])
    assert all(len(q["ours_top"]) == 6 for q in got["queries"])


def test_tool_copies_match_jax():
    import tools.parity_eval as jpe
    import tools.torch_parity_eval as tpe
    assert tpe.QUERIES == jpe.QUERIES
    for a, b in (("a b c", "a c d"), ("", ""), ("x", ""), ("A a", "a")):
        assert tpe.token_f1(a, b) == jpe.token_f1(a, b)


@pytest.mark.parametrize("package", ["transformers", "sentence_transformers"])
def test_missing_reference_package_named(monkeypatch, tmp_path, package):
    import tools.torch_parity_eval as tpe
    monkeypatch.setitem(sys.modules, package, None)
    monkeypatch.setattr(sys, "argv", [
        "torch_parity_eval.py", "--whisper-base", str(tmp_path),
        "--captioner", str(tmp_path), "--minilm", str(tmp_path),
        "--out", str(tmp_path / "r.json"), "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        tpe.main()
    assert e.value.code != 0 and f"'{package}'" in str(e.value.code)
    assert not (tmp_path / "r.json").exists()
