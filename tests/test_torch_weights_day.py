"""tools/torch_weights_day.py against tools/weights_day.py, and
chip_smoke.py's stand-in writer.

Random-init HF checkpoints saved by ``save_pretrained`` at the toy widths
of tests/test_weights_day.py's fixture (copied here; raw BPE tokenizer
assets beside the Whisper weights, none beside MiniLM's) run through both
tools' ``run(dry_run=True)`` on the CPU, JAX's engine at float32 as the
port's: the reports are equal in parameter counts, tensors, the
tokenizers' classes and ``real`` flags, smoke segments,
``sample_transcripts``, hits and fusion weights. Two widths differ from
the JAX fixture: its presets leave Whisper's prompt ids (no-timestamps,
transcribe, English) at whisper's 50k-range defaults and give MiniLM 64
words under the hash tokenizer's [CLS] = 101; JAX's gathers clamp such
ids, the port's indexing raises (ROADMAP §3, deliberate differences), so
here the prompt ids lie inside the 256-word vocabulary and MiniLM has 128;
and the Whisper init is 0.3 (tests/test_torch_convert.py's engine test),
so the toy decoders emit texts that the validators keep.

chip_smoke.write_standins (the [weights] phase's writer, the inverse of
models/convert.py) is held to HF: ``from_pretrained`` loads each
directory with no missing and no unexpected key, the HF configs read
back to the presets, and ``convert_*`` gives back the tree written bit
for bit; the [weights] phase itself is rehearsed at toy widths.
"""
import dataclasses
import json
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as C
from multimodal_audio_search_tpu.models import minilm as JM
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu_torch.models import convert
from multimodal_audio_search_tpu_torch.models import minilm as M
from multimodal_audio_search_tpu_torch.models import whisper as W
from tokenizer_fixture import make_whisper_style_dir

torch.set_num_threads(1)

WHISPER_KW = dict(vocab_size=256, d_model=32, enc_layers=1, dec_layers=1,
                  heads=2, ffn=64, enc_positions=500, dec_positions=24,
                  bos_token_id=250, eos_token_id=251, pad_token_id=251,
                  no_timestamps_id=252, transcribe_id=253, lang_en_id=254)
MINI_KW = dict(vocab_size=128, hidden=32, layers=1, heads=2,
               intermediate=64)


@pytest.fixture()
def presets():
    """The toy presets in both packages' PRESETS, under the names the
    production EngineConfig path resolves."""
    for mods, kw in (((JW, W), WHISPER_KW),):
        for mod in mods:
            for name in ("wd-asr", "wd-cap"):
                mod.PRESETS[name] = mod.WhisperConfig(**kw)
    for mod in (JM, M):
        mod.PRESETS["wd-mini"] = mod.MiniLMConfig(**MINI_KW)
    yield
    for mod in (JW, W):
        for name in ("wd-asr", "wd-cap"):
            mod.PRESETS.pop(name, None)
    for mod in (JM, M):
        mod.PRESETS.pop("wd-mini", None)


@pytest.fixture()
def standins(tmp_path, presets):
    """tests/test_weights_day.py's stand-ins: random-init HF checkpoints
    at toy shapes, with raw tokenizer assets beside the Whisper ones."""
    from transformers import (
        BertConfig, BertModel, WhisperConfig, WhisperForConditionalGeneration)
    torch.manual_seed(0)
    w = WHISPER_KW
    wcfg_hf = WhisperConfig(
        vocab_size=w["vocab_size"], d_model=w["d_model"],
        encoder_layers=1, decoder_layers=1, encoder_attention_heads=2,
        decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=500, max_target_positions=24,
        num_mel_bins=80, bos_token_id=250, eos_token_id=251,
        pad_token_id=251, decoder_start_token_id=250, init_std=0.3)
    asr_dir = tmp_path / "asr"
    cap_dir = tmp_path / "cap"
    WhisperForConditionalGeneration(wcfg_hf).save_pretrained(asr_dir)
    WhisperForConditionalGeneration(wcfg_hf).save_pretrained(cap_dir)
    tok_src = make_whisper_style_dir(tmp_path)
    for d in (asr_dir, cap_dir):
        for f in ("vocab.json", "merges.txt", "added_tokens.json"):
            (d / f).write_text((tok_src / f).read_text())
    bcfg_hf = BertConfig(
        vocab_size=MINI_KW["vocab_size"], hidden_size=32,
        num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    mini_dir = tmp_path / "mini"
    BertModel(bcfg_hf).save_pretrained(mini_dir)
    return {"asr": asr_dir, "cap": cap_dir, "mini": mini_dir,
            "tmp": tmp_path}


def _copy(standins, label, assets: bool):
    """A fresh copy of the three directories (each tool writes its
    tokenizer.json into its own), without the Whisper directories'
    tokenizer assets unless ``assets``."""
    root = standins["tmp"] / label
    out = []
    for k in ("asr", "cap", "mini"):
        d = shutil.copytree(standins[k], root / k)
        if not assets:
            for f in ("vocab.json", "merges.txt", "added_tokens.json"):
                (d / f).unlink(missing_ok=True)
        out.append(str(d))
    return out


@pytest.mark.parametrize("assets", [True, False])
def test_reports_equal_jax(standins, monkeypatch, assets):
    """The fixture's directories (real BPE beside the Whisper weights),
    and the same weights alone (every model on the hash tokenizer)."""
    import multimodal_audio_search_tpu.service.api as japi
    import tools.torch_weights_day as twd
    import tools.weights_day as jwd

    j_make = japi.make_default_ingest
    # the JAX engine at float32, as the port's on the CPU (its pipelines
    # default to bf16)
    monkeypatch.setattr(japi, "make_default_ingest",
                        lambda *a, **k: j_make(*a, **{**k,
                                                      "dtype": jnp.float32}))
    monkeypatch.chdir(standins["tmp"])
    kw = dict(dry_run=True, asr_preset="wd-asr", caption_preset="wd-cap",
              minilm_preset="wd-mini", embed_dim=32, short_context=True,
              smoke_max_new=6)
    jdirs, tdirs = (_copy(standins, lb, assets) for lb in ("jax", "port"))
    want = jwd.run(*jdirs, out=str(standins["tmp"] / "j.json"), **kw)
    got = twd.run(*tdirs, out=str(standins["tmp"] / "t.json"),
                  device="cpu", **kw)
    with open(standins["tmp"] / "t.json") as f:
        assert json.load(f) == got
    g, w = got["steps"], want["steps"]
    assert g.keys() == w.keys()
    for name in ("whisper_base", "captioner", "minilm"):
        assert g["convert"][name] == w["convert"][name]
    assert g["convert"]["whisper_base"]["params"] == twd.n_params(
        W.init_params(torch.Generator().manual_seed(0), W.PRESETS["wd-asr"]))
    for name, tok in w["tokenize"].items():
        assert g["tokenize"][name]["class"] == tok["class"]
        assert g["tokenize"][name]["real"] == tok["real"]
        assert g["tokenize"][name]["build"].replace(
            str(standins["tmp"] / "port"), "") == tok["build"].replace(
            str(standins["tmp"] / "jax"), "")
    assert g["tokenize"]["whisper_base"]["real"] == assets
    assert not g["tokenize"]["minilm"]["real"]
    for key in ("ok", "segments", "sample_transcripts", "hits"):
        assert g["smoke"][key] == w["smoke"][key], (key, g["smoke"],
                                                     w["smoke"])
    assert g["smoke"]["weights"].keys() == w["smoke"]["weights"].keys()
    for key, v in w["smoke"]["weights"].items():
        assert g["smoke"]["weights"][key] == pytest.approx(v)
    assert g["parity"] == w["parity"] == "skipped (--dry-run)"
    assert g["smoke"]["segments"] > 0 and g["smoke"]["hits"] > 0


TOY_STANDINS = (("asr", "whisper", "wd-asr"), ("cap", "whisper", "wd-cap"),
                ("mini", "minilm", "wd-mini"))


def test_standin_writer_round_trips_through_hf(tmp_path, presets):
    from transformers import BertModel, WhisperForConditionalGeneration
    dirs, trees = C.write_standins(str(tmp_path), 3, TOY_STANDINS)
    for name, family, preset in TOY_STANDINS:
        cls = WhisperForConditionalGeneration if family == "whisper" \
            else BertModel
        model, info = cls.from_pretrained(dirs[name],
                                          output_loading_info=True)
        assert info["missing_keys"] == [] and \
            info["unexpected_keys"] == [], (name, info)
        sd = convert.load_state_dict_from_dir(dirs[name])
        if family == "whisper":
            p = W.PRESETS[preset]
            assert dataclasses.replace(
                convert.whisper_config_from_hf(model.config),
                no_timestamps_id=p.no_timestamps_id,
                transcribe_id=p.transcribe_id,
                lang_en_id=p.lang_en_id) == p
            tree = convert.convert_whisper(sd, p)
            # HF's model computes with the written weights: its token
            # table is the tree's
            np.testing.assert_array_equal(
                model.model.decoder.embed_tokens.weight.detach().numpy(),
                trees[name]["decoder"]["embed_tokens"].numpy())
        else:
            assert convert.bert_config_from_hf(model.config) == \
                M.PRESETS[preset]
            tree = convert.convert_bert(sd, M.PRESETS[preset])
        assert C.tree_bits_equal(name, tree, trees[name]) > 10


def test_standin_writer_catches_a_wrong_key(tmp_path, presets):
    """The bit-for-bit check is not vacuous: a written tree whose fc1
    differs from the converted one is caught."""
    dirs, trees = C.write_standins(str(tmp_path), 3, TOY_STANDINS[:1])
    tree = convert.convert_whisper(
        convert.load_state_dict_from_dir(dirs["asr"]), W.PRESETS["wd-asr"])
    trees["asr"]["encoder"]["blocks"][0]["mlp_in"]["w"][0, 0] += 1e-3
    with pytest.raises(AssertionError, match="mlp_in"):
        C.tree_bits_equal("asr", tree, trees["asr"])


def test_weights_phase_rehearsed(presets):
    """chip_smoke's [weights] phase at toy widths on the CPU: the chain,
    the parameter counts, the hash tokenizers, and the engine from the
    directories equal to the in-memory engine."""
    rng = np.random.default_rng(0)
    clips = [("short.wav", C.make_audio(25, rng))]
    counts = C.weights_phase(
        "cpu", clips, device="cpu", presets=TOY_STANDINS,
        run_kw={"embed_dim": 32, "short_context": True, "smoke_max_new": 6})
    assert set(counts) == set(C.KEYS) and not any(counts.values())
    assert "jax" not in sys.modules["chip_smoke"].__dict__
