"""tools/torch_synth_drift.py against tools/synth_drift.py on the CPU, on
the same weights: the JAX captioner trained at the "test" preset for
STEPS steps (its transcripts differ clip to clip), carried to the port by
weights.py, and the held-out clips of both tools' stream
(``make_clip`` on ``default_rng(seed + 1)``).

* Every float32 row (parity, short_context, mulaw8, int16, int12,
  int8_dec, the mel codecs, fused_enc_f32, and the port's fused_layer,
  v2 -- JAX's True branch, which JAX turns "v2" into -- paired, and the
  opt-in fused_layer_f32 and v2_f32) gives JAX's texts clip for clip;
  int8_enc is held to JAX's row under MAS_ENC_INT8 (its XLA twin of the
  int8 kernel's arithmetic). fused_layer_f32 and v2_f32 give the
  fused_layer and v2 rows' texts, and on the card decode in float32.
* bf16 and fused_enc (torch's and XLA's bf16 round differently on the
  CPU) and int8_fused / int8_kv (the port follows its kernels'
  arithmetic, under tests/test_torch_int8_attention.py's guardrail) agree
  with JAX's row on at least BOUND_AGREE of the clips.
* The roundtrip helpers are bit-equal to JAX's, the JSON line's keys are
  JAX's, checkpoints load across packages, and each drift tool raises
  without a card unless told the CPU.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.ops.quant import (
    quantize_whisper_decoder as jquantize)
from multimodal_audio_search_tpu.pipelines.whisper_pipeline import (
    WhisperTextPipeline as JPipe)
from multimodal_audio_search_tpu.training import synth as JS
from multimodal_audio_search_tpu.utils.checkpoint import (
    load_pytree as jload, save_pytree as jsave)
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.training import synth as S

torch.set_num_threads(1)
JD = chip_smoke.load_tool("synth_drift")
TD = chip_smoke.load_tool("torch_synth_drift")
STEPS = 80        # the fewest at batch 16 whose transcripts are not alike
CLIPS = 16
SHORT_S = 1.0     # the test geometry's short context: 1 s clips, 2 s mel
EXACT_ROWS = ("parity", "short_context", "mulaw8", "int16", "int12",
              "int8_dec", "int8_enc", "mel16", "mel12", "mel8",
              "fused_enc_f32", "fused_layer", "v2", "paired",
              "fused_layer_f32", "v2_f32")
BOUND_ROWS = ("bf16", "fused_enc", "int8_fused", "int8_kv")
BOUND_AGREE = 0.875  # of the clips (14 of 16), the port's row = JAX's row


def _jax_transcribe(jm, waves, **decode):
    """JS.transcribe (float32) with more DecodeConfig fields."""
    pipe = JPipe(params=jm.params, cfg=jm.cfg, tokenizer=jm.vocab,
                 decode=jcfg.DecodeConfig(max_new_tokens=jm.max_new,
                                          **decode),
                 mel_cfg=jcfg.MelConfig(padded_seconds=jm.mel_seconds),
                 prefix_ids=[jm.cfg.bos_token_id], dtype=jnp.float32,
                 name="synth")
    return pipe.transcribe_batch(S.pad_waves(waves, pipe.mel_cfg.n_samples))


def jax_row(name, jm, waves, monkeypatch):
    """JAX's texts for the port's row ``name`` (the JAX tool's code for
    its rows; JAX's pipeline with the same decode option for the port's
    extra rows)."""
    if name in ("int8_dec", "int8_fused", "int8_kv"):
        quant = dataclasses.replace(jm, params=jquantize(jm.params))
    if name == "parity":
        return JS.transcribe(jm, waves)
    if name == "short_context":
        return JS.transcribe(jm, waves, mel_seconds=SHORT_S)
    if name in ("mulaw8", "int16", "int12"):
        trip = {"mulaw8": JD.mulaw_roundtrip, "int16": JD.int16_roundtrip,
                "int12": JD.int12_roundtrip}[name]
        return JS.transcribe(jm, trip(waves))
    if name == "bf16":
        return JS.transcribe(jm, waves, dtype=jnp.bfloat16)
    if name == "int8_dec":
        return JS.transcribe(quant, waves)
    if name == "int8_enc":
        # read when the encoder is traced: clear the compiled programs
        monkeypatch.setenv("MAS_ENC_INT8", "1")
        jax.clear_caches()
        try:
            return JS.transcribe(jm, waves)
        finally:
            monkeypatch.delenv("MAS_ENC_INT8")
            jax.clear_caches()
    if name == "fused_enc":
        return JS.transcribe(jm, waves, fused_encoder=True,
                             dtype=jnp.bfloat16)
    if name == "fused_enc_f32":
        return JS.transcribe(jm, waves, fused_encoder=True)
    if name.startswith("mel"):
        return JD.transcribe_hostmel(jm, waves, int(name[3:]))
    if name in ("fused_layer", "v2", "fused_layer_f32", "v2_f32"):
        return _jax_transcribe(jm, waves, fused_layer=True)
    if name == "int8_fused":
        return _jax_transcribe(quant, waves, cross_attn="int8_fused")
    if name == "int8_kv":
        return _jax_transcribe(quant, waves, cross_attn="int8")
    if name == "paired":
        return JS.transcribe(jm, waves, fused_encoder="paired")
    raise ValueError(name)


@pytest.fixture(scope="module")
def drift():
    """(JAX model, port model, waves, truths, the port's modes and
    details over every row, on the CPU)."""
    jm = JS.train_synth_captioner(steps=STEPS, batch=16, seed=0)
    tm = S.SynthModel(params=weights.whisper_params(
        jax.tree.map(np.asarray, jm.params)), cfg=W.PRESETS["test"],
        vocab=S.SynthVocab(W.PRESETS["test"]), mel_seconds=jm.mel_seconds,
        losses=list(jm.losses), n_events=jm.n_events)
    waves, truths = TD.held_out(np.random.default_rng(1), CLIPS, 1.0,
                                jm.n_events)
    rows = TD.select_rows(list(TD.ROWS + TD.EXTRA_ROWS))
    modes, details = TD.measure(tm, waves, truths, rows, "cpu", SHORT_S)
    return jm, tm, waves, truths, modes, details


def test_trained_transcripts_differ(drift):
    *_, details = drift
    parity = details["parity"]["texts"]
    assert len(set(parity)) >= 4, parity
    words = set(S.SynthVocab.WORDS)
    assert all(set(t.split()) <= words for d in details.values()
               for t in d["texts"])


def test_held_out_clips_are_the_jax_tools(drift):
    """The JAX tool's stream: make_clip on default_rng(seed + 1)."""
    _, _, waves, truths, _, _ = drift
    rng = np.random.default_rng(1)
    want = [JS.make_clip(rng, 1.0, (1, 3)) for _ in range(CLIPS)]
    np.testing.assert_array_equal(waves, np.stack([w for w, _ in want]))
    assert list(truths) == [t for _, t in want]


@pytest.mark.parametrize("name", EXACT_ROWS)
def test_float32_row_matches_jax(drift, monkeypatch, name):
    jm, _, waves, _, _, details = drift
    assert details[name]["dtype"] == "torch.float32"
    assert details[name]["texts"] == jax_row(name, jm, waves, monkeypatch)


@pytest.mark.parametrize("row,twin", [("fused_layer_f32", "fused_layer"),
                                      ("v2_f32", "v2")])
def test_f32_fused_rows_give_their_twins_texts(drift, row, twin):
    """The opt-in float32 rows of the fused decoder blocks: selected only
    by name, and on the CPU (where the twins decode at float32 too) the
    fused_layer / v2 rows' routes and texts, clip for clip."""
    *_, details = drift
    assert row not in TD.select_rows() and row not in TD.select_rows(
        extra=True) and row in TD.select_rows([row])
    assert details[row]["dtype"] == details[twin]["dtype"] == \
        "torch.float32"
    assert details[row]["fused_layer"] == details[twin]["fused_layer"]
    assert details[row]["texts"] == details[twin]["texts"]


@pytest.mark.parametrize("name", BOUND_ROWS)
def test_bounded_row_near_jax(drift, monkeypatch, name):
    jm, _, waves, _, _, details = drift
    want = jax_row(name, jm, waves, monkeypatch)
    got = details[name]["texts"]
    agree = np.mean([a == b for a, b in zip(got, want)])
    assert agree >= BOUND_AGREE, (name, agree, list(zip(got, want)))


@pytest.mark.parametrize("name", ["mulaw_roundtrip", "int16_roundtrip",
                                  "int12_roundtrip"])
def test_roundtrip_bit_equal(name):
    """On clips, out-of-range samples, NaN and an odd length."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(3, 1601)) * 0.6).astype(np.float32)
    w[0, :4] = [np.nan, 1.5, -2.0, 0.0]
    np.testing.assert_array_equal(getattr(TD, name)(w),
                                  getattr(JD, name)(w))


def _run_main(main, argv, capsys, monkeypatch=None):
    """The JSON line a tool's main prints (argv through sys.argv where
    main takes none)."""
    if monkeypatch is not None:
        monkeypatch.setattr(sys, "argv", ["tool", *argv])
        main()
    else:
        main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


def test_json_line_and_checkpoints_across_packages(drift, tmp_path, capsys,
                                                   monkeypatch):
    """A JAX checkpoint measured by both tools: the same JSON keys, and on
    float32 rows the same numbers; a port checkpoint loads in JAX."""
    jm, *_ = drift
    ck = str(tmp_path / "jax.npz")
    jsave(jm.params, ck)
    argv = ["--load-model", ck, "--clips", "6", "--modes", "parity",
            "int16", "mel8"]
    want = _run_main(JD.main, argv, capsys, monkeypatch)
    got = _run_main(TD.main, ["--device", "cpu", *argv], capsys)
    assert _keys(got) == _keys(want)
    assert got["modes"] == want["modes"] and got["train"] == want["train"]
    assert got["geometry"] == want["geometry"]
    out = str(tmp_path / "port.npz")
    TD.main(["--device", "cpu", "--steps", "2", "--batch", "4",
             "--save-model", out, "--train-only"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "synth_drift_train_only"
    port = weights.whisper_params(jax.tree.map(np.asarray, jload(
        jm.params, out)))
    from multimodal_audio_search_tpu_torch.utils.checkpoint import (
        load_pytree)
    mine = load_pytree(W.init_params(torch.Generator().manual_seed(0),
                                     W.PRESETS["test"]), out)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(mine)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("tool,argv", [
    ("torch_synth_drift", []), ("torch_bigindex_drift", []),
    ("torch_compare_modes", ["--out", "unused.json"]),
    ("torch_eval_context", ["--out", "unused.json"])])
def test_tool_refuses_without_a_card(monkeypatch, tool, argv):
    """Each drift tool takes the card by default and raises without one,
    before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.load_tool(tool).main(argv)


# the lever rows' floor for the CPU's captioner (80 steps of the "test"
# preset; its int8 rows keep 7 of 8 clips), under the card's
# DRIFT_LEVER_AGREE for its 600-step whisper-tiny
CPU_LEVER_AGREE = 0.75


def test_chip_drift_phase_on_cpu(drift, monkeypatch, capsys):
    """chip_smoke.py's [drift] rehearsed on the CPU at 8 clips and 2000
    index rows: one line a row, the lever agreement line, the bigindex
    line, the floors met; a planted int16 row that differs from parity,
    and a planted lever row off its dtype's row, are caught."""
    _, tm, *_ = drift
    monkeypatch.setattr(chip_smoke, "DRIFT_CLIPS", 8)
    monkeypatch.setattr(chip_smoke, "DRIFT_BIG_N", 2000)
    monkeypatch.setattr(chip_smoke, "DRIFT_BIG_QUERIES", 10)
    monkeypatch.setattr(chip_smoke, "DRIFT_LEVER_AGREE", CPU_LEVER_AGREE)
    modes = chip_smoke.drift_phase("cpu", tm, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[drift] ")]
    rows = TD.select_rows(list(TD.ROWS + TD.EXTRA_ROWS))
    assert list(modes) == rows and len(lines) == len(rows) + 3
    agree = json.loads(lines[len(rows) + 1][8:])
    assert agree["lever_agree_with"] == "parity"
    assert set(agree["agree"]) == set(chip_smoke.DRIFT_LEVERS)
    assert json.loads(lines[-1][8:])["n"] == 2000
    measure = TD.measure
    monkeypatch.setattr(chip_smoke, "load_tool", lambda name: TD if
                        name == "torch_synth_drift" else None)

    def planted_int16(*a, **k):
        modes, details = measure(*a, **k)
        details["int16"]["texts"][0] += " tone"
        return modes, details

    def planted_lever(*a, **k):      # K7 gone wrong, still in the grammar
        modes, details = measure(*a, **k)
        details["int8_kv"]["texts"] = ["noise"] * len(
            details["int8_kv"]["texts"])
        return modes, details
    for planted, match in ((planted_int16, "tone"),
                           (planted_lever, "lever rows under")):
        monkeypatch.setattr(TD, "measure", planted)
        with pytest.raises(AssertionError, match=match):
            chip_smoke.drift_phase("cpu", tm, device="cpu")


@pytest.mark.parametrize("row,fused", [("fused_layer_f32", True),
                                       ("v2_f32", "v2")])
def test_card_decodes_f32_fused_rows_in_float32(row, fused, monkeypatch):
    """On the card the float32 fused-decoder rows decode in float32 with
    their fused_layer (the decoder blocks' float32 forms: the symbols by
    dtype in tests/test_torch_runtime_devices.py::
    test_k3_k4_form_by_dtype), where fused_layer and v2 take the card's
    bf16; neither is moved to the CPU."""
    from multimodal_audio_search_tpu_torch.training import synth
    seen = {}

    def transcribe(m, waves, **kw):
        seen.update(kw)
        return ["t"] * len(waves)
    monkeypatch.setattr(synth, "transcribe", transcribe)
    dev = torch.device("cuda")
    texts, route = TD.decode_row(row, None, np.zeros((2, 8)), dev, SHORT_S)
    assert texts == ["t", "t"] and seen["device"] == dev
    assert seen["dtype"] == torch.float32 and seen["fused_layer"] == fused
    assert route["dtype"] == str(torch.float32)
    TD.decode_row(row.replace("_f32", ""), None, np.zeros((2, 8)), dev,
                  SHORT_S)
    assert seen["dtype"] == torch.bfloat16 and seen["fused_layer"] == fused


@pytest.mark.parametrize("modes", [["fused_enc_f32"],
                                   ["parity", "fused_enc_f32", "bf16"]])
def test_card_refuses_fused_enc_f32(modes, monkeypatch):
    """Whether the card refuses the float32 fused-encoder row: it does
    not. The row is selected as on the CPU and decoded on the card in
    float32 with fused_encoder=True, which encode sends to K1's float32
    form (the kernel symbol by dtype: tests/test_torch_runtime_devices.py
    ::test_k1_form_by_dtype); it is not moved to the CPU."""
    from multimodal_audio_search_tpu_torch.training import synth
    rows = TD.select_rows(modes)
    assert "fused_enc_f32" in rows and rows[0] == "parity"
    seen = {}

    def transcribe(m, waves, **kw):
        seen.update(kw)
        return ["t"] * len(waves)
    monkeypatch.setattr(synth, "transcribe", transcribe)
    dev = torch.device("cuda")
    texts, route = TD.decode_row("fused_enc_f32", None, np.zeros((2, 8)),
                                 dev, SHORT_S)
    assert texts == ["t", "t"]
    assert seen["dtype"] == torch.float32 and seen["fused_encoder"] is True
    assert seen["device"] == dev
    assert route == {"dtype": str(torch.float32), "device": str(dev),
                     "fused_encoder": True}
