"""chip_smoke.py's ``[embedders]`` and ``[clap]`` phases, rehearsed on
the CPU at test widths: the phases run whole (torch.cuda's timing and
memory calls stubbed, K1 and K2 counted where the card's wrappers would
count them), and their checks are held to planted faults: an embedder
whose old pipelines stay allocated, a card-side query embedding off the
CPU's, a search that does not rank by the store's rows."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.models import clap_htsat as CH
from tests.test_torch_service_engine import (
    SMALL_CLIP, SMALL_MPNET, small_embedder_presets)

torch.set_num_threads(1)
STEPS = (("all-mpnet-base-v2", SMALL_MPNET["hidden"]),
         ("clip-ViT-B-32-multilingual-v1", SMALL_CLIP["hidden"]),
         ("all-MiniLM-L6-v2", 384))
TINY_HTSAT = CH.HTSATConfig(patch_embed_dim=8, depths=(1, 1),
                            num_heads=(2, 2), hidden_size=16,
                            projection_dim=24)
TINY_ROBERTA = CH.RobertaConfig(vocab_size=300, hidden=32, layers=1,
                                heads=2, intermediate=64, projection_dim=24)


@pytest.fixture
def printed(monkeypatch):
    out = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, **kv: out.append((name, kv)))
    return out


@pytest.fixture
def no_card(monkeypatch):
    """torch.cuda's synchronisation and memory calls as no-ops, and K1 /
    K2 counted in runtime.COUNTS where their wrappers are called."""
    from multimodal_audio_search_tpu_torch.ops import (
        cross_attention, encoder_block)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    for key, mod, name in (
            ("K1", encoder_block, "fused_attention_o_residual"),
            ("K2", cross_attention, "fused_single_query_attention")):
        fn = getattr(mod, name)

        def counted(*a, _f=fn, _k=chip_smoke.KEYS[key], **k):
            runtime.COUNTS[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)


@pytest.fixture
def clips():
    rng = np.random.default_rng(0)
    return [("long.wav", chip_smoke.make_audio(320, rng)),
            ("short.wav", chip_smoke.make_audio(25, rng))]


@pytest.fixture
def test_engines(monkeypatch):
    """The embedders phase's engine at the test presets."""
    small_embedder_presets(monkeypatch)
    monkeypatch.setattr(chip_smoke, "EMBEDDER_STEPS", STEPS)
    spec = tcfg.ModelSpec(family="whisper", preset="test")

    def config(*_):
        # the "test" preset's 100 encoder positions: 2 s segments in a
        # 2 s mel context
        cfg = tcfg.EngineConfig(
            asr_model=spec, caption_model=spec, short_context=True,
            text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
            segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                       min_segment_seconds=1.0))
        dec = dict(max_new_tokens=4)
        return cfg.replace(
            asr_decode=dataclasses.replace(cfg.asr_decode, **dec),
            caption_decode=dataclasses.replace(cfg.caption_decode, **dec))
    monkeypatch.setattr(chip_smoke, "engine_config", config)


def test_embedders_phase_on_cpu(monkeypatch, printed, no_card, clips,
                                test_engines):
    # memory_allocated is stubbed: the freed-pipelines check cannot see
    monkeypatch.setattr(chip_smoke, "EMBED_FREE_SLACK", math.inf)
    out = chip_smoke.embedders_phase("cpu", clips, device="cpu")
    assert list(out) == [name for name, _ in STEPS]
    lines = [kv for name, kv in printed if name == "embedders"]
    assert [kv["embed_dim"] for kv in lines[:3]] == [d for _, d in STEPS]
    assert [kv["model"] for kv in lines[:3]] == ["mpnet", "minilm", "minilm"]
    assert set(lines[0]["ingest_audio_s_per_s"]) == {"long.wav", "short.wav"}
    for counts, kv in zip(out.values(), lines):
        assert counts["K1"] > 0 and counts["K2"] > 0
        assert kv["card_vs_cpu_max_abs_err"] == 0.0
    assert set(lines[3]["query_p50_ms"]) == {name for name, _ in STEPS}


def test_embedders_phase_sees_kept_pipelines(monkeypatch, printed, no_card,
                                             clips, test_engines):
    """An allocation that grows by 1 GiB at each reconfigure (old
    pipelines kept) fails the freed check."""
    grown = iter(range(0, 1 << 40, 1 << 30))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda *a, **k: next(grown))
    with pytest.raises(AssertionError, match="not freed"):
        chip_smoke.embedders_phase("cpu", clips, device="cpu")


def test_embedders_phase_sees_an_embedding_off_the_cpu(
        monkeypatch, printed, no_card, clips, test_engines):
    """A query embedding 1e-4 off the CPU's fails the card-vs-CPU check
    (the engine's embedder is the 'card' here; its CPU copy is the
    embedder made last before the comparison)."""
    from multimodal_audio_search_tpu_torch.pipelines import embed
    monkeypatch.setattr(chip_smoke, "EMBED_FREE_SLACK", math.inf)
    call = embed.TextEmbedder.__call__
    made = []

    def off(self, texts):
        out = call(self, texts)
        return out if self is made[-1] else out + 1e-4
    init = embed.TextEmbedder.__init__

    def track(self, *a, **k):
        init(self, *a, **k)
        made.append(self)
    monkeypatch.setattr(embed.TextEmbedder, "__call__", off)
    monkeypatch.setattr(embed.TextEmbedder, "__init__", track)
    with pytest.raises(AssertionError, match="card vs CPU"):
        chip_smoke.embedders_phase("cpu", clips, device="cpu")


def test_clap_phase_on_cpu(printed, no_card, clips):
    got = chip_smoke.clap_phase("cpu", clips, device="cpu",
                                htsat=TINY_HTSAT, roberta=TINY_ROBERTA)
    assert got["htsat_tower_ms"] > 0
    search, towers = [kv for name, kv in printed if name == "clap"]
    assert (search["rows"], search["rows_25s"], search["rows_20_5s"]) == \
        (32, 3, 2)
    assert search["card_vs_cpu_audio_max_abs_err"] == 0.0
    assert towers["fused_is_longer"] == [True, False]
    assert towers["batch"] == 32


def test_clap_topk_check_sees_a_misranked_search(monkeypatch, clips):
    """A search whose hits come in the store's order, not by score, fails
    the plain-scoring check."""
    from multimodal_audio_search_tpu_torch.pipelines.clap_ingest import (
        ClapSearch)
    cs = ClapSearch(device="cpu")
    cs.ingest_waveform(clips[0][1][: 16000 * 60], 16000, "x")
    assert chip_smoke.clap_topk_check(cs, "drums")["top"]
    search = cs.search

    def unranked(query, k=10):
        return sorted(search(query, k), key=lambda h: h["index"])
    monkeypatch.setattr(cs, "search", unranked)
    with pytest.raises(AssertionError, match="rank"):
        chip_smoke.clap_topk_check(cs, "drums")


def test_smoke_phases_tool_runs_the_named_phases(monkeypatch):
    """tools/torch_smoke_phases.py runs the phases it is given, in
    chip_smoke's order, on chip_smoke's clips, and refuses an unknown
    name."""
    tool = chip_smoke.load_tool("torch_smoke_phases")
    ran = []
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    monkeypatch.setattr(runtime, "select_device", lambda d: d)
    monkeypatch.setattr(runtime, "kernels", lambda: None)
    monkeypatch.setattr(chip_smoke, "embedders_phase",
                        lambda card, clips: ran.append(
                            ("embedders", [n for n, _ in clips])))
    monkeypatch.setattr(chip_smoke, "clap_phase",
                        lambda card, clips: ran.append(
                            ("clap", [len(x) for _, x in clips])))
    assert tool.main(["clap", "embedders"]) == 0
    assert ran == [("embedders", ["long.wav", "short.wav"]),
                   ("clap", [320 * 16000, 25 * 16000])]
    with pytest.raises(SystemExit, match="unknown phases"):
        tool.main(["kernels"])
