"""The float32 fused decode against the JAX package's, on the CPU.

On the card a float32 decode under ``fused_layer`` True or "v2" runs the
float32 forms of K3 / K4 and K3-q / K4-o (csrc/decoder_block_f32.cu); on
the CPU the same wrappers run their plain versions, which the card tests
hold those kernels to (tests/test_torch_cuda.py -k float32). At a
geometry with the kernels' head dim 64 (2 decoder layers, 2 heads,
D=128) and B=8 (the fused gate), in float32:

* greedy ``generate`` gives the JAX package's tokens and lengths under
  the same ``fused_layer`` (JAX runs its Pallas B3 / B4 in interpret
  mode; its "v2" takes its True branch over the einsum cross K/V it
  picks on the CPU, as in tests/test_torch_slice.py);
* the decode steps on those tokens give JAX's logits within 5e-5, each
  package over the merged cross K/V, so JAX's "v2" runs B5a and B5b.

K3's and K4's float32 plans (``self_block_f32_plan``, ``mlp_f32_plan``)
fit whisper-tiny through -large widths at every cache length up to
L=448 and B up to 256, raise a ValueError naming the limit past what
fits, and keep to the kernel source's figures (the partitions and the
summation order: tests/test_torch_f32_decoder_grid.py).
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.models import generate as JG
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import generate as G
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.ops import decoder_block as DB

torch.set_num_threads(1)
CPU = torch.device("cpu")
B, T_ENC, NEW = 8, 100, 6
LOGITS_ATOL = 5e-5


@pytest.mark.parametrize("fused", [True, "v2"])
def test_f32_fused_decode_matches_jax(fused):
    jc = JW.config_for("test", d_model=128, heads=2)     # head dim 64
    tc = W.config_for("test", d_model=128, heads=2)
    jp = JW.init_params(jax.random.PRNGKey(25), jc)
    tp = W.prepare_params(weights.whisper_params(
        jax.tree.map(np.asarray, jp)), torch.float32, CPU)
    enc = np.random.default_rng(25).normal(
        size=(B, T_ENC, jc.d_model)).astype(np.float32)
    prefix = np.tile(np.asarray(JW.forced_prefix(jc), np.int32), (B, 1))
    kw = dict(max_new_tokens=NEW, fused_layer=fused)
    ref = JG.generate(jp, jnp.asarray(enc), jnp.asarray(prefix), cfg=jc,
                      decode=jcfg.DecodeConfig(**kw),
                      prefix_len=prefix.shape[1], max_new_tokens=NEW)
    out = G.generate(tp, torch.from_numpy(enc), torch.from_numpy(prefix),
                     cfg=tc, decode=tcfg.DecodeConfig(**kw),
                     max_new_tokens=NEW)
    tokens = np.array(ref.tokens)
    np.testing.assert_array_equal(out.tokens.numpy(), tokens)
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    # the decode steps on those tokens, both over the merged cross K/V
    jckv = JW.cross_kv_merged(jp, jnp.asarray(enc), jc)
    tckv = W.cross_kv_merged(tp, torch.from_numpy(enc), tc)
    steps = tokens.shape[1] - 1
    jcache = JW.init_cache(jc, B, steps, jnp.float32)
    tcache = W.init_cache(tc, B, steps, torch.float32, CPU)
    err = 0.0
    for pos in range(steps):
        jl, jcache = JW.decode_step(jp, jnp.asarray(tokens[:, pos]),
                                    jnp.int32(pos), jcache, jckv, jc,
                                    fused_layer=fused)
        tl = W.decode_step(tp, torch.from_numpy(tokens[:, pos]).long(), pos,
                           tcache, tckv, tc, fused_layer=fused)
        assert tl.dtype == torch.float32
        err = max(err, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    assert err <= LOGITS_ATOL, err


@pytest.mark.parametrize("heads", [6, 8, 12, 16, 20])
def test_k3_f32_plan_fits_every_whisper_width(heads):
    """D = 384-1280 at L = 1, 68 and 448 and B = 1, 32 and 256 on an
    H100's 66 clusters of two: all 132 blocks, one pass over every row,
    each phase's columns (the q/k/v projection's 3 H * 64, the o- and
    cross q-projections' D) within a block's slot and its threads'
    micro-tiles, the block within an H100 block's shared memory; a cache
    past F32_RED rows, more than 256 rows, or too few clusters for the
    widest projection raise a ValueError naming the limit."""
    for l in (1, 68, 448):
        for b in (1, 32, 256):
            plan = DB.self_block_f32_plan(b, heads, l)
            assert (plan.blocks, plan.cluster, plan.clusters) == (132, 2, 66)
            assert plan.passes == 1 and plan.rows >= b
            assert plan.stages == DB.F32_STAGES >= 3
            for groups in (3 * heads * 8, heads * 8):
                nc = 8 * -(-groups // plan.clusters)
                assert plan.rows * nc <= DB.F32_MAXMT * DB.F32_NT * 32
                assert DB.f32_tile_rows(nc, plan.rows) >= 8
    assert DB.F32_SMEM <= 232448
    with pytest.raises(ValueError, match="caches of 1..16384 rows"):
        DB.self_block_f32_plan(8, heads, 16385)
    with pytest.raises(ValueError, match="1..256 rows"):
        DB.self_block_f32_plan(257, heads, 68)
    with pytest.raises(ValueError, match="does not fit the q/k/v"):
        DB.self_block_f32_plan(256, heads, 68, clusters=heads // 2)


def _const(name):
    src = (pathlib.Path(DB.__file__).resolve().parent.parent / "csrc"
           / "decoder_block_f32.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1]), src


def test_k3_f32_plan_mirrors_the_kernel_source():
    """The plans' figures are the kernels' (csrc/decoder_block_f32.cu):
    threads, slot, ring, window, partials, rows, micro-tiles, K3's cluster
    and the shared memory they add up to."""
    for name, value in (("NT", DB.F32_NT), ("SLOT", DB.F32_SLOT),
                        ("STAGES", DB.F32_STAGES), ("HBUF", DB.F32_HBUF),
                        ("RED", DB.F32_RED), ("MAXB", DB.F32_MAXB),
                        ("MAXMT", DB.F32_MAXMT), ("F3_CS", DB.K3F_CS)):
        assert _const(name)[0] == value, name
    src = _const("NT")[1]
    assert "128 + 4 * ((size_t)STAGES * SLOT + HBUF + RED + 5 * MAXB)" in src
    assert DB.F32_SMEM == 128 + 4 * (DB.F32_STAGES * DB.F32_SLOT
                                     + DB.F32_HBUF + DB.F32_RED
                                     + 5 * DB.F32_MAXB)
    # tile_rows: the slot, and a window row of the rows
    for nc, rb in ((24, 32), (8, 32), (64, 256), (160, 32), (256, 64)):
        t = min(DB.F32_SLOT // nc, DB.F32_HBUF // rb - 4)
        assert DB.f32_tile_rows(nc, rb) == (t // 32 * 32 if t >= 32
                                            else t // 8 * 8)


@pytest.mark.parametrize("d,f", [(384, 1536), (512, 2048), (768, 3072),
                                 (1024, 4096), (1280, 5120)])
def test_k4_f32_plan_fits_every_whisper_width(d, f):
    """K4's float32 plan at every Whisper width on an H100's 15 clusters of
    eight (120 blocks): one pass at B <= 64, the passes covering B up to
    256, every cluster's fc1 share and the ranks' fc2 columns within a
    slot and the micro-tiles; the cluster partials 0.98 MB at whisper-base
    and B=32 (from the old design's 8.4 MB of slice partials); K4-o's row
    projection on clusters of two, one 8-column group at least a cluster;
    a width past 2048 or more than 256 rows raise."""
    for b in (1, 32, 64, 200, 256):
        plan = DB.mlp_f32_plan(b, d, f)
        assert (plan.blocks, plan.cluster, plan.clusters) == (120, 8, 15)
        assert plan.rows * plan.passes >= b and plan.rows % 4 == 0
        assert plan.passes == 1 or b > 64
        ngc = -(-(f // 8) // plan.clusters)
        for groups, parts in ((ngc, 8), (d // 8, 8)):
            nc = 8 * -(-groups // parts)
            assert plan.rows * nc <= DB.F32_MAXMT * DB.F32_NT * 32
            assert DB.f32_tile_rows(nc, plan.rows) >= 8
        proj = DB.rowproj_f32_plan(b, d)
        assert proj.cluster == 2 and proj.clusters == min(66, d // 8)
    if d == 512:
        assert 15 * 32 * 512 * 4 <= 1 << 20   # the partials at B=32
    with pytest.raises(ValueError, match="D % 64 == 0"):
        DB.mlp_f32_plan(32, 4096, 4 * 4096)
    with pytest.raises(ValueError, match="1..256 rows"):
        DB.mlp_f32_plan(257, d, f)


def test_k4_f32_plan_mirrors_the_kernel_source():
    """K4's cluster, its widest row and the bf16 forms' limit shared with
    it (ops/decoder_block.py::MAX_D) are the kernel's."""
    assert _const("F4_CS")[0] == DB.K4F_CS == 8
    assert _const("F4_MAX_D")[0] == DB.MAX_D == 2048
    assert _const("IB")[0] == 8


def _cpu_engine(fused):
    """A toy-width float32 engine on the CPU (head dim 64), its decode
    configs' fused_layer ``fused``."""
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        DualPipelineIngest)
    from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
        WhisperTextPipeline)
    wcfg = W.config_for("test", d_model=128, heads=2)
    mel = tcfg.MelConfig(padded_seconds=2.0)
    dec = tcfg.DecodeConfig(max_new_tokens=5, fused_layer=fused)
    asr = WhisperTextPipeline(cfg=wcfg, decode=dec, mel_cfg=mel,
                              device="cpu")
    cap = WhisperTextPipeline(cfg=wcfg, decode=dec, mel_cfg=mel, seed=1,
                              prefix_ids=[wcfg.bos_token_id], device="cpu")
    emb = TextEmbedder(cfg=PRESETS["test"], device="cpu")
    cfg = tcfg.EngineConfig(ingest_batch=4, embed_dim=64)
    return AudioSearchEngine(cfg=cfg, ingest_pipeline=DualPipelineIngest(
        asr, cap, emb, cfg))


def test_chip_f32_engine_checks_on_cpu():
    """chip_smoke.py's [f32] checks of the fused float32 engine rehearsed
    on a CPU engine: the texts of a fused_layer=True engine against an
    unfused one's pass f32_margin_check (no row differs here), a planted
    differing text whose tokens do not differ is rejected, and the "v2"
    decode steps match the unfused steps within F32_STEP_LOGITS_REL."""
    import chip_smoke
    wave = (np.random.default_rng(0).normal(size=16000 * 25) * 0.3) \
        .astype(np.float32)
    clip = ("x.wav", wave)
    texts = []
    for fused in (True, False):
        eng = _cpu_engine(fused)
        eng.ingest_waveform(wave, 16000, clip[0])
        texts.append({(m["source"], m["start_time"]):
                      (m["asr_text"], m["audio_description"])
                      for m in eng.store.meta})
        if fused:
            fused_eng = eng
    out = chip_smoke.f32_margin_check("cpu", fused_eng, clip, *texts,
                                      device="cpu")
    assert {k: v["rows_differing"] for k, v in out.items()} == \
        {"asr": 0, "caption": 0}
    planted = dict(texts[1])
    key = next(iter(planted))
    planted[key] = ("planted", planted[key][1])
    with pytest.raises(AssertionError, match="texts differ"):
        chip_smoke.f32_margin_check("cpu", fused_eng, clip, texts[0],
                                    planted, device="cpu")
    v2 = chip_smoke.f32_v2_step_check("cpu", fused_eng, clip, device="cpu")
    assert v2["logits_rel_err"] <= chip_smoke.F32_STEP_LOGITS_REL
    assert v2["steps"] == len(fused_eng.ingest_pipeline.asr.prefix_ids)
