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

K3's float32 plan (``self_block_f32_plan``) fits whisper-tiny through
-large widths at every cache length up to L=448, raises a ValueError
naming the limit past what fits, and keeps to the kernel source's limits.
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
    """D = 384-1280 at L = 1, 68 and 448 and B = 1, 32 and 256: the
    cluster over the heads, 1-8 rows a tile covering B, 4-8 ring slots,
    and the block within an H100 block's shared memory; a cache too long
    for even 4 slots raises a ValueError naming the limit."""
    for l in (1, 68, 448):
        for b in (1, 32, 256):
            cs, rows, tiles, stages = DB.self_block_f32_plan(b, heads, l)
            assert cs == min(heads, DB.K3_MAX_CLUSTER)
            assert 1 <= rows <= DB.K3F_ROWS and tiles * rows >= b
            assert DB.K3F_MIN_STAGES <= stages <= DB.K3F_MAX_STAGES
            assert DB.k3_f32_smem(heads * 64, l, stages, rows) <= DB.K3_SMEM
    assert DB.self_block_f32_plan(32, heads, 68, clusters=15)[1] == 3
    with pytest.raises(ValueError, match="does not fit D=.*shared memory"):
        DB.self_block_f32_plan(8, heads, 8192, rows=8)


def test_k3_f32_plan_mirrors_the_kernel_source():
    """The plan's limits are the kernel's (csrc/decoder_block_f32.cu)."""
    src = (pathlib.Path(DB.__file__).resolve().parent.parent / "csrc"
           / "decoder_block_f32.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("F3_RT") == DB.K3F_ROWS
    assert const("F3_MAX_STAGES") == DB.K3F_MAX_STAGES
    assert const("F3_MIN_STAGES") == DB.K3F_MIN_STAGES
    assert const("F3_MAX_CS") == DB.K3_MAX_CLUSTER
    assert "232448 - 1024" in src and DB.K3_SMEM == 232448 - 1024


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
