"""K1-K14 on the card, against their plain PyTorch versions.

Marked ``requires_cuda``: on a machine without a CUDA card every test
here skips (the card is looked up inside a fixture, never at import).
On the card they build the kernels with nvcc and run them at small
shapes, including the ragged edges the main path's shapes do not reach.
Run them there with ``python -m pytest tests/test_torch_cuda.py -q``.
Inputs and checks are chip_smoke.py's: K1 on a residual input (bf16
output, atol 1e-2 + rtol 1.6e-2) and on inputs with x = 0 and bo = 0 that
isolate the attention term (within 1e-2 of its max and 7e-3 of its
norm); K2 (f32 output, f32 math on the same bf16 inputs) 1e-3, across
its split edges with the arrival counters left zero; K3 and K4
(both variants) on their block's term out - x (chip_smoke.check_delta)
and k1/v1/q_cross elementwise, each with a planted fault it rejects; K5
(int8 weights) elementwise (chip_smoke.check_k5) in both kernels of its
plan and at forced split counts, at ragged M, N and K, float32 and bf16
outputs, with and without a bias, and with one K split dropped; K6 and
K7 (int8 K/V) relative to the output's scale (chip_smoke.check_rel), K6
at forced head layouts and cluster sizes with empty ranks and a dropped
rank; the
encoder variants K8-K11 as chip_smoke holds them (K8 relative to its
output's scale, K9-K11 by the K1 check), at ragged T and K8's tile
edges, K9, K1 and K10 at D = 384-1280, K1, K10 and K11's three forms on
every cluster size they take, with planted faults and a cluster the card
refuses, the row division K9 and K11 share held to the true one, and
K9's launches on the same inputs bit-equal to each other;
K1's, K2's, K8's, K3's, K3-q's, K4's, K4-o's, K5's, K6's and K7's
float32 forms within chip_smoke's float32 tolerances of their plain
versions (K6's and K7's within the int8 forms' relative bounds), at the
float32 engine's shapes and ragged ones, K5's in each regime and at its
split edges, with their launches repeated bit for bit and a dropped
split, K tile or rank rejected (``-k float32``);
K12 (search scores) by chip_smoke.check_k12 at odd N and other widths and
exactly on the rule rows, with the >= fault; K13 (streaming read) on every
column, with the 128-column fault; K14 (cross + MLP block) by check_delta
and, on the attention input, check_rel and check_bits, on every cluster
size of its attention, with the plans it refuses; calibrate() and
search_batch on the card.
"""
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (kernels have no CPU mode)")
    from multimodal_audio_search_tpu_torch import runtime
    return runtime.select_device("cuda")


def _rn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(
        "cuda", torch.bfloat16)


@pytest.mark.parametrize("b,heads,t", [(1, 2, 1), (2, 4, 97), (3, 8, 200),
                                       (2, 6, 64)])
def test_k1_matches_plain(cuda, b, heads, t):
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import encoder_block as K1
    gen = torch.Generator().manual_seed(t)
    for inputs, q_scale, residual in chip_smoke.K1_CASES:
        args = chip_smoke.k1_inputs(gen, b, t, heads, q_scale=q_scale,
                                    residual=residual)
        runtime.reset_counts()
        got = K1.fused_attention_o_residual(*args)
        torch.cuda.synchronize()
        assert runtime.COUNTS["encoder_attn_o_residual"] == 1
        ref = K1.attention_o_residual_plain(*args)
        assert got.dtype == torch.bfloat16 and got.shape == args[3].shape
        chip_smoke.check_k1(inputs, got, ref, residual)


def test_k1_check_sees_unmasked_pad_keys(cuda):
    """A planted fault: run K1 at T=1536 on keys whose last 36 rows are
    zero, which is what a kernel that left the zero-filled pad of the last
    64-key tile unmasked computes at T=1500. chip_smoke's check passes the
    kernel at T=1500 and rejects the faulty rows."""
    from multimodal_audio_search_tpu_torch.ops import encoder_block as K1
    gen = torch.Generator().manual_seed(0)
    q, k, v, x, wo, bo = chip_smoke.k1_inputs(gen, 2, 1536, 8,
                                              residual=False)
    k[:, :, 1500:] = 0
    v[:, :, 1500:] = 0
    cut = [a[:, :, :1500] for a in (q, k, v)] + [
        x[:, :1500].contiguous(), wo, bo]
    ref = K1.attention_o_residual_plain(*cut)
    good = K1.fused_attention_o_residual(*cut)
    faulty = K1.fused_attention_o_residual(q, k, v, x, wo, bo)[:, :1500]
    chip_smoke.check_k1("K1 T=1500", good, ref, residual=False)
    with pytest.raises(AssertionError, match="attention term"):
        chip_smoke.check_k1("K1 pad keys unmasked", faulty, ref,
                            residual=False)


@pytest.mark.parametrize("t,pos", [(1500, None), (68, 0), (68, 31),
                                   (68, 67), (5, None)])
def test_k2_matches_plain(cuda, t, pos):
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    gen = torch.Generator().manual_seed(t)
    b, heads = 3, 6
    hd = heads * 64
    q, k, v = _rn(gen, b, hd), _rn(gen, b, t, hd), _rn(gen, b, t, hd)
    runtime.reset_counts()
    got = K2.fused_single_query_attention(q, k, v, heads=heads, pos=pos)
    torch.cuda.synchronize()
    assert runtime.COUNTS["single_query_attention"] == 1
    ref = K2.single_query_attention_plain(q, k, v, heads=heads, pos=pos)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("t,pos", [(100, None), (1500, None), (32, 0),
                                   (32, 31), (5, None)])
def test_k2_float32_matches_plain(cuda, t, pos):
    """K2's float32 form (a float32 decode on the card) over cross keys
    and a self cache, within chip_smoke's float32 tolerance."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    gen = torch.Generator().manual_seed(t)
    q, k, v = (a.float() for a in chip_smoke.k2_inputs(gen, 3, t, 6))
    runtime.reset_counts()
    got = K2.fused_single_query_attention(q, k, v, heads=6, pos=pos)
    torch.cuda.synchronize()
    assert runtime.COUNTS["single_query_attention"] == 1
    chip_smoke.check_close(f"K2 float32 T={t} pos={pos}", got,
                           K2.single_query_attention_plain(
                               q, k, v, heads=6, pos=pos),
                           chip_smoke.F32_ATT_ATOL, chip_smoke.F32_ATT_RTOL)


# (T, n_valid, forced splits or None for split_plan): the plan's edge at
# 128 keys, empty splits, one split over 1500 keys, 12 splits, chunk edges
K2_SPLIT_CASES = [(300, 127, None), (300, 128, None), (300, 129, None),
                  (300, 9, 8), (1500, 1500, 1), (1500, 1500, None),
                  (300, 100, 3), (300, 101, 3), (1500, 376, 3), (68, 1, None)]


@pytest.mark.parametrize("t,n_valid,splits", K2_SPLIT_CASES)
def test_k2_split_edges(cuda, t, n_valid, splits):
    """K2 across its split edges, with splits holding no key and with one
    split: one launch a call, the arrival counters back at zero after it,
    and the output within chip_smoke's K2 tolerance of the plain one."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    gen = torch.Generator().manual_seed(t + n_valid)
    b, heads = 3, 6
    q, k, v = chip_smoke.k2_inputs(gen, b, t, heads)
    pos = None if n_valid == t else n_valid - 1
    for _ in range(2):  # a second call finds the counters at zero
        runtime.reset_counts()
        got = K2._launch(q, k, v, heads, n_valid, splits)
        torch.cuda.synchronize()
        assert runtime.COUNTS["single_query_attention"] == 1
        assert sum(runtime.COUNTS.values()) == 1
        assert int(K2._SCRATCH[k.device][3].abs().sum()) == 0
        chip_smoke.check_close(f"K2 n_valid={n_valid} splits={splits}", got,
                               K2.single_query_attention_plain(
                                   q, k, v, heads=heads, pos=pos),
                               chip_smoke.K2_ATOL, chip_smoke.K2_RTOL)


def test_wrappers_raise_instead_of_falling_back(cuda):
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    from multimodal_audio_search_tpu_torch.ops import encoder_block as K1
    q = torch.zeros(2, 128, device="cuda", dtype=torch.float16)  # not taken
    kv = torch.zeros(2, 4, 128, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        K2.fused_single_query_attention(q, kv, kv, heads=2)
    x = torch.zeros(1, 4, 96, device="cuda", dtype=torch.bfloat16)
    q4 = torch.zeros(1, 3, 4, 32, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(96, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):                   # head dim 32
        K1.fused_attention_o_residual(q4, q4, q4, x, w, w[0])


def test_tiny_engine_on_card_matches_cpu(cuda):
    """A toy-width engine (head dim 64, as the kernels take) in bf16 on
    the card and in float32 on the CPU, from the same seed: both keep the
    same segments, and on the card the encoder ran through K1 (2 layers x
    1 batch x 2 models) and the decoder through K2."""
    import numpy as np
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, EngineConfig, MelConfig)
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        DualPipelineIngest)
    from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
        WhisperTextPipeline)
    wcfg = W.config_for("test", d_model=128, heads=2)   # head dim 64
    mel = MelConfig(padded_seconds=2.0)

    def engine(device):
        dec = DecodeConfig(max_new_tokens=5)
        asr = WhisperTextPipeline(cfg=wcfg, decode=dec, mel_cfg=mel,
                                  device=device)
        cap = WhisperTextPipeline(cfg=wcfg, decode=dec, mel_cfg=mel, seed=1,
                                  prefix_ids=[wcfg.bos_token_id],
                                  device=device)
        emb = TextEmbedder(cfg=PRESETS["test"], device=device)
        cfg = EngineConfig(ingest_batch=4, embed_dim=64)
        return AudioSearchEngine(cfg=cfg, ingest_pipeline=DualPipelineIngest(
            asr, cap, emb, cfg))

    x = (np.random.default_rng(0).normal(size=16000 * 25) * 0.3) \
        .astype(np.float32)
    runtime.reset_counts()
    gpu = engine("cuda").ingest_waveform(x, 16000, "x")
    cpu = engine("cpu").ingest_waveform(x, 16000, "x")
    assert [s["start_time"] for s in gpu] == [s["start_time"] for s in cpu]
    assert runtime.COUNTS["encoder_attn_o_residual"] == 2 * 2
    assert runtime.COUNTS["single_query_attention"] > 0


# ------------------------------------------------ K3 / K4 (decoder blocks)
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("b,heads,l,pos", [(1, 2, 41, 0), (3, 6, 41, 1),
                                           (33, 8, 68, 40), (5, 2, 7, 6)])
def test_k3_matches_plain(cuda, tail, b, heads, l, pos):
    """K3 and K3-q at odd batch rows (ragged last row block) and pos,
    held by chip_smoke's check; the cache row pos is written, the rows
    t < pos are not touched, and the wrapper counts one launch."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(b * 100 + pos)
    x, selfw, tl, kc, vc = chip_smoke.k3_inputs(gen, b, l, heads * 64)
    extra = tl if tail else []
    fused = DB.fused_self_block_q if tail else DB.fused_self_block
    plain = DB.self_block_q_plain if tail else DB.self_block_plain
    ref = plain(x, *selfw, *extra, kc, vc, pos, heads=heads)
    kg, vg = kc.clone(), vc.clone()
    runtime.reset_counts()
    got = fused(x, *selfw, *extra, kg, vg, pos, heads=heads)
    torch.cuda.synchronize()
    key = "decoder_self_block_q" if tail else "decoder_self_block"
    assert runtime.COUNTS[key] == 1 and sum(runtime.COUNTS.values()) == 1
    chip_smoke.check_k3("K3", got, ref, x)
    assert torch.equal(kg[:, pos], got[1]) and torch.equal(vg[:, pos], got[2])
    assert torch.equal(kg[:, :pos], kc[:, :pos])
    assert torch.equal(vg[:, pos + 1:], vc[:, pos + 1:])


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("heads", [12, 20])
@pytest.mark.parametrize("b", [1, 33, 128])
@pytest.mark.parametrize("pos", [0, 67])
def test_k3_cluster_at_small_and_large_width(cuda, tail, heads, b, pos):
    """K3 and K3-q at whisper-small's and -large's widths (clusters of 12
    blocks of one head, and of 16 of one or two heads: K3-q's Wcq tiles
    then outnumber the ring, so the producer warp meets the tail's
    cluster barriers between them), one row, a ragged last tile and
    several tiles, pos 0 and L - 1, held by chip_smoke's check; one
    launch each."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(heads * 1000 + b + pos)
    l = 68
    x, selfw, tl, kc, vc = chip_smoke.k3_inputs(gen, b, l, heads * 64)
    extra = tl if tail else []
    fused = DB.fused_self_block_q if tail else DB.fused_self_block
    plain = DB.self_block_q_plain if tail else DB.self_block_plain
    ref = plain(x, *selfw, *extra, kc, vc, pos, heads=heads)
    kg, vg = kc.clone(), vc.clone()
    runtime.reset_counts()
    got = fused(x, *selfw, *extra, kg, vg, pos, heads=heads)
    torch.cuda.synchronize()
    assert sum(runtime.COUNTS.values()) == 1
    chip_smoke.check_k3(f"K3 H={heads} B={b} pos={pos}", got, ref, x)
    assert torch.equal(kg[:, pos], got[1]) and torch.equal(vg[:, pos], got[2])


@pytest.mark.parametrize("rows", [4, 8, 16])
def test_k3_row_tiles(cuda, rows):
    """K3 at base width with 4, 8 and 16 rows a tile (the plan's rows):
    the same check at B=33."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(rows)
    x, selfw, _, kc, vc = chip_smoke.k3_inputs(gen, 33, 68, 512)
    ref = DB.self_block_plain(x, *selfw, kc, vc, 40, heads=8)
    got = DB._launch_self(x, *selfw, kc.clone(), vc.clone(), 40, 8, 1e-5,
                          rows=rows)
    chip_smoke.check_k3(f"K3 rows={rows}", got, ref, x)


def test_k3_check_sees_a_dropped_rank(cuda):
    """A planted fault: K3 at base width (B=32, pos 67) run with rank 1's
    rows of Wo (head 1's: the rank's share of the o-projection) zeroed
    computes what a cluster sum that left rank 1's partial out computes;
    chip_smoke's check rejects it and passes the kernel on the true Wo."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(13)
    x, selfw, _, kc, vc = chip_smoke.k3_inputs(gen, 32, 68, 512)
    g, cs, _, _, _ = DB.self_block_plan(32, 8, 68)
    assert (g, cs) == (1, 8)
    ref = DB.self_block_plain(x, *selfw, kc, vc, 67, heads=8)
    chip_smoke.check_k3("K3", DB.fused_self_block(
        x, *selfw, kc.clone(), vc.clone(), 67, heads=8), ref, x)
    dropped = list(selfw)
    dropped[7] = selfw[7].clone()
    dropped[7][64:128] = 0
    with pytest.raises(AssertionError, match="off its plain version"):
        chip_smoke.check_k3("K3 rank 1 dropped", DB.fused_self_block(
            x, *dropped, kc.clone(), vc.clone(), 67, heads=8), ref, x)


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("b,d,f", [(1, 128, 256), (5, 384, 1536),
                                   (33, 512, 2048), (32, 512, 2048),
                                   (32, 384, 1536), (32, 768, 3072),
                                   (32, 1280, 5120), (7, 1024, 4096),
                                   (128, 512, 2048), (200, 384, 1536)])
def test_k4_matches_plain(cuda, head, b, d, f):
    """K4 and K4-o at ragged batches, every Whisper width (D in 512-column
    chunks past 512; at 1280, 160 slices on a grid capped by the card)
    and batches of several 32-row blocks (the ingest batch up to 200)."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(b + d)
    x, mlp, hd = chip_smoke.k4_inputs(gen, b, d, f)
    args = (x, *hd, *mlp) if head else (x, *mlp)
    fused = DB.fused_mlp_block_o if head else DB.fused_mlp_block
    plain = DB.mlp_block_o_plain if head else DB.mlp_block_plain
    for _ in range(2):  # a second call finds the barrier counters at zero
        runtime.reset_counts()
        got = fused(*args)
        torch.cuda.synchronize()
        assert sum(runtime.COUNTS.values()) == 1
        assert int(DB._COUNTERS[x.device][1].abs().sum()) == 0
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        chip_smoke.check_delta("K4", got, plain(*args), x)


def test_k3_check_sees_fresh_row_counted_twice(cuda):
    """A planted fault: K3 at pos + 1 over caches whose row pos already
    holds this step's k1/v1 computes what a kernel that read the row it
    wrote (t <= pos) AND added the closed-form fresh row computes at pos.
    chip_smoke's check passes K3 at pos and rejects that."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(3)
    x, selfw, _, kc, vc = chip_smoke.k3_inputs(gen, 8, 68, 512)
    pos = 3
    ref = DB.self_block_plain(x, *selfw, kc, vc, pos, heads=8)
    good = DB.fused_self_block(x, *selfw, kc, vc, pos, heads=8)
    faulty = DB.fused_self_block(x, *selfw, kc, vc, pos + 1, heads=8)
    chip_smoke.check_k3("K3", good, ref, x)
    with pytest.raises(AssertionError, match="off its plain version"):
        chip_smoke.check_k3("K3 fresh row twice", faulty, ref, x)


def test_k4_check_sees_missing_fc1_bias(cuda):
    """A planted fault: K4 run with fc1's bias zeroed, held to the plain
    version with the bias, is rejected; with the bias it passes."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(4)
    x, mlp, _ = chip_smoke.k4_inputs(gen, 32, 512, 2048)
    ref = DB.mlp_block_plain(x, *mlp)
    chip_smoke.check_delta("K4", DB.fused_mlp_block(x, *mlp), ref, x)
    no_b1 = list(mlp)
    no_b1[3] = torch.zeros_like(mlp[3])
    with pytest.raises(AssertionError, match="off its plain version"):
        chip_smoke.check_delta("K4 b1 missing", DB.fused_mlp_block(x, *no_b1),
                               ref, x)


def test_decoder_wrappers_raise_instead_of_falling_back(cuda):
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(5)
    x, selfw, tail, kc, vc = chip_smoke.k3_inputs(gen, 8, 16, 128)
    with pytest.raises(TypeError):                    # float32 x, bf16 w
        DB.fused_self_block(x.float(), *selfw, kc, vc, 2, heads=2)
    with pytest.raises(ValueError):                   # head dim 32
        DB.fused_self_block(x, *selfw, kc, vc, 2, heads=4)
    cpu_w = list(selfw)
    cpu_w[2] = cpu_w[2].cpu()
    with pytest.raises(ValueError):                   # a weight on the CPU
        DB.fused_self_block(x, *cpu_w, kc, vc, 2, heads=2)
    with pytest.raises(ValueError):                   # pos outside the cache
        DB.fused_self_block_q(x, *selfw, *tail, kc, vc, 16, heads=2)
    xm, mlp, head = chip_smoke.k4_inputs(gen, 8, 128, 256)
    with pytest.raises(ValueError):                   # F % 128 != 0
        DB.fused_mlp_block(xm, mlp[0], mlp[1], mlp[2][:, :200],
                           mlp[3][:200], mlp[4][:200], mlp[5])
    with pytest.raises(TypeError):                    # bf16 attn
        DB.fused_mlp_block_o(xm, head[0].bfloat16(), *head[1:], *mlp)


@pytest.mark.parametrize("fused", [True, "v2"])
def test_tiny_fused_engine_on_card(cuda, fused):
    """The toy-width engine with fused_layer on both models: on the card
    every decode layer step went through K3/K4 (or K3-q/K4-o) and K2
    once, and the segments are the CPU engine's."""
    import numpy as np
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, EngineConfig, MelConfig)
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        DualPipelineIngest)
    from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
        WhisperTextPipeline)
    wcfg = W.config_for("test", d_model=128, heads=2)   # head dim 64
    mel = MelConfig(padded_seconds=2.0)

    def engine(device):
        dec = DecodeConfig(max_new_tokens=5, fused_layer=fused)
        asr = WhisperTextPipeline(cfg=wcfg, decode=dec, mel_cfg=mel,
                                  device=device)
        cap = WhisperTextPipeline(cfg=wcfg, decode=dec, mel_cfg=mel, seed=1,
                                  prefix_ids=[wcfg.bos_token_id],
                                  device=device)
        emb = TextEmbedder(cfg=PRESETS["test"], device=device)
        cfg = EngineConfig(ingest_batch=4, embed_dim=64,
                           transfer_dtype="auto")
        return AudioSearchEngine(cfg=cfg, ingest_pipeline=DualPipelineIngest(
            asr, cap, emb, cfg))

    x = (np.random.default_rng(0).normal(size=16000 * 25) * 0.3) \
        .astype(np.float32)
    runtime.reset_counts()
    eng = engine("cuda")
    gpu = eng.ingest_waveform(x, 16000, "x")
    steps = eng.ingest_pipeline.asr.total_steps + \
        eng.ingest_pipeline.caption.total_steps
    cpu = engine("cpu").ingest_waveform(x, 16000, "x")
    assert [s["start_time"] for s in gpu] == [s["start_time"] for s in cpu]
    pair = ("decoder_self_block_q", "decoder_mlp_block_o") if fused == "v2" \
        else ("decoder_self_block", "decoder_mlp_block")
    for k in pair + ("single_query_attention",):
        assert runtime.COUNTS[k] == steps * wcfg.dec_layers > 0, k
    assert eng.ingest_pipeline.last_transfer_resolved in ("int16", "int16d")


# ---------------------------------------- K5 / K6 / K7 (int8 memory mode)
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("m,k,n,dt,bias", [
    (1, 64, 51865, "f32", False), (33, 136, 130, "bf16", True),
    (130, 512, 515, "f32", True), (8, 2048, 512, "bf16", True),
    (130, 520, 384, "bf16", True), (8, 512, 51865, "f32", False),
    (9, 256, 336, "bf16", True)])
def test_k5_matches_plain(cuda, splits, m, k, n, dt, bias):
    """K5 in every regime of its plan (the wide wgmma kernel at M > 64 and
    N % 16 == 0 with ``splits`` None; the skinny one otherwise, at the
    plan's split count or at a forced one; the table kernel, on a copy
    made for the call, for an N % 16 != 0 whatever ``splits``) at ragged
    M (rows past M are never stored), N (a partial column tile) and K (a
    partial K step); one launch a call, the arrival counters left zero."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    out_dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator().manual_seed(m + n)
    x, wq, scale, b = chip_smoke.k5_inputs(gen, m, k, n, bias=bias)
    for _ in range(2):  # a second call finds the counters at zero
        runtime.reset_counts()
        got = Q._launch(x, wq, scale, b, out_dtype, splits=splits)
        torch.cuda.synchronize()
        assert runtime.COUNTS["quant_matmul"] == 1
        assert sum(runtime.COUNTS.values()) == 1
        scratch = Q._SCRATCH.get(x.device)  # made by a skinny launch
        assert scratch is None or int(scratch[3].abs().sum()) == 0
        assert got.dtype == out_dtype and got.shape == (m, n)
        chip_smoke.check_k5("K5", got, chip_smoke.k5_plain(x, wq, scale, b,
                                                           out_dtype))


def test_k5_check_sees_a_dropped_column_tile(cuda):
    """A planted fault: K5's output with its last, partial column tile
    zeroed (what a grid of N // 32 tiles leaves) fails chip_smoke's
    check; the kernel's own output passes."""
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    gen = torch.Generator().manual_seed(7)
    x, wq, scale, _ = chip_smoke.k5_inputs(gen, 32, 512, 51865, bias=False)
    ref = chip_smoke.k5_plain(x, wq, scale, None, torch.float32)
    got = Q.quant_matmul(x, wq, scale)
    chip_smoke.check_k5("K5", got, ref)
    got[:, 51865 // 32 * 32:] = 0
    with pytest.raises(AssertionError, match="outside atol"):
        chip_smoke.check_k5("K5 last tile dropped", got, ref)


@pytest.mark.parametrize("m,k,n", [(1, 64, 51865), (32, 512, 51865),
                                   (33, 384, 1027), (5, 48, 100),
                                   (32, 768, 51865), (32, 1280, 51865),
                                   (3, 1040, 333), (4, 136, 130)])
def test_k5_table_matches_plain(cuda, m, k, n):
    """K5's table kernel (the logits' transposed int8 copy, which takes
    the codes' place in the leaf) at the vocabulary's odd N, a ragged
    last column tile and row block, a partial K step, every Whisper width
    (K in pieces of 512 past 512, a last piece of 16 at 1040) and a row
    padded to 16 codes (136), against the plain version on the codes."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    gen = torch.Generator().manual_seed(m * k)
    x, wq, scale, _ = chip_smoke.k5_inputs(gen, m, k, n, bias=False)
    p = Q.logits_table({"wq": wq, "scale": scale})
    assert "wq" not in p
    runtime.reset_counts()
    got = Q.quant_dense_apply(p, x, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert runtime.COUNTS["quant_matmul"] == 1
    chip_smoke.check_k5("K5 table", got, chip_smoke.k5_plain(
        x, wq, scale, None, torch.float32))


def test_k5_unsplit_launches_leave_the_scratch_as_it_was(cuda):
    """The split scratch is sized for split launches only: the wide
    kernel over 16,000 rows and an unsplit skinny launch leave it at its
    size (sized for the wide kernel's tiles, it grew by 98 MB at the
    engine's 48,000 rows, for nothing)."""
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    gen = torch.Generator().manual_seed(12)
    x, wq, scale, b = chip_smoke.k5_inputs(gen, 32, 512, 512)
    Q._launch(x, wq, scale, b, torch.bfloat16)  # splits: the scratch exists
    size = Q._SCRATCH[x.device][2].numel()
    xw, wq, scale, b = chip_smoke.k5_inputs(gen, 16000, 512, 512)
    assert Q.split_plan(16000, 512, 512)[0] == "wide"
    Q._launch(xw, wq, scale, b, torch.bfloat16)
    Q._launch(x, wq, scale, b, torch.bfloat16, splits=1)
    torch.cuda.synchronize()
    assert Q._SCRATCH[x.device][2].numel() == size


def test_k5_check_sees_a_dropped_split(cuda):
    """A planted fault: K5 at the main path's [2048, 512] (M = 32, 8
    splits) on x with the K columns of split 7 zeroed computes what a
    kernel that left that split out of its reduction computes;
    chip_smoke's check rejects it and passes the kernel on x."""
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    gen = torch.Generator().manual_seed(11)
    x, wq, scale, b = chip_smoke.k5_inputs(gen, 32, 2048, 512)
    _, _, splits, steps = Q.split_plan(32, 2048, 512)
    assert splits == 8
    ref = chip_smoke.k5_plain(x, wq, scale, b, torch.bfloat16)
    chip_smoke.check_k5("K5", Q._launch(x, wq, scale, b, torch.bfloat16),
                        ref)
    k0 = 7 * steps * Q.SB_K
    xd = x.clone()
    xd[:, k0:k0 + steps * Q.SB_K] = 0
    with pytest.raises(AssertionError, match="outside atol"):
        chip_smoke.check_k5("K5 split 7 dropped", Q._launch(
            xd, wq, scale, b, torch.bfloat16), ref)


@pytest.mark.parametrize("b,t,heads,pos", [(1, 1, 2, None), (3, 97, 6, 50),
                                           (2, 1500, 8, None),
                                           (5, 200, 8, 0)])
def test_k6_matches_plain(cuda, b, t, heads, pos):
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    gen = torch.Generator().manual_seed(t + heads)
    args = chip_smoke.k6_inputs(gen, b, t, heads)
    runtime.reset_counts()
    got = CX.fused_single_query_attention_int8(*args, heads=heads, pos=pos)
    torch.cuda.synchronize()
    assert runtime.COUNTS["single_query_attention_int8"] == 1
    ref = CX.single_query_attention_int8_plain(*args, heads=heads, pos=pos)
    assert got.dtype == torch.float32 and got.shape == (b, heads * 64)
    chip_smoke.check_rel("K6", got, ref, chip_smoke.INT8_ATT_MAX,
                         chip_smoke.INT8_ATT_L2)


def test_k6_check_sees_an_ignored_mask(cuda):
    """A planted fault: K6 attending every key, held to the plain version
    masked at pos, fails chip_smoke's check."""
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    gen = torch.Generator().manual_seed(8)
    args = chip_smoke.k6_inputs(gen, 4, 1500, 8)
    ref = CX.single_query_attention_int8_plain(*args, heads=8, pos=999)
    chip_smoke.check_rel("K6", CX.fused_single_query_attention_int8(
        *args, heads=8, pos=999), ref, chip_smoke.INT8_ATT_MAX,
        chip_smoke.INT8_ATT_L2)
    with pytest.raises(AssertionError, match="off its plain version"):
        chip_smoke.check_rel("K6 mask ignored",
                             CX.fused_single_query_attention_int8(
                                 *args, heads=8), ref,
                             chip_smoke.INT8_ATT_MAX, chip_smoke.INT8_ATT_L2)


@pytest.mark.parametrize("b,t,heads", [(1, 1, 2), (3, 97, 6), (2, 1500, 8)])
def test_k7_matches_plain(cuda, b, t, heads):
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    gen = torch.Generator().manual_seed(t * heads)
    args = chip_smoke.k7_inputs(gen, b, t, heads)
    runtime.reset_counts()
    got = CA.int8_cached_attention(*args)
    torch.cuda.synchronize()
    assert runtime.COUNTS["int8_cached_attention"] == 1
    assert got.dtype == torch.float32 and got.shape == (b, heads, 64)
    chip_smoke.check_rel("K7", got, CA.int8_cached_attention_plain(*args),
                         chip_smoke.INT8_ATT_MAX, chip_smoke.INT8_ATT_L2)


@pytest.mark.parametrize("t,cluster", [(1, None), (1, 8), (7, 8),
                                       (1501, None), (12288, None),
                                       (300, 8)])
def test_k7_cluster_edges(cuda, t, cluster):
    """K7 at T = 1 and 7 with 8 blocks forced (ranks without a key), a
    ragged T (1501), T = 12288 (1536 keys a block) and T = 300 over 8
    blocks."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    gen = torch.Generator().manual_seed(t)
    args = chip_smoke.k7_inputs(gen, 3, t, 2)
    runtime.reset_counts()
    got = CA._launch(*args, cluster=cluster)
    torch.cuda.synchronize()
    assert runtime.COUNTS["int8_cached_attention"] == 1
    chip_smoke.check_rel(f"K7 T={t}", got,
                         CA.int8_cached_attention_plain(*args),
                         chip_smoke.INT8_ATT_MAX, chip_smoke.INT8_ATT_L2)


def test_k7_check_sees_a_dropped_rank(cuda):
    """A planted fault: K7 at B=32, T=1500, H=8 run with the V codes of
    rank 1's keys zeroed computes what a cluster that left rank 1's
    partial out of rank 0's sum computes; chip_smoke's check rejects it
    and passes the kernel on the true V."""
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    gen = torch.Generator().manual_seed(14)
    q, k8, ks, v8, vs = chip_smoke.k7_inputs(gen, 32, 1500, 8)
    cs, chunk = CA.cluster_plan(1500, None, 32 * 8, CA._fit(q.device))
    assert cs > 1
    ref = CA.int8_cached_attention_plain(q, k8, ks, v8, vs)
    chip_smoke.check_rel("K7", CA.int8_cached_attention(q, k8, ks, v8, vs),
                         ref, chip_smoke.INT8_ATT_MAX, chip_smoke.INT8_ATT_L2)
    vd = v8.clone()
    vd[:, :, chunk:2 * chunk] = 0
    with pytest.raises(AssertionError, match="off its plain version"):
        chip_smoke.check_rel("K7 rank 1 dropped", CA.int8_cached_attention(
            q, k8, ks, vd, vs), ref, chip_smoke.INT8_ATT_MAX,
            chip_smoke.INT8_ATT_L2)


@pytest.mark.parametrize("heads", [6, 8, 12])
@pytest.mark.parametrize("group,cluster", [(None, None), (1, 2), (2, 4),
                                           (1, 16), ("H", 8), (2, 16)])
@pytest.mark.parametrize("t,pos", [(1500, None), (1500, 999), (7, None),
                                   (1501, 3)])
def test_k6_cluster_layouts(cuda, heads, group, cluster, t, pos):
    """K6's split-T cluster at H = 6, 8, 12 with forced head layouts and
    cluster sizes (16 blocks over 7 or 4 keys leave ranks without keys),
    against the plain version; one launch each."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    gen = torch.Generator().manual_seed(t + heads)
    args = chip_smoke.k6_inputs(gen, 3, t, heads)
    n = t if pos is None else pos + 1
    runtime.reset_counts()
    got = CX._launch_int8(*args, heads, n,
                          heads if group == "H" else group, cluster)
    torch.cuda.synchronize()
    assert runtime.COUNTS["single_query_attention_int8"] == 1
    chip_smoke.check_rel(f"K6 G={group} cs={cluster}", got,
                         CX.single_query_attention_int8_plain(
                             *args, heads=heads, pos=pos),
                         chip_smoke.INT8_ATT_MAX, chip_smoke.INT8_ATT_L2)


def test_k6_check_sees_a_dropped_rank(cuda):
    """A planted fault: K6 at B=32, T=1500, H=8 with the plan's cluster,
    run with the V codes of rank 1's keys zeroed, computes what a cluster
    that left rank 1's partial out of rank 0's sum computes; chip_smoke's
    check rejects it and passes the kernel on the true V."""
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    gen = torch.Generator().manual_seed(15)
    q, k8, ks, v8, vs = chip_smoke.k6_inputs(gen, 32, 1500, 8)
    g, cs, chunk = CX.int8_plan(1500, 8, 32, CX._fit_int8(q.device))
    assert cs > 1
    ref = CX.single_query_attention_int8_plain(q, k8, ks, v8, vs, heads=8)
    chip_smoke.check_rel("K6", CX.fused_single_query_attention_int8(
        q, k8, ks, v8, vs, heads=8), ref, chip_smoke.INT8_ATT_MAX,
        chip_smoke.INT8_ATT_L2)
    vd = v8.clone()
    vd[:, chunk:2 * chunk] = 0
    with pytest.raises(AssertionError, match="off its plain version"):
        chip_smoke.check_rel("K6 rank 1 dropped",
                             CX.fused_single_query_attention_int8(
                                 q, k8, ks, vd, vs, heads=8), ref,
                             chip_smoke.INT8_ATT_MAX, chip_smoke.INT8_ATT_L2)


def test_int8_wrappers_raise_instead_of_falling_back(cuda):
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    gen = torch.Generator().manual_seed(9)
    x, wq, scale, b = chip_smoke.k5_inputs(gen, 4, 64, 96)
    with pytest.raises(TypeError):                    # float16 x
        Q.quant_matmul(x.half(), wq, scale)
    with pytest.raises(TypeError, match="of one dtype"):  # float32 bias
        Q.quant_dense_apply({"wq": wq, "scale": scale, "b": b.float()}, x)
    with pytest.raises(ValueError):                   # K % 8 != 0
        Q.quant_matmul(x[:, :60].contiguous(), wq[:60].contiguous(), scale)
    with pytest.raises(ValueError):                   # scale on the CPU
        Q.quant_matmul(x, wq, scale.cpu())
    q, k8, ks, v8, vs = chip_smoke.k6_inputs(gen, 2, 16, 2)
    with pytest.raises(TypeError):                    # float16 q
        CX.fused_single_query_attention_int8(q.half(), k8, ks, v8, vs,
                                             heads=2)
    with pytest.raises(ValueError):                   # head dim 32
        CX.fused_single_query_attention_int8(q, k8, ks.repeat(1, 1, 2), v8,
                                             vs.repeat(1, 1, 2), heads=4)
    with pytest.raises(ValueError):                   # 3 heads a block, H=2
        CX._launch_int8(q, k8, ks, v8, vs, 2, 16, group=3)
    with pytest.raises(ValueError):                   # 17 blocks a cluster
        CX._launch_int8(q, k8, ks, v8, vs, 2, 16, cluster=17)
    q, k8, ks, v8, vs = chip_smoke.k7_inputs(gen, 2, 16, 2)
    with pytest.raises(ValueError):                   # non-contiguous K
        CA.int8_cached_attention(q, k8.transpose(2, 3), ks, v8, vs)
    with pytest.raises(TypeError):                    # float16 q
        CA.int8_cached_attention(q.half(), k8, ks, v8, vs)


@pytest.mark.parametrize("mode", ["int8_fused", "int8"])
def test_tiny_int8_engine_on_card(cuda, mode):
    """The toy-width engine (head dim 64) with the int8 decoder memory
    mode on both models: on the card every dense decoder layer and the
    logits went through K5, the cross attention through K6 or K7, and the
    segments are the CPU engine's."""
    import numpy as np
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, EngineConfig, MelConfig)
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
    from multimodal_audio_search_tpu_torch.ops.quant import (
        quantize_whisper_decoder)
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        DualPipelineIngest)
    from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
        WhisperTextPipeline)
    wcfg = W.config_for("test", d_model=128, heads=2)   # head dim 64
    mel = MelConfig(padded_seconds=2.0)

    def engine(device):
        dec = DecodeConfig(max_new_tokens=5, cross_attn=mode)
        pipes = [WhisperTextPipeline(
            params=quantize_whisper_decoder(W.init_params(
                torch.Generator().manual_seed(s), wcfg)),
            cfg=wcfg, decode=dec, mel_cfg=mel, device=device,
            prefix_ids=None if s == 0 else [wcfg.bos_token_id])
            for s in (0, 1)]
        emb = TextEmbedder(cfg=PRESETS["test"], device=device)
        cfg = EngineConfig(ingest_batch=4, embed_dim=64)
        return AudioSearchEngine(cfg=cfg, ingest_pipeline=DualPipelineIngest(
            *pipes, emb, cfg))

    x = (np.random.default_rng(0).normal(size=16000 * 25) * 0.3) \
        .astype(np.float32)
    runtime.reset_counts()
    eng = engine("cuda")
    gpu = eng.ingest_waveform(x, 16000, "x")
    ing = eng.ingest_pipeline
    steps = (ing.asr.total_steps, ing.caption.total_steps)
    disp = (ing.asr.dispatches, ing.caption.dispatches)
    cpu = engine("cpu").ingest_waveform(x, 16000, "x")
    assert [s["start_time"] for s in gpu] == [s["start_time"] for s in cpu]
    counts = {k: runtime.COUNTS[v] for k, v in chip_smoke.KEYS.items()}
    assert counts == chip_smoke.expected_launches(False, mode, steps, disp,
                                                  ing.asr, ing.caption)


# ------------------------------------------ K8-K11 (encoder variants)
ENC_SHAPES = [(1, 2, 1), (2, 4, 97), (3, 6, 200), (2, 8, 1500)]
# K8's 128-key tiles and 128-row query blocks: one key short of a tile,
# a full tile, one key into the next, four tiles and a key, the main T
K8_TILE_EDGES = [(2, 3, 127), (2, 3, 128), (2, 3, 129), (2, 4, 513),
                 (1, 8, 1500)]


@pytest.mark.parametrize("b,heads,t", ENC_SHAPES + K8_TILE_EDGES)
def test_k8_matches_plain(cuda, b, heads, t):
    """K8 at ragged T (a partial last 128-key tile, rows past T never
    stored), on head-split views of separate dense outputs, its output a
    [B, H, T, D] view of the merged layout."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import attention as A
    gen = torch.Generator().manual_seed(100 + t)
    for inputs, q_scale, _ in chip_smoke.K1_CASES:
        q, k, v, *_ = chip_smoke.k1_inputs(gen, b, t, heads, q_scale=q_scale)
        runtime.reset_counts()
        got = A.fused_encoder_attention(q, k, v)
        torch.cuda.synchronize()
        assert runtime.COUNTS["encoder_attention"] == 1
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert got.transpose(1, 2).is_contiguous()
        chip_smoke.check_rel(f"K8 {inputs}", got,
                             A.encoder_attention_plain(q, k, v),
                             chip_smoke.K1_Y_MAX, chip_smoke.K1_Y_L2)


# the float32 forms' 64-key tiles and 64-row blocks: one key, one short
# of a tile, a full tile, one into the next, the drift shape, the main T
F32_TILE_EDGES = [(2, 3, 1), (2, 3, 63), (2, 3, 64), (2, 3, 65),
                  (3, 6, 100), (2, 6, 1500), (8, 6, 1500)]


@pytest.mark.parametrize("b,heads,t", F32_TILE_EDGES)
def test_k8_float32_matches_plain(cuda, b, heads, t):
    """K8's float32 form (a float32 encode on the card, 3xTF32) at ragged
    T (a partial last 64-key tile and 64-row block), on head-split views,
    within chip_smoke's float32 tolerance; its output a float32 view of
    the merged layout."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import attention as A
    gen = torch.Generator().manual_seed(200 + t)
    q, k, v = chip_smoke._f32_heads(gen, b, t, heads)
    runtime.reset_counts()
    got = A.fused_encoder_attention(q, k, v)
    torch.cuda.synchronize()
    assert runtime.COUNTS["encoder_attention"] == 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert got.transpose(1, 2).is_contiguous()
    chip_smoke.check_close(f"K8 float32 T={t}", got,
                           A.encoder_attention_plain(q, k, v),
                           chip_smoke.F32_ATT_ATOL, chip_smoke.F32_ATT_RTOL)


@pytest.mark.parametrize("b,heads,t", F32_TILE_EDGES + [
    (32, 8, 1500), (32, 6, 1500), (2, 12, 129), (1, 20, 257), (1, 1, 70)])
def test_k1_float32_matches_plain(cuda, b, heads, t):
    """K1's float32 form at the float32 engine's widths (B=32, T=1500,
    base and tiny), at ragged T and at H = 12 and 20 (clusters of 6 and
    7 blocks of 2-3 heads), within chip_smoke's float32 block tolerance
    of attention_o_residual_plain; one launch a call."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    args = chip_smoke._f32_block(torch.Generator().manual_seed(600 + t),
                                 b, t, heads)
    runtime.reset_counts()
    got = EB.fused_attention_o_residual(*args)
    torch.cuda.synchronize()
    assert runtime.COUNTS["encoder_attn_o_residual"] == 1
    assert got.dtype == torch.float32 and got.shape == args[3].shape
    chip_smoke.check_close(f"K1 float32 B={b} H={heads} T={t}", got,
                           EB.attention_o_residual_plain(*args),
                           chip_smoke.F32_BLOCK_ATOL,
                           chip_smoke.F32_BLOCK_RTOL)


@pytest.mark.parametrize("heads", [8, 6])
def test_k1_float32_repeats_bit_equal(cuda, heads):
    """K1's float32 form, 16 more launches on the same inputs at B=32,
    T=1500, each bit-equal to the first: every output element is summed
    in one order by one thread, and the cluster barrier orders the
    merged tile's stores before any rank reads them."""
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    args = chip_smoke._f32_block(torch.Generator().manual_seed(heads), 32,
                                 1500, heads)
    first = EB.fused_attention_o_residual(*args)
    assert chip_smoke.check_repeats(
        f"K1 float32 H={heads}",
        lambda: EB.fused_attention_o_residual(*args), first,
        chip_smoke.F32_REPEATS) == chip_smoke.F32_REPEATS


# K3's float32 form: the float32 engine's widths at B=32, L=68 and every
# pos of chip_smoke.K3_POS, a ragged tile, whisper-small's 12 heads, and
# whisper-large's 20 over 16 blocks at L=448 (the widest plan)
K3_F32_CASES = [(32, 8, 68, 0), (32, 8, 68, 3), (32, 8, 68, 67),
                (32, 6, 68, 0), (32, 6, 68, 3), (32, 6, 68, 67),
                (5, 2, 41, 6), (33, 12, 68, 40), (9, 20, 448, 447)]


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("b,heads,l,pos", K3_F32_CASES)
def test_k3_float32_matches_plain(cuda, tail, b, heads, l, pos):
    """K3's and K3-q's float32 forms (csrc/decoder_block_f32.cu) within
    chip_smoke's float32 block tolerance of the plain version on x_out,
    k1, v1 and q_cross; row pos of the caches written with the k1 / v1
    returned and no other row touched; one launch a call, counted as
    the bf16 form's."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(2500 + b * 100 + pos)
    x, selfw, tl, kc, vc = chip_smoke.k3_inputs(gen, b, l, heads * 64,
                                                dtype=torch.float32)
    extra = tl if tail else []
    fused = DB.fused_self_block_q if tail else DB.fused_self_block
    plain = DB.self_block_q_plain if tail else DB.self_block_plain
    ref = plain(x, *selfw, *extra, kc, vc, pos, heads=heads)
    kg, vg = kc.clone(), vc.clone()
    runtime.reset_counts()
    got = fused(x, *selfw, *extra, kg, vg, pos, heads=heads)
    torch.cuda.synchronize()
    key = "decoder_self_block_q" if tail else "decoder_self_block"
    assert runtime.COUNTS[key] == 1 and sum(runtime.COUNTS.values()) == 1
    assert all(g.dtype == torch.float32 for g in got)
    for label, g, r in zip(("x_out", "k1", "v1", "q_cross"), got, ref):
        chip_smoke.check_close(f"K3 float32 {label}", g, r,
                               chip_smoke.F32_BLOCK_ATOL,
                               chip_smoke.F32_BLOCK_RTOL)
    assert torch.equal(kg[:, pos], got[1]) and torch.equal(vg[:, pos], got[2])
    for c, cg in ((kc, kg), (vc, vg)):
        assert torch.equal(cg[:, :pos], c[:, :pos])
        assert torch.equal(cg[:, pos + 1:], c[:, pos + 1:])


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("b,d,f", [(32, 512, 2048), (32, 384, 1536),
                                   (1, 128, 256), (33, 512, 2048),
                                   (7, 1024, 4096), (64, 768, 3072),
                                   (32, 1280, 5120), (200, 384, 1536)])
def test_k4_float32_matches_plain(cuda, head, b, d, f):
    """K4's and K4-o's float32 forms at the float32 engine's widths (B=32,
    base and tiny), one row, ragged row blocks and the ingest batch up to
    200, and every Whisper width (D in 512-column chunks past 512; at
    1280, 320 slices of 16 fc1 columns on a grid capped by the card),
    within chip_smoke's float32 block tolerance of the plain version; a
    second call finds the barrier counters at zero."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(2600 + b + d)
    x, mlp, hd = chip_smoke.k4_inputs(gen, b, d, f, dtype=torch.float32)
    args = (x, *hd, *mlp) if head else (x, *mlp)
    fused = DB.fused_mlp_block_o if head else DB.fused_mlp_block
    plain = DB.mlp_block_o_plain if head else DB.mlp_block_plain
    ref = plain(*args)
    for _ in range(2):
        runtime.reset_counts()
        got = fused(*args)
        torch.cuda.synchronize()
        assert sum(runtime.COUNTS.values()) == 1
        assert int(DB._COUNTERS[x.device][1].abs().sum()) == 0
        assert got.dtype == torch.float32 and got.shape == x.shape
        chip_smoke.check_close(f"K4 float32 B={b} D={d}", got, ref,
                               chip_smoke.F32_BLOCK_ATOL,
                               chip_smoke.F32_BLOCK_RTOL)


@pytest.mark.parametrize("kernel", ["K3", "K3-q", "K4", "K4-o"])
@pytest.mark.parametrize("heads", [8, 6])
def test_decoder_float32_repeats_bit_equal(cuda, kernel, heads):
    """The decoder blocks' float32 forms at B=32 (K3 and K3-q at L=68,
    pos 67), 16 more launches on the same inputs each bit-equal to the
    first: every output element is summed in one fixed order."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(heads)
    d = heads * 64
    if kernel.startswith("K3"):
        x, selfw, tl, kc, vc = chip_smoke.k3_inputs(gen, 32, 68, d,
                                                    dtype=torch.float32)
        extra = tl if kernel == "K3-q" else []
        fused = DB.fused_self_block_q if extra else DB.fused_self_block

        def fn():
            return torch.cat([t.reshape(-1) for t in fused(
                x, *selfw, *extra, kc, vc, 67, heads=heads)])
    else:
        x, mlp, hd = chip_smoke.k4_inputs(gen, 32, d, 4 * d,
                                          dtype=torch.float32)
        args = (x, *hd, *mlp) if kernel == "K4-o" else (x, *mlp)
        fused = DB.fused_mlp_block_o if kernel == "K4-o" \
            else DB.fused_mlp_block

        def fn():
            return fused(*args)
    first = fn()
    assert chip_smoke.check_repeats(f"{kernel} float32 H={heads}", fn,
                                    first, chip_smoke.F32_REPEATS) == \
        chip_smoke.F32_REPEATS


def test_k3_float32_check_sees_a_dropped_rank(cuda):
    """A planted fault: K3's float32 form at base width (B=32, pos 67) run
    with rank 1's rows of Wo (head 1's) zeroed computes what a cluster
    sum that left rank 1's partial out computes; the float32 check
    rejects it and passes the kernel on the true Wo."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(13)
    x, selfw, _, kc, vc = chip_smoke.k3_inputs(gen, 32, 68, 512,
                                               dtype=torch.float32)
    assert DB.self_block_f32_plan(32, 8, 68)[0] == 8
    ref = DB.self_block_plain(x, *selfw, kc, vc, 67, heads=8)[0]
    tol = (chip_smoke.F32_BLOCK_ATOL, chip_smoke.F32_BLOCK_RTOL)
    chip_smoke.check_close("K3 float32", DB.fused_self_block(
        x, *selfw, kc.clone(), vc.clone(), 67, heads=8)[0], ref, *tol)
    dropped = list(selfw)
    dropped[7] = selfw[7].clone()
    dropped[7][64:128] = 0
    with pytest.raises(AssertionError, match="K3 float32 rank 1 dropped"):
        chip_smoke.check_close("K3 float32 rank 1 dropped",
                               DB.fused_self_block(
                                   x, *dropped, kc.clone(), vc.clone(), 67,
                                   heads=8)[0], ref, *tol)


def test_k8_reuses_tensor_maps_only_for_the_same_view(cuda):
    """K8 keeps the TMA maps of views it has seen: the same buffers with
    new contents, and a view of the same base with fewer rows, each match
    the plain version."""
    from multimodal_audio_search_tpu_torch.ops import attention as A
    gen = torch.Generator().manual_seed(14)
    q, k, v, *_ = chip_smoke.k1_inputs(gen, 2, 300, 4)

    def check(name, *views):
        chip_smoke.check_rel(name, A.fused_encoder_attention(*views),
                             A.encoder_attention_plain(*views),
                             chip_smoke.K1_Y_MAX, chip_smoke.K1_Y_L2)
    check("first call", q, k, v)
    for a in (q, k, v):   # new contents at the same addresses
        a.copy_(torch.randn(a.shape, generator=gen).to(a.device, a.dtype))
    check("same views, new contents", q, k, v)
    check("fewer rows, same base", *(a[:, :, :150] for a in (q, k, v)))


@pytest.mark.parametrize("b,heads,t", ENC_SHAPES)
def test_k9_k10_k11_match_plain(cuda, b, heads, t):
    """K9 (on quantize_kv's codes), K10 (even head counts) and K11's three
    forms on K1's inputs, held by chip_smoke's K1 check; one launch each."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    from multimodal_audio_search_tpu_torch.ops.cached_attention import (
        quantize_kv)
    gen = torch.Generator().manual_seed(200 + t)
    for inputs, q_scale, residual in chip_smoke.K1_CASES:
        args = chip_smoke.k1_inputs(gen, b, t, heads, q_scale=q_scale,
                                    residual=residual)
        q, k, v, x, wo, bo = args
        args9 = (q, *quantize_kv(k, v), x, wo, bo)
        runs = [("K9", "encoder_attn_o_residual_int8",
                 lambda: EB.attention_o_residual_int8(*args9),
                 lambda: EB.attention_o_residual_int8_plain(*args9))]
        if heads % 2 == 0:
            runs.append(("K10", "encoder_attn_o_residual_paired",
                         lambda: EB.fused_attention_o_residual(
                             *args, pair_heads=True),
                         lambda: EB.attention_o_residual_paired_plain(*args)))
        for form in (False, True, "post"):
            runs.append((f"K11 {form}", "encoder_attn_o_residual_ab",
                         lambda f=form: EB.attention_o_residual_ab(*args, f),
                         lambda f=form: EB.attention_o_residual_ab_plain(
                             *args, f)))
        for name, key, fused, plain in runs:
            runtime.reset_counts()
            got = fused()
            torch.cuda.synchronize()
            assert runtime.COUNTS[key] == 1 and sum(runtime.COUNTS.values()) == 1
            assert got.dtype == torch.bfloat16 and got.shape == x.shape
            chip_smoke.check_k1(f"{name} {inputs}", got, plain(), residual)


@pytest.mark.parametrize("heads", [6, 8, 12, 20])
@pytest.mark.parametrize("t", [129, 1500, 1501])
def test_k9_widths_and_ragged_t(cuda, heads, t):
    """K9 at D = 384, 512, 768 and 1280 (the widest, one ring stage a
    warpgroup) and at T = 129 and 1501 (a last 128-key tile of one key, a
    last 64-row block of one row), on every K1 input; one launch each."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    from multimodal_audio_search_tpu_torch.ops.cached_attention import (
        quantize_kv)
    gen = torch.Generator().manual_seed(300 + t + heads)
    for inputs, q_scale, residual in chip_smoke.K1_CASES:
        q, k, v, x, wo, bo = chip_smoke.k1_inputs(
            gen, 2, t, heads, q_scale=q_scale, residual=residual)
        args9 = (q, *quantize_kv(k, v), x, wo, bo)
        runtime.reset_counts()
        got = EB.attention_o_residual_int8(*args9)
        torch.cuda.synchronize()
        assert runtime.COUNTS["encoder_attn_o_residual_int8"] == 1
        chip_smoke.check_k1(f"K9 D={heads * 64} T={t} {inputs}", got,
                            EB.attention_o_residual_int8_plain(*args9),
                            residual)


@pytest.mark.parametrize("heads", [6, 8])
def test_k9_launches_repeat_bit_for_bit(cuda, heads):
    """K9 at B=32, T=1500 on the attention input, 400 more launches on the
    same inputs each bit-equal to the first (chip_smoke.check_repeats):
    without the proxy fence before a stage's release, about 1 % of
    launches read a refilled Wo stage in one warp's 16 rows."""
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    from multimodal_audio_search_tpu_torch.ops.cached_attention import (
        quantize_kv)
    q, k, v, x, wo, bo = chip_smoke.k1_inputs(
        torch.Generator().manual_seed(0), 32, 1500, heads, residual=False)
    args9 = (q, *quantize_kv(k, v), x, wo, bo)
    first = EB.attention_o_residual_int8(*args9)
    assert chip_smoke.check_repeats(
        f"K9 H={heads}", lambda: EB.attention_o_residual_int8(*args9),
        first, 400) == 400


@pytest.mark.parametrize("heads", [12, 16, 20])
@pytest.mark.parametrize("t", [129, 1500, 1501])
def test_k1_k10_widths_and_ragged_t(cuda, heads, t):
    """K1 and K10 at D = 768, 1024 and 1280 on their plans' clusters and at
    T = 129 and 1501 (a last 128-key tile of one key, a last 128-row tile
    of one row), on every K1 input, held by chip_smoke's K1 check; one
    launch each."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    gen = torch.Generator().manual_seed(400 + t + heads)
    for inputs, q_scale, residual in chip_smoke.K1_CASES:
        args = chip_smoke.k1_inputs(gen, 2, t, heads, q_scale=q_scale,
                                    residual=residual)
        for name, key, pair, plain in (
                ("K1", "encoder_attn_o_residual", False,
                 EB.attention_o_residual_plain),
                ("K10", "encoder_attn_o_residual_paired", True,
                 EB.attention_o_residual_paired_plain)):
            runtime.reset_counts()
            got = EB.fused_attention_o_residual(*args, pair_heads=pair)
            torch.cuda.synchronize()
            assert runtime.COUNTS[key] == 1
            chip_smoke.check_k1(f"{name} D={heads * 64} T={t} {inputs}", got,
                                plain(*args), residual)


@pytest.mark.parametrize("heads,t,pair", [(8, 300, False), (6, 129, False),
                                          (6, 129, True), (8, 1501, True),
                                          (20, 257, False)])
def test_k1_k10_every_cluster_size(cuda, heads, t, pair):
    """K1 and K10 on every cluster size the kernel takes at a shape (one
    to four heads a block, even and uneven splits, K10 one or two pairs),
    each held by chip_smoke's K1 check on the attention input."""
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    gen = torch.Generator().manual_seed(500 + t + heads)
    args = chip_smoke.k1_inputs(gen, 2, t, heads, residual=False)
    plain = (EB.attention_o_residual_paired_plain if pair
             else EB.attention_o_residual_plain)(*args)
    units = heads // 2 if pair else heads
    g = 2 if pair else 1
    sizes = [c for c in range(1, min(units, EB.MAX_CLUSTER) + 1)
             if -(-units // c) * g <= EB.BLOCK_HEADS]
    assert sizes
    for c in sizes:
        chip_smoke.check_k1(f"cluster {c}", EB._launch(
            *args, pair_heads=pair, cluster=c), plain, residual=False)


def test_k1_raises_on_a_cluster_the_card_refuses(cuda):
    """A cluster the card cannot place (17 blocks, past its 16) and a plan
    outside the kernel's rules (five heads a block) both raise from the
    wrapper; neither counts a launch, and nothing falls back to the plain
    version."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    gen = torch.Generator().manual_seed(15)
    args = chip_smoke.k1_inputs(gen, 1, 200, 20)
    for cluster in (17, 4):
        runtime.reset_counts()
        with pytest.raises(RuntimeError, match="mas_attn_o_residual"):
            EB._launch(*args, cluster=cluster)
        assert sum(runtime.COUNTS.values()) == 0
    with pytest.raises(RuntimeError, match="mas_attn_o_residual_paired"):
        EB._launch(*args, pair_heads=True, cluster=17)
    # the refused launches left no error behind for the next kernel's
    # cudaGetLastError() (K8's wrapper reads it)
    from multimodal_audio_search_tpu_torch.ops import attention as A
    A.fused_encoder_attention(*args[:3])
    torch.cuda.synchronize()
    chip_smoke.check_k1("after", EB.fused_attention_o_residual(*args),
                        EB.attention_o_residual_plain(*args), True)


@pytest.mark.parametrize("heads,t", [(8, 300), (6, 129), (20, 257),
                                     (8, 1501)])
def test_k11_every_form_and_cluster_size(cuda, heads, t):
    """K11's three forms on every cluster size the kernel takes at a shape
    (one to four heads a block, even and uneven splits; at T = 129 and
    1501 a last 128-key tile of one key), each held by chip_smoke's K1
    check on the attention input and one launch each; on the plan's size
    also on the residual and peaked inputs."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    gen = torch.Generator().manual_seed(600 + t + heads)
    sizes = [c for c in range(1, min(heads, EB.MAX_CLUSTER) + 1)
             if -(-heads // c) <= EB.BLOCK_HEADS]
    plan = EB._card_plan(heads, 2, t)
    assert plan in sizes
    for inputs, q_scale, residual in chip_smoke.K1_CASES:
        args = chip_smoke.k1_inputs(gen, 2, t, heads, q_scale=q_scale,
                                    residual=residual)
        for form in (False, True, "post"):
            plain = EB.attention_o_residual_ab_plain(*args, form)
            for c in sizes if inputs == "attention" else [plan]:
                runtime.reset_counts()
                got = EB._launch(*args, form=form, cluster=c)
                torch.cuda.synchronize()
                assert runtime.COUNTS["encoder_attn_o_residual_ab"] == 1
                assert sum(runtime.COUNTS.values()) == 1
                chip_smoke.check_k1(f"K11 {form} cluster {c} {inputs}", got,
                                    plain, residual)


def test_k11_raises_on_a_cluster_the_card_refuses(cuda):
    """K11 on a cluster the card cannot place (17 blocks, past its 16) and
    on a plan outside the kernel's rules (five heads a block) raises from
    the wrapper in every form, counting no launch; the next kernel's
    launch check finds no error left behind."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    gen = torch.Generator().manual_seed(16)
    args = chip_smoke.k1_inputs(gen, 1, 200, 20)
    for form in (False, True, "post"):
        for cluster in (17, 4):
            runtime.reset_counts()
            with pytest.raises(RuntimeError, match="mas_attn_o_residual_ab"):
                EB._launch(*args, form=form, cluster=cluster)
            assert sum(runtime.COUNTS.values()) == 0
    chip_smoke.check_k1("after", EB.attention_o_residual_ab(*args, False),
                        EB.attention_o_residual_ab_plain(*args, False), True)


@pytest.mark.parametrize("case", ["p / l", "pw / ps", "o / l"])
def test_k9_row_division_is_the_true_division(cuda, case):
    """K9 and K11 divide by a row's reciprocal with one correction step
    (sm90.cuh div_row); over 1.6e7 random quotients in the ranges they
    divide (exp(s - m) in [1e-30, 1] by a row sum l in [1, 12288]; pw in
    [0, 127 ps] by ps down to 1e-30 / 127; K11's True form: a head's PV
    output o, |o| <= 16 l, by l) every bit matches the true division
    (below 2^-100 the quotient may leave float32's normal range, where
    div_row's note says why no code or bf16 p can move)."""
    from multimodal_audio_search_tpu_torch import runtime
    gen = torch.Generator(device="cuda").manual_seed(7)
    n = 1 << 24
    u = torch.rand(n, generator=gen, device="cuda")
    if case == "p / l":
        x = torch.exp(-69.0 * u)                # down to 1e-30 > 2^-100
        d = 1.0 + 12287.0 * torch.rand(n, generator=gen, device="cuda")
    elif case == "o / l":
        d = 1.0 + 12287.0 * torch.rand(n, generator=gen, device="cuda")
        x = (2.0 * u - 1.0) * 16.0 * d
    else:
        d = torch.exp(-69.0 * torch.rand(n, generator=gen, device="cuda")) \
            / 127.0                             # ps in [1e-30 / 127, 1 / 127]
        x = u * 127.0 * d
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    runtime.check_launch(runtime.kernels().mas_k9_division_check(
        x.data_ptr(), d.data_ptr(), bad.data_ptr(), n,
        runtime.stream_handle(x.device)), "mas_k9_division_check")
    assert int(bad.item()) == 0


def test_k8_check_sees_unmasked_pad_keys(cuda):
    """A planted fault: K8 at T=1536 (12 tiles of 128 keys) on keys whose
    last 36 rows are zero computes what a K8 that left the zero-filled pad
    of its last 128-key tile unmasked computes at T=1500; chip_smoke's
    check rejects it."""
    from multimodal_audio_search_tpu_torch.ops import attention as A
    gen = torch.Generator().manual_seed(11)
    q, k, v, *_ = chip_smoke.k1_inputs(gen, 2, 1536, 8)
    k[:, :, 1500:] = 0
    v[:, :, 1500:] = 0
    cut = [a[:, :, :1500] for a in (q, k, v)]
    ref = A.encoder_attention_plain(*cut)

    def check(name, got):
        chip_smoke.check_rel(name, got, ref, chip_smoke.K1_Y_MAX,
                             chip_smoke.K1_Y_L2)
    check("K8 T=1500", A.fused_encoder_attention(*cut))
    with pytest.raises(AssertionError, match="off its plain version"):
        check("K8 pad keys unmasked",
              A.fused_encoder_attention(q, k, v)[:, :, :1500])


def test_k9_k10_checks_see_planted_faults(cuda):
    """Planted faults through the kernels' inputs: K9 given head 0's key
    scales for every head, K10 given each odd head's partner's keys; each
    held to the plain version on the right inputs fails chip_smoke's
    check, and the right inputs pass."""
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    from multimodal_audio_search_tpu_torch.ops.cached_attention import (
        quantize_kv)
    gen = torch.Generator().manual_seed(12)
    q, k, v, x, wo, bo = chip_smoke.k1_inputs(gen, 2, 1500, 8,
                                              residual=False)
    k8, ks, v8, vs = quantize_kv(k, v)
    ref = EB.attention_o_residual_int8_plain(q, k8, ks, v8, vs, x, wo, bo)
    chip_smoke.check_k1("K9", EB.attention_o_residual_int8(
        q, k8, ks, v8, vs, x, wo, bo), ref, residual=False)
    ks0 = ks[:, :1].expand_as(ks).contiguous()
    with pytest.raises(AssertionError, match="attention term"):
        chip_smoke.check_k1("K9 head 0's key scales", EB.
                            attention_o_residual_int8(q, k8, ks0, v8, vs, x,
                                                      wo, bo), ref,
                            residual=False)
    ref = EB.attention_o_residual_paired_plain(q, k, v, x, wo, bo)
    chip_smoke.check_k1("K10", EB.fused_attention_o_residual(
        q, k, v, x, wo, bo, pair_heads=True), ref, residual=False)
    kf = k.clone()
    kf[:, 1::2] = k[:, 0::2]
    with pytest.raises(AssertionError, match="attention term"):
        chip_smoke.check_k1("K10 partner's keys", EB.fused_attention_o_residual(
            q, kf, v, x, wo, bo, pair_heads=True), ref, residual=False)


def test_encoder_variant_wrappers_raise_instead_of_falling_back(cuda):
    from multimodal_audio_search_tpu_torch.ops import attention as A
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    from multimodal_audio_search_tpu_torch.ops.cached_attention import (
        quantize_kv)
    gen = torch.Generator().manual_seed(13)
    q, k, v, x, wo, bo = chip_smoke.k1_inputs(gen, 1, 40, 3)
    with pytest.raises(TypeError):                    # float16: no form
        A.fused_encoder_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):                    # float32 q alone
        A.fused_encoder_attention(q.float(), k, v)
    with pytest.raises(ValueError):                   # head dim 32
        A.fused_encoder_attention(*(a.reshape(1, 6, 40, 32)
                                    for a in (q, k, v)))
    with pytest.raises(ValueError):                   # odd head count
        EB._launch(q, k, v, x, wo, bo, pair_heads=True)
    with pytest.raises(TypeError):                    # float32 q
        EB.attention_o_residual_int8(q.float(), *quantize_kv(k, v), x, wo,
                                     bo)
    with pytest.raises(ValueError):                   # not a form
        EB.attention_o_residual_ab(q, k, v, x, wo, bo, "div")


@pytest.mark.parametrize("enc", [False, "int8", "paired"])
def test_tiny_encoder_variant_engine_on_card(cuda, enc):
    """A toy-width engine (head dim 64) at a 12 s context (T=600 >= 512,
    so fused_encoder=False takes K8) with each encoder variant on both
    models: on the card every encoder layer went through K8, K9 or K10,
    the launches are what chip_smoke expects, and the segments are the
    CPU engine's."""
    import numpy as np
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, EngineConfig, MelConfig)
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        DualPipelineIngest)
    from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
        WhisperTextPipeline)
    wcfg = W.config_for("test", d_model=128, heads=2, enc_positions=600)
    mel = MelConfig(padded_seconds=12.0)

    def engine(device):
        dec = DecodeConfig(max_new_tokens=5, fused_encoder=enc)
        asr = WhisperTextPipeline(cfg=wcfg, decode=dec, mel_cfg=mel,
                                  device=device)
        cap = WhisperTextPipeline(cfg=wcfg, decode=dec, mel_cfg=mel, seed=1,
                                  prefix_ids=[wcfg.bos_token_id],
                                  device=device)
        emb = TextEmbedder(cfg=PRESETS["test"], device=device)
        cfg = EngineConfig(ingest_batch=4, embed_dim=64)
        return AudioSearchEngine(cfg=cfg, ingest_pipeline=DualPipelineIngest(
            asr, cap, emb, cfg))

    x = (np.random.default_rng(0).normal(size=16000 * 25) * 0.3) \
        .astype(np.float32)
    runtime.reset_counts()
    eng = engine("cuda")
    gpu = eng.ingest_waveform(x, 16000, "x")
    ing = eng.ingest_pipeline
    steps = (ing.asr.total_steps, ing.caption.total_steps)
    disp = (ing.asr.dispatches, ing.caption.dispatches)
    counts = {k: runtime.COUNTS[v] for k, v in chip_smoke.KEYS.items()}
    cpu = engine("cpu").ingest_waveform(x, 16000, "x")
    assert [s["start_time"] for s in gpu] == [s["start_time"] for s in cpu]
    exp = chip_smoke.expected_launches(False, None, steps, disp, ing.asr,
                                       ing.caption, enc)
    assert counts == exp and exp[chip_smoke.encoder_kernel(enc, 2)] > 0


# ------------------------------------- K12-K14 (search at scale, B12)
@pytest.mark.parametrize("n,dtype", [(1, "float32"), (31, "bfloat16"),
                                     (1027, "float32"), (1027, "bfloat16"),
                                     (100_000, "float32"),
                                     (100_000, "bfloat16")])
def test_k12_matches_plain(cuda, n, dtype):
    """K12 at odd N (no padding: the stride loop ends at N) in both index
    dtypes, held by chip_smoke's K12 check; one launch."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import fused_search as FS
    q, e, ok = chip_smoke.k12_inputs(n, dtype, seed=n)
    runtime.reset_counts()
    got = FS.fused_scores_kernel(q, e, ok, 0.6, 0.4)
    torch.cuda.synchronize()
    assert runtime.COUNTS["fused_scores"] == 1
    assert got.dtype == torch.float32 and got.shape == (n,)
    chip_smoke.check_k12(f"K12 N={n} {dtype}", got, q, e, ok, 0.6, 0.4)


@pytest.mark.parametrize("d,dtype", [(4, "float32"), (8, "bfloat16"),
                                     (136, "float32"), (64, "bfloat16")])
def test_k12_other_widths(cuda, d, dtype):
    """Index rows of any 16-byte multiple, not only MiniLM's 384."""
    from multimodal_audio_search_tpu_torch.ops import fused_search as FS
    gen = torch.Generator(device="cuda").manual_seed(d)
    e = torch.randn(5000, 2, d, generator=gen, device="cuda")
    e = (e / e.norm(dim=-1, keepdim=True)).to(getattr(torch, dtype))
    ok = torch.rand(5000, 2, generator=gen, device="cuda") > 0.3
    q = e[7, 1].float()
    chip_smoke.check_k12(f"K12 D={d}", FS.fused_scores_kernel(
        q, e, ok, 0.3, 0.7), q, e, ok, 0.3, 0.7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k12_rules_and_the_ge_fault(cuda, dtype):
    """The rule rows come out exactly; a kernel that compared with >=
    (run here as K12 at the next float32 below the threshold, which gives
    the same verdicts as >= on these exact values) fails the check."""
    import numpy as np
    from multimodal_audio_search_tpu_torch.ops import fused_search as FS
    q, e, ok, want = chip_smoke.k12_rule_inputs(dtype)
    thr = chip_smoke.K12_RULE_THRESHOLD
    chip_smoke.check_k12_rules("K12", FS.fused_scores_kernel(
        q, e, ok, 0.5, 0.5, threshold=thr), want)
    below = float(np.nextafter(np.float32(thr), np.float32(0)))
    with pytest.raises(AssertionError, match="validity rules"):
        chip_smoke.check_k12_rules("K12 >=", FS.fused_scores_kernel(
            q, e, ok, 0.5, 0.5, threshold=below), want)


@pytest.mark.parametrize("rows,cols,passes", [(1, 8, 1), (1000, 128, 3),
                                              (4099, 512, 2), (333, 264, 1),
                                              (70000, 2048, 1)])
def test_k13_matches_plain(cuda, rows, cols, passes):
    """K13 at ragged shapes: every column sum within K13_RTOL; one launch;
    stream_read keeps the first 128 sums, as the TPU kernel does."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import stream_read as SR
    gen = torch.Generator(device="cuda").manual_seed(rows)
    x = torch.rand(rows, cols, generator=gen, device="cuda").to(
        torch.bfloat16)
    runtime.reset_counts()
    got = SR.stream_read_sums(x, passes)
    torch.cuda.synchronize()
    assert runtime.COUNTS["stream_read"] == 1
    chip_smoke.check_k13(f"K13 {rows}x{cols}", got,
                         SR.stream_read_sums_plain(x, passes))
    if cols >= 128:
        assert SR.stream_read(x, passes).shape == (1, 128)


def test_k13_check_sees_128_column_reads(cuda):
    """A planted fault: sums of the first 128 columns only (what a kernel
    reading just the columns it returns computes). Its [1, 128] output
    matches; chip_smoke's check over all columns rejects it."""
    from multimodal_audio_search_tpu_torch.ops import stream_read as SR
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(4096, 512, generator=gen, device="cuda").to(
        torch.bfloat16)
    ref = SR.stream_read_sums_plain(x, 2)
    chip_smoke.check_k13("K13", SR.stream_read_sums(x, 2), ref)
    faulty = torch.zeros_like(ref)
    faulty[:128] = SR.stream_read_sums(x[:, :128].contiguous(), 2)
    chip_smoke.check_k13("K13 first 128", faulty[:128], ref[:128])
    with pytest.raises(AssertionError, match="column sums"):
        chip_smoke.check_k13("K13 128 columns read", faulty, ref)


@pytest.mark.parametrize("b,t,label", [(1, 1, "tiny"), (3, 77, "base"),
                                       (5, 1500, "tiny"), (32, 1500, "base"),
                                       (3, 100, "small"), (2, 50, "large")])
def test_k14_matches_plain(cuda, b, t, label):
    """K14 at ragged B and T, the engine's two widths and whisper-small's
    and large's, on chip_smoke's "block" and "attention" inputs, held by
    its checks; one launch each."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    widths = {w[0]: w for w in chip_smoke.DEC_WIDTHS}
    widths.update(small=("small", 768, 12, 3072),
                  large=("large", 1280, 20, 5120))
    _, d, heads, f = widths[label]
    gen = torch.Generator().manual_seed(b * t)
    for inputs in ("block", "attention"):
        args = chip_smoke.k14_inputs(gen, b, t, d, f,
                                     attention_only=inputs == "attention")
        runtime.reset_counts()
        got = DB.fused_cross_mlp_block(*args, heads=heads)
        torch.cuda.synchronize()
        assert runtime.COUNTS["cross_mlp_block"] == 1
        assert sum(runtime.COUNTS.values()) == 1
        ref = DB.cross_mlp_block_plain(*args, heads=heads)
        assert got.dtype == torch.bfloat16 and got.shape == (b, d)
        if inputs == "block":
            chip_smoke.check_delta("K14", got, ref, args[0])
        else:
            chip_smoke.check_rel("K14", got, ref, chip_smoke.K1_Y_MAX,
                                 chip_smoke.K1_Y_L2)
            chip_smoke.check_bits("K14", got, ref)


@pytest.mark.parametrize("b,t,label", [(3, 77, "base"), (2, 1501, "tiny"),
                                       (1, 129, "large")])
def test_k14_every_cluster_size(cuda, b, t, label):
    """K14's attention on every cluster size (1 to 16 blocks: at T=77 and
    129 the last ranks hold no key), on the "attention" input, held by
    chip_smoke's bit check and check_rel; one launch each."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    widths = {w[0]: w for w in chip_smoke.DEC_WIDTHS}
    widths.update(large=("large", 1280, 20, 5120))
    _, d, heads, f = widths[label]
    gen = torch.Generator().manual_seed(700 + t)
    args = chip_smoke.k14_inputs(gen, b, t, d, f, attention_only=True)
    ref = DB.cross_mlp_block_plain(*args, heads=heads)
    for c in range(1, DB.X_MAX_CLUSTER + 1):
        runtime.reset_counts()
        got = DB._launch_cross_mlp(*args, heads, 1e-5, cluster=c)
        torch.cuda.synchronize()
        assert runtime.COUNTS["cross_mlp_block"] == 1
        assert sum(runtime.COUNTS.values()) == 1
        chip_smoke.check_rel(f"K14 cluster {c}", got, ref,
                             chip_smoke.K1_Y_MAX, chip_smoke.K1_Y_L2)
        chip_smoke.check_bits(f"K14 cluster {c}", got, ref)


def test_k14_raises_on_a_plan_the_card_or_kernel_refuses(cuda, monkeypatch):
    """No fallback for K14's attention: a cluster past 16 blocks, a block
    past its shared memory (the card's fit is 0 there, and a plan with no
    size the card places raises), and a plan outside the kernel's rules
    (ranks that leave keys uncovered) each raise, counting no launch."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    gen = torch.Generator().manual_seed(17)
    args = chip_smoke.k14_inputs(gen, 2, 77, 384, 1536)
    fit = DB._fit_cross(args[0].device)
    assert fit(1, 50000) == 0 and fit(2, 39) > 0   # 200 KB of logits
    with pytest.raises(ValueError):
        DB._launch_cross_mlp(*args, 6, 1e-5, cluster=17)
    with pytest.raises(ValueError):
        DB.cross_plan(77, 6, 2, lambda cs, chunk: 0)
    monkeypatch.setattr(DB, "cross_plan", lambda *a, **k: (2, 30))
    runtime.reset_counts()
    with pytest.raises(RuntimeError, match="mas_cross_mlp_block"):
        DB._launch_cross_mlp(*args, 6, 1e-5, cluster=2)
    assert sum(runtime.COUNTS.values()) == 0


def test_new_wrappers_raise_instead_of_falling_back(cuda):
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    from multimodal_audio_search_tpu_torch.ops import fused_search as FS
    from multimodal_audio_search_tpu_torch.ops import stream_read as SR
    q, e, ok = chip_smoke.k12_inputs(100, "float32")
    with pytest.raises(ValueError):                   # D * 4 not 16-byte
        FS.fused_scores_kernel(q[:6], e[..., :6].contiguous(), ok, 0.5, 0.5)
    with pytest.raises(ValueError):                   # success as float
        FS.fused_scores_kernel(q, e, ok.float(), 0.5, 0.5)
    with pytest.raises(TypeError):                    # a float32 slab
        SR.stream_read_sums(torch.ones(8, 128, device="cuda"), 1)
    with pytest.raises(ValueError):                   # cols % 8 != 0
        SR.stream_read_sums(torch.ones(8, 12, device="cuda",
                                       dtype=torch.bfloat16), 1)
    gen = torch.Generator().manual_seed(0)
    args = list(chip_smoke.k14_inputs(gen, 2, 10, 384, 1536))
    with pytest.raises(TypeError):                    # float32 x
        DB.fused_cross_mlp_block(args[0].float(), *args[1:], heads=6)
    with pytest.raises(ValueError):                   # head dim 96
        DB.fused_cross_mlp_block(*args, heads=4)


def test_calibrate_rates(cuda):
    """calibrate() on the card: positive rates, the read rate under the
    data sheet's 3,350 GB/s (with 5 % for the clock), K13 launched as
    often as the search tool expects."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.utils import calibrate as CAL
    runtime.reset_counts()
    cal = CAL.calibrate("cuda")
    assert runtime.COUNTS["stream_read"] == CAL.STREAM_READ_LAUNCHES
    assert set(cal) == {"tflops_bf16", "hbm_gbps", "h2d_mbps"}
    assert all(v > 0 for v in cal.values()), cal
    assert cal["hbm_gbps"] < 3350 * 1.05, cal


def test_search_batch_on_card_matches_search(cuda):
    """FusionSearcher on the card with a MiniLM embedder: search_batch
    gives search's ids and scores per query, with the float32 and the
    bfloat16 index; a segment's own text finds it first."""
    import numpy as np
    from multimodal_audio_search_tpu_torch.config import FusionConfig
    from multimodal_audio_search_tpu_torch.index.search import (
        FusionSearcher)
    from multimodal_audio_search_tpu_torch.index.store import SegmentStore
    from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    emb = TextEmbedder(cfg=PRESETS["test"], device="cuda")
    store = SegmentStore(embed_dim=64, keep_audio=False)
    texts = [f"segment number {i} with words" for i in range(40)]
    vecs = emb(texts)
    for i, t in enumerate(texts):      # a third without an audio slot
        store.add({"asr_text": t}, vecs[i], vecs[i] if i % 3 else None)
    queries = [texts[5], "words", "number 12"]
    for dt in ("float32", "bfloat16"):
        s = FusionSearcher(store, emb, cfg=FusionConfig(index_dtype=dt))
        batch = s.search_batch(queries)
        for qt, (hits, _) in zip(queries, batch):
            single, _ = s(qt)
            assert [h["index"] for h in hits] == [h["index"] for h in single]
            assert [h["fusion_score"] for h in hits] == pytest.approx(
                [h["fusion_score"] for h in single], abs=1e-5)
        top = batch[0][0][0]
        assert top["index"] == 5 and top["asr_similarity"] > 0.999
        assert store.device_index(emb.device, s.index_dtype)[0].dtype == \
            getattr(torch, dt)


# ------------------ K5 / K6 / K7 float32 forms (the float32 int8 engines)
# (M, K, N, output, bias, splits): the skinny FFMA kernel at the decode
# layers' shapes of both widths, at forced split counts (1, 3, and 8 over
# [2048, 512]) and ragged M, N and K; the FFMA table kernel at the
# vocabulary's odd N at every Whisper width, a ragged last chunk and row
# block, a partial K piece and a row padded to 16 codes; the 2xTF32 wide
# kernel at the cross K/V projection's B*1500 rows and at a ragged M, a
# partial column block, a last K tile of 8 and the smallest shape
K5_F32_CASES = [
    (32, 512, 512, "f32", True, None), (32, 512, 2048, "f32", True, None),
    (32, 2048, 512, "f32", True, None), (32, 384, 1536, "f32", True, None),
    (32, 1536, 384, "f32", True, 1), (32, 2048, 512, "f32", True, 8),
    (9, 256, 336, "bf16", True, 3), (33, 136, 48, "f32", False, None),
    (32, 512, 51865, "f32", False, None), (32, 384, 51865, "f32", False, None),
    (32, 1280, 51865, "f32", False, None), (1, 64, 51865, "f32", False, None),
    (33, 1040, 333, "f32", True, None), (4, 136, 130, "bf16", False, None),
    (48000, 512, 512, "f32", True, None), (48000, 384, 384, "f32", True, None),
    (130, 520, 400, "f32", True, None), (300, 384, 384, "bf16", True, None),
    (65, 64, 16, "f32", False, None)]


def _check_k5_f32(name, got, ref):
    """K5's float32 form against its plain version: float32 outputs at
    [f32]'s F32_BLOCK_ATOL / RTOL, bf16 ones by check_k5 (one bf16 step)."""
    if got.dtype == torch.bfloat16:
        return chip_smoke.check_k5(name, got, ref)
    return chip_smoke.check_close(name, got, ref, chip_smoke.F32_BLOCK_ATOL,
                                  chip_smoke.F32_BLOCK_RTOL)


@pytest.mark.parametrize("m,k,n,dt,bias,splits", K5_F32_CASES)
def test_k5_float32_matches_plain(cuda, m, k, n, dt, bias, splits):
    """K5's float32 form (x and bias float32) in each regime of its plan,
    held to the plain version; one launch of the float32 symbol a call,
    counted as K5's, the arrival counters left zero; the table kernel on
    the transposed copy the model holds; 16 more launches bit-equal."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    out_dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator().manual_seed(m + k + n)
    x, wq, scale, b = chip_smoke.k5_inputs(gen, m, k, n, bias=bias,
                                           dtype=torch.float32)
    p = {"wq": wq, "scale": scale, **({"b": b} if bias else {})}
    if n % 16:
        p = Q.logits_table(p)

    def call():
        if splits is not None:
            return Q._launch(x, wq, scale, b, out_dtype, splits=splits)
        return Q.quant_dense_apply(p, x, out_dtype=out_dtype)
    runtime.reset_counts()
    got = call()
    torch.cuda.synchronize()
    assert runtime.COUNTS["quant_matmul"] == 1
    assert sum(runtime.COUNTS.values()) == 1
    scratch = Q._SCRATCH.get(x.device)
    assert scratch is None or int(scratch[3].abs().sum()) == 0
    assert got.dtype == out_dtype and got.shape == (m, n)
    _check_k5_f32(f"K5 float32 {m}x{k}x{n}", got,
                  chip_smoke.k5_plain(x, wq, scale, b, out_dtype))
    chip_smoke.check_repeats(f"K5 float32 {m}x{k}x{n}", call, got,
                             chip_smoke.F32_REPEATS)


def test_k5_float32_table_limit(cuda):
    """The float32 table kernel takes K up to TABLE_MAX_K_F32 (1280) and
    raises a ValueError naming the limit past it, before any launch."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    gen = torch.Generator().manual_seed(3)
    x, wq, scale, _ = chip_smoke.k5_inputs(gen, 2, 1296, 100, bias=False,
                                           dtype=torch.float32)
    runtime.reset_counts()
    with pytest.raises(ValueError, match="K <= 1280"):
        Q.quant_dense_apply(Q.logits_table({"wq": wq, "scale": scale}), x)
    assert runtime.COUNTS["quant_matmul"] == 0


@pytest.mark.parametrize("fault", ["split", "tile"])
def test_k5_float32_check_sees_a_dropped_split_or_tile(cuda, fault):
    """Planted faults: the float32 skinny kernel at [2048, 512] (8 splits)
    on x with split 7's K columns zeroed, and the 2xTF32 wide kernel at
    48,000 rows on x with its last 64-deep K tile zeroed, compute what a
    kernel that left that split or tile out computes; the check rejects
    both and passes the kernels on x."""
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    gen = torch.Generator().manual_seed(16)
    m, k = (32, 2048) if fault == "split" else (48000, 512)
    x, wq, scale, b = chip_smoke.k5_inputs(gen, m, k, 512,
                                           dtype=torch.float32)
    ref = chip_smoke.k5_plain(x, wq, scale, b, torch.float32)
    _check_k5_f32("K5 float32", Q._launch(x, wq, scale, b, torch.float32),
                  ref)
    if fault == "split":
        _, _, splits, steps = Q.split_plan(m, k, 512, f32=True)
        assert splits == 8
        k0, width = 7 * steps * Q.SB_K, steps * Q.SB_K
    else:
        assert Q.split_plan(m, k, 512, f32=True)[0] == "wide"
        k0, width = k - 64, 64
    xd = x.clone()
    xd[:, k0:k0 + width] = 0
    with pytest.raises(AssertionError, match="outside atol"):
        _check_k5_f32(f"K5 float32 {fault} dropped",
                      Q._launch(xd, wq, scale, b, torch.float32), ref)


@pytest.mark.parametrize("b,t,heads,pos", [(1, 1, 2, None), (3, 97, 6, 50),
                                           (32, 1500, 8, None),
                                           (32, 1500, 6, 999),
                                           (5, 200, 8, 0)])
def test_k6_float32_matches_plain(cuda, b, t, heads, pos):
    """K6's float32 form (q float32, quantized in the kernel with B6's
    true division) against the plain version on the same q; one launch
    of the float32 symbol, counted as K6's; 16 more bit-equal."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    gen = torch.Generator().manual_seed(t + heads)
    args = chip_smoke.k6_inputs(gen, b, t, heads, dtype=torch.float32)
    assert args[0].dtype == torch.float32

    def call():
        return CX.fused_single_query_attention_int8(*args, heads=heads,
                                                    pos=pos)
    runtime.reset_counts()
    got = call()
    torch.cuda.synchronize()
    assert runtime.COUNTS["single_query_attention_int8"] == 1
    assert sum(runtime.COUNTS.values()) == 1
    assert got.dtype == torch.float32 and got.shape == (b, heads * 64)
    chip_smoke.check_rel("K6 float32", got,
                         CX.single_query_attention_int8_plain(
                             *args, heads=heads, pos=pos),
                         chip_smoke.F32_INT8_ATT_MAX,
                         chip_smoke.F32_INT8_ATT_L2)
    chip_smoke.check_repeats("K6 float32", call, got, chip_smoke.F32_REPEATS)


@pytest.mark.parametrize("group,cluster,t,pos", [
    (1, 16, 7, None), (2, 4, 1501, 3), ("H", 8, 1500, 999)])
def test_k6_float32_cluster_layouts(cuda, group, cluster, t, pos):
    """K6's float32 form at forced head layouts and cluster sizes (ranks
    without keys), against the plain version."""
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    gen = torch.Generator().manual_seed(t)
    args = chip_smoke.k6_inputs(gen, 3, t, 6, dtype=torch.float32)
    n = t if pos is None else pos + 1
    got = CX._launch_int8(*args, 6, n, 6 if group == "H" else group, cluster)
    chip_smoke.check_rel(f"K6 float32 G={group} cs={cluster}", got,
                         CX.single_query_attention_int8_plain(
                             *args, heads=6, pos=pos),
                         chip_smoke.F32_INT8_ATT_MAX,
                         chip_smoke.F32_INT8_ATT_L2)


@pytest.mark.parametrize("b,t,heads,cluster", [
    (1, 1, 2, None), (3, 97, 6, None), (32, 1500, 8, None),
    (32, 1500, 6, None), (3, 7, 2, 8), (3, 1501, 2, None)])
def test_k7_float32_matches_plain(cuda, b, t, heads, cluster):
    """K7's float32 form (q float32, rounded to bf16 as it is read, as B7
    rounds it) against the plain version on the same q; one launch of the
    float32 symbol, counted as K7's; 16 more bit-equal."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    gen = torch.Generator().manual_seed(t * heads)
    args = chip_smoke.k7_inputs(gen, b, t, heads, dtype=torch.float32)

    def call():
        return CA._launch(*args, cluster=cluster)
    runtime.reset_counts()
    got = call()
    torch.cuda.synchronize()
    assert runtime.COUNTS["int8_cached_attention"] == 1
    assert sum(runtime.COUNTS.values()) == 1
    assert got.dtype == torch.float32 and got.shape == (b, heads, 64)
    chip_smoke.check_rel("K7 float32", got,
                         CA.int8_cached_attention_plain(*args),
                         chip_smoke.F32_INT8_ATT_MAX,
                         chip_smoke.F32_INT8_ATT_L2)
    chip_smoke.check_repeats("K7 float32", call, got, chip_smoke.F32_REPEATS)


@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_k6_k7_float32_checks_see_a_dropped_rank(cuda, kernel):
    """A planted fault: K6's and K7's float32 forms at B=32, T=1500, H=8
    with the plan's cluster, run with the V codes of rank 1's keys
    zeroed, compute what a cluster that left rank 1's partial out of rank
    0's sum computes; the check rejects both and passes the kernels on
    the true V."""
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    gen = torch.Generator().manual_seed(17)
    if kernel == "K6":
        q, k8, ks, v8, vs = chip_smoke.k6_inputs(gen, 32, 1500, 8,
                                                 dtype=torch.float32)
        _, cs, chunk = CX.int8_plan(1500, 8, 32, CX._fit_int8(q.device))

        def fn(v):
            return CX.fused_single_query_attention_int8(q, k8, ks, v, vs,
                                                        heads=8)
        ref = CX.single_query_attention_int8_plain(q, k8, ks, v8, vs,
                                                   heads=8)
    else:
        q, k8, ks, v8, vs = chip_smoke.k7_inputs(gen, 32, 1500, 8,
                                                 dtype=torch.float32)
        cs, chunk = CA.cluster_plan(1500, None, 32 * 8, CA._fit(q.device))

        def fn(v):
            return CA.int8_cached_attention(q, k8, ks, v, vs)
        ref = CA.int8_cached_attention_plain(q, k8, ks, v8, vs)
    assert cs > 1
    chip_smoke.check_rel(kernel, fn(v8), ref, chip_smoke.F32_INT8_ATT_MAX,
                         chip_smoke.F32_INT8_ATT_L2)
    vd = v8.clone()
    if kernel == "K6":
        vd[:, chunk:2 * chunk] = 0
    else:
        vd[:, :, chunk:2 * chunk] = 0
    with pytest.raises(AssertionError, match="off its plain version"):
        chip_smoke.check_rel(f"{kernel} float32 rank 1 dropped", fn(vd), ref,
                             chip_smoke.F32_INT8_ATT_MAX,
                             chip_smoke.F32_INT8_ATT_L2)
