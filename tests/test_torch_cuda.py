"""K1 and K2 on the card, against their plain PyTorch versions.

Marked ``requires_cuda``: on a machine without a CUDA card every test
here skips (the card is looked up inside a fixture, never at import).
On the card they build the kernels with nvcc and run them at small
shapes, including the ragged edges the main path's shapes do not reach.
Run them there with ``python -m pytest tests/test_torch_cuda.py -q``.
Inputs and checks are chip_smoke.py's: K1 on a residual input (bf16
output, atol 1e-2 + rtol 1.6e-2) and on inputs with x = 0 and bo = 0 that
isolate the attention term (within 1e-2 of its max and 7e-3 of its
norm); K2 (f32 output, f32 math on the same bf16 inputs) 1e-3.
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


def test_wrappers_raise_instead_of_falling_back(cuda):
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    from multimodal_audio_search_tpu_torch.ops import encoder_block as K1
    q = torch.zeros(2, 128, device="cuda")            # float32: not taken
    kv = torch.zeros(2, 4, 128, device="cuda")
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
