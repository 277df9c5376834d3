"""Analytic FLOP / HBM-byte models for the production pipeline stages.

A copy of ``multimodal_audio_search_tpu/utils/roofline.py`` (framework
free; ``tests/test_torch_copies.py`` holds it identical). The models count
matrix-unit FLOPs (2*M*N*K per matmul) and the dominant device-memory
streams; the search-at-scale tool (``tools/torch_bench_search_scale.py``)
reads ``search_hbm_bytes`` for the bytes a query's scoring must move.
"""
from __future__ import annotations

from ..models.whisper import WhisperConfig


def encoder_flops(cfg: WhisperConfig, batch: int, mel_frames: int) -> float:
    """Whisper encoder forward FLOPs for a [B, n_mels, mel_frames] input."""
    t1 = mel_frames                     # conv1 stride 1
    s = mel_frames // 2                 # conv2 stride 2 -> seq length
    d, ffn, layers = cfg.d_model, cfg.ffn, cfg.enc_layers
    conv = 2 * batch * t1 * (3 * cfg.n_mels) * d \
        + 2 * batch * s * (3 * d) * d
    qkvo = 4 * 2 * batch * s * d * d
    attn = 2 * 2 * batch * s * s * d            # scores + weighted sum
    mlp = 2 * 2 * batch * s * d * ffn
    return conv + layers * (qkvo + attn + mlp)


def decode_step_flops(cfg: WhisperConfig, batch: int, t_enc: int,
                      cache_len: int) -> float:
    """One KV-cached greedy decode step (all layers + tied logits)."""
    d, ffn, layers = cfg.d_model, cfg.ffn, cfg.dec_layers
    proj = 6 * 2 * batch * d * d                 # self q/k/v/o + cross q/o
    self_attn = 2 * 2 * batch * cache_len * d
    cross_attn = 2 * 2 * batch * t_enc * d
    mlp = 2 * 2 * batch * d * ffn
    logits = 2 * batch * d * cfg.vocab_size
    return layers * (proj + self_attn + cross_attn + mlp) + logits


def decode_step_hbm_bytes(cfg: WhisperConfig, batch: int, t_enc: int,
                          cache_len: int, kv_bytes: int = 2,
                          weight_bytes: int = 2) -> float:
    """Dominant HBM reads per decode step.

    kv_bytes: 2 for bf16 cross-KV, 1 for int8 (per element; int8 adds a
    f32 scale per position, counted below). Weights stream once per step
    (batch=1 reuse in VMEM is not assumed across layers).
    """
    d, ffn, layers = cfg.d_model, cfg.ffn, cfg.dec_layers
    hd = d // cfg.heads
    cross_kv = layers * batch * cfg.heads * t_enc * hd * 2 * kv_bytes
    if kv_bytes == 1:   # int8: + per-(b,h,t) f32 scales for K and V
        cross_kv += layers * batch * cfg.heads * t_enc * 2 * 4
    self_kv = layers * batch * cfg.heads * cache_len * hd * 2 * 2
    weights = layers * (6 * d * d + 2 * d * ffn) * weight_bytes
    logits_table = cfg.vocab_size * d * weight_bytes
    return cross_kv + self_kv + weights + logits_table


def search_hbm_bytes(n_index: int, dim: int, dtype_bytes: int) -> float:
    """Fused search reads the whole [N, 2, dim] index once per query."""
    return n_index * 2 * dim * dtype_bytes
