"""K1 and K2 of the PyTorch package, held to the JAX package's Pallas
kernels on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version (a
CUDA kernel has no interpret mode); the Pallas kernels run in interpret
mode, as the JAX package's own tests run them. Inputs come from numpy
with a seed and feed both. Float32 throughout; tolerance 2e-5 absolute
(float32 summation order differs between the two frameworks, the math
is the same). The card-side check of each kernel against this plain
version is tests/test_torch_cuda.py and chip_smoke.py; the last is held
here to faults planted in a float32 emulation of K1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops.cross_attention import (
    fused_single_query_attention as jax_sqa, xla_single_query_attention)
from multimodal_audio_search_tpu.ops.encoder_block import (
    fused_attention_o_residual as jax_attn_o)
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
from multimodal_audio_search_tpu_torch.ops import encoder_block as K1

torch.set_num_threads(1)
TOL = 2e-5


def _k1_inputs(rng, b, heads, t, d, hd_scale=1.0):
    hd = heads * d
    q, k, v = (rng.normal(size=(b, heads, t, d)).astype(np.float32)
               for _ in range(3))
    x = rng.normal(size=(b, t, hd)).astype(np.float32)
    wo = (rng.normal(size=(hd, hd)) * hd_scale / np.sqrt(hd)) \
        .astype(np.float32)
    bo = rng.normal(size=(hd,)).astype(np.float32) * 0.1
    return q, k, v, x, wo, bo


@pytest.mark.parametrize("b,heads,t,d,blk_q", [
    (2, 4, 40, 16, 16),     # T not a multiple of blk_q: padded keys masked
    (1, 2, 21, 8, 16),      # ragged, two heads
    (2, 3, 64, 16, 64),     # one query block per row (the deferred-/l form)
    (1, 2, 97, 64, 32),     # the production head dim
])
def test_k1_plain_matches_pallas(rng, b, heads, t, d, blk_q):
    q, k, v, x, wo, bo = _k1_inputs(rng, b, heads, t, d)
    ref = jax_attn_o(*(jnp.asarray(a) for a in (q, k, v, x, wo, bo)),
                     blk_q=blk_q, interpret=True)
    runtime.reset_counts()
    got = K1.fused_attention_o_residual(
        *(torch.from_numpy(a) for a in (q, k, v, x, wo, bo)))
    assert got.shape == (b, t, heads * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    # a CPU tensor takes the plain version and launches nothing
    assert runtime.COUNTS["encoder_attn_o_residual"] == 0


def test_k1_takes_head_split_views(rng):
    """The encoder hands K1 the head-split VIEWS of the q/k/v dense
    outputs ([B, T, H*D] -> [B, H, T, D] without a copy); the result must
    equal the contiguous-input one."""
    b, heads, t, d = 2, 4, 33, 16
    q, k, v, x, wo, bo = _k1_inputs(rng, b, heads, t, d)
    merged = [torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3).reshape(b, t, heads * d))) for a in (q, k, v)]
    views = [m.reshape(b, t, heads, d).transpose(1, 2) for m in merged]
    assert not views[0].is_contiguous()
    args = [torch.from_numpy(a) for a in (x, wo, bo)]
    got = K1.fused_attention_o_residual(*views, *args)
    ref = K1.fused_attention_o_residual(
        *(torch.from_numpy(a) for a in (q, k, v)), *args)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


def _k1_kernel_numerics(q, k, v, wo, *, pad=0, normalise=True):
    """K1's attention term y = attn @ Wo with the kernel's roundings (P
    in bf16 before PV, 1/l after it, attn and y in bf16), and on request
    a planted fault: ``pad`` zero keys left unmasked, or no 1/l."""
    q, k, v = q.float(), k.float(), v.float()
    if pad:
        k, v = (torch.cat([a, a.new_zeros(*a.shape[:2], pad, a.shape[3])],
                          dim=2) for a in (k, v))
    s = q @ k.transpose(-1, -2) / np.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = p.to(torch.bfloat16).float() @ v
    if normalise:
        o = o / p.sum(-1, keepdim=True)
    b, h, t, d = q.shape
    attn = o.transpose(1, 2).reshape(b, t, h * d).to(torch.bfloat16)
    return (attn.float() @ wo.float()).to(torch.bfloat16)


@pytest.mark.parametrize("fault", [None, "pad keys unmasked", "no 1/l"])
def test_k1_card_check_rejects_planted_faults(fault):
    """chip_smoke.py's K1 check at the main path's T=1500 (not a multiple
    of the kernel's 64-key tile): the kernel's own roundings pass, and a
    kernel that left the 36 zero-padded keys unmasked, or skipped the 1/l,
    fails it."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, x, wo, bo = chip_smoke.k1_inputs(gen, 1, 1500, 2,
                                              residual=False, device="cpu")
    ref = K1.attention_o_residual_plain(q, k, v, x, wo, bo)
    got = _k1_kernel_numerics(q, k, v, wo,
                              pad=36 if fault == "pad keys unmasked" else 0,
                              normalise=fault != "no 1/l")
    if fault is None:
        chip_smoke.check_k1("kernel roundings", got, ref, residual=False)
    else:
        with pytest.raises(AssertionError, match="attention term"):
            chip_smoke.check_k1(fault, got, ref, residual=False)


def _k2_inputs(rng, b, t, heads, d):
    hd = heads * d
    q = rng.normal(size=(b, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, t, hd)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("pos", [None, 0, 9, 19])
def test_k2_plain_matches_pallas_and_xla(rng, pos):
    """Cross (pos=None: all keys) and causal self attention over a cache
    (pos = first, middle, last row)."""
    b, t, heads, d = 3, 20, 4, 16
    q, k, v = _k2_inputs(rng, b, t, heads, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jpos = None if pos is None else jnp.int32(pos)
    ref_pallas = np.asarray(jax_sqa(jq, jk, jv, heads=heads, pos=jpos,
                                    interpret=True))
    ref_xla = np.asarray(xla_single_query_attention(
        jq, jk, jv, heads=heads, pos=jpos))
    runtime.reset_counts()
    got = K2.fused_single_query_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), heads=heads, pos=pos)
    assert got.shape == (b, heads * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref_pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), ref_xla, atol=TOL, rtol=TOL)
    assert runtime.COUNTS["single_query_attention"] == 0


def test_k2_pos_zero_returns_first_value_row(rng):
    """At pos=0 only key 0 is visible: the output is V's first row."""
    q, k, v = _k2_inputs(rng, 2, 7, 2, 8)
    got = K2.fused_single_query_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), heads=2, pos=0)
    np.testing.assert_allclose(got.numpy(), v[:, 0], atol=1e-6)


def test_k2_rejects_pos_outside_cache(rng):
    q, k, v = (torch.from_numpy(a) for a in _k2_inputs(rng, 1, 5, 2, 8))
    with pytest.raises(ValueError):
        K2.fused_single_query_attention(q, k, v, heads=2, pos=5)


def test_merge_heads_kv_is_dense_layout(rng):
    k = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    km, vm = K2.merge_heads_kv(torch.from_numpy(k), torch.from_numpy(k))
    np.testing.assert_array_equal(
        km.numpy(), k.transpose(0, 2, 1, 3).reshape(2, 5, 12))
