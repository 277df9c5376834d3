"""K2's split-T arithmetic, emulated in float64 on the CPU.

K2 (csrc/cross_attention.cu) splits the keys 0..n_valid-1 of each
(batch, head) into ``split_plan`` parts; each split keeps an online
softmax state (m, l, acc[64]) and the last split to arrive merges them:
out = sum_i w_i acc_i / sum_i w_i l_i with w_i = exp(m_i - max_j m_j), a
split without a key holding (-inf, 0, 0) and weighing 0. The emulation
below states that arithmetic in float64 and is held to the plain twin
(float32) and to the JAX Pallas kernel in interpret mode, at split edges
and with empty splits. chip_smoke.py's K2 check is then held to two
planted split faults at the main path's B=32, T=1500: the first key of
every split after the first dropped, and the last key of every split but
the last counted twice.
"""
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops.cross_attention import (
    fused_single_query_attention as jax_sqa)
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import cross_attention as K2

torch.set_num_threads(1)
TOL = 2e-5


def emulate_split(q_m, k_m, v_m, heads: int, n_valid: int, splits: int,
                  drop=(), double=()) -> torch.Tensor:
    """K2's split states and last-block merge in float64 ([B, H*64]).
    ``drop`` / ``double``: key indices whose weight is planted as 0 / 2."""
    b, hd = q_m.shape
    d = hd // heads
    chunk = -(-n_valid // splits)
    out = torch.empty(b, hd, dtype=torch.float64)
    w = torch.ones(n_valid, dtype=torch.float64)
    w[list(drop)] = 0.0
    w[list(double)] = 2.0
    for h in range(heads):          # one head at a time keeps float64 small
        cols = slice(h * d, (h + 1) * d)
        q = q_m[:, cols].double()
        k = k_m[:, :n_valid, cols].double()
        v = v_m[:, :n_valid, cols].double()
        s = torch.einsum("bd,btd->bt", q, k) / np.sqrt(d)
        m_i, l_i, a_i = [], [], []
        for i in range(splits):
            t0, t1 = i * chunk, min(n_valid, (i + 1) * chunk)
            if t0 >= t1:             # a split without a key
                m_i.append(torch.full((b,), -np.inf, dtype=torch.float64))
                l_i.append(torch.zeros(b, dtype=torch.float64))
                a_i.append(torch.zeros(b, d, dtype=torch.float64))
                continue
            m = s[:, t0:t1].amax(-1)
            p = torch.exp(s[:, t0:t1] - m[:, None]) * w[t0:t1]
            m_i.append(m)
            l_i.append(p.sum(-1))
            a_i.append(torch.einsum("bt,btd->bd", p, v[:, t0:t1]))
        mx = torch.stack(m_i).amax(0)
        wt = [torch.where(torch.isinf(m), torch.zeros_like(m),
                          torch.exp(m - mx)) for m in m_i]
        ls = sum(x * y for x, y in zip(wt, l_i))
        acc = sum(x[:, None] * y for x, y in zip(wt, a_i))
        out[:, cols] = acc / ls[:, None]
    return out


def _inputs(rng, b, t, heads):
    hd = heads * 64
    return (rng.normal(size=(b, hd)).astype(np.float32),
            rng.normal(size=(b, t, hd)).astype(np.float32),
            rng.normal(size=(b, t, hd)).astype(np.float32))


# (n_valid, forced splits or None for split_plan); T = 300, CHUNK = 128
CASES = [(1, None), (127, None), (128, None), (129, None), (256, None),
         (257, None), (300, None),
         (9, 8),                       # splits 5-7 hold no key
         (99, 3), (100, 3), (101, 3),  # chunk 33 / 34: the edges move
         (299, 7), (300, 7)]


@pytest.mark.parametrize("n_valid,splits", CASES)
def test_split_emulation_matches_plain_and_pallas(rng, n_valid, splits):
    b, t, heads = 2, 300, 2
    q, k, v = _inputs(rng, b, t, heads)
    plan = K2.split_plan(n_valid, b * heads)
    s = plan[0] if splits is None else splits
    if splits is None:
        assert plan == (max(1, -(-n_valid // K2.CHUNK)),
                        -(-n_valid // plan[0]))
    pos = None if n_valid == t else n_valid - 1
    got = emulate_split(*(torch.from_numpy(a) for a in (q, k, v)), heads,
                        n_valid, s)
    runtime.reset_counts()
    plain = K2.fused_single_query_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), heads=heads, pos=pos)
    assert runtime.COUNTS["single_query_attention"] == 0
    pallas = np.asarray(jax_sqa(*(jnp.asarray(a) for a in (q, k, v)),
                                heads=heads,
                                pos=None if pos is None else jnp.int32(pos),
                                interpret=True))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.numpy(), pallas, atol=TOL, rtol=TOL)


def test_split_plan_covers_every_key():
    """Every plan's splits cover 0..n_valid-1 with chunk <= CHUNK while the
    scratch holds the states, and S = 1 at the self-attention lengths."""
    for pairs in (1, 48, 256, K2.STATES):
        for n in (1, 68, 127, 128, 129, 1500, 3000, 20000):
            s, chunk = K2.split_plan(n, pairs)
            assert s >= 1 and s * chunk >= n
            assert s == 1 or pairs * s <= K2.STATES
            if pairs * -(-n // K2.CHUNK) <= K2.STATES:
                assert chunk <= K2.CHUNK
    assert K2.split_plan(68, 256) == (1, 68)
    assert K2.split_plan(1500, 256) == (12, 125)


@pytest.fixture(scope="module")
def main_path_k2():
    """chip_smoke's cross case (B=32, T=1500, H=8) on the CPU: its inputs,
    the plain version's output, and the split plan."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = chip_smoke.k2_inputs(gen, 32, 1500, 8, device="cpu")
    ref = K2.single_query_attention_plain(q, k, v, heads=8)
    return q, k, v, ref, K2.split_plan(1500, 32 * 8)


@pytest.mark.parametrize("fault", [None, "boundary key dropped",
                                   "boundary key counted twice"])
def test_k2_card_check_rejects_split_faults(main_path_k2, fault):
    """chip_smoke's K2 check (K2_ATOL, K2_RTOL) passes the split arithmetic
    and rejects each planted split fault (readings in chip_smoke.py)."""
    q, k, v, ref, (s, chunk) = main_path_k2
    edges = [i * chunk for i in range(1, s)]
    got = emulate_split(q, k, v, 8, 1500, s,
                        drop=edges if fault == "boundary key dropped" else (),
                        double=[e - 1 for e in edges]
                        if fault == "boundary key counted twice" else ())
    if fault is None:
        chip_smoke.check_close("split arithmetic", got, ref, chip_smoke.K2_ATOL,
                               chip_smoke.K2_RTOL)
    else:
        with pytest.raises(AssertionError, match="outside atol"):
            chip_smoke.check_close(fault, got, ref, chip_smoke.K2_ATOL,
                                   chip_smoke.K2_RTOL)


def test_k2_bf16_gap_to_pallas(rng):
    """K2 keeps p and its output in float32 where the TPU kernel rounds p
    to bf16 before PV and writes bf16 (a deliberate difference, ROADMAP
    §3). On bf16 inputs the plain twin (K2's arithmetic) stays within 1 %
    of the output's scale of the Pallas kernel in interpret mode (reads
    2.1e-3 here: one bf16 rounding of the output, 2^-9 = 2.0e-3)."""
    b, t, heads = 3, 300, 4
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(rng, b, t, heads))
    got = K2.fused_single_query_attention(q, k, v, heads=heads)
    ref = torch.from_numpy(np.array(jax_sqa(
        *(jnp.asarray(a.float().numpy(), dtype=jnp.bfloat16)
          for a in (q, k, v)), heads=heads, interpret=True)))
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel < 1e-2


def test_attention_ab_tool_refuses_without_a_card(monkeypatch):
    """tools/torch_attention_ab.py measures the card only: without one it
    exits before it builds or imports anything of the checkout."""
    spec = importlib.util.spec_from_file_location(
        "torch_attention_ab", os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "tools",
            "torch_attention_ab.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["x", "--root", ".", "--label", "t"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        tool.main()
