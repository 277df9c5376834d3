"""K3 and K4 of the PyTorch package (ops/decoder_block.py), held to the
JAX package's Pallas kernels B3, B5a, B4 and B5b on the CPU, and the
fused decode step held to the JAX decode step.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version (a
CUDA kernel has no interpret mode); the Pallas kernels run in interpret
mode, as the JAX package's own tests run them. Inputs come from numpy
with a seed and feed both, float32 throughout. Tolerances: 2e-5 on the
self blocks and 3e-5 on the MLP blocks (the JAX package's own bars in
tests/test_cross_attention.py; float32 summation order differs, and the
MLP's A&S erf enters both sides), 5e-5 on decode-step logits.

The card's check functions (chip_smoke.check_delta and check_close) are
held to faults planted in a bf16-rounding emulation of the kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.ops import decoder_block as JDB
from multimodal_audio_search_tpu_torch import runtime, weights
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.ops import decoder_block as DB

torch.set_num_threads(1)
CPU = torch.device("cpu")
SELF_TOL, MLP_TOL = 2e-5, 3e-5
D, HEADS, F, L = 64, 4, 128, 12


def _self_inputs(rng, b, l=L, d=D, x_scale=1.0):
    """B3/B5a inputs as numpy float32: x, the self weights, the tail's
    weights and a random cache."""
    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)
    w = 1 / np.sqrt(d)
    selfw = [n(d, s=0.2) + 1, n(d, s=0.2), n(d, d, s=w), n(d, s=0.1),
             n(d, d, s=w), n(d, d, s=w), n(d, s=0.1), n(d, d, s=w),
             n(d, s=0.1)]
    tail = [n(d, s=0.2) + 1, n(d, s=0.2), n(d, d, s=w), n(d, s=0.1)]
    return n(b, d, s=x_scale), selfw, tail, n(b, l, d), n(b, l, d)


def _mlp_inputs(rng, b, d=D, f=F):
    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)
    x, attn = n(b, d), n(b, d)
    head = [n(d, d, s=1 / np.sqrt(d)), n(d, s=0.1)]
    mlp = [n(d, s=0.2) + 1, n(d, s=0.2), n(d, f, s=1 / np.sqrt(d)),
           n(f, s=0.5), n(f, d, s=1 / np.sqrt(f)), n(d, s=0.1)]
    return x, attn, head, mlp


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("pos", [0, 5, L - 1])
def test_self_block_plain_matches_pallas(rng, b, pos):
    x, selfw, _, kc, vc = _self_inputs(rng, b)
    ref = JDB.fused_self_block(*_j([x, *selfw, kc, vc]), jnp.int32(pos),
                               heads=HEADS, interpret=True)
    got = DB.self_block_plain(*_t([x, *selfw, kc, vc]), pos, heads=HEADS)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=SELF_TOL,
                                   rtol=SELF_TOL)


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("pos", [0, 5, L - 1])
def test_self_block_q_plain_matches_pallas(rng, b, pos):
    x, selfw, tail, kc, vc = _self_inputs(rng, b)
    ref = JDB.fused_self_block_q(*_j([x, *selfw, *tail, kc, vc]),
                                 jnp.int32(pos), heads=HEADS, interpret=True)
    got = DB.self_block_q_plain(*_t([x, *selfw, *tail, kc, vc]), pos,
                                heads=HEADS)
    assert len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=SELF_TOL,
                                   rtol=SELF_TOL)


@pytest.mark.parametrize("b", [8, 16])
def test_mlp_block_plain_matches_pallas(rng, b):
    x, _, _, mlp = _mlp_inputs(rng, b)
    ref = JDB.fused_mlp_block(*_j([x, *mlp]), interpret=True)
    got = DB.mlp_block_plain(*_t([x, *mlp]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=MLP_TOL,
                               rtol=MLP_TOL)


@pytest.mark.parametrize("b", [8, 16])
def test_mlp_block_o_plain_matches_pallas(rng, b):
    x, attn, head, mlp = _mlp_inputs(rng, b)
    ref = JDB.fused_mlp_block_o(*_j([x, attn, *head, *mlp]), interpret=True)
    got = DB.mlp_block_o_plain(*_t([x, attn, *head, *mlp]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=MLP_TOL,
                               rtol=MLP_TOL)


def test_wrappers_write_the_cache_row_and_launch_nothing_on_cpu(rng):
    """The K3 wrappers store k1/v1 into row pos and return views of it;
    the rows t < pos stay; a CPU tensor launches no kernel."""
    x, selfw, tail, kc, vc = _self_inputs(rng, 8)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    runtime.reset_counts()
    xo, k1, v1, qc = DB.fused_self_block_q(*_t([x, *selfw, *tail]), tk, tv,
                                           4, heads=HEADS)
    ref = DB.self_block_q_plain(*_t([x, *selfw, *tail, kc, vc]), 4,
                                heads=HEADS)
    for g, r in zip((xo, k1, v1, qc), ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    assert k1.data_ptr() == tk[:, 4].data_ptr()
    np.testing.assert_array_equal(tk[:, 4].numpy(), ref[1].numpy())
    np.testing.assert_array_equal(tk[:, :4].numpy(), kc[:, :4])
    np.testing.assert_array_equal(tv[:, 5:].numpy(), vc[:, 5:])
    xm, attn, head, mlp = _mlp_inputs(rng, 8)
    torch.testing.assert_close(
        DB.fused_mlp_block_o(*_t([xm, attn, *head, *mlp])),
        DB.mlp_block_o_plain(*_t([xm, attn, *head, *mlp])), atol=0, rtol=0)
    assert set(runtime.COUNTS.values()) == {0}


def test_self_block_at_pos_zero_attends_to_v1_alone(rng):
    """At pos=0 no cache row is visible: every head's attention output is
    v1, whatever the cache holds."""
    x, selfw, _, kc, vc = _self_inputs(rng, 8)
    got = DB.self_block_plain(*_t([x, *selfw, kc, vc]), 0, heads=HEADS)
    g, b, wq, bq, wk, wv, bv, wo, bo = _t(selfw)
    tx = torch.from_numpy(x)
    mu = tx.mean(-1, keepdim=True)
    h = (tx - mu) * torch.rsqrt(tx.var(-1, unbiased=False, keepdim=True)
                                + 1e-5) * g + b
    v1 = h @ wv + bv
    torch.testing.assert_close(got[2], v1, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[0], tx + v1 @ wo + bo, atol=2e-5,
                               rtol=2e-5)


# ------------------------------------------------- the card's checks
def _emulate_k3(x, selfw, kc, vc, pos, heads, fault=None):
    """K3's output with its bf16 roundings, computed in float64 (so only
    the order and precision of the sums differ from the plain version),
    and on request a planted fault:
      "fresh row twice": the row written into the cache before the
          attention AND read there with t <= pos, besides the closed form;
      "fresh row dropped": no closed-form fresh row;
      "mask t <= pos": the unwritten row pos (zeros) attended as well."""
    bf = torch.bfloat16

    def r(a):
        return a.to(bf).double()

    g, b, wq, bq, wk, wv, bv, wo, bo = (a.double() for a in selfw)
    xf = x.double()
    bsz, hd = x.shape
    d = hd // heads
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    h = r((xf - mu) / torch.sqrt(var + 1e-5) * r(g) + r(b))
    q1, k1, v1 = r(h @ r(wq) + r(bq)), r(h @ r(wk)), r(h @ r(wv) + r(bv))
    kcache, vcache = kc.double().clone(), vc.double().clone()
    n = pos
    if fault == "fresh row twice":
        kcache[:, pos], vcache[:, pos] = k1, v1
        n = pos + 1
    elif fault == "mask t <= pos":
        kcache[:, pos] = vcache[:, pos] = 0.0
        n = pos + 1
    qh = q1.reshape(bsz, heads, d)
    kk = kcache[:, :n].reshape(bsz, n, heads, d)
    vv = vcache[:, :n].reshape(bsz, n, heads, d)
    s = torch.einsum("bhd,bthd->bht", qh, kk) / np.sqrt(d)
    ln = r(q1 * k1).reshape(bsz, heads, d).sum(-1) / np.sqrt(d)
    if fault == "fresh row dropped":
        ln = torch.full_like(ln, -np.inf)
    m = torch.maximum(s.amax(-1), ln) if n else ln
    p, pn = torch.exp(s - m[..., None]), torch.exp(ln - m)
    den = p.sum(-1) + pn
    attn = torch.einsum("bht,bthd->bhd", r(p / den[..., None]), vv) \
        + r(pn / den)[..., None] * v1.reshape(bsz, heads, d)
    attn = r(attn.reshape(bsz, hd))
    return (xf + attn @ r(wo) + r(bo)).to(bf), k1.to(bf), v1.to(bf)


@pytest.mark.parametrize("fault", [None, "fresh row twice",
                                   "fresh row dropped", "mask t <= pos"])
def test_k3_card_check_rejects_planted_faults(fault):
    """chip_smoke's K3 check on its own inputs (x ~ 0.01 N(0, 1), so the
    block's term dominates x_out - x) at base width, B=8, L=68: the
    kernel's roundings pass at every pos the script checks, and each
    fault fails at one of them at least."""
    gen = torch.Generator().manual_seed(0)
    failed = []
    for pos in chip_smoke.K3_POS:
        x, selfw, _, kc, vc = chip_smoke.k3_inputs(gen, 8, 68, 512,
                                                   device="cpu")
        ref = DB.self_block_plain(x, *selfw, kc, vc, pos, heads=8)
        got = _emulate_k3(x, selfw, kc, vc, pos, 8, fault)
        try:
            chip_smoke.check_k3(f"K3 pos={pos}", got, ref, x)
        except AssertionError:
            failed.append(pos)
    assert failed == [] if fault is None else failed, failed


@pytest.mark.parametrize("fault", [None, "b1 missing"])
def test_k4_card_check_rejects_planted_faults(fault):
    """chip_smoke's K4 check at base width: float64 sums with the
    kernel's roundings pass; a kernel that leaves out fc1's bias fails."""
    gen = torch.Generator().manual_seed(1)
    x, mlp, _ = chip_smoke.k4_inputs(gen, 8, 512, 2048, device="cpu")
    ref = DB.mlp_block_plain(x, *mlp)
    g, b, w1, b1, w2, b2 = (a.double() for a in mlp)

    def r(a):
        return a.to(torch.bfloat16).double()

    xf = x.double()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    h = r((xf - mu) / torch.sqrt(var + 1e-5) * r(g) + r(b))
    u = h @ r(w1) + (0 if fault else r(b1))
    u = r(0.5 * u * (1 + torch.erf(u / np.sqrt(2))))
    got = (xf + u @ r(w2) + r(b2)).to(torch.bfloat16)
    if fault is None:
        chip_smoke.check_delta("K4", got, ref, x)
    else:
        with pytest.raises(AssertionError, match="off its plain version"):
            chip_smoke.check_delta("K4 b1 missing", got, ref, x)


# ------------------------------------------------------- decode step
@pytest.fixture(scope="module")
def whisper_pair():
    cfg = JW.PRESETS["test"]
    jp = JW.init_params(jax.random.PRNGKey(4), cfg)
    tp = W.prepare_params(weights.whisper_params(jax.tree.map(np.asarray,
                                                              jp)),
                          torch.float32, CPU)
    return cfg, jp, tp


@pytest.mark.parametrize("fused,b", [(True, 8), ("v2", 8), (True, 4)])
def test_fused_decode_step_matches_jax(whisper_pair, rng, fused, b):
    """Six cached decode steps, logits within 5e-5 of the JAX decode step
    with the same ``fused_layer`` (B=4 takes the unfused path in both;
    the JAX "v2" value runs its True branch, see ROADMAP)."""
    cfg, jp, tp = whisper_pair
    enc = rng.normal(size=(b, 100, cfg.d_model)).astype(np.float32)
    jckv = JW.cross_kv(jp, jnp.asarray(enc), cfg)
    tckv = W.cross_kv_merged(tp, torch.from_numpy(enc), cfg)
    jcache = JW.init_cache(cfg, b, 8, jnp.float32)
    tcache = W.init_cache(cfg, b, 8, torch.float32, CPU)
    toks = rng.integers(0, cfg.vocab_size, size=(6, b))
    for pos in range(6):
        jl, jcache = JW.decode_step(jp, jnp.asarray(toks[pos], jnp.int32),
                                    jnp.int32(pos), jcache, jckv, cfg,
                                    fused_layer=fused)
        tl = W.decode_step(tp, torch.from_numpy(toks[pos]).long(), pos,
                           tcache, tckv, cfg, fused_layer=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5)
    np.testing.assert_allclose(tcache[1]["v"].numpy(),
                               np.asarray(jcache[1]["v"]), atol=5e-5)


@pytest.mark.parametrize("fused,b,merged,want", [
    ("v2", 8, True, "v2"),
    ("v2", 8, False, "fused"),      # v2 needs merged cross K/V
    (True, 8, True, "fused"),
    ("v2", 4, True, "plain"),       # B % 8 != 0: the unfused step
])
def test_fused_layer_gates(whisper_pair, rng, monkeypatch, fused, b, merged,
                           want):
    """Which sub-block functions a step calls, per layer."""
    cfg, _, tp = whisper_pair
    calls = []
    for name in ("fused_self_block", "fused_self_block_q",
                 "fused_mlp_block", "fused_mlp_block_o"):
        fn = getattr(DB, name)
        monkeypatch.setattr(DB, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    enc = torch.from_numpy(rng.normal(size=(b, 100, cfg.d_model))
                           .astype(np.float32))
    ckv = (W.cross_kv_merged if merged else W.cross_kv)(tp, enc, cfg)
    cache = W.init_cache(cfg, b, 4, torch.float32, CPU)
    W.decode_step(tp, torch.zeros(b, dtype=torch.long), 0, cache, ckv, cfg,
                  fused_layer=fused)
    per_layer = {"v2": ["fused_self_block_q", "fused_mlp_block_o"],
                 "fused": ["fused_self_block", "fused_mlp_block"],
                 "plain": []}[want]
    assert calls == per_layer * cfg.dec_layers
