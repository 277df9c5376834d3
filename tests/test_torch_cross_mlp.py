"""K14 of the PyTorch package (ops/decoder_block.py::fused_cross_mlp_block)
held to the JAX package's Pallas kernel B12 (fused_cross_mlp_block,
interpret mode) on the CPU, and chip_smoke's K14 checks held to faults
planted in emulations of the kernel.

On a CPU tensor the wrapper runs the plain version (a CUDA kernel has no
interpret mode). Inputs come from numpy with a seed and feed both.
Tolerances: 3e-5 at float32 (the JAX package's own bar for this kernel in
tests/test_cross_attention.py: float32 sums in another order, and the
MLP's A&S erf on both sides). In bf16 the twin must round where the
Pallas kernel rounds: on an input whose output is the rounded attention
alone (chip_smoke.k14_inputs(attention_only=True)), the two agree bit for
bit on at least chip_smoke.K14_EQUAL_MIN of the elements, and a twin that
divides by l before PV, or keeps p unrounded, does not.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.ops import decoder_block as JDB
from multimodal_audio_search_tpu.ops.cross_attention import merge_heads_kv
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import decoder_block as DB

torch.set_num_threads(1)
TOL = 3e-5


def tiny_cfg():
    """tests/test_cross_attention.py's tiny config."""
    return JW.WhisperConfig(
        vocab_size=96, d_model=32, enc_layers=1, dec_layers=2, heads=2,
        ffn=64, enc_positions=40, dec_positions=24,
        bos_token_id=90, eos_token_id=91, pad_token_id=91,
        no_timestamps_id=93, transcribe_id=94, lang_en_id=95)


def _block_args(rng, b=8, t=20):
    """The JAX test's inputs: block 0 of a seeded tiny decoder, x and
    per-head K/V ~ N(0, 1) merged to [B, T, H*D]; numpy float32."""
    cfg = tiny_cfg()
    blk = JW.init_params(jax.random.PRNGKey(0), cfg)["decoder"]["blocks"][0]
    hd, heads = cfg.d_model, cfg.heads
    x = rng.normal(size=(b, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, heads, t, hd // heads)).astype(np.float32)
            for _ in range(2))
    k_m, v_m = merge_heads_kv(jnp.asarray(k), jnp.asarray(v))
    c = blk["cross_attn"]
    w = [blk["cross_ln"]["scale"], blk["cross_ln"]["bias"], c["q"]["w"],
         c["q"]["b"], c["o"]["w"], c["o"]["b"], blk["mlp_ln"]["scale"],
         blk["mlp_ln"]["bias"], blk["mlp_in"]["w"], blk["mlp_in"]["b"],
         blk["mlp_out"]["w"], blk["mlp_out"]["b"]]
    return [x, *(np.array(a, np.float32) for a in (*w, k_m, v_m))], heads


def _pallas(args, heads, dtype=jnp.float32):
    return np.asarray(JDB.fused_cross_mlp_block(
        *(jnp.asarray(a, dtype) for a in args), heads=heads,
        interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("t", [20, 37])
def test_k14_plain_matches_pallas_f32(rng, t):
    args, heads = _block_args(rng, t=t)
    ref = _pallas(args, heads)
    got = DB.cross_mlp_block_plain(*map(torch.from_numpy, args), heads=heads)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=1e-5)


def test_k14_wrapper_on_cpu_is_the_plain_version(rng):
    args, heads = _block_args(rng)
    targs = list(map(torch.from_numpy, args))
    runtime.reset_counts()
    torch.testing.assert_close(
        DB.fused_cross_mlp_block(*targs, heads=heads),
        DB.cross_mlp_block_plain(*targs, heads=heads), atol=0, rtol=0)
    assert set(runtime.COUNTS.values()) == {0}


# ------------------------------------------------- the bf16 roundings
def _attention_args(seed=0, b=8, t=20, d=32, f=64):
    """chip_smoke's K14 "attention" input at the tiny width, float32
    arrays holding bf16 values (LN scales kept float32, as the card's
    wrapper takes them)."""
    gen = torch.Generator().manual_seed(seed)
    args = chip_smoke.k14_inputs(gen, b, t, d, f, attention_only=True,
                                 device="cpu")
    return [a.float().numpy() for a in args]


def _emulate(args, heads, fault=None, cs=1):
    """K14's arithmetic in float64 with the twin's bf16 roundings (so only
    the order and precision of the sums differ from the twin): its
    attention split over the keys of a cluster of ``cs`` blocks (rank r
    the keys [r chunk, (r + 1) chunk)), p = exp(logit - m) with the
    global max m the ranks exchange, and each rank's sum of p and p . V
    added in rank order, then divided by l once. On request a planted
    fault: "divide before PV" (p / l rounded to bf16, then PV), "p
    unrounded" (PV on unrounded p), or "split max" (K2's split-T merge:
    each rank rounds p against its own max and rescales its sums by
    exp(m_r - m) afterwards)."""
    def r(a):
        return a.to(torch.bfloat16).double()

    def ln(xf, g, b):
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        return (xf - mu) / torch.sqrt(var + 1e-5) * r(g) + r(b)

    x, g2, b2, wcq, bcq, wco, bco, g3, b3, w1, b1, w2, b2m, k, v = (
        torch.from_numpy(a).double() for a in args)
    b, hd = x.shape
    t, d = k.shape[1], hd // heads
    xf = r(x)
    q1 = r(r(ln(xf, g2, b2)) @ r(wcq) + r(bcq)).reshape(b, heads, d)
    kh, vh = (r(a).reshape(b, t, heads, d) for a in (k, v))
    logits = torch.einsum("bhd,bthd->bht", q1, kh) / math.sqrt(d)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    if fault == "divide before PV":
        of = torch.einsum("bht,bthd->bhd", r(p / l), vh)
    elif fault == "p unrounded":
        of = torch.einsum("bht,bthd->bhd", p, vh) / l
    else:
        chunk = -(-t // cs)
        of, l = 0, 0
        for r0 in range(0, t, chunk):   # the ranks in order
            lg = logits[..., r0:r0 + chunk]
            mr = lg.amax(-1, keepdim=True) if fault == "split max" else m
            pr, w = torch.exp(lg - mr), torch.exp(mr - m)
            l = l + pr.sum(-1, keepdim=True) * w
            of = of + torch.einsum("bht,bthd->bhd", r(pr),
                                   vh[:, r0:r0 + chunk]) * w
        of = of / l
    x1 = xf + r(of.reshape(b, hd)) @ r(wco) + r(bco)
    u = r(ln(x1, g3, b3)) @ r(w1) + r(b1)
    u = r(0.5 * u * (1 + torch.erf(u / math.sqrt(2))))
    return (x1 + u @ r(w2) + r(b2m)).to(torch.bfloat16)


def _bf16_torch(args):
    return [torch.from_numpy(a).to(torch.bfloat16) if i not in (1, 7)
            else torch.from_numpy(a) for i, a in enumerate(args)]


@pytest.mark.parametrize("seed", [0, 1])
def test_k14_plain_rounds_where_pallas_rounds_bf16(seed):
    """bf16 through both on the attention-only input (the output is the
    rounded attention): the twin matches the Pallas kernel bit for bit on
    at least K14_EQUAL_MIN of the elements (chip_smoke's K14 check), and
    both planted roundings fail that check."""
    args, heads = _attention_args(seed), 2
    ref = torch.from_numpy(_pallas(args, heads, jnp.bfloat16))
    got = DB.cross_mlp_block_plain(*_bf16_torch(args), heads=heads)
    assert got.dtype == torch.bfloat16
    chip_smoke.check_bits("K14 twin", got, ref)
    for fault in ("divide before PV", "p unrounded"):
        with pytest.raises(AssertionError, match="bit for bit"):
            chip_smoke.check_bits(f"K14 {fault}",
                                  _emulate(args, heads, fault), ref)


def test_k14_card_checks_reject_planted_faults():
    """chip_smoke's K14 checks on its own inputs at base width (B=8,
    T=1500): a float32 emulation of the kernel with the twin's roundings
    passes both; dividing by l before PV fails the bit check of the
    "attention" input; attending head 0's keys with every head's query
    fails check_delta on the "block" input."""
    gen = torch.Generator().manual_seed(3)
    b, t, d, heads, f = 8, 1500, 512, 8, 2048
    att = chip_smoke.k14_inputs(gen, b, t, d, f, attention_only=True,
                                device="cpu")
    ref = DB.cross_mlp_block_plain(*att, heads=heads)
    arr = [a.float().numpy() for a in att]
    chip_smoke.check_rel("K14", _emulate(arr, heads), ref,
                         chip_smoke.K1_Y_MAX, chip_smoke.K1_Y_L2)
    chip_smoke.check_bits("K14", _emulate(arr, heads), ref)
    with pytest.raises(AssertionError, match="bit for bit"):
        chip_smoke.check_bits("K14 divide before PV",
                              _emulate(arr, heads, "divide before PV"), ref)
    blk = chip_smoke.k14_inputs(gen, b, t, d, f, device="cpu")
    ref = DB.cross_mlp_block_plain(*blk, heads=heads)
    chip_smoke.check_delta("K14", _emulate([a.float().numpy() for a in blk],
                                           heads), ref, blk[0])
    k0 = blk[13].reshape(b, t, heads, 64)[:, :, :1].expand(
        b, t, heads, 64).reshape(b, t, d)
    faulty = DB.cross_mlp_block_plain(*blk[:13], k0, blk[14], heads=heads)
    with pytest.raises(AssertionError, match="off its plain version"):
        chip_smoke.check_delta("K14 head 0's keys", faulty, ref, blk[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_k14_cluster_arithmetic_and_split_max_fault(seed):
    """chip_smoke's bit check on its "attention" input at base width (B=8,
    T=1500): the emulation of K14's split-T cluster (the global max
    exchanged before any p is rounded, the ranks' sums in rank order)
    passes at 125- and 750-key splits (cs 12 and 2) and on one block; K2's
    split-T merge, p rounded against each split's own max and rescaled
    afterwards, fails it. Readings (equal share, limit K14_EQUAL_MIN =
    0.99): the cluster 0.9988 (seed 0) and 1.0 (seed 1) at every cs; the
    split-max merge 0.502-0.509 at cs 12 and 0.567-0.577 at cs 2."""
    gen = torch.Generator().manual_seed(seed)
    b, t, d, heads, f = 8, 1500, 512, 8, 2048
    att = chip_smoke.k14_inputs(gen, b, t, d, f, attention_only=True,
                                device="cpu")
    ref = DB.cross_mlp_block_plain(*att, heads=heads)
    arr = [a.float().numpy() for a in att]
    for cs in (1, 2, 12):
        chip_smoke.check_bits(f"K14 cs={cs}", _emulate(arr, heads, cs=cs),
                              ref)
    for cs in (2, 12):
        with pytest.raises(AssertionError, match="bit for bit"):
            chip_smoke.check_bits(f"K14 split max cs={cs}",
                                  _emulate(arr, heads, "split max", cs), ref)


# clusters of cs K14 attention blocks an H100 80GB HBM3 holds at once at
# T=1500 (mas_cross_mlp_attention_fit through ops/decoder_block.py::
# _fit_cross, PERF.md)
H100_X_FIT = {1: 528, 2: 264, 3: 163, 4: 124, 5: 94, 6: 79, 7: 69, 8: 62,
              9: 51, 10: 44, 11: 37, 12: 37, 13: 30, 14: 30, 15: 28, 16: 28}


@pytest.mark.parametrize("b,heads,t", [
    (32, 8, 1500), (32, 6, 1500), (1, 8, 1500), (3, 6, 77), (5, 6, 1),
    (128, 8, 1500), (2, 20, 12288)])
def test_k14_cross_plan(b, heads, t):
    """K14's attention plan on the H100's recorded cluster occupancy: the
    ranks cover every key once (the last may hold none), a block fits its
    shared memory, and the size is the largest whose b x heads clusters
    are all resident (2 blocks of 750 keys at both Whisper widths, B=32,
    T=1500); past what the card holds at once (B=128), one block a row."""
    fit = (lambda cs, chunk: H100_X_FIT[cs])
    cs, chunk = DB.cross_plan(t, heads, b, fit)
    assert cs * chunk >= t and chunk == -(-t // cs)
    assert DB.cross_smem_bytes(chunk) <= DB.X_SMEM_LIMIT
    resident = [c for c in range(1, DB.X_MAX_CLUSTER + 1)
                if H100_X_FIT[c] >= b * heads
                and c <= max(1, -(-t // DB.X_KEYS_PER_BLOCK))]
    assert cs == (max(resident) if resident else 1)
    if (b, t) == (32, 1500):
        assert (cs, chunk) == (2, 750)


def test_k14_cross_plan_refusals():
    """A cluster past 16 blocks, no key, and a card that places no
    cluster each raise; a forced size is kept."""
    with pytest.raises(ValueError):
        DB.cross_plan(1500, 8, 32, cluster=17)
    with pytest.raises(ValueError):
        DB.cross_plan(0, 8, 32)
    with pytest.raises(ValueError):
        DB.cross_plan(1500, 8, 32, lambda cs, chunk: 0)
    assert DB.cross_plan(1500, 8, 32, cluster=5) == (5, 300)
