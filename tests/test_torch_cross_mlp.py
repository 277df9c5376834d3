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


def _emulate(args, heads, fault=None):
    """K14's arithmetic in float64 with the twin's bf16 roundings (so only
    the order and precision of the sums differ from the twin), and on
    request a planted fault: "divide before PV" (p / l rounded to bf16,
    then PV) or "p unrounded" (PV on unrounded p)."""
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
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if fault == "divide before PV":
        of = torch.einsum("bht,bthd->bhd", r(p / l), vh)
    elif fault == "p unrounded":
        of = torch.einsum("bht,bthd->bhd", p, vh) / l
    else:
        of = torch.einsum("bht,bthd->bhd", r(p), vh) / l
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
