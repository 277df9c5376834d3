"""The port's training subsystem (training/*, models/whisper.py::
decode_train) held to the JAX package's on the CPU at float32, on the
same numbers (the JAX inits carried by weights.py; the optax state by
``weights.opt_state``): decode_train's logits within 5e-5; caption_loss
(with and without label smoothing) within 1e-6 relative and its
gradients within 1e-5 of each leaf's max; the schedules within 1e-7 of
optax's; three train steps with clipping on (losses and grad_norm 1e-5
relative, parameters 1e-5 of each leaf's max); the CLAP step with the
text backbone trained and frozen (its decay included); train_bridge's
epoch losses; three train_synth_captioner steps; and the data axis: a
step split over two CPU entries, with unequal mask counts in the two
chunks, equal to the unsplit step.

Parameters after Adam steps are compared under one rule: an entry whose
root-mean-square gradient so far (sqrt of Adam's second moment, from the
reference run) is below NEAR_ZERO of the largest in the tree is left
out and counted, since Adam turns a gradient at rounding level into an
update of about +-lr whatever its size; every other entry is held at
the stated tolerance (the frozen backbone's decay is checked on its
own). The grad guard: a kernel wrapper refuses an input that
requires grad, and caption_loss never takes K8, even where the dispatch
would (the device faked through ``use_fused_attention``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.models import bridge as JB
from multimodal_audio_search_tpu.models import clap as JC
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.models.minilm import (
    MiniLMConfig as JMiniLMConfig)
from multimodal_audio_search_tpu.training import bridge as JTB
from multimodal_audio_search_tpu.training import clap as JTC
from multimodal_audio_search_tpu.training import finetune as JFT
from multimodal_audio_search_tpu.training import synth as JS
from multimodal_audio_search_tpu.utils.checkpoint import _path_str
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import bridge as B
from multimodal_audio_search_tpu_torch.models import clap as C
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.models.minilm import MiniLMConfig
from multimodal_audio_search_tpu_torch.parallel.mesh import make_mesh
from multimodal_audio_search_tpu_torch.training import bridge as TB
from multimodal_audio_search_tpu_torch.training import clap as TC
from multimodal_audio_search_tpu_torch.training import finetune as FT
from multimodal_audio_search_tpu_torch.training import synth as S
from multimodal_audio_search_tpu_torch.utils.tree import (
    path_str, tree_leaves_with_path)

torch.set_num_threads(1)
CFG = JW.PRESETS["test"]
NEAR_ZERO = 1e-6
ACFG = dict(embed_dim=32, d_model=16, layers=1, heads=2, ffn=32, n_mels=8,
            patch_frames=4, max_patches=16)
TCFG = dict(vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_flat(tree) -> dict:
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, x: out.__setitem__(_path_str(p), np.asarray(x)), tree)
    return out


def port_flat(tree) -> dict:
    return {path_str(p): (x.detach().float().numpy() if torch.is_tensor(x)
                          else np.asarray(x))
            for p, x in tree_leaves_with_path(tree)}


def assert_leaves_close(got: dict, want: dict, rel: float, rms=None):
    """Each leaf within ``rel`` of its largest |value| in ``want``;
    ``rms``: per-leaf RMS gradients (sqrt of Adam's nu, the reference
    run's), whose entries under NEAR_ZERO of the largest in the tree are
    left out (a leaf's own largest would keep a leaf whose gradient is
    zero but for rounding, as an attention key bias's; an exact zero in
    one run can be rounding in the other).
    Returns the count left out."""
    assert set(got) == set(want)
    skipped = 0
    top = max((float(r.max()) for r in rms.values()), default=0.0) \
        if rms else 0.0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        keep = np.ones(w.shape, bool)
        if rms is not None and k in rms:
            r = rms[k]
            near = r < NEAR_ZERO * top
            keep = ~near
            skipped += int(near.sum())
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        err = np.abs(g - w)[keep]
        assert err.size == 0 or err.max() <= tol, \
            (k, float(err.max()), tol)
    return skipped


def worst_leaf_gap(got: dict, want: dict, rms: dict) -> float:
    """The largest |got - want| as a share of its leaf's largest |want|,
    over the entries ``assert_leaves_close`` holds under ``rms``."""
    top = max(float(r.max()) for r in rms.values())
    worst = 0.0
    for k, w in want.items():
        keep = rms[k] >= NEAR_ZERO * top if k in rms \
            else np.ones(w.shape, bool)
        err = np.abs(got[k] - w)[keep]
        if err.size:
            worst = max(worst, float(err.max())
                        / max(float(np.abs(w).max()), 1e-30))
    return worst


def nu_rms(jax_state, prefix: str) -> dict:
    """sqrt(nu) by parameter path, from a JAX optax state's flat keys."""
    return {k[len(prefix):]: np.sqrt(v) for k, v in jax_flat(jax_state).items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def whisper_pair():
    jp = JW.init_params(jax.random.PRNGKey(0), CFG)
    return jp, weights.whisper_params(_np(jp))


def caption_batch(seed: int, b: int = 4, t: int = 9, frames: int = 200):
    """A batch of random mels and token rows of unequal lengths (the
    mask counts differ row by row, and between the batch's halves)."""
    rng = np.random.default_rng(seed)
    mel = rng.normal(size=(b, CFG.n_mels, frames)).astype(np.float32)
    tokens = rng.integers(0, 500, size=(b, t)).astype(np.int32)
    tokens[:, 0] = CFG.bos_token_id
    mask = np.zeros((b, t - 1), np.float32)
    for i, n in enumerate([t - 1, 3, 6, 1][:b]):
        mask[i, :n] = 1.0
    return {"mel": mel, "tokens": tokens, "loss_mask": mask}


# ------------------------------------------------------------ decode_train
def test_decode_train_logits_match_jax(whisper_pair):
    jp, tp = whisper_pair
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(2, 100, CFG.d_model)).astype(np.float32)
    tok = rng.integers(0, CFG.vocab_size, size=(2, 7)).astype(np.int32)
    want = np.asarray(JW.decode_train(jp, jnp.asarray(enc), jnp.asarray(tok),
                                      CFG))
    got = W.decode_train(tp, torch.from_numpy(enc), torch.from_numpy(tok),
                         CFG)
    assert got.dtype == torch.float32 and got.shape == (2, 7, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_caption_loss_and_gradients_match_jax(whisper_pair, smoothing):
    jp, tp = whisper_pair
    b = caption_batch(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want_loss, want_g = jax.value_and_grad(JFT.caption_loss)(
        jp, jb["mel"], jb["tokens"], jb["loss_mask"], CFG, smoothing)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = FT.caption_loss(tp, tb["mel"], tb["tokens"], tb["loss_mask"], CFG,
                           smoothing)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    got_loss, got_g = FT.loss_and_grads(tp, b, CFG, smoothing)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    assert_leaves_close(port_flat(got_g), jax_flat(want_g), 1e-5)


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("tcfg", [
    JFT.TrainConfig(learning_rate=1e-3),
    JFT.TrainConfig(learning_rate=1e-3, warmup_steps=4),
    JFT.TrainConfig(learning_rate=1e-3, schedule="warmup_cosine",
                    warmup_steps=10, total_steps=100, end_lr_frac=0.1),
    JFT.TrainConfig(learning_rate=3e-4, schedule="warmup_cosine",
                    warmup_steps=0, total_steps=7),
], ids=["constant", "warmup", "warmup_cosine", "cosine_warm0"])
def test_schedules_match_optax(tcfg):
    want = JFT.make_schedule(tcfg)
    got = FT.make_schedule(FT.TrainConfig(**tcfg.__dict__))
    for step in range(tcfg.total_steps + 3 if tcfg.total_steps < 200
                      else 203):
        assert abs(got(step) - float(want(step))) <= 1e-7, step
    with pytest.raises(ValueError):
        FT.make_schedule(FT.TrainConfig(schedule="nope"))


# ------------------------------------------------------------ train steps
def test_three_train_steps_match_jax(whisper_pair):
    """Clip low enough that every step clips (grad_norm > grad_clip),
    weight decay on, warmup: losses, grad norms and parameters."""
    jp, tp = whisper_pair
    kw = dict(learning_rate=3e-3, grad_clip=0.05, weight_decay=0.01,
              warmup_steps=2, schedule="warmup_cosine", total_steps=10)
    jstep, jopt = JFT.make_train_step(CFG, JFT.TrainConfig(**kw),
                                      donate=False)
    tstep, topt = FT.make_train_step(CFG, FT.TrainConfig(**kw))
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        b = caption_batch(10 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, b)
        assert float(jm["grad_norm"]) > 0.05
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    skipped = assert_leaves_close(port_flat(tp), jax_flat(jp), 1e-5,
                                  nu_rms(js, "1/0/.nu/"))
    # left out: the 24 decoder position rows past the 8 tokens (1536
    # entries that no step reaches: the decay alone moves them) and a
    # handful at rounding level
    assert 1536 <= skipped < 1536 + 1e-3 * 236288
    # the state, key for key (optax's chain): moments and counts
    assert_leaves_close(port_flat(ts), jax_flat(js), 1e-4)
    assert int(ts[1][0].count) == int(ts[1][2].count) == 3


# ------------------------------------------------------------ CLAP
def clap_batch(seed: int, b: int = 8):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 6), np.int32)
    mask[1, 4:] = 0
    return {"mel": rng.normal(size=(b, 8, 32)).astype(np.float32),
            "input_ids": rng.integers(4, 64, size=(b, 6)).astype(np.int32),
            "attention_mask": mask}


@pytest.mark.parametrize("train_backbone", [True, False])
def test_clap_step_matches_jax(train_backbone):
    acfg, tcfg = JC.ClapConfig(**ACFG), JMiniLMConfig(**TCFG)
    tc = dict(learning_rate=3e-3, train_text_backbone=train_backbone)
    jp = JTC.init_clap_params(jax.random.PRNGKey(0), acfg, tcfg)
    tp = weights.clap_train_params(_np(jp))
    jstep, jopt = JTC.make_clap_train_step(
        acfg, tcfg, JTC.ClapTrainConfig(**tc), donate=False)
    tstep, topt = TC.make_clap_train_step(
        C.ClapConfig(**ACFG), MiniLMConfig(**TCFG), TC.ClapTrainConfig(**tc))
    js, ts = jopt.init(jp), topt.init(tp)
    w0 = np.asarray(jp["text_backbone"]["blocks"][0]["mlp_in"]["w"])
    for i in range(3):
        b = clap_batch(i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, b)
        for k in ("loss", "in_batch_acc", "temperature", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
    assert_leaves_close(port_flat(tp), jax_flat(jp), 1e-5,
                        nu_rms(js, "1/0/.nu/"))
    w3 = tp["text_backbone"]["blocks"][0]["mlp_in"]["w"].numpy()
    if not train_backbone:
        # no gradient, but AdamW's decoupled decay: w (1 - lr wd)^3
        np.testing.assert_allclose(w3, w0 * (1 - 3e-3 * 0.01) ** 3,
                                   rtol=1e-6)
        # biases (ndim 1) take no decay
        np.testing.assert_array_equal(
            tp["text_backbone"]["blocks"][0]["mlp_in"]["b"].numpy(),
            np.asarray(jp["text_backbone"]["blocks"][0]["mlp_in"]["b"]))
    else:
        assert np.abs(w3 - w0).max() > 1e-4


def test_clap_split_step_equals_whole():
    """Over two data entries the InfoNCE logits still span the whole
    batch: the split step's metrics and parameters equal the whole
    step's."""
    acfg, tcfg = C.ClapConfig(**ACFG), MiniLMConfig(**TCFG)
    p0 = TC.init_clap_params(torch.Generator().manual_seed(0), acfg, tcfg)
    out = []
    for mesh in (None, make_mesh(2, device="cpu")):
        step, opt = TC.make_clap_train_step(acfg, tcfg, mesh=mesh)
        p, s, m = step(p0, opt.init(p0), clap_batch(3))
        out.append((port_flat(p), m, port_flat(s)))
    for k in out[0][1]:
        np.testing.assert_allclose(float(out[1][1][k]), float(out[0][1][k]),
                                   rtol=1e-6, err_msg=k)
    rms = {k[len("1/0/.nu/"):]: np.sqrt(v) for k, v in out[0][2].items()
           if k.startswith("1/0/.nu/")}
    assert_leaves_close(out[1][0], out[0][0], 1e-6, rms)


# ------------------------------------------------------------ bridge
def test_train_bridge_matches_jax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(150, 128)).astype(np.float32) * 3 + 1
    tgt = rng.normal(size=(150, 384)).astype(np.float32)
    tgt /= np.linalg.norm(tgt, axis=-1, keepdims=True)
    cfg = JB.BridgeConfig(dropout=0.0)
    jp, jl = JTB.train_bridge(feats, tgt, cfg, epochs=3, seed=0)
    init = weights.bridge_params(_np(JB.init_params(jax.random.PRNGKey(0),
                                                    cfg)))
    tp, tl = TB.train_bridge(feats, tgt, B.BridgeConfig(dropout=0.0),
                             epochs=3, seed=0, init_params=init,
                             device="cpu")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    # the fitted standardisation is held fixed by training
    np.testing.assert_array_equal(tp["feat_mean"].numpy(),
                                  np.asarray(jp["feat_mean"]))


def test_features_for_waves_matches_jax():
    """The host wrapper over ops/audio_features.py: bit-equal to the
    port's feature vector, its MFCCs within 5e-5 of JAX's wrapper's (the
    other columns' float32 conditioning: tests/test_torch_clap.py)."""
    from multimodal_audio_search_tpu.config import MelConfig as JMelConfig
    from multimodal_audio_search_tpu_torch.config import MelConfig
    from multimodal_audio_search_tpu_torch.ops.audio_features import (
        audio_feature_vector)
    waves = (np.random.default_rng(8).normal(size=(3, 32000)) * 0.3) \
        .astype(np.float32)
    cfg = MelConfig(padded_seconds=2.0)
    got = TB.features_for_waves(waves, cfg, device="cpu")
    np.testing.assert_array_equal(
        got, audio_feature_vector(torch.from_numpy(waves), cfg).numpy())
    want = JTB.features_for_waves(waves, JMelConfig(padded_seconds=2.0))
    np.testing.assert_allclose(got[:, :13], want[:, :13], atol=5e-5,
                               rtol=5e-5)


# ------------------------------------------------------------ synth
def test_synth_steps_match_jax(whisper_pair):
    jp, tp = whisper_pair
    want = JS.train_synth_captioner(steps=3, batch=4, seed=0,
                                    params_init=jp)
    got = S.train_synth_captioner(steps=3, batch=4, seed=0, params_init=tp,
                                  device="cpu")
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.max_new == want.max_new == 9


# ------------------------------------------------------------ data axis
def test_split_step_equals_whole(whisper_pair):
    """loss_and_grads over two CPU entries: the chunks' mask counts are
    11 and 7, so a mean of chunk means would differ by ~10 %."""
    _, tp = whisper_pair
    b = caption_batch(4)
    assert b["loss_mask"][:2].sum() != b["loss_mask"][2:].sum()
    l1, g1 = FT.loss_and_grads(tp, b, CFG)
    l2, g2 = FT.loss_and_grads(tp, b, CFG, mesh=make_mesh(2, device="cpu"))
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    assert_leaves_close(port_flat(g2), port_flat(g1), 1e-6)


def test_finetune_captioner_data_parallel_equals_one_device(whisper_pair,
                                                            tmp_path):
    """Three steps at TrainConfig's lr 1e-4 over two CPU entries against
    one. Measured here (share of each leaf's max, near-zero entries left
    out): the split's worst leaf 1.75e-6 (decoder cross_ln bias), the
    same one-device run with the batch's rows reversed 4.46e-6 (decoder
    mlp_ln bias), so the split's gap is summation order, which Adam's
    per-entry normalisation lifts above 1e-6 of a leaf."""
    from multimodal_audio_search_tpu_torch.training.loop import (
        finetune_captioner)
    from multimodal_audio_search_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)
    _, tp = whisper_pair
    tcfg = FT.TrainConfig()
    runs = {}
    for name, n, order in (("one", 1, slice(None)), ("split", 2, slice(None)),
                           ("reversed", 1, slice(None, None, -1))):
        runs[name] = finetune_captioner(
            [{k: v[order].copy() for k, v in caption_batch(20 + i).items()}
             for i in range(3)], CFG, tcfg,
            init_params=tp, n_devices=n, device="cpu",
            checkpoint_dir=str(tmp_path / name), log_fn=lambda s: None)
    np.testing.assert_allclose(runs["split"].losses, runs["one"].losses,
                               rtol=1e-6)
    _, opt = FT.make_train_step(CFG, tcfg)
    _, st, _ = TrainCheckpointer(tmp_path / "one").restore(
        tp, opt.init(tp))
    rms = {k[len("1/0/.nu/"):]: np.sqrt(v) for k, v in port_flat(st).items()
           if k.startswith("1/0/.nu/")}
    one = port_flat(runs["one"].params)
    assert_leaves_close(port_flat(runs["split"].params), one, 3e-6, rms)
    # the witness: the split is no further from the unsplit run than the
    # unsplit run is from itself with its rows in another order
    split_gap = worst_leaf_gap(port_flat(runs["split"].params), one, rms)
    reorder_gap = worst_leaf_gap(port_flat(runs["reversed"].params), one, rms)
    assert 0 < split_gap <= reorder_gap, (split_gap, reorder_gap)


# ------------------------------------------------------------ grad guard
def test_kernel_wrappers_refuse_inputs_that_require_grad():
    from multimodal_audio_search_tpu_torch.ops.attention import (
        fused_encoder_attention)
    from multimodal_audio_search_tpu_torch.ops.cross_attention import (
        fused_single_query_attention)
    from multimodal_audio_search_tpu_torch.ops.encoder_block import (
        fused_attention_o_residual)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 5, 64, generator=g) for _ in range(3))
    x = torch.randn(1, 5, 128, generator=g)
    wo = torch.randn(128, 128, generator=g).requires_grad_()
    with pytest.raises(ValueError, match="K1 has no backward"):
        fused_attention_o_residual(q, k, v, x, wo, torch.zeros(128))
    with pytest.raises(ValueError, match="K8 has no backward"):
        fused_encoder_attention(q.clone().requires_grad_(), k, v)
    km = torch.randn(1, 5, 128, generator=g)
    with pytest.raises(ValueError, match="K2 has no backward"):
        fused_single_query_attention(torch.randn(1, 128).requires_grad_(),
                                     km, km, heads=2)
    with torch.no_grad():           # no graph to cut: the kernel runs
        fused_attention_o_residual(q, k, v, x, wo, torch.zeros(128))


def test_caption_loss_never_takes_k8(whisper_pair, monkeypatch):
    """With the dispatch faked to the card's (use_fused_attention says
    yes), encode's auto mode reaches K8; caption_loss does not."""
    from multimodal_audio_search_tpu_torch.ops import attention
    _, tp = whisper_pair

    def k8(*a):
        raise AssertionError("K8 reached")
    monkeypatch.setattr(W, "use_fused_attention", lambda t, device: True)
    monkeypatch.setattr(attention, "fused_encoder_attention", k8)
    b = {k: torch.from_numpy(v) for k, v in caption_batch(6).items()}
    with pytest.raises(AssertionError, match="K8 reached"):
        W.encode(tp, b["mel"], CFG)
    loss, grads = FT.loss_and_grads(tp, caption_batch(6), CFG)
    assert torch.isfinite(loss)
    assert float(FT.global_norm(grads)) > 0
