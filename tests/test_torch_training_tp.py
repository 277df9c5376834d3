"""Training over the mesh's model axis (training/finetune.py, clap.py,
loop.py, synth.py; models/whisper.py::decode_train_tp, models/clap.py::
audio_embed_tp / text_embed_tp; parallel/mesh.py::gather_heads) held to
the JAX package's step on its 8 virtual CPU devices, with the parameters
placed by JAX's ``shard_params`` on ``make_mesh(2, 2)`` = (1, 2) and
``make_mesh(4, 2)`` = (2, 2), and to the port's one-device step, at the
JAX training tests' tiny geometry (tests/test_training_loop.py,
tests/test_clap_training.py), float32:

  * ``decode_train_tp``'s logits within 5e-5 of JAX's ``decode_train``;
  * the loss within 1e-6 (relative) and every gradient leaf within 1e-5
    of its largest |value|, against JAX's mesh step and the port's one
    device;
  * three clipped AdamW steps within 3e-6 of each leaf's max (entries
    whose RMS gradient is under NEAR_ZERO of the tree's largest left out
    and counted, as tests/test_torch_training.py does), no further from
    the one-device run than the farther of two reorderings of that run
    (its heads and MLP units permuted, the batch's rows reversed);
  * the CLAP step, the text backbone trained and frozen;
  * ``model_sum``'s backward against JAX's psum under shard_map;
  * each rank holding only its shard of every split leaf, in the
    parameters and in both Adam moments, the replicas of every other leaf
    bit-equal after the steps, and ``gather_heads(shard_heads(p)) == p``
    exactly;
  * checkpoints across packages and axes: JAX's (2, 2) checkpoint resumed
    by the port at (1, 2), the port's (1, 2) checkpoint resumed by JAX at
    (2, 2) and by the port at mp = 1;
  * no TP training step reaching K8, K1p or K1 (their wrappers replaced
    by ones that raise), and a model whose heads do not divide the axis
    training unsharded, logged.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.models import clap as JC
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.models.minilm import (
    MiniLMConfig as JMiniLMConfig)
from multimodal_audio_search_tpu.parallel import mesh as jmesh
from multimodal_audio_search_tpu.training import clap as JTC
from multimodal_audio_search_tpu.training import finetune as JFT
from multimodal_audio_search_tpu.training.loop import (
    finetune_captioner as j_finetune)
from multimodal_audio_search_tpu.utils import checkpoint as JCK
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import clap as C
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.models.minilm import MiniLMConfig
from multimodal_audio_search_tpu_torch.parallel import mesh as M
from multimodal_audio_search_tpu_torch.training import clap as TC
from multimodal_audio_search_tpu_torch.training import finetune as FT
from multimodal_audio_search_tpu_torch.training import synth as S
from multimodal_audio_search_tpu_torch.training.loop import (
    finetune_captioner, restore_ranks)
from multimodal_audio_search_tpu_torch.utils.checkpoint import (
    TrainCheckpointer)
from multimodal_audio_search_tpu_torch.utils.tree import (
    tree_leaves, tree_leaves_with_path, tree_map_with_path)

from test_torch_training import (assert_leaves_close, jax_flat, nu_rms,
                                 port_flat, worst_leaf_gap)

torch.set_num_threads(1)
MESHES = [(1, 2), (2, 2)]
IDS = ["1x2", "2x2"]
WCFG = dict(vocab_size=64, d_model=16, enc_layers=1, dec_layers=1, heads=2,
            ffn=32, enc_positions=20, dec_positions=12, bos_token_id=60,
            eos_token_id=61, pad_token_id=61)
ACFG = dict(embed_dim=32, d_model=16, layers=1, heads=2, ffn=32, n_mels=8,
            patch_frames=4, max_patches=16)
TCFG = dict(vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32)
CFG, JCFG = W.WhisperConfig(**WCFG), JW.WhisperConfig(**WCFG)
ADAM = dict(learning_rate=3e-3, grad_clip=0.05, weight_decay=0.01,
            warmup_steps=1, schedule="warmup_cosine", total_steps=10)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_mesh(shape):
    return M.make_mesh(shape[0] * shape[1], model_parallel=shape[1],
                       device="cpu")


def jax_mesh(shape):
    return jmesh.make_mesh(shape[0] * shape[1], model_parallel=shape[1])


def ranks_of(params, shape):
    """The port's TP state: row 0's rank trees (training/loop.py)."""
    return M.shard_heads(params, M.make_mesh(
        shape[1], shape[1], device="cpu"), CFG.heads)[0]


@pytest.fixture
def tp_rows(monkeypatch):
    """The calls of decode_train_tp: one a data row of each step taken
    over the model axis, none where a step runs unsplit."""
    calls = []
    orig = W.decode_train_tp

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(W, "decode_train_tp", counted)
    return calls


@pytest.fixture(scope="module")
def whisper_pair():
    jp = JW.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, weights.whisper_params(_np(jp))


def caption_batch(seed: int, b: int = 8, t: int = 8, frames: int = 40):
    """Random mels and token rows of unequal lengths: the mask counts
    differ row by row and between the batch's halves (the (2, 2) rows)."""
    rng = np.random.default_rng(seed)
    mel = rng.normal(size=(b, 80, frames)).astype(np.float32)
    tokens = rng.integers(0, 60, size=(b, t)).astype(np.int32)
    tokens[:, 0] = CFG.bos_token_id
    mask = np.zeros((b, t - 1), np.float32)
    for i, n in enumerate([7, 3, 6, 1, 7, 7, 5, 2][:b]):
        mask[i, :n] = 1.0
    return {"mel": mel, "tokens": tokens, "loss_mask": mask}


def jax_run(step, mesh, params, state, batches):
    """JAX's jitted step over ``mesh``: the parameters by shard_params,
    the state replicated, each batch data-sharded (as JAX's
    finetune_captioner runs it)."""
    params = jmesh.shard_params(params, mesh)
    state = jax.device_put(state, jmesh.replicated(mesh))
    metrics = []
    with mesh:
        for b in batches:
            b = {k: jax.device_put(np.asarray(v), jmesh.data_sharded(mesh))
                 for k, v in b.items()}
            params, state, m = step(params, state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    return params, state, metrics


# ------------------------------------------------------ shards and sums
@pytest.mark.parametrize("mp", [2, 4])
def test_gather_heads_inverts_shard_heads(mp):
    """Exactly, on the parameters and on an optimizer state (its moments
    split by the same paths, its counts whole); each rank's shard of a
    split leaf is 1/mp of it."""
    cfg = W.PRESETS["test"]
    p = W.init_params(torch.Generator().manual_seed(1), cfg)
    st = FT.make_optimizer(FT.TrainConfig()).init(p)
    mesh = M.make_mesh(mp, mp, device="cpu")
    for tree in (p, st):
        ranks = M.shard_heads(tree, mesh, cfg.heads)[0]
        back = M.gather_heads(ranks)
        assert [pth for pth, _ in tree_leaves_with_path(back)] == \
            [pth for pth, _ in tree_leaves_with_path(tree)]
        for (pth, a), (_, b) in zip(tree_leaves_with_path(back),
                                    tree_leaves_with_path(tree)):
            assert torch.equal(a, b), pth
        whole = dict(tree_leaves_with_path(tree))
        for split, (pth, leaf) in zip(M.split_leaves(ranks[1]),
                                      tree_leaves_with_path(ranks[1])):
            assert leaf.numel() * (mp if split else 1) == \
                whole[pth].numel(), pth
        # shard_like splits whole leaves as shard_heads does
        again = M.shard_like(tree, ranks)
        for j in range(mp):
            for a, b in zip(tree_leaves(again[j]), tree_leaves(ranks[j])):
                assert torch.equal(a, b)


@pytest.mark.parametrize("mp", [2, 4])
def test_model_sum_backward_matches_psum(mp):
    """Each rank's copy of model_sum's output feeds its own downstream
    term (as the next layer's rank does): the gradient reaches every
    rank's partial and the residual once each, and the row-parallel
    bias, read from rank 0 only, once -- JAX's psum under shard_map."""
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(mp)
    parts = rng.normal(size=(mp, 3, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    res = rng.normal(size=(3, 5)).astype(np.float32)
    cot = rng.normal(size=(mp, 3, 5)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:mp]), ("model",))

    def rank(p, b, r, c):
        y = jax.lax.psum(p[0], "model") + b + r
        return jax.lax.psum(jnp.sum(y * c[0]), "model")

    f = jax.shard_map(rank, mesh=mesh,
                      in_specs=(P("model"), P(), P(), P("model")),
                      out_specs=P())
    jg = jax.grad(f, argnums=(0, 1, 2))(parts, bias, res, cot)
    tp = [torch.from_numpy(parts[j]).requires_grad_() for j in range(mp)]
    tb = torch.from_numpy(bias).requires_grad_()
    tr = [torch.from_numpy(res).requires_grad_() for _ in range(mp)]
    out = M.model_sum(tp, tb, tr)
    loss = sum((o * torch.from_numpy(cot[j])).sum()
               for j, o in enumerate(out))
    gp = torch.autograd.grad(loss, tp + [tb] + tr, allow_unused=True)
    for j in range(mp):
        np.testing.assert_allclose(gp[j].numpy(), np.asarray(jg[0])[j],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gp[mp].numpy(), np.asarray(jg[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gp[mp + 1].numpy(), np.asarray(jg[2]),
                               rtol=1e-6, atol=1e-6)
    # the residual's other replicas are not read
    assert all(g is None for g in gp[mp + 2:])


# ------------------------------------------------------ decode_train_tp
@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_decode_train_tp_logits_match_jax(whisper_pair, shape):
    """Each data row's rows of the batch decoded over its two ranks."""
    jp, tp = whisper_pair
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(4, 20, CFG.d_model)).astype(np.float32)
    tok = rng.integers(0, CFG.vocab_size, size=(4, 7)).astype(np.int32)
    want = np.asarray(JW.decode_train(jp, jnp.asarray(enc),
                                      jnp.asarray(tok), JCFG))
    mesh = port_mesh(shape)
    rows = M.shard_heads(tp, mesh, CFG.heads)
    got = []
    for i, (e, t) in enumerate(zip(np.split(enc, shape[0]),
                                   np.split(tok, shape[0]))):
        trees = list(rows[i])
        encs = [torch.from_numpy(e)] * shape[1]
        got.append(W.decode_train_tp(trees, encs, torch.from_numpy(t), CFG))
    got = torch.cat(got)
    assert got.dtype == torch.float32 and got.shape == (4, 7, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    # the encoder's TP form under autograd gives the one-device states
    mel = torch.from_numpy(rng.normal(size=(2, 80, 40)).astype(np.float32))
    encs = W.encode_tp(list(rows[0]), mel, CFG, fused_attention=False,
                       fused_blocks=False)
    np.testing.assert_allclose(encs[1].numpy(),
                               W.encode(tp, mel, CFG).numpy(), atol=5e-5)


# ------------------------------------------------------ the caption step
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_tp_loss_and_grads_match_jax_mesh(whisper_pair, shape, smoothing):
    jp, tp = whisper_pair
    b = caption_batch(2)
    mesh = jax_mesh(shape)

    def loss_fn(p, b):
        return JFT.caption_loss(p, b["mel"], b["tokens"], b["loss_mask"],
                                JCFG, smoothing)
    with mesh:
        want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(
            jmesh.shard_params(jp, mesh),
            {k: jax.device_put(v, jmesh.data_sharded(mesh))
             for k, v in b.items()})
    one_loss, one_g = FT.loss_and_grads(tp, b, CFG, smoothing)
    loss, grads = FT.loss_and_grads(ranks_of(tp, shape), b, CFG, smoothing,
                                    mesh=port_mesh(shape))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(one_loss), rtol=1e-6)
    whole = port_flat(M.gather_heads(grads))
    assert_leaves_close(whole, jax_flat(want_g), 1e-5)
    assert_leaves_close(whole, port_flat(one_g), 1e-5)
    # every rank carries the same sum for a leaf that is not split
    for split, a, c in zip(M.split_leaves(grads[0]), tree_leaves(grads[0]),
                           tree_leaves(grads[1])):
        assert split or torch.equal(a, c)
    np.testing.assert_allclose(float(FT.rank_global_norm(grads)),
                               float(FT.global_norm(one_g)), rtol=1e-6)
    # one rank: optax's global norm bit for bit
    assert torch.equal(FT.rank_global_norm(M.as_ranks([one_g])),
                       FT.global_norm(one_g))


def _state_shards_ok(params, state, whole_params):
    """Each rank holds only its shard of a split leaf, in the parameters
    and in both moments; every other leaf's replicas are bit-equal."""
    mp = len(params)
    whole = dict(tree_leaves_with_path(whole_params))
    for tree_of in (lambda j: params[j], lambda j: state[j][1][0].mu,
                    lambda j: state[j][1][0].nu):
        flags = M.split_leaves(tree_of(0))
        leaves = [tree_leaves_with_path(tree_of(j)) for j in range(mp)]
        for k, split in enumerate(flags):
            path = leaves[0][k][0]
            for j in range(mp):
                n = leaves[j][k][1].numel()
                assert n * (mp if split else 1) == whole[path].numel(), path
                if not split:
                    assert torch.equal(leaves[j][k][1], leaves[0][k][1]), \
                        path
    assert len({int(state[j][1][0].count) for j in range(mp)}) == 1


def init_state(opt, params):
    """The optimizer state of rank trees or of one tree (a train step
    takes either)."""
    return opt.init_ranks(params) if M.is_ranks(params) else opt.init(params)


def permuted(tree, inverse: bool = False):
    """The same function with its inner sums in another order: the two
    heads of every attention swapped (q/k/v columns, o rows) and every
    MLP's hidden units reversed (mlp_in columns, mlp_out rows)."""
    def perm(path, x):
        axis = M._head_split(path)
        if axis is None:
            return x
        n = x.shape[axis]
        p = torch.arange(n - 1, -1, -1) if "mlp_in" in path or \
            "mlp_out" in path else torch.arange(n).roll(n // 2)
        return x.index_select(axis, torch.argsort(p) if inverse else p)
    return tree_map_with_path(perm, tree)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_three_tp_steps_match_jax_mesh(whisper_pair, shape):
    """Clip low enough that every step clips, decay on, warmup. Measured
    here (share of each leaf's max, near-zero entries left out), the TP
    run against the one-device run: 9.97e-7 at (1, 2), 9.14e-7 at
    (2, 2). It is held to the farther of two reorderings of the
    one-device run: the batch's rows reversed (the data axis's witness in
    tests/test_torch_training.py: the order of the sums over the batch)
    5.13e-7, and the parameters permuted (permuted(): the order of the
    sums over the heads and MLP units, which the model axis splits in
    two) 1.09e-6."""
    jp, tp = whisper_pair
    batches = [caption_batch(10 + i) for i in range(3)]
    jstep, jopt = JFT.make_train_step(JCFG, JFT.TrainConfig(**ADAM),
                                      donate=False)
    jparams, jstate, jm = jax_run(jstep, jax_mesh(shape), jp,
                                  jopt.init(jp), batches)
    runs = {}
    for name, params, mesh, order in (
            ("tp", ranks_of(tp, shape), port_mesh(shape), slice(None)),
            ("one", tp, None, slice(None)),
            ("reversed", tp, None, slice(None, None, -1)),
            ("permuted", permuted(tp), None, slice(None))):
        step, opt = FT.make_train_step(CFG, FT.TrainConfig(**ADAM),
                                       mesh=mesh)
        state, ms = init_state(opt, params), []
        for b in batches:
            params, state, m = step(
                params, state, {k: v[order].copy() for k, v in b.items()})
            ms.append(m)
        runs[name] = (params, state, ms)
    params, state, ms = runs["tp"]
    for m, j in zip(ms, jm):
        assert j["grad_norm"] > 0.05
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), j[k], rtol=1e-5)
    rms = nu_rms(jstate, "1/0/.nu/")
    got = port_flat(M.gather_heads(params))
    skipped = assert_leaves_close(got, jax_flat(jparams), 3e-6, rms)
    # left out: the decoder position rows past the 7 inputs (5 x 16
    # entries that no step reaches) and 13 of the encoder's self-attention
    # q / k weights, at rounding level (the softmax's near-cancelling sum)
    assert 80 <= skipped <= 100, skipped
    one = port_flat(runs["one"][0])
    assert_leaves_close(got, one, 3e-6, rms)
    tp_gap = worst_leaf_gap(got, one, rms)
    reorder_gap = worst_leaf_gap(port_flat(runs["reversed"][0]), one, rms)
    perm_gap = worst_leaf_gap(
        port_flat(permuted(runs["permuted"][0], inverse=True)), one, rms)
    print(f"worst leaf gap: TP {tp_gap:.3g}, rows reversed "
          f"{reorder_gap:.3g}, permuted {perm_gap:.3g}")
    assert 0 < tp_gap <= max(perm_gap, reorder_gap), \
        (tp_gap, perm_gap, reorder_gap)
    # the state: each rank its shards, the replicas bit-equal; whole, it
    # is JAX's key for key
    _state_shards_ok(params, state, tp)
    assert_leaves_close(port_flat(M.gather_heads(state)), jax_flat(jstate),
                        1e-4)


# ------------------------------------------------------ CLAP
def clap_batch(seed: int, b: int = 8):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 6), np.int32)
    mask[1, 4:] = 0
    mask[6, 3:] = 0
    return {"mel": rng.normal(size=(b, 8, 32)).astype(np.float32),
            "input_ids": rng.integers(4, 64, size=(b, 6)).astype(np.int32),
            "attention_mask": mask}


@pytest.mark.parametrize("train_backbone", [True, False])
@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_clap_tp_step_matches_jax_mesh(shape, train_backbone):
    acfg, tcfg = JC.ClapConfig(**ACFG), JMiniLMConfig(**TCFG)
    tc = dict(learning_rate=3e-3, train_text_backbone=train_backbone)
    jp = JTC.init_clap_params(jax.random.PRNGKey(0), acfg, tcfg)
    tp = weights.clap_train_params(_np(jp))
    batches = [clap_batch(i) for i in range(3)]
    jstep, jopt = JTC.make_clap_train_step(
        acfg, tcfg, JTC.ClapTrainConfig(**tc), donate=False)
    jparams, jstate, jm = jax_run(jstep, jax_mesh(shape), jp,
                                  jopt.init(jp), batches)
    out = {}
    for name, params, mesh in (("tp", M.shard_heads(
            tp, M.make_mesh(2, 2, device="cpu"), 2)[0], port_mesh(shape)),
            ("one", tp, None)):
        step, opt = TC.make_clap_train_step(
            C.ClapConfig(**ACFG), MiniLMConfig(**TCFG),
            TC.ClapTrainConfig(**tc), mesh=mesh)
        state, ms = init_state(opt, params), []
        for b in batches:
            params, state, m = step(params, state, b)
            ms.append(m)
        out[name] = (params, state, ms)
    params, state, ms = out["tp"]
    for m, j, o in zip(ms, jm, out["one"][2]):
        for k in ("loss", "in_batch_acc", "temperature", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), j[k], rtol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose(float(m[k]), float(o[k]), rtol=1e-5,
                                       err_msg=k)
    rms = nu_rms(jstate, "1/0/.nu/")
    got = port_flat(M.gather_heads(params))
    assert_leaves_close(got, jax_flat(jparams), 1e-5, rms)
    assert_leaves_close(got, port_flat(out["one"][0]), 1e-5, rms)
    _state_shards_ok(params, state, tp)
    w0 = tp["text_backbone"]["blocks"][0]["mlp_in"]["w"].numpy()
    for j in range(2):
        w3 = params[j]["text_backbone"]["blocks"][0]["mlp_in"]["w"].numpy()
        half = np.split(w0, 2, axis=1)[j]
        if train_backbone:
            assert np.abs(w3 - half).max() > 1e-4
        else:
            # each rank's frozen shard: the decoupled decay alone
            np.testing.assert_allclose(w3, half * (1 - 3e-3 * 0.01) ** 3,
                                       rtol=1e-6)


# ------------------------------------------------------ checkpoints
def make_batches(seed, n, b=8):
    return [caption_batch(seed + i, b) for i in range(n)]


def test_jax_tp_checkpoint_resumes_in_port_at_1x2(tmp_path, tp_rows):
    """JAX trains 2 steps at (2, 2) and checkpoints; JAX resumes at (2, 2)
    and the port at (1, 2), each for the same 2 batches."""
    kw = dict(learning_rate=3e-3, schedule="warmup_cosine", warmup_steps=1,
              total_steps=6)
    first, more = make_batches(0, 2), make_batches(5, 2)
    j_finetune(first, JCFG, JFT.TrainConfig(**kw), n_devices=4,
               model_parallel=2, checkpoint_dir=str(tmp_path / "j"),
               log_fn=lambda s: None)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jres = j_finetune(more, JCFG, JFT.TrainConfig(**kw), n_devices=4,
                      model_parallel=2, checkpoint_dir=str(tmp_path / "j"),
                      log_fn=lambda s: None)
    logs = []
    tres = finetune_captioner(more, CFG, FT.TrainConfig(**kw), n_devices=2,
                              model_parallel=2, device="cpu",
                              checkpoint_dir=str(tmp_path / "t"),
                              log_fn=logs.append)
    assert logs[0] == "resumed from step 2"
    assert len(tp_rows) == 2        # both steps over the model axis
    assert jres.steps == tres.steps == 4
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5)
    jp0 = JW.init_params(jax.random.PRNGKey(0), JCFG)
    jst = JCK.load_pytree(JFT.make_optimizer(JFT.TrainConfig(**kw)).init(
        jp0), tmp_path / "j" / "step_00000004.opt.npz")
    assert_leaves_close(port_flat(tres.params), jax_flat(jres.params), 1e-5,
                        nu_rms(jst, "1/0/.nu/"))


def test_port_tp_checkpoint_resumes_in_jax_and_at_mp1(whisper_pair,
                                                      tmp_path, tp_rows):
    """The port trains 2 steps at (1, 2) and checkpoints whole leaves
    under JAX's keys; JAX's TrainCheckpointer loads them, JAX resumes at
    (2, 2), and the port resumes at mp = 1 and at (1, 2): all four runs
    of the next 2 batches agree."""
    jp, tp = whisper_pair
    kw = dict(learning_rate=3e-3, schedule="warmup_cosine", warmup_steps=1,
              total_steps=6)
    first, more = make_batches(20, 2), make_batches(30, 2)
    finetune_captioner(first, CFG, FT.TrainConfig(**kw), init_params=tp,
                       n_devices=2, model_parallel=2, device="cpu",
                       checkpoint_dir=str(tmp_path / "a"),
                       log_fn=lambda s: None)
    z = np.load(tmp_path / "a" / "step_00000002.opt.npz")
    opt0 = FT.make_optimizer(FT.TrainConfig(**kw)).init(tp)
    assert set(z.files) == set(port_flat(opt0))
    for k, v in port_flat(opt0).items():
        assert z[k].shape == v.shape, k
    # JAX's checkpointer reads the port's files into its own templates
    jopt = JFT.make_optimizer(JFT.TrainConfig(**kw))
    jparams, jstate, meta = JCK.TrainCheckpointer(tmp_path / "a").restore(
        jp, jopt.init(jp))
    assert meta["step"] == 2
    assert jax_flat(jparams).keys() == port_flat(tp).keys()
    for d in ("j", "one", "tp"):
        shutil.copytree(tmp_path / "a", tmp_path / d)
    jres = j_finetune(more, JCFG, JFT.TrainConfig(**kw), n_devices=4,
                      model_parallel=2, checkpoint_dir=str(tmp_path / "j"),
                      log_fn=lambda s: None)
    res, rows = {}, {}
    for mp, name in ((1, "one"), (2, "tp")):
        del tp_rows[:]
        res[mp] = finetune_captioner(
            more, CFG, FT.TrainConfig(**kw), init_params=tp, n_devices=mp,
            model_parallel=mp, device="cpu",
            checkpoint_dir=str(tmp_path / name), log_fn=lambda s: None)
        rows[mp] = len(tp_rows)
    assert jres.steps == res[1].steps == res[2].steps == 4
    assert rows == {1: 0, 2: 2}
    jst = JCK.load_pytree(jopt.init(jp),
                          tmp_path / "j" / "step_00000004.opt.npz")
    rms = nu_rms(jst, "1/0/.nu/")
    want = jax_flat(jres.params)
    for r in res.values():
        np.testing.assert_allclose(r.losses, jres.losses, rtol=1e-5)
        assert_leaves_close(port_flat(r.params), want, 1e-5, rms)
    # the (1, 2) run's own checkpoint restores into rank trees again: each
    # rank its block, the whole leaves the run's parameters bit for bit
    template = ranks_of(tp, (1, 2))
    params, state, meta = restore_ranks(
        TrainCheckpointer(tmp_path / "tp"), template,
        FT.make_optimizer(FT.TrainConfig(**kw)).init_ranks(template))
    assert meta["step"] == 4
    for a, b in zip(tree_leaves(M.gather_heads(params)),
                    tree_leaves(res[2].params)):
        assert torch.equal(a, b)
    _state_shards_ok(params, state, tp)


# ------------------------------------------------------ guards
@pytest.mark.parametrize("kernel", ["K8", "K1p/K1"])
def test_tp_step_never_takes_an_encoder_kernel(whisper_pair, monkeypatch,
                                               kernel):
    """With the dispatch faked to the card's (use_fused_attention says
    yes), encode_tp's auto mode reaches the wrapper; the TP training step
    does not, and launches nothing."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import attention
    from multimodal_audio_search_tpu_torch.ops import encoder_block
    _, tp = whisper_pair
    ranks = ranks_of(tp, (1, 2))

    def reached(*a, **k):
        raise AssertionError(f"{kernel} reached")
    monkeypatch.setattr(W, "use_fused_attention", lambda t, device: True)
    mod, name, kw = (attention, "fused_encoder_attention", {}) \
        if kernel == "K8" else \
        (encoder_block, "fused_attention_o_residual", {"fused_blocks": True})
    monkeypatch.setattr(mod, name, reached)
    mel = torch.from_numpy(caption_batch(6)["mel"])
    with pytest.raises(AssertionError, match="reached"):
        W.encode_tp(list(ranks), mel, CFG, **kw)
    runtime.reset_counts()
    loss, grads = FT.loss_and_grads(ranks, caption_batch(6), CFG,
                                    mesh=port_mesh((1, 2)))
    assert torch.isfinite(loss) and float(FT.rank_global_norm(grads)) > 0
    assert not any(runtime.COUNTS.values())


def test_model_that_does_not_divide_trains_unsharded(whisper_pair, tp_rows):
    """Three heads at model_parallel=2: the loop logs it and trains a
    whole replica on each data row's first model device (JAX's GSPMD
    would split a head); the result equals the data axis alone."""
    cfg = dataclasses.replace(CFG, d_model=24, heads=3, ffn=48)
    init = W.init_params(torch.Generator().manual_seed(4), cfg)
    batches = make_batches(40, 2)
    logs = []
    kw = dict(init_params=init, device="cpu")
    split = finetune_captioner(batches, cfg, FT.TrainConfig(), n_devices=4,
                               model_parallel=2, log_fn=logs.append, **kw)
    data = finetune_captioner(batches, cfg, FT.TrainConfig(), n_devices=2,
                              log_fn=lambda s: None, **kw)
    assert any("does not split into 2 model shards" in s for s in logs)
    assert not tp_rows
    assert split.losses == data.losses
    for a, b in zip(tree_leaves(split.params), tree_leaves(data.params)):
        assert torch.equal(a, b)


# ------------------------------------------------------ synth
def test_synth_captioner_over_the_model_axis(whisper_pair, tp_rows):
    """train_synth_captioner(mesh=) at (1, 2) against one device (JAX
    replicates over that axis: the same function); its transcription
    through the TP pipeline equals the gathered model's on one device."""
    _, tp = whisper_pair
    tp = weights.whisper_params(_np(JW.init_params(jax.random.PRNGKey(0),
                                                   JW.PRESETS["test"])))
    kw = dict(steps=3, batch=4, seed=0, params_init=tp, device="cpu")
    one = S.train_synth_captioner(**kw)
    assert not tp_rows
    mesh = port_mesh((1, 2))
    split = S.train_synth_captioner(**kw, mesh=mesh)
    assert len(tp_rows) == 3
    np.testing.assert_allclose(split.losses, one.losses, rtol=1e-5)
    waves = np.stack([S.make_clip(np.random.default_rng(i))[0]
                      for i in range(2)])
    pipe = S.synth_pipeline(split, mesh=mesh)
    assert pipe.model_parallel == 2
    assert pipe.transcribe_batch(S.pad_waves(waves, pipe.mel_cfg.n_samples)) \
        == S.transcribe(split, waves)
