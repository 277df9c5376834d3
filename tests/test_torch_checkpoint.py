"""The port's checkpoints (utils/checkpoint.py) against the JAX package's,
and the training loop's plumbing around them:

  * a port-saved parameter tree and optimizer state load in JAX's
    ``load_pytree`` (the state keyed as optax's for the same chain), and
    JAX's files in the port's, array-equal, with identical key sets;
  * a JAX ``finetune_captioner`` checkpoint at step 2 resumes in the
    port, whose next two steps land within 1e-5 of JAX's own resumption
    (losses relative; parameters of each leaf's max, under
    test_torch_training.py's near-zero rule);
  * retention, LATEST, restore by step, resume's step counter and
    ``fast_forward_data``, as tests/test_training_loop.py and
    tests/test_checkpoint_combined.py hold them for JAX;
  * a bfloat16 leaf round-trips as bfloat16, in the bytes JAX writes;
  * the synthetic captioner learns at the JAX test's settings (150 steps,
    B=16) and transcribes within the grammar;
  * training/* imports with jax blocked.
"""
import json
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.training import finetune as JFT
from multimodal_audio_search_tpu.training.loop import (
    finetune_captioner as j_finetune)
from multimodal_audio_search_tpu.utils import checkpoint as JCK
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.parallel.mesh import make_mesh
from multimodal_audio_search_tpu_torch.training import finetune as FT
from multimodal_audio_search_tpu_torch.training.loop import (
    finetune_captioner)
from multimodal_audio_search_tpu_torch.training.synth import (
    SynthVocab, make_clip, train_synth_captioner, transcribe)
from multimodal_audio_search_tpu_torch.utils.checkpoint import (
    TrainCheckpointer, load_pytree, save_pytree)

from test_torch_training import (assert_leaves_close, jax_flat, nu_rms,
                                 port_flat)

torch.set_num_threads(1)


def tiny_cfg(jax_side: bool = False):
    from multimodal_audio_search_tpu.models import whisper as JW
    mod = JW if jax_side else W
    return mod.WhisperConfig(
        vocab_size=64, d_model=16, enc_layers=1, dec_layers=1, heads=2,
        ffn=32, enc_positions=20, dec_positions=12,
        bos_token_id=60, eos_token_id=61, pad_token_id=61)


def make_batches(rng, n_batches, b):
    for _ in range(n_batches):
        yield {
            "mel": rng.normal(size=(b, 80, 40)).astype(np.float32),
            "tokens": np.tile(np.arange(8, dtype=np.int32), (b, 1)),
            "loss_mask": np.ones((b, 7), np.float32),
        }


def _jax_pair():
    from multimodal_audio_search_tpu.models import whisper as JW
    jp = JW.init_params(jax.random.PRNGKey(0), tiny_cfg(True))
    return jp, weights.whisper_params(jax.tree.map(np.asarray, jp))


# ------------------------------------------------------- files both ways
def test_port_files_load_in_jax_and_back(tmp_path):
    jp, tp = _jax_pair()
    tcfg = FT.TrainConfig(schedule="warmup_cosine", warmup_steps=2,
                          total_steps=10)
    jopt = JFT.make_optimizer(JFT.TrainConfig(**tcfg.__dict__))
    topt = FT.make_optimizer(tcfg)
    # one real step on each side, so the moments and counts are non-zero
    step, _ = FT.make_train_step(tiny_cfg(), tcfg)
    b = next(make_batches(np.random.default_rng(0), 1, 2))
    tp1, ts1, _ = step(tp, topt.init(tp), b)
    save_pytree(tp1, tmp_path / "p.npz")
    save_pytree(ts1, tmp_path / "o.npz")
    jparams = JCK.load_pytree(jp, tmp_path / "p.npz")
    jstate = JCK.load_pytree(jopt.init(jp), tmp_path / "o.npz")
    for got, want in ((jax_flat(jparams), port_flat(tp1)),
                      (jax_flat(jstate), port_flat(ts1))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = set(np.load(tmp_path / "o.npz").files)
    assert {"1/0/.count", "1/2/.count", "1/0/.mu/decoder/ln/scale",
            "1/0/.nu/encoder/conv1/w"} <= keys
    # and JAX's own files, of the same trees, load in the port
    JCK.save_pytree(jparams, tmp_path / "jp.npz")
    JCK.save_pytree(jstate, tmp_path / "jo.npz")
    assert set(np.load(tmp_path / "jo.npz").files) == keys
    back = load_pytree(topt.init(tp), tmp_path / "jo.npz")
    assert back[1][0].count.dtype == torch.int32
    for got, want in ((port_flat(load_pytree(tp, tmp_path / "jp.npz")),
                       port_flat(tp1)), (port_flat(back), port_flat(ts1))):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the carrier: a JAX optax state in memory -> the port's
    carried = weights.opt_state(jax.tree.map(np.asarray, jstate))
    assert type(carried[1][0]) is FT.ScaleByAdamState
    assert port_flat(carried).keys() == port_flat(ts1).keys()


def test_missing_leaf_named(tmp_path):
    save_pytree({"w": torch.ones(2)}, tmp_path / "a.npz")
    with pytest.raises(KeyError, match="checkpoint missing leaf 'v'"):
        load_pytree({"w": torch.ones(2), "v": torch.ones(2)},
                    tmp_path / "a.npz")


def test_bf16_leaf_round_trips_as_bf16(tmp_path):
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    tree = {"a": [x, torch.arange(4, dtype=torch.int32)],
            "s": torch.tensor(2.5, dtype=torch.bfloat16)}
    save_pytree(tree, tmp_path / "b.npz")
    z = np.load(tmp_path / "b.npz")
    assert z["a/0"].dtype == np.dtype("V2")           # as JAX writes it
    got = load_pytree(tree, tmp_path / "b.npz")
    assert got["a"][0].dtype == torch.bfloat16 and got["s"].shape == ()
    assert torch.equal(got["a"][0], x) and torch.equal(got["s"], tree["s"])
    # the same bits as JAX's file of the same values
    JCK.save_pytree({"a": [jnp.asarray(x.float().numpy(), jnp.bfloat16),
                           np.arange(4, dtype=np.int32)],
                     "s": jnp.asarray(2.5, jnp.bfloat16)},
                    tmp_path / "j.npz")
    zj = np.load(tmp_path / "j.npz")
    for k in ("a/0", "s"):
        np.testing.assert_array_equal(zj[k].view(np.uint16),
                                      z[k].view(np.uint16))
    # and JAX's file loads here as bf16, a float32 template's too
    got = load_pytree({"a": [torch.zeros(3, 5), torch.zeros(4)],
                       "s": torch.zeros(())}, tmp_path / "j.npz")
    assert got["a"][0].dtype == torch.bfloat16
    assert torch.equal(got["a"][0], x)


# ------------------------------------------------------- JAX run resumed
def test_jax_checkpoint_resumes_in_port(tmp_path):
    """JAX trains 2 steps and checkpoints; JAX and the port each resume
    from that checkpoint and take the same 2 batches."""
    cfg_j, cfg_t = tiny_cfg(True), tiny_cfg()
    kw = dict(learning_rate=3e-3, schedule="warmup_cosine", warmup_steps=1,
              total_steps=6)
    rng = np.random.default_rng(0)
    first = list(make_batches(rng, 2, 4))
    more = list(make_batches(rng, 2, 4))
    j_finetune(first, cfg_j, JFT.TrainConfig(**kw), n_devices=1,
               checkpoint_dir=str(tmp_path / "j"), checkpoint_every=2,
               log_fn=lambda s: None)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    assert (tmp_path / "t" / "LATEST").read_text() == "2"
    jres = j_finetune(more, cfg_j, JFT.TrainConfig(**kw), n_devices=1,
                      checkpoint_dir=str(tmp_path / "j"),
                      log_fn=lambda s: None)
    logs = []
    tres = finetune_captioner(more, cfg_t, FT.TrainConfig(**kw),
                              n_devices=1, device="cpu",
                              checkpoint_dir=str(tmp_path / "t"),
                              log_fn=logs.append)
    assert logs[0] == "resumed from step 2"
    assert jres.steps == tres.steps == 4
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5)
    jp0, _ = _jax_pair()
    jopt = JFT.make_optimizer(JFT.TrainConfig(**kw))
    jst = JCK.load_pytree(jopt.init(jp0),
                          tmp_path / "j" / "step_00000004.opt.npz")
    assert_leaves_close(port_flat(tres.params), jax_flat(jres.params), 1e-5,
                        nu_rms(jst, "1/0/.nu/"))
    meta = json.loads((tmp_path / "t" / "step_00000004.meta.json")
                      .read_text())
    assert meta["step"] == 4 and meta["loss"] == pytest.approx(
        tres.losses[-1])


# ------------------------------------------------------- the loop
def test_train_checkpointer_retention_and_restore(tmp_path):
    ck = TrainCheckpointer(tmp_path, keep=2)
    params = {"w": torch.arange(4, dtype=torch.float32)}
    for step in (1, 2, 3, 4):
        ck.save(step, {"w": params["w"] * step},
                metadata={"loss": 1.0 / step})
    assert ck.latest_step() == 4
    got, _, meta = ck.restore(params)
    assert torch.equal(got["w"], params["w"] * 4)
    assert meta["step"] == 4
    kept = sorted(p.name for p in tmp_path.glob("step_*.params.npz"))
    assert len(kept) == 2 and "step_00000003" in kept[0]
    got3, _, _ = ck.restore(params, step=3)
    assert torch.equal(got3["w"], params["w"] * 3)
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(tmp_path / "empty").restore(params)


def test_finetune_loop_with_checkpoint_resume(tmp_path):
    """tests/test_training_loop.py's run on the port, over a data axis of
    2 CPU entries: losses fall, resume continues the counter, and
    fast_forward_data skips the batches already consumed."""
    rng = np.random.default_rng(0)
    cfg = tiny_cfg()
    kw = dict(n_devices=2, device="cpu", checkpoint_dir=str(tmp_path),
              log_fn=lambda s: None)
    res = finetune_captioner(make_batches(rng, 6, 8), cfg,
                             FT.TrainConfig(learning_rate=3e-3),
                             checkpoint_every=3, **kw)
    assert res.steps == 6 and res.losses[-1] < res.losses[0]
    assert sorted(p.name for p in tmp_path.glob("*.params.npz")) == [
        "step_00000003.params.npz", "step_00000006.params.npz"]
    res2 = finetune_captioner(make_batches(rng, 2, 8), cfg,
                              FT.TrainConfig(learning_rate=3e-3), **kw)
    assert res2.steps == 8
    seen = []

    def batches():
        for i, b in enumerate(make_batches(rng, 10, 8)):
            seen.append(i)
            yield b
    res3 = finetune_captioner(batches(), cfg,
                              FT.TrainConfig(learning_rate=3e-3),
                              fast_forward_data=True, **kw)
    assert res3.steps == 10 and len(res3.losses) == 2
    assert seen == list(range(10))
    # a fresh run without resume starts at 0 and keeps 3 checkpoints
    res4 = finetune_captioner(make_batches(rng, 1, 8), cfg, resume=False,
                              **kw)
    assert res4.steps == 1
    assert TrainCheckpointer(tmp_path).latest_step() == 1


# ------------------------------------------------------- synth learns
def test_synth_captioner_learns_and_transcribes_the_grammar():
    m = train_synth_captioner(steps=150, batch=16, seed=0, device="cpu")
    assert np.mean(m.losses[:10]) > 2 * np.mean(m.losses[-10:])
    rng = np.random.default_rng(99)
    waves, texts = zip(*(make_clip(rng) for _ in range(16)))
    got = transcribe(m, np.stack(waves))
    words = set(SynthVocab.WORDS)
    assert all(set(g.split()) <= words for g in got)
    assert any(g for g in got)
    q = (np.clip(np.stack(waves), -1, 1) * 32767.0).astype(np.int16)
    assert transcribe(m, q.astype(np.float32) / 32767.0) == got
    # and through the pipeline's K1 twin (fused_encoder=None)
    assert all(set(g.split()) <= words
               for g in transcribe(m, np.stack(waves), fused_encoder=None))


def test_synth_mesh_and_int16_transfer_run():
    """The mesh argument (data axis of 2 CPU entries) and the int16
    transfer take the same clips as the plain run: losses within 1e-5."""
    plain = train_synth_captioner(steps=3, batch=4, seed=1, device="cpu")
    split = train_synth_captioner(steps=3, batch=4, seed=1,
                                  mesh=make_mesh(2, device="cpu"))
    np.testing.assert_allclose(split.losses, plain.losses, rtol=1e-5)
    q = train_synth_captioner(steps=2, batch=4, seed=1, device="cpu",
                              transfer_int16=True)
    np.testing.assert_allclose(q.losses, plain.losses[:2], rtol=1e-3)


# ------------------------------------------------------- no jax
def test_training_imports_without_jax(tmp_path):
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        from multimodal_audio_search_tpu_torch.training import (
            bridge, clap, finetune, loop, synth)
        from multimodal_audio_search_tpu_torch.utils import checkpoint
        from multimodal_audio_search_tpu_torch.models import whisper as W
        cfg = W.WhisperConfig(vocab_size=64, d_model=16, enc_layers=1,
                              dec_layers=1, heads=2, ffn=32,
                              enc_positions=20, dec_positions=12)
        rng = np.random.default_rng(0)
        b = {"mel": rng.normal(size=(2, 80, 40)).astype(np.float32),
             "tokens": np.tile(np.arange(8, dtype=np.int32), (2, 1)),
             "loss_mask": np.ones((2, 7), np.float32)}
        res = loop.finetune_captioner([b, b], cfg, device="cpu",
                                      n_devices=1,
                                      checkpoint_dir=sys.argv[1],
                                      log_fn=lambda s: None)
        assert res.steps == 2
        assert not any(m.split(".")[0] == "multimodal_audio_search_tpu"
                       for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
