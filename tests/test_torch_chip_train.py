"""chip_smoke.py's ``[train]`` phase rehearsed on the CPU at toy sizes
(the "test" Whisper preset at its 2 s context, a narrow CLAP tower and
MiniLM, a small bridge set), and its checks held to planted faults: the
comparison rules of ``leaves_rel_err``, a resumed run that lost its
optimizer state, and a split step that averages its chunks' means
instead of the batch's global masked mean; and the model axis's part
(``train_tp_check``) rehearsed whole, held to a step that leaves a
replicated leaf's gradient as rank 0's share, without the sum over the
ranks."""
import dataclasses

import pytest
import torch

import chip_smoke as C
from multimodal_audio_search_tpu_torch.models import clap as MC
from multimodal_audio_search_tpu_torch.models import minilm
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.parallel import mesh as M
from multimodal_audio_search_tpu_torch.training import finetune as FT
from multimodal_audio_search_tpu_torch.utils.checkpoint import (
    TrainCheckpointer)

torch.set_num_threads(1)
CARD = "cpu rehearsal"


@pytest.fixture
def toy(monkeypatch):
    """The phase's constants and shapes cut to the CPU: the test preset,
    the production part at the preset's 2 s context, B=4 CLAP batches of
    a narrow tower, 256 bridge rows."""
    orig = C._synth_batches

    def batches(n, b, clip_s, mel_s, events, seed, device="cuda"):
        return orig(n, b, min(clip_s, 1.0), min(mel_s, 2.0),
                    (1, 3) if events == (2, 6) else events, seed, device)
    monkeypatch.setattr(C, "_synth_batches", batches)
    for name, v in (("TRAIN_PRESET", "test"), ("TRAIN_B", 4),
                    ("TRAIN_PROD_STEPS", 3), ("TRAIN_CKPT_K", 2),
                    ("TRAIN_CLAP_B", 4), ("TRAIN_CLAP_STEPS", 3),
                    ("TRAIN_CLAP_LR", 3e-3), ("TRAIN_BRIDGE_N", 256),
                    ("TRAIN_TP_STEPS", 1), ("TRAIN_TP_SYNTH_STEPS", 60),
                    ("TRAIN_TP_SYNTH_LR", 3e-3)):
        monkeypatch.setattr(C, name, v)
    monkeypatch.setitem(minilm.PRESETS, "L6", minilm.PRESETS["test"])
    small = dataclasses.replace(MC.ClapConfig(), embed_dim=32, d_model=16,
                                layers=1, heads=2, ffn=32)
    monkeypatch.setattr(MC, "ClapConfig", lambda: small)


def test_leaves_rel_err_rules():
    want = {"a": torch.tensor([1.0, 2.0, 4.0]), "b": torch.tensor([1e-9, 0.0])}
    got = {"a": torch.tensor([1.0, 2.0, 4.0 + 4e-5]),
           "b": torch.tensor([2e-9, 0.0])}
    rel, _ = C.leaves_rel_err(got, want)
    assert rel == pytest.approx(1.0)            # leaf b: 1e-9 of 1e-9
    # a floor of 1e-3 x the tree's largest holds b at 4e-3: a's 1e-5 wins
    rel, held = C.leaves_rel_err(got, want, floor=1e-3)
    assert rel == pytest.approx(1e-5, rel=1e-2) and held == 1


def test_train_parts_rehearsed_on_cpu(toy):
    """Every part but the 150+-step synthetic run (the training tests
    hold that one), on the CPU."""
    fresh = W.init_params(torch.Generator().manual_seed(3),
                          W.PRESETS["test"])
    C.train_production_check(CARD, "cpu")
    C.train_split_check(CARD, fresh, "cpu")
    C.train_checkpoint_check(CARD, "cpu")
    C.train_clap_check(CARD, "cpu")
    C.train_bridge_check(CARD, "cpu")


def test_checkpoint_check_catches_a_lost_optimizer_state(toy, monkeypatch):
    restore = TrainCheckpointer.restore

    def no_opt(self, params_template, opt_template=None, step=None):
        params, _, meta = restore(self, params_template, opt_template, step)
        return params, None, meta
    monkeypatch.setattr(TrainCheckpointer, "restore", no_opt)
    with pytest.raises(AssertionError):
        C.train_checkpoint_check(CARD, "cpu")


def test_split_check_catches_a_mean_of_chunk_means(toy, monkeypatch):
    """Each chunk's nll sum scaled to its own mean (x the mean count):
    the split loss becomes the mean of the chunks' means, which differs
    from the global masked mean where the chunks' mask counts do."""
    orig = FT.nll_sum

    def chunk_mean(params, mel, tokens, loss_mask, *a, **k):
        m = loss_mask.float().sum()
        return orig(params, mel, tokens, loss_mask, *a, **k) / m * \
            (C.TRAIN_B * 4.0)
    monkeypatch.setattr(FT, "nll_sum", chunk_mean)
    fresh = W.init_params(torch.Generator().manual_seed(3),
                          W.PRESETS["test"])
    with pytest.raises(AssertionError, match="loss_rel|grad_rel"):
        C.train_split_check(CARD, fresh, "cpu")


def test_tp_part_rehearsed_on_cpu(toy):
    """train_tp_check whole on the CPU: the (1, 2) and (2, 2) steps
    against the unsplit one, the synthetic captioner trained at (1, 2)
    and transcribed through the TP pipeline, the checkpoint resumed and
    loaded at mp = 1, CLAP at (1, 2)."""
    C.train_tp_check(CARD, "cpu")


def test_tp_check_catches_a_replicated_leaf_without_its_sum(toy,
                                                             monkeypatch):
    """Each leaf that is not split takes rank 0's share of its gradient
    alone (the layer norms' scales lose the other ranks' terms): the
    (1, 2) step's gradients leave the unsplit step's."""
    def rank0_share(params, parts):
        split = M.split_leaves(params[0])
        return orig(params, [[r if j == 0 else [
            g if s else torch.zeros_like(g) for g, s in zip(r, split)]
            for j, r in enumerate(row)] for row in parts])
    orig = FT.sum_rank_grads
    monkeypatch.setattr(FT, "sum_rank_grads", rank0_share)
    with pytest.raises(AssertionError, match="grad_rel"):
        C.train_tp_check(CARD, "cpu")
