"""Float32 rounding yardsticks of the training step's gradients on a card.

    python3 tools/torch_train_noise.py            # one CUDA card

chip_smoke.py's ``[train]`` holds the card's training step to the same
step on the CPU and the (2, 1) data-axis step to the unsplit one. A
gradient leaf that is a residue of cancelling terms (cross-attention q
and its layer norm once the model has trained a little; every leaf of a
captioner whose loss is ~0.04) carries float32 rounding far above 1e-5 of
its own max, whatever the code. This tool measures that rounding with
reorderings that change nothing but the order of the sums, beside the
comparisons chip_smoke asserts, for whisper-tiny:

  * ``init`` and ``trained10`` (fresh parameters, and after 10 steps at
    the shipped geometry: 10 s clips, 30 s mel, T=1500, B=16), one B=2
    step: the card against the CPU, the CPU on 1 thread against 8, the
    batch's rows reversed and the (2, 1) split, each against the card;
  * ``synth600`` (the synthetic captioner after 600 steps at 1 s clips,
    2 s mel, B=16), one B=16 step: the rows reversed and the split.

Each line lists the worst leaves: their max |difference| over their own
max |gradient|, and that max over the tree's largest.
"""
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worst(got, want, n: int = 6) -> list:
    """The ``n`` leaves of ``want`` with the largest max |got - want| over
    their own max: (that ratio, path, the leaf's max over the tree's)."""
    import chip_smoke as C
    fa, fb = C._flat(got), C._flat(want)
    top = max(float(x.abs().max()) for x in fb.values())
    rows = sorted(((float((fa[k].cpu() - fb[k].cpu()).abs().max())
                    / max(float(fb[k].abs().max()), 1e-30), k,
                    float(fb[k].abs().max()) / top) for k in fb),
                  reverse=True)
    return [(f"{r:.2e}", k, f"{s:.1e}") for r, k, s in rows[:n]]


def measure(label: str, params, batch: dict, with_cpu: bool) -> None:
    import chip_smoke as C
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.parallel.mesh import make_mesh
    from multimodal_audio_search_tpu_torch.training import finetune as FT
    cfg = W.PRESETS["tiny"]
    card = torch.device("cuda", 0)
    rev = {k: np.asarray(v)[::-1].copy() for k, v in batch.items()}
    lc, gc = FT.loss_and_grads(params, batch, cfg)
    out = {"loss": float(lc)}
    out["reversed_rows"] = worst(FT.loss_and_grads(params, rev, cfg)[1], gc)
    out["split_2x1"] = worst(FT.loss_and_grads(
        params, batch, cfg, mesh=make_mesh(2, devices=[card] * 2))[1], gc)
    if with_cpu:
        host = C._to(params, "cpu")
        _, gh = FT.loss_and_grads(host, batch, cfg)
        out["card_vs_cpu"] = worst(gc, gh)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        _, g1 = FT.loss_and_grads(host, batch, cfg)
        torch.set_num_threads(threads)
        out["cpu_1_thread_vs_cpu"] = worst(g1, gh)
    C.phase("train_noise", label=label, batch=len(batch["tokens"]), **out)


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.training import finetune as FT
    from multimodal_audio_search_tpu_torch.training import synth as S
    print(C.card_line(), flush=True)
    runtime.select_device("cuda")
    cfg = W.PRESETS["tiny"]
    t0 = time.perf_counter()
    p0 = C._to(W.init_params(torch.Generator().manual_seed(0), cfg), "cuda")
    step, opt = FT.make_train_step(cfg, FT.TrainConfig(
        learning_rate=3e-4, schedule="warmup_cosine", warmup_steps=2,
        total_steps=10, weight_decay=0.0))
    p, st = p0, opt.init(p0)
    for b in C._synth_batches(10, 16, 10.0, 30.0, (2, 6), 7):
        p, st, _ = step(p, st, b)
    b2 = C._synth_batches(1, 2, 10.0, 30.0, (2, 6), 8)[0]
    measure("init", p0, b2, True)
    measure("trained10", p, b2, True)
    m = S.train_synth_captioner(steps=600, batch=16, preset="tiny", seed=0,
                                device="cuda")
    measure("synth600", m.params,
            C._synth_batches(1, 16, 1.0, 2.0, (1, 3), 9)[0], False)
    print(f"seconds {time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
