"""Run chosen phases of chip_smoke.py alone on one CUDA card.

    python3 tools/torch_smoke_phases.py search,embedders,clap,service
    python3 tools/torch_smoke_phases.py decoder,mesh
    python3 tools/torch_smoke_phases.py decoder,tp
    python3 tools/torch_smoke_phases.py train
    python3 tools/torch_smoke_phases.py drift
    python3 tools/torch_smoke_phases.py weights,soak,dcn
    python3 tools/torch_smoke_phases.py f32
    python3 tools/torch_smoke_phases.py f32,tp,ann

Builds the kernels, makes chip_smoke's two WAVs (320 s and 25 s, seed 0)
and runs, in this order, each named phase: ``search`` (K12 and K13
against their plain versions, K12 also at D=768), ``embedders`` and
``clap`` (the secondary models at published widths) and ``service`` (the
HTTP surface, after the ``[audio]`` phase that makes its uploads). Each
phase prints its lines as in chip_smoke.py and raises on a failed check;
the wall seconds of each phase follow it. ``decoder`` is K3, K3-q, K4
and K4-o against their plain versions (K3 and K3-q with their repeats),
``mesh`` the mesh's data and DCN axes (search at 1M segments, the
data-parallel ingest), ``tp`` the mesh's model axis (the partial
kernels K1p, K3p, K4p, K9p and K10p, K2, K5, K6 and K7 on shards, the
engines of chip_smoke.TP_PATHS at (1, 2) and (2, 2)), ``train`` the training subsystem (the synthetic captioner
trained and transcribed through K1 and K2, the production geometry, the
data axis, the model axis on the card named twice, checkpoints, CLAP and
the bridge; ``[drift]`` among them), ``drift`` the synthetic captioner
trained as ``train`` trains it, then ``[drift]`` alone (the drift rows on
it and the host index's storage dtypes). ``weights`` is the weights-day
chain on random-init stand-ins (checkpoint directories -> the engine,
against the in-memory engine), ``soak`` tools/torch_soak.py's single
pass and loop against the server, ``dcn`` the multi-process DCN check at
the JAX tool's size and at 50k x 2 x 384. ``f32`` is the float32 engine
(``[f32]``: K1's, K8's and K2's float32 forms, and K3's, K3-q's, K4's and
K4-o's, at its shapes, then the engine at EngineConfig()'s defaults in
float32 against the same engine with fused_encoder=False and under
fast_lossless, and the float32 "v2" decode steps on its batch; then
K5's, K6's and K7's float32 forms and the float32 engine with the int8
decoder under int8_fused and int8; then K9's and K10's float32 forms and
the float32 engine under fused_encoder "int8" and "paired"); ``tp`` also
runs the float32 partial forms and the float32 engine over the model
axis (chip_smoke.TP_F32_PATHS). ``ann`` is the beyond-memory path
(tools/torch_bench_ivf.py at chip_smoke.ANN_ROWS, then an ann="ivf"
engine).
"""
import os
import sys
import time

import numpy as np
import torch

PHASES = ("f32", "decoder", "search", "embedders", "clap", "service",
          "weights", "soak", "ann", "mesh", "dcn", "tp", "train", "drift")


def main(names: list[str]) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as C
    from multimodal_audio_search_tpu_torch import runtime
    unknown = set(names) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; "
                         f"choose from {PHASES}")
    card = C.card_line()
    print(card, flush=True)
    runtime.select_device("cuda")
    runtime.kernels()
    rng = np.random.default_rng(0)
    clips = [("long.wav", C.make_audio(320, rng)),
             ("short.wav", C.make_audio(25, rng))]
    tp_args = {"k1": {"cases": []}, "k2": {"cases": []},
               "dec": [{"name": n, "cases": []} for n in (
                   "decoder_self_block", "decoder_mlp_block")],
               "int8k": [{"name": n, "cases": []} for n in (
                   "quant_matmul", "single_query_attention_int8",
                   "int8_cached_attention")]}
    run = {"f32": lambda: C.f32_phase(card, clips),
           "decoder": lambda: C.decoder_kernel_phase(
               card, torch.Generator().manual_seed(0)),
           "search": lambda: C.search_kernel_phase(card),
           "embedders": lambda: C.embedders_phase(card, clips),
           "clap": lambda: C.clap_phase(card, clips),
           "service": lambda: C.service_phase(card, rng, C.audio_phase(
               card, np.random.default_rng(1))["uploads"]),
           "weights": lambda: C.weights_phase(card, clips),
           "soak": lambda: C.soak_phase(card),
           "ann": lambda: C.ann_phase(card, clips),
           "mesh": lambda: C.mesh_phase(card, clips),
           "dcn": lambda: C.dcn_phase(card),
           "tp": lambda: C.tp_phase(card, clips, **tp_args),
           "train": lambda: C.train_phase(card),
           "drift": lambda: C.drift_phase(card, C.train_synth_check(card))}
    for name in PHASES:
        if name in names:
            t0 = time.time()
            run[name]()
            print(f"== {name} {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1].split(",") if len(sys.argv) > 1
                  else list(PHASES)))
