"""Smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, one line each (``[phase] ...``):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. No card -> the script raises before anything else.
2. build: K1-K14 compiled from ``multimodal_audio_search_tpu_torch/
   csrc`` with nvcc for sm_90a (one nvcc per source, in parallel); build
   seconds and ptxas resource lines.
2b. the audio front door (``[audio]``): the native libraries built from
   native/*.cc with the host's g++ into the port's _build/ (seconds
   each; the WAV/FLAC/resample/quantize library and the MP3 decoder must
   be available, and whether g++ finds the FFmpeg headers is printed), a
   44.1 kHz stereo WAV through the native decoder and resampler equal to
   the numpy path, a FLAC (tests/flac_fixture.py) equal to its PCM, the
   committed MP3 vector against its fingerprint (and libmpg123 where the
   host has it), M4A and OGG decoded where FFmpeg built, else refused
   with the ValueError naming it; host decode ms of each; the native
   quantizers (mu-law, int16, int12) bit-equal to their numpy forms and
   the native mel16/12/8 encoder within MEL_CODE_MAX_DIFF codes, on a
   32-segment batch, each timed.
3. kernels against their plain PyTorch versions on the card, at the
   shapes the main paths give them: K1 (the encoder block on wgmma + TMA,
   a thread-block cluster over the heads, csrc/encoder_block_wgmma.cu) at
   B=32, T=1500, (H, D) = (8, 64) (whisper-base) and (6, 64)
   (whisper-tiny), each on a residual input and on two inputs that
   isolate the attention term (K1_CASES), with its cluster plan; K2
   cross at B=32, T=1500, H=8 and K2 self at B=32, L=68, pos in {0, 3,
   67}; K3 and K3-q at B=32, L=68, pos in K3_POS (each case launched
   K3_REPEATS more times, every launch bit-equal to the first), K4 and
   K4-o at B=32,
   each at both model widths, on inputs whose block term dominates the
   output (DELTA_MAX); K5 (int8 weights) at the (M, K, N) of a decode
   step's dense layers, the tied logits and the cross K/V projection
   over B*1500 rows (K5_SHAPES: its three regimes, each case with its
   split plan, device ms, host us and one torch._weight_int8pack_mm call
   as a yardstick where the card's torch runs it on CUDA; K3, K3-q, K4
   and K4-o also carry device ms and host us), K6 and K7 (int8 K/V) at
   B=32, T=1500, H=8 and H=6 (K7 with its cluster plan, device ms and
   host us); the encoder variants K8 (per-head attention on wgmma
   and TMA, csrc/encoder_attention.cu), K9 (int8
   dots) and K10 (head pairs, K1's cluster kernel with one TMA fetch a
   pair) at B=32, T=1500 and both widths, and K11's
   three forms of the softmax division (K1's cluster kernel, each form a
   template instance) at base width, on K1's inputs;
   K12 (fused search scores) at N=1M and N=1027 in float32 and bf16, at
   N=1M and D=768 (the mpnet / CLIP-text index width) in both, and on
   the validity-rule rows, K13 (streaming read) on a 64 MiB slab and
   at the calibration's 4 GiB x 8 passes, K14 (cross + MLP block, its
   attention split over the keys of a thread-block cluster) at B=32,
   T=1500 and both widths -- K14's own path: its launches are counted
   over this phase, since no decode step calls it.
   Tolerances asserted; median times from CUDA events after a warm-up,
   each beside the card's bound for the same work (bound()) and, for K2
   and K8, one scaled_dot_product_attention call as a yardstick (K13:
   one torch.sum per pass). K2 and K8 and their yardsticks also carry
   ``device_ms`` (torch.profiler's CUDA kernel rows over 20 calls), K2
   its split count and ``host_us`` (the wrapper's enqueue time a call),
   and the lines of K1, K8, K9, K10 and K11 their mechanism: the wgmma,
   TMA and mbarrier instructions counted in their SASS (cuobjdump), which
   must all be there; K14's line its TMA loads, mbarrier operations and
   cluster barriers; K1, K10, K11 and K14 also their cluster plans.
4. the engines (ENGINE_PATHS), each an AudioSearchEngine on cuda (random
   init from a seed, bf16) built from its config alone: the default
   config, ``apply_profile(EngineConfig(), "fast_lossless")``, and the
   int8 decoder memory mode (``quantize_decoder=True`` on both Whisper
   slots) with ``cross_attn="int8_fused"`` and with ``"int8"`` ingest
   two 16-bit WAVs made with numpy (320 s = one full batch of 32
   segments, and 25 s = 3 segments) and answer 4 queries;
   fast_lossless with ``fused_layer="v2"`` and the three encoder
   variants (``fused_encoder`` False -> K8, "int8" -> K9, "paired" ->
   K10, on both decode configs) ingest the 320 s WAV and answer them.
   Each path's launch counts (set to 0 just before, read just after)
   must be > 0 and equal what the path implies; the ASR text of one
   ingested segment, used as a query, must rank its own segment first;
   each engine's peak device memory (reset before its build) is printed
   beside the default's, and its ASR texts' agreement with the default
   engine's. The default engine's encoder and decode steps (unfused,
   fused, "v2") are then held against their plain paths on a small
   input, each int8 engine's first decode step against its quantized
   decoder's bf16 einsum cross attention (INT8_SPAN_MAX), and each
   encoder variant's encoder against the plain encoder (ENC_MEAN_ERR_MAX).
   The default engine also answers its queries with search_batch, equal
   to search, with the float32 index and with index_dtype="bfloat16".
4a. the float32 engine (``[f32]``, after the engines): K1's float32
   form (csrc/encoder_block_f32.cu, 3xTF32 on mma.sync) at B=32, T=1500,
   base and tiny widths against its plain version (F32_BLOCK_ATOL /
   RTOL), F32_REPEATS more launches bit-equal, timed beside the unfused
   float32 route (K8 f32 + addmm + add); K8's and K2's float32 forms at
   the same shapes (cross 1500 keys, self 64), each beside one
   scaled_dot_product_attention call on float32; float32 bounds the
   lesser of the CUDA cores' float32 rate and 3 TF32 products
   (f32_bound, ``bound_rate``). Then make_default_ingest(dtype=
   torch.float32) at EngineConfig()'s defaults ingests the 320 s WAV and
   answers 4 queries (K1 f32 10 launches a dispatch, K2 f32 counted,
   both held to expected_launches), one batch's encoder states within
   F32_ENC_ATOL / RTOL of the plain float32 encoder, then the same engine
   with fused_encoder=False (K8 f32) whose texts and top-10 must be the
   first's; both ingest rates printed. The decoder blocks' float32 forms
   (csrc/decoder_block_f32.cu: K3, K3-q, K4, K4-o; f32_decoder_checks)
   at B=32, L=68 (K3 at every K3_POS) and both widths against their
   plain versions (F32_BLOCK_ATOL / RTOL, the cache row written and no
   other, F32_REPEATS more launches bit-equal), each with ms, queued ms,
   plain ms and its bytes bound; the float32 engine under
   apply_profile(..., "fast_lossless") (K1 f32 10 a dispatch, K3 f32 and
   K4 f32 once a decode step and layer, K2 f32 for the cross attention,
   held to expected_launches), whose texts and top-10 must be the K1
   engine's except where f32_margin_check finds the plain float32
   decode's top-2 margin under F32_MARGIN_REL at the first differing
   step; then the float32 "v2" path on its batch (f32_v2_step_check:
   the prompt's decode steps under "v2", K3-q f32, K4-o f32 and K2 f32
   counted, logits within F32_STEP_LOGITS_REL of the unfused steps').
   Then the int8 decoder on float32 (f32_int8_kernel_checks): K5's
   float32 forms at the float32 twins of K5_SHAPES (F32_BLOCK_ATOL /
   RTOL; every bound at the lesser of FFMA and two TF32 products), K6's
   and K7's at B=32, T=1500, H=8 and 6 (F32_INT8_ATT_MAX / L2, which a
   planted q fault must fail), each with F32_REPEATS launches bit-equal,
   ms, queued ms, plain ms and bound; and the float32 engine with
   quantize_decoder under "int8_fused" and "int8" (launches =
   expected_launches, own segment first, texts beside the K1 engine's,
   warm ingest rate, the first decode step within F32_INT8_STEP_MAX of
   the same step on the plain versions, which the step with a planted q
   fault must fail: f32_int8_step_check).
4b. the transfer codecs (``[codecs]``, after the engines): CODEC_PATHS
   (``fast`` = mulaw8 + short_context + bf16 index, ``fast`` with mel8,
   ``fast_lossless`` with mel16 and with mel12, the default with int12),
   each an engine phase as in 4 over both WAVs, with launch counts, own
   segment first, transfer bytes a segment, host encode ms a batch,
   ingest rate, peak memory and ASR texts beside the default engine's;
   the short-context paths run the encoder at SHORT_T = 500 positions and
   K2 over 500 cross keys, so K1 (base and tiny, every K1_CASES input)
   and K2 cross (H = 8 and 6) are then held against their plain versions
   at B=32, T=500, each case added to its kernel's cases.
5. the A/B path of K11: tools/torch_profile_encoder_kernel_ab.py's run()
   (B=64, T=500 and 1500, each form), launches counted.
6. search at scale, the path of K12 and K13: tools/torch_bench_search_
   scale.py's run() (the card's calibration, then 100k / 400k / 1M
   segments x float32 / bfloat16: scoring, sort, top-k, GB/s and share
   of the calibrated and published read rates, query p50 through the
   MiniLM embedder, the < 50 ms verdict at 1M float32), launches counted.
8. the reference-parity decodes (``[parity]``, run after the engines,
   before 7): PARITY_PATHS, two engines whose captioner decodes with
   ``caption_parity_decode()`` (whisper-tiny, beam-2 over 64 rows a
   32-segment batch, 100 tokens, penalty 1.3, n-gram 3) and whose ASR
   model samples (``asr_parity_decode()`` with method="sample":
   whisper-base, temperature 0.2, penalty 1.05, n-gram 2, 224 tokens),
   the second under ``fast_lossless`` (K3/K4 over the beam rows), ingest
   both WAVs and answer the 4 queries with their launches counted and
   checked as the engine phases' are, own segment first; then, on the
   first engine's pipelines, the invariants that need no oracle
   (parity_invariants: beam with one beam is greedy, cold sampling is
   greedy where the noise cannot reach, one seed reproduces and two
   differ, the self cache keeps its addresses), a 32-segment batch of
   each decode timed beside greedy on the same encoder output; each
   decode kernel of this path against its plain version at the shapes
   the path gives it (parity_kernel_phase: K2 over T=1500 cross keys and
   over the self cache, K3 and K4, at the captioner's 64 beam rows with
   its L=101 cache and the sampled ASR's 32 rows with its L=228 cache,
   at DELTA_MAX / KV_ATOL / K2_ATOL, each case added to its kernel's
   cases in the kernels line), and both engines' peak memory and ingest
   rate beside the default engine's.
7. the service (``[service]``, run after the engines, before 5 and 6):
   ``service/server.py::serve`` over a default-config engine on cuda
   (warm-up on), its accept loop on a daemon thread, every request over
   HTTP with its own deadline: ingest of the 320 s WAV and an async job
   of the 25 s one (K1/K2 launches as expected_launches), search (own
   segment first, four ?q= = four singles, compare_all, the three
   combined modes), a 45 s stream in uneven int16 chunks (its windows =
   ingest_waveform's; the texts' agreement printed), transcribe_long on
   120 s (the ASR model's launches alone), delete (no row of the source
   after it; a row behind the deleted ones found at its new index),
   save / reset / load and a streaming save_incremental, /metrics,
   metrics.csv, stats and a profile trace, uploads of the MP3 vector
   and a FLAC (segments equal to ingest_waveform's on the decoded audio,
   own segment first), reconfigure to whisper-small (K1 at D=768, 12
   heads, own segment first), the mpnet embedder (200, embed_dim 768,
   an empty index, then short.wav ingested with K1/K2 counted and its
   own text first) and a mulaw8 reconfigure at whisper-base back at
   MiniLM-L6 (384-D) that ingests (own segment first),
   10 ingest/delete cycles (VmRSS slope over cycles 6-10 <=
   RSS_SLOPE_MAX_MB), then the CLI (``python -m
   multimodal_audio_search_tpu_torch`` ingest, search --strategy,
   delete, stats) as subprocesses on one --index. Request
   wall times are printed beside the card.

9. beyond-memory search (``[ann]``, after 6): tools/torch_bench_ivf.py's
   run() at ANN_ROWS = 500k segments of MiniLM width (D=384; the tool
   alone runs 1M, and [mesh] searches 1M), which runs no kernel
   (every launch count stays 0): IVF's build stages, exact and IVF query
   p50 at n_probe 4-64 with recall@10, the host index written in float32
   / bfloat16 / int8 to a temporary directory (~2.7 GB) and streamed
   through the card (first-query and p50 ms, GB/s beside the pinned copy
   rate), ``search_ivf`` p50, recall and bytes shipped; with its checks:
   a full probe = exact at 100k segments (float32 and bfloat16), two
   builds identical, the streamed search = the in-memory one for each
   storage dtype (and at 65,536-row chunks), the bytes shipped = the
   candidate rows' and < 5 % of the index at n_probe 8. Then an engine
   of the default config with ``fusion.ann="ivf"`` ingests both WAVs
   through ``ingest_many`` (K1/K2 launches as expected_launches, the
   layout built on the write path, no ``ivf_prewarm_failed``) and
   answers the 4 queries singly and by ``search_batch``, each with its
   ``weight_info["ann"]`` (a full probe at this size), own segment
   first, equal to the exact search on the same store
   (ann_engine_check).

10. the secondary models (``[embedders]`` and ``[clap]``, after
   ``[parity]``, before 7; no kernel of their own -- the JAX package runs
   them in XLA): embedders_phase reconfigures a default engine to
   all-mpnet-base-v2, clip-ViT-B-32-multilingual-v1 and back to
   all-MiniLM-L6-v2 at published widths (embed_dim 768 / 768 / 384, the
   previous pipelines freed, the 25 s clip ingested under each and the
   320 s one under mpnet with K1/K2 as expected_launches, own text
   first, query embeddings card vs CPU within EMBED_ATOL, rebuild wall,
   embed ms, query p50 beside L6's, peak memory); clap_phase runs
   ClapSearch at its default ClapConfig over the 320 s clip (32 rows,
   the >= 1 s keep rule, top-10 = a plain scoring of the store's rows,
   card vs CPU) and the HTSAT-Swin / RoBERTa towers at laion's defaults
   (32 chunks at 48 kHz, B=32 audio-s/s and peak memory, a fused pair
   with one row over 10 s, the text tower's ms; card vs CPU within
   CLAP_ATOL / EMBED_ATOL).

11. the mesh's data and DCN axes (``[mesh]``, after 9; no kernel of its
   own: the sharded search scores in plain torch, as the JAX package's
   does): mesh_search_check on the [ann] data (1M segments, D=384,
   float32) over MESH_DP shards, the card named MESH_DP times -- the
   exact sharded search = the unsharded scan (ids, valid, num_valid;
   scores within K12_ATOL) with both p50s, the sharded IVF (full probe
   = exact, recall@10 at n_probe MESH_PROBE, build seconds), and in an
   NCCL group of one process (a FileStore) the two-stage hierarchical
   top-k and IVF = the flat results; then mesh_ingest_check: the
   default config through make_default_ingest(cfg, mesh=...) over
   MESH_INGEST_DP chunks on the 25 s clip against the same config
   without a mesh (K1/K2 as expected_launches of the chunks, the same
   segments, the encoder within ENC_MEAN_ERR_MAX, tokens equal except on
   rows within the logits' margin, counted; top-10 of the sharded and
   the unsharded searcher identical), and the device indices the
   kernel library was set up on.

12. the mesh's model axis (``[tp]``, after 11; Megatron tensor
   parallelism over TP_MP ranks, the card named once a rank):
   tp_kernel_phase holds the kernels' partial forms at a rank's shard to
   their plain twins -- K1p at B=32, T=1500 on whisper-base's, -tiny's
   and -large-v3's H / 2 heads with the layer's Wo rows (the attention
   term, K1_Y_MAX / K1_Y_L2; 16 repeats bit-equal), K2 on 4 and 3 heads
   (cross T=1500, self L=68), K3p (B=32, L=68, pos=67) and K4p (F / 2)
   at base width (DELTA_MAX, KV_ATOL; 16 repeats each) -- each timed
   (CUDA events and the profiler's device ms) beside its square form,
   and the ranks' partials through model_sum against the square K1 / K3
   / K4 on the whole layer; the encoder variants' partial forms the
   same way (tp_variant_kernels: K9p on 4 and 3 heads, K10p on 4, 16
   repeats bit-equal, summed against square K9 / K10), K5 at the column
   and row shard shapes of whisper-base's decoder (TP_K5_SHAPES), K6 and
   K7 on 4 and 3 heads at cross T=1500, each beside its square form;
   then mesh_ingest_check with a model axis of TP_MP under each of
   TP_PATHS on the 25 s clip -- the default config and fast_lossless at
   (dp, mp) = (1, 2) and (2, 2); parity (sampled ASR, beam-2 captions),
   "v2" (the True form over the axis: K3p, K2, K4p), int8_fused (K5 +
   K6), int8 (K5 + K7), enc_int8 (K9p) and enc_paired (K10p at base, K1p
   at tiny's 3 heads a rank) at (1, 2) -- against the unsplit engine:
   every launch once a rank (split_expected: the int8 decoder's logits
   once; K1 = 2 x the unsplit 10 on the default config; every chunk at
   least 8 rows under fused_layer, so K3 and K4 run at (2, 2) too), the
   same segments, the encoder within ENC_MEAN_ERR_MAX, tokens equal
   outside the logits' margin (sampling: the margin of logits / t + the
   same noise; beam: of the 2k + 1 best candidates), top-10 identical to
   the sharded and the unsplit engines' searchers; each split and
   unsplit dispatch's wall ms beside, and [tp]'s seconds after each
   path.

13. training (``[train]``, after 12; ROADMAP A14): no kernel in a
   training step (each part's launch counts over its steps must be 0),
   then the trained captioner through K1 and K2. train_synth_check:
   whisper-tiny trained on synthetic clips (training/synth.py: 1 s
   clips, 2 s mel, B=16, warmup_cosine, float32) for TRAIN_STEPS steps,
   its loss falling more than 2x, steps/s and peak memory; 16 held-out
   clips transcribed through the serving pipeline with fused_encoder
   None (K1 + K2, counted) and False (the plain encoder, K2), every text
   from the grammar, the routes agreeing on TRAIN_AGREE_MIN;
   train_production_check: the shipped geometry (10 s clips, 30 s mel,
   T=1500, B=16) for TRAIN_PROD_STEPS timed steps (step ms, audio-s
   trained a second, TF32 off and printed), one B=2 step against the
   CPU's at fresh and trained parameters; train_split_check: the (2, 1)
   data-axis step against the unsplit one; train_tp_check (ROADMAP
   A14b): the model axis on one card named twice (four times for (2,
   2)): at the shipped geometry a (1, 2) and a (2, 2) step against the
   unsplit one, timed (1, 2) steps beside unsplit ones with peak memory
   and each rank's state bytes, the synthetic captioner trained at (1, 2)
   until its loss falls more than 2x and transcribed through the TP
   pipeline (K1p and K2 on head shards, counted), a (1, 2) checkpoint
   resumed = an uninterrupted run and loaded at mp = 1, CLAP at (1, 2);
   train_checkpoint_check: save
   at k, resume, continue to 2k = an uninterrupted run (deterministic
   algorithms on), a bf16 tree round-tripped; train_clap_check: CLAP at
   ClapConfig() + MiniLM L6, B=32, TRAIN_CLAP_STEPS steps on 32 fixed
   pairs, the in-batch accuracy rising; train_bridge_check: train_bridge
   on TRAIN_BRIDGE_N features for 50 epochs, the loss falling.

14. drift (``[drift]``, inside 13, after train_split_check; it trains
   nothing): train_synth_check's captioner measured by
   tools/torch_synth_drift.py (its ``measure``) on DRIFT_CLIPS held-out
   clips from their own generator, every row of the tool (its opt-in
   fused_enc_f32, fused_layer_f32, v2_f32 and int8_dec_f32 /
   int8_fused_f32 / int8_kv_f32, the float32 forms of K1, K3 + K4, K3-q
   + K4-o and K5 (+ K6 / K7), included); one line a row with its
   agreement with the parity row (exact, token F1), its exact rate
   against the truth, its dtype and the launches it made by kernel. Each lever row must launch its lever's
   kernels (DRIFT_LEVERS), the float32 parity row none of them (and K2's
   float32 form), each lever row must agree with the bf16 row
   (DRIFT_F32_ROWS: the float32 parity row) on at least
   DRIFT_LEVER_AGREE of the clips, int16 must give the parity row's
   texts, every text must be in the grammar. On the card the kernels at
   the rows' shapes are held against their plain versions
   (drift_kernel_checks: K2's and K8's float32 forms, K6 and K7 and their
   float32 forms, and K9 at 100 keys / T=100).
   Then tools/torch_bigindex_drift.py at DRIFT_BIG_N rows (D=384; ~1.5 GB
   of temporary files, removed): the bf16 and int8 host indexes' recall@10
   against float32's must meet DRIFT_RECALL_FLOOR.

15. checkpoint directories (``[weights]``, after 7): weights_phase writes
   random-init stand-ins of whisper-base, whisper-tiny and MiniLM-L6 at
   published widths (write_standins: the parameters the engine draws from
   WEIGHTS_SEED in memory, under HF's key names, config.json +
   pytorch_model.bin by torch.save, no tokenizer assets); each loads and
   converts (models/convert.py) back to the tree written, bit for bit;
   tools/torch_weights_day.py's run(dry_run=True) on the card reports the
   presets' init parameter counts and the hash tokenizer; an engine
   built from the directories (EngineConfig weight paths) ingests
   short.wav with K1 and K2 as expected_launches, ranks its own segment
   first, and its segments, texts, launches and top-10 equal the
   in-memory engine's. Write, load and convert seconds and the ingest
   wall are printed.

16. the service soak (``[soak]``, after 15): tools/torch_soak.py's single
   pass against the port's server on the card (production defaults, a
   temporary data root, a SOAK_SECONDS WAV), then its ``_soak_loop`` for
   SOAK_LOOP_MINUTES: every status 200, the three checks true, the RSS
   samples' least-squares slope and the launches printed.

17. multi-process DCN (``[dcn]``, after 11): tools/torch_multiprocess_
   dcn_check.py with two processes in one Gloo group, each naming the card
   twice, at each of DCN_RUNS (the JAX tool's 512 x 2 x 64, then 50k x 2
   x 384, the engine's width; the script's time pays for no 1M-row run,
   which the tool alone runs with --rows):
   the hierarchical sharded top-k and a data-parallel gradient summed
   across the processes, each against the process's single-device
   computation; both MPDCN_OK lines and ALL OK required.

The line before the last two is the card (nvidia-smi), then the kernels
JSON object (K1-K14, then K9p and K10p, then the float32 forms of K1,
K2, K8, K3, K3-q, K4, K4-o, K5, K6 and K7), the last line ``{"ok": true, "device":
{...}}``. ``[seconds]`` prints each phase's wall seconds; [ann] runs at
ANN_ROWS (half the IVF tool's 1M) to pay for [f32]'s decoder parts.
Any failure raises (exit code != 0).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000

# tolerances of kernel vs plain version on identical bf16 inputs
# K1 is held to its plain version on three inputs at each shape
# (K1_CASES). The kernel rounds P to bf16 before PV (the TPU kernel's
# rounding) where the plain version keeps f32, and the two sum in
# different orders.
# * "residual" (x ~ N(0, 1), bo ~ 0.1 N(0, 1)): out = x + y + bo
#   elementwise within 2 bf16 ulps relative + 1e-2. This checks the
#   residual and bias epilogue; x dominates out, so it cannot see the
#   attention term y = attn @ Wo (~0.04 in scale).
# * "attention" (x = 0, bo = 0, unit-variance logits) and "peaked" (the
#   same with q scaled by 3): out is y alone, held to the plain y relative
#   to its own scale: max |err| <= K1_Y_MAX * max |y_ref| and
#   ||err|| <= K1_Y_L2 * ||y_ref||. A float32 emulation of the kernel's
#   roundings (its 128-key tiles and cluster, tests/test_torch_k1_wgmma.py)
#   at T=1500 reads 0.46 % and 0.32 %; the 36 zero-padded keys of the
#   last 128-key tile left unmasked read 1.37 % and 1.47 % on the
#   "attention" input, a rank's heads missing from the merged tile or
#   read before the cluster barrier over 70 %, and a missing 1/l over
#   300 % (tests/test_torch_kernels.py, tests/test_torch_k1_wgmma.py and
#   tests/test_torch_cuda.py plant these faults and show the check
#   rejects them).
K1_ATOL, K1_RTOL = 1e-2, 1.6e-2
K1_Y_MAX, K1_Y_L2 = 1e-2, 7e-3
# K9's launches a case beyond the first, each held bit-equal to it: K9
# sums in a fixed order, so a launch that differs shows a race (its Wo
# stages were once refilled under loads still in flight, in ~1 % of
# launches; tools/torch_kernel_repeat.py takes 2000 a width)
K9_REPEATS = 16
# K3's and K3-q's launches a case beyond the first, held so too: their
# warps read the weight ring's tiles with ldmatrix and hand a slot back
# to TMA, the pattern that raced in K9 before its proxy fence
K3_REPEATS = 16
# (label, q scale, residual)
K1_CASES = (("residual", 1.0, True), ("attention", 1.0, False),
            ("peaked", 3.0, False))
# K8-K11, K1's relatives, are held as K1 is on K1's inputs at each shape:
# K9, K10 and K11 (x + attn @ Wo + bo) on the residual input elementwise
# and on the attention term alone relative to its scale (check_k1); K8,
# which has no residual, on its output relative to its scale (check_rel
# with K1_Y_MAX, K1_Y_L2). Readings on an H100 at B=32, T=1500, both
# widths: at most 0.59 % (max) and 0.32 % (norm) of the term. K9 and its
# plain version compute the same integer dots, so they differ only where
# exp and the order of the float32 sum l move a p8 code across a
# rounding boundary: at most 0.38 % / 0.012 %. Planted faults in float32
# emulations at T=1500 read (max / norm; tests/test_torch_encoder_
# variants.py): K8's 36 zero-padded keys of the last 128-key tile left
# unmasked 1.26 % / 1.44 %; K9 with head 0's key scales for every head
# 383 % / 55 %; K10 pairing each odd head's queries with its partner's
# keys 89 % / 80 %; K11 without its 1/l over 9000 %.
# K2: f32 output, f32 softmax and products on the same bf16 inputs in
#     both -> only the summation order differs. K2 splits T (12 splits of
#     125 keys at T=1500) and merges the splits' states; a float64
#     emulation of that arithmetic at B=32, T=1500 reads 1.6e-7, and the
#     planted split faults (tests/test_torch_k2_split.py) read: the first
#     key of every split but the first dropped, max |err| 2.3e-2 with 11109
#     of 16384 elements outside the limit (21.8x it at worst); the last key
#     of every split but the last counted twice, 5.0e-2, 11299 outside
#     (47.6x).
K2_ATOL, K2_RTOL = 1e-3, 1e-3
# K3 (self block), K3-q, K4 (MLP block), K4-o: kernel and plain version
# round to bf16 at the same places, and sum in different orders, so a
# rounding may land one bf16 step apart and carry on from there.
# * The block's term out - x is held to the plain version's, relative to
#   its own scale: max |err| <= DELTA_MAX * max |d_ref| and ||err|| <=
#   DELTA_L2 * ||d_ref||. The inputs make that term dominate: x ~ 0.01
#   N(0, 1), which the layer norm scales up to unit size, while the
#   residual it is added to stays small, so an error in the attention or
#   the MLP is not hidden under x (K1's lesson). A float64 emulation of
#   the kernels' roundings at these inputs (B=32, both widths) reads at
#   most 0.29 % (max) and 0.04 % (norm). Planted faults read: the fresh
#   row counted twice 14-28 % / 9-24 % at pos 3 and 67; dropped, 17-82 %
#   / 10-58 % (non-finite at pos 0); the unwritten cache row pos attended,
#   55-61 % / 53-54 % at pos 0 and 0.6-0.8 % / 0.9 % at pos 67; fc1's
#   bias left out, 44-46 % / 46-47 %. Each fault fails at one pos at
#   least (tests/test_torch_decoder_block.py holds these checks to it).
# * k1, v1 and q_cross (unit scale) elementwise within 1e-2 + 1e-2
#   relative: one bf16 step of a value in [1, 2) is 7.8e-3.
DELTA_MAX, DELTA_L2 = 2e-2, 5e-3
KV_ATOL, KV_RTOL = 1e-2, 1e-2
K3_POS = (0, 3, 67)
# (label, D, heads, F): whisper-base and whisper-tiny widths
DEC_WIDTHS = (("base", 512, 8, 2048), ("tiny", 384, 6, 1536))
# the engine's kernel path (K1 encoder, K2 decode step) against its plain
# path (plain encoder, einsum cross attention) on one bf16 input: both
# round bf16 activations at different places through 6 layers. Limits are
# twice the readings on an H100 (encoder mean 0.0059, logits max 0.021 on
# a scale of 2.23); PERF.md lists what planted faults read.
ENC_MEAN_ERR_MAX = 1.2e-2
LOGITS_ERR_REL = 2e-2
# four fused decode steps (fused_layer True and "v2", B=8) against the
# unfused steps on the same bf16 weights: max |err| of the logits over
# the steps, relative to their max.
FUSED_LOGITS_ERR_REL = 2e-2
# K5 (int8 weights): every product of a bf16 x with an int8 code is exact
# in float32 (8 + 7 significant bits), so kernel and plain version differ
# only in the order of their float32 sums: elementwise within K5_ATOL of
# max |ref| + K5_RTOL relative; a bf16 output may round one bf16 step
# apart (2^-7 = 7.8e-3). (A float32 x's product is not exact, 24 + 7 bits:
# the float32 form rounds it as the plain version does, in another order;
# [f32] holds that form at F32_BLOCK_ATOL / RTOL.)
# Planted faults -- the last, partial column tile of N = 51865 left out,
# or the scale indexed by row -- are off by 100 % and ~50 % of a value
# (tests/test_torch_quant.py).
K5_ATOL, K5_RTOL_F32, K5_RTOL_BF16 = 1e-4, 1e-4, 8e-3
# (M, K, N, output dtype, bias) at both widths: a decode step's q/k/v/o,
# fc1 and fc2 (bf16 out with bias), the tied logits (float32 out), the
# cross K/V projection over B*1500 encoder rows (bf16 out)
K5_SHAPES = tuple(
    (m, k, n, dt, bias)
    for d, f in ((512, 2048), (384, 1536))
    for m, k, n, dt, bias in (
        (32, d, d, "bf16", True), (32, d, f, "bf16", True),
        (32, f, d, "bf16", True), (32, d, 51865, "f32", False),
        (48000, d, d, "bf16", True)))
# K6 and K7 (int8 K/V): kernel and plain version compute the same integer
# dots (K6, exact) or exact float32 products (K7) and differ in exp and in
# the order of float32 sums; where that moves a weighted probability
# across a rounding boundary of its int8 code (K6) or of bf16 (K7), one
# term moves by one code step. Held relative to the output's scale: max
# |err| <= INT8_ATT_MAX * max |ref| and ||err|| <= INT8_ATT_L2 * ||ref||.
# Float64 emulations of the kernels' arithmetic at B=8, T=1500, H=8 and
# 6 read 0 / 0 (K6: no code moved) and at most 2.0e-4 / 3.5e-5 (K7).
# Planted faults read: K6 with head 0's q scale for every head 0.17-0.20 /
# 0.067-0.10, K6 with the pos mask ignored 0.59-0.62 / 0.57-0.59, K7 with
# vs left out of the weighted probabilities 47-50 / 49
# (tests/test_torch_int8_attention.py).
INT8_ATT_MAX, INT8_ATT_L2 = 1e-2, 2e-3
# keys attended in K6's masked case (a cache of 1000 rows)
K6_POS = 999
# an int8 engine's first decode step (B=8) against the same quantized
# decoder with bf16 cross K/V and the einsum attention: the JAX package's
# guardrail for these modes (max |err| < 5 % of the logits' span, argmax
# agreement >= 0.9; tests/test_cross_attention.py, tests/test_int8_kv.py)
INT8_SPAN_MAX, INT8_AGREE_MIN = 5e-2, 0.9
# K12 (fused search scores): kernel and plain version compute the same
# float32 dot products in different orders (a warp's shuffle tree, a
# matmul), so the scores of rows both call valid agree within K12_ATOL.
# A row's validity may differ only where such a rounding can move its
# score across the threshold or its larger sim across 0 (within K12_ATOL
# of either); those rows are counted ("edge_rows", "validity_flips").
# The top-10 ids must match wherever the plain scores' gaps to their
# neighbours exceed K12_ATOL. The rule rows (k12_rule_inputs: the JAX
# tests' validity cases and a score exactly at the threshold, exact in
# float32 and bf16) must come out bit for bit: a kernel comparing with
# >= fails there (tests/test_torch_search.py, tests/test_torch_cuda.py).
K12_ATOL = 1e-5
# (N, index dtype): the search path's largest index and an odd tail
K12_SHAPES = ((1_000_000, "float32"), (1_000_000, "bfloat16"),
              (1027, "float32"), (1027, "bfloat16"))
K12_RULE_THRESHOLD = 0.125
# K12 at the 768-D index of the mpnet / CLIP-text embedders (A11)
K12_WIDE = ((1_000_000, "float32"), (1_000_000, "bfloat16"))
K12_WIDE_D = 768
# K13 (streaming read): every column sum of a random 64 MiB bf16 slab
# (uniform in [0, 1), so no sum cancels) within K13_RTOL of the plain
# float32 sums, over all `cols` columns: a kernel that read only the 128
# columns the wrapper returns would leave 384 of 512 sums at zero and
# report 4x the real rate (tests/test_torch_calibrate.py). Timed at the
# calibration's shape, 4 GiB x 8 passes.
K13_RTOL = 1e-3
K13_CHECK_SHAPE = (65536, 512)
# K14 (cross + MLP block) at B=32, T=1500 and both widths on two inputs:
# "block" (x ~ 0.01 N(0, 1), so the block's term dominates; held by
# check_delta as K4-o is) and "attention" (x, bco, fc1 and fc2 zero, Wco
# the identity: the output is the bf16-rounded attention alone, held
# relative to its scale with K1's attention limits).
K14_T = 1500
# On the "attention" input K14 is also held to its plain version bit for
# bit (check_bits): the two round p to bf16 at the same place and divide
# by l after PV, so only the order of float32 sums differs, and an output
# element's bf16 rounding flips where that moves it across a rounding
# boundary. A float64 emulation of the kernel at B=8, T=1500 matches on
# more than 99 % of the elements (its split-T cluster too: 0.9988 and 1.0
# at 1, 2 and 12 ranks, seeds 0 and 1, where the ranks exchange the
# global max before any p is rounded); dividing by l before PV, or
# leaving p unrounded, moves attention values by up to 2^-9 relative and
# matches on far fewer, and so does K2's split merge, p rounded against
# each split's own max: 0.50-0.58 (tests/test_torch_cross_mlp.py).
K14_EQUAL_MIN = 0.99


# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# 700 W limit): tensor-core operations per second by input type (f32:
# the CUDA cores, outside the tensor cores; tf32: the tensor cores'
# TF32 rate), and the device memory's bytes per second
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
HBM_BYTES_S = 3.35e12


def bound(nbytes: float, **ops: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate of their type
    (``bf16=..., int8=..., f32=...``, summed over the types)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def f32_bound(nbytes: float, flops: float, products: int = 3) -> dict:
    """bound() of a float32 kernel's function: the lesser of its float32
    operations on the CUDA cores and of ``products`` TF32 products each on
    the tensor cores (3xTF32, the float32 forms' arithmetic:
    csrc/tf32x3.cuh; 2 where one operand is exact in TF32, as K5's int8
    codes are); ``bound_rate`` names the one taken ("f32", "3xtf32" or
    "2xtf32")."""
    by_rate = {"f32": bound(nbytes, f32=flops),
               f"{products}xtf32": bound(nbytes, tf32=products * flops)}
    rate = min(by_rate, key=lambda r: by_rate[r]["bound_ms"])
    return {**by_rate[rate], "bound_rate": rate}


def nbytes(*tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors
               if a is not None)


def attn_o_bound(b: int, t: int, heads: int, d: int = 64,
                 int8: bool = False) -> dict:
    """bound() of K1's function (and K9-K11's) at [B, T, H*D]: q/k/v
    (int8 K/V with float32 scales for K9), x and out, Wo and bo; the two
    attention products (int8 for K9) and the o-projection."""
    hd = heads * d
    kv = 2 * b * t * hd + 8 * b * heads * t if int8 else 4 * b * t * hd
    attn = 4 * b * heads * t * t * d
    ops = {"bf16": 2 * b * t * hd * hd}
    if int8:
        ops["int8"] = attn
    else:
        ops["bf16"] += attn
    return bound(2 * b * t * hd + kv + 4 * b * t * hd + 2 * hd * hd + 2 * hd,
                 **ops)


_START = time.perf_counter()
_LINES: list = []      # (phase name, time.perf_counter()) of every line


def phase(name: str, **kv) -> None:
    _LINES.append((name, time.perf_counter()))
    print(f"[{name}] " + json.dumps(kv, default=str), flush=True)


def phase_seconds() -> dict:
    """Wall seconds a phase: the time from the line before each of its
    lines to that line, summed over its lines (the build's under
    [build], the script's start under its first phase)."""
    out, prev = {}, _START
    for name, t in _LINES:
        out[name] = out.get(name, 0.0) + t - prev
        prev = t
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median per-call milliseconds from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# calls of device_ms whose profiles all came back without device time, so
# that their milliseconds are queued CUDA-event times ([profiler] lines)
PROFILER_FALLBACKS = []


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Device milliseconds a call: torch.profiler's CUDA kernel rows
    (device_type CUDA only: the op rows repeat the same time) over
    ``reps`` calls after a warm-up, summed and divided by ``reps``. A
    profile that comes back without device time is taken again, ``tries``
    times in all. Late in the script torch.profiler has come back without
    device time in every try, for SDPA and for the hand kernels alike (on
    an H100); then the call is timed by CUDA events instead, ``reps``
    calls queued behind a sleep kernel
    (tools/torch_decode_kernel_ab.py::queued_ms), and a [profiler] line
    says so."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    ms = load_tool("torch_decode_kernel_ab").queued_ms(fn, n=reps)
    PROFILER_FALLBACKS.append(ms)
    # printed outside phase(), so the seconds stay the running phase's
    print("[profiler] " + json.dumps({
        "note": f"{tries} profiles held no device time; CUDA events over "
                f"{reps} queued calls instead", "device_ms": ms,
        "fallbacks": len(PROFILER_FALLBACKS)}), flush=True)
    return ms


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call: the wall time of ``n`` calls issued back
    to back without a synchronise, after a warm-up (fewer launches than
    the card's queue holds, so none waits for the device)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def sass_counts(function: str, opcodes=("HGMMA", "UTMALDG", "SYNCS")) -> dict:
    """How often each SASS opcode occurs in the built kernel library's
    function whose name contains ``function`` (cuobjdump -sass)."""
    from multimodal_audio_search_tpu_torch import runtime
    tool = os.path.join(os.path.dirname(runtime._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", runtime.build_info["library"]],
                          capture_output=True, text=True, check=True).stdout
    counts, inside = dict.fromkeys(opcodes, 0), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside:
            for op in opcodes:
                counts[op] += op in line
    return counts


def wav_bytes(x: np.ndarray, rate: int = SR) -> bytes:
    """Mono 16-bit PCM WAV in memory."""
    payload = (np.clip(x, -1.0, 1.0 - 1.0 / 32768) * 32768.0) \
        .astype("<i2").tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(payload),
                      b"WAVE", b"fmt ", 16, 1, 1, rate, rate * 2, 2, 16,
                      b"data", len(payload))
    return hdr + payload


def make_audio(seconds: int, rng: np.random.Generator) -> np.ndarray:
    """Distinct 10 s pieces (tones of different pitch and noise of
    different level) so the segments differ from one another."""
    out = []
    t = np.arange(10 * SR) / SR
    for i in range(-(-seconds // 10)):
        f = 110.0 * 2 ** (i / 5)
        piece = 0.3 * np.sin(2 * np.pi * f * t) * (1 + (i % 3)) / 3 \
            + rng.normal(size=t.size) * 0.02 * (1 + i % 7)
        out.append(piece)
    return np.concatenate(out)[: seconds * SR].astype(np.float32)


def _same_shape_finite(name, got, ref) -> None:
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite values")


def check_close(name, got, ref, atol, rtol) -> float:
    got, ref = got.float(), ref.float()
    _same_shape_finite(name, got, ref)
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {atol} + rtol "
            f"{rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def k1_inputs(gen: torch.Generator, b: int, t: int, heads: int, *,
              q_scale: float = 1.0, residual: bool = True,
              device="cuda"):
    """K1's inputs in bf16 as the encoder hands them over: q/k/v are
    head-split views of [B, T, H*D] dense outputs. Without ``residual``,
    x and bo are zero, so the output is the attention term alone."""
    d = 64
    hd = heads * d

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device, torch.bfloat16)

    q, k, v = (rn(b, t, hd, scale=s).view(b, t, heads, d).transpose(1, 2)
               for s in (q_scale, 1.0, 1.0))
    wo = rn(hd, hd, scale=1 / math.sqrt(hd))
    if residual:
        x, bo = rn(b, t, hd), rn(hd, scale=0.1)
    else:
        x = torch.zeros(b, t, hd, device=device, dtype=torch.bfloat16)
        bo = torch.zeros(hd, device=device, dtype=torch.bfloat16)
    return q, k, v, x, wo, bo


def k2_inputs(gen: torch.Generator, b: int, t: int, heads: int, *,
              device="cuda"):
    """K2's inputs in bf16 as a decode step hands them over: the query
    [B, H*64] and merged-head K/V [B, T, H*64], all ~ N(0, 1)."""
    hd = heads * 64
    return tuple(torch.randn(*shape, generator=gen).to(device, torch.bfloat16)
                 for shape in ((b, hd), (b, t, hd), (b, t, hd)))


def check_k1(name, got, ref, residual: bool) -> dict:
    """K1's output against its plain version's (see K1_CASES); raises
    outside the tolerance, returns the errors."""
    if residual:
        return {"max_abs_err": check_close(name, got, ref, K1_ATOL,
                                           K1_RTOL)}
    got, ref = got.float(), ref.float()
    _same_shape_finite(name, got, ref)
    err = got - ref
    rel_max = float(err.abs().max() / ref.abs().max())
    rel_l2 = float(err.norm() / ref.norm())
    if not (rel_max <= K1_Y_MAX and rel_l2 <= K1_Y_L2):
        raise AssertionError(
            f"{name}: attention term off its plain version: max |err| = "
            f"{rel_max:.3e} of max |y| (limit {K1_Y_MAX}), ||err|| = "
            f"{rel_l2:.3e} of ||y|| (limit {K1_Y_L2})")
    return {"max_abs_err": float(err.abs().max()), "rel_max_err": rel_max,
            "rel_l2_err": rel_l2}


def check_repeats(name, fn, first, n: int) -> int:
    """``n`` more launches of a kernel on the inputs that gave ``first``,
    each bit-equal to it; raises on the first that differs, returns n."""
    for i in range(n):
        again = fn()
        if not torch.equal(again, first):
            raise AssertionError(
                f"{name}: launch {i + 2} on the same inputs differs from "
                f"the first in {int((again != first).sum())} elements")
    return n


def _rand(gen: torch.Generator, device, dtype=torch.bfloat16):
    def rn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(
            device, dtype)
    return rn


def k3_inputs(gen: torch.Generator, b: int, l: int, d: int, *,
              device="cuda", dtype=torch.bfloat16):
    """K3/K3-q inputs as the decode step hands them over: x [B, D] bf16 at
    0.01 N(0, 1); the self sub-block's LN (float32 scale), q/k/v/o
    weights [D, D] and biases in bf16; the cross LN, q weight and bias
    (K3-q's tail); unit-scale caches [B, L, D]. ``dtype`` float32: the
    same draws, every tensor float32 (the float32 forms' inputs)."""
    rn, rf = _rand(gen, device, dtype), _rand(gen, device, torch.float32)
    w = 1 / math.sqrt(d)
    selfw = [rf(d, scale=0.1, shift=1.0), rn(d, scale=0.1),
             rn(d, d, scale=w), rn(d, scale=0.1), rn(d, d, scale=w),
             rn(d, d, scale=w), rn(d, scale=0.1), rn(d, d, scale=w),
             rn(d, scale=0.1)]
    tail = [rf(d, scale=0.1, shift=1.0), rn(d, scale=0.1),
            rn(d, d, scale=w), rn(d, scale=0.1)]
    return rn(b, d, scale=0.01), selfw, tail, rn(b, l, d), rn(b, l, d)


def k4_inputs(gen: torch.Generator, b: int, d: int, f: int, *,
              device="cuda", dtype=torch.bfloat16):
    """K4/K4-o inputs: x [B, D] bf16 at 0.01 N(0, 1); the MLP's LN (float32
    scale), fc1 [D, F], fc2 [F, D] and biases in bf16 (fc1's bias at
    0.5 N(0, 1), so it moves the GELU); the cross attention output
    [B, D] float32 and the cross o-projection (K4-o's head). ``dtype``
    float32: the same draws, every tensor float32."""
    rn, rf = _rand(gen, device, dtype), _rand(gen, device, torch.float32)
    mlp = [rf(d, scale=0.1, shift=1.0), rn(d, scale=0.1),
           rn(d, f, scale=1 / math.sqrt(d)), rn(f, scale=0.5),
           rn(f, d, scale=1 / math.sqrt(f)), rn(d, scale=0.1)]
    head = [rf(b, d, scale=0.3), rn(d, d, scale=1 / math.sqrt(d)),
            rn(d, scale=0.1)]
    return rn(b, d, scale=0.01), mlp, head


def check_delta(name, got, ref, x) -> dict:
    """A block's output against its plain version's on the block's term
    out - x (see DELTA_MAX); raises outside the limits."""
    got, ref = got.float(), ref.float()
    _same_shape_finite(name, got, ref)
    d_ref = ref - x.float()
    err = got - ref
    rel_max = float(err.abs().max() / d_ref.abs().max())
    rel_l2 = float(err.norm() / d_ref.norm())
    if not (rel_max <= DELTA_MAX and rel_l2 <= DELTA_L2):
        raise AssertionError(
            f"{name}: out - x off its plain version: max |err| = "
            f"{rel_max:.3e} of max |d| (limit {DELTA_MAX}), ||err|| = "
            f"{rel_l2:.3e} of ||d|| (limit {DELTA_L2})")
    return {"max_abs_err": float(err.abs().max()), "rel_max_err": rel_max,
            "rel_l2_err": rel_l2}


def check_k3(name, got, ref, x) -> dict:
    """K3's (x_out, k1, v1[, q_cross]) against the plain version's: x_out
    on its block term, the rest elementwise."""
    out = check_delta(name, got[0], ref[0], x)
    for label, g, r in zip(("k1", "v1", "q_cross"), got[1:], ref[1:]):
        out[f"{label}_max_abs_err"] = check_close(f"{name} {label}", g, r,
                                                  KV_ATOL, KV_RTOL)
    return out


def k3_bound(args, got, pos: int) -> dict:
    """bound() of K3's function (K3-q's with its tail's 4 more inputs):
    its inputs and outputs, the cache rows 0..pos-1 read and row pos
    written; the [D, D] projections (q/k/v/o, and K3-q's cross q) and
    the attention's two products over pos + 1 keys."""
    b, d = args[0].shape
    tail = len(args) > 10
    return bound(nbytes(*args, *got) + 2 * b * (pos + 1) * d * 2,
                 bf16=2 * b * d * d * (5 if tail else 4)
                 + 4 * b * (pos + 1) * d)


def decoder_kernel_phase(card: str, gen: torch.Generator) -> list[dict]:
    """K3, K3-q, K4 and K4-o against their plain versions at B=32 and both
    model widths (K3 at every pos of K3_POS, cache L=68)."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    src = "multimodal_audio_search_tpu_torch/csrc/decoder_block.cu"
    jx = "multimodal_audio_search_tpu/ops/decoder_block.py"
    specs = {
        "K3": ("decoder_self_block", f"{jx}:200", DB.fused_self_block,
               DB.self_block_plain),
        "K3-q": ("decoder_self_block_q", f"{jx}:272", DB.fused_self_block_q,
                 DB.self_block_q_plain),
        "K4": ("decoder_mlp_block", f"{jx}:611", DB.fused_mlp_block,
               DB.mlp_block_plain),
        "K4-o": ("decoder_mlp_block_o", f"{jx}:363", DB.fused_mlp_block_o,
                 DB.mlp_block_o_plain)}
    out = {k: {"name": n, "route": "cuda", "source": src, "replaces": r,
               "cases": []} for k, (n, r, _, _) in specs.items()}
    b, l = 32, 68
    for label, d, heads, f in DEC_WIDTHS:
        x, selfw, tail, kc, vc = k3_inputs(gen, b, l, d)
        for key in ("K3", "K3-q"):
            _, _, fused, plain = specs[key]
            extra = tail if key == "K3-q" else []
            for pos in K3_POS:
                args = (x, *selfw, *extra)
                ref = plain(*args, kc, vc, pos, heads=heads)
                got = fused(*args, kc.clone(), vc.clone(), pos, heads=heads)
                torch.cuda.synchronize()
                case = {"shape": f"{label} B={b} D={d} H={heads} L={l} "
                                 f"pos={pos}",
                        **check_k3(f"{key} {label} pos={pos}", got, ref, x)}

                def flat(outs):
                    return torch.cat([t.reshape(-1).float() for t in outs])
                case["repeats_equal"] = check_repeats(
                    f"{key} {label} pos={pos}",
                    lambda: flat(fused(*args, kc.clone(), vc.clone(), pos,
                                       heads=heads)), flat(got), K3_REPEATS)
                if pos == K3_POS[-1]:
                    fn = (lambda: fused(*args, kc, vc, pos, heads=heads))
                    case.update(
                        ms=time_ms(fn), device_ms=device_ms(fn),
                        host_us=host_us(fn),
                        plain_ms=time_ms(
                            lambda: plain(*args, kc, vc, pos, heads=heads)),
                        **k3_bound(args, got, pos))
                out[key]["cases"].append(case)
                phase("kernels", kernel=key, card=card,
                      tol={"delta_max": DELTA_MAX, "delta_l2": DELTA_L2,
                           "kv": [KV_ATOL, KV_RTOL]}, **case)
        x, mlp, head = k4_inputs(gen, b, d, f)
        for key in ("K4", "K4-o"):
            _, _, fused, plain = specs[key]
            args = (x, *head, *mlp) if key == "K4-o" \
                else (x, *mlp)
            got, ref = fused(*args), plain(*args)
            torch.cuda.synchronize()
            case = {"shape": f"{label} B={b} D={d} F={f}",
                    **check_delta(f"{key} {label}", got, ref, x),
                    "ms": time_ms(lambda: fused(*args)),
                    "device_ms": device_ms(lambda: fused(*args)),
                    "host_us": host_us(lambda: fused(*args)),
                    "plain_ms": time_ms(lambda: plain(*args)),
                    "plain_device_ms": device_ms(lambda: plain(*args)),
                    **bound(nbytes(*args, got), bf16=4 * b * d * f + (
                        2 * b * d * d if key == "K4-o" else 0))}
            out[key]["cases"].append(case)
            phase("kernels", kernel=key, card=card,
                  tol={"delta_max": DELTA_MAX, "delta_l2": DELTA_L2}, **case)
    return list(out.values())


def k5_inputs(gen: torch.Generator, m: int, k: int, n: int, *, bias=True,
              device="cuda", dtype=torch.bfloat16):
    """K5's inputs: x [M, K] ~ N(0, 1) in ``dtype`` (bf16, or float32 for
    the float32 form); int8 codes [K, N] uniform in [-127, 127];
    per-column scales spread over 0.5-1.5 / (127 sqrt(K)), so a scale read
    from the wrong index shows; a bias in ``dtype`` at 0.1 N(0, 1) or
    None."""
    x = torch.randn(m, k, generator=gen).to(device, dtype)
    wq = torch.randint(-127, 128, (k, n), generator=gen,
                       dtype=torch.int8).to(device)
    scale = ((0.5 + torch.rand(n, generator=gen))
             / (127 * math.sqrt(k))).to(device)
    b = (torch.randn(n, generator=gen) * 0.1).to(device, dtype) \
        if bias else None
    return x, wq, scale, b


def k5_plain(x, wq, scale, b, out_dtype):
    """quant_dense_apply's arithmetic in plain PyTorch on any device."""
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    y = Q.quant_matmul_plain(x, wq, scale)
    return (y if b is None else y + b.float()).to(out_dtype)


def k5_regime(m: int, n: int) -> str:
    """The regime of a K5 call on the main path: a decode step's dense
    layer, the tied logits (the vocabulary's N) or the cross K/V
    projection over the encoder rows."""
    if m > 64:
        return "cross_kv"
    return "logits" if n == 51865 else "decode"


def k5_library(x, wq, scale):
    """One PyTorch call computing K5's product, as a yardstick:
    torch._weight_int8pack_mm(x, the int8 weight transposed to [N, K],
    the scales in x's dtype), its transposed copy made here, outside any
    timed window. Returns (the call, None), or (None, why) where the
    card's torch runs no CUDA kernel for it. The port never calls it."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "torch has no _weight_int8pack_mm"
    wt, sc = wq.t().contiguous(), scale.to(x.dtype)
    try:
        fn(x, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, "no CUDA kernel: " + str(e).splitlines()[0][:160]
    return (lambda: fn(x, wt, sc)), None


def check_k5(name, got, ref) -> float:
    """K5's output against its plain version's (K5_ATOL, K5_RTOL_*)."""
    rtol = K5_RTOL_BF16 if ref.dtype == torch.bfloat16 else K5_RTOL_F32
    return check_close(name, got, ref,
                       K5_ATOL * float(ref.float().abs().max()), rtol)


def k6_inputs(gen: torch.Generator, b: int, t: int, heads: int, *,
              device="cuda", dtype=torch.bfloat16):
    """K6's inputs as the int8_fused decode step hands them over: the
    cross query [B, H*64] ~ N(0, 1) in ``dtype`` (bf16, or float32 for the
    float32 form), and merged-head K/V ~ N(0, 1) in ``dtype`` quantized
    by quantize_kv_merged (int8 [B, T, H*64], scales [B, T, H])."""
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    hd = heads * 64
    q = torch.randn(b, hd, generator=gen).to(device, dtype)
    k, v = (torch.randn(b, t, hd, generator=gen).to(device, dtype)
            for _ in range(2))
    return (q, *CX.quantize_kv_merged(k, v, heads))


def k7_inputs(gen: torch.Generator, b: int, t: int, heads: int, *,
              device="cuda", dtype=torch.bfloat16):
    """K7's inputs as the int8 decode step hands them over: q [B, H, 64]
    ~ N(0, 1) in ``dtype`` (bf16, or float32 for the float32 form), K/V
    [B, H, T, 64] ~ N(0, 1) in ``dtype`` quantized by quantize_kv."""
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    q = torch.randn(b, heads, 64, generator=gen).to(device, dtype)
    k, v = (torch.randn(b, heads, t, 64, generator=gen).to(device, dtype)
            for _ in range(2))
    return (q, *CA.quantize_kv(k, v))


def check_rel(name, got, ref, max_lim: float, l2_lim: float) -> dict:
    """got against ref relative to ref's own scale: max |err| <= max_lim *
    max |ref| and ||err|| <= l2_lim * ||ref||; raises outside."""
    got, ref = got.float(), ref.float()
    _same_shape_finite(name, got, ref)
    err = got - ref
    rel_max = float(err.abs().max() / ref.abs().max())
    rel_l2 = float(err.norm() / ref.norm())
    if not (rel_max <= max_lim and rel_l2 <= l2_lim):
        raise AssertionError(
            f"{name}: off its plain version: max |err| = {rel_max:.3e} of "
            f"max |ref| (limit {max_lim}), ||err|| = {rel_l2:.3e} of "
            f"||ref|| (limit {l2_lim})")
    return {"max_abs_err": float(err.abs().max()), "rel_max_err": rel_max,
            "rel_l2_err": rel_l2}


def int8_kernel_phase(card: str, gen: torch.Generator) -> list[dict]:
    """K5 at K5_SHAPES, K6 (pos None and K6_POS) and K7 at B=32, T=1500,
    H=8 and H=6, each against its plain version."""
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    pkg, jx = "multimodal_audio_search_tpu_torch/csrc", \
        "multimodal_audio_search_tpu/ops"
    k5 = {"name": "quant_matmul", "route": "cuda",
          "source": f"{pkg}/quant_matmul.cu", "replaces": f"{jx}/quant.py:113",
          "cases": []}
    for m, k, n, dt, bias in K5_SHAPES:
        out_dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, wq, scale, b = k5_inputs(gen, m, k, n, bias=bias)
        p = {"wq": wq, "scale": scale, **({"b": b} if bias else {})}
        regime = k5_regime(m, n)
        if regime == "logits":  # the table as the model on the card holds it
            p = Q.logits_table(p)
        got = Q.quant_dense_apply(p, x, out_dtype=out_dtype)
        ref = k5_plain(x, wq, scale, b, out_dtype)
        torch.cuda.synchronize()
        fused = (lambda: Q.quant_dense_apply(p, x, out_dtype=out_dtype))
        ms = time_ms(fused)
        plan = {"kernel": "table"} if "wq_t" in p else dict(zip(
            ("kernel", "bn", "splits", "steps"), Q.split_plan(
                m, k, n, wave=torch.cuda.get_device_properties(
                    x.device).multi_processor_count)))
        case = {"shape": f"M={m} K={k} N={n} out={dt} bias={bias} "
                         f"regime={regime}",
                "plan": plan,
                "max_abs_err": check_k5(f"K5 {m}x{k}x{n}", got, ref), "ms": ms,
                "device_ms": device_ms(fused), "host_us": host_us(fused),
                "plain_ms": time_ms(lambda: k5_plain(x, wq, scale, b,
                                                     out_dtype)),
                **bound(nbytes(x, wq, scale, b, got), bf16=2 * m * k * n)}
        case["weight_gbps"] = k * n / case["device_ms"] / 1e6
        case["tflops"] = 2 * m * k * n / case["device_ms"] / 1e9
        lib, why = k5_library(x, wq, scale)
        case["library_ms"] = time_ms(lib) if lib else None
        if lib:
            case["library_device_ms"] = device_ms(lib)
        else:
            case["library"] = why
        k5["cases"].append(case)
        phase("kernels", kernel="K5", card=card,
              tol={"atol_of_max": K5_ATOL, "rtol": K5_RTOL_BF16 if dt ==
                   "bf16" else K5_RTOL_F32}, **case)
        del x, wq, scale, b, p, got, ref, lib
    k6 = {"name": "single_query_attention_int8", "route": "cuda",
          "source": f"{pkg}/cross_attention_int8.cu",
          "replaces": f"{jx}/cross_attention.py:329", "cases": []}
    k7 = {"name": "int8_cached_attention", "route": "cuda",
          "source": f"{pkg}/cached_attention.cu",
          "replaces": f"{jx}/cached_attention.py:90", "cases": []}
    b, t = 32, 1500
    for label, heads in (("base", 8), ("tiny", 6)):
        args = k6_inputs(gen, b, t, heads)
        for pos in (None, K6_POS):
            got = CX.fused_single_query_attention_int8(*args, heads=heads,
                                                       pos=pos)
            ref = CX.single_query_attention_int8_plain(*args, heads=heads,
                                                       pos=pos)
            torch.cuda.synchronize()
            n = t if pos is None else pos + 1
            case = {"shape": f"{label} B={b} T={t} H={heads} pos={pos}",
                    "plan": CX.int8_plan(n, heads, b,
                                         CX._fit_int8(got.device)),
                    **check_rel(f"K6 {label} pos={pos}", got, ref,
                                INT8_ATT_MAX, INT8_ATT_L2),
                    "ms": time_ms(lambda: CX.fused_single_query_attention_int8(
                        *args, heads=heads, pos=pos)),
                    "device_ms": device_ms(
                        lambda: CX.fused_single_query_attention_int8(
                            *args, heads=heads, pos=pos)),
                    "host_us": host_us(
                        lambda: CX.fused_single_query_attention_int8(
                            *args, heads=heads, pos=pos)),
                    "plain_ms": time_ms(
                        lambda: CX.single_query_attention_int8_plain(
                            *args, heads=heads, pos=pos))}
            case["gbps"] = 2 * b * n * heads * 64 / case["ms"] / 1e6
            # keys 0..n-1: int8 K/V rows and their float32 scales
            case.update(bound(nbytes(args[0], got)
                              + 2 * b * n * heads * (64 + 4),
                              int8=4 * b * n * heads * 64))
            k6["cases"].append(case)
            phase("kernels", kernel="K6", card=card,
                  tol={"max": INT8_ATT_MAX, "l2": INT8_ATT_L2}, **case)
        # a forced cluster of 8 over 4 keys: ranks 1-7 hold none
        for group in (heads, 1):
            got = CX._launch_int8(*args, heads, 4, group=group, cluster=8)
            ref = CX.single_query_attention_int8_plain(*args, heads=heads,
                                                       pos=3)
            torch.cuda.synchronize()
            case = {"shape": f"{label} B={b} T={t} H={heads} pos=3 "
                             f"G={group} cluster=8 (empty ranks)",
                    **check_rel(f"K6 {label} empty ranks G={group}", got,
                                ref, INT8_ATT_MAX, INT8_ATT_L2)}
            phase("kernels", kernel="K6", card=card,
                  tol={"max": INT8_ATT_MAX, "l2": INT8_ATT_L2}, **case)
        args = k7_inputs(gen, b, t, heads)
        got = CA.int8_cached_attention(*args)
        ref = CA.int8_cached_attention_plain(*args)
        torch.cuda.synchronize()
        fn = (lambda: CA.int8_cached_attention(*args))
        case = {"shape": f"{label} B={b} T={t} H={heads}",
                "plan": CA.cluster_plan(t, None, b * heads,
                                        CA._fit(args[0].device)),
                **check_rel(f"K7 {label}", got, ref, INT8_ATT_MAX,
                            INT8_ATT_L2),
                "ms": time_ms(fn), "device_ms": device_ms(fn),
                "host_us": host_us(fn),
                "plain_ms": time_ms(
                    lambda: CA.int8_cached_attention_plain(*args))}
        case["gbps"] = nbytes(*args) / case["device_ms"] / 1e6
        case.update(bound(nbytes(*args, got), int8=4 * b * t * heads * 64))
        k7["cases"].append(case)
        phase("kernels", kernel="K7", card=card,
              tol={"max": INT8_ATT_MAX, "l2": INT8_ATT_L2}, **case)
        del args, got, ref
    torch.cuda.empty_cache()
    return [k5, k6, k7]


def cluster_case(b: int, t: int, heads: int, pair: bool = False) -> dict:
    """K1's (K10's) cluster plan at this shape: blocks a cluster, the
    heads of each rank, and how many such clusters the card holds."""
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    cs = EB._card_plan(heads, b, t, pair)
    return {"cluster": cs, "clusters_held": EB.cluster_fit(cs, pair),
            "rank_heads": EB.cluster_ranks(heads, cs, pair)}


def cluster_mechanism(name: str, function: str) -> dict:
    """A split-T cluster kernel's instructions in the built library: TMA
    tensor loads (UTMALDG), mbarrier operations (SYNCS) and cluster
    barriers (UCGABAR_ARV / UCGABAR_WAIT). Raises unless it has all
    three."""
    counts = sass_counts(function, ("UTMALDG", "SYNCS", "UCGABAR"))
    if not all(counts.values()):
        raise AssertionError(f"{name}'s SASS lacks TMA/mbarrier/cluster "
                             f"barrier instructions: {counts}")
    return {"path": "cp.async.bulk.tensor + mbarrier + barrier.cluster",
            "sass": counts}


def wgmma_mechanism(name: str, function: str, mma: str = "HGMMA") -> dict:
    """A kernel's instructions in the built library: its warpgroup
    products (HGMMA for floats, IGMMA for int8), TMA tensor loads (UTMALDG)
    and mbarrier operations (SYNCS). Raises unless it has all three: K1,
    K8, K9, K10 and K11 run their products on wgmma fed by TMA only."""
    counts = sass_counts(function, (mma, "UTMALDG", "SYNCS"))
    if not all(counts.values()):
        raise AssertionError(f"{name}'s SASS lacks wgmma/TMA/mbarrier "
                             f"instructions: {counts}")
    return {"path": "wgmma.mma_async + cp.async.bulk.tensor + mbarrier",
            "sass": counts}


def encoder_variant_phase(card: str, gen: torch.Generator) -> list[dict]:
    """K8, K9 and K10 at B=32, T=1500 and both widths, K11's three forms
    at base width, each against its plain version on K1's inputs
    (K1_CASES); timed on the residual input."""
    from multimodal_audio_search_tpu_torch.ops import attention as A
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    from multimodal_audio_search_tpu_torch.ops.cached_attention import (
        quantize_kv)
    pkg, jx = "multimodal_audio_search_tpu_torch/csrc", \
        "multimodal_audio_search_tpu/ops"
    out = {
        "K8": {"name": "encoder_attention", "route": "cuda",
               "source": f"{pkg}/encoder_attention.cu",
               "replaces": f"{jx}/attention.py:83",
               "mechanism": wgmma_mechanism("K8", "encoder_attention_kernel"),
               "cases": []},
        "K9": {"name": "encoder_attn_o_residual_int8", "route": "cuda",
               "source": f"{pkg}/encoder_block_int8.cu",
               "replaces": f"{jx}/encoder_block.py:319",
               "mechanism": wgmma_mechanism(
                   "K9", "attn_o_residual_int8_kernel", "IGMMA"),
               "cases": []},
        "K10": {"name": "encoder_attn_o_residual_paired", "route": "cuda",
                "source": f"{pkg}/encoder_block_wgmma.cu",
                "replaces": f"{jx}/encoder_block.py:375",
                "mechanism": wgmma_mechanism("K10",
                                             "encoder_block_paired_kernel"),
                "cases": []},
        "K11": {"name": "encoder_attn_o_residual_ab", "route": "cuda",
                "source": f"{pkg}/encoder_block_wgmma.cu",
                "replaces": "tools/profile_encoder_kernel_ab.py:118",
                # True and False; "post" is K1's kernel (its own line)
                "mechanism": wgmma_mechanism("K11",
                                             "encoder_block_ab_kernel"),
                "cases": []}}
    b, t = 32, 1500
    for label, heads in (("base", 8), ("tiny", 6)):
        for inputs, q_scale, residual in K1_CASES:
            q, k, v, x, wo, bo = args = k1_inputs(
                gen, b, t, heads, q_scale=q_scale, residual=residual)
            kv = quantize_kv(k, v)
            args9 = (q, *kv, x, wo, bo)
            runs = {
                "K8": (lambda: A.fused_encoder_attention(q, k, v),
                       lambda: A.encoder_attention_plain(q, k, v)),
                "K9": (lambda: EB.attention_o_residual_int8(*args9),
                       lambda: EB.attention_o_residual_int8_plain(*args9)),
                "K10": (lambda: EB.fused_attention_o_residual(
                            *args, pair_heads=True),
                        lambda: EB.attention_o_residual_paired_plain(*args))}
            if label == "base":
                for form in (False, True, "post"):
                    runs[f"K11 {form}"] = (
                        lambda f=form: EB.attention_o_residual_ab(*args, f),
                        lambda f=form: EB.attention_o_residual_ab_plain(
                            *args, f))
            for name, (fused, plain) in runs.items():
                key = name.split()[0]
                got, ref = fused(), plain()
                torch.cuda.synchronize()
                tag = f"{name} {label} {inputs}"
                err = (check_rel(tag, got, ref, K1_Y_MAX, K1_Y_L2)
                       if key == "K8" else check_k1(tag, got, ref, residual))
                case = {"shape": f"{label} B={b} T={t} H={heads} D=64",
                        "inputs": inputs, **err}
                if key == "K9":
                    case["repeats_equal"] = check_repeats(
                        tag, fused, got, K9_REPEATS)
                if name.startswith("K11"):
                    case["defer_div"] = name.split()[1]
                    case.update(cluster_case(b, t, heads))
                if key == "K10":
                    case.update(cluster_case(b, t, heads, True))
                if residual:
                    case["ms"] = time_ms(fused)
                    case["plain_ms"] = time_ms(plain, reps=5)
                    if key == "K8":
                        sdpa = (lambda: torch.nn.functional.
                                scaled_dot_product_attention(q, k, v))
                        case["library_ms"] = time_ms(sdpa)
                        case["device_ms"] = device_ms(fused)
                        case["library_device_ms"] = device_ms(sdpa)
                        case["tflops"] = (4 * b * heads * t * t * 64
                                          / case["device_ms"] / 1e9)
                        case.update(bound(4 * nbytes(q),
                                          bf16=4 * b * heads * t * t * 64))
                    else:
                        case.update(attn_o_bound(b, t, heads,
                                                 int8=key == "K9"))
                out[key]["cases"].append(case)
                phase("kernels", kernel=name, card=card,
                      tol={"y_max": K1_Y_MAX, "y_l2": K1_Y_L2}
                      if key == "K8" or not residual else [K1_ATOL, K1_RTOL],
                      **case)
                del got, ref
            del q, k, v, x, wo, bo, args, kv, args9, runs
            torch.cuda.empty_cache()
    # K9 at a ragged T: a last 64-row block of one row, a last 128-key
    # tile of 92 keys
    for inputs, q_scale, residual in K1_CASES:
        q, k, v, x, wo, bo = k1_inputs(gen, 4, 1501, 8, q_scale=q_scale,
                                       residual=residual)
        args9 = (q, *quantize_kv(k, v), x, wo, bo)
        got = EB.attention_o_residual_int8(*args9)
        ref = EB.attention_o_residual_int8_plain(*args9)
        torch.cuda.synchronize()
        case = {"shape": "base B=4 T=1501 H=8 D=64", "inputs": inputs,
                **check_k1(f"K9 T=1501 {inputs}", got, ref, residual),
                "repeats_equal": check_repeats(
                    f"K9 T=1501 {inputs}",
                    lambda: EB.attention_o_residual_int8(*args9), got,
                    K9_REPEATS)}
        out["K9"]["cases"].append(case)
        phase("kernels", kernel="K9", card=card,
              tol={"y_max": K1_Y_MAX, "y_l2": K1_Y_L2} if not residual
              else [K1_ATOL, K1_RTOL], **case)
        del q, k, v, x, wo, bo, args9, got, ref
    return list(out.values())


def kernel_phase(card: str, gen: torch.Generator):
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    from multimodal_audio_search_tpu_torch.ops import encoder_block as K1
    k1 = {"name": "encoder_attn_o_residual", "route": "cuda",
          "source": "multimodal_audio_search_tpu_torch/csrc/"
                    "encoder_block_wgmma.cu",
          "replaces": "multimodal_audio_search_tpu/ops/encoder_block.py:425",
          "mechanism": wgmma_mechanism("K1", "encoder_block_kernel"),
          "cases": []}
    for heads, label in ((8, "base"), (6, "tiny")):
        b, t, d = 32, 1500, 64
        for inputs, q_scale, residual in K1_CASES:
            args = k1_inputs(gen, b, t, heads, q_scale=q_scale,
                             residual=residual)
            got = K1.fused_attention_o_residual(*args)
            ref = K1.attention_o_residual_plain(*args)
            torch.cuda.synchronize()
            case = {"shape": f"{label} B={b} T={t} H={heads} D={d}",
                    "inputs": inputs, **cluster_case(b, t, heads),
                    **check_k1(f"K1 {label} {inputs}", got, ref, residual)}
            if residual:
                ms = time_ms(lambda: K1.fused_attention_o_residual(*args))
                plain_ms = time_ms(
                    lambda: K1.attention_o_residual_plain(*args), reps=5)
                hd = heads * d
                flops = 4 * b * heads * t * t * d + 2 * b * t * hd * hd
                case.update(ms=ms, plain_ms=plain_ms,
                            tflops=flops / ms / 1e9,
                            **attn_o_bound(b, t, heads))
            k1["cases"].append(case)
            phase("kernels", kernel="K1", card=card,
                  tol=[K1_ATOL, K1_RTOL] if residual
                  else {"y_max": K1_Y_MAX, "y_l2": K1_Y_L2}, **case)
            del args, got, ref
            torch.cuda.empty_cache()

    k2 = {"name": "single_query_attention", "route": "cuda",
          "source": "multimodal_audio_search_tpu_torch/csrc/"
                    "cross_attention.cu",
          "replaces": "multimodal_audio_search_tpu/ops/cross_attention.py:145",
          "cases": []}
    for label, t, pos in (("cross", 1500, None), ("self", 68, 0),
                          ("self", 68, 3), ("self", 68, 67)):
        b, heads, d = 32, 8, 64
        hd = heads * d
        q, k, v = k2_inputs(gen, b, t, heads)
        got = K2.fused_single_query_attention(q, k, v, heads=heads, pos=pos)
        ref = K2.single_query_attention_plain(q, k, v, heads=heads, pos=pos)
        torch.cuda.synchronize()
        err = check_close(f"K2 {label} pos={pos}", got, ref, K2_ATOL,
                          K2_RTOL)
        n = t if pos is None else pos + 1
        fused = (lambda: K2.fused_single_query_attention(
            q, k, v, heads=heads, pos=pos))
        # the yardstick: one PyTorch call over the same keys (views)
        qh = q.view(b, 1, heads, d).transpose(1, 2)
        kh, vh = (a[:, :n].view(b, n, heads, d).transpose(1, 2)
                  for a in (k, v))
        sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh))
        splits, chunk = K2.split_plan(n, b * heads)
        case = {"shape": f"{label} B={b} T={t} H={heads} pos={pos}",
                "splits": splits, "keys_per_split": chunk,
                "max_abs_err": err, "ms": time_ms(fused),
                "plain_ms": time_ms(lambda: K2.single_query_attention_plain(
                    q, k, v, heads=heads, pos=pos)),
                "library_ms": time_ms(sdpa), "device_ms": device_ms(fused),
                "library_device_ms": device_ms(sdpa),
                "host_us": host_us(fused), "library_host_us": host_us(sdpa),
                **bound(nbytes(q, got) + 2 * b * n * hd * 2,
                        bf16=4 * b * n * hd)}
        case["gbps"] = 2 * b * n * hd * 2 / case["device_ms"] / 1e6
        k2["cases"].append(case)
        phase("kernels", kernel="K2", card=card, tol=[K2_ATOL, K2_RTOL],
              **case)
    return k1, k2


def load_tool(name: str):
    """tools/<name>.py as a module (tools/ is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def k12_inputs(n: int, dtype: str, *, device="cuda", seed: int = 0):
    """K12's inputs as the search path makes them (the search-at-scale
    tool's make_index: n unit rows [n, 2, 384], success = uniform > 0.2,
    generated on ``device``); the query is row 123's ASR embedding."""
    e, ok = load_tool("torch_bench_search_scale").make_index(
        n, getattr(torch, dtype), device, seed)
    return e[min(123, n - 1), 0].float(), e, ok


def k12_wide_inputs(n: int, dtype: str, *, d: int = K12_WIDE_D,
                    device="cuda", seed: int = 2):
    """k12_inputs at width ``d``: n unit rows [n, 2, d] made on
    ``device``, success = uniform > 0.2, the query row 123's ASR
    embedding."""
    gen = torch.Generator(device=device).manual_seed(seed)
    e = torch.randn((n, 2, d), generator=gen, device=device)
    e /= e.norm(dim=-1, keepdim=True)
    ok = torch.rand((n, 2), generator=gen, device=device) > 0.2
    e = e.to(getattr(torch, dtype))
    return e[min(123, n - 1), 0].float(), e, ok


def k12_rule_inputs(dtype: str, *, device="cuda", n: int = 256,
                    d: int = 64):
    """The validity rules on exact values, with weights 0.5 / 0.5 and
    K12_RULE_THRESHOLD: the JAX package's cases (tests/test_fused_search_
    kernel.py) and a score exactly at the threshold. Returns (q, emb, ok,
    the expected masked scores); rows not listed are zero (invalid)."""
    emb = torch.zeros(n, 2, d)
    ok = torch.zeros(n, 2, dtype=torch.bool)
    want = torch.full((n,), -1e30)
    # (row, ASR sim, audio sim, ASR ok, audio ok, score or None: invalid)
    for row, sa, sb, oa, ob, score in (
            (0, 1.0, 0.0, True, False, 1.0),       # valid
            (1, 0.0625, 0.0, True, False, None),   # below the threshold
            (2, -1.0, 0.0, True, False, None),     # negative sim
            (3, 1.0, 0.0, False, False, None),     # no weight at all
            (4, 0.125, 0.0, True, False, None),    # AT the threshold
            (5, 0.0, 0.5, True, True, 0.25),       # one positive sim
            (6, 0.5, -0.5, True, True, None),      # sims cancel: 0
            (7, 1.0, 0.5, False, True, 0.5)):      # ASR weight dropped
        emb[row, 0, 0], emb[row, 1, 0] = sa, sb
        ok[row, 0], ok[row, 1] = oa, ob
        if score is not None:
            want[row] = score
    q = torch.zeros(d)
    q[0] = 1.0
    return (q.to(device), emb.to(device, getattr(torch, dtype)),
            ok.to(device), want)


def check_k12_rules(name, got, want) -> None:
    """K12 on k12_rule_inputs must give the expected scores exactly."""
    got = got.float().cpu()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).nonzero().flatten().tolist()
        raise AssertionError(f"{name}: rows {bad} break the validity rules: "
                             f"{got[bad].tolist()} vs {want[bad].tolist()}")


def check_topk(name, got, ref, k: int = 10, gap: float = K12_ATOL) -> None:
    """The top-k ids of ``got`` (stable descending sort) equal ``ref``'s at
    every rank whose plain score is more than ``gap`` from both
    neighbours; raises otherwise."""
    rs, ri = torch.sort(ref.float(), descending=True, stable=True)
    gi = torch.sort(got.float(), descending=True, stable=True)[1]
    rs, ri, gi = (a[: k + 1].cpu() for a in (rs, ri, gi))
    for i in range(min(k, rs.numel())):
        clear = (i + 1 >= rs.numel() or rs[i] - rs[i + 1] > gap) and (
            i == 0 or rs[i - 1] - rs[i] > gap)
        if clear and gi[i] != ri[i]:
            raise AssertionError(f"{name}: rank {i} is {int(gi[i])}, the "
                                 f"plain path's is {int(ri[i])}")


def check_k12(name, got, q, emb, ok, wa, wb, threshold=0.1) -> dict:
    """K12's masked scores against the plain version's (see K12_ATOL);
    raises outside the tolerance, returns the errors and counts."""
    from multimodal_audio_search_tpu_torch.index.fusion import fused_scores
    ref, valid = fused_scores(q, emb, ok, wa, wb, threshold)
    # the rows that pass every rule but the threshold, scored
    loose = fused_scores(q, emb, ok, wa, wb, -math.inf)[0]
    sims = torch.einsum("npd,d->np", emb.float(), q.float())
    _same_shape_finite(name, got, ref)
    gvalid = got > -1e29
    edge = ((loose - threshold).abs() <= K12_ATOL) | (
        sims.amax(-1).abs() <= K12_ATOL)
    flips = gvalid != valid
    if (flips & ~edge).any():
        bad = (flips & ~edge).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"{name}: validity differs from the plain "
                             f"version on rows {bad} away from any edge")
    both = gvalid & valid
    err = float((got[both] - ref[both]).abs().max()) if both.any() else 0.0
    if err > K12_ATOL:
        raise AssertionError(f"{name}: max |score err| {err:.3e} > "
                             f"{K12_ATOL}")
    check_topk(name, got, ref)
    return {"max_abs_err": err, "edge_rows": int(edge.sum()),
            "validity_flips": int(flips.sum()),
            "valid_rows": int(valid.sum())}


def check_bits(name, got, ref, min_share: float = K14_EQUAL_MIN) -> dict:
    """got equals ref bit for bit (as bf16) on at least ``min_share`` of
    the elements; raises otherwise."""
    got, ref = got.to(torch.bfloat16).float(), ref.to(torch.bfloat16).float()
    _same_shape_finite(name, got, ref)
    share = float((got == ref).float().mean())
    if share < min_share:
        raise AssertionError(f"{name}: equal to its plain version bit for "
                             f"bit on {share:.4f} of the elements (limit "
                             f"{min_share})")
    return {"equal_share": share}


def check_k13(name, got, ref) -> dict:
    """K13's [cols] sums against the plain version's, every column, within
    K13_RTOL relative; raises outside."""
    got, ref = got.float(), ref.float()
    _same_shape_finite(name, got, ref)
    err = (got - ref).abs()
    rel = float((err / ref.abs()).max())
    if not rel <= K13_RTOL:
        raise AssertionError(f"{name}: column sums off the plain version by "
                             f"{rel:.3e} relative (limit {K13_RTOL}); "
                             f"{int((err > K13_RTOL * ref.abs()).sum())} of "
                             f"{ref.numel()} columns")
    return {"max_abs_err": float(err.max()), "rel_err": rel}


def search_kernel_phase(card: str) -> tuple[dict, dict]:
    """K12 at K12_SHAPES and on the rule rows (float32 and bf16 index),
    K13 on a 64 MiB slab and at the calibration's 4 GiB x 8 passes, each
    against its plain version; K13's yardstick is one torch.sum per
    pass."""
    from multimodal_audio_search_tpu_torch.ops import fused_search as FS
    from multimodal_audio_search_tpu_torch.ops import stream_read as SR
    from multimodal_audio_search_tpu_torch.utils import calibrate as CAL
    pkg = "multimodal_audio_search_tpu_torch/csrc"
    k12 = {"name": "fused_scores", "route": "cuda",
           "source": f"{pkg}/fused_search.cu",
           "replaces": "multimodal_audio_search_tpu/ops/fused_search.py:73",
           "cases": []}
    for dtype in ("float32", "bfloat16"):
        q, e, ok, want = k12_rule_inputs(dtype)
        check_k12_rules(f"K12 rules {dtype}", FS.fused_scores_kernel(
            q, e, ok, 0.5, 0.5, threshold=K12_RULE_THRESHOLD), want)
    phase("kernels", kernel="K12", card=card, step="validity rules exact")
    wa, wb = 0.6, 0.4
    for n, dtype in K12_SHAPES:
        q, e, ok = k12_inputs(n, dtype)
        got = FS.fused_scores_kernel(q, e, ok, wa, wb)
        torch.cuda.synchronize()
        case = {"shape": f"N={n} D=384 {dtype}",
                **check_k12(f"K12 N={n} {dtype}", got, q, e, ok, wa, wb)}
        if n >= 1_000_000:
            case["ms"] = time_ms(lambda: FS.fused_scores_kernel(
                q, e, ok, wa, wb))
            case["plain_ms"] = time_ms(lambda: FS.fused_scores_plain(
                q, e, ok, wa, wb))
            case["gbps"] = nbytes(e) / case["ms"] / 1e6
            case.update(bound(nbytes(q, e, ok, got), f32=4 * n * 384))
        k12["cases"].append(case)
        phase("kernels", kernel="K12", card=card, tol=K12_ATOL, **case)
        del q, e, ok, got
    torch.cuda.empty_cache()
    for n, dtype in K12_WIDE:
        q, e, ok = k12_wide_inputs(n, dtype)
        got = FS.fused_scores_kernel(q, e, ok, wa, wb)
        torch.cuda.synchronize()
        case = {"shape": f"N={n} D={K12_WIDE_D} {dtype}",
                **check_k12(f"K12 N={n} D={K12_WIDE_D} {dtype}", got, q, e,
                            ok, wa, wb),
                "ms": time_ms(lambda: FS.fused_scores_kernel(
                    q, e, ok, wa, wb)),
                "plain_ms": time_ms(lambda: FS.fused_scores_plain(
                    q, e, ok, wa, wb))}
        case["gbps"] = nbytes(e) / case["ms"] / 1e6
        case.update(bound(nbytes(q, e, ok, got), f32=4 * n * K12_WIDE_D))
        k12["cases"].append(case)
        phase("kernels", kernel="K12", card=card, tol=K12_ATOL, **case)
        del q, e, ok, got
        torch.cuda.empty_cache()

    k13 = {"name": "stream_read", "route": "cuda",
           "source": f"{pkg}/stream_read.cu", "replaces": "bench.py:206",
           "cases": []}
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(K13_CHECK_SHAPE, generator=gen, device="cuda").to(
        torch.bfloat16)
    case = {"shape": f"{list(K13_CHECK_SHAPE)} bf16 x {CAL.PASSES} passes",
            **check_k13("K13 64 MiB", SR.stream_read_sums(x, CAL.PASSES),
                        SR.stream_read_sums_plain(x, CAL.PASSES))}
    k13["cases"].append(case)
    phase("kernels", kernel="K13", card=card, tol=K13_RTOL, **case)
    rows, p = CAL.ROWS * CAL.N_CHUNK, CAL.PASSES
    x = torch.ones((rows, CAL.COLS), dtype=torch.bfloat16, device="cuda")
    got = SR.stream_read_sums(x, p)
    case = {"shape": f"[{rows}, {CAL.COLS}] bf16 (4 GiB) x {p} passes",
            **check_k13("K13 4 GiB", got, SR.stream_read_sums_plain(x, p)),
            "ms": time_ms(lambda: SR.stream_read_sums(x, p), reps=5),
            "plain_ms": time_ms(lambda: SR.stream_read_sums_plain(x, p),
                                reps=3, warmup=1),
            "library_ms": time_ms(lambda: [
                torch.sum(x, dim=0, dtype=torch.float32) for _ in range(p)],
                reps=5)}
    case["gbps"] = p * nbytes(x) / case["ms"] / 1e6
    # the function reads x once; the kernel reads it p times by design
    case["passes_bound_ms"] = bound(p * nbytes(x))["bound_ms"]
    case.update(bound(nbytes(x, got), f32=p * x.numel()))
    k13["cases"].append(case)
    phase("kernels", kernel="K13", card=card, tol=K13_RTOL, **case)
    del x, got
    torch.cuda.empty_cache()
    return k12, k13


def k14_inputs(gen: torch.Generator, b: int, t: int, d: int, f: int, *,
               attention_only: bool = False, device="cuda") -> tuple:
    """fused_cross_mlp_block's inputs in the decode step's types (bf16,
    float32 LN scales): x [B, D] at 0.01 N(0, 1), the cross LN, q and o
    projections, the MLP's LN, fc1 (bias 0.5 N(0, 1)) and fc2, and
    unit-scale merged cross K/V [B, T, D]. ``attention_only`` zeroes x,
    bco, fc1 and fc2 and makes Wco the identity."""
    rn, rf = _rand(gen, device), _rand(gen, device, torch.float32)
    w = 1 / math.sqrt(d)
    x = rn(b, d, scale=0.01)
    cross = [rf(d, scale=0.1, shift=1.0), rn(d, scale=0.1),
             rn(d, d, scale=w), rn(d, scale=0.1), rn(d, d, scale=w),
             rn(d, scale=0.1)]
    mlp = [rf(d, scale=0.1, shift=1.0), rn(d, scale=0.1), rn(d, f, scale=w),
           rn(f, scale=0.5), rn(f, d, scale=1 / math.sqrt(f)),
           rn(d, scale=0.1)]
    kv = [rn(b, t, d), rn(b, t, d)]
    if attention_only:
        x = torch.zeros_like(x)
        cross[4] = torch.eye(d, device=device, dtype=torch.bfloat16)
        cross[5] = torch.zeros_like(cross[5])
        mlp[2:] = [torch.zeros_like(a) for a in mlp[2:]]
    return (x, *cross, *mlp, *kv)


def cross_mlp_phase(card: str, gen: torch.Generator) -> tuple[dict, dict]:
    """K14 at B=32, T=K14_T and both widths on the "block" and "attention"
    inputs against its plain version, with every launch count set to 0
    before and read after: no decode step calls K14 (as in the JAX
    package), so this phase is its path. Returns (K14's entry, counts)."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    k14 = {"name": "cross_mlp_block", "route": "cuda",
           "source": "multimodal_audio_search_tpu_torch/csrc/"
                     "decoder_block.cu",
           "replaces": "multimodal_audio_search_tpu/ops/decoder_block.py:515",
           "mechanism": cluster_mechanism("K14",
                                          "cross_attention_split_kernel"),
           "cases": []}
    calls = 0

    def fused(args, heads):
        nonlocal calls
        calls += 1
        return DB.fused_cross_mlp_block(*args, heads=heads)

    b, t = 32, K14_T
    runtime.reset_counts()
    for label, d, heads, f in DEC_WIDTHS:
        for inputs in ("block", "attention"):
            args = k14_inputs(gen, b, t, d, f,
                              attention_only=inputs == "attention")
            got = fused(args, heads)
            ref = DB.cross_mlp_block_plain(*args, heads=heads)
            torch.cuda.synchronize()
            tag = f"K14 {label} {inputs}"
            err = check_delta(tag, got, ref, args[0]) if inputs == "block" \
                else {**check_rel(tag, got, ref, K1_Y_MAX, K1_Y_L2),
                      **check_bits(tag, got, ref)}
            dev = args[0].device
            cs, chunk = DB.cross_plan(t, heads, b, DB._fit_cross(dev))
            case = {"shape": f"{label} B={b} T={t} D={d} H={heads} F={f}",
                    "inputs": inputs, "cluster": cs, "keys_a_block": chunk,
                    "clusters_held": DB._fit_cross(dev)(cs, chunk), **err}
            if inputs == "block":
                case["ms"] = time_ms(lambda: fused(args, heads))
                case["plain_ms"] = time_ms(
                    lambda: DB.cross_mlp_block_plain(*args, heads=heads))
                case.update(bound(nbytes(*args, got), bf16=4 * b * d * d
                                  + 4 * b * t * d + 4 * b * d * f))
            k14["cases"].append(case)
            phase("kernels", kernel="K14", card=card,
                  tol={"delta_max": DELTA_MAX, "delta_l2": DELTA_L2}
                  if inputs == "block" else {"y_max": K1_Y_MAX, "y_l2":
                                             K1_Y_L2, "equal_min":
                                             K14_EQUAL_MIN}, **case)
            del args, got, ref
    counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
    exp = dict.fromkeys(KEYS, 0)
    exp["K14"] = calls
    if counts != exp:
        raise AssertionError(f"K14 phase: launches {counts} != {exp}")
    torch.cuda.empty_cache()
    return k14, counts


def search_scale_phase(card: str) -> dict:
    """The search-at-scale path: tools/torch_bench_search_scale.py's run()
    (calibration, then 100k / 400k / 1M segments x float32 / bfloat16),
    with every launch count set to 0 just before and read just after; K12
    and K13 must be the only kernels launched, as often as the tool
    implies."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.utils import calibrate as CAL
    tool = load_tool("torch_bench_search_scale")
    runtime.reset_counts()
    res = tool.run(emit=lambda line: None)
    counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
    exp = dict.fromkeys(KEYS, 0)
    exp["K12"] = len(res["rows"]) * tool.K12_LAUNCHES_PER_ROW
    exp["K13"] = CAL.STREAM_READ_LAUNCHES
    phase("search_scale", card=card, calibration=res["calibration"])
    for row in res["rows"]:
        phase("search_scale", card=card, **row)
    phase("search_scale", card=card, launches=counts, expected=exp,
          verdict=f"1M f32 parity p50 target <{tool.TARGET_MS:.0f} ms: "
                  f"{res['verdict']}")
    if len(res["rows"]) != len(tool.SIZES) * len(tool.DTYPES) or not all(
            math.isfinite(v) and v > 0 for r in res["rows"]
            for k, v in r.items() if k.endswith("_ms")):
        raise AssertionError(f"search at scale: rows missing or not "
                             f"positive: {res['rows']}")
    if counts != exp:
        raise AssertionError(f"search at scale: launches {counts} != {exp}")
    return counts


# [ann]'s index rows: half the tool's 1M, which took ~75 s of the
# script's 1200 s; the streamed host index still spans several chunks
# of each size
ANN_ROWS = 500_000


def ann_phase(card: str, clips) -> dict:
    """The beyond-memory path: tools/torch_bench_ivf.py's run() (no kernel
    may launch), then an ann="ivf" engine through ann_engine_check with
    its K1/K2 launches counted. Returns the engine's launch counts."""
    import dataclasses
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    from multimodal_audio_search_tpu_torch.config import EngineConfig
    tool = load_tool("torch_bench_ivf")
    runtime.reset_counts()
    res = tool.run(emit=lambda line: None, rows=ANN_ROWS)
    counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
    phase("ann", card=card, step="data", rows=ANN_ROWS,
          seconds=res["data_s"])
    phase("ann", card=card, step="full probe = exact", **res["full_probe"])
    phase("ann", card=card, step="in memory", **res["in_memory"])
    for row in res["host_index"].values():
        phase("ann", card=card, step="host index", **row)
    if any(counts.values()):
        raise AssertionError(f"[ann] the IVF tool launched kernels: {counts}")
    torch.cuda.empty_cache()
    cfg = EngineConfig()
    eng = AudioSearchEngine(cfg=cfg.replace(fusion=dataclasses.replace(
        cfg.fusion, ann="ivf")), device="cuda", seed=0)
    eng.load_all_models()
    asr, cap = eng.ingest_pipeline.asr, eng.ingest_pipeline.caption
    runtime.reset_counts()
    steps0 = (asr.total_steps, cap.total_steps)
    disp0 = (asr.dispatches, cap.dispatches)
    out = ann_engine_check(eng, clips)
    counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
    steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
    disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
    exp = expected_launches(False, None, steps, disp, asr, cap)
    phase("ann", card=card, step="engine", launches=counts, expected=exp,
          **out)
    if counts != exp or not all(counts[k] > 0 for k in exp if exp[k]):
        raise AssertionError(f"[ann] engine: launches {counts} != {exp}")
    del eng, asr, cap
    torch.cuda.empty_cache()
    return counts


ANN_QUERIES = ("upbeat music with drums", "someone speaking clearly",
               "rain and birds in the background")


def ann_engine_check(eng, clips) -> dict:
    """An engine with fusion.ann="ivf" ingests ``clips`` through
    ingest_many, which must build the IVF layout once on the write path
    (no ivf_prewarm_failed); the own-segment query and ANN_QUERIES, singly
    and by search_batch, each carry weight_info["ann"] with a full probe
    and equal an exact engine's answers on the same store (torch_bench_
    ivf.same_topk: scores within K12_ATOL, ids equal except inside a near
    tie; random decoders give many segments one text), own segment
    first."""
    import dataclasses
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    same_topk = load_tool("torch_bench_ivf").same_topk
    k = eng.cfg.fusion.top_k

    def cols(rows):
        return [h["fusion_score"] for h in rows], [h["index"] for h in rows]
    n_events = len(eng.stats.log.events)
    t0 = time.perf_counter()
    eng.ingest_many([wav_bytes(x) for _, x in clips],
                    [name for name, _ in clips], on_error="raise")
    ingest_s = time.perf_counter() - t0
    searcher = eng._searcher
    layout = searcher._ivf if searcher is not None else None
    if layout is None or searcher._ivf_key != eng.store.version:
        raise AssertionError("[ann] engine: no IVF layout of the store's "
                             "rows after ingest_many")
    events = eng.stats.log.events[n_events:]
    ops = [e.operation for e in events]
    if "ivf_prewarm_failed" in ops:
        raise AssertionError(f"[ann] engine: ivf_prewarm_failed in {ops}")
    meta = eng.store.meta
    own = own_segment(meta, range(len(meta)))
    queries = [meta[own]["asr_text"], *ANN_QUERIES]
    t0 = time.perf_counter()
    singles = [eng.search(q) for q in queries]
    query_s = time.perf_counter() - t0
    batch = eng.search_batch(queries)
    if searcher._ivf is not layout:
        raise AssertionError("[ann] engine: a query rebuilt the layout")
    exact = AudioSearchEngine(
        cfg=eng.cfg.replace(fusion=dataclasses.replace(eng.cfg.fusion,
                                                       ann="none")),
        ingest_pipeline=eng.ingest_pipeline, store=eng.store)
    for q, (hits, info), (bhits, binfo) in zip(queries, singles, batch):
        ref, rinfo = exact.search(q, k + 1)
        for name, got, inf in (("search", hits, info),
                               ("search_batch", bhits, binfo)):
            ann = inf.get("ann", {})
            if ann.get("mode") != "ivf" or \
                    ann.get("n_probe") != layout.n_clusters:
                raise AssertionError(f"[ann] {name} {q[:40]!r}: weight_"
                                     f"info ann {ann} is not a full probe")
            same_topk(f"[ann] {name} {q[:40]!r}", *cols(got), *cols(ref),
                      k=k, tol=K12_ATOL)
        if "ann" in rinfo:
            raise AssertionError("[ann] the exact engine searched by IVF")
    check_own_first("[ann]", meta, own, singles[0][0])
    return {"segments": len(meta), "ingest_seconds": ingest_s,
            "ivf_prewarm_s": [e.duration_s for e in events
                              if e.operation == "ivf_prewarm"],
            "build_s": layout.build_s, "n_clusters": layout.n_clusters,
            "spill": int(layout.spill.shape[0]),
            "query_ms_mean": 1e3 * query_s / len(queries),
            "top_hit": singles[0][0][0]["index"], "own": own}


def query_entry_check(card: str, eng, queries, texts, own: int,
                      unique: bool) -> None:
    """The engine's search_batch against search on the same queries, with
    the float32 index and again with FusionConfig(index_dtype="bfloat16")
    (an engine on the same pipelines and store): the same ids, scores
    within K12_ATOL, the self-retrieval query's own segment first."""
    import dataclasses
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    for dt in ("float32", "bfloat16"):
        e = eng if dt == "float32" else AudioSearchEngine(
            cfg=eng.cfg.replace(fusion=dataclasses.replace(
                eng.cfg.fusion, index_dtype=dt)),
            ingest_pipeline=eng.ingest_pipeline, store=eng.store)
        batch = e.search_batch(queries)
        singles = [e.search(qt) for qt in queries]
        for qt, (bh, _), (sh, _) in zip(queries, batch, singles):
            got, ref = ([(h["index"], h["fusion_score"]) for h in hits]
                        for hits in (bh, sh))
            if [i for i, _ in got] != [i for i, _ in ref] or any(
                    abs(a - c) > K12_ATOL
                    for (_, a), (_, c) in zip(got, ref)):
                raise AssertionError(
                    f"index_dtype={dt}: search_batch differs from search "
                    f"on {qt!r}: {got} vs {ref}")
        top = singles[0][0]
        if not top or (top[0]["index"] != own if unique
                       else top[0]["asr_text"] != texts[own]):
            raise AssertionError(f"index_dtype={dt}: self-retrieval query "
                                 f"did not rank segment {own} first")
        phase("engine", path="default", step="search_batch", card=card,
              index_dtype=dt, queries=len(queries),
              hits=[len(h) for h, _ in batch], top_hit=top[0]["index"],
              top_score=top[0]["fusion_score"],
              self_cosine=top[0]["asr_similarity"])


# the engine configurations driven on the card: (label, profile, fused,
# int8 cross_attn mode -- one set means quantize_decoder=True on both
# models --, fused_encoder on both decode configs, None = the config's)
ENGINE_PATHS = (("default", None, False, None, None),
                ("fast_lossless", "fast_lossless", True, None, None),
                ("v2", "fast_lossless", "v2", None, None),
                ("int8_fused", None, False, "int8_fused", None),
                ("int8", None, False, "int8", None),
                ("enc_attn", None, False, None, False),
                ("enc_int8", None, False, None, "int8"),
                ("enc_paired", None, False, None, "paired"))
# launch-count key of each kernel in runtime.COUNTS
KEYS = {"K1": "encoder_attn_o_residual", "K2": "single_query_attention",
        "K3": "decoder_self_block", "K3-q": "decoder_self_block_q",
        "K4": "decoder_mlp_block", "K4-o": "decoder_mlp_block_o",
        "K5": "quant_matmul", "K6": "single_query_attention_int8",
        "K7": "int8_cached_attention", "K8": "encoder_attention",
        "K9": "encoder_attn_o_residual_int8",
        "K10": "encoder_attn_o_residual_paired",
        "K11": "encoder_attn_o_residual_ab", "K12": "fused_scores",
        "K13": "stream_read", "K14": "cross_mlp_block"}
# K5's launches per decode step and decoder layer: self q/k/v/o, cross
# q/o, fc1, fc2
K5_PER_LAYER_STEP = 8


def engine_config(profile, fused, int8=None, enc=None, base=None):
    """EngineConfig for one entry of ENGINE_PATHS (on ``base``, default
    EngineConfig()); "v2" is fast_lossless with fused_layer="v2" on both
    models; ``int8`` sets quantize_decoder on both Whisper slots and that
    cross_attn on both decode configs; ``enc`` (not None) sets
    fused_encoder on both decode configs."""
    import dataclasses
    from multimodal_audio_search_tpu_torch.config import (
        EngineConfig, apply_profile)
    cfg = base or EngineConfig()
    if profile:
        cfg = apply_profile(cfg, profile)
    dec = {}
    if fused == "v2":
        dec["fused_layer"] = "v2"
    if int8:
        dec["cross_attn"] = int8
        cfg = cfg.replace(
            **{k: dataclasses.replace(getattr(cfg, k), quantize_decoder=True)
               for k in ("asr_model", "caption_model")})
    if enc is not None:
        dec["fused_encoder"] = enc
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **dec)
                          for k in ("asr_decode", "caption_decode")})


def encoder_kernel(enc, heads: int) -> str:
    """The kernel one encoder layer of a model with ``heads`` heads (a
    rank's, over the mesh's model axis) launches at T >= 512 on the card
    under fused_encoder ``enc``: over the axis each is its partial form
    (K1p, K9p, K10p), counted as the square form."""
    if enc is False:
        return "K8"
    if enc == "int8":
        return "K9"
    return "K10" if enc == "paired" and heads % 2 == 0 else "K1"


def expected_launches(fused, int8, steps, disp, asr, cap, enc=None) -> dict:
    """What one ingest run must have launched: one encoder kernel per
    encoder layer and dispatch (encoder_kernel: K1, or K8/K9/K10 under
    ``enc``); per decode step and decoder layer, K2 twice on the unfused
    path, and on the fused paths K2 once (cross only) beside K3 and K4,
    or K3-q and K4-o for "v2". The int8 paths (unfused) take K2 for the
    self attention, K6 ("int8_fused") or K7 ("int8") for the cross
    attention, and K5 for every dense layer (K5_PER_LAYER_STEP), for the
    logits once a step, and for the cross k/v projections twice per
    decoder layer and dispatch."""
    per_step = steps[0] * asr.cfg.dec_layers + steps[1] * cap.cfg.dec_layers
    exp = {k: 0 for k in KEYS}
    for n, pipe in zip(disp, (asr, cap)):
        exp[encoder_kernel(enc, pipe.cfg.heads // pipe.model_parallel)] += \
            n * pipe.cfg.enc_layers
    if int8:
        exp["K2"] = per_step
        exp["K6" if int8 == "int8_fused" else "K7"] = per_step
        exp["K5"] = (K5_PER_LAYER_STEP * per_step + steps[0] + steps[1]
                     + 2 * (disp[0] * asr.cfg.dec_layers
                            + disp[1] * cap.cfg.dec_layers))
    elif not fused:
        exp["K2"] = 2 * per_step
    else:
        exp["K2"] = per_step
        pair = ("K3-q", "K4-o") if fused == "v2" else ("K3", "K4")
        for k in pair:
            exp[k] = per_step
    return exp


def self_query(label: str, texts) -> tuple[int, bool]:
    """The self-retrieval query of an engine's stored ASR ``texts``: the
    first segment whose text no other segment has, else the first with a
    text. Returns (its index, whether its text is unique)."""
    if not texts:
        raise AssertionError(f"{label}: no segment survived validation")
    unique = [i for i, tx in enumerate(texts) if tx and texts.count(tx) == 1]
    own = unique[0] if unique else next(i for i, tx in enumerate(texts) if tx)
    return own, bool(unique)


def check_self_hit(label: str, hits, texts, own: int, unique: bool):
    """The self-retrieval query's hits: segment ``own`` first (a segment
    of its text where no text is unique), at cosine > 0.999. Returns the
    top hit."""
    if not hits:
        raise AssertionError(f"{label}: self-retrieval query returned no hit")
    top = hits[0]
    if unique:
        if top["index"] != own:
            raise AssertionError(
                f"{label}: own segment {own} not first: "
                f"{[h['index'] for h in hits]}")
    elif top["asr_text"] != texts[own]:
        raise AssertionError(f"{label}: no unique ASR text, and the top hit "
                             f"does not even share the query's text")
    if not top["asr_similarity"] > 0.999:
        raise AssertionError(f"{label}: self cosine {top['asr_similarity']}")
    return top


def engine_phase(card: str, rng: np.random.Generator, label: str, profile,
                 fused, int8, enc, clips, ref_texts=None, cfg=None):
    """Build the engine of one ENGINE_PATHS entry (or of ``cfg``) on cuda,
    ingest ``clips`` and answer the queries with every launch count set
    to 0 just before and read just after; check the counts and
    self-retrieval. Returns (launch counts, {(source, start): ASR text},
    {device memory: the peak from the build to the last query, and
    decode_extra_bytes; ingest audio-seconds a second})."""
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = AudioSearchEngine(
        cfg=cfg or engine_config(profile, fused, int8, enc), device="cuda",
        seed=0)
    eng.load_all_models()
    ing = eng.ingest_pipeline
    asr, cap = ing.asr, ing.caption
    torch.cuda.synchronize()
    phase("engine", path=label, step="built",
          seconds=time.perf_counter() - t0,
          asr=f"whisper-base d={asr.cfg.d_model} L={asr.cfg.enc_layers}",
          caption=f"whisper-tiny d={cap.cfg.d_model}",
          dtype=str(asr.dtype), batch=eng.cfg.ingest_batch,
          method=[asr.decode.method, cap.decode.method],
          fused_layer=[asr.decode.fused_layer, cap.decode.fused_layer],
          quantize_decoder=[asr.quantized, cap.quantized],
          cross_attn=[asr.decode.cross_attn, cap.decode.cross_attn],
          fused_encoder=[asr.fused_encoder_resolved,
                         cap.fused_encoder_resolved],
          transfer=eng.cfg.transfer_dtype,
          allocated_bytes=torch.cuda.memory_allocated())

    # ---- the path, counted
    runtime.reset_counts()
    steps0 = (asr.total_steps, cap.total_steps)
    disp0 = (asr.dispatches, cap.dispatches)
    t0 = time.perf_counter()
    n_segs, audio_s, traces = 0, 0.0, []
    for name, x in clips:
        segs = eng.ingest(wav_bytes(x), source_name=name)
        n_segs += len(segs)
        audio_s += len(x) / SR
        traces.append(dict(ing.last_trace))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    queries = []
    texts = [m["asr_text"] for m in eng.store.meta]
    own, unique = self_query(label, texts)
    counts_by_text = {tx: texts.count(tx) for tx in texts}
    queries.append(texts[own])
    queries += ["upbeat music with drums", "someone speaking clearly",
                "rain and birds in the background"]
    lat, hits0 = [], None
    for qi, qtext in enumerate(queries):
        tq = time.perf_counter()
        hits, info = eng.search(qtext)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - tq) * 1e3)
        if qi == 0:
            hits0 = hits
    counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
    steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
    disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
    # ---- what the path must have launched
    exp = expected_launches(fused, int8, steps, disp, asr, cap, enc)
    if counts != exp or not all(counts[k] > 0 for k in exp if exp[k]):
        raise AssertionError(f"{label}: launches {counts} != expected {exp}")
    # ---- self-retrieval
    top = check_self_hit(label, hits0, texts, own, unique)
    by_seg = {(m["source"], m["start_time"]): m["asr_text"]
              for m in eng.store.meta}
    same = None
    if ref_texts is not None:
        common = [k for k in by_seg if k in ref_texts]
        same = {"segments": len(common), "share_equal": sum(
            by_seg[k] == ref_texts[k] for k in common) / max(1, len(common))}
    mem = {"peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "asr_decode_extra_bytes": decode_extra_bytes(asr, rng),
           "ingest_audio_s_per_s": audio_s / ingest_s}
    # the transfer: one segment's code bytes, and the host encode of the
    # first clip's batches
    from multimodal_audio_search_tpu_torch.audio.segment import (
        segment_windows)
    seg_len = min(int(eng.cfg.segment.segment_seconds * SR),
                  asr.mel_cfg.n_samples)
    code = ing._encode_transfer([np.zeros(seg_len, np.float32)], 1, seg_len,
                                np.float32(1.0), ing.last_transfer_resolved)
    batches = -(-len(segment_windows(len(clips[0][1]), SR, eng.cfg.segment))
                // eng.cfg.ingest_batch)
    codec = {"transfer_dtype": ing.last_transfer_resolved,
             "transfer_bytes_per_segment": code.numel() * code.element_size(),
             "quantize_ms_per_batch": traces[0]["quantize"] * 1e3 / batches,
             "encoder_positions": asr.mel_cfg.n_frames // 2}
    phase("engine", path=label, step="ingest and queries", card=card, **mem,
          **codec,
          segments=n_segs, audio_seconds=audio_s, ingest_seconds=ingest_s,
          query_ms=lat, query_p50_ms=float(np.median(lat)),
          decode_steps={"asr": steps[0], "caption": steps[1]},
          dispatches={"asr": disp[0], "caption": disp[1]},
          launches=counts, expected=exp,
          transfer={"resolved": ing.last_transfer_resolved,
                    "probe_s": ing.last_probe},
          asr_text_vs_default=same,
          distinct_asr_texts=len(counts_by_text), stored=len(texts),
          self_query_segment=own, self_query_unique=bool(unique),
          top_hit=top["index"], top_score=top["fusion_score"],
          trace_ms=[{k: round(v * 1e3, 3) for k, v in tr.items()}
                    for tr in traces])
    mem.update(codec, asr_text_vs_default=same)
    if label == "default":
        query_entry_check(card, eng, queries, texts, own, bool(unique))
        reference_check(asr, rng)
    if int8:
        int8_reference_check(asr, rng, int8)
    if enc is not None:
        encoder_reference_check(asr, rng, enc)
    del eng, ing, asr, cap
    torch.cuda.empty_cache()
    return counts, by_seg, mem


def decode_extra_bytes(pipe, rng: np.random.Generator) -> int:
    """The device bytes one full batch's decode (B=32, the pipeline's
    decode config) holds at its peak above what is allocated once the
    encoder output exists: the cross K/V in the path's format, the self
    cache and the step temporaries. The engine's own peak is set earlier,
    by the encoder; this is the part the int8 memory mode changes."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.generate import generate
    from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram
    b = 32
    with torch.inference_mode():
        x = torch.as_tensor(make_audio(10 * b, rng).reshape(b, -1),
                            device=pipe.device)
        mel = log_mel_spectrogram(torch.nn.functional.pad(
            x, (0, pipe.mel_cfg.n_samples - x.shape[1])), pipe.mel_cfg)
        enc = W.encode(pipe.params, mel.to(pipe.dtype), pipe.cfg,
                       fused_blocks=pipe.fused_encoder_resolved)
        prefix = torch.tensor([pipe.prefix_ids] * b, device=pipe.device)
        del x, mel
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        generate(pipe.params, enc, prefix, cfg=pipe.cfg, decode=pipe.decode,
                 max_new_tokens=pipe.decode.max_new_tokens)
        torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def reference_check(asr, rng: np.random.Generator) -> None:
    """The ASR model's kernel path against its plain path on one small
    input: the K1 encoder against the plain encoder, a decode step over
    merged cross K/V (K2) against the einsum one, four fused decode steps
    (True: K3 + K2 + K4; "v2": K3-q + K2 + K4-o) at B=8 against the
    unfused ones, and an 8-token greedy run for shapes. Raises outside
    ENC_MEAN_ERR_MAX / LOGITS_ERR_REL / FUSED_LOGITS_ERR_REL. The
    unfused decode steps take K2 for the cached self attention, so the
    K2 comparison sees K2's cross use only; the kernel phase checks its
    ``pos`` mask."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.generate import generate
    from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram
    dev = asr.device
    with torch.inference_mode():
        x = make_audio(20, rng).reshape(2, -1)[:, : asr.mel_cfg.n_samples]
        w = torch.nn.functional.pad(
            torch.as_tensor(x, device=dev),
            (0, asr.mel_cfg.n_samples - x.shape[1]))
        mel = log_mel_spectrogram(w, asr.mel_cfg).to(asr.dtype)
        enc_k = W.encode(asr.params, mel, asr.cfg, fused_blocks=True)
        enc_p = W.encode(asr.params, mel, asr.cfg, fused_attention=False)
        enc_err = (enc_k.float() - enc_p.float()).abs()
        ckv = W.cross_kv_merged(asr.params, enc_k, asr.cfg)
        ckv_e = W.cross_kv(asr.params, enc_k, asr.cfg)
        cache = W.init_cache(asr.cfg, 2, 8, asr.dtype, dev)
        cache_e = W.init_cache(asr.cfg, 2, 8, asr.dtype, dev)
        tok = torch.tensor([asr.cfg.bos_token_id] * 2, device=dev)
        lg = W.decode_step(asr.params, tok, 0, cache, ckv, asr.cfg)
        lg_e = W.decode_step(asr.params, tok, 0, cache_e, ckv_e, asr.cfg)
        lg_err = (lg - lg_e).abs()
        # fused steps at B=8 (the fused paths need B % 8 == 0)
        ckv8 = W.cross_kv_merged(asr.params, enc_k.repeat(4, 1, 1), asr.cfg)
        fused_err = {}
        for fused in (False, True, "v2"):
            cache8 = W.init_cache(asr.cfg, 8, 8, asr.dtype, dev)
            steps = []
            for pos, t in enumerate(asr.prefix_ids):
                steps.append(W.decode_step(
                    asr.params, torch.full((8,), t, device=dev), pos, cache8,
                    ckv8, asr.cfg, fused_layer=fused))
            if fused is False:
                base = steps
                continue
            fused_err[str(fused)] = max(
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip(steps, base))
        prefix = torch.tensor([asr.prefix_ids] * 2, device=dev)
        out = generate(asr.params, enc_k, prefix, cfg=asr.cfg,
                       decode=asr.decode, max_new_tokens=8)
    ok_shapes = (tuple(enc_k.shape) == (2, asr.mel_cfg.n_frames // 2,
                                        asr.cfg.d_model)
                 and tuple(lg.shape) == (2, asr.cfg.vocab_size)
                 and tuple(out.tokens.shape) == (2, len(asr.prefix_ids) + 8))
    finite = bool(torch.isfinite(enc_k).all() and torch.isfinite(lg).all())
    phase("engine", step="reference", encoder_max_abs_err=float(
        enc_err.max()), encoder_mean_abs_err=float(enc_err.mean()),
        logits_max_abs_err=float(lg_err.max()),
        logits_scale=float(lg_e.abs().max()),
        fused_step_logits_rel_err=fused_err, shapes_ok=ok_shapes,
        finite=finite)
    if not (ok_shapes and finite):
        raise AssertionError("engine outputs: wrong shape or non-finite")
    if float(enc_err.mean()) > ENC_MEAN_ERR_MAX or float(lg_err.max()) > \
            LOGITS_ERR_REL * float(lg_e.abs().max()):
        raise AssertionError(
            f"kernel path disagrees with the plain path: encoder mean "
            f"{float(enc_err.mean()):.3e} (limit {ENC_MEAN_ERR_MAX}), "
            f"logits max {float(lg_err.max()):.3e} (limit {LOGITS_ERR_REL} "
            f"x {float(lg_e.abs().max()):.3f})")
    if not all(e <= FUSED_LOGITS_ERR_REL for e in fused_err.values()):
        raise AssertionError(
            f"fused decode steps disagree with the unfused ones: {fused_err}"
            f" (limit {FUSED_LOGITS_ERR_REL} of the logits' scale)")


def encoder_reference_check(asr, rng: np.random.Generator, enc) -> None:
    """An encoder variant's engine (fused_encoder ``enc``: K8, K9 or K10)
    against the plain encoder on two 10 s segments: mean |err| within
    ENC_MEAN_ERR_MAX, as K1's encoder is held. The int8 dots add 7e-4 of
    mean |err| at float32 on the CPU (whisper-base and tiny, seed 0), a
    tenth of the bf16 roundings' 0.0059 on the card."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram
    dev = asr.device
    with torch.inference_mode():
        x = make_audio(20, rng).reshape(2, -1)
        w = torch.nn.functional.pad(
            torch.as_tensor(x, device=dev),
            (0, asr.mel_cfg.n_samples - x.shape[1]))
        mel = log_mel_spectrogram(w, asr.mel_cfg).to(asr.dtype)
        got = W.encode(asr.params, mel, asr.cfg, fused_blocks=enc)
        ref = W.encode(asr.params, mel, asr.cfg, fused_attention=False)
    err = (got.float() - ref.float()).abs()
    ok = got.shape == ref.shape and bool(torch.isfinite(got).all())
    phase("engine", path=f"fused_encoder={enc}", step="encoder reference",
          encoder_mean_abs_err=float(err.mean()),
          encoder_max_abs_err=float(err.max()), shapes_finite_ok=ok)
    if not ok or float(err.mean()) > ENC_MEAN_ERR_MAX:
        raise AssertionError(
            f"fused_encoder={enc}: encoder off the plain encoder: mean "
            f"{float(err.mean()):.3e} (limit {ENC_MEAN_ERR_MAX}), shapes "
            f"and finite values ok: {ok}")


def first_decode_steps(asr, rng: np.random.Generator, runs: dict) -> tuple:
    """``asr``'s model on 8 distinct 10 s segments: the encoder once, then
    for each of ``runs`` (label: (a context manager's factory, the cross
    K/V function)) the cross K/V and the first decode step inside that
    context, with the launches each made. Returns (logits by label,
    launches by label, the encoder states)."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram
    dev, b = asr.device, 8
    logits, counts = {}, {}
    with torch.inference_mode():
        x = make_audio(10 * b, rng).reshape(b, -1)
        w = torch.nn.functional.pad(
            torch.as_tensor(x, device=dev),
            (0, asr.mel_cfg.n_samples - x.shape[1]))
        enc = W.encode(asr.params, log_mel_spectrogram(w, asr.mel_cfg)
                       .to(asr.dtype), asr.cfg, fused_blocks=True)
        tok = torch.full((b,), asr.cfg.bos_token_id, device=dev)
        for label, (context, ckv_of) in runs.items():
            _sync(dev)
            before = dict(runtime.COUNTS)
            with context():
                logits[label] = W.decode_step(
                    asr.params, tok, 0,
                    W.init_cache(asr.cfg, b, 4, asr.dtype, dev),
                    ckv_of(asr.params, enc, asr.cfg), asr.cfg)
            _sync(dev)
            counts[label] = {k: runtime.COUNTS[v] - before[v]
                             for k, v in KEYS.items()}
    return logits, counts, enc


def step_reading(got: torch.Tensor, ref: torch.Tensor, vocab: int) -> dict:
    """A first decode step's logits against a reference step's: max |err|
    as a share of the reference's span, argmax agreement, and whether
    ``got`` is [8, vocab] and finite."""
    span = float(ref.max() - ref.min())
    return {"first_step_err_of_span": float((got - ref).abs().max()) / span,
            "logits_span": span,
            "argmax_agreement": float((got.argmax(-1) == ref.argmax(-1))
                                      .float().mean()),
            "shapes_finite_ok": tuple(got.shape) == (8, vocab)
            and bool(torch.isfinite(got).all())}


def check_step(name: str, r: dict, span_max: float, agree_min: float,
               against: str) -> None:
    """Raises unless step_reading ``r`` has the right shape and finite
    values, max |err| under ``span_max`` of the span and argmax agreement
    at least ``agree_min``."""
    if not r["shapes_finite_ok"]:
        raise AssertionError(f"{name}: wrong shape or non-finite values")
    rel, agree = r["first_step_err_of_span"], r["argmax_agreement"]
    if not (rel < span_max and agree >= agree_min):
        raise AssertionError(
            f"{name}: first step {rel:.3e} of the logits' span (limit "
            f"{span_max}), argmax agreement {agree} (limit {agree_min}) "
            f"against {against}")


def int8_reference_check(asr, rng: np.random.Generator, mode: str) -> None:
    """An int8 engine's ASR model (quantized decoder) on 8 distinct 10 s
    segments: the first decode step over its int8 cross K/V (K6 or K7)
    against the same step over bf16 cross K/V with the einsum attention,
    held to the JAX package's guardrail (INT8_SPAN_MAX, INT8_AGREE_MIN),
    and an 8-token greedy run for shapes and finite values. Both steps
    take K5 for every dense layer and the logits."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.generate import generate
    null = contextlib.nullcontext
    logits, _, enc = first_decode_steps(asr, rng, {
        "int8": (null, W.cross_kv_merged_int8 if mode == "int8_fused"
                 else W.cross_kv_quantized),
        "bf16": (null, W.cross_kv)})
    b = enc.shape[0]
    with torch.inference_mode():
        prefix = torch.tensor([asr.prefix_ids] * b, device=asr.device)
        out = generate(asr.params, enc, prefix, cfg=asr.cfg,
                       decode=asr.decode, max_new_tokens=8)
    r = step_reading(logits["int8"], logits["bf16"], asr.cfg.vocab_size)
    r["shapes_finite_ok"] = r["shapes_finite_ok"] and (
        tuple(out.tokens.shape) == (b, len(asr.prefix_ids) + 8)
        and bool(torch.isfinite(enc).all()))
    phase("engine", path=mode, step="int8 reference", **r)
    check_step(mode, r, INT8_SPAN_MAX, INT8_AGREE_MIN, "bf16 cross K/V")


# the reference-parity decode engines ([parity]): (label, profile, fused).
# The captioner on caption_parity_decode() (whisper-tiny, beam-2, 100
# tokens, penalty 1.3, n-gram 3: 64 decode rows for a 32-segment batch),
# the ASR model on asr_parity_decode() with method="sample" (whisper-base,
# temperature 0.2, penalty 1.05, n-gram 2, 224 tokens);
# "parity_fast_lossless" under fast_lossless, so K3/K4 take the beam rows.
PARITY_PATHS = (("parity", None, False),
                ("parity_fast_lossless", "fast_lossless", True))
# The Gumbel noise lies in [-log(-log(tiny)), -log(-log(1 - 2^-24))] =
# [-4.47, 16.63] (u in [finfo(float32).tiny, 1 - 2^-24]): a sample at
# temperature t is the argmax wherever the top two processed logits lie
# more than GUMBEL_SPREAD x t apart, so a cold sample may leave greedy
# only at a step whose top-two gap is below that.
GUMBEL_SPREAD = 21.1
PARITY_COLD_T, PARITY_HOT_T = 1e-4, 2.0
# the invariants' decodes: 8 segments, 24 tokens
PARITY_CHECK_ROWS, PARITY_CHECK_TOKENS = 8, 24


def parity_config(profile=None, base=None):
    """EngineConfig of a PARITY_PATHS entry (on ``base``, default
    EngineConfig()): the reference's decode knobs on both Whisper slots
    (sampling for ASR, beam-2 for captions), then the profile."""
    import dataclasses
    from multimodal_audio_search_tpu_torch.config import (
        EngineConfig, apply_profile, asr_parity_decode,
        caption_parity_decode)
    cfg = base or EngineConfig()
    asr, cap = asr_parity_decode(), caption_parity_decode()
    if base is not None:        # the base's decode lengths (test presets)
        asr, cap = (dataclasses.replace(d, max_new_tokens=b.max_new_tokens)
                    for d, b in ((asr, base.asr_decode),
                                 (cap, base.caption_decode)))
    cfg = cfg.replace(asr_decode=dataclasses.replace(asr, method="sample"),
                      caption_decode=cap)
    return apply_profile(cfg, profile) if profile else cfg


def _encode_batch(pipe, x: np.ndarray) -> torch.Tensor:
    """The encoder output of the segments ``x`` [B, samples] on the card."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram
    w = torch.nn.functional.pad(torch.as_tensor(x, device=pipe.device),
                                (0, pipe.mel_cfg.n_samples - x.shape[1]))
    mel = log_mel_spectrogram(w, pipe.mel_cfg).to(pipe.dtype)
    return W.encode(pipe.params, mel, pipe.cfg,
                    fused_blocks=pipe.fused_encoder_resolved)


def _prefix(pipe, b: int) -> torch.Tensor:
    return torch.tensor([pipe.prefix_ids] * b, device=pipe.device)


def parity_invariants(card: str, ing, rng: np.random.Generator) -> None:
    """What holds on the card without an oracle, on a parity ingest
    pipeline's Whisper pipelines (PARITY_CHECK_ROWS segments,
    PARITY_CHECK_TOKENS tokens):
    beam-2's decode with num_beams=1 is greedy's, token for token (the
    repetition penalty at 1.0: it acts on logits in greedy and on
    log-probabilities in beam); sampling at PARITY_COLD_T is greedy
    except where the noise can reach (GUMBEL_SPREAD); one seed twice is
    the same decode, two seeds at PARITY_HOT_T differ; the self cache
    keeps its addresses through a beam decode. Then one 32-segment batch
    of each decode, timed against greedy on the same encoder output."""
    import dataclasses
    from multimodal_audio_search_tpu_torch.models import beam as BM
    from multimodal_audio_search_tpu_torch.models import generate as G
    asr, cap = ing.asr, ing.caption
    n, new = PARITY_CHECK_ROWS, PARITY_CHECK_TOKENS
    x = make_audio(10 * 32, rng).reshape(32, -1)
    out = {}
    with torch.inference_mode():
        enc_c, enc_a = _encode_batch(cap, x), _encode_batch(asr, x)
        # beam with one beam = greedy
        dec = dataclasses.replace(cap.decode, repetition_penalty=1.0,
                                  max_new_tokens=new)
        g = G.generate(cap.params, enc_c[:n], _prefix(cap, n), cfg=cap.cfg,
                       decode=dataclasses.replace(dec, method="greedy"),
                       max_new_tokens=new)
        bm = BM.beam_generate(cap.params, enc_c[:n], _prefix(cap, n),
                              cfg=cap.cfg, decode=dec, max_new_tokens=new,
                              num_beams=1)
        out["beam1_equals_greedy"] = bool(
            torch.equal(bm.tokens, g.tokens)
            and torch.equal(bm.lengths, g.lengths))
        # cold sampling = greedy, but where the noise reaches
        gaps, real = [], G._select_next

        def spy(logits, *a):
            top = logits.topk(2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
            return real(logits, *a)
        dec = dataclasses.replace(asr.decode, max_new_tokens=new)
        G._select_next = spy
        try:
            g = G.generate(asr.params, enc_a[:n], _prefix(asr, n),
                           cfg=asr.cfg,
                           decode=dataclasses.replace(dec, method="greedy"),
                           max_new_tokens=new)
        finally:
            G._select_next = real
        gaps = torch.stack(gaps).float().cpu()          # [steps, n]

        def sample(t, seed):
            return G.generate(
                asr.params, enc_a[:n], _prefix(asr, n), cfg=asr.cfg,
                decode=dataclasses.replace(dec, temperature=t),
                max_new_tokens=new,
                rng=torch.Generator(device=asr.device).manual_seed(seed))
        cold = sample(PARITY_COLD_T, 1)
        p = len(asr.prefix_ids)
        left = []                   # (row, step, greedy top-two gap)
        for r in range(n):
            diff = (cold.tokens[r] != g.tokens[r]).nonzero()
            if len(diff):
                j = int(diff[0])
                left.append((r, j - 1, float(gaps[j - 1, r])))
        out["cold_rows_left_greedy"] = left
        out["cold_ok"] = all(gap < GUMBEL_SPREAD * PARITY_COLD_T
                             for _, _, gap in left)
        gen_gaps = gaps[p - 1:, :]
        out["greedy_min_top2_gap"] = float(gen_gaps.min())
        hot = [sample(PARITY_HOT_T, s) for s in (7, 7, 8)]
        out["same_seed_equal"] = bool(torch.equal(hot[0].tokens,
                                                  hot[1].tokens))
        out["seeds_differ"] = not torch.equal(hot[0].tokens, hot[2].tokens)
        # the self cache keeps its addresses through a beam decode
        ptrs, step = [], BM.decode_step

        def spy_step(params, tok, pos, cache, *a, **k):
            ptrs.append([(c["k"].data_ptr(), c["v"].data_ptr())
                         for c in cache])
            return step(params, tok, pos, cache, *a, **k)
        BM.decode_step = spy_step
        try:
            bm = BM.beam_generate(
                cap.params, enc_c[:n], _prefix(cap, n), cfg=cap.cfg,
                decode=dataclasses.replace(cap.decode, max_new_tokens=new),
                max_new_tokens=new, num_beams=cap.decode.num_beams)
        finally:
            BM.decode_step = step
        out["cache_addresses_kept"] = bool(
            len(ptrs) == bm.steps and all(q == ptrs[0] for q in ptrs))
        # one 32-segment batch of each decode, and greedy on the same
        # encoder output, in turns (decode, greedy, greedy, decode), from
        # CUDA-synchronised host walls
        walls = {}
        for name, pipe, enc_out in (("beam", cap, enc_c),
                                    ("sample", asr, enc_a)):
            m = pipe.decode.method
            for method in (m, "greedy", "greedy", m):
                d = dataclasses.replace(pipe.decode, method=method)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if method == "beam":
                    o = BM.beam_generate(
                        pipe.params, enc_out, _prefix(pipe, 32),
                        cfg=pipe.cfg, decode=d,
                        max_new_tokens=d.max_new_tokens,
                        num_beams=d.num_beams)
                else:
                    o = G.generate(
                        pipe.params, enc_out, _prefix(pipe, 32),
                        cfg=pipe.cfg, decode=d,
                        max_new_tokens=d.max_new_tokens,
                        rng=torch.Generator(device=pipe.device)
                        .manual_seed(1))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                w = walls.setdefault(f"{name}:{method}", {
                    "model": f"d={pipe.cfg.d_model}",
                    "rows": 32 * (d.num_beams if method == "beam" else 1),
                    "steps": o.steps, "wall_s": [], "ms_per_step": []})
                w["wall_s"].append(wall)
                w["ms_per_step"].append(wall * 1e3 / o.steps)
        out["decode_32_segments"] = walls
    phase("parity", step="invariants", card=card, **out)
    if not (out["beam1_equals_greedy"] and out["cold_ok"]
            and out["same_seed_equal"] and out["seeds_differ"]
            and out["cache_addresses_kept"]):
        raise AssertionError(f"parity invariants failed: {out}")


def parity_shapes(ing) -> list[tuple]:
    """(model, rows, L, D, H, F, positions) of each Whisper pipeline's
    decode on the [parity] path: rows = a full batch's bucket
    (ingest_batch, at least batch_floor) x num_beams under beam search;
    the self cache L = prefix + max_new_tokens; the positions held there:
    0, K3_POS's last (the kernel phase's edge) and the cache's last two
    rows."""
    from multimodal_audio_search_tpu_torch.utils.batching import bucket_pow2
    out = []
    for pipe in (ing.caption, ing.asr):
        c, dec = pipe.cfg, pipe.decode
        rows = bucket_pow2(ing.cfg.ingest_batch, ing.batch_floor()) * (
            dec.num_beams if dec.method == "beam" else 1)
        l = len(pipe.prefix_ids) + dec.max_new_tokens
        out.append((f"d={c.d_model} {dec.method}", rows, l, c.d_model,
                    c.heads, c.ffn, sorted({p for p in (0, K3_POS[-1], l - 2,
                                                        l - 1) if p < l})))
    return out


def parity_kernel_phase(card: str, ing, k2: dict, dec: list) -> None:
    """The decode kernels of the [parity] path against their plain
    versions on the card, at the shapes that path gives them
    (parity_shapes): K2 over T=1500 cross keys and over the self cache at
    each position, K3 (fused_layer=True) at each position, K4; at K2_ATOL,
    DELTA_MAX and KV_ATOL, as the kernel phases hold them. Each case joins
    its kernel's cases in the kernels line. The last position of each
    shape, K4 and the cross rows carry the bound, the profiler's device
    ms and the mean of 20 calls queued behind a sleep kernel between two
    CUDA events (tools/torch_decode_kernel_ab.py::queued_ms); the cross
    rows also one scaled_dot_product_attention call's, beside the kernel
    phase's 32-row base row."""
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    queued_ms = load_tool("torch_decode_kernel_ab").queued_ms
    by_name = {k["name"]: k for k in dec}
    k3, k4 = by_name["decoder_self_block"], by_name["decoder_mlp_block"]
    gen = torch.Generator().manual_seed(1)
    for model, b, l, d, heads, f, positions in parity_shapes(ing):
        # K2 cross over the encoder's 1500 keys
        q, k, v = k2_inputs(gen, b, 1500, heads)
        got = K2.fused_single_query_attention(q, k, v, heads=heads)
        ref = K2.single_query_attention_plain(q, k, v, heads=heads)
        torch.cuda.synchronize()
        err = check_close(f"K2 {model} B={b} cross", got, ref, K2_ATOL,
                          K2_RTOL)
        fused = (lambda: K2.fused_single_query_attention(
            q, k, v, heads=heads))
        qh = q.view(b, 1, heads, 64).transpose(1, 2)
        kh, vh = (a.view(b, 1500, heads, 64).transpose(1, 2) for a in (k, v))
        sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh))
        case = {"shape": f"parity {model} cross B={b} T=1500 H={heads}",
                "max_abs_err": err, "device_ms": device_ms(fused),
                "queued_ms": queued_ms(fused),
                "library_queued_ms": queued_ms(sdpa),
                **bound(nbytes(q, got) + 2 * b * 1500 * d * 2,
                        bf16=4 * b * 1500 * d)}
        k2["cases"].append(case)
        phase("parity", kernel="K2", card=card, tol=[K2_ATOL, K2_RTOL],
              **case)
        del q, k, v, got, ref, qh, kh, vh
        # K2 self over the cache, and K3, at each position
        x, selfw, _, kc, vc = k3_inputs(gen, b, l, d)
        q = torch.randn(b, d, generator=gen).to(x.device, torch.bfloat16)
        for pos in positions:
            last = pos == positions[-1]
            got = K2.fused_single_query_attention(q, kc, vc, heads=heads,
                                                  pos=pos)
            ref = K2.single_query_attention_plain(q, kc, vc, heads=heads,
                                                  pos=pos)
            torch.cuda.synchronize()
            case = {"shape": f"parity {model} self B={b} L={l} H={heads} "
                             f"pos={pos}",
                    "max_abs_err": check_close(
                        f"K2 {model} B={b} L={l} pos={pos}", got, ref,
                        K2_ATOL, K2_RTOL)}
            if last:
                fn = (lambda: K2.fused_single_query_attention(
                    q, kc, vc, heads=heads, pos=pos))
                case.update(device_ms=device_ms(fn), queued_ms=queued_ms(fn),
                            **bound(nbytes(q, got) + 2 * b * (pos + 1) * d * 2,
                                    bf16=4 * b * (pos + 1) * d))
            k2["cases"].append(case)
            phase("parity", kernel="K2", card=card, tol=[K2_ATOL, K2_RTOL],
                  **case)
            args = (x, *selfw)
            ref = DB.self_block_plain(*args, kc, vc, pos, heads=heads)
            got = DB.fused_self_block(*args, kc.clone(), vc.clone(), pos,
                                      heads=heads)
            torch.cuda.synchronize()
            case = {"shape": f"parity {model} B={b} D={d} H={heads} L={l} "
                             f"pos={pos}",
                    **check_k3(f"K3 {model} B={b} L={l} pos={pos}", got,
                               ref, x)}
            if last:
                fn = (lambda: DB.fused_self_block(*args, kc, vc, pos,
                                                  heads=heads))
                case.update(device_ms=device_ms(fn), queued_ms=queued_ms(fn),
                            **k3_bound(args, got, pos))
            k3["cases"].append(case)
            phase("parity", kernel="K3", card=card,
                  tol={"delta_max": DELTA_MAX, "delta_l2": DELTA_L2,
                       "kv": [KV_ATOL, KV_RTOL]}, **case)
        del x, selfw, kc, vc, q, got, ref
        # K4 at the path's rows
        x, mlp, _ = k4_inputs(gen, b, d, f)
        got, ref = DB.fused_mlp_block(x, *mlp), DB.mlp_block_plain(x, *mlp)
        torch.cuda.synchronize()
        case = {"shape": f"parity {model} B={b} D={d} F={f}",
                **check_delta(f"K4 {model} B={b}", got, ref, x),
                "device_ms": device_ms(lambda: DB.fused_mlp_block(x, *mlp)),
                "queued_ms": queued_ms(lambda: DB.fused_mlp_block(x, *mlp)),
                **bound(nbytes(x, *mlp, got), bf16=4 * b * d * f)}
        k4["cases"].append(case)
        phase("parity", kernel="K4", card=card,
              tol={"delta_max": DELTA_MAX, "delta_l2": DELTA_L2}, **case)
        del x, mlp, got, ref
    first = k2["cases"][0]
    phase("parity", step="K2 beside the kernel phase", card=card,
          kernel_phase_row={k: first[k] for k in ("shape", "ms",
                                                  "device_ms")})


def parity_phase(card: str, rng: np.random.Generator, clips, mems: dict,
                 k2: dict, dec: list) -> dict:
    """The reference-parity decode path (PARITY_PATHS) through the
    engine: each engine ingests ``clips`` and answers the queries with
    its launches counted and checked (expected_launches: K2 twice a
    decoder layer and step, or once beside K3 and K4 under fast_lossless,
    where they take the 64 beam rows), its own segment first. The first
    path's ingest pipeline, built again from its config, then holds the
    invariants (parity_invariants) and gives the decode kernels the
    shapes they are checked at (parity_kernel_phase). Memory and ingest
    rate are printed beside the default engine's. Returns each path's
    launch counts."""
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        make_default_ingest)
    counts = {}
    for label, profile, fused in PARITY_PATHS:
        counts[label], _, mems[label] = engine_phase(
            card, rng, label, profile, fused, None, None, clips,
            cfg=parity_config(profile))
    ing = make_default_ingest(parity_config(), seed=0, device="cuda")
    parity_invariants(card, ing, rng)
    parity_kernel_phase(card, ing, k2, dec)
    del ing
    torch.cuda.empty_cache()
    paths = ("default", "fast_lossless", *counts)
    phase("parity", step="summary", card=card, launches=counts,
          **{key: {k: mems[k][key] for k in paths}
             for key in ("ingest_audio_s_per_s", "peak_allocated_bytes")})
    return counts


def ab_phase(card: str) -> dict:
    """K11's own path, the A/B tool (tools/torch_profile_encoder_kernel_
    ab.py: B=64, T=500 and 1500, each form of the division), with every
    launch count set to 0 just before and read just after; the counts
    must be K11's three forms x two contexts and nothing else."""
    from multimodal_audio_search_tpu_torch import runtime
    tool = load_tool("torch_profile_encoder_kernel_ab")
    reps = 20
    runtime.reset_counts()
    rows = tool.run(reps=reps, emit=lambda line: None)
    counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
    exp = {k: 0 for k in KEYS}
    # each case: the compared call, the warm-ups and the timed calls
    exp["K11"] = len(rows) * (1 + tool.WARMUP + reps)
    for row in rows:
        phase("ab", card=card, **row)
    if counts != exp:
        raise AssertionError(f"A/B path: launches {counts} != {exp}")
    return counts


# ------------------------------------------------------- audio, codecs
# the committed MP3 vector and its fingerprint (tests/make_mp3_vector.py)
MP3_VECTOR = os.path.join("tests", "data", "vector_16k_mono.mp3")
MP3_FINGERPRINT = os.path.join("tests", "data", "vector_16k_mono.json")
# each 1024-sample block's RMS of the vector's decode against the
# fingerprint JAX's native decoder gave (float rounding only)
MP3_RMS_ATOL = 1e-5
# the in-tree MP3 decoder against libmpg123, where the card's host has
# it (tests/test_mp3_native.py's bar)
MP3_LIB_ATOL = 3e-6
# native mel codes against the numpy codes: the FFT's summation order
# may move a code by one (ops/mel.py::_native_mel_codes)
MEL_CODE_MAX_DIFF = 1
# (label, profile, fused_layer, transfer): bench.py's codec modes
CODEC_PATHS = (("fast", "fast", True, None),
               ("fast_mel8", "fast", True, "mel8"),
               ("fast_lossless_mel16", "fast_lossless", True, "mel16"),
               ("fast_lossless_mel12", "fast_lossless", True, "mel12"),
               ("int12", None, False, "int12"))
# encoder positions of a short_context (10 s) engine
SHORT_T = 500


def host_ms(fn, n: int = 3) -> float:
    """Median wall milliseconds of ``n`` calls on the host clock."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def libav_headers() -> bool:
    """Whether g++ finds the libavformat/libavcodec headers that
    native/ffdecode.cc includes."""
    src = "#include <libavformat/avformat.h>\n" \
          "#include <libavcodec/avcodec.h>\n"
    res = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                         input=src, capture_output=True, text=True)
    return res.returncode == 0


def audio_phase(card: str, rng: np.random.Generator) -> dict:
    """The ingest front door on the card's host: the three native
    libraries built from native/*.cc with the host's g++ (seconds each;
    the WAV/FLAC/resample/quantize library and the MP3 decoder must be
    available), each container decoded and checked, and the native
    quantizers and mel encoder against their numpy forms on a
    32-segment batch. Returns the upload bodies for ``[service]``."""
    import tempfile
    from multimodal_audio_search_tpu_torch.audio import (
        ffdecode, mp3, mp3_native, native)
    from multimodal_audio_search_tpu_torch.audio.decode import (
        load_audio, sniff_format)
    from multimodal_audio_search_tpu_torch.audio.resample import resample
    from multimodal_audio_search_tpu_torch.audio.wav import (
        read_wav, to_mono, write_wav)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from flac_fixture import encode_flac
    from make_mp3_vector import fingerprint

    build = {}
    for name, mod in (("audio_kernels", native), ("mp3_decode", mp3_native),
                      ("ffdecode", ffdecode)):
        t0 = time.perf_counter()
        lib = mod.get_lib()
        build[name] = {"seconds": time.perf_counter() - t0,
                       "available": lib is not None,
                       "library": os.path.basename(lib._name) if lib
                       else None}
    headers = libav_headers()
    phase("audio", step="build", card=card, gxx=shutil.which("g++"),
          libav_headers=headers, **build)
    if not (native.available() and mp3_native.available()):
        raise AssertionError(f"audio: native libraries missing: {build}")
    out = {"build": build, "decode_ms": {}}
    tmp = tempfile.mkdtemp(prefix="mas_audio_")

    # WAV, 44.1 kHz stereo: native decode + native resample against the
    # numpy reader and resampler
    t = np.arange(44100 * 10) / 44100
    x = np.stack([0.3 * np.sin(2 * np.pi * f * t)
                  + rng.normal(size=t.size) * 0.02 for f in (220.0, 330.0)],
                 axis=1).astype(np.float32)
    path = os.path.join(tmp, "s.wav")
    write_wav(path, x, 44100)
    data = open(path, "rb").read()
    got, sr = load_audio(data, SR)
    y, r = read_wav(data)
    ref = resample(to_mono(y).astype(np.float32), r, SR)
    if native.wav_decode_mono(data) is None or sr != SR or \
            not np.array_equal(got, ref):
        raise AssertionError("audio: native WAV decode + resample differs "
                             "from the numpy path")
    out["decode_ms"]["wav_44k1_stereo_10s"] = host_ms(
        lambda: load_audio(data, SR))

    # FLAC (tests/flac_fixture.py), mono 16 kHz: the source PCM exactly
    pcm = (np.clip(make_audio(6, rng), -1.0, 1.0) * 32767).astype(np.int16)
    flac = encode_flac(pcm, rate=SR, mode="fixed2")
    got, sr = load_audio(flac, SR)
    if sniff_format(flac) != "flac" or \
            not np.array_equal(got, pcm.astype(np.float32) / 32768.0):
        raise AssertionError("audio: FLAC decode differs from its PCM")
    out["decode_ms"]["flac_16k_mono_6s"] = host_ms(
        lambda: load_audio(flac, SR))

    # the committed MP3 vector against its fingerprint (and libmpg123)
    mp3_bytes = open(os.path.join(ROOT, MP3_VECTOR), "rb").read()
    want = json.load(open(os.path.join(ROOT, MP3_FINGERPRINT)))
    dec, rate = mp3_native.decode_mp3_native(mp3_bytes)
    fp = fingerprint(dec, rate)
    rms_err = float(np.max(np.abs(np.subtract(fp["rms"], want["rms"]))))
    if (fp["samples"], fp["rate"]) != (want["samples"], want["rate"]) or \
            rms_err > MP3_RMS_ATOL:
        raise AssertionError(f"audio: MP3 vector {fp['samples']} samples at "
                             f"{fp['rate']} Hz, RMS err {rms_err}")
    lib_err = None
    if mp3.available():
        ref, _ = mp3.decode_mp3(mp3_bytes)
        lib_err = float(np.max(np.abs(ref - dec)))
        if ref.shape != dec.shape or lib_err > MP3_LIB_ATOL:
            raise AssertionError(f"audio: MP3 vs libmpg123 {lib_err}")
    out["decode_ms"]["mp3_16k_mono_14s"] = host_ms(
        lambda: load_audio(mp3_bytes, SR))

    # M4A and OGG where the FFmpeg libraries built; else the named refusal
    containers = {}
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(44100 * 2) / 44100)
            ).astype(np.float32)
    for ext in ("m4a", "ogg"):
        path = os.path.join(tmp, f"tone.{ext}")
        if ffdecode.available():
            ffdecode.encode_file(tone, 44100, path)
            body = open(path, "rb").read()
            got, sr = load_audio(body, SR)
            mid = got[4000:-4000]
            spec = np.abs(np.fft.rfft(mid))
            dom = float(np.fft.rfftfreq(len(mid), 1 / SR)[np.argmax(spec)])
            if sniff_format(body) != ext or abs(len(got) - 2 * SR) > 2000 \
                    or not np.isfinite(got).all() or abs(dom - 440.0) > 5:
                raise AssertionError(f"audio: {ext} decoded {len(got)} "
                                     f"samples, peak at {dom} Hz")
            out["decode_ms"][f"{ext}_44k1_mono_2s"] = host_ms(
                lambda: load_audio(body, SR))
            containers[ext] = {"samples": len(got), "peak_hz": dom}
        else:
            head = b"\x00\x00\x00\x1cftypM4A " if ext == "m4a" else b"OggS"
            try:
                load_audio(head + bytes(256), SR)
                raise AssertionError(f"audio: {ext} without FFmpeg decoded")
            except ValueError as e:
                if "libavformat" not in str(e):
                    raise
                containers[ext] = {"refused": str(e)}
    shutil.rmtree(tmp, ignore_errors=True)
    phase("audio", step="containers", card=card,
          wav="native decode + resample == numpy",
          flac="== source PCM", mp3={"samples": fp["samples"],
                                     "rate": fp["rate"],
                                     "rms_max_err": rms_err,
                                     "vs_libmpg123": lib_err},
          containers=containers, decode_ms=out["decode_ms"])

    # the native quantizers and mel encoder on a 32-segment batch
    out["quantize_ms"] = quantize_check(card, make_audio(320, rng)
                                        .reshape(32, -1))
    out["uploads"] = {"vector.mp3": mp3_bytes, "tone.flac": flac}
    return out


def quantize_check(card: str, batch: np.ndarray) -> dict:
    """Native against numpy, each timed on the host over the batch: the
    mu-law, int16 and int12 quantizers bit for bit, the mel16/12/8
    encoder within MEL_CODE_MAX_DIFF codes (their gmax tails bit for
    bit)."""
    from multimodal_audio_search_tpu_torch.audio import native
    from multimodal_audio_search_tpu_torch.config import MelConfig
    from multimodal_audio_search_tpu_torch.ops import mel as M
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        _mulaw_lut, _pack_int12)
    b, n = batch.shape
    scale = np.float32(0.9)
    lut = _mulaw_lut()

    def nat(kind):
        w = 3 * ((n + 1) // 2) if kind == "int12" else n
        q = np.zeros((b, w), {"mulaw8": np.int8, "int16": np.int16,
                              "int12": np.uint8}[kind])
        for i in range(b):
            ok = {"mulaw8": lambda: native.quantize_mulaw(
                      batch[i], float(scale), lut, q[i]),
                  "int16": lambda: native.quantize_int16(
                      batch[i], float(scale), q[i]),
                  "int12": lambda: native.quantize_int12(
                      batch[i], float(scale), q[i])}[kind]()
            if not ok:
                raise AssertionError(f"audio: native {kind} refused")
        return q

    def numpy_form(kind):
        wn = batch * scale
        if kind == "mulaw8":
            return lut[np.clip(np.rint(wn * 32767.5 + 32767.5), 0.0,
                               65535.0).astype(np.uint16)]
        if kind == "int16":
            return (np.clip(wn, -1.0, 1.0) * 32767.0).astype(np.int16)
        return np.stack([_pack_int12(r) for r in wn])

    res = {}
    for kind in ("mulaw8", "int16", "int12"):
        a, c = nat(kind), numpy_form(kind)
        if not np.array_equal(a, c):
            raise AssertionError(f"audio: native {kind} codes differ from "
                                 f"numpy's in {int((a != c).sum())} places")
        res[kind] = {"native_ms": host_ms(lambda: nat(kind)),
                     "numpy_ms": host_ms(lambda: numpy_form(kind))}
    cfg = MelConfig()
    t_seg = M.mel_seg_frames(n, cfg)
    for kind, enc in (("mel16", M.encode_mel16), ("mel12", M.encode_mel12),
                      ("mel8", M.encode_mel8)):
        if M._native_mel_codes(batch[:1], cfg, t_seg,
                               int(kind[3:])) is None:
            raise AssertionError(f"audio: native {kind} encoder refused")
        t0 = time.perf_counter()
        a = enc(batch, cfg, t_seg)
        native_ms = (time.perf_counter() - t0) * 1e3
        os.environ["MAS_NO_NATIVE_MEL"] = "1"
        try:
            t0 = time.perf_counter()
            c = enc(batch, cfg, t_seg)
            numpy_ms = (time.perf_counter() - t0) * 1e3
        finally:
            del os.environ["MAS_NO_NATIVE_MEL"]
        if kind == "mel12":
            ca, cc = (mel12_codes(v) for v in (a, c))
        else:
            ca, cc = (v[:, :-4] if kind == "mel8" else v for v in (a, c))
        diff = int(np.abs(ca.astype(np.int32) - cc.astype(np.int32)).max())
        if a.shape != c.shape or diff > MEL_CODE_MAX_DIFF or (
                kind != "mel16" and not np.array_equal(a[:, -4:],
                                                       c[:, -4:])):
            raise AssertionError(f"audio: native {kind} codes differ from "
                                 f"numpy's by {diff}")
        res[kind] = {"native_ms": native_ms, "numpy_ms": numpy_ms,
                     "max_code_diff": diff,
                     "bytes_per_segment": a[0].nbytes}
    phase("audio", step="quantize", card=card, segments=b,
          samples_per_segment=n, tol={"waveform": "bit-equal",
                                      "mel_codes": MEL_CODE_MAX_DIFF},
          **res)
    return res


def mel12_codes(packed: np.ndarray) -> np.ndarray:
    """The 12-bit codes of mel12 rows (without their 4-byte tail)."""
    u = packed[:, :-4].astype(np.int32).reshape(packed.shape[0], -1, 3)
    return np.stack([u[..., 0] | ((u[..., 1] & 0xF) << 8),
                     (u[..., 1] >> 4) | (u[..., 2] << 4)], -1)


def codec_config(profile, transfer):
    """EngineConfig of one entry of CODEC_PATHS."""
    from multimodal_audio_search_tpu_torch.config import (
        EngineConfig, apply_profile)
    cfg = EngineConfig()
    if profile:
        cfg = apply_profile(cfg, profile)
    return cfg.replace(transfer_dtype=transfer) if transfer else cfg


def codec_phase(card: str, rng: np.random.Generator, clips, mems: dict,
                ref_texts, k1: dict, k2: dict,
                gen: torch.Generator) -> dict:
    """The transfer codecs through the engine: each CODEC_PATHS engine
    ingests ``clips`` and answers the queries with its launches counted
    and checked (engine_phase); the short_context paths run the encoder
    at SHORT_T positions, so K1 and K2's cross attention run over
    SHORT_T keys. Then K1 and K2 at SHORT_T against their plain
    versions, each case added to its kernel's cases. Returns each path's
    launch counts."""
    counts = {}
    for label, profile, fused, transfer in CODEC_PATHS:
        cfg = codec_config(profile, transfer)
        counts[label], _, mems[label] = engine_phase(
            card, rng, label, profile, fused, None, None, clips, ref_texts,
            cfg=cfg)
        if cfg.short_context and mems[label]["encoder_positions"] != SHORT_T:
            raise AssertionError(f"{label}: encoder at "
                                 f"{mems[label]['encoder_positions']}")
    paths = ("default", *counts)
    phase("codecs", step="summary", card=card, launches=counts,
          **{key: {k: mems[k][key] for k in paths}
             for key in ("transfer_dtype", "transfer_bytes_per_segment",
                         "quantize_ms_per_batch", "encoder_positions",
                         "ingest_audio_s_per_s", "peak_allocated_bytes",
                         "asr_text_vs_default")})
    short_context_kernels(card, gen, k1, k2)
    return counts


def short_context_kernels(card: str, gen: torch.Generator, k1: dict,
                          k2: dict) -> None:
    """K1 (base and tiny, every K1_CASES input) and K2's cross attention
    (H = 8 and 6) at B=32, T=SHORT_T against their plain versions, with
    the tolerances of their T=1500 cases; the residual K1 case and each
    K2 case timed beside the bound."""
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    from multimodal_audio_search_tpu_torch.ops import encoder_block as K1
    b, t, d = 32, SHORT_T, 64
    for heads, label in ((8, "base"), (6, "tiny")):
        for inputs, q_scale, residual in K1_CASES:
            args = k1_inputs(gen, b, t, heads, q_scale=q_scale,
                             residual=residual)
            got = K1.fused_attention_o_residual(*args)
            ref = K1.attention_o_residual_plain(*args)
            torch.cuda.synchronize()
            case = {"shape": f"{label} B={b} T={t} H={heads} D={d}",
                    "inputs": inputs, "path": "short_context",
                    **cluster_case(b, t, heads),
                    **check_k1(f"K1 {label} T={t} {inputs}", got, ref,
                               residual)}
            if residual:
                case.update(
                    ms=time_ms(lambda: K1.fused_attention_o_residual(*args)),
                    plain_ms=time_ms(
                        lambda: K1.attention_o_residual_plain(*args), reps=5),
                    **attn_o_bound(b, t, heads))
            k1["cases"].append(case)
            phase("codecs", kernel="K1", card=card,
                  tol=[K1_ATOL, K1_RTOL] if residual
                  else {"y_max": K1_Y_MAX, "y_l2": K1_Y_L2}, **case)
            del args, got, ref
    for heads in (8, 6):
        hd = heads * d
        q, k, v = k2_inputs(gen, b, t, heads)
        got = K2.fused_single_query_attention(q, k, v, heads=heads)
        ref = K2.single_query_attention_plain(q, k, v, heads=heads)
        torch.cuda.synchronize()
        err = check_close(f"K2 cross T={t} H={heads}", got, ref, K2_ATOL,
                          K2_RTOL)
        qh = q.view(b, 1, heads, d).transpose(1, 2)
        kh, vh = (a.view(b, t, heads, d).transpose(1, 2) for a in (k, v))
        splits, chunk = K2.split_plan(t, b * heads)
        case = {"shape": f"cross B={b} T={t} H={heads} pos=None",
                "path": "short_context", "splits": splits,
                "keys_per_split": chunk, "max_abs_err": err,
                "ms": time_ms(lambda: K2.fused_single_query_attention(
                    q, k, v, heads=heads)),
                "plain_ms": time_ms(lambda: K2.single_query_attention_plain(
                    q, k, v, heads=heads)),
                "library_ms": time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qh, kh, vh)),
                **bound(nbytes(q, got) + 2 * b * t * hd * 2,
                        bf16=4 * b * t * hd)}
        k2["cases"].append(case)
        phase("codecs", kernel="K2", card=card, tol=[K2_ATOL, K2_RTOL],
              **case)
    torch.cuda.empty_cache()


# ------------------------------------------------------------- service
# [soak] watches RSS over a longer loop; these cycles keep a short check
SERVICE_SOAK_CYCLES = 10
# least-squares slope of VmRSS over the soak's cycles 6-10, MB a cycle
RSS_SLOPE_MAX_MB = 1.0
# each request's deadline on the host clock (the first ingest builds
# nothing: the server's warm-up has run by then)
REQUEST_TIMEOUT_S = 300


def request(base: str, path: str, data: bytes | None = None,
            raw: bool = False, headers=None):
    """(status, body, wall seconds) of one request to the service, with
    its own deadline; the body parsed as JSON unless ``raw``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        base + path, data=data, headers=headers or {},
        method="POST" if data is not None else "GET")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT_S) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    dt = time.perf_counter() - t0
    return status, (body if raw else json.loads(body)), dt


def expect(name: str, status: int, body, want: int = 200) -> None:
    if status != want:
        raise AssertionError(f"service {name}: status {status} != {want}: "
                             f"{str(body)[:500]}")


def vm_rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise AssertionError("no VmRSS in /proc/self/status")


def own_segment(meta, rows) -> int:
    """A row of ``rows`` whose ASR text no other row of ``meta`` has, else
    the first of them with a text (then a search for it must rank first a
    row with that text)."""
    texts = [m["asr_text"] for m in meta]
    rows = [i for i in rows if texts[i]]
    return next((i for i in rows if texts.count(texts[i]) == 1), rows[0])


def check_own_first(name: str, meta, own: int, hits) -> None:
    """The search for row ``own``'s ASR text (``meta``: the index's rows
    now) ranks it first, or, where other rows share that text, one of
    them."""
    text = meta[own]["asr_text"]
    same = [i for i, m in enumerate(meta) if m["asr_text"] == text]
    if not hits or hits[0]["asr_text"] != text or (
            hits[0]["index"] != own if len(same) == 1
            else hits[0]["index"] not in same):
        raise AssertionError(
            f"service {name}: row {own} not first: "
            f"{[(h['index'], h['asr_text']) for h in hits[:3]]}")


def service_phase(card: str, rng: np.random.Generator,
                  uploads: dict) -> None:
    """The port's service surface on the card at the default config's
    published widths: ``serve(engine, port=0, warmup=True)`` with its
    accept loop on a daemon thread, every request over HTTP with its own
    deadline. Ingest (sync 320 s, async 25 s; launch counts as
    expected_launches), search (own segment first, four ?q= = four
    singles, compare_all, search_combined's modes), a stream's windows
    against ingest_waveform's, transcribe_long's launches, delete (no
    row of the source after it, the own-segment check on a row the
    delete moved), save / reset / load and save_incremental, the metrics
    routes and a profile, ``uploads`` (name -> bytes: the MP3 vector and
    a FLAC) each equal to ingest_waveform on its decoded audio, own
    segment first, reconfigure to whisper-small (K1 at D=768, 12 heads),
    the mpnet embedder (200, 768-D, an ingest with K1/K2 counted and its
    own text first) and a mulaw8 reconfigure back at MiniLM-L6 that
    ingests, 10 ingest/delete cycles (VmRSS slope), and the CLI as
    subprocesses on
    one --index directory."""
    import csv
    import io
    import shutil
    import tempfile
    import threading
    import urllib.parse
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    from multimodal_audio_search_tpu_torch.index.store import SegmentStore
    from multimodal_audio_search_tpu_torch.index.strategies import STRATEGIES
    from multimodal_audio_search_tpu_torch.pipelines.longform import (
        chunk_windows)
    from multimodal_audio_search_tpu_torch.pipelines.streaming import (
        StreamingIngest)
    from multimodal_audio_search_tpu_torch.service.server import serve

    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mas_service_")
    t0 = time.perf_counter()
    eng = AudioSearchEngine(cfg=engine_config(None, False), device="cuda",
                            seed=0)
    srv = serve(eng, host="127.0.0.1", port=0, block=False, warmup=True,
                data_root=tmp)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    lock = srv.RequestHandlerClass.lock
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    q = urllib.parse.quote
    try:
        torch.cuda.synchronize()
        phase("service", step="serving", card=card,
              build_and_warmup_s=time.perf_counter() - t0,
              asr=eng.ingest_pipeline.asr.cfg.d_model,
              caption=eng.ingest_pipeline.caption.cfg.d_model)

        # ---- 1. ingest: sync 320 s, async 25 s, launches counted
        ing = eng.ingest_pipeline
        asr, cap = ing.asr, ing.caption
        long_x, short_x = make_audio(320, rng), make_audio(25, rng)
        runtime.reset_counts()
        steps0 = (asr.total_steps, cap.total_steps)
        disp0 = (asr.dispatches, cap.dispatches)
        st, body, ingest_s = request(base, "/api/ingest?name=long.wav",
                                     wav_bytes(long_x))
        expect("ingest", st, body)
        n_long = len(body["segments"])
        st, job, _ = request(base, "/api/ingest?name=short.wav&async=1",
                             wav_bytes(short_x))
        expect("async ingest", st, job, 202)
        deadline = time.perf_counter() + REQUEST_TIMEOUT_S
        while True:
            st, rec, _ = request(base, f"/api/jobs/{job['job']}")
            expect("job", st, rec)
            if rec["state"] in ("done", "failed"):
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"service: job never finished: {rec}")
            time.sleep(0.05)
        if rec["state"] != "done":
            raise AssertionError(f"service: async job failed: {rec}")
        counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
        steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
        disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
        exp = expected_launches(False, None, steps, disp, asr, cap)
        if counts != exp or not counts["K1"] or not counts["K2"]:
            raise AssertionError(f"service ingest: launches {counts} != "
                                 f"expected {exp}")
        phase("service", step="ingest", card=card,
              http_ingest_320s_wall_s=ingest_s, segments=n_long,
              async_segments=rec["n_segments"], total=rec["total"],
              launches=counts, expected=exp,
              decode_steps={"asr": steps[0], "caption": steps[1]},
              dispatches={"asr": disp[0], "caption": disp[1]})

        # ---- 2. search
        st, seg, _ = request(base, "/api/segments")
        meta = seg["segments"]
        own = own_segment(meta, range(n_long))
        texts = [m["asr_text"] for m in meta]
        st, out, _ = request(base, f"/api/search?q={q(texts[own])}")
        expect("search", st, out)
        check_own_first("search", meta, own, out["results"])
        queries = [texts[own], "upbeat music with drums",
                   "someone speaking clearly",
                   "rain and birds in the background"]
        st, batch, _ = request(base, "/api/search?" + "&".join(
            f"q={q(x)}" for x in queries))
        expect("batched search", st, batch)
        for x, b in zip(queries, batch["batch"]):
            single = request(base, f"/api/search?q={q(x)}")[1]["results"]
            got = [(h["index"], h["fusion_score"]) for h in b["results"]]
            ref = [(h["index"], h["fusion_score"]) for h in single]
            if [i for i, _ in got] != [i for i, _ in ref] or any(
                    abs(a - c) > K12_ATOL for (_, a), (_, c) in zip(got, ref)):
                raise AssertionError(f"service: batched {x!r} differs from "
                                     f"single: {got} vs {ref}")
        st, cmp_all, _ = request(
            base, f"/api/search?q={q(queries[1])}&strategy=compare_all")
        expect("compare_all", st, cmp_all)
        if set(cmp_all["weight_info"]["per_strategy"]) != set(STRATEGIES):
            raise AssertionError("service: compare_all strategies "
                                 f"{cmp_all['weight_info']['per_strategy']}")
        combined = {}
        with lock:
            for mode, slot in (("combined", None), ("asr", "asr_success"),
                               ("caption", "audio_success")):
                rows = eng.search_combined(queries[0], mode, 10)
                n_ok = len(eng.store) if slot is None else sum(
                    m[slot] for m in eng.store.meta)
                if len(rows) != min(10, n_ok):
                    raise AssertionError(f"service: search_combined {mode} "
                                         f"gave {len(rows)} rows")
                combined[mode] = len(rows)
        lat = []
        for i in range(20):
            st, out, dt = request(
                base, f"/api/search?q={q(queries[i % 4] + f' {i}')}")
            expect("search", st, out)
            lat.append(dt * 1e3)
        phase("service", step="search", card=card, own_segment=own,
              batched=len(queries), strategies=sorted(STRATEGIES),
              combined_rows=combined, http_search_ms=lat,
              http_search_p50_ms=float(np.median(lat)))

        # ---- 3. streaming: uneven int16 chunks against one shot
        wave = make_audio(45, rng)
        pcm = (np.clip(wave, -1.0, 1.0) * 32767).astype(np.int16)
        st, opened, _ = request(base, "/api/stream/open?name=stream.wav", b"")
        expect("stream open", st, opened)
        sid = opened["session"]
        cuts = [0, int(1.7 * SR), int(10.8 * SR), int(24.1 * SR),
                int(30.3 * SR), int(41.9 * SR), len(pcm)]
        streamed, commit_s = [], []
        for lo, hi in zip(cuts, cuts[1:]):
            st, out, dt = request(base, f"/api/stream/{sid}/chunk?rate={SR}",
                                  pcm[lo:hi].tobytes())
            expect("stream chunk", st, out)
            streamed += out["segments"]
            if out["segments"]:
                commit_s.append(dt)
        st, out, dt = request(base, f"/api/stream/{sid}/close", b"")
        expect("stream close", st, out)
        streamed += out["segments"]
        commit_s.append(dt)
        with lock:
            shot = eng.ingest_waveform(pcm.astype(np.float32) / 32767.0, SR,
                                       "oneshot.wav")
            eng.delete_source("oneshot.wav")
        windows = [(s["start_time"], s["end_time"]) for s in streamed]
        one_shot = [(s["start_time"], s["end_time"]) for s in shot]
        if windows != one_shot:
            raise AssertionError(f"service: stream windows {windows} != "
                                 f"one-shot {one_shot}")
        agree = sum(a["asr_text"] == b["asr_text"]
                    for a, b in zip(streamed, shot)) / max(1, len(shot))
        phase("service", step="stream", card=card, windows=len(windows),
              chunks=len(cuts) - 1, commit_wall_s=commit_s,
              asr_text_agreement=agree)

        # ---- 4. long form: the ASR model alone
        long_form = make_audio(120, rng)
        with lock:
            runtime.reset_counts()
            s0, d0 = asr.total_steps, (asr.dispatches, cap.dispatches)
            t1 = time.perf_counter()
            text = eng.transcribe_long(wav_bytes(long_form))
            torch.cuda.synchronize()
            long_s = time.perf_counter() - t1
            counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
            disp = (asr.dispatches - d0[0], cap.dispatches - d0[1])
            exp = expected_launches(False, None, (asr.total_steps - s0, 0),
                                    disp, asr, cap)
        n_win = len(chunk_windows(len(long_form), SR))
        if disp != (1, 0) or counts != exp or not isinstance(text, str):
            raise AssertionError(f"service transcribe_long: dispatches "
                                 f"{disp}, launches {counts} != {exp}")
        phase("service", step="transcribe_long", card=card, windows=n_win,
              transcribe_long_wall_s=long_s, launches=counts, expected=exp,
              chars=len(text))

        # ---- 5. delete: no row of the source, rows behind it moved
        st, seg, _ = request(base, "/api/segments")
        meta = seg["segments"]
        n_short = sum(m["source"] == "short.wav" for m in meta)
        last = max(i for i, m in enumerate(meta)
                   if m["source"] == "short.wav")
        moved = own_segment(meta, range(last + 1, len(meta)))
        moved_text = meta[moved]["asr_text"]
        st, out, _ = request(base, "/api/delete?source=short.wav", b"")
        expect("delete", st, out)
        if out["removed"] != n_short or out["total"] != len(meta) - n_short:
            raise AssertionError(f"service delete: {out}, {n_short} rows "
                                 f"of short.wav in {len(meta)}")
        seen = []
        for x in [*queries, moved_text]:
            hits = request(base, f"/api/search?q={q(x)}")[1]["results"]
            seen += hits
            if any(h["source"] == "short.wav" for h in hits):
                raise AssertionError("service: a deleted row was returned")
        # a stale device index would score the old rows against the
        # compacted meta: the row behind the deleted ones would not come
        # back at its new index with its own text
        now = request(base, "/api/segments")[1]["segments"]
        if now[moved - n_short]["segment_id"] != meta[moved]["segment_id"]:
            raise AssertionError("service: the delete did not compact")
        top = request(base, f"/api/search?q={q(texts[own])}")[1]["results"]
        check_own_first("delete", now, own, top)
        after = request(base, f"/api/search?q={q(moved_text)}")[1]["results"]
        check_own_first("delete", now, moved - n_short, after)
        with lock:     # the device index those searches scored
            view = eng.store._device_view
            emb, ok = eng.store.device_index(eng.ingest_pipeline.device)
            n = len(eng.store)
            if view is None or emb is not view[1] or not torch.equal(
                    emb[:n].cpu(), torch.from_numpy(eng.store.embeddings)) \
                    or int(ok[n:].sum()):
                raise AssertionError("service: the device index after the "
                                     "delete is not the compacted store")
        phase("service", step="delete", card=card, removed=n_short,
              total=out["total"], moved_row=[moved, after[0]["index"]],
              searched_hits=len(seen))

        # ---- 6. persistence
        st, out, _ = request(base, "/api/save?path=idx", b"")
        expect("save", st, out)
        before = request(base, "/api/segments")[1]
        top_q = f"/api/search?q={q(queries[1])}"
        top10 = request(base, top_q)[1]["results"]
        for path in ("/api/reset", "/api/load?path=idx"):
            st, out, _ = request(base, path, b"")
            expect(path, st, out)
        again = request(base, top_q)[1]["results"]
        if request(base, "/api/segments")[1] != before or \
                [h["index"] for h in again] != [h["index"] for h in top10] \
                or any(abs(a["fusion_score"] - b["fusion_score"]) > K12_ATOL
                       for a, b in zip(again, top10)):
            raise AssertionError("service: save/reset/load changed the "
                                 "segments or the top-10")
        inc = os.path.join(tmp, "incremental")
        with lock:
            live = StreamingIngest(eng.ingest_pipeline, eng.store, eng.cfg,
                                   source_name="autosave.wav",
                                   autosave_path=inc, autosave_every=1)
            live.feed(short_x[: 13 * SR], SR)
            live.feed(short_x[13 * SR:], SR)
            live.flush()
            back = SegmentStore.load(inc)
            if back.meta != eng.store.meta or not np.array_equal(
                    back.embeddings, eng.store.embeddings):
                raise AssertionError("service: save_incremental rows differ")
            shards = json.load(open(os.path.join(inc, "manifest.json")))
        phase("service", step="persistence", card=card,
              segments=before["total"], incremental_rows=len(back),
              shards=shards["shards"])

        # ---- 7. metrics, stats, a profile
        st, prom, _ = request(base, "/metrics", raw=True)
        expect("metrics", st, prom)
        samples = {}
        for line in prom.decode().splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        total = request(base, "/api/segments")[1]["total"]
        if samples.get("mas_index_segments") != total:
            raise AssertionError(f"service /metrics: mas_index_segments "
                                 f"{samples.get('mas_index_segments')} != "
                                 f"{total}")
        st, csv_body, _ = request(base, "/api/metrics.csv", raw=True)
        rows = list(csv.reader(io.StringIO(csv_body.decode())))
        st2, stats, _ = request(base, "/api/stats")
        if st != 200 or st2 != 200 or rows[0][:2] != ["timestamp",
                                                      "operation"] \
                or stats["database"]["total_segments"] != total:
            raise AssertionError("service: metrics.csv or stats malformed")
        st, prof, prof_s = request(base, f"/api/profile?q={q(queries[2])}",
                                   b"")
        expect("profile", st, prof)
        trace = os.path.join(prof["trace_dir"], "trace.json")
        if not os.path.getsize(trace):
            raise AssertionError(f"service: empty trace {trace}")
        kernels_in_trace = sum(ev.get("cat") == "kernel" for ev in
                               json.load(open(trace))["traceEvents"])
        phase("service", step="metrics", card=card, samples=len(samples),
              csv_rows=len(rows) - 1, trace_bytes=os.path.getsize(trace),
              trace_kernels=kernels_in_trace, profile_wall_s=prof_s)

        # ---- 7b. uploads: the MP3 vector and a FLAC, each as
        # ingest_waveform would ingest its decoded audio
        from multimodal_audio_search_tpu_torch.audio.decode import (
            load_audio)
        up = {}
        for name, data in uploads.items():
            n0 = request(base, "/api/segments")[1]["total"]
            st, body, wall = request(base, f"/api/ingest?name={name}", data)
            expect(f"upload {name}", st, body)
            x, sr = load_audio(data, SR)
            with lock:
                ref = eng.ingest_pipeline.process_waveform(x, sr, name)
            key = ("start_time", "end_time", "asr_text", "audio_description")
            got = [tuple(sg[k] for k in key) for sg in body["segments"]]
            want = [tuple(sg[k] for k in key) for sg in ref]
            if not got or got != want:
                raise AssertionError(f"service upload {name}: {got} != "
                                     f"ingest_waveform's {want}")
            meta = request(base, "/api/segments")[1]["segments"]
            mine = own_segment(meta, range(n0, n0 + len(got)))
            hits = request(base, f"/api/search?q={q(meta[mine]['asr_text'])}"
                           )[1]["results"]
            check_own_first(f"upload {name}", meta, mine, hits)
            up[name] = {"bytes": len(data), "audio_s": len(x) / SR,
                        "segments": len(got), "wall_s": wall,
                        "own_segment": mine}
        phase("service", step="uploads", card=card, **up)

        # ---- 8. reconfigure: whisper-small ASR, the mpnet embedder,
        # then mulaw8 at whisper-base with MiniLM-L6
        st, cfg_out, rebuild_s = request(
            base, "/api/config", json.dumps({"asr_preset": "small"}).encode(),
            headers={"Content-Type": "application/json"})
        expect("config small", st, cfg_out)
        ing = eng.ingest_pipeline
        asr, cap = ing.asr, ing.caption
        if (asr.cfg.d_model, asr.cfg.heads) != (768, 12) or \
                request(base, "/api/segments")[1]["total"] != 0:
            raise AssertionError(f"service: reconfigure gave {cfg_out}")
        runtime.reset_counts()
        steps0 = (asr.total_steps, cap.total_steps)
        disp0 = (asr.dispatches, cap.dispatches)
        st, body, small_s = request(base, "/api/ingest?name=short.wav",
                                    wav_bytes(short_x))
        expect("ingest small", st, body)
        counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
        steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
        disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
        exp = expected_launches(False, None, steps, disp, asr, cap)
        if counts != exp or disp[0] < 1:
            raise AssertionError(f"service small: launches {counts} != "
                                 f"{exp}")
        meta = request(base, "/api/segments")[1]["segments"]
        mine = own_segment(meta, range(len(meta)))
        hits = request(base, f"/api/search?q={q(meta[mine]['asr_text'])}"
                       )[1]["results"]
        check_own_first("whisper-small", meta, mine, hits)
        small = {"reconfigure_small_wall_s": rebuild_s,
                 "asr": f"whisper-small d={asr.cfg.d_model} "
                        f"H={asr.cfg.heads}",
                 "ingest_wall_s": small_s, "launches": counts,
                 "expected": exp, "own_segment": mine}
        # the mpnet embedder (A11): 200, 768-D, an empty index that then
        # ingests and answers its own text first
        st, cfg_out, mpnet_s = request(
            base, "/api/config", json.dumps(
                {"embedder": "all-mpnet-base-v2"}).encode(),
            headers={"Content-Type": "application/json"})
        expect("config mpnet", st, cfg_out)
        ing = eng.ingest_pipeline
        asr, cap = ing.asr, ing.caption
        if cfg_out["embed_dim"] != 768 or cfg_out["asr_preset"] != "small" \
                or request(base, "/api/segments")[1]["total"] != 0 or \
                not ing.embedder.model.__name__.endswith(".mpnet"):
            raise AssertionError(f"service: mpnet reconfigure gave "
                                 f"{cfg_out}")
        runtime.reset_counts()
        steps0 = (asr.total_steps, cap.total_steps)
        disp0 = (asr.dispatches, cap.dispatches)
        st, body, mpnet_ingest_s = request(
            base, "/api/ingest?name=short.wav", wav_bytes(short_x))
        expect("ingest mpnet", st, body)
        counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
        steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
        disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
        exp = expected_launches(False, None, steps, disp, asr, cap)
        if counts != exp or disp[0] < 1:
            raise AssertionError(f"service mpnet: launches {counts} != "
                                 f"{exp}")
        meta = request(base, "/api/segments")[1]["segments"]
        mine = own_segment(meta, range(len(meta)))
        hits = request(base, f"/api/search?q={q(meta[mine]['asr_text'])}"
                       )[1]["results"]
        check_own_first("mpnet", meta, mine, hits)
        small.update(mpnet_status=st, reconfigure_mpnet_wall_s=mpnet_s,
                     mpnet_embed_dim=cfg_out["embed_dim"],
                     mpnet_ingest_wall_s=mpnet_ingest_s,
                     mpnet_launches=counts, mpnet_own_segment=mine)
        # back to MiniLM-L6 with the mulaw8 transfer at whisper-base
        st, cfg_out, mulaw_s = request(
            base, "/api/config", json.dumps(
                {"asr_preset": "base", "transfer_dtype": "mulaw8",
                 "embedder": "all-MiniLM-L6-v2"}).encode(),
            headers={"Content-Type": "application/json"})
        expect("config mulaw8", st, cfg_out)
        ing = eng.ingest_pipeline
        asr, cap = ing.asr, ing.caption
        if cfg_out["transfer_dtype"] != "mulaw8" or asr.cfg.d_model != 512 \
                or cfg_out["embed_dim"] != 384:
            raise AssertionError(f"service: reconfigure gave {cfg_out}")
        runtime.reset_counts()
        steps0 = (asr.total_steps, cap.total_steps)
        disp0 = (asr.dispatches, cap.dispatches)
        st, body, mulaw_ingest_s = request(
            base, "/api/ingest?name=short.wav", wav_bytes(short_x))
        expect("ingest mulaw8", st, body)
        counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
        steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
        disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
        exp = expected_launches(False, None, steps, disp, asr, cap)
        if counts != exp or disp[0] < 1 or \
                ing.last_transfer_resolved != "mulaw8":
            raise AssertionError(f"service mulaw8: launches {counts} != "
                                 f"{exp}")
        meta = request(base, "/api/segments")[1]["segments"]
        mine = own_segment(meta, range(len(meta)))
        hits = request(base, f"/api/search?q={q(meta[mine]['asr_text'])}"
                       )[1]["results"]
        check_own_first("mulaw8", meta, mine, hits)
        phase("service", step="reconfigure", card=card, **small,
              reconfigure_mulaw8_wall_s=mulaw_s,
              mulaw8_ingest_wall_s=mulaw_ingest_s, mulaw8_launches=counts,
              mulaw8_expected=exp, mulaw8_own_segment=mine)
        st, cfg_out, base_s = request(
            base, "/api/config", json.dumps(
                {"transfer_dtype": "int16"}).encode(),
            headers={"Content-Type": "application/json"})
        expect("config int16", st, cfg_out)

        # ---- 9. memory: ingest/delete cycles
        data = wav_bytes(short_x)
        rss = []
        for _ in range(SERVICE_SOAK_CYCLES):
            st, body, _ = request(base, "/api/ingest?name=cycle.wav", data)
            expect("cycle ingest", st, body)
            st, out, _ = request(base, "/api/delete?source=cycle.wav", b"")
            if st != 200 or out["removed"] != len(body["segments"]):
                raise AssertionError(f"service cycle delete: {out}")
            rss.append(vm_rss_mb())
        slope = float(np.polyfit(np.arange(5, SERVICE_SOAK_CYCLES),
                                 rss[5:], 1)[0])
        phase("service", step="memory", card=card, vm_rss_mb=rss,
              slope_mb_per_cycle=slope, limit=RSS_SLOPE_MAX_MB)
        if slope > RSS_SLOPE_MAX_MB:
            raise AssertionError(f"service: VmRSS grows {slope:.3f} MB a "
                                 f"cycle > {RSS_SLOPE_MAX_MB}")
    finally:
        srv.shutdown()
        srv.server_close()
        srv.RequestHandlerClass.jobs_q.put(None)

    # ---- 10. the CLI, one process a subcommand, on one --index
    idx = os.path.join(tmp, "cli_index")
    files = []
    for name, x in (("a.wav", short_x), ("b.wav", make_audio(15, rng))):
        files.append(os.path.join(tmp, name))
        with open(files[-1], "wb") as f:
            f.write(wav_bytes(x))

    def cli(*args):
        t1 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "multimodal_audio_search_tpu_torch",
             "--index", idx, *args], cwd=ROOT, capture_output=True,
            text=True, timeout=REQUEST_TIMEOUT_S)
        if res.returncode != 0:
            raise AssertionError(f"service CLI {args}: rc {res.returncode}"
                                 f"\n{res.stderr[-3000:]}")
        return res.stdout, time.perf_counter() - t1

    out, cli_s = cli("ingest", *files)
    n = len(SegmentStore.load(idx))
    if f"2 file(s): {n} segments (index total {n})" not in out:
        raise AssertionError(f"service CLI ingest: {out!r}, {n} stored")
    # one search process, with --strategy (a search without it costs a
    # process, ~13 s, for no other code: the script's time limit)
    res = strat = json.loads(cli("search", "upbeat music with drums",
                                 "--strategy", "fixed_5050")[0])
    removed = sum(m["source"] == files[0]
                  for m in SegmentStore.load(idx).meta)
    out_del = cli("delete", files[0])[0]
    stats = json.loads(cli("stats")[0])
    left = SegmentStore.load(idx)
    if not res["results"] or strat["weight_info"]["strategy"] != \
            "fixed_5050" or \
            f"removed {removed} segment(s) (index total {n - removed})" \
            not in out_del or stats["database"]["total_segments"] != \
            n - removed or len(left) != n - removed or any(
                m["source"] == files[0] for m in left.meta):
        raise AssertionError(f"service CLI: {res['results'][:1]}, "
                             f"{strat['weight_info']}, {out_del!r}, "
                             f"{stats['database']}")
    phase("service", step="cli", card=card, segments=n, removed=removed,
          left=len(left), ingest_process_wall_s=cli_s)
    shutil.rmtree(tmp, ignore_errors=True)
    del eng
    torch.cuda.empty_cache()


# ------------------------------------------------- the secondary models (A11)
# the default engine reconfigured to each embedder choice, in this order,
# with the embed_dim each must give
EMBEDDER_STEPS = (("all-mpnet-base-v2", 768),
                  ("clip-ViT-B-32-multilingual-v1", 768),
                  ("all-MiniLM-L6-v2", 384))
EMBED_QUERIES = ("upbeat music with drums", "someone speaking clearly",
                 "rain and birds in the background")
# card against CPU, the same float32 weights and inputs (TF32 off on the
# card): a text tower's unit-norm embeddings within EMBED_ATOL (the CPU
# tests' bar against JAX); an audio tower's, whose features the card
# computes itself (the STFT + mel of ClapSearch, the bicubic resize and
# the patch im2col of HTSAT) in another summation order, within CLAP_ATOL
EMBED_ATOL = 5e-5
CLAP_ATOL = 1e-4
# after a reconfigure, the allocation may move by the two embedders'
# parameter bytes and this much more: a kept old embedder (>= 91 MB at
# MiniLM-L6) or old Whisper pair would exceed it
EMBED_FREE_SLACK = 64 << 20


def tree_bytes(tree) -> int:
    """Bytes of the tensors in a param tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def embedders_phase(card: str, clips, device: str = "cuda") -> dict:
    """The engine's three embedder choices at published widths on a
    default engine (whisper-base ASR, whisper-tiny captions; random init,
    seed 0): reconfigure to all-mpnet-base-v2 (MPNet 12 x 768, vocab
    30527), clip-ViT-B-32-multilingual-v1 (the 6 x 768 DistilBERT text
    tower, vocab 119,547), then back to all-MiniLM-L6-v2. After each: the
    rebuild wall, embed_dim, the previous pipelines freed (the allocation
    moves by the embedders' parameter bytes), the 25 s clip ingested (and
    the 320 s clip under mpnet, for an ingest rate) with K1/K2 launches
    as expected_launches, each text's segment first, the card's query
    embeddings within EMBED_ATOL of the same embedder's on the CPU, one
    query's and a 32-text batch's embed ms, query p50 over 4 queries, peak
    memory. Returns {embedder: launch counts}. (``device`` "cpu" is for
    rehearsing the phase at test widths.)"""
    import gc
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    from multimodal_audio_search_tpu_torch.models.layers import cast_floats
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    (long_name, long_x), (short_name, short_x) = clips
    torch.cuda.empty_cache()
    eng = AudioSearchEngine(cfg=engine_config(None, False), device=device,
                            seed=0)
    eng.load_all_models()
    cpu = torch.device("cpu")
    out, p50 = {}, {}
    for name, dim in EMBEDDER_STEPS:
        gc.collect()
        torch.cuda.synchronize()
        old_bytes = tree_bytes(eng.embedder.params)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg_out = eng.reconfigure(embedder=name)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        gc.collect()
        emb = eng.embedder
        moved = torch.cuda.memory_allocated() - before
        params_moved = tree_bytes(emb.params) - old_bytes
        if cfg_out["embedder"] != name or cfg_out["embed_dim"] != dim or \
                emb.dim != dim or len(eng.store) != 0:
            raise AssertionError(f"embedders {name}: reconfigure gave "
                                 f"{cfg_out}, dim {emb.dim}")
        if abs(moved - params_moved) > EMBED_FREE_SLACK:
            raise AssertionError(
                f"embedders {name}: the allocation moved {moved} bytes, the "
                f"embedders' params {params_moved}: the previous pipelines "
                f"were not freed")
        ing = eng.ingest_pipeline
        asr, cap = ing.asr, ing.caption
        runtime.reset_counts()
        steps0 = (asr.total_steps, cap.total_steps)
        disp0 = (asr.dispatches, cap.dispatches)
        runs = [(short_name, short_x)]
        if name == EMBEDDER_STEPS[0][0]:
            runs.append((long_name, long_x))
        rates = {}
        for nm, x in runs:
            t0 = time.perf_counter()
            eng.ingest(wav_bytes(x), source_name=nm)
            torch.cuda.synchronize()
            rates[nm] = len(x) / SR / (time.perf_counter() - t0)
        counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
        steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
        disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
        exp = expected_launches(False, None, steps, disp, asr, cap)
        if counts != exp or disp[0] < 1:
            raise AssertionError(f"embedders {name}: launches {counts} != "
                                 f"{exp}")
        meta = eng.store.meta
        own = own_segment(meta, range(len(meta)))
        queries = [meta[own]["asr_text"], *EMBED_QUERIES]
        lat = []
        for qi, qt in enumerate(queries):
            tq = time.perf_counter()
            hits, _ = eng.search(qt)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - tq) * 1e3)
            if qi == 0:
                check_own_first(f"embedders {name}", meta, own, hits)
        # the same embedder on the CPU: its weights copied, float32
        ref = TextEmbedder(params=cast_floats(emb.params, torch.float32, cpu),
                           cfg=emb.cfg, model=emb.model,
                           tokenizer=emb.tokenizer,
                           max_tokens=emb.max_tokens, device="cpu")
        err = float(np.abs(emb(queries) - ref(queries)).max())
        if not err <= EMBED_ATOL:
            raise AssertionError(f"embedders {name}: card vs CPU max |err| "
                                 f"{err:.3e} > {EMBED_ATOL}")
        del ref
        texts = [m["asr_text"] or m["audio_description"] for m in meta]
        batch = [texts[i % len(texts)] for i in range(32)]
        one_ms = host_ms(lambda: emb(queries[:1]), n=10)
        batch_ms = host_ms(lambda: emb(batch), n=5)
        p50[name] = float(np.median(lat))
        out[name] = counts
        phase("embedders", embedder=name, card=card,
              model=emb.model.__name__.rsplit(".", 1)[-1],
              width=emb.cfg.hidden, layers=emb.cfg.layers,
              vocab=emb.cfg.vocab_size, embed_dim=cfg_out["embed_dim"],
              rebuild_wall_s=rebuild_s, allocated_moved_bytes=moved,
              params_moved_bytes=params_moved,
              embedder_param_bytes=tree_bytes(emb.params),
              peak_allocated_bytes=torch.cuda.max_memory_allocated(),
              segments=len(meta), ingest_audio_s_per_s=rates,
              launches=counts, expected=exp, own_segment=own,
              card_vs_cpu_max_abs_err=err, tol=EMBED_ATOL,
              embed_one_query_ms=one_ms, embed_32_texts_ms=batch_ms,
              query_ms=lat, query_p50_ms=p50[name])
        # hold nothing of this embedder's engine into the next step's
        # allocation check
        del ing, asr, cap, emb
    phase("embedders", step="query p50 beside MiniLM-L6", card=card,
          query_p50_ms=p50)
    del eng
    torch.cuda.empty_cache()
    return out


def clap_topk_check(cs, query: str, k: int = 10) -> dict:
    """ClapSearch.search's top-k against a plain scoring of the store's
    rows (numpy dot of the AUDIO slot with the card's query embedding, a
    stable descending sort): the same row at every rank whose plain score
    is more than K12_ATOL from its neighbours, scores within K12_ATOL."""
    hits = cs.search(query, k=k)
    q = cs.embed_query(query).cpu().numpy()
    scores = cs.store.embeddings[:, 1] @ q
    order = np.argsort(-scores, kind="stable")
    if len(hits) != min(k, len(scores)):
        raise AssertionError(f"clap {query!r}: {len(hits)} hits")
    ref = scores[order]
    for i, h in enumerate(hits):
        if abs(h["similarity"] - scores[h["index"]]) > K12_ATOL:
            raise AssertionError(f"clap {query!r}: rank {i} scores "
                                 f"{h['similarity']} vs {scores[h['index']]}")
        clear = (i + 1 >= len(ref) or ref[i] - ref[i + 1] > K12_ATOL) and (
            i == 0 or ref[i - 1] - ref[i] > K12_ATOL)
        if clear and h["index"] != order[i]:
            raise AssertionError(f"clap {query!r}: rank {i} is {h['index']},"
                                 f" the plain scoring's {order[i]}")
    return {"top": [h["index"] for h in hits[:3]],
            "top_score": hits[0]["similarity"]}


def clap_phase(card: str, clips, device: str = "cuda",
               htsat=None, roberta=None) -> dict:
    """The CLAP search path on the card, random init from seed 0.

    1. ClapSearch at its default ClapConfig (80 mels, d_model 256, 4
       layers, 512-D; MiniLM-L6 text tower) ingests the 320 s clip (32
       rows), the 25 s clip (3: the 5 s tail kept) and its first 20.5 s
       (2: the 0.5 s tail dropped); each query's top-10 equals a plain
       scoring of the store's rows; 2 chunks' embeddings and the queries'
       on the card within CLAP_ATOL / EMBED_ATOL of the CPU's.
    2. The HTSAT-Swin and RoBERTa towers at laion's defaults
       (HTSATConfig(), RobertaConfig()): 32 chunks of the 320 s clip at
       48 kHz through clap_features, one B=32 audio_embed timed (audio-s/s,
       peak memory), 2 rows against the CPU; the fused tower
       (enable_fusion) on a row longer than 10 s and one shorter against
       the CPU; the text tower's ms for one query and the 4 queries
       against the CPU.
    (``device`` "cpu" and smaller ``htsat`` / ``roberta`` configs are for
    rehearsing the phase.)"""
    import dataclasses
    from multimodal_audio_search_tpu_torch.audio import clap_features as CF
    from multimodal_audio_search_tpu_torch.audio.resample import (
        resample_best)
    from multimodal_audio_search_tpu_torch.models import clap_htsat as CH
    from multimodal_audio_search_tpu_torch.models.layers import cast_floats
    from multimodal_audio_search_tpu_torch.models.tokenizer import (
        load_tokenizer)
    from multimodal_audio_search_tpu_torch.pipelines.clap_ingest import (
        ClapSearch)
    cpu, cuda, f32 = torch.device("cpu"), torch.device(device), torch.float32
    (_, long_x), (_, short_x) = clips
    queries = ["upbeat music with drums", *EMBED_QUERIES[1:], "a dog barks"]

    # ---- 1. ClapSearch (the v1 tower)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cs = ClapSearch(device=device, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = cs.ingest_waveform(long_x, SR, "long.wav")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    n25 = len(cs.ingest_waveform(short_x, SR, "short.wav"))
    n205 = len(cs.ingest_waveform(short_x[: int(20.5 * SR)], SR,
                                  "short_20.5s.wav"))
    ends = [m["end_time"] for m in cs.store.meta[32:35]]
    if len(rows) != 32 or (n25, n205) != (3, 2) or ends != [10.0, 20.0, 25.0]:
        raise AssertionError(f"clap: rows {len(rows)}, 25 s -> {n25}, "
                             f"20.5 s -> {n205}, ends {ends}")
    tops = {qt: clap_topk_check(cs, qt) for qt in queries}
    lat = []
    for qt in queries:
        tq = time.perf_counter()
        cs.search(qt)
        lat.append((time.perf_counter() - tq) * 1e3)
    ref = ClapSearch(audio_params=cast_floats(cs.audio_params, f32, cpu),
                     text_params=cast_floats(cs.text_params, f32, cpu),
                     proj_params=cast_floats(cs.proj_params, f32, cpu),
                     acfg=cs.acfg, tcfg=cs.tcfg, tokenizer=cs.tokenizer,
                     device="cpu")
    n = cs.mel_cfg.n_samples
    two = np.stack([long_x[:n], long_x[n: 2 * n]]).astype(np.float32)
    audio_err = float(np.abs(cs.embed_batch(two).cpu().numpy()
                             - ref.embed_batch(two).numpy()).max())
    text_err = max(float((cs.embed_query(qt).cpu()
                          - ref.embed_query(qt)).abs().max())
                   for qt in queries)
    if not (audio_err <= CLAP_ATOL and text_err <= EMBED_ATOL):
        raise AssertionError(f"clap: card vs CPU audio {audio_err:.3e} "
                             f"(tol {CLAP_ATOL}), text {text_err:.3e} "
                             f"(tol {EMBED_ATOL})")
    phase("clap", step="ClapSearch", card=card, config=str(cs.acfg),
          build_s=build_s, rows=len(rows), rows_25s=n25, rows_20_5s=n205,
          ingest_audio_s_per_s=len(long_x) / SR / ingest_s,
          search_ms=lat, search_p50_ms=float(np.median(lat)), top=tops,
          card_vs_cpu_audio_max_abs_err=audio_err, audio_tol=CLAP_ATOL,
          card_vs_cpu_text_max_abs_err=text_err, text_tol=EMBED_ATOL,
          peak_allocated_bytes=torch.cuda.max_memory_allocated())
    del cs, ref

    # ---- 2. HTSAT-Swin + RoBERTa at laion's defaults
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    acfg, tcfg = htsat or CH.HTSATConfig(), roberta or CH.RobertaConfig()
    gen = torch.Generator().manual_seed(0)
    ap_cpu = CH.init_audio_params(gen, acfg)
    tp_cpu = CH.init_text_params(gen, tcfg)
    ap, tp = (cast_floats(t, f32, cuda) for t in (ap_cpu, tp_cpu))
    t0 = time.perf_counter()
    x48 = resample_best(long_x, SR, CF.SAMPLE_RATE)
    chunk = CF.MAX_SAMPLES
    feats = np.concatenate([CF.clap_input_features(x48[i * chunk:
                                                       (i + 1) * chunk])
                            for i in range(32)])          # [32, 1, 1001, 64]
    features_s = time.perf_counter() - t0
    xf = torch.from_numpy(feats).to(cuda)
    with torch.inference_mode():
        def tower():
            z = CH.audio_embed(ap, xf, acfg)
            torch.cuda.synchronize()
            return z
        z = tower()
        tower_ms = host_ms(tower, n=3)
        zr = CH.audio_embed(ap_cpu, torch.from_numpy(feats[:2]), acfg)
    norms = z.norm(dim=-1)
    if tuple(z.shape) != (32, acfg.projection_dim) or \
            not torch.isfinite(z).all() or \
            float((norms - 1).abs().max()) > 1e-5:
        raise AssertionError(f"clap htsat: {tuple(z.shape)}, norms "
                             f"{norms.min()}-{norms.max()}")
    htsat_err = float((z[:2].cpu() - zr).abs().max())
    peak_htsat = torch.cuda.max_memory_allocated()
    # the fused tower: a row longer than 10 s, a row shorter
    fcfg = dataclasses.replace(acfg, enable_fusion=True)
    fp_cpu = CH.init_audio_params(gen, fcfg)
    fp = cast_floats(fp_cpu, f32, cuda)
    ff, longer = CF.clap_fusion_batch(
        [x48[: 15 * CF.SAMPLE_RATE],
         x48[15 * CF.SAMPLE_RATE: 20 * CF.SAMPLE_RATE]])
    with torch.inference_mode():
        zf = CH.audio_embed(fp, torch.from_numpy(ff).to(cuda), fcfg,
                            is_longer=torch.from_numpy(longer).to(cuda))
        zfr = CH.audio_embed(fp_cpu, torch.from_numpy(ff), fcfg,
                             is_longer=longer)
    fused_err = float((zf.cpu() - zfr).abs().max())
    # the text tower
    tok = load_tokenizer(vocab_size=tcfg.vocab_size)
    ids, mask = tok.encode(queries, 64)
    ids_t = torch.as_tensor(ids, dtype=torch.long)
    mask_t = torch.as_tensor(mask)
    with torch.inference_mode():
        zt = CH.text_embed(tp, ids_t.to(cuda), mask_t.to(cuda), tcfg)
        ztr = CH.text_embed(tp_cpu, ids_t, mask_t, tcfg)

        def one_query():
            CH.text_embed(tp, ids_t[:1].to(cuda), mask_t[:1].to(cuda), tcfg)
            torch.cuda.synchronize()
        one_query()
        text_ms = host_ms(one_query, n=10)
    roberta_err = float((zt.cpu() - ztr).abs().max())
    if not (htsat_err <= CLAP_ATOL and fused_err <= CLAP_ATOL
            and roberta_err <= EMBED_ATOL and list(longer) == [True, False]
            and torch.isfinite(zf).all()):
        raise AssertionError(
            f"clap towers: card vs CPU htsat {htsat_err:.3e}, fused "
            f"{fused_err:.3e} (tol {CLAP_ATOL}, is_longer {list(longer)}), "
            f"roberta {roberta_err:.3e} (tol {EMBED_ATOL})")
    phase("clap", step="HTSAT + RoBERTa (laion defaults)", card=card,
          htsat=str(acfg), roberta=str(tcfg),
          audio_param_bytes=tree_bytes(ap), text_param_bytes=tree_bytes(tp),
          host_features_s=features_s, batch=32, tower_ms=tower_ms,
          tower_audio_s_per_s=32 * CF.MAX_LENGTH_S / (tower_ms / 1e3),
          peak_allocated_bytes=peak_htsat,
          card_vs_cpu_htsat_max_abs_err=htsat_err,
          card_vs_cpu_fused_max_abs_err=fused_err,
          fused_is_longer=[bool(v) for v in longer],
          card_vs_cpu_roberta_max_abs_err=roberta_err,
          audio_tol=CLAP_ATOL, text_tol=EMBED_ATOL,
          text_one_query_ms=text_ms)
    del ap, tp, fp, xf
    torch.cuda.empty_cache()
    return {"htsat_tower_ms": tower_ms, "text_ms": text_ms}


# ------------------------------------------------------------------ [mesh]
# the data axis of the [mesh] phase's searches, and its ingest's
MESH_DP, MESH_INGEST_DP = 4, 2
MESH_QUERIES = 16
MESH_PROBE = 8


def _wall_ms(fn, dev) -> tuple[float, object]:
    """(host milliseconds of one call, the device synchronized after it;
    its result)."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3, out


def _same_out(name, got: dict, ref: dict, tol: float = K12_ATOL) -> float:
    """A sharded search's result dict against the unsharded one's: the
    same indices, valid flags and num_valid, scores within ``tol``.
    Returns max |score err|."""
    for key in ("indices", "valid", "num_valid"):
        if not torch.equal(got[key].cpu(), ref[key].cpu()):
            raise AssertionError(f"{name}: {key} {got[key].tolist()} != "
                                 f"{ref[key].tolist()}")
    err = float((got["scores"].cpu() - ref["scores"].cpu()).abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: max |score err| {err:.3e} > {tol}")
    return err


def mesh_search_check(card: str, emb, success, qs, devices) -> dict:
    """The sharded search paths on one data shard a device of ``devices``
    (one card named several times, several cards, or the CPU) against the
    unsharded exact scan of the same index on ``devices[0]``, for every
    query of ``qs``: the exact sharded search (indices, valid, num_valid
    identical, scores within K12_ATOL), the sharded IVF (a full probe
    equal to exact; recall@10 at n_probe MESH_PROBE and the build's
    seconds), then, inside a one-process group (NCCL on the card, Gloo
    on the CPU; a FileStore in a temporary directory), the two-stage
    hierarchical top-k and IVF over a (dcn 1, data len(devices)) mesh
    equal to the flat results. Prints one line a step; raises on a
    failed check."""
    import tempfile
    import torch.distributed as dist
    from multimodal_audio_search_tpu_torch.index.fusion import fused_topk
    from multimodal_audio_search_tpu_torch.index.ivf import (
        build_ivf_sharded, sharded_ivf_search_impl)
    from multimodal_audio_search_tpu_torch.parallel import distributed as D
    from multimodal_audio_search_tpu_torch.parallel.mesh import make_mesh
    from multimodal_audio_search_tpu_torch.parallel.sharding import (
        shard_index, sharded_fused_search_impl)
    recall = load_tool("torch_bench_ivf").recall
    w = (0.6, 0.4)
    k = 10
    dev, dp = torch.device(devices[0]), len(devices)
    mesh = make_mesh(dp, devices=devices)
    e_full = torch.from_numpy(emb).to(dev)
    ok_full = torch.from_numpy(success).to(dev)
    e_sh, ok_sh = shard_index(mesh, emb, success)
    q_d = torch.from_numpy(qs).to(dev)
    sharded = sharded_fused_search_impl(mesh, k=k)
    flat_ms, sh_ms, refs, errs = [], [], [], []
    for qi, q in enumerate(q_d):
        t, ref = _wall_ms(lambda: fused_topk(q, e_full, ok_full, *w, k=k),
                          dev)
        flat_ms.append(t)
        t, got = _wall_ms(lambda: sharded(q, e_sh, ok_sh, *w), dev)
        sh_ms.append(t)
        errs.append(_same_out(f"[mesh] exact q{qi}", got, ref))
        refs.append(ref)
    out = {"rows": len(emb), "dim": emb.shape[-1], "dp": dp,
           "queries": len(qs), "exact_max_score_err": max(errs),
           "exact_p50_ms": float(np.median(flat_ms[1:])),
           "sharded_p50_ms": float(np.median(sh_ms[1:]))}
    phase("mesh", card=card, step="exact sharded = exact", **out)
    # ---- sharded IVF over the same shards
    t0 = time.perf_counter()
    layout = build_ivf_sharded(emb, success, dp, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    placed = layout.place(mesh.data_devices())
    full = sharded_ivf_search_impl(mesh, layout, k=k,
                                   n_probe=layout.n_clusters)
    probe = sharded_ivf_search_impl(mesh, layout, k=k, n_probe=MESH_PROBE)
    rec, ivf_ms = [], []
    for qi, (q, ref) in enumerate(zip(q_d, refs)):
        got = full(q, *placed, e_sh, ok_sh, *w)
        keep = ref["scores"] > -1e29
        if not torch.equal(got["indices"][keep].cpu(),
                           ref["indices"][keep].cpu()) or float(
                (got["scores"][keep] - ref["scores"][keep]).abs().max()
                if keep.any() else 0.0) > K12_ATOL:
            raise AssertionError(f"[mesh] IVF full probe q{qi}: "
                                 f"{got['indices'].tolist()} != "
                                 f"{ref['indices'].tolist()}")
        t, got = _wall_ms(lambda: probe(q, *placed, e_sh, ok_sh, *w), dev)
        ivf_ms.append(t)
        rec.append(recall(got["indices"].cpu().numpy(),
                          got["scores"].cpu().numpy(),
                          ref["indices"].cpu().numpy(),
                          ref["scores"].cpu().numpy(), k))
    ivf = {"build_s": build_s, "n_clusters": layout.n_clusters,
           "spill_per_shard": [int((s >= 0).sum()) for s in layout.spill],
           "n_probe": MESH_PROBE, "recall_at_10": float(np.mean(rec)),
           "p50_ms": float(np.median(ivf_ms[1:]))}
    phase("mesh", card=card, step="sharded IVF", **ivf)
    # ---- the two stages, the second over a process group
    hier = {}
    with tempfile.TemporaryDirectory() as tmp:
        D.initialize(init_method=f"file://{tmp}/pg", world_size=1, rank=0,
                     device=dev)
        try:
            dmesh = D.make_dcn_mesh(dcn=1, ici_data=dp, devices=devices)
            de, dok = D.shard_index_dcn(dmesh, emb, success)
            topk = D.hierarchical_sharded_topk(dmesh, k=k)
            hivf = D.hierarchical_sharded_ivf(dmesh, layout, k=k,
                                              n_probe=layout.n_clusters)
            for qi, (q, ref) in enumerate(zip(q_d, refs)):
                keep = ref["scores"] > -1e29
                for name, (s, i) in (("top-k", topk(q, de, dok, *w)), (
                        "IVF", hivf(q, *placed, de, dok, *w))):
                    if not torch.equal(i[keep].cpu(),
                                       ref["indices"][keep].cpu()) or \
                            float((s[keep] - ref["scores"][keep]).abs()
                                  .max()) > K12_ATOL:
                        raise AssertionError(
                            f"[mesh] hierarchical {name} q{qi}: "
                            f"{i.tolist()} != {ref['indices'].tolist()}")
            hier = {"backend": dist.get_backend(),
                    "world": dist.get_world_size(),
                    "mesh": dmesh.shape, "queries": len(qs)}
        finally:
            dist.destroy_process_group()
    phase("mesh", card=card, step="hierarchical = flat", **hier)
    return {"exact": out, "ivf": ivf, "hierarchical": hier}


def decode_margins(pipe, enc: torch.Tensor, tokens: torch.Tensor,
                   lengths: torch.Tensor, seed: int | None = None,
                   rel: float = LOGITS_ERR_REL,
                   at: torch.Tensor | None = None) -> torch.Tensor:
    """Replay a greedy decode's own tokens through the decoder (the
    pipeline's decode config and logits rules) and return, a row, the
    smallest top-2 margin of the processed logits over the steps that
    chose a token, less ``rel`` of that step's largest |logit|: a row
    whose value is <= 0 had a step where a rounding of the kernels' size
    could flip the greedy choice (the largest |logit| before the rules,
    whose bans put -1e9 in). A sampled decode (``seed``: the dispatch's
    generator seed) is replayed with its noise drawn again as generate
    draws it, one draw a step: the margin is then that of logits / t +
    noise, less ``rel`` of the largest |logit| / t. ``at`` [B]: each
    row's margin at its step at[row] alone (the step that chose the
    token at column prompt length + at[row]; inf where no step is)."""
    from multimodal_audio_search_tpu_torch.models import generate as G
    from multimodal_audio_search_tpu_torch.models import whisper as W
    cfg, dev = pipe.cfg, enc.device
    b, total = tokens.shape
    p = len(pipe.prefix_ids)
    ckv = G._select_cross_kv(pipe.params, enc, cfg, pipe.decode)
    cache = W.init_cache(cfg, b, total, enc.dtype, dev)
    ar = torch.arange(total, device=dev)
    worst = torch.full((b,), float("inf"), device=dev)
    last = p - 1 + int(lengths.max())
    sample = pipe.decode.method == "sample"
    t = max(pipe.decode.temperature, 1e-6) if sample else 1.0
    rng = torch.Generator(device=dev).manual_seed(seed) if sample else None
    for pos in range(min(total - 1, last)):
        logits = W.decode_step(pipe.params, tokens[:, pos], pos, cache, ckv,
                               cfg, fused_layer=pipe.decode.fused_layer)
        noise = G._gumbel(rng, logits.shape, dev) if sample else 0.0
        scale = logits.float().abs().max(dim=-1).values
        if pos < p - 1:
            continue
        seen = tokens.masked_fill(ar[None, :] > pos, cfg.pad_token_id)
        logits = G.apply_repetition_penalty(
            logits, seen, (ar <= pos)[None, :].expand(b, total),
            pipe.decode.repetition_penalty)
        logits = G.ban_repeated_ngrams(
            logits, seen, torch.full((b,), pos + 1, device=dev),
            pipe.decode.no_repeat_ngram_size)
        top2 = (logits.float() / t + noise).topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1] - rel * scale / t
        live = pos - (p - 1) < lengths
        if at is not None:
            live = live & (at == pos - (p - 1))
        worst = torch.where(live, torch.minimum(worst, margin), worst)
    return worst


def _ingest_batch(ing, wave: np.ndarray):
    """The first batch process_waveform makes of ``wave`` (at 16 kHz):
    (its segments' count, the batch's codes in a host tensor, the
    transfer, the segment length)."""
    from multimodal_audio_search_tpu_torch.audio.segment import (
        peak_scale, segment_windows)
    from multimodal_audio_search_tpu_torch.utils.batching import bucket_pow2
    cfg = ing.cfg
    scale = np.float32(peak_scale(wave, cfg.audio))
    wins = segment_windows(len(wave), SR, cfg.segment)[: cfg.ingest_batch]
    waves = [wave[w.start_sample: w.start_sample + w.length] for w in wins]
    seg_len = min(int(cfg.segment.segment_seconds * SR),
                  ing.asr.mel_cfg.n_samples)
    b = bucket_pow2(len(waves), ing.batch_floor())
    transfer = ing.last_transfer_resolved or cfg.transfer_dtype
    q = ing._encode_transfer(waves, b, seg_len, scale, transfer)
    return len(waves), q, transfer, seg_len


def beam_margins(pipe, mel) -> tuple:
    """A beam dispatch of ``pipe`` on ``mel`` with each step watched: a
    step's logits may be off by LOGITS_ERR_REL of their largest |value|
    a row (over its k beams), its log-probabilities by twice that, and a
    candidate's cumulative score by the sum of that over the steps so
    far; for every row, the smallest gap between neighbours among the 2k
    + 1 best candidates (the finite ones) less that sum, over the steps.
    A row whose value is <= 0 had a step where a rounding of the
    kernels' size could reorder its candidates. Returns ((tokens,
    lengths), margins)."""
    from multimodal_audio_search_tpu_torch.models import beam as BM
    k = pipe.decode.num_beams
    worst, err = [], []
    top_k, step = BM.top_k_stable, BM.decode_step

    def stepped(*a, **kw):
        logits = step(*a, **kw)
        scale = logits.float().abs().amax(dim=-1).reshape(-1, k).amax(1)
        err.append((err[-1] if err else 0.0)
                   + 2 * LOGITS_ERR_REL * scale)
        return logits

    def watched(x, n):
        v = torch.sort(x, dim=1, descending=True, stable=True)[0][:, :2 * k
                                                                  + 1]
        fin = v > BM.NEG_INF / 2
        gap = torch.where(fin[:, :-1] & fin[:, 1:], v[:, :-1] - v[:, 1:],
                          torch.full_like(v[:, 1:], float("inf")))
        worst.append(gap.min(dim=1).values - err[-1])
        return top_k(x, n)
    BM.top_k_stable, BM.decode_step = watched, stepped
    try:
        out = pipe.dispatch_mel(mel)
    finally:
        BM.top_k_stable, BM.decode_step = top_k, step
    margins = torch.stack(worst).min(dim=0).values if worst else \
        torch.full((out[0].shape[0],), float("inf"))
    return out, margins.to(out[0].device)


def split_expected(fused, steps, disp, asr, cap, int8=None,
                   enc=None) -> dict:
    """expected_launches of a run whose Whisper pipelines each run over
    their ``model_parallel`` ranks (1 without a model axis): every launch
    of a model once a rank, but the logits' K5 (an int8 decoder's, once a
    step) on the first rank only; "v2" runs the True form (K3, K4) over
    the axis; each encoder layer its rank's kernel (encoder_kernel of
    the rank's heads)."""
    out = {}
    for i, pipe in enumerate((asr, cap)):
        mp = pipe.model_parallel
        f = True if fused == "v2" and mp > 1 else fused
        st = (steps[0], 0) if i == 0 else (0, steps[1])
        dp = (disp[0], 0) if i == 0 else (0, disp[1])
        e = expected_launches(f, int8, st, dp, asr, cap, enc)
        if int8:       # the logits, once a step, on the first rank only
            e["K5"] = mp * (e["K5"] - steps[i]) + steps[i]
            mp_k5 = 1
        else:
            mp_k5 = mp
        for key, n in e.items():
            out[key] = out.get(key, 0) + n * (mp_k5 if key == "K5" else mp)
    return out


def split_encode(pipe, mels) -> list:
    """A split pipeline's encoder output on each data row's chunk of
    ``mels``: its replicas', or its head shards' (encode_tp, the first
    rank's copy)."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    if pipe._shards is not None:
        return [W.encode_tp(list(row), m.to(pipe.dtype), pipe.cfg,
                            fused_blocks=pipe.fused_encoder_resolved)[0]
                for row, m in zip(pipe._shards, mels)]
    return [W.encode(r, m.to(pipe.dtype), pipe.cfg,
                     fused_blocks=pipe.fused_encoder_resolved)
            for r, m in zip(pipe._replicas, mels)]


def mesh_ingest_check(card: str, wave: np.ndarray, cfg, devices,
                      mp: int = 1, whole=None) -> dict:
    """The split ingest: make_default_ingest(cfg, mesh=m) over
    ``devices`` (one card named twice on the card), a (len / mp, mp)
    mesh, against the same config without a mesh on devices[0] (or the
    ``whole`` result of an earlier call, reused), both ingesting
    ``wave``. The split engine's launches equal split_expected for its
    chunks (its dispatches count one a chunk; with a model axis, every
    launch once a rank, the int8 decoder's logits once); its segments
    (ids, times) equal the unsplit one's; on the first batch, the
    chunks' encoder outputs are within ENC_MEAN_ERR_MAX of the whole
    batch's (mean |err|) and, in both Whisper models, a row's tokens
    differ only where the unsplit decode had a step with a top-2 margin
    within LOGITS_ERR_REL of its logits (decode_margins, with the
    sampling noise of the same seed under sampling; beam_margins under
    beam search; such rows are counted, and the texts follow the
    tokens); the own-segment query and ANN_QUERIES give identical top-10
    ids from a sharded and an unsharded searcher over the split engine's
    store, and with a model axis (phase ``[tp]``) from the unsplit
    engine's searcher where every text is equal."""
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    from multimodal_audio_search_tpu_torch.index.search import FusionSearcher
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.parallel.mesh import make_mesh
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        make_default_ingest)
    tag = "[tp]" if mp > 1 else "[mesh]"
    dev = torch.device(devices[0])
    mesh = make_mesh(len(devices), model_parallel=mp, devices=devices)
    fused = cfg.asr_decode.fused_layer
    fe = cfg.asr_decode.fused_encoder
    int8 = cfg.asr_decode.cross_attn if cfg.asr_model.quantize_decoder \
        else None
    enc = fe if fe is False or fe in ("int8", "paired") else None
    engines, counts = {}, {}
    if whole is not None:
        engines["whole"] = whole["engine"]
        counts["whole"] = whole["launches_unsplit"]
    for label, m in (("split", mesh), ("whole", None)):
        if label in engines:
            continue
        t0 = time.perf_counter()
        ing = make_default_ingest(cfg, seed=0, device=dev, mesh=m)
        eng = AudioSearchEngine(cfg=cfg, ingest_pipeline=ing, device=dev)
        asr, cap = ing.asr, ing.caption
        runtime.reset_counts()
        steps0 = (asr.total_steps, cap.total_steps)
        disp0 = (asr.dispatches, cap.dispatches)
        t1 = time.perf_counter()
        segs = eng.ingest_waveform(wave, SR, "mesh.wav")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        counts[label] = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
        steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
        disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
        exp = split_expected(fused, steps, disp, asr, cap, int8, enc)
        if dev.type == "cuda" and (counts[label] != exp or not all(
                counts[label][k] > 0 for k in exp if exp[k])):
            raise AssertionError(f"{tag} {label} ingest: launches "
                                 f"{counts[label]} != {exp}")
        engines[label] = (eng, segs, disp, exp, {
            "build_s": t1 - t0, "ingest_s": t2 - t1, "steps": steps})
    (eng, segs, disp, exp, wall), (eng1, segs1, _, _, wall1) = \
        engines["split"], engines["whole"]
    # with one data row the split run's launches are mp x the unsplit
    # run's wherever both decoded the same number of steps (where every
    # kernel runs its partial form once a rank: not for the int8
    # decoder's logits, "v2", or the encoder variants, whose forms
    # differ between a rank and the whole layer)
    mp_x_unsplit = counts["split"] == {k: mp * v
                                       for k, v in counts["whole"].items()}
    mirrored = int8 is None and enc is None and fused != "v2"
    if dev.type == "cuda" and len(mesh.data_devices()) == 1 and mirrored \
            and wall["steps"] == wall1["steps"] and not mp_x_unsplit:
        raise AssertionError(f"{tag} split ingest: launches "
                             f"{counts['split']} != {mp} x the unsplit "
                             f"{counts['whole']}")
    keys = ("segment_id", "start_time", "end_time", "duration")
    if [[s[k] for k in keys] for s in segs] != \
            [[s[k] for k in keys] for s in segs1]:
        raise AssertionError(f"{tag} split ingest: segments differ")
    # ---- the first batch, decoded whole and split
    ing, ing1 = eng.ingest_pipeline, eng1.ingest_pipeline
    # each engine's own bucket: the split one's may hold more rows (its
    # floor keeps every chunk at the fused gate's 8 under fused_layer)
    n, q, transfer, seg_len = _ingest_batch(ing1, wave)
    _, q2, transfer2, _ = _ingest_batch(ing, wave)
    chunks = torch.chunk(q2, len(mesh.data_devices()))
    rows = {}
    with torch.inference_mode():
        mel1 = ing1._device_mel(q.to(dev), transfer, seg_len)
        mels = [ing._device_mel(c.to(d), transfer2, seg_len)
                for c, d in zip(chunks, mesh.data_devices())]
        for name in ("asr", "caption"):
            p1, p2 = getattr(ing1, name), getattr(ing, name)
            enc1 = W.encode(p1.params, mel1.to(p1.dtype), p1.cfg,
                            fused_blocks=p1.fused_encoder_resolved)
            enc2 = torch.cat([e.to(dev) for e in split_encode(p2, mels)])
            enc2 = enc2[: enc1.shape[0]]
            enc_err = float((enc1.float() - enc2.float()).abs().mean())
            # one sampling seed for both (a reused unsplit engine has
            # dispatched more often)
            p1.calls = p2.calls = max(p1.calls, p2.calls)
            if p1.decode.method == "beam":
                ms1, ((t1, l1), margin) = _wall_ms(
                    lambda: beam_margins(p1, mel1), dev)
            else:
                ms1, (t1, l1) = _wall_ms(lambda: p1.dispatch_mel(mel1), dev)
                margin = decode_margins(p1, enc1, t1, l1, seed=p1.calls)
            margin = margin[:n]
            ms2, (t2, l2) = _wall_ms(lambda: p2.dispatch_mel(mels), dev)
            close = margin <= 0
            differ = (t1[:n] != t2[:n]).any(dim=1) | (l1[:n] != l2[:n])
            if enc_err > ENC_MEAN_ERR_MAX or bool((differ & ~close).any()):
                raise AssertionError(
                    f"{tag} {name}: encoder mean |err| {enc_err:.3e} "
                    f"(limit {ENC_MEAN_ERR_MAX}); rows whose tokens differ "
                    f"{differ.tolist()}, rows within the margin "
                    f"{close.tolist()}")
            rows[name] = {"encoder_mean_abs_err": enc_err,
                          "rows": n, "rows_within_margin": int(close.sum()),
                          "rows_differing": int(differ.sum()),
                          "min_margin": float(margin.min()),
                          "model_parallel": p2.model_parallel,
                          "method": p2.decode.method,
                          "dispatch_ms": ms2, "dispatch_ms_unsplit": ms1,
                          "steps": p2.last_steps}
    texts_equal = sum(a["asr_text"] == b["asr_text"] and
                      a["audio_description"] == b["audio_description"]
                      for a, b in zip(segs, segs1))
    # ---- sharded and unsharded searchers over the split engine's store
    meta = eng.store.meta
    queries = [meta[own_segment(meta, range(len(meta)))]["asr_text"],
               *ANN_QUERIES]
    tops = []
    for qt in queries:
        hits = [[h["index"] for h in FusionSearcher(
            eng.store, ing.embedder, cfg=cfg.fusion, mesh=m)(qt)[0]]
            for m in (mesh, None)]
        if hits[0] != hits[1]:
            raise AssertionError(f"{tag} searcher {qt!r}: sharded "
                                 f"{hits[0]} != unsharded {hits[1]}")
        if mp > 1 and texts_equal == len(segs):
            whole_hits = [h["index"] for h in eng1.search(qt)[0]]
            if whole_hits != hits[0]:
                raise AssertionError(f"{tag} {qt!r}: top-10 {hits[0]} != "
                                     f"the unsplit engine's {whole_hits}")
        tops.append(hits[0])
    out = {"dp": len(mesh.data_devices()), "mp": mp, "segments": len(segs),
           "texts_equal": texts_equal, "decode": rows,
           "dispatches": {"asr": disp[0], "caption": disp[1]},
           "launches": counts["split"], "expected": exp,
           "launches_unsplit": counts["whole"],
           "launches_mp_x_unsplit": mp_x_unsplit if mirrored else None,
           "top10": tops,
           "top10_equal_unsplit": mp > 1 and texts_equal == len(segs),
           "wall": wall, "wall_unsplit": wall1}
    if mp > 1:
        phase("tp", card=card, step=f"(dp, mp) = ({out['dp']}, {mp}) "
                                    f"ingest", **out)
    else:
        phase("mesh", card=card, step="data-parallel ingest", **out)
    out["engine"] = engines["whole"]
    return out


def mesh_phase(card: str, clips) -> dict:
    """[mesh]: mesh_search_check at the [ann] data (1M segments of MiniLM
    width, tools/torch_bench_ivf.make_data, MESH_QUERIES queries) over
    MESH_DP shards of the card, then mesh_ingest_check of the default
    config over MESH_INGEST_DP chunks on the 25 s clip, and the device
    indices the kernel library was set up on. Returns the split ingest's
    launch counts."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.config import EngineConfig
    tool = load_tool("torch_bench_ivf")
    cuda = torch.device("cuda", 0)
    t0 = time.perf_counter()
    emb, success, qs = tool.make_data(tool.ROWS, queries=MESH_QUERIES)
    phase("mesh", card=card, step="data", rows=len(emb),
          seconds=time.perf_counter() - t0)
    mesh_search_check(card, emb, success, qs, [cuda] * MESH_DP)
    del emb, success
    torch.cuda.empty_cache()
    out = mesh_ingest_check(card, dict(clips)["short.wav"], EngineConfig(),
                            [cuda] * MESH_INGEST_DP)
    phase("mesh", card=card, step="runtime",
          kernels_ready_on=runtime.ready_devices())
    torch.cuda.empty_cache()
    return out["launches"]

# [tp]: the mesh's model axis (Megatron tensor parallelism) over TP_MP
# ranks, the card named once a rank. The kernels' partial forms (K1p,
# K3p, K4p) at a rank's shard of each width: (label, heads, D) for K1p
# (B=32, T=1500, H / TP_MP heads, Wo [H / TP_MP * 64, D]), whisper-base
# for K3p (B=32, L=68, pos=67) and K4p (F / TP_MP = 1024). Each is held
# to its plain twin as its square form is (K1p: the attention term alone,
# K1_Y_MAX / K1_Y_L2; K3p, K4p: the block term, DELTA_MAX / DELTA_L2, and
# K3p's cache row at KV_ATOL / KV_RTOL) and, summed over the ranks by
# model_sum, to the square kernel on the whole layer. The encoder
# variants' partial forms (K9p at whisper-base's and -tiny's rank widths,
# K10p at -base's: -tiny's 3 heads a rank take K1p) the same way, K9p
# repeated K9_REPEATS times bit-equal as K9 is; K5 at the column and row
# shards of whisper-base's decoder (TP_K5_SHAPES, each beside its square
# shape), K6 and K7 on 4 and 3 heads at cross T=1500.
TP_MP = 2
TP_K1_WIDTHS = (("base", 8, 512), ("tiny", 6, 384), ("large-v3", 20, 1280))
TP_ENC_WIDTHS = (("base", 8, 512), ("tiny", 6, 384))
# (label, M, K, N, out, bias, the square shape's (K, N)): a rank's share
# at B=32 rows of whisper-base's decoder and its cross K/V projection
TP_K5_SHAPES = (("q/k/v column", 32, 512, 256, "bf16", True, (512, 512)),
                ("mlp_in column", 32, 512, 1024, "bf16", True, (512, 2048)),
                ("o row", 32, 256, 512, "f32", False, (512, 512)),
                ("mlp_out row", 32, 1024, 512, "f32", False, (2048, 512)),
                ("cross k/v column", 48000, 512, 256, "bf16", True,
                 (512, 512)))
# each path of the model axis: (label, profile, fused_layer, int8 cross
# attention, fused_encoder, the data axes it runs at): the default config
# and fast_lossless at (1, TP_MP) and (2, TP_MP), the rest at (1, TP_MP);
# "parity" is parity_config (sampled ASR, beam-2 captions)
TP_PATHS = (("default", None, False, None, None, (1, 2)),
            ("fast_lossless", "fast_lossless", True, None, None, (1, 2)),
            ("parity", None, False, None, None, (1,)),
            ("v2", "fast_lossless", "v2", None, None, (1,)),
            ("int8_fused", None, False, "int8_fused", None, (1,)),
            ("int8", None, False, "int8", None, (1,)),
            ("enc_int8", None, False, None, "int8", (1,)),
            ("enc_paired", None, False, None, "paired", (1,)))


def tp_config(label, profile, fused, int8, enc, base=None):
    """The EngineConfig of a TP_PATHS entry, on ``base`` (default:
    EngineConfig())."""
    if label == "parity":
        return parity_config(profile, base)
    return engine_config(profile, fused, int8, enc, base)


def k9p_bound(b: int, t: int, hl: int, hdo: int) -> dict:
    """bound() of K9p: q of the rank's hl heads, its int8 K/V with their
    float32 scales, its Wo rows and the float32 output; the two int8
    attention products and the bf16 o-projection."""
    hd = hl * 64
    return bound(b * t * hd * 2 + 2 * b * t * hd + 8 * b * hl * t
                 + hd * hdo * 2 + b * t * hdo * 4,
                 int8=4 * b * hl * t * t * 64, bf16=2 * b * t * hd * hdo)


def k1p_bound(b: int, t: int, hl: int, hdo: int) -> dict:
    """bound() of K1p: q/k/v of the rank's hl heads, its Wo rows and the
    float32 output; the two attention products and the o-projection."""
    hd = hl * 64
    return bound(3 * b * t * hd * 2 + hd * hdo * 2 + b * t * hdo * 4,
                 bf16=4 * b * hl * t * t * 64 + 2 * b * t * hd * hdo)


def tp_shard_rows(a: torch.Tensor, j: int, axis: int) -> torch.Tensor:
    """Rank j's contiguous block of ``a`` on ``axis`` (TP_MP ranks)."""
    return torch.chunk(a, TP_MP, axis)[j].contiguous()


def tp_kernel_phase(card: str, gen: torch.Generator, k1: dict, k2: dict,
                    dec: list, device: str = "cuda", b: int = 32,
                    t: int = 1500, int8k: list | None = None
                    ) -> list[dict]:
    """K1p, K2 on head shards, K3p and K4p against their plain twins at a
    rank's shard, each timed beside its square form; the ranks' K1p, K3p
    and K4p partials through model_sum against the square kernel on the
    whole layer. Appends each case to its kernel's cases. With ``int8k``
    (int8_kernel_phase's K5, K6, K7), also tp_variant_kernels: K9p and
    K10p, returned as their own entries of the kernels line, and K5 / K6
    / K7 at shard shapes, appended to int8k's. ``device``, ``b`` and
    ``t`` let the tests rehearse the checks on the CPU at a small size
    (their twins then stand in for the kernels)."""
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    from multimodal_audio_search_tpu_torch.ops import encoder_block as K1
    from multimodal_audio_search_tpu_torch.parallel.mesh import model_sum
    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
    for label, heads, hdo in TP_K1_WIDTHS:
        hl = heads // TP_MP
        q, k, v, _, _, _ = k1_inputs(gen, b, t, hl, residual=False,
                                     device=device)
        wo = (torch.randn(hl * 64, hdo, generator=gen) / math.sqrt(hdo)).to(
            device, q.dtype)
        fn = (lambda: K1.fused_attention_o_residual(q, k, v, None, wo, None,
                                                    partial=True))
        got = fn()
        ref = K1.attention_o_residual_plain(q, k, v, None, wo, None,
                                            partial=True)
        sync()
        sq = k1_inputs(gen, b, t, heads, device=device)
        case = {"shape": f"TP {label} rank of {TP_MP}: B={b} T={t} H={hl} "
                         f"Wo [{hl * 64}, {hdo}] (partial)",
                "inputs": "attention",
                **(cluster_case(b, t, hl) if device == "cuda" else {}),
                **check_k1(f"K1p {label}", got, ref, False),
                "repeats_equal": check_repeats(f"K1p {label}", fn, got,
                                               K3_REPEATS),
                "ms": time_ms(fn),
                "plain_ms": time_ms(lambda: K1.attention_o_residual_plain(
                    q, k, v, None, wo, None, partial=True), reps=5),
                "square_ms": time_ms(
                    lambda: K1.fused_attention_o_residual(*sq)),
                "square_shape": f"B={b} T={t} H={heads}",
                **k1p_bound(b, t, hl, hdo)}
        if device == "cuda":
            case.update(device_ms=device_ms(fn), square_device_ms=device_ms(
                lambda: K1.fused_attention_o_residual(*sq)))
        k1["cases"].append(case)
        phase("tp", kernel="K1", card=card,
              tol={"y_max": K1_Y_MAX, "y_l2": K1_Y_L2}, **case)
        del q, k, v, wo, got, ref, sq
        torch.cuda.empty_cache()
    # the ranks' partials summed = the square K1 on the whole layer
    for inputs, _, residual in K1_CASES[:2]:
        q, k, v, x, wo, bo = k1_inputs(gen, b, t, 8, residual=residual,
                                     device=device)
        hl = 8 // TP_MP
        parts = [K1.fused_attention_o_residual(
            q[:, j * hl:(j + 1) * hl], k[:, j * hl:(j + 1) * hl],
            v[:, j * hl:(j + 1) * hl], None, tp_shard_rows(wo, j, 0), None,
            partial=True) for j in range(TP_MP)]
        got = model_sum(parts, bo, x)[0]
        ref = K1.fused_attention_o_residual(q, k, v, x, wo, bo)
        sync()
        case = {"shape": f"TP base: model_sum of {TP_MP} K1p ranks vs "
                         f"square K1, B={b} T={t} H=8", "inputs": inputs,
                **check_k1(f"K1p sum {inputs}", got, ref, residual)}
        k1["cases"].append(case)
        phase("tp", kernel="K1", card=card, tol=[K1_ATOL, K1_RTOL]
              if residual else {"y_max": K1_Y_MAX, "y_l2": K1_Y_L2}, **case)
        del q, k, v, x, wo, bo, parts, got, ref
        torch.cuda.empty_cache()
    # K2 on the head shards of whisper-base and -tiny
    for hl in (8 // TP_MP, 6 // TP_MP):
        for kind, tk, pos in (("cross", 1500, None), ("self", 68, 67)):
            qq, kk, vv = k2_inputs(gen, b, tk, hl, device=device)
            fn = (lambda: K2.fused_single_query_attention(
                qq, kk, vv, heads=hl, pos=pos))
            got = fn()
            ref = K2.single_query_attention_plain(qq, kk, vv, heads=hl,
                                                  pos=pos)
            sync()
            n = tk if pos is None else pos + 1
            case = {"shape": f"TP {kind} head shard B={b} T={tk} H={hl} "
                             f"pos={pos}",
                    "max_abs_err": check_close(f"K2 TP H={hl} {kind}", got,
                                               ref, K2_ATOL, K2_RTOL),
                    "ms": time_ms(fn),
                    "plain_ms": time_ms(
                        lambda: K2.single_query_attention_plain(
                            qq, kk, vv, heads=hl, pos=pos)),
                    **bound(nbytes(qq, got) + 2 * b * n * hl * 64 * 2,
                            bf16=4 * b * n * hl * 64)}
            k2["cases"].append(case)
            phase("tp", kernel="K2", card=card, tol=[K2_ATOL, K2_RTOL],
                  **case)
    # K3p and K4p at whisper-base width, a rank's 4 heads / 1024 columns
    by_name = {k["name"]: k for k in dec}
    _, d, heads, f = DEC_WIDTHS[0]
    hl, l, pos = heads // TP_MP, 68, K3_POS[-1]
    x, selfw, _, kc, vc = k3_inputs(gen, b, l, d, device=device)
    g1, b1, wq, bq, wk, wv, bv, wo, bo = selfw
    ranks = [(g1, b1, tp_shard_rows(wq, j, 1), tp_shard_rows(bq, j, 0),
              tp_shard_rows(wk, j, 1), tp_shard_rows(wv, j, 1),
              tp_shard_rows(bv, j, 0), tp_shard_rows(wo, j, 0), bo)
             for j in range(TP_MP)]
    caches = [(tp_shard_rows(kc, j, 2), tp_shard_rows(vc, j, 2))
              for j in range(TP_MP)]
    zero = torch.zeros(b, d, device=device)

    def k3p(j):
        return DB.fused_self_block(x, *ranks[j], caches[j][0].clone(),
                                   caches[j][1].clone(), pos, heads=hl,
                                   partial=True)

    def flat(outs):
        return torch.cat([a.reshape(-1).float() for a in outs])
    got = k3p(0)
    ref = DB.self_block_plain(x, *ranks[0], *caches[0], pos, heads=hl,
                              partial=True)
    sync()
    args = (x, *ranks[0][:-1])
    case = {"shape": f"TP base rank of {TP_MP}: B={b} D={d} H={hl} L={l} "
                     f"pos={pos} (partial)",
            **check_k3(f"K3p base pos={pos}", got, ref, zero),
            "repeats_equal": check_repeats(
                f"K3p base pos={pos}", lambda: flat(k3p(0)), flat(got),
                K3_REPEATS),
            "ms": time_ms(lambda: DB.fused_self_block(
                x, *ranks[0], *caches[0], pos, heads=hl, partial=True)),
            "plain_ms": time_ms(lambda: DB.self_block_plain(
                x, *ranks[0], *caches[0], pos, heads=hl, partial=True)),
            "square_ms": time_ms(lambda: DB.fused_self_block(
                x, *selfw, kc, vc, pos, heads=heads)),
            **bound(nbytes(*args, *got) + 2 * b * pos * hl * 64 * 2,
                    bf16=2 * b * d * hl * 64 * 4
                    + 4 * b * (pos + 1) * hl * 64)}
    if device == "cuda":
        case.update(device_ms=device_ms(lambda: DB.fused_self_block(
            x, *ranks[0], *caches[0], pos, heads=hl, partial=True)),
            square_device_ms=device_ms(lambda: DB.fused_self_block(
                x, *selfw, kc, vc, pos, heads=heads)))
    parts = [k3p(j)[0] for j in range(TP_MP)]
    whole = DB.fused_self_block(x, *selfw, kc.clone(), vc.clone(), pos,
                                heads=heads)[0]
    case["sum_vs_square"] = check_delta(
        "K3p sum vs K3", model_sum(parts, bo, x)[0], whole, x)
    by_name["decoder_self_block"]["cases"].append(case)
    phase("tp", kernel="K3", card=card,
          tol={"delta_max": DELTA_MAX, "delta_l2": DELTA_L2,
               "kv": [KV_ATOL, KV_RTOL]}, **case)
    x, mlp, _ = k4_inputs(gen, b, d, f, device=device)
    g, bl, w1, b1f, w2, b2 = mlp
    ranks = [(g, bl, tp_shard_rows(w1, j, 1), tp_shard_rows(b1f, j, 0),
              tp_shard_rows(w2, j, 0), b2) for j in range(TP_MP)]

    def k4p(j):
        return DB.fused_mlp_block(x, *ranks[j], partial=True)
    got = k4p(0)
    ref = DB.mlp_block_plain(x, *ranks[0], partial=True)
    sync()
    case = {"shape": f"TP base rank of {TP_MP}: B={b} D={d} "
                     f"F={f // TP_MP} (partial)",
            **check_delta("K4p base", got, ref, zero),
            "repeats_equal": check_repeats("K4p base", lambda: k4p(0), got,
                                           K3_REPEATS),
            "ms": time_ms(lambda: k4p(0)),
            "plain_ms": time_ms(lambda: DB.mlp_block_plain(
                x, *ranks[0], partial=True)),
            "square_ms": time_ms(lambda: DB.fused_mlp_block(x, *mlp)),
            **bound(nbytes(x, *ranks[0][:-1], got),
                    bf16=4 * b * d * f // TP_MP)}
    if device == "cuda":
        case.update(device_ms=device_ms(lambda: k4p(0)),
                    square_device_ms=device_ms(
                        lambda: DB.fused_mlp_block(x, *mlp)))
    case["sum_vs_square"] = check_delta(
        "K4p sum vs K4", model_sum([k4p(j) for j in range(TP_MP)], b2,
                                   x)[0], DB.fused_mlp_block(x, *mlp), x)
    by_name["decoder_mlp_block"]["cases"].append(case)
    phase("tp", kernel="K4", card=card,
          tol={"delta_max": DELTA_MAX, "delta_l2": DELTA_L2}, **case)
    if int8k is None:
        return []
    return tp_variant_kernels(card, gen, int8k, device, b, t)


def tp_variant_kernels(card: str, gen: torch.Generator, int8k: list,
                       device: str = "cuda", b: int = 32,
                       t: int = 1500) -> list[dict]:
    """K9p (TP_ENC_WIDTHS) and K10p (the widths whose rank holds an even
    head count) against their plain twins, K9_REPEATS launches bit-equal
    to the first, each timed beside its square form; the ranks' partials
    through model_sum against square K9 / K10 on the whole layer (K1's
    tolerance, on K1_CASES' residual inputs). K5 at TP_K5_SHAPES, K6 and
    K7 on the rank's heads at cross T (whisper-base's 4 and -tiny's 3),
    each against its plain version and beside its square form; appended
    to ``int8k``'s cases. Returns the kernels line's K9p and K10p
    entries."""
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    from multimodal_audio_search_tpu_torch.parallel.mesh import model_sum
    cuda = device == "cuda"
    pkg, jx = "multimodal_audio_search_tpu_torch/csrc", \
        "multimodal_audio_search_tpu/ops"
    k9p = {"name": "encoder_attn_o_residual_int8_partial", "route": "cuda",
           "source": f"{pkg}/encoder_block_int8.cu",
           "replaces": f"{jx}/encoder_block.py:319", "cases": []}
    k10p = {"name": "encoder_attn_o_residual_paired_partial",
            "route": "cuda", "source": f"{pkg}/encoder_block_wgmma.cu",
            "replaces": f"{jx}/encoder_block.py:375", "cases": []}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(case, fn, plain, square):
        case.update(ms=time_ms(fn), plain_ms=time_ms(plain, reps=5),
                    square_ms=time_ms(square))
        if cuda:
            case.update(device_ms=device_ms(fn),
                        square_device_ms=device_ms(square))

    for label, heads, hdo in TP_ENC_WIDTHS:
        hl = heads // TP_MP
        q, k, v, _, _, _ = k1_inputs(gen, b, t, hl, residual=False,
                                     device=device)
        wo = (torch.randn(hl * 64, hdo, generator=gen) / math.sqrt(hdo)).to(
            device, q.dtype)
        kv = EB.quantize_kv(k, v)
        sq = k1_inputs(gen, b, t, heads, device=device)
        sq9 = (sq[0], *EB.quantize_kv(sq[1], sq[2]), *sq[3:])
        runs = [("K9p", k9p,
                 lambda: EB.attention_o_residual_int8(
                     q, *kv, None, wo, None, partial=True),
                 lambda: EB.attention_o_residual_int8_plain(
                     q, *kv, None, wo, None, partial=True),
                 lambda: EB.attention_o_residual_int8(*sq9))]
        if hl % 2 == 0:
            runs.append((
                "K10p", k10p,
                lambda: EB.fused_attention_o_residual(
                    q, k, v, None, wo, None, pair_heads=True, partial=True),
                lambda: EB.attention_o_residual_paired_plain(
                    q, k, v, None, wo, None, partial=True),
                lambda: EB.fused_attention_o_residual(*sq, pair_heads=True)))
        for name, entry, fn, plain, square in runs:
            got, ref = fn(), plain()
            sync()
            case = {"shape": f"TP {label} rank of {TP_MP}: B={b} T={t} "
                             f"H={hl} Wo [{hl * 64}, {hdo}] (partial)",
                    "inputs": "attention",
                    **(cluster_case(b, t, hl, True)
                       if cuda and name == "K10p" else {}),
                    **check_k1(f"{name} {label}", got, ref, False),
                    "repeats_equal": check_repeats(f"{name} {label}", fn,
                                                   got, K9_REPEATS),
                    "square_shape": f"B={b} T={t} H={heads}"}
            timed(case, fn, plain, square)
            case.update(k9p_bound(b, t, hl, hdo) if name == "K9p"
                        else k1p_bound(b, t, hl, hdo))
            entry["cases"].append(case)
            phase("tp", kernel=name, card=card,
                  tol={"y_max": K1_Y_MAX, "y_l2": K1_Y_L2}, **case)
            del got, ref
        del q, k, v, wo, kv, sq, sq9, runs
        if cuda:
            torch.cuda.empty_cache()
        # the ranks' partials summed = the square kernel on the whole layer
        q, k, v, x, wo, bo = k1_inputs(gen, b, t, heads, device=device)
        kv = EB.quantize_kv(k, v)

        def rank(a, j, axis=1):
            return torch.chunk(a, TP_MP, axis)[j]
        sums = [("K9p", k9p, lambda j: EB.attention_o_residual_int8(
                    rank(q, j), *(rank(a, j).contiguous() for a in kv), None,
                    tp_shard_rows(wo, j, 0), None, partial=True),
                 lambda: EB.attention_o_residual_int8(q, *kv, x, wo, bo))]
        if hl % 2 == 0:
            sums.append(("K10p", k10p, lambda j: EB.fused_attention_o_residual(
                rank(q, j), rank(k, j), rank(v, j), None,
                tp_shard_rows(wo, j, 0), None, pair_heads=True, partial=True),
                lambda: EB.fused_attention_o_residual(q, k, v, x, wo, bo,
                                                      pair_heads=True)))
        for name, entry, part, whole in sums:
            got = model_sum([part(j) for j in range(TP_MP)], bo, x)[0]
            ref = whole()
            sync()
            case = {"shape": f"TP {label}: model_sum of {TP_MP} {name} "
                             f"ranks vs square {name[:-1]}, B={b} T={t} "
                             f"H={heads}", "inputs": "residual",
                    **check_k1(f"{name} sum {label}", got, ref, True)}
            entry["cases"].append(case)
            phase("tp", kernel=name, card=card, tol=[K1_ATOL, K1_RTOL],
                  **case)
            del got, ref
        del q, k, v, x, wo, bo, kv, sums
        if cuda:
            torch.cuda.empty_cache()
    k5, k6, k7 = int8k
    for label, m, kk, n, dt, bias, (sk, sn) in TP_K5_SHAPES:
        m = m if m <= 64 else b * t
        out_dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, wq, scale, bb = k5_inputs(gen, m, kk, n, bias=bias, device=device)
        p = {"wq": wq, "scale": scale, **({"b": bb} if bias else {})}
        sx, swq, ss, sbb = k5_inputs(gen, m, sk, sn, bias=bias,
                                     device=device)
        sp = {"wq": swq, "scale": ss, **({"b": sbb} if bias else {})}
        fn = (lambda: Q.quant_dense_apply(p, x, out_dtype=out_dtype))
        got = fn()
        ref = k5_plain(x, wq, scale, bb, out_dtype)
        sync()
        case = {"shape": f"TP base {label} rank of {TP_MP}: M={m} K={kk} "
                         f"N={n} out={dt} bias={bias}",
                "square_shape": f"M={m} K={sk} N={sn}",
                "plan": dict(zip(("kernel", "bn", "splits", "steps"),
                                 Q.split_plan(m, kk, n, wave=(
                                     torch.cuda.get_device_properties(
                                         x.device).multi_processor_count
                                     if cuda else Q.WAVE)))),
                "max_abs_err": check_k5(f"K5 TP {label}", got, ref),
                **bound(nbytes(x, wq, scale, bb, got), bf16=2 * m * kk * n)}
        timed(case, fn, lambda: k5_plain(x, wq, scale, bb, out_dtype),
              lambda: Q.quant_dense_apply(sp, sx, out_dtype=out_dtype))
        if cuda:
            lib, why = k5_library(x, wq, scale)
            case["library_ms"] = time_ms(lib) if lib else None
            if not lib:
                case["library"] = why
        k5["cases"].append(case)
        phase("tp", kernel="K5", card=card,
              tol={"atol_of_max": K5_ATOL, "rtol": K5_RTOL_BF16 if dt ==
                   "bf16" else K5_RTOL_F32}, **case)
        del x, wq, scale, bb, p, sx, swq, ss, sbb, sp, got, ref
    for label, heads in (("base", 8), ("tiny", 6)):
        hl = heads // TP_MP
        args = k6_inputs(gen, b, t, hl, device=device)
        sq = k6_inputs(gen, b, t, heads, device=device)
        fn = (lambda: CX.fused_single_query_attention_int8(*args, heads=hl))
        got = fn()
        ref = CX.single_query_attention_int8_plain(*args, heads=hl)
        sync()
        case = {"shape": f"TP {label} head shard B={b} T={t} H={hl}",
                "square_shape": f"B={b} T={t} H={heads}",
                **({"plan": CX.int8_plan(t, hl, b, CX._fit_int8(got.device))}
                   if cuda else {}),
                **check_rel(f"K6 TP {label}", got, ref, INT8_ATT_MAX,
                            INT8_ATT_L2),
                **bound(nbytes(args[0], got) + 2 * b * t * hl * (64 + 4),
                        int8=4 * b * t * hl * 64)}
        timed(case, fn, lambda: CX.single_query_attention_int8_plain(
            *args, heads=hl), lambda: CX.fused_single_query_attention_int8(
            *sq, heads=heads))
        k6["cases"].append(case)
        phase("tp", kernel="K6", card=card,
              tol={"max": INT8_ATT_MAX, "l2": INT8_ATT_L2}, **case)
        args = k7_inputs(gen, b, t, hl, device=device)
        sq = k7_inputs(gen, b, t, heads, device=device)
        fn = (lambda: CA.int8_cached_attention(*args))
        got = fn()
        ref = CA.int8_cached_attention_plain(*args)
        sync()
        case = {"shape": f"TP {label} head shard B={b} T={t} H={hl}",
                "square_shape": f"B={b} T={t} H={heads}",
                **({"plan": CA.cluster_plan(t, None, b * hl,
                                            CA._fit(got.device))}
                   if cuda else {}),
                **check_rel(f"K7 TP {label}", got, ref, INT8_ATT_MAX,
                            INT8_ATT_L2),
                **bound(nbytes(*args, got), int8=4 * b * t * hl * 64)}
        timed(case, fn, lambda: CA.int8_cached_attention_plain(*args),
              lambda: CA.int8_cached_attention(*sq))
        k7["cases"].append(case)
        phase("tp", kernel="K7", card=card,
              tol={"max": INT8_ATT_MAX, "l2": INT8_ATT_L2}, **case)
        del args, sq, got, ref
    if cuda:
        torch.cuda.empty_cache()
    return [k9p, k10p]


def tp_phase(card: str, clips, k1: dict, k2: dict, dec: list,
             int8k: list | None = None) -> tuple[dict, list]:
    """[tp]: tp_kernel_phase (with ``int8k``, the encoder variants'
    partial forms and K5 / K6 / K7 at shard shapes too), then
    mesh_ingest_check with a model axis of TP_MP over the card named
    TP_MP times (dp, mp) = (1, TP_MP) and, for the paths that name it,
    2 x TP_MP times (2, TP_MP), under each TP_PATHS config, on the 25 s
    clip, against the unsplit engine of that config (built once a
    config). Returns each split ingest's launch counts and the K9p /
    K10p entries of the kernels line."""
    from multimodal_audio_search_tpu_torch import runtime
    t0 = time.perf_counter()
    parts = tp_kernel_phase(card, torch.Generator().manual_seed(18), k1, k2,
                            dec, int8k=int8k)
    marks = {"kernels": time.perf_counter() - t0}
    cuda = torch.device("cuda", 0)
    out = {}
    for label, profile, fused, int8, enc, dps in TP_PATHS:
        cfg = tp_config(label, profile, fused, int8, enc)
        whole = None
        for dp in dps:
            whole = mesh_ingest_check(card, dict(clips)["short.wav"], cfg,
                                      [cuda] * (dp * TP_MP), mp=TP_MP,
                                      whole=whole)
            out[f"{label} ({dp}, {TP_MP})"] = whole["launches"]
        del whole
        torch.cuda.empty_cache()
        marks[label] = time.perf_counter() - t0
    phase("tp", card=card, step="summary", launches=out,
          kernels_ready_on=runtime.ready_devices(), seconds_after=marks,
          seconds=time.perf_counter() - t0)
    return out, parts


# [train] (ROADMAP A14): training on the card. A training step runs plain
# PyTorch under autograd and launches no kernel (the counts over every
# part's steps must stay 0; a kernel wrapper refuses an input that
# requires grad); the trained synthetic captioner is then transcribed
# through the serving pipeline, whose K1 and K2 it runs.
TRAIN_PRESET = "tiny"      # whisper-tiny, the shipped captioner's width
TRAIN_STEPS = 600          # the synthetic captioner's step budget
TRAIN_B = 16
TRAIN_HELD_OUT = 16
TRAIN_AGREE_MIN = 15       # of 16 held-out clips: the K1 route = plain
TRAIN_PROD_STEPS = 10      # production geometry (30 s mel, T=1500), timed
TRAIN_CPU_LOSS_RTOL = 1e-5   # the card's B=2 step against the CPU's
TRAIN_CPU_GRAD_REL = 1e-4    # a gradient leaf, of its largest |value|
# after training, a leaf whose largest gradient is under this share of
# the tree's largest (cross-attention q, its LN: 2e-7-3e-6 of it after 10
# steps) is held at TRAIN_CPU_GRAD_REL of this share of the tree's
# largest instead of its own: its gradient is a residue of cancelling
# terms, whose float32 rounding alone (the CPU's 1 thread against 8)
# reaches 1e-4 of it (tools/torch_train_noise.py)
TRAIN_LEAF_FLOOR = 1e-4
TRAIN_SPLIT_REL = 1e-5     # the (2, 1) step against the unsplit one
# the same on the trained captioner, whose loss is ~0.04: its gradients
# are residues of cancelling terms and the split's summation order moves
# them by up to ~2e-5 of a leaf (tools/torch_train_noise.py)
TRAIN_SPLIT_TRAINED_REL = 1e-4
TRAIN_CKPT_K = 5           # save at k, resume, continue to 2k
TRAIN_CKPT_REL = 1e-6      # resumed against uninterrupted, of each leaf
TRAIN_CLAP_STEPS = 30
TRAIN_CLAP_B = 32
TRAIN_CLAP_LR = 1e-3
TRAIN_BRIDGE_N = 4096
# the model axis (ROADMAP A14b), one card named twice (four times for
# (2, 2)): timed (1, 2) steps at the shipped geometry beside as many
# unsplit ones, and the synthetic captioner's steps at (1, 2)
TRAIN_TP_STEPS = 4
TRAIN_TP_SYNTH_STEPS = 100
TRAIN_TP_SYNTH_LR = 3e-4     # training/synth.py's default


def _flat(tree) -> dict:
    from multimodal_audio_search_tpu_torch.utils.tree import (
        path_str, tree_leaves_with_path)
    return {path_str(p): x for p, x in tree_leaves_with_path(tree)}


def leaves_rel_err(got, want, floor: float = 0.0) -> tuple[float, int]:
    """The largest, over the leaves of ``want``, of max |got - want| over
    the leaf's max |want| or, with ``floor``, over max(the leaf's max,
    floor x the tree's largest |want|). Returns it and the count of
    leaves held at the floor."""
    g_, w_ = _flat(got), _flat(want)
    w_top = max(float(w.float().abs().max()) for w in w_.values())
    worst, floored = 0.0, 0
    for k, w in w_.items():
        d = (g_[k].float().to(w.device) - w.float()).abs()
        scale = float(w.float().abs().max())
        if scale < floor * w_top:
            scale, floored = floor * w_top, floored + 1
        worst = max(worst, float(d.max()) / max(scale, 1e-30))
    return worst, floored


def _launched() -> dict:
    from multimodal_audio_search_tpu_torch import runtime
    return {k: v for k, v in runtime.COUNTS.items() if v}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(device) -> int | None:
    return torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else None


def _tf32() -> dict:
    return {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}


def train_synth_check(card: str, device="cuda"):
    """Part 1: the synthetic captioner at whisper-tiny width (1 s clips,
    2 s mel context, B=16, warmup_cosine, float32) for TRAIN_STEPS steps;
    its loss must fall more than 2x (first 10 steps' mean against the
    last 10's). Then 16 held-out clips transcribed through the serving
    pipeline with fused_encoder=None (K1 + K2) and False (the plain
    encoder at T=100, K2): every text from the grammar, the routes
    agreeing on TRAIN_AGREE_MIN clips."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.training import synth as S
    runtime.reset_counts()
    _reset_peak(device)
    _sync(device)
    t0 = time.perf_counter()
    m = S.train_synth_captioner(steps=TRAIN_STEPS, batch=TRAIN_B,
                                clip_seconds=1.0, mel_seconds=2.0,
                                preset=TRAIN_PRESET, seed=0, device=device)
    _sync(device)
    secs = time.perf_counter() - t0
    launched = _launched()
    first, last = float(np.mean(m.losses[:10])), float(np.mean(m.losses[-10:]))
    phase("train", card=card, step="synth", preset=TRAIN_PRESET, batch=TRAIN_B,
          steps=TRAIN_STEPS, clip_seconds=1.0, mel_seconds=2.0,
          schedule="warmup_cosine", dtype="float32", tf32=_tf32(),
          seconds=secs, steps_per_s=TRAIN_STEPS / secs,
          peak_bytes=_peak(device),
          loss_first10=first, loss_last10=last, fall=first / last,
          losses_every_50=m.losses[::50], launches=launched)
    assert not launched, f"a training step launched kernels: {launched}"
    assert first > 2 * last, (
        f"whisper-tiny did not learn the grammar in {TRAIN_STEPS} steps: "
        f"loss {first:.4f} -> {last:.4f} (fall {first / last:.2f}x)")
    rng = np.random.default_rng(99)
    waves, truth = zip(*(S.make_clip(rng) for _ in range(TRAIN_HELD_OUT)))
    waves = np.stack(waves)
    routes = {}
    for label, fused in (("k1", None), ("plain", False)):
        runtime.reset_counts()
        routes[label] = (S.transcribe(m, waves, fused_encoder=fused),
                         _launched())
    (k1, k1_n), (plain, plain_n) = routes["k1"], routes["plain"]
    words = set(S.SynthVocab.WORDS)
    outside = [t for t in k1 + plain if not set(t.split()) <= words]
    agree = sum(a == b for a, b in zip(k1, plain))
    phase("train", card=card, step="transcribe", clips=TRAIN_HELD_OUT,
          dtype=str(runtime.default_dtype(torch.device(device))),
          launches_k1_route=k1_n,
          launches_plain_route=plain_n, agree=agree,
          exact_k1=sum(a == b for a, b in zip(k1, truth)),
          exact_plain=sum(a == b for a, b in zip(plain, truth)),
          outside_grammar=len(outside), empty=sum(not t for t in k1),
          texts=list(zip(truth, k1))[:6])
    if torch.device(device).type == "cuda":      # the CPU runs the twins
        assert k1_n.get(KEYS["K1"], 0) > 0 and \
            k1_n.get(KEYS["K2"], 0) > 0, k1_n
        assert plain_n.get(KEYS["K1"], 0) == 0 and \
            plain_n.get(KEYS["K2"], 0) > 0, plain_n
    assert not outside, f"transcripts outside the grammar: {outside[:4]}"
    assert any(k1), "every transcript empty"
    assert agree >= TRAIN_AGREE_MIN, (agree, list(zip(k1, plain)))
    return m


def _synth_batches(n: int, b: int, clip_s: float, mel_s: float, events,
                   seed: int, device="cuda") -> list[dict]:
    """``n`` synthetic batches of ``b`` clips with their log-mel made on
    the card and brought to the host (as a data loader hands them over)."""
    from multimodal_audio_search_tpu_torch.config import MelConfig
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram
    from multimodal_audio_search_tpu_torch.training import synth as S
    cfg = W.PRESETS[TRAIN_PRESET]
    mel_cfg = MelConfig(padded_seconds=mel_s)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        waves, tokens, mask = S.synth_batch(rng, b, cfg, S.SynthVocab(cfg),
                                            clip_s, mel_cfg.n_samples,
                                            events)
        with torch.no_grad():
            mel = log_mel_spectrogram(torch.as_tensor(waves).to(device),
                                      mel_cfg)
        out.append({"mel": mel.cpu().numpy(), "tokens": tokens,
                    "loss_mask": mask})
    return out


def train_production_check(card: str, device="cuda") -> None:
    """Part 2: whisper-tiny at the shipped geometry (10 s clips of 2-6
    events, 30 s mel, T=1500), B=16: TRAIN_PROD_STEPS steps timed (step
    ms, audio-seconds trained a second); one step at B=2 held to the same
    step on the CPU (TF32 off) at the initial parameters (every leaf at
    TRAIN_CPU_GRAD_REL of its max) and at the trained ones (the same, a
    leaf under TRAIN_LEAF_FLOOR of the tree's largest held at the
    floor)."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.training import finetune as FT
    from multimodal_audio_search_tpu_torch import runtime
    cfg = W.PRESETS[TRAIN_PRESET]
    host = W.init_params(torch.Generator().manual_seed(0), cfg)
    params = _to(host, device)
    step, opt = FT.make_train_step(cfg, FT.TrainConfig(
        learning_rate=3e-4, schedule="warmup_cosine", warmup_steps=2,
        total_steps=TRAIN_PROD_STEPS, weight_decay=0.0))
    state = opt.init(params)
    batches = _synth_batches(TRAIN_PROD_STEPS, TRAIN_B, 10.0, 30.0, (2, 6),
                             7, device)
    runtime.reset_counts()
    _reset_peak(device)
    times, losses = [], []
    for b in batches:
        _sync(device)
        t = time.perf_counter()
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t)
    launched = _launched()
    step_s = float(np.median(times[1:]))
    b2 = _synth_batches(1, 2, 10.0, 30.0, (2, 6), 8, device)[0]
    cpu = {}
    for label, tree, floor in (("init", host, 0.0),
                               ("trained", params, TRAIN_LEAF_FLOOR)):
        lc, gc = FT.loss_and_grads(_to(tree, device), b2, cfg)
        lh, gh = FT.loss_and_grads(_to(tree, "cpu"), b2, cfg)
        gc = _to(gc, "cpu")
        floored, n_floored = leaves_rel_err(gc, gh, floor=floor)
        # at the floor a leaf's own rounding hides under the tree's
        # scale: the trained check is a sanity check, not parity
        cpu[label] = {
            "check": "sanity" if n_floored else "parity",
            "loss_rel": abs(float(lc) - float(lh)) / abs(float(lh)),
            "grad_rel": leaves_rel_err(gc, gh)[0],
            "grad_rel_floored": floored, "leaves_at_floor": n_floored,
            "leaves": len(_flat(gh))}
    phase("train", card=card, step="production", preset=TRAIN_PRESET,
          batch=TRAIN_B, clip_seconds=10.0, mel_seconds=30.0,
          encoder_T=1500, steps=TRAIN_PROD_STEPS, tf32=_tf32(),
          step_ms=step_s * 1e3, first_step_ms=times[0] * 1e3,
          audio_s_per_s=TRAIN_B * 10.0 / step_s,
          peak_bytes=_peak(device), losses=losses,
          launches=launched, cpu_check_batch=2, cpu_check=cpu)
    assert not launched, f"a training step launched kernels: {launched}"
    for label, c in cpu.items():
        assert c["loss_rel"] <= TRAIN_CPU_LOSS_RTOL, (label, c)
        assert c["grad_rel_floored"] <= TRAIN_CPU_GRAD_REL, (label, c)


def _to(tree, device):
    from multimodal_audio_search_tpu_torch.utils.tree import tree_map
    return tree_map(lambda x: x.to(device), tree)


def train_split_check(card: str, trained, device="cuda") -> None:
    """Part 3: the data axis, the card named twice: the (2, 1) step (each
    chunk's sum of nll over the whole batch's mask count, the chunks'
    gradients summed in rank order) against the unsplit step on a B=16
    batch of the 2 s geometry (the halves' mask counts differ): the loss
    and every gradient leaf within TRAIN_SPLIT_REL of each leaf's max at
    fresh parameters, and within TRAIN_SPLIT_TRAINED_REL at the trained
    captioner's ``trained``. (The optimizer then runs on the first device
    alone, the same code either way; after one AdamW step from a fresh
    state each entry moves by lr x g / (|g| + eps), about its sign, so
    the parameters would repeat this comparison but for entries whose
    sign lies within rounding.)"""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.parallel.mesh import make_mesh
    from multimodal_audio_search_tpu_torch.training import finetune as FT
    from multimodal_audio_search_tpu_torch import runtime
    cfg = W.PRESETS[TRAIN_PRESET]
    cuda = torch.device(device)
    b = _synth_batches(1, TRAIN_B, 1.0, 2.0, (1, 3), 9, device)[0]
    fresh = _to(W.init_params(torch.Generator().manual_seed(2), cfg), device)
    runtime.reset_counts()
    out = {}
    for label, params, bar in (("fresh", fresh, TRAIN_SPLIT_REL),
                               ("trained", trained, TRAIN_SPLIT_TRAINED_REL)):
        l1, g1 = FT.loss_and_grads(params, b, cfg)
        l2, g2 = FT.loss_and_grads(params, b, cfg,
                                   mesh=make_mesh(2, devices=[cuda] * 2))
        out[label] = {"bar": bar, "loss": float(l1),
                      "loss_rel": abs(float(l2) - float(l1)) / abs(float(l1)),
                      "grad_rel": leaves_rel_err(g2, g1)[0]}
    launched = _launched()
    half = TRAIN_B // 2
    phase("train", card=card, step="data_axis", mesh=(2, 1),
          mask_counts=[float(b["loss_mask"][:half].sum()),
                       float(b["loss_mask"][half:].sum())],
          checks=out, launches=launched)
    assert not launched, launched
    for label, c in out.items():
        for name in ("loss_rel", "grad_rel"):
            assert c[name] <= c["bar"], (label, name, c)


def _tp_mesh(shape, device):
    """A (data, model) mesh of ``shape`` naming ``device`` once a
    position."""
    from multimodal_audio_search_tpu_torch.parallel.mesh import make_mesh
    n = shape[0] * shape[1]
    return make_mesh(n, model_parallel=shape[1],
                     devices=[torch.device(device)] * n)


def _ranks(params, shape, heads: int, device):
    """The TP training state's parameters: the first data row's rank
    trees (parallel/mesh.py::shard_heads)."""
    from multimodal_audio_search_tpu_torch.parallel.mesh import shard_heads
    return shard_heads(params, _tp_mesh((1, shape[1]), device), heads)[0]


def _tp_steps_check(card: str, cfg, device) -> dict:
    """The shipped geometry (10 s clips of 2-6 events, 30 s mel, T=1500),
    B=TRAIN_B, float32, TF32 off: one (1, 2) and one (2, 2) step against
    the unsplit step at the same fresh parameters (the loss and every
    gradient leaf within TRAIN_SPLIT_REL of the leaf's max), then
    TRAIN_TP_STEPS timed steps each of the unsplit and the (1, 2) step
    after one untimed, with the card's peak memory of each and the bytes
    of parameters and Adam moments each rank holds."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.parallel.mesh import gather_heads
    from multimodal_audio_search_tpu_torch.training import finetune as FT
    fresh = _to(W.init_params(torch.Generator().manual_seed(2), cfg), device)
    batches = _synth_batches(TRAIN_TP_STEPS + 1, TRAIN_B, 10.0, 30.0,
                             (2, 6), 13, device)
    l1, g1 = FT.loss_and_grads(fresh, batches[0], cfg)
    checks = {}
    for shape in ((1, 2), (2, 2)):
        l2, g2 = FT.loss_and_grads(_ranks(fresh, shape, cfg.heads, device),
                                   batches[0], cfg,
                                   mesh=_tp_mesh(shape, device))
        checks[str(shape)] = {
            "loss_rel": abs(float(l2) - float(l1)) / abs(float(l1)),
            "grad_rel": leaves_rel_err(gather_heads(g2), g1)[0]}
    del g1, g2
    tcfg = FT.TrainConfig(learning_rate=3e-4)
    timed = {}
    for label, params, mesh in (
            ("unsplit", fresh, None),
            ("(1, 2)", _ranks(fresh, (1, 2), cfg.heads, device),
             _tp_mesh((1, 2), device))):
        step, opt = FT.make_train_step(cfg, tcfg, mesh=mesh)
        state = opt.init(params) if mesh is None else opt.init_ranks(params)
        _reset_peak(device)
        times = []
        for b in batches:
            _sync(device)
            t = time.perf_counter()
            params, state, met = step(params, state, b)
            float(met["loss"])
            times.append(time.perf_counter() - t)
        timed[label] = {
            "step_ms": float(np.median(times[1:])) * 1e3,
            "steps_ms": [x * 1e3 for x in times], "peak_bytes": _peak(device),
            "state_bytes_per_rank": [
                tree_bytes(p) + tree_bytes(s[1][0].mu) + tree_bytes(s[1][0].nu)
                for p, s in (zip(params, state) if mesh is not None
                             else [(params, state)])]}
    return {"checks": checks, "timed": timed}


def _tp_synth_check(card: str, device) -> dict:
    """The synthetic captioner at whisper-tiny width trained at (1, 2)
    (training/synth.py with ``mesh``: 1 s clips, 2 s mel, B=TRAIN_B,
    warmup_cosine, lr TRAIN_TP_SYNTH_LR, float32) for TRAIN_TP_SYNTH_STEPS
    steps, its loss falling more than 2x (the first 10 steps' mean
    against the last 10's); then TRAIN_HELD_OUT held-out clips
    transcribed through the TP pipeline (model_parallel=2,
    fused_encoder=None: K1p and K2 on head shards), its launches equal
    to split_expected, every text from the grammar, beside the unsplit
    pipeline's transcripts of the gathered model."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.training import synth as S
    mesh = _tp_mesh((1, 2), device)
    runtime.reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    m = S.train_synth_captioner(steps=TRAIN_TP_SYNTH_STEPS, batch=TRAIN_B,
                                clip_seconds=1.0, mel_seconds=2.0,
                                preset=TRAIN_PRESET, seed=0,
                                lr=TRAIN_TP_SYNTH_LR, mesh=mesh)
    _sync(device)
    secs = time.perf_counter() - t0
    launched = _launched()
    first, last = float(np.mean(m.losses[:10])), float(np.mean(m.losses[-10:]))
    rng = np.random.default_rng(99)
    waves, truth = zip(*(S.make_clip(rng) for _ in range(TRAIN_HELD_OUT)))
    pipe = S.synth_pipeline(m, fused_encoder=None, mesh=mesh)
    runtime.reset_counts()
    texts = pipe.transcribe_batch(S.pad_waves(waves, pipe.mel_cfg.n_samples))
    tp_n = _launched()
    want = split_expected(False, (pipe.last_steps, 0), (pipe.dispatches, 0),
                          pipe, pipe)
    want = {KEYS[k]: n for k, n in want.items() if n}
    whole = S.transcribe(m, waves, fused_encoder=None)
    words = set(S.SynthVocab.WORDS)
    outside = [t for t in texts if not set(t.split()) <= words]
    out = {"steps": TRAIN_TP_SYNTH_STEPS, "seconds": secs,
           "step_ms": secs / TRAIN_TP_SYNTH_STEPS * 1e3,
           "loss_first10": first, "loss_last10": last, "fall": first / last,
           "losses_every_10": m.losses[::10], "launches": launched,
           "model_parallel": pipe.model_parallel,
           "decode_steps": pipe.last_steps, "launches_tp_pipeline": tp_n,
           "expected": want, "agree_unsplit": sum(
               a == b for a, b in zip(texts, whole)),
           "exact": sum(a == b for a, b in zip(texts, truth)),
           "outside_grammar": len(outside), "texts": list(zip(truth,
                                                              texts))[:4]}
    assert not launched, f"a TP training step launched kernels: {launched}"
    assert first > 2 * last, (first, last)
    assert pipe.model_parallel == 2, pipe.model_parallel
    if torch.device(device).type == "cuda":      # the CPU runs the twins
        assert tp_n == want, (tp_n, want)
    assert not outside, f"transcripts outside the grammar: {outside[:4]}"
    assert any(texts), "every transcript empty"
    return out


def _tp_checkpoint_check(card: str, device) -> dict:
    """finetune_captioner at (1, 2) saves at step TRAIN_CKPT_K, a second
    run resumes from it and continues to 2k, against an uninterrupted
    (1, 2) run of 2k steps (deterministic algorithms on, warn_only): the
    losses and parameters within TRAIN_CKPT_REL of each leaf's max. The
    checkpoint holds whole leaves under the unsplit run's keys and loads
    at mp = 1 equal to the gathered ranks, bit for bit."""
    import tempfile
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.training import finetune as FT
    from multimodal_audio_search_tpu_torch.training.loop import (
        finetune_captioner)
    from multimodal_audio_search_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)
    cfg = W.PRESETS[TRAIN_PRESET]
    k = TRAIN_CKPT_K
    batches = _synth_batches(2 * k, TRAIN_B, 1.0, 2.0, (1, 3), 14, device)
    init = W.init_params(torch.Generator().manual_seed(1), cfg)
    tcfg = FT.TrainConfig(learning_rate=3e-4)
    kw = dict(init_params=init, model_parallel=2, log_fn=lambda s: None,
              devices=[torch.device(device)] * 2)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as d:
            whole = finetune_captioner(batches, cfg, tcfg, **kw)
            finetune_captioner(batches[:k], cfg, tcfg,
                               checkpoint_dir=f"{d}/b", **kw)
            logs = []
            resumed = finetune_captioner(batches[k:], cfg, tcfg,
                                         checkpoint_dir=f"{d}/b",
                                         **{**kw, "log_fn": logs.append})
            template = _to(init, device)
            _, opt = FT.make_train_step(cfg, tcfg)
            one, one_state, meta = TrainCheckpointer(f"{d}/b").restore(
                template, opt.init(template))
            keys = sorted(np.load(f"{d}/b/step_{2 * k:08d}.opt.npz").files)
    finally:
        torch.use_deterministic_algorithms(was)
    rel, _ = leaves_rel_err(resumed.params, whole.params)
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(resumed.losses, whole.losses[k:]))
    ranks_equal = all(torch.equal(a, b) for a, b in zip(
        _flat(resumed.params).values(), _flat(one).values()))
    out = {"k": k, "steps": 2 * k, "resumed_log": logs[:1],
           "param_rel": rel, "loss_rel": loss_rel,
           "loads_at_mp1_equal": ranks_equal, "mp1_step": meta["step"],
           "keys": len(keys), "state_keys_as_unsplit": keys == sorted(
               _flat(opt.init(template)).keys())}
    assert logs[:1] == [f"resumed from step {k}"], logs
    assert resumed.steps == whole.steps == 2 * k
    assert rel <= TRAIN_CKPT_REL and loss_rel <= TRAIN_CKPT_REL, out
    assert ranks_equal and out["state_keys_as_unsplit"], out
    return out


def _tp_clap_check(card: str, device) -> dict:
    """The CLAP recipe at published widths (ClapConfig(), MiniLM L6) at
    (1, 2), B=TRAIN_CLAP_B, TRAIN_CLAP_STEPS steps on 32 fixed pairs, as
    train_clap_check: the in-batch accuracy must rise; step ms."""
    from multimodal_audio_search_tpu_torch.models.clap import ClapConfig
    from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
    from multimodal_audio_search_tpu_torch.training import clap as TC
    from multimodal_audio_search_tpu_torch.training.loop import place_params
    acfg, tcfg = ClapConfig(), PRESETS["L6"]
    rng = np.random.default_rng(11)
    batch = {"mel": rng.normal(size=(TRAIN_CLAP_B, acfg.n_mels, 1000))
             .astype(np.float32),
             "input_ids": rng.integers(100, tcfg.vocab_size,
                                       size=(TRAIN_CLAP_B, 16)),
             "attention_mask": np.ones((TRAIN_CLAP_B, 16), np.int64)}
    mesh = _tp_mesh((1, 2), device)
    params = place_params(TC.init_clap_params(
        torch.Generator().manual_seed(0), acfg, tcfg), mesh, (acfg, tcfg),
        print, "train_clap")
    step, opt = TC.make_clap_train_step(
        acfg, tcfg, TC.ClapTrainConfig(learning_rate=TRAIN_CLAP_LR),
        mesh=mesh)
    state = opt.init_ranks(params)
    accs, losses, times = [], [], []
    for _ in range(TRAIN_CLAP_STEPS):
        _sync(device)
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t)
        accs.append(float(m["in_batch_acc"]))
    out = {"ranks": len(params), "step_ms": float(np.median(times[1:])) * 1e3,
           "acc_first": accs[0], "acc_last": accs[-1],
           "loss_first": losses[0], "loss_last": losses[-1]}
    assert accs[-1] > accs[0], (accs, losses)
    return out


def train_tp_check(card: str, device="cuda") -> None:
    """Part 4: the mesh's model axis (ROADMAP A14b) on one card named
    twice (four times for (2, 2)): _tp_steps_check (whisper-tiny at the
    shipped geometry, the (1, 2) and (2, 2) steps against the unsplit one,
    timed (1, 2) steps beside unsplit ones, peak memory and each rank's
    state bytes), _tp_synth_check (the synthetic captioner trained at
    (1, 2) and transcribed through the TP pipeline), _tp_checkpoint_check
    (save at k, resume, continue to 2k; the checkpoint at mp = 1) and
    _tp_clap_check (CLAP at published widths at (1, 2)). Every training
    step of the part launches no kernel."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.models import whisper as W
    cfg = W.PRESETS[TRAIN_PRESET]
    t0 = time.perf_counter()
    marks = {}
    runtime.reset_counts()
    steps = _tp_steps_check(card, cfg, device)
    launched = _launched()
    phase("train", card=card, step="tp_steps", preset=TRAIN_PRESET,
          batch=TRAIN_B, mel_seconds=30.0, encoder_T=1500, dtype="float32",
          tf32=_tf32(), bar=TRAIN_SPLIT_REL, launches=launched, **steps)
    assert not launched, f"a TP training step launched kernels: {launched}"
    for shape, c in steps["checks"].items():
        for name in ("loss_rel", "grad_rel"):
            assert c[name] <= TRAIN_SPLIT_REL, (shape, name, c)
    marks["steps"] = time.perf_counter() - t0
    synth = _tp_synth_check(card, device)
    phase("train", card=card, step="tp_synth", **synth)
    marks["synth"] = time.perf_counter() - t0
    runtime.reset_counts()
    ckpt = _tp_checkpoint_check(card, device)
    clap = _tp_clap_check(card, device)
    launched = _launched()
    phase("train", card=card, step="tp_checkpoint_clap", checkpoint=ckpt,
          clap=clap, launches=launched)
    assert not launched, f"a TP training step launched kernels: {launched}"
    marks["checkpoint_clap"] = time.perf_counter() - t0
    phase("train", card=card, step="tp_summary", seconds_after=marks,
          seconds=time.perf_counter() - t0)


def train_checkpoint_check(card: str, device="cuda") -> None:
    """Part 5: finetune_captioner saves at step k, a second run resumes
    from it and continues to 2k on the same batches, against an
    uninterrupted run of 2k steps (torch.use_deterministic_algorithms on,
    warn_only: cuBLAS on one stream): losses and parameters within
    TRAIN_CKPT_REL of each leaf's max; then a bfloat16 tree round-trips
    through save_pytree / load_pytree as bfloat16."""
    import tempfile
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.training import finetune as FT
    from multimodal_audio_search_tpu_torch.training.loop import (
        finetune_captioner)
    from multimodal_audio_search_tpu_torch.utils.checkpoint import (
        load_pytree, save_pytree)
    cfg = W.PRESETS[TRAIN_PRESET]
    k = TRAIN_CKPT_K
    batches = _synth_batches(2 * k, TRAIN_B, 1.0, 2.0, (1, 3), 10,
                             device)
    init = W.init_params(torch.Generator().manual_seed(1), cfg)
    tcfg = FT.TrainConfig(learning_rate=3e-4)
    kw = dict(init_params=init, n_devices=1, device=device,
              log_fn=lambda s: None)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as d:
            whole = finetune_captioner(batches, cfg, tcfg, **kw)
            finetune_captioner(batches[:k], cfg, tcfg,
                               checkpoint_dir=f"{d}/b", **kw)
            logs = []
            resumed = finetune_captioner(batches[k:], cfg, tcfg,
                                         checkpoint_dir=f"{d}/b",
                                         **{**kw, "log_fn": logs.append})
            ckpt_bytes = sum(os.path.getsize(os.path.join(f"{d}/b", f))
                             for f in os.listdir(f"{d}/b"))
            bf = _to(whole.params, torch.bfloat16)
            save_pytree(bf, f"{d}/bf16.npz")
            back = load_pytree(bf, f"{d}/bf16.npz")
    finally:
        torch.use_deterministic_algorithms(was)
    rel, _ = leaves_rel_err(resumed.params, whole.params)
    bitwise = all(torch.equal(a, b) for a, b in zip(
        _flat(resumed.params).values(), _flat(whole.params).values()))
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(resumed.losses, whole.losses[k:]))
    bf_ok = all(a.dtype == torch.bfloat16 and torch.equal(a, b)
                for a, b in zip(_flat(back).values(), _flat(bf).values()))
    phase("train", card=card, step="checkpoint", k=k, steps=2 * k,
          resumed_log=logs[:1], deterministic="use_deterministic_algorithms"
          "(True, warn_only=True)", param_rel=rel, bitwise_equal=bitwise,
          loss_rel=loss_rel, checkpoint_bytes=ckpt_bytes,
          bf16_round_trip=bf_ok)
    assert logs[:1] == [f"resumed from step {k}"], logs
    assert resumed.steps == whole.steps == 2 * k
    assert rel <= TRAIN_CKPT_REL and loss_rel <= TRAIN_CKPT_REL, \
        (rel, loss_rel)
    assert bf_ok


def train_clap_check(card: str, device="cuda") -> None:
    """Part 6: the CLAP recipe at published widths (ClapConfig(), MiniLM
    L6), B=32, TRAIN_CLAP_STEPS steps on 32 fixed pairs (10 s mels,
    16-token captions): the in-batch accuracy must rise; step ms."""
    from multimodal_audio_search_tpu_torch.models.clap import ClapConfig
    from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
    from multimodal_audio_search_tpu_torch.training import clap as TC
    acfg, tcfg = ClapConfig(), PRESETS["L6"]
    rng = np.random.default_rng(11)
    batch = {"mel": rng.normal(size=(TRAIN_CLAP_B, acfg.n_mels, 1000))
             .astype(np.float32),
             "input_ids": rng.integers(100, tcfg.vocab_size,
                                       size=(TRAIN_CLAP_B, 16)),
             "attention_mask": np.ones((TRAIN_CLAP_B, 16), np.int64)}
    params = _to(TC.init_clap_params(torch.Generator().manual_seed(0), acfg,
                                     tcfg), device)
    step, opt = TC.make_clap_train_step(
        acfg, tcfg, TC.ClapTrainConfig(learning_rate=TRAIN_CLAP_LR))
    state = opt.init(params)
    from multimodal_audio_search_tpu_torch import runtime
    runtime.reset_counts()
    _reset_peak(device)
    accs, losses, times = [], [], []
    for _ in range(TRAIN_CLAP_STEPS):
        _sync(device)
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t)
        accs.append(float(m["in_batch_acc"]))
    launched = _launched()
    phase("train", card=card, step="clap", audio="ClapConfig()",
          text="MiniLM L6", batch=TRAIN_CLAP_B, steps=TRAIN_CLAP_STEPS,
          lr=TRAIN_CLAP_LR, step_ms=float(np.median(times[1:])) * 1e3,
          peak_bytes=_peak(device),
          acc_first=accs[0], acc_last=accs[-1], loss_first=losses[0],
          loss_last=losses[-1], temperature=float(m["temperature"]),
          launches=launched)
    assert not launched, launched
    assert accs[-1] > accs[0], (accs, losses)


def train_bridge_check(card: str, device="cuda") -> None:
    """Part 7: train_bridge on TRAIN_BRIDGE_N features of 128 dimensions
    whose targets are a fixed random map of them into 384-D unit vectors,
    for the reference's 50 epochs (batch 64, Adam 1e-3, dropout 0.2):
    the loss must fall; seconds."""
    from multimodal_audio_search_tpu_torch.training import bridge as TB
    rng = np.random.default_rng(12)
    feats = (rng.normal(size=(TRAIN_BRIDGE_N, 128)) * 2 + 0.5) \
        .astype(np.float32)
    tgt = np.tanh(feats @ rng.normal(size=(128, 384)) / np.sqrt(128))
    tgt = (tgt / np.linalg.norm(tgt, axis=-1, keepdims=True)) \
        .astype(np.float32)
    from multimodal_audio_search_tpu_torch import runtime
    runtime.reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    _, losses = TB.train_bridge(feats, tgt, epochs=50, seed=0,
                                device=device)
    _sync(device)
    secs = time.perf_counter() - t0
    launched = _launched()
    phase("train", card=card, step="bridge", n=TRAIN_BRIDGE_N, epochs=50,
          seconds=secs, steps=50 * TRAIN_BRIDGE_N // 64,
          loss_first=losses[0], loss_last=losses[-1], launches=launched)
    assert not launched, launched
    assert losses[-1] < losses[0], losses


DRIFT_CLIPS = 64
DRIFT_SEED = 7             # the held-out clips' own generator
# each lever row's exact agreement with the row of its dtype (bf16 on the
# card, where the levers' kernels take bf16; parity on the CPU): a lever
# kernel that goes wrong at the drift shapes (T=100, 100 cross keys) and
# still yields texts in the grammar shows here. Every lever read 1.000 on
# the H100 (PERF.md §6)
DRIFT_LEVER_AGREE = 0.9
# K2's and K8's float32 forms against their plain versions: the same
# float32 products and sums in another order (K2's splits, K8's online
# softmax) and the kernels' expf against torch's exp
F32_ATT_ATOL, F32_ATT_RTOL = 2e-5, 2e-5
DRIFT_BIG_N = 100_000
DRIFT_BIG_QUERIES = 50
# recall@10 against the float32 index, below the CPU run's at 20k rows
# (bf16 0.994, int8 0.986; PERF.md §6)
DRIFT_RECALL_FLOOR = {"bfloat16": 0.97, "int8": 0.95}
# the kernels each lever row of tools/torch_synth_drift.py must launch
DRIFT_LEVERS = {"fused_enc": ("K1",), "fused_enc_f32": ("K1",),
                "int8_enc": ("K9",),
                "paired": ("K10",), "int8_dec": ("K5",),
                "int8_fused": ("K5", "K6"), "int8_kv": ("K5", "K7"),
                "fused_layer": ("K3", "K4"), "v2": ("K3-q", "K4-o"),
                "fused_layer_f32": ("K3", "K4"),
                "v2_f32": ("K3-q", "K4-o"), "int8_dec_f32": ("K5",),
                "int8_fused_f32": ("K5", "K6"), "int8_kv_f32": ("K5", "K7")}
# the lever rows in float32 on the card, held to the float32 parity row
DRIFT_F32_ROWS = ("fused_enc_f32", "fused_layer_f32", "v2_f32",
                  "int8_dec_f32", "int8_fused_f32", "int8_kv_f32")


def _f32_heads(gen: torch.Generator, b: int, t: int, heads: int):
    """q, k, v ~ N(0, 1) in float32 as the encoder hands them to K8: the
    head-split [B, H, T, 64] views of [B, T, H*64] buffers."""
    return tuple(torch.randn(b, t, heads * 64, generator=gen).cuda()
                 .view(b, t, heads, 64).transpose(1, 2) for _ in range(3))


# [f32]: K1's float32 form against its plain version (the same float32
# products in 3xTF32 and another order, K8's online softmax and expf),
# and a float32 engine's encoder states (6 layers of it, then the MLPs
# and layer norms) against the plain float32 encoder on the card
F32_BLOCK_ATOL, F32_BLOCK_RTOL = 2e-5, 2e-5
F32_ENC_ATOL, F32_ENC_RTOL = 1e-4, 1e-4
F32_REPEATS = 16
# K1 f32's, K2 f32's and K8 f32's cases: the float32 engine's shapes
# (B=32 segments of 30 s, T=1500; whisper-base and -tiny widths)
F32_WIDTHS = (("base", 8), ("tiny", 6))
F32_B, F32_T = 32, 1500


def _f32_block(gen: torch.Generator, b: int, t: int, heads: int):
    """K1's float32 inputs: q, k, v as _f32_heads, x ~ N(0, 1), Wo ~
    N(0, 1/HD), bo ~ N(0, 0.01)."""
    hd = heads * 64
    q, k, v = _f32_heads(gen, b, t, heads)
    x = torch.randn(b, t, hd, generator=gen).cuda()
    wo = (torch.randn(hd, hd, generator=gen) / math.sqrt(hd)).cuda()
    bo = (0.1 * torch.randn(hd, generator=gen)).cuda()
    return q, k, v, x, wo, bo


def f32_kernel_checks(card: str, gen: torch.Generator) -> tuple:
    """The float32 engine's kernels at its shapes, each against its plain
    version: K1's float32 form (with 16 repeats bit-equal, and the
    unfused float32 route K8 f32 + addmm + add beside it), K8's float32
    form (scaled_dot_product_attention on float32 beside it) and K2's
    float32 form over 1500 cross keys and a 64-step self cache. Returns
    the three kernels' entries for the kernels line."""
    from multimodal_audio_search_tpu_torch.ops import attention as A
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    src = "multimodal_audio_search_tpu_torch/csrc/"
    k1 = {"name": "encoder_attn_o_residual_f32", "route": "cuda",
          "source": src + "encoder_block_f32.cu",
          "replaces": "multimodal_audio_search_tpu/ops/encoder_block.py:425",
          "cases": []}
    k8 = {"name": "encoder_attention_f32", "route": "cuda",
          "source": src + "encoder_attention.cu",
          "replaces": "multimodal_audio_search_tpu/ops/attention.py:83",
          "cases": []}
    k2 = {"name": "single_query_attention_f32", "route": "cuda",
          "source": src + "cross_attention.cu",
          "replaces": "multimodal_audio_search_tpu/ops/cross_attention.py:145",
          "cases": []}
    b, t = F32_B, F32_T
    for label, heads in F32_WIDTHS:
        hd = heads * 64
        q, k, v, x, wo, bo = args = _f32_block(gen, b, t, heads)
        fn = (lambda: EB.fused_attention_o_residual(*args))
        plain = (lambda: EB.attention_o_residual_plain(*args))

        def unfused():
            a = A.fused_encoder_attention(q, k, v).transpose(1, 2)
            return x + torch.addmm(bo, a.reshape(-1, hd), wo).view(b, t, hd)
        got = fn()
        torch.cuda.synchronize()
        shape = f"{label} B={b} T={t} H={heads}"
        case = {"shape": shape, "cluster": EB.f32_cluster(heads),
                "max_abs_err": check_close(f"K1 float32 {shape}", got,
                                           plain(), F32_BLOCK_ATOL,
                                           F32_BLOCK_RTOL),
                "unfused_max_abs_err": check_close(
                    f"K8 f32 + addmm {shape}", unfused(), got,
                    F32_BLOCK_ATOL, F32_BLOCK_RTOL),
                "repeats_equal": check_repeats(f"K1 float32 {shape}", fn,
                                               got, F32_REPEATS),
                "ms": time_ms(fn), "plain_ms": time_ms(plain, reps=3),
                "unfused_ms": time_ms(unfused), "library_ms": None,
                **f32_bound(nbytes(*args) + nbytes(got),
                            4 * b * heads * t * t * 64 + 2 * b * t * hd * hd)}
        case["vs_unfused"] = case["ms"] / case["unfused_ms"]
        k1["cases"].append(case)
        phase("f32", card=card, kernel="K1 float32",
              tol=[F32_BLOCK_ATOL, F32_BLOCK_RTOL], **case)
        del got
        fn = (lambda: A.fused_encoder_attention(q, k, v))
        plain = (lambda: A.encoder_attention_plain(q, k, v))
        sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v))
        got = fn()
        case = {"shape": shape,
                "max_abs_err": check_close(f"K8 float32 {shape}", got,
                                           plain(), F32_ATT_ATOL,
                                           F32_ATT_RTOL),
                "ms": time_ms(fn), "plain_ms": time_ms(plain, reps=3),
                "library_ms": time_ms(sdpa),
                **f32_bound(4 * nbytes(q), 4 * b * heads * t * t * 64)}
        case["vs_library"] = case["ms"] / case["library_ms"]
        k8["cases"].append(case)
        phase("f32", card=card, kernel="K8 float32",
              tol=[F32_ATT_ATOL, F32_ATT_RTOL], **case)
        del args, q, k, v, x, wo, bo, got
        torch.cuda.empty_cache()
        for kind, n, pos in (("cross", t, None), ("self", 64, 63)):
            qm, km, vm = (a.float() for a in k2_inputs(gen, b, n, heads))
            fn = (lambda: CX.fused_single_query_attention(
                qm, km, vm, heads=heads, pos=pos))
            plain = (lambda: CX.single_query_attention_plain(
                qm, km, vm, heads=heads, pos=pos))
            keys = n if pos is None else pos + 1
            qh = qm.view(b, 1, heads, 64).transpose(1, 2)
            kh, vh = (a[:, :keys].view(b, keys, heads, 64).transpose(1, 2)
                      for a in (km, vm))
            sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh))
            got = fn()
            case = {"shape": f"{kind} {label} B={b} T={n} H={heads} "
                             f"pos={pos}",
                    "max_abs_err": check_close(
                        f"K2 float32 {kind} {label}", got, plain(),
                        F32_ATT_ATOL, F32_ATT_RTOL),
                    "ms": time_ms(fn), "plain_ms": time_ms(plain),
                    "library_ms": time_ms(sdpa),
                    **f32_bound(nbytes(qm, got) + 2 * b * keys * hd * 4,
                                4 * b * keys * hd)}
            k2["cases"].append(case)
            phase("f32", card=card, kernel="K2 float32",
                  tol=[F32_ATT_ATOL, F32_ATT_RTOL], **case)
    return k1, k2, k8


# [f32]'s decoder blocks: K3's, K3-q's, K4's and K4-o's float32 forms
# (csrc/decoder_block_f32.cu) at the float32 engine's decode shapes, B=32
# segments and a self cache of L=68 rows (64 greedy tokens past the
# 4-token prompt) at every K3_POS, F = 4 D, at F32_WIDTHS; each held to
# its plain version elementwise at F32_BLOCK_ATOL / RTOL (the same float32
# products, summed in another order: x_out, k1 and v1 as written into the
# cache row, q_cross), the other cache rows unwritten, F32_REPEATS more
# launches bit-equal.
F32_DEC_B, F32_DEC_L = 32, 68
# the fast_lossless float32 engine against the [f32] K1 engine (the same
# float32 weights, EngineConfig()'s unfused decode): their logits differ
# by float32 rounding in two summation orders (the CPU test of the fused
# float32 decode against JAX's reads 6e-7 on logits of unit scale), so a
# segment's text may differ only where the plain float32 decode's top-2
# margin, at the first step whose token differs, is under F32_MARGIN_REL
# of that step's largest |logit| (decode_margins)
F32_MARGIN_REL = 1e-4
# the float32 "v2" decode steps against the unfused steps on the same
# batch: max |err| of the logits within F32_STEP_LOGITS_REL of their
# largest |value| (float32 rounding through 6 layers, as above)
F32_STEP_LOGITS_REL = 1e-4


def k3_f32_bound(args, got, pos: int) -> dict:
    """bound() of K3's float32 function (K3-q's with its tail's 4 more
    inputs): its inputs, the cache rows 0..pos-1 read and row pos written
    (K and V), x_out (K3-q: and q_cross); the projections' float32
    operations (4 D x D, K3-q 5) and the attention's two products over
    pos + 1 keys, at the CUDA cores' float32 rate."""
    b, d = args[0].shape
    tail = len(args) > 10
    outs = (got[0], got[3]) if tail else (got[0],)
    return {**bound(nbytes(*args, *outs) + 2 * b * (pos + 1) * d * 4,
                    f32=2 * b * d * d * (5 if tail else 4)
                    + 4 * b * (pos + 1) * d), "bound_rate": "f32"}


def f32_decoder_checks(card: str, gen: torch.Generator) -> list[dict]:
    """K3's, K3-q's, K4's and K4-o's float32 forms against their plain
    versions at F32_WIDTHS, B=F32_DEC_B (K3 and K3-q at L=F32_DEC_L and
    every K3_POS), each case with its repeats, ms (CUDA events), queued
    ms (20 calls behind a sleep kernel), plain ms and bound. Returns the
    four kernels' entries for the kernels line."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    queued_ms = load_tool("torch_decode_kernel_ab").queued_ms
    src = "multimodal_audio_search_tpu_torch/csrc/decoder_block_f32.cu"
    jx = "multimodal_audio_search_tpu/ops/decoder_block.py"
    specs = {
        "K3": ("decoder_self_block_f32", f"{jx}:200", DB.fused_self_block,
               DB.self_block_plain),
        "K3-q": ("decoder_self_block_q_f32", f"{jx}:272",
                 DB.fused_self_block_q, DB.self_block_q_plain),
        "K4": ("decoder_mlp_block_f32", f"{jx}:611", DB.fused_mlp_block,
               DB.mlp_block_plain),
        "K4-o": ("decoder_mlp_block_o_f32", f"{jx}:363",
                 DB.fused_mlp_block_o, DB.mlp_block_o_plain)}
    out = {k: {"name": n, "route": "cuda", "source": src, "replaces": r,
               "cases": []} for k, (n, r, _, _) in specs.items()}
    tol = [F32_BLOCK_ATOL, F32_BLOCK_RTOL]
    b, l = F32_DEC_B, F32_DEC_L

    def flat(outs):
        return torch.cat([t.reshape(-1) for t in outs])

    def timed(fn, plain):
        return {"ms": time_ms(fn), "queued_ms": queued_ms(fn),
                "plain_ms": time_ms(plain), "library_ms": None}
    for label, heads in F32_WIDTHS:
        d = heads * 64
        f = 4 * d
        x, selfw, tail, kc, vc = k3_inputs(gen, b, l, d, dtype=torch.float32)
        for key in ("K3", "K3-q"):
            _, _, fused, plain = specs[key]
            args = (x, *selfw, *(tail if key == "K3-q" else []))
            for pos in K3_POS:
                name = f"{key} float32 {label} pos={pos}"
                ref = plain(*args, kc, vc, pos, heads=heads)
                kg, vg = kc.clone(), vc.clone()
                got = fused(*args, kg, vg, pos, heads=heads)
                torch.cuda.synchronize()
                err = max(check_close(f"{name} {o}", g, r, *tol)
                          for o, g, r in zip(("x_out", "k1", "v1",
                                              "q_cross"), got, ref))
                for c, cg in ((kc, kg), (vc, vg)):
                    if not (torch.equal(cg[:, :pos], c[:, :pos]) and
                            torch.equal(cg[:, pos + 1:], c[:, pos + 1:])):
                        raise AssertionError(f"{name}: a cache row other "
                                             f"than {pos} was written")
                fn = (lambda: fused(*args, kg, vg, pos, heads=heads))
                case = {"shape": f"{label} B={b} D={d} H={heads} L={l} "
                                 f"pos={pos}", "max_abs_err": err,
                        "repeats_equal": check_repeats(
                            name, lambda: flat(fn()), flat(got),
                            F32_REPEATS),
                        **timed(fn, lambda: plain(*args, kc, vc, pos,
                                                  heads=heads)),
                        **k3_f32_bound(args, got, pos)}
                out[key]["cases"].append(case)
                phase("f32", card=card, kernel=f"{key} float32", tol=tol,
                      **case)
        x, mlp, head = k4_inputs(gen, b, d, f, dtype=torch.float32)
        for key in ("K4", "K4-o"):
            _, _, fused, plain = specs[key]
            args = (x, *head, *mlp) if key == "K4-o" else (x, *mlp)
            got = fused(*args)
            torch.cuda.synchronize()
            name = f"{key} float32 {label}"
            case = {"shape": f"{label} B={b} D={d} F={f}",
                    "max_abs_err": check_close(name, got, plain(*args),
                                               *tol),
                    "repeats_equal": check_repeats(
                        name, lambda: fused(*args), got, F32_REPEATS),
                    **timed(lambda: fused(*args), lambda: plain(*args)),
                    **bound(nbytes(*args, got), f32=4 * b * d * f + (
                        2 * b * d * d if key == "K4-o" else 0)),
                    "bound_rate": "f32"}
            out[key]["cases"].append(case)
            phase("f32", card=card, kernel=f"{key} float32", tol=tol,
                  **case)
        del x, selfw, tail, kc, vc, mlp, head, args, got
    return list(out.values())


# [f32]'s int8 decoder kernels: K5's, K6's and K7's float32 forms at the
# float32 int8 engines' shapes. K5 at the float32 twins of K5_SHAPES (x and
# bias float32, float32 out, as a float32 engine calls it) is held
# elementwise at F32_BLOCK_ATOL / RTOL: its products round in float32, as
# the plain version's do, in another order (the 2xTF32 wide kernel drops
# 2^-21 of x and sums 64-deep tiles toward zero: at most 5.0e-6 over its
# 24.6M outputs on an H100).
# K6 and K7 at B=F32_B, T=F32_T, F32_WIDTHS (K6 also at K6_POS) are held
# to F32_INT8_ATT_MAX / L2, relative as check_rel reads them. Kernel and
# plain version read the same float32 q and make the same q codes (K6:
# B6's true division) or bf16 values (K7: B7's rounding to nearest), then
# differ in exp and the order of float32 sums, so a weighted probability
# crosses a rounding boundary of its code (K6) or of bf16 (K7) rarely.
# Sound readings: on an H100 80GB HBM3 at 700 W at most 2.0e-7 / 7.1e-8
# (K6) and 3.6e-5 / 2.9e-6 (K7 base: a bf16 crossing); K7's float64
# emulation at B=8 2.0e-4 / 3.5e-5 (INT8_ATT_MAX's note). The limits are
# 5x and 3x the largest, a tenth and a twentieth of INT8_ATT_MAX / L2.
# Planted faults, from the plain versions at the same shapes
# (fault_reading, each run), read: K6 with q rounded to bf16 before its
# division (q_bf16_plain_k6) 2.0e-2-2.8e-2 / 1.6e-2-1.8e-2; K7 with q
# left in float32 (q_f32_plain_k7) 4.2e-3-5.0e-3 / 2.7e-3-2.8e-3, whose
# max INT8_ATT_MAX passes.
F32_INT8_ATT_MAX, F32_INT8_ATT_L2 = 1e-3, 1e-4
# A float32 int8 engine's first decode step against the same step on K5's,
# K6's and K7's plain versions: max |err| within F32_INT8_STEP_MAX of the
# plain step's span (sound runs on an H100 80GB HBM3 at 700 W: 1.5e-6-
# 2.3e-6); the step with the attention's planted q fault must read beyond
# it (on the CPU test engine, 2 layers of D=128: K6's 1.3e-4, K7's 2.7e-5).
F32_INT8_STEP_MAX = 1e-5


def f32_int8_kernel_checks(card: str, gen: torch.Generator) -> list[dict]:
    """K5's (every K5_SHAPES case in float32), K6's and K7's float32 forms
    against their plain versions on the card (K6 / K7 within
    F32_INT8_ATT_MAX / L2, and their planted q faults' readings beyond
    them: fault_reading), each with F32_REPEATS more launches bit-equal,
    ms (CUDA events), queued ms (20 calls behind a sleep kernel), plain
    ms, bound and the library call's ms (K5: torch._weight_int8pack_mm on
    float32 where the card's torch runs it). Returns the three kernels'
    entries for the kernels line."""
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    queued_ms = load_tool("torch_decode_kernel_ab").queued_ms
    pkg, jx = "multimodal_audio_search_tpu_torch/csrc", \
        "multimodal_audio_search_tpu/ops"
    k5 = {"name": "quant_matmul_f32", "route": "cuda",
          "source": f"{pkg}/quant_matmul.cu", "replaces": f"{jx}/quant.py:113",
          "cases": []}
    k6 = {"name": "single_query_attention_int8_f32", "route": "cuda",
          "source": f"{pkg}/cross_attention_int8.cu",
          "replaces": f"{jx}/cross_attention.py:329", "cases": []}
    k7 = {"name": "int8_cached_attention_f32", "route": "cuda",
          "source": f"{pkg}/cached_attention.cu",
          "replaces": f"{jx}/cached_attention.py:90", "cases": []}
    f32 = torch.float32
    tol = [F32_BLOCK_ATOL, F32_BLOCK_RTOL]
    for m, k, n, _, bias in K5_SHAPES:
        x, wq, scale, b = k5_inputs(gen, m, k, n, bias=bias, dtype=f32)
        p = {"wq": wq, "scale": scale, **({"b": b} if bias else {})}
        regime = k5_regime(m, n)
        if regime == "logits":  # the table as the model on the card holds it
            p = Q.logits_table(p)
        fn = (lambda: Q.quant_dense_apply(p, x))
        plain = (lambda: k5_plain(x, wq, scale, b, f32))
        got = fn()
        torch.cuda.synchronize()
        name = f"K5 float32 {m}x{k}x{n}"
        plan = {"kernel": "table"} if "wq_t" in p else dict(zip(
            ("kernel", "bn", "splits", "steps"), Q.split_plan(
                m, k, n, wave=torch.cuda.get_device_properties(
                    x.device).multi_processor_count, f32=True)))
        case = {"shape": f"M={m} K={k} N={n} out=f32 bias={bias} "
                         f"regime={regime}", "plan": plan,
                "max_abs_err": check_close(name, got, plain(), *tol),
                "repeats_equal": check_repeats(name, fn, got, F32_REPEATS),
                "ms": time_ms(fn), "queued_ms": queued_ms(fn),
                "plain_ms": time_ms(plain),
                # every regime at the lesser of FFMA and two TF32
                # products (the codes are exact in TF32)
                **f32_bound(nbytes(x, wq, scale, b, got), 2 * m * k * n,
                            products=2)}
        case["tflops"] = 2 * m * k * n / case["queued_ms"] / 1e9
        lib, why = k5_library(x, wq, scale)
        case["library_ms"] = time_ms(lib) if lib else None
        if not lib:
            case["library"] = why
        k5["cases"].append(case)
        phase("f32", card=card, kernel="K5 float32", tol=tol, **case)
        del x, wq, scale, b, p, got, lib
    torch.cuda.empty_cache()
    b, t = F32_B, F32_T
    lim = (F32_INT8_ATT_MAX, F32_INT8_ATT_L2)
    att_tol = dict(zip(("max", "l2"), lim))
    for label, heads in F32_WIDTHS:
        args = k6_inputs(gen, b, t, heads, dtype=f32)
        for pos in (None, K6_POS):
            fn = (lambda: CX.fused_single_query_attention_int8(
                *args, heads=heads, pos=pos))
            plain = (lambda: CX.single_query_attention_int8_plain(
                *args, heads=heads, pos=pos))
            got = fn()
            torch.cuda.synchronize()
            name = f"K6 float32 {label} pos={pos}"
            keys = t if pos is None else pos + 1
            ref = plain()
            case = {"shape": f"{label} B={b} T={t} H={heads} pos={pos}",
                    "plan": CX.int8_plan(keys, heads, b,
                                         CX._fit_int8(got.device)),
                    **check_rel(name, got, ref, *lim),
                    "q_bf16_fault": fault_reading(
                        name, q_bf16_plain_k6(*args, heads=heads, pos=pos),
                        ref, *lim),
                    "repeats_equal": check_repeats(name, fn, got,
                                                   F32_REPEATS),
                    "ms": time_ms(fn), "queued_ms": queued_ms(fn),
                    "plain_ms": time_ms(plain), "library_ms": None,
                    **bound(nbytes(args[0], got)
                            + 2 * b * keys * heads * (64 + 4),
                            int8=4 * b * keys * heads * 64)}
            k6["cases"].append(case)
            phase("f32", card=card, kernel="K6 float32", tol=att_tol, **case)
        args = k7_inputs(gen, b, t, heads, dtype=f32)
        fn = (lambda: CA.int8_cached_attention(*args))
        plain = (lambda: CA.int8_cached_attention_plain(*args))
        got = fn()
        torch.cuda.synchronize()
        name = f"K7 float32 {label}"
        ref = plain()
        case = {"shape": f"{label} B={b} T={t} H={heads}",
                "plan": CA.cluster_plan(t, None, b * heads,
                                        CA._fit(args[0].device)),
                **check_rel(name, got, ref, *lim),
                "q_f32_fault": fault_reading(name, q_f32_plain_k7(*args),
                                             ref, *lim),
                "repeats_equal": check_repeats(name, fn, got, F32_REPEATS),
                "ms": time_ms(fn), "queued_ms": queued_ms(fn),
                "plain_ms": time_ms(plain), "library_ms": None,
                **bound(nbytes(*args, got), int8=4 * b * t * heads * 64)}
        k7["cases"].append(case)
        phase("f32", card=card, kernel="K7 float32", tol=att_tol, **case)
        del args, got, ref
    torch.cuda.empty_cache()
    return [k5, k6, k7]


def f32_margin_check(card: str, eng, clip, texts: dict, ref: dict,
                     device="cuda") -> dict:
    """The fast_lossless float32 engine's texts (``texts``, by segment)
    against the [f32] K1 engine's (``ref``), the clip ingested twice by
    each: each segment whose ASR text or caption differs must be a row of
    the clip's first batch (the 320 s clip: every segment) whose fused
    decode and plain float32 decode (the same pipeline with
    fused_layer=False) differ in tokens, at a first differing step where
    the plain decode's top-2 margin is under F32_MARGIN_REL of the
    step's largest |logit| (decode_margins with ``at``, replayed through
    the plain decoder). Returns the rows differing and their margins by
    model. ``device``: the engine's (the CPU rehearses it)."""
    import dataclasses

    from multimodal_audio_search_tpu_torch.models import whisper as W
    ing = eng.ingest_pipeline
    n, q, transfer, seg_len = _ingest_batch(ing, clip[1])
    starts = sorted({k[1] for k in ref})
    if len(starts) > n:
        raise AssertionError(f"[f32] {len(starts)} segments, {n} in the "
                             f"first batch")
    out = {}
    with torch.inference_mode():
        mel = ing._device_mel(q.to(device), transfer, seg_len)
        for i, name in enumerate(("asr", "caption")):
            p = getattr(ing, name)
            enc = W.encode(p.params, mel.to(p.dtype), p.cfg,
                           fused_blocks=p.fused_encoder_resolved)
            tf, lf = p.dispatch_mel(mel)
            own = p.decode
            p.decode = dataclasses.replace(own, fused_layer=False)
            try:
                tp, lp = p.dispatch_mel(mel)
                at = (tf != tp).int().argmax(dim=1) - len(p.prefix_ids)
                margin = decode_margins(p, enc, tp, lp, rel=F32_MARGIN_REL,
                                        at=at)[:n]
            finally:
                p.decode = own
            texts_differ = sorted({starts.index(k[1]) for k in ref
                                   if texts[k][i] != ref[k][i]})
            differ = ((tf[:n] != tp[:n]).any(dim=1) | (lf[:n] != lp[:n]))
            wide = differ & (margin > 0)
            if bool(wide.any()) or any(not differ[r] for r in
                                       texts_differ):
                raise AssertionError(
                    f"[f32] fast_lossless {name}: rows whose tokens differ "
                    f"from the plain float32 decode's {differ.tolist()}, "
                    f"margins at the first differing step "
                    f"{margin.tolist()} (limit {F32_MARGIN_REL} of the "
                    f"largest |logit|), rows whose texts differ from the "
                    f"K1 engine's {texts_differ}")
            out[name] = {"rows_differing": int(differ.sum()),
                         "texts_differing": len(texts_differ),
                         "margins": [float(m) for m in margin[differ]]}
    return out


def f32_v2_step_check(card: str, eng, clip, device="cuda") -> dict:
    """The float32 "v2" path by the decode steps of the engine's batch:
    ``eng``'s ASR pipeline (whisper-base, float32), the clip's first batch
    encoded, its merged cross K/V, and the prompt's steps decoded with
    fused_layer="v2" (the counts set to 0 just before and read just
    after: K3-q, K4-o and K2 once a step and layer, nothing else) and
    unfused on a cache of their own; the logits within
    F32_STEP_LOGITS_REL of their largest |value| at every step.
    ``device``: the engine's (the CPU rehearses it: no launch counted)."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.models import whisper as W
    ing = eng.ingest_pipeline
    p = ing.asr
    _, q, transfer, seg_len = _ingest_batch(ing, clip[1])
    on_card = torch.device(device).type == "cuda"
    with torch.inference_mode():
        mel = ing._device_mel(q.to(device), transfer, seg_len)
        enc = W.encode(p.params, mel.to(p.dtype), p.cfg,
                       fused_blocks=p.fused_encoder_resolved)
        ckv = W.cross_kv_merged(p.params, enc, p.cfg)
        b, steps = enc.shape[0], len(p.prefix_ids)
        toks = torch.tensor(p.prefix_ids, device=device)
        caches = [W.init_cache(p.cfg, b, steps, torch.float32, device)
                  for _ in range(2)]
        logits = {}
        for label, fused, cache in (("v2", "v2", caches[0]),
                                    ("unfused", False, caches[1])):
            _sync(device)
            runtime.reset_counts()
            logits[label] = [W.decode_step(
                p.params, toks[pos].expand(b), pos, cache, ckv, p.cfg,
                fused_layer=fused) for pos in range(steps)]
            _sync(device)
            if label == "v2":
                counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
        per = steps * p.cfg.dec_layers
        exp = {k: per if on_card and k in ("K2", "K3-q", "K4-o") else 0
               for k in KEYS}
        if counts != exp:
            raise AssertionError(f"[f32] v2 steps: launches {counts} != "
                                 f"{exp}")
        rel = max(float((a - r).abs().max() / r.abs().max())
                  for a, r in zip(logits["v2"], logits["unfused"]))
    if not rel <= F32_STEP_LOGITS_REL:
        raise AssertionError(f"[f32] v2 steps: logits {rel:.3e} of their "
                             f"largest |value| off the unfused steps' "
                             f"(limit {F32_STEP_LOGITS_REL})")
    out = {"batch": b, "steps": steps, "launches": counts,
           "logits_rel_err": rel, "tol": F32_STEP_LOGITS_REL}
    phase("f32", path="f32 v2 steps", card=card, **out)
    return out


def q_bf16_plain_k6(q_m, *args, **kw) -> torch.Tensor:
    """K6's plain version with a planted fault: q rounded to bf16 before
    B6's division (the float32 form must quantize the float32 q)."""
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    return CX.single_query_attention_int8_plain(
        q_m.to(torch.bfloat16).float(), *args, **kw)


def q_f32_plain_k7(q, k8, ks, v8, vs) -> torch.Tensor:
    """K7's plain version with a planted fault: q left in float32 where B7
    rounds it to bf16."""
    logits = torch.einsum("bhd,bhtd->bht", q.float(), k8.float()) \
        * ks.float() * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.softmax(logits, dim=-1)
    pw = (p * vs.float()).to(torch.bfloat16).float()
    return torch.einsum("bht,bhtd->bhd", pw, v8.float())


def fault_reading(name: str, bad, ref, max_lim: float, l2_lim: float) -> dict:
    """A planted fault's output ``bad`` against the sound plain version
    ``ref``, as check_rel reads it; raises if check_rel at these limits
    would pass it."""
    bad, ref = bad.float(), ref.float()
    err = bad - ref
    r = {"rel_max_err": float(err.abs().max() / ref.abs().max()),
         "rel_l2_err": float(err.norm() / ref.norm())}
    if r["rel_max_err"] <= max_lim and r["rel_l2_err"] <= l2_lim:
        raise AssertionError(f"{name}: the check passes a planted fault: "
                             f"{r} (limits {max_lim}, {l2_lim})")
    return r


@contextlib.contextmanager
def plain_int8_kernels(q_fault: bool = False):
    """Within it, K5, K6 and K7 are replaced by their plain versions on
    the tensors' own device: quant_dense_apply, fused_single_query_
    attention_int8 and int8_cached_attention as the ops modules'
    attributes, which the model looks up at each call (so none of the
    three is launched or counted). ``q_fault``: K6's and K7's by their
    planted q faults (q_bf16_plain_k6, q_f32_plain_k7)."""
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    swaps = ((Q, "quant_dense_apply", Q.quant_dense_plain),
             (CX, "fused_single_query_attention_int8",
              q_bf16_plain_k6 if q_fault
              else CX.single_query_attention_int8_plain),
             (CA, "int8_cached_attention",
              q_f32_plain_k7 if q_fault else CA.int8_cached_attention_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def f32_int8_step_check(card: str, asr, mode: str,
                        rng: np.random.Generator) -> dict:
    """A float32 int8 engine's ASR model (quantized decoder, float32) on 8
    distinct 10 s segments (first_decode_steps): its cross K/V (K5's
    2xTF32 projections, then quantized) and first decode step (K5 for
    every dense layer and the logits, K6 or K7 for the cross attention,
    K2 for the self attention), launches counted, against the same step
    with K5 / K6 / K7 replaced by their plain versions on the card
    (plain_int8_kernels, which launches none of them): logits within
    F32_INT8_STEP_MAX of the plain step's span, argmax agreement at least
    INT8_AGREE_MIN. The same step with the attention's planted q fault
    must read beyond F32_INT8_STEP_MAX. ``asr``'s device: the card, or the
    CPU in rehearsal (no launch counted)."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    ckv_of = (W.cross_kv_merged_int8 if mode == "int8_fused"
              else W.cross_kv_quantized)
    logits, counts, _ = first_decode_steps(asr, rng, {
        "kernels": (contextlib.nullcontext, ckv_of),
        "plain": (plain_int8_kernels, ckv_of),
        "fault": (lambda: plain_int8_kernels(q_fault=True), ckv_of)})
    lq, lp = logits["kernels"], logits["plain"]
    layers = asr.cfg.dec_layers
    on_card = torch.device(asr.device).type == "cuda"
    att = "K6" if mode == "int8_fused" else "K7"
    want = {k: 0 for k in KEYS}
    if on_card:
        want.update({"K5": (K5_PER_LAYER_STEP + 2) * layers + 1,
                     att: layers, "K2": layers})
    plain_want = {k: layers if on_card and k == "K2" else 0 for k in KEYS}
    r = step_reading(lq, lp, asr.cfg.vocab_size)
    r["shapes_finite_ok"] = r["shapes_finite_ok"] and \
        lq.dtype == torch.float32
    fault = step_reading(logits["fault"], lp, asr.cfg.vocab_size)
    out = {**r, "planted_q_fault_err_of_span":
           fault["first_step_err_of_span"], "launches": counts["kernels"],
           "plain_launches": counts["plain"]}
    phase("f32", path=f"f32 {mode}", step="first decode step vs plain",
          card=card, tol=[F32_INT8_STEP_MAX, INT8_AGREE_MIN], **out)
    if counts["kernels"] != want or counts["plain"] != plain_want:
        raise AssertionError(f"[f32] {mode}: first step launches "
                             f"{counts['kernels']} != {want}, plain "
                             f"{counts['plain']} != {plain_want}")
    check_step(f"[f32] {mode}", r, F32_INT8_STEP_MAX, INT8_AGREE_MIN,
               "K5 / K6 / K7's plain versions")
    if not fault["first_step_err_of_span"] >= F32_INT8_STEP_MAX:
        raise AssertionError(
            f"[f32] {mode}: the step check passes {att}'s planted q fault "
            f"({fault['first_step_err_of_span']:.3e} of the span)")
    return out


def f32_engine_run(card: str, clip, label: str, enc, profile=None,
                   fused=False, int8=None) -> tuple:
    """A float32 engine at EngineConfig()'s defaults (``profile`` applied,
    ``fused``: the decode configs' fused_layer as in engine_config;
    ``enc``: the decode configs' fused_encoder, None = the profile's, K1;
    ``int8``: quantize_decoder on both Whisper slots under that
    cross_attn, whose own segment must then rank first for its text)
    built by make_default_ingest(..., dtype=torch.float32): the clip
    ingested and the queries answered with the counts set to 0 just
    before and read just after, held to expected_launches; then the clip
    once more under another name, timed warm. Returns (counts, the
    counted run's dispatches (ASR, captions), texts by segment of both
    ingests, each query's top-10 indices, the engine's ASR pipeline, the
    engine, the warm ingest's audio-s/s)."""
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        make_default_ingest)
    cfg = engine_config(profile, fused, int8, enc)
    t0 = time.perf_counter()
    ing = make_default_ingest(cfg, seed=0, dtype=torch.float32,
                              device="cuda")
    eng = AudioSearchEngine(cfg=cfg, ingest_pipeline=ing, device="cuda",
                            seed=0)
    asr, cap = ing.asr, ing.caption
    if not (asr.dtype == cap.dtype == torch.float32):
        raise AssertionError(f"[f32] {label}: dtypes {asr.dtype}, "
                             f"{cap.dtype}")
    build_s = time.perf_counter() - t0
    runtime.reset_counts()
    steps0 = (asr.total_steps, cap.total_steps)
    disp0 = (asr.dispatches, cap.dispatches)
    t0 = time.perf_counter()
    segs = eng.ingest(wav_bytes(clip[1]), source_name=clip[0])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    texts = [m["asr_text"] for m in eng.store.meta]
    queries = [next(tx for tx in texts if tx), *ANN_QUERIES[:3]]
    top10 = []
    for qtext in queries:
        hits, _ = eng.search(qtext, k=10)
        top10.append([h["index"] for h in hits])
    torch.cuda.synchronize()
    counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
    steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
    disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
    exp = expected_launches(fused, int8, steps, disp, asr, cap, enc)
    if counts != exp:
        raise AssertionError(f"[f32] {label}: launches {counts} != "
                             f"expected {exp}")
    own = None
    if int8:
        own, unique = self_query(f"[f32] {label}", texts)
        check_self_hit(f"[f32] {label}", eng.search(texts[own])[0], texts,
                       own, unique)
    rate = len(clip[1]) / SR / ingest_s
    # the same clip again, the engine warm (the first ingest also pays
    # the shapes' first launches and allocations)
    t0 = time.perf_counter()
    eng.ingest(wav_bytes(clip[1]), source_name=clip[0] + ".again")
    torch.cuda.synchronize()
    warm = len(clip[1]) / SR / (time.perf_counter() - t0)
    phase("f32", path=label, card=card, build_seconds=build_s,
          fused_encoder=[asr.fused_encoder_resolved,
                         cap.fused_encoder_resolved],
          segments=len(segs), ingest_seconds=ingest_s,
          ingest_audio_s_per_s=rate, warm_ingest_audio_s_per_s=warm,
          k1_per_dispatch=counts["K1"] / max(1, disp[0]),
          decode_steps={"asr": steps[0], "caption": steps[1]},
          dispatches={"asr": disp[0], "caption": disp[1]},
          launches=counts, expected=exp,
          distinct_asr_texts=len(set(texts)), top10=top10,
          **({"self_query_segment": own} if int8 else {}),
          peak_allocated_bytes=torch.cuda.max_memory_allocated())
    by_seg = {(m["source"], m["start_time"]): (m["asr_text"],
                                               m["audio_description"])
              for m in eng.store.meta}
    return counts, disp, by_seg, top10, asr, eng, warm


def f32_phase(card: str, clips) -> tuple:
    """[f32]: the float32 engine on the card (make_default_ingest(dtype=
    torch.float32) at EngineConfig()'s defaults, full width: whisper-base
    ASR and whisper-tiny captions, 30 s mel context, B=32 segments of the
    320 s clip, 64 greedy tokens, MiniLM-L6, exact top-10). Its kernels
    against their plain versions (f32_kernel_checks, f32_decoder_checks);
    the engine with fused_encoder None (K1's float32 form, 10 launches a
    dispatch: 6 base and 4 tiny layers) and with fused_encoder=False
    (K8's float32 form + the plain o-projection), each with its launches
    held to expected_launches; their texts and top-10 identical; one
    batch's encoder states of the K1 engine against the plain float32
    encoder within F32_ENC_ATOL / F32_ENC_RTOL. Then the float32 engine
    under apply_profile(..., "fast_lossless") (K1 f32 10 a dispatch, K3
    and K4 f32 once a decode step and layer, K2 f32 for the cross
    attention, held to expected_launches), whose texts and top-10 must be
    the K1 engine's but where f32_margin_check allows a segment, and the
    float32 "v2" path on its batch (f32_v2_step_check). Then the int8
    decoder on float32 (f32_int8_kernel_checks: K5's, K6's and K7's
    float32 forms against their plain versions): the float32 engine with
    quantize_decoder under cross_attn "int8_fused" (K5 + K6) and "int8"
    (K5 + K7), each held to expected_launches, its own segment first for
    its text, its texts' agreement with the K1 engine's and its warm
    ingest rate printed, and its first decode step held to the same step
    on the plain versions (f32_int8_step_check). Returns ({path: its
    counts} for "f32" (the K1 engine), "f32_enc_attn", "f32_fast_lossless",
    "f32_v2" (the steps), "f32_int8_fused" and "f32_int8"; the kernels'
    entries: K1's, K2's and K8's float32 forms, then K3's, K3-q's, K4's
    and K4-o's, then K5's, K6's and K7's)."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram
    kern = f32_kernel_checks(card, torch.Generator().manual_seed(24))
    torch.cuda.empty_cache()
    kern = (*kern, *f32_decoder_checks(card,
                                       torch.Generator().manual_seed(25)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts, disp, texts, top10, asr, eng, rate = f32_engine_run(
        card, clips[0], "f32", None)
    layers = asr.cfg.enc_layers + eng.ingest_pipeline.caption.cfg.enc_layers
    if disp != (1, 1) or counts["K1"] != layers:
        raise AssertionError(f"[f32]: K1 {counts['K1']} over dispatches "
                             f"{disp}, want {layers} over one")
    with torch.inference_mode():
        x = make_audio(20, np.random.default_rng(24)).reshape(2, -1)
        w = torch.nn.functional.pad(torch.as_tensor(x, device="cuda"),
                                    (0, asr.mel_cfg.n_samples - x.shape[1]))
        mel = log_mel_spectrogram(w, asr.mel_cfg).float()
        got = W.encode(asr.params, mel, asr.cfg, fused_blocks=True)
        ref = W.encode(asr.params, mel, asr.cfg, fused_attention=False)
    enc_err = check_close("[f32] encoder vs the plain float32 encoder", got,
                          ref, F32_ENC_ATOL, F32_ENC_RTOL)
    del eng, asr, got, ref
    torch.cuda.empty_cache()
    counts8, _, texts8, top8, _, eng8, rate8 = f32_engine_run(
        card, clips[0], "f32 fused_encoder=False", False)
    del eng8
    torch.cuda.empty_cache()
    if texts8 != texts or top8 != top10:
        diff = [k for k in texts if texts8.get(k) != texts[k]]
        raise AssertionError(f"[f32]: K1 and K8 engines differ: texts of "
                             f"{len(diff)} segments, top-10 equal "
                             f"{top8 == top10}")
    countsf, dispf, textsf, topf, _, engf, ratef = f32_engine_run(
        card, clips[0], "f32 fast_lossless", None, "fast_lossless", True)
    if dispf != (1, 1) or countsf["K1"] != layers:
        raise AssertionError(f"[f32] fast_lossless: K1 {countsf['K1']} "
                             f"over dispatches {dispf}, want {layers} over "
                             f"one")
    same = textsf == texts and topf == top10
    margins = None if same else f32_margin_check(card, engf, clips[0],
                                                 textsf, texts)
    v2 = f32_v2_step_check(card, engf, clips[0])
    del engf
    torch.cuda.empty_cache()
    kern = (*kern, *f32_int8_kernel_checks(card,
                                           torch.Generator().manual_seed(26)))
    counts_i8 = {}
    for mode in ("int8_fused", "int8"):
        counts_i8[mode], _, texts_i, _, asr_i, eng_i, rate_i = \
            f32_engine_run(card, clips[0], f"f32 {mode}", None, int8=mode)
        step = f32_int8_step_check(card, asr_i, mode,
                                   np.random.default_rng(26))
        agree = {name: float(np.mean([texts_i[k][i] == texts[k][i]
                                      for k in texts]))
                 for i, name in enumerate(("asr", "caption"))}
        phase("f32", path=f"f32 {mode}", card=card,
              warm_ingest_audio_s_per_s=rate_i, texts_agree_k1_engine=agree,
              first_step_err_of_span=step["first_step_err_of_span"])
        del eng_i, asr_i
        torch.cuda.empty_cache()
    phase("f32", path="f32", card=card, encoder_max_abs_err=enc_err,
          tol=[F32_ENC_ATOL, F32_ENC_RTOL], texts_equal_k8_engine=True,
          top10_equal_k8_engine=True, warm_ingest_audio_s_per_s=rate,
          k8_engine_warm_ingest_audio_s_per_s=rate8,
          fast_lossless_texts_equal=textsf == texts,
          fast_lossless_top10_equal=topf == top10,
          fast_lossless_margins=margins, margin_rel=F32_MARGIN_REL,
          fast_lossless_warm_ingest_audio_s_per_s=ratef)
    return {"f32": counts, "f32_enc_attn": counts8,
            "f32_fast_lossless": countsf, "f32_v2": v2["launches"],
            "f32_int8_fused": counts_i8["int8_fused"],
            "f32_int8": counts_i8["int8"]}, kern


def drift_kernel_checks(card: str, b: int, t: int, heads: int) -> None:
    """[drift]'s kernels at the shapes its rows give them, each against
    its plain version: K2's float32 form over ``t`` cross keys and a self
    cache (the float32 rows), K8's float32 form at T=``t`` and 1500 (the
    float32 rows of the tool's --production), K6 and K7 over ``t`` keys
    (and their float32 forms, the float32 int8 rows'),
    K9 at T=``t`` (a 64-key tile and a partial one), B=``b`` clips. The
    float32 forms also carry one scaled_dot_product_attention call on the
    same float32 inputs (``library_ms``), and both their device time as
    20 calls queued behind a sleep kernel (``queued_ms``)."""
    from multimodal_audio_search_tpu_torch.ops import attention as A
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    # device time behind a sleep kernel: late in the script torch.profiler
    # has come back without device time for SDPA on float32
    queued_ms = load_tool("torch_decode_kernel_ab").queued_ms
    gen = torch.Generator().manual_seed(DRIFT_SEED)
    hd = heads * 64
    tol = [F32_ATT_ATOL, F32_ATT_RTOL]
    for label, n, pos in (("cross", t, None), ("self", 32, 0),
                          ("self", 32, 31)):
        q, k, v = (a.float() for a in k2_inputs(gen, b, n, heads))
        fn = (lambda: CX.fused_single_query_attention(q, k, v, heads=heads,
                                                      pos=pos))
        plain = (lambda: CX.single_query_attention_plain(
            q, k, v, heads=heads, pos=pos))
        got = fn()
        err = check_close(f"K2 float32 {label} pos={pos}", got, plain(),
                          *tol)
        keys = n if pos is None else pos + 1
        # the library call: SDPA on float32 over the same keys (views)
        qh = q.view(b, 1, heads, 64).transpose(1, 2)
        kh, vh = (a[:, :keys].view(b, keys, heads, 64).transpose(1, 2)
                  for a in (k, v))
        sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh))
        phase("drift", card=card, kernel="K2 float32", tol=tol,
              shape=f"{label} B={b} T={n} H={heads} pos={pos}",
              max_abs_err=err, ms=time_ms(fn), plain_ms=time_ms(plain),
              queued_ms=queued_ms(fn), library_ms=time_ms(sdpa),
              library_queued_ms=queued_ms(sdpa),
              **f32_bound(nbytes(q, got) + 2 * b * keys * hd * 4,
                          4 * b * keys * hd))
    for n, bb in ((t, b), (1500, 8)):
        q, k, v = _f32_heads(gen, bb, n, heads)
        fn = (lambda: A.fused_encoder_attention(q, k, v))
        plain = (lambda: A.encoder_attention_plain(q, k, v))
        got = fn()
        err = check_close(f"K8 float32 T={n}", got, plain(), *tol)
        sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v))
        phase("drift", card=card, kernel="K8 float32", tol=tol,
              shape=f"B={bb} T={n} H={heads}", max_abs_err=err,
              ms=time_ms(fn), plain_ms=time_ms(plain, reps=5),
              queued_ms=queued_ms(fn), library_ms=time_ms(sdpa),
              library_queued_ms=queued_ms(sdpa),
              **f32_bound(4 * nbytes(q), 4 * bb * heads * n * n * 64))
    del q, k, v, got
    args = k6_inputs(gen, b, t, heads)
    phase("drift", card=card, kernel="K6", shape=f"B={b} T={t} H={heads}",
          **check_rel("K6 drift", CX.fused_single_query_attention_int8(
              *args, heads=heads), CX.single_query_attention_int8_plain(
              *args, heads=heads), INT8_ATT_MAX, INT8_ATT_L2))
    args = k7_inputs(gen, b, t, heads)
    phase("drift", card=card, kernel="K7", shape=f"B={b} T={t} H={heads}",
          **check_rel("K7 drift", CA.int8_cached_attention(*args),
                      CA.int8_cached_attention_plain(*args), INT8_ATT_MAX,
                      INT8_ATT_L2))
    # the float32 int8 rows' attention: K6's and K7's float32 forms
    args = k6_inputs(gen, b, t, heads, dtype=torch.float32)
    phase("drift", card=card, kernel="K6 float32",
          shape=f"B={b} T={t} H={heads}",
          **check_rel("K6 float32 drift", CX.fused_single_query_attention_int8(
              *args, heads=heads), CX.single_query_attention_int8_plain(
              *args, heads=heads), F32_INT8_ATT_MAX, F32_INT8_ATT_L2))
    args = k7_inputs(gen, b, t, heads, dtype=torch.float32)
    phase("drift", card=card, kernel="K7 float32",
          shape=f"B={b} T={t} H={heads}",
          **check_rel("K7 float32 drift", CA.int8_cached_attention(*args),
                      CA.int8_cached_attention_plain(*args),
                      F32_INT8_ATT_MAX, F32_INT8_ATT_L2))
    for inputs, q_scale, residual in K1_CASES:
        q, k, v, x, wo, bo = k1_inputs(gen, b, t, heads, q_scale=q_scale,
                                       residual=residual)
        args9 = (q, *CA.quantize_kv(k, v), x, wo, bo)
        got = EB.attention_o_residual_int8(*args9)
        phase("drift", card=card, kernel="K9", inputs=inputs,
              shape=f"B={b} T={t} H={heads}",
              **check_k1(f"K9 drift {inputs}", got,
                         EB.attention_o_residual_int8_plain(*args9),
                         residual),
              repeats_equal=check_repeats(
                  f"K9 drift {inputs}",
                  lambda: EB.attention_o_residual_int8(*args9), got,
                  K9_REPEATS))
    del args, args9, got
    torch.cuda.empty_cache()


def drift_phase(card: str, model, device="cuda") -> dict:
    """[drift]: the trained captioner's rows, then the host index's
    storage dtypes (module docstring, 14). Returns the rows' modes."""
    from multimodal_audio_search_tpu_torch.training.synth import SynthVocab
    tool = load_tool("torch_synth_drift")
    waves, truths = tool.held_out(np.random.default_rng(DRIFT_SEED),
                                  DRIFT_CLIPS, 1.0, model.n_events)
    rows = tool.select_rows([*tool.ROWS, *tool.EXTRA_ROWS])
    short_s = tool.short_context_seconds(1.0, model.mel_seconds)
    modes, details = tool.measure(model, waves, truths, rows, device,
                                  short_s)
    names = {v: k for k, v in KEYS.items()}
    launched = {r: {names.get(k, k): n for k, n in d["launches"].items()}
                for r, d in details.items()}
    words = set(SynthVocab.WORDS)
    outside = {r: [t for t in d["texts"] if not set(t.split()) <= words]
               for r, d in details.items()}
    for r in rows:
        d = details[r]
        phase("drift", card=card, row=r, **modes[r], dtype=d["dtype"],
              device=d["device"], fused_encoder=d["fused_encoder"],
              seconds=d["seconds"], launches=launched[r],
              outside_grammar=len(outside[r]))
    phase("drift", card=card, clips=DRIFT_CLIPS, short_context_s=short_s,
          sample=list(zip(truths, details["parity"]["texts"]))[:6])
    on_card = torch.device(device).type == "cuda"
    if on_card:                                  # the CPU runs the twins
        for r, kernels in DRIFT_LEVERS.items():
            missing = [k for k in kernels if not launched[r].get(k)]
            assert not missing, f"{r} did not launch {missing}: {launched[r]}"
        levers = {k for ks in DRIFT_LEVERS.values() for k in ks}
        assert not levers & set(launched["parity"]), launched["parity"]
        assert launched["parity"].get("K2"), launched["parity"]
    # each lever row against the row of its dtype: bf16 on the card, where
    # the levers' kernels take bf16 (DRIFT_F32_ROWS: float32, parity)
    ref = {r: details["bf16" if on_card and r not in DRIFT_F32_ROWS
                      else "parity"]["texts"] for r in DRIFT_LEVERS}
    agree = {r: float(np.mean([a == b for a, b in zip(details[r]["texts"],
                                                      ref[r])]))
             for r in DRIFT_LEVERS}
    phase("drift", card=card, lever_agree_with="bf16" if on_card
          else "parity", floor=DRIFT_LEVER_AGREE, agree=agree)
    low = {r: a for r, a in agree.items() if a < DRIFT_LEVER_AGREE}
    assert not low, f"lever rows under {DRIFT_LEVER_AGREE}: {low}"
    assert details["int16"]["texts"] == details["parity"]["texts"], [
        (a, b) for a, b in zip(details["int16"]["texts"],
                               details["parity"]["texts"]) if a != b]
    assert not any(outside.values()), outside
    if on_card:
        from multimodal_audio_search_tpu_torch.config import MelConfig
        t_enc = MelConfig(padded_seconds=model.mel_seconds).n_frames // 2
        drift_kernel_checks(card, DRIFT_CLIPS, t_enc, model.cfg.heads)
    big = load_tool("torch_bigindex_drift").run(
        DRIFT_BIG_N, 384, DRIFT_BIG_QUERIES, device=device)
    phase("drift", card=card, part="bigindex", **big)
    for dtype, floor in DRIFT_RECALL_FLOOR.items():
        got = big["modes"][dtype]["recall@10"]
        assert got >= floor, f"{dtype} recall@10 {got} under {floor}"
    return modes


def train_phase(card: str, device="cuda") -> None:
    """[train]: the seven parts above, in order, the seconds of each, and
    [drift] on the synthetic captioner of the first."""
    t0 = time.perf_counter()
    marks = {}
    m = train_synth_check(card, device)
    marks["synth"] = time.perf_counter() - t0
    train_production_check(card, device)
    marks["production"] = time.perf_counter() - t0
    train_split_check(card, m.params, device)
    marks["data_axis"] = time.perf_counter() - t0
    drift_phase(card, m, device)
    marks["drift"] = time.perf_counter() - t0
    del m
    train_tp_check(card, device)
    marks["model_axis"] = time.perf_counter() - t0
    train_checkpoint_check(card, device)
    marks["checkpoint"] = time.perf_counter() - t0
    train_clap_check(card, device)
    marks["clap"] = time.perf_counter() - t0
    train_bridge_check(card, device)
    marks["bridge"] = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    phase("train", card=card, step="summary", seconds_after=marks)


# ---------------------------------------------------------------- [weights]
WEIGHTS_SEED = 0           # the stand-ins' and the in-memory engine's seed
# the stand-ins at published widths: (directory, family, preset)
STANDINS = (("whisper-base", "whisper", "base"),
            ("whisper-tiny", "whisper", "tiny"),
            ("all-MiniLM-L6-v2", "minilm", "L6"))
WEIGHTS_QUERIES = ("upbeat music with drums", "someone speaking clearly",
                   "rain and birds in the background")


def _cpu32(x) -> torch.Tensor:
    """A leaf as a contiguous float32 CPU tensor."""
    return torch.as_tensor(np.asarray(x.detach().cpu() if torch.is_tensor(x)
                                      else x, np.float32)).contiguous()


def _hf_linear(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _cpu32(p["w"]).t().contiguous()
    if "b" in p:
        sd[f"{prefix}.bias"] = _cpu32(p["b"])


def _hf_ln(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _cpu32(p["scale"])
    sd[f"{prefix}.bias"] = _cpu32(p["bias"])


def _hf_attn(sd: dict, prefix: str, p: dict) -> None:
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("o", "out_proj")):
        _hf_linear(sd, f"{prefix}.{theirs}", p[ours])


def hf_whisper_state_dict(params) -> dict:
    """The inverse of models/convert.py::convert_whisper: a Whisper param
    tree (the port's layout; torch or numpy leaves) as the state dict of
    HF's WhisperForConditionalGeneration, float32 on the CPU, the output
    projection ``proj_out`` tied to the token table as HF ties it."""
    sd: dict = {}
    enc, dec = params["encoder"], params["decoder"]
    for conv in ("conv1", "conv2"):
        sd[f"model.encoder.{conv}.weight"] = _cpu32(
            enc[conv]["w"]).permute(2, 1, 0).contiguous()
        sd[f"model.encoder.{conv}.bias"] = _cpu32(enc[conv]["b"])
    sd["model.encoder.embed_positions.weight"] = _cpu32(enc["positions"])
    for i, blk in enumerate(enc["blocks"]):
        b = f"model.encoder.layers.{i}"
        _hf_attn(sd, f"{b}.self_attn", blk["self_attn"])
        _hf_ln(sd, f"{b}.self_attn_layer_norm", blk["self_ln"])
        _hf_linear(sd, f"{b}.fc1", blk["mlp_in"])
        _hf_linear(sd, f"{b}.fc2", blk["mlp_out"])
        _hf_ln(sd, f"{b}.final_layer_norm", blk["mlp_ln"])
    _hf_ln(sd, "model.encoder.layer_norm", enc["ln"])
    sd["model.decoder.embed_tokens.weight"] = _cpu32(dec["embed_tokens"])
    sd["model.decoder.embed_positions.weight"] = _cpu32(dec["positions"])
    for i, blk in enumerate(dec["blocks"]):
        b = f"model.decoder.layers.{i}"
        _hf_attn(sd, f"{b}.self_attn", blk["self_attn"])
        _hf_ln(sd, f"{b}.self_attn_layer_norm", blk["self_ln"])
        _hf_attn(sd, f"{b}.encoder_attn", blk["cross_attn"])
        _hf_ln(sd, f"{b}.encoder_attn_layer_norm", blk["cross_ln"])
        _hf_linear(sd, f"{b}.fc1", blk["mlp_in"])
        _hf_linear(sd, f"{b}.fc2", blk["mlp_out"])
        _hf_ln(sd, f"{b}.final_layer_norm", blk["mlp_ln"])
    _hf_ln(sd, "model.decoder.layer_norm", dec["ln"])
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


def hf_whisper_config(cfg) -> dict:
    """HF's config.json of a WhisperForConditionalGeneration at ``cfg``'s
    widths (models/convert.py::whisper_config_from_hf reads it back:
    HF's decoder start token is the port's bos_token_id)."""
    return {"architectures": ["WhisperForConditionalGeneration"],
            "model_type": "whisper", "vocab_size": cfg.vocab_size,
            "num_mel_bins": cfg.n_mels, "d_model": cfg.d_model,
            "encoder_layers": cfg.enc_layers,
            "decoder_layers": cfg.dec_layers,
            "encoder_attention_heads": cfg.heads,
            "decoder_attention_heads": cfg.heads,
            "encoder_ffn_dim": cfg.ffn, "decoder_ffn_dim": cfg.ffn,
            "max_source_positions": cfg.enc_positions,
            "max_target_positions": cfg.dec_positions,
            "decoder_start_token_id": cfg.bos_token_id,
            "bos_token_id": cfg.eos_token_id,
            "eos_token_id": cfg.eos_token_id,
            "pad_token_id": cfg.pad_token_id,
            "activation_function": "gelu", "scale_embedding": False,
            "torch_dtype": "float32"}


def hf_bert_state_dict(params, cfg) -> dict:
    """The inverse of models/convert.py::convert_bert: a MiniLM param tree
    as HF's BertModel state dict (float32 on the CPU); the pooler, which
    the conversion drops, is written as zeros so the directory loads
    whole."""
    sd: dict = {}
    emb = params["embeddings"]
    e = "embeddings"
    sd[f"{e}.word_embeddings.weight"] = _cpu32(emb["word"])
    sd[f"{e}.position_embeddings.weight"] = _cpu32(emb["position"])
    sd[f"{e}.token_type_embeddings.weight"] = _cpu32(emb["token_type"])
    _hf_ln(sd, f"{e}.LayerNorm", emb["ln"])
    for i, blk in enumerate(params["blocks"]):
        b = f"encoder.layer.{i}"
        for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value")):
            _hf_linear(sd, f"{b}.attention.self.{theirs}", blk["attn"][ours])
        _hf_linear(sd, f"{b}.attention.output.dense", blk["attn"]["o"])
        _hf_ln(sd, f"{b}.attention.output.LayerNorm", blk["attn_ln"])
        _hf_linear(sd, f"{b}.intermediate.dense", blk["mlp_in"])
        _hf_linear(sd, f"{b}.output.dense", blk["mlp_out"])
        _hf_ln(sd, f"{b}.output.LayerNorm", blk["mlp_ln"])
    sd["pooler.dense.weight"] = torch.zeros(cfg.hidden, cfg.hidden)
    sd["pooler.dense.bias"] = torch.zeros(cfg.hidden)
    return sd


def hf_bert_config(cfg) -> dict:
    """HF's config.json of a BertModel at ``cfg``'s widths
    (models/convert.py::bert_config_from_hf reads it back)."""
    return {"architectures": ["BertModel"], "model_type": "bert",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden,
            "num_hidden_layers": cfg.layers,
            "num_attention_heads": cfg.heads,
            "intermediate_size": cfg.intermediate,
            "max_position_embeddings": cfg.max_positions,
            "type_vocab_size": cfg.type_vocab,
            "layer_norm_eps": cfg.ln_eps, "hidden_act": "gelu",
            "hidden_dropout_prob": 0.0,
            "attention_probs_dropout_prob": 0.0, "torch_dtype": "float32"}


def write_standin(path: str, state_dict: dict, config: dict) -> None:
    """A checkpoint directory as HF's save_pretrained lays out a
    ``pytorch_model.bin`` one: config.json and the state dict saved with
    torch.save (no tokenizer assets)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    torch.save(state_dict, os.path.join(path, "pytorch_model.bin"))


def write_standins(root: str, seed: int = WEIGHTS_SEED,
                   presets=None) -> tuple[dict, dict]:
    """Random-init stand-ins of the three checkpoints under ``root``: the
    parameters the engine draws from ``seed`` in memory (each model from
    its own ``torch.Generator().manual_seed(seed)``), written under HF's
    key names. ``presets`` replaces STANDINS' (name, family, preset)
    triples. Returns ({name: directory}, {name: param tree})."""
    from multimodal_audio_search_tpu_torch.models import minilm as M
    from multimodal_audio_search_tpu_torch.models import whisper as W
    dirs, trees = {}, {}
    for name, family, preset in presets or STANDINS:
        gen = torch.Generator().manual_seed(seed)
        path = os.path.join(root, name)
        if family == "whisper":
            cfg = W.PRESETS[preset]
            tree = W.init_params(gen, cfg)
            write_standin(path, hf_whisper_state_dict(tree),
                          hf_whisper_config(cfg))
        else:
            cfg = M.PRESETS[preset]
            tree = M.init_params(gen, cfg)
            write_standin(path, hf_bert_state_dict(tree, cfg),
                          hf_bert_config(cfg))
        dirs[name], trees[name] = path, tree
    return dirs, trees


def tree_bits_equal(name: str, got, want) -> int:
    """Every leaf of ``got`` (numpy, from models/convert.py) equal bit for
    bit to ``want``'s (the tree written), same keys; returns the leaves
    compared."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{name}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        return sum(tree_bits_equal(f"{name}/{k}", got[k], want[k])
                   for k in want)
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} != {len(want)} items")
        return sum(tree_bits_equal(f"{name}/{i}", g, w)
                   for i, (g, w) in enumerate(zip(got, want)))
    g = np.asarray(got)
    w = _cpu32(want).numpy()
    if g.shape != w.shape or g.dtype != w.dtype or \
            g.tobytes() != w.tobytes():
        raise AssertionError(f"{name}: the converted leaf differs from the "
                             f"written one ({g.shape} {g.dtype} vs "
                             f"{w.shape} {w.dtype})")
    return 1


def weights_engine_check(card: str, cfg, clip, device="cuda") -> dict:
    """An engine of ``cfg`` (seed WEIGHTS_SEED) ingesting ``clip`` (name,
    wave) and answering the own-segment query and WEIGHTS_QUERIES, its
    launches set to 0 just before and read just after (on the card: equal
    to expected_launches, K1 and K2 launched). Returns the segments (source,
    start, end, ASR text, caption), each query's top-10 (index, score),
    the counts and the walls."""
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime
    t0 = time.perf_counter()
    eng = AudioSearchEngine(cfg=cfg, device=device, seed=WEIGHTS_SEED)
    eng.load_all_models()
    build_s = time.perf_counter() - t0
    ing = eng.ingest_pipeline
    asr, cap = ing.asr, ing.caption
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    runtime.reset_counts()
    steps0 = (asr.total_steps, cap.total_steps)
    disp0 = (asr.dispatches, cap.dispatches)
    t0 = time.perf_counter()
    segs = eng.ingest(wav_bytes(clip[1]), source_name=clip[0])
    if on_card:
        torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    meta = list(eng.store.meta)
    texts = [m["asr_text"] for m in meta]
    if not any(texts):
        raise AssertionError("weights: no segment survived validation")
    own = own_segment(meta, range(len(meta)))
    tops = []
    for qi, q in enumerate((texts[own],) + WEIGHTS_QUERIES):
        hits, _ = eng.search(q)
        if qi == 0:
            check_own_first("weights own segment", meta, own, hits)
        tops.append([(h["index"], h["fusion_score"]) for h in hits])
    counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()}
    steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
    disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
    exp = expected_launches(False, None, steps, disp, asr, cap)
    if on_card and (counts != exp or not counts["K1"] or not counts["K2"]):
        raise AssertionError(f"weights: launches {counts} != expected {exp}")
    out = {"segments": [(m["source"], m["start_time"], m["end_time"],
                         m["asr_text"], m["audio_description"])
                        for m in meta],
           "tops": tops, "launches": counts, "expected": exp,
           "build_s": build_s, "ingest_s": ingest_s, "own": own,
           "stored": len(segs),
           "tokenizers": [type(p.tokenizer).__name__
                          for p in (asr, cap, ing.embedder)]}
    del eng, ing, asr, cap
    if on_card:
        torch.cuda.empty_cache()
    return out


def weights_phase(card: str, clips, device="cuda", presets=None,
                  run_kw=None) -> dict:
    """[weights]: the weights-day chain on random-init stand-ins
    (write_standins: whisper-base, whisper-tiny and MiniLM-L6 under HF's
    key names, no tokenizer assets). Each directory loaded and converted
    (timed apart) equals the tree written, bit for bit;
    tools/torch_weights_day.py's run(dry_run=True) on the card reports
    the presets' init parameter counts and the hash tokenizer for all
    three; an engine built from the directories (the tool's
    smoke_config) ingests short.wav with K1 and K2 as expected_launches
    and ranks its own segment first, and its segments, texts and top-10
    equal those of the engine the same seed builds in memory (both take
    the hash tokenizer: no directory carries assets). ``presets`` and
    ``run_kw`` (the tool's smoke arguments) narrow it for the CPU
    rehearsal."""
    import dataclasses
    import tempfile
    from multimodal_audio_search_tpu_torch.models import convert
    from multimodal_audio_search_tpu_torch.models import minilm as M
    from multimodal_audio_search_tpu_torch.models import whisper as W
    tool = load_tool("torch_weights_day")
    presets = presets or STANDINS
    run_kw = run_kw or {}
    clip = next(c for c in clips if c[0] == "short.wav")
    with tempfile.TemporaryDirectory(prefix="standins_") as root:
        t0 = time.perf_counter()
        dirs, trees = write_standins(root, WEIGHTS_SEED, presets)
        write_s = time.perf_counter() - t0
        load_s, convert_s, leaves, nbytes_ = {}, {}, {}, {}
        for name, family, preset in presets:
            nbytes_[name] = os.path.getsize(
                os.path.join(dirs[name], "pytorch_model.bin"))
            t0 = time.perf_counter()
            sd = convert.load_state_dict_from_dir(dirs[name])
            load_s[name] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tree = convert.convert_whisper(sd, W.PRESETS[preset]) \
                if family == "whisper" else \
                convert.convert_bert(sd, M.PRESETS[preset])
            convert_s[name] = time.perf_counter() - t0
            leaves[name] = tree_bits_equal(name, tree, trees[name])
        asr_d, cap_d, mini_d = (dirs[n] for n, _, _ in presets)
        presets_kw = {"asr_preset": presets[0][2],
                      "caption_preset": presets[1][2],
                      "minilm_preset": presets[2][2], **run_kw}
        t0 = time.perf_counter()
        rep = tool.run(asr_d, cap_d, mini_d, dry_run=True,
                       out=os.path.join(root, "weights_day_report.json"),
                       device=device, **presets_kw)
        run_s = time.perf_counter() - t0
        steps = rep["steps"]
        want = {key: tool.n_params(trees[n]) for key, (n, _, _) in zip(
            ("whisper_base", "captioner", "minilm"), presets)}
        got = {key: steps["convert"][key]["params"] for key in want}
        if got != want:
            raise AssertionError(f"weights: converted parameter counts "
                                 f"{got} != the presets' init {want}")
        real = {k: v["real"] for k, v in steps["tokenize"].items()}
        if any(real.values()):
            raise AssertionError(f"weights: a stand-in without assets took "
                                 f"a real tokenizer: {real}")
        if not steps["smoke"]["ok"] or steps["parity"] != \
                "skipped (--dry-run)":
            raise AssertionError(f"weights: report {steps}")
        phase("weights", step="weights_day", card=card, device=device,
              write_seconds=write_s, load_seconds=load_s,
              convert_seconds=convert_s, bin_bytes=nbytes_,
              leaves_bit_equal=leaves, run_seconds=run_s,
              params=got, tokenize={k: v["class"]
                                    for k, v in steps["tokenize"].items()},
              smoke={k: steps["smoke"][k] for k in (
                  "seconds", "segments", "sample_transcripts", "hits")})
        cfg = tool.smoke_config(asr_d, cap_d, mini_d, **presets_kw)
        in_memory = cfg.replace(**{
            k: dataclasses.replace(getattr(cfg, k), weights_path=None)
            for k in ("asr_model", "caption_model", "text_embedder")})
        got_e = weights_engine_check(card, cfg, clip, device)
    want_e = weights_engine_check(card, in_memory, clip, device)
    for label, e in (("directories", got_e), ("in memory", want_e)):
        phase("weights", step=f"engine from {label}", card=card,
              build_seconds=e["build_s"], ingest_seconds=e["ingest_s"],
              segments=len(e["segments"]), launches=e["launches"],
              tokenizers=e["tokenizers"], own_segment=e["own"],
              top_hit=e["tops"][0][0] if e["tops"][0] else None)
    if got_e["segments"] != want_e["segments"]:
        raise AssertionError(
            f"weights: segments from the directories differ from the "
            f"in-memory engine's: {got_e['segments']} vs "
            f"{want_e['segments']}")
    ids = [[i for i, _ in t] for t in got_e["tops"]]
    if ids != [[i for i, _ in t] for t in want_e["tops"]]:
        raise AssertionError(f"weights: top-10 differ: {got_e['tops']} vs "
                             f"{want_e['tops']}")
    score_diff = max((abs(a - b) for ga, wa in zip(got_e["tops"],
                                                    want_e["tops"])
                      for (_, a), (_, b) in zip(ga, wa)), default=0.0)
    if score_diff > K12_ATOL:
        raise AssertionError(f"weights: top-10 scores differ by "
                             f"{score_diff}")
    if got_e["launches"] != want_e["launches"]:
        raise AssertionError(f"weights: launches {got_e['launches']} != "
                             f"the in-memory engine's {want_e['launches']}")
    phase("weights", step="directories = memory", card=card,
          segments=len(got_e["segments"]), texts_equal=True,
          top10_equal=True, max_score_diff=score_diff,
          tokenizers=got_e["tokenizers"])
    return got_e["launches"]


# ------------------------------------------------------------------- [soak]
# the single pass's WAV and the loop's length (tools/torch_soak.py)
SOAK_SECONDS = 60
SOAK_LOOP_MINUTES = 0.5


def soak_phase(card: str, device="cuda", seconds: float = SOAK_SECONDS,
               minutes: float = SOAK_LOOP_MINUTES) -> dict:
    """[soak]: tools/torch_soak.py against the port's server (production
    defaults, a temporary data root) on ``device``: its single pass, then
    ``_soak_loop`` for ``minutes``; every status must be 200 and the
    loop's three checks true. Prints the samples' RSS fit and the
    launches over the whole run."""
    from multimodal_audio_search_tpu_torch import runtime
    tool = load_tool("torch_soak")
    runtime.reset_counts()
    t0 = time.perf_counter()
    res = tool.main(["--seconds", str(seconds), "--port", "0",
                     "--loop-minutes", str(minutes), "--device", device])
    wall = time.perf_counter() - t0
    counts = {k: runtime.COUNTS[v] for k, v in KEYS.items()
              if runtime.COUNTS[v]}
    loop = res.get("loop", {})
    phase("soak", card=card, device=device, seconds=wall,
          statuses={k: v["status"] for k, v in res.items()
                    if isinstance(v, dict) and "status" in v},
          ingest={"status": res["ingest"]["status"],
                  "s": res["ingest"]["s"],
                  "segments": len(res["ingest"]["segments"] or [])},
          search=res["search"],
          search_warm=res["search_warm"], loop=loop,
          rss_fit=res.get("rss_fit"), launches=counts)
    bad = {k: v["status"] for k, v in res.items()
           if isinstance(v, dict) and "status" in v and v["status"] != 200}
    if not res["ok"] or bad or not loop or not all(loop["checks"].values()):
        raise AssertionError(f"soak: statuses {bad}, loop {loop}")
    if torch.device(device).type == "cuda" and not (
            counts.get("K1") and counts.get("K2")):
        raise AssertionError(f"soak: the server's ingests launched "
                             f"{counts}")
    return counts


# -------------------------------------------------------------------- [dcn]
# (rows, dim) of the multi-process check's runs: the JAX tool's size, then
# 50k rows at the engine's width (384) for the top-k and gradient across
# processes (1M x 2 x 384 took 47 s on an H100, over the script's time;
# [mesh] searches 1M x 2 x 384 across shards in one process)
DCN_RUNS = ((512, 64), (50_000, 384))


def dcn_phase(card: str, device="cuda", runs=DCN_RUNS) -> None:
    """[dcn]: tools/torch_multiprocess_dcn_check.py, two processes in one
    Gloo group on ``device`` (the card, each process naming it twice), at
    each of ``runs``; both MPDCN_OK lines and ALL OK required."""
    for rows, dim in runs:
        cmd = [sys.executable,
               os.path.join(ROOT, "tools", "torch_multiprocess_dcn_check.py"),
               "--procs", "2", "--local", "2", "--rows", str(rows),
               "--dim", str(dim), "--device", device]
        t0 = time.perf_counter()
        # past the tool's own deadline for its children
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=660)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("MPDCN_OK")]
        phase("dcn", card=card, rows=rows, dim=dim, procs=2, local=2,
              seconds=time.perf_counter() - t0, returncode=p.returncode,
              ok_lines=lines)
        if p.returncode != 0 or "ALL OK" not in p.stdout or len(lines) != 2:
            raise AssertionError(f"dcn at {rows} rows failed (rc "
                                 f"{p.returncode}):\n{p.stdout[-4000:]}"
                                 f"\n{p.stderr[-2000:]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    if torch.cuda.device_count() != 1:
        raise SystemExit(
            f"chip_smoke drives one card; {torch.cuda.device_count()} are "
            f"visible (expose one, e.g. CUDA_VISIBLE_DEVICES=0)")
    card = card_line()
    phase("env", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          devices=torch.cuda.device_count())
    sys.path.insert(0, ROOT)
    from multimodal_audio_search_tpu_torch import runtime
    runtime.select_device("cuda")
    runtime.kernels()
    info = runtime.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln
             or "Compiling entry" in ln]
    phase("build", seconds=info["seconds"], command=info["command"],
          ptxas=ptxas)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    clips = [("long.wav", make_audio(320, rng)),
             ("short.wav", make_audio(25, rng))]
    # the phases this slice added draw from their own generators, so the
    # other phases see the inputs they saw before
    audio = audio_phase(card, np.random.default_rng(1))
    k1, k2 = kernel_phase(card, gen)
    dec = decoder_kernel_phase(card, gen)
    int8k = int8_kernel_phase(card, gen)
    encv = encoder_variant_phase(card, gen)
    k12, k13 = search_kernel_phase(card)
    counts, mems, ref_texts = {}, {}, None
    k14, counts["kernels"] = cross_mlp_phase(card, gen)
    for label, profile, fused, int8, enc in ENGINE_PATHS:
        # v2 and the encoder variants take the 320 s clip only (time)
        c, texts, mems[label] = engine_phase(
            card, rng, label, profile, fused, int8, enc,
            clips[:1] if fused == "v2" or enc is not None else clips,
            ref_texts)
        counts[label] = c
        ref_texts = ref_texts or texts
    f32_counts, f32k = f32_phase(card, clips)
    counts.update(f32_counts)
    counts.update(codec_phase(card, np.random.default_rng(2), clips, mems,
                              ref_texts, k1, k2, gen))
    counts.update(parity_phase(card, rng, clips, mems, k2, dec))
    phase("memory", card=card, **{key: {
        "bytes": {k: m[key] for k, m in mems.items()},
        "share_of_default": {k: m[key] / mems["default"][key]
                             for k, m in mems.items()}}
        for key in mems["default"] if key.endswith("_bytes")})
    counts["embedders"] = embedders_phase(card, clips)
    clap_phase(card, clips)
    service_phase(card, rng, audio["uploads"])
    counts["weights"] = weights_phase(card, clips)
    counts["soak"] = soak_phase(card)
    counts["ab"] = ab_phase(card)
    counts["search_scale"] = search_scale_phase(card)
    counts["ann"] = ann_phase(card, clips)
    counts["mesh"] = mesh_phase(card, clips)
    dcn_phase(card)
    counts["tp"], tp_kern = tp_phase(card, clips, k1, k2, dec, int8k)
    train_phase(card)
    phase("seconds", **phase_seconds())
    # each kernel's launches from the path that runs it
    path_of = {"K1": "default", "K2": "default", "K3": "fast_lossless",
               "K4": "fast_lossless", "K3-q": "v2", "K4-o": "v2",
               "K5": "int8_fused", "K6": "int8_fused", "K7": "int8",
               "K8": "enc_attn", "K9": "enc_int8", "K10": "enc_paired",
               "K11": "ab", "K12": "search_scale", "K13": "search_scale",
               "K14": "kernels"}
    kern = []
    for key, k in zip(KEYS, (k1, k2, *dec, *int8k, *encv, k12, k13, k14)):
        first = next(c for c in k["cases"] if "ms" in c)
        kern.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": counts[path_of[key]][key],
            "max_abs_err": max(c["max_abs_err"] for c in k["cases"]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first.get("library_ms"),
            **{f: first[f] for f in ("device_ms", "library_device_ms")
               if f in first},
            **({"mechanism": k["mechanism"]} if "mechanism" in k else {}),
            "shape": first["shape"], "path": path_of[key],
            "cases": k["cases"]})
    # the encoder variants' partial forms, from the model axis's paths
    # (their launches count as K9's and K10's, which these paths run only
    # in the partial form)
    for key, k, path in (("K9", tp_kern[0], f"enc_int8 (1, {TP_MP})"),
                         ("K10", tp_kern[1], f"enc_paired (1, {TP_MP})")):
        first = next(c for c in k["cases"] if "ms" in c)
        kern.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": counts["tp"][path][key],
            "max_abs_err": max(c["max_abs_err"] for c in k["cases"]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "device_ms": first["device_ms"],
            "shape": first["shape"], "path": f"tp {path}",
            "cases": k["cases"]})
    # the float32 forms, from the float32 engines' paths (K3-q's and K4-o's
    # from the float32 "v2" decode steps)
    for key, k, path in (("K1", f32k[0], "f32"), ("K2", f32k[1], "f32"),
                         ("K8", f32k[2], "f32_enc_attn"),
                         ("K3", f32k[3], "f32_fast_lossless"),
                         ("K3-q", f32k[4], "f32_v2"),
                         ("K4", f32k[5], "f32_fast_lossless"),
                         ("K4-o", f32k[6], "f32_v2"),
                         ("K5", f32k[7], "f32_int8_fused"),
                         ("K6", f32k[8], "f32_int8_fused"),
                         ("K7", f32k[9], "f32_int8")):
        first = k["cases"][0]
        kern.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": counts[path][key],
            "max_abs_err": max(c["max_abs_err"] for c in k["cases"]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "bound_rate": first.get("bound_rate", "int8"),
            "library_ms": first["library_ms"],
            "shape": first["shape"], "path": path, "cases": k["cases"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
