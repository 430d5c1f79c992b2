#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. the CUDA preflight's verdict (``hostenv.backend_preflight``: the device
   count and the first card's name under a wall deadline), then the card
   (``nvidia-smi``), torch and CUDA versions, and the build of
   every CUDA kernel of the port (one ``nvcc`` per source, started together),
   beside the launches that launch no port kernel: ``supervised_resume``'s
   two, ``main_path_live``'s without the plane and ``bare_init``, checked
   where their phases stand; section 2 runs every kernel's check beside
   them and waits for them before its first timing, so that no kernel is
   timed beside another process;
2. with TF32 off, each kernel against its plain PyTorch version on the card:
   the Gram-Schmidt kernel (K1) at every (g, n, r) shape group of the
   ResNet path (ResNet-152, rank 4) and of the DistilBERT path
   (``distilbert_base``, rank 16, n = 30522 for the word table), a ragged
   n = 100, r in {1, 8, 32} at n = 4608, (1, 30522, 32) (the streaming
   route), (1, 30523, 16), (1, 17, 16) and (25, 768, 16), with the route
   and cluster size of each and the device time of each DistilBERT group;
   the fused PowerSGD kernels
   (K2a, K2b, K3, K4) at every (g, n, m, r) shape group, a ragged
   (3, 100, 37, 8), a clipped (1, 2, 3, 2), m % 4 in {1, 2, 3} and r in
   {1, 8, 32} at n = 4608, m = 512 (r = 32 takes K3's two-launch route),
   with K3's P-hat held to K1's output bit for bit and a second launch of
   K2a, K2b and K3 to the first's bits at every shape; flash attention (K5) at
   DistilBERT's full width (B 16, T 256, H 12, D 64) with the synthetic-IMDb
   padding, without a mask, causal, with fully masked rows (-1e30 and
   finfo(f32).min), at D = 128, against the plain version's
   block_q != block_k, with left padding (real keys only in the last tile),
   one real key inside a padded tile and at T = 100; NaN in K and V of
   every all-padding tile must leave out and lse bitwise unchanged (those
   tiles are skipped, not read); one step's launches timed with the IMDb
   mask and without one, each beside SDPA on the same inputs; then K5 on
   bf16 heads (the IMDb mask, GPT-2's causal (16, 1024, 12, 64), T = 100 at
   D = 40, causal at D = 128, NaN in the skipped bf16 tiles) and causal in
   fp32 at GPT-2's shape, against the plain version on the same inputs,
   with one GPT-2 step's 12 causal launches timed in each dtype beside
   SDPA ``is_causal``; then K5's backward kernel, in fp32 and bf16, against
   its plain version on the forward kernel's own out and lse (the IMDb
   padding, no mask, causal, fully masked rows, left padding, real keys
   alone in their tiles, T = 100 at D = 40, causal at D = 128, GPT-2's
   causal shape and the mask's gradient), two calls bitwise equal, NaN in K and V of every
   all-padding tile leaving dq and the real keys' dk and dv bitwise
   unchanged (the padded keys' exactly 0), and one GPT-2 step's 12
   backwards timed in each dtype beside the plain version and SDPA's
   backward;
3. the main paths through a one-rank NCCL group, 2 warm-up and 5 timed
   steps, then 3 steps under ``torch.profiler``, each with the launch
   counts set to 0 just before it and read just after (K5's backward once
   per layer and training step wherever K5 runs in training):
   ``powersgd_cifar10.run`` with preset ``full`` (ResNet-152, ImageNet
   stem, width 64, global batch 512, PowerSGD rank 4) on the
   ``compress_impl="xla"`` path (K1) and on the fused ``"pallas"`` path
   (K2a, K3, K4); ``powersgd_imdb.run`` with preset ``full``
   (``distilbert_base``, batch 16, max_len 256, rank 16: K5 and K1);
   ``exact_cifar10.run`` with preset ``full`` (ResNet-50, ImageNet stem,
   width 64, global batch 256, exact DDP: no kernel of the port) under four
   reducer layouts (one packed payload, 25 MiB buckets, 4 chunks, the ring),
   with the bits and collectives of each, the layouts' parameters after two
   steps held equal bit for bit, one profiled step (busy time, NCCL) and the
   accuracy on the test split; ``imdb_baseline.run`` with preset ``full``
   (``distilbert_base``, batch 16, max_len 256, one process: K5) under
   Nesterov SGD and AdamW; ``gpt_lm.run`` with preset ``full`` (GPT-2
   small at vocabulary 1024, T 1024, global batch 16, PowerSGD rank 4: K5
   causal and K1) in fp32 and in bf16; ``gpt_generate.run`` with preset
   ``full`` at vocabulary 50257 (batch 8, prompt 128, 32 new tokens; no
   kernel of the port) in fp32 and bf16, with each fp32 decode step's
   logits held to a full forward of the same prefix and the greedy tokens
   to the full forwards' wherever the top two logits stand apart;
   ``serve_gpt`` with preset ``full`` (GPT-2 small at vocabulary 1024, 8
   slots, 32 Poisson requests at 64 a second, up to 64 new tokens,
   ``max_len`` 96; no kernel of the port): the slot engine in fp32 twice
   (the same tokens bit for bit) and in bf16, every request finished in
   fewer decode steps than padded static batching, the fp32 tokens
   against a sequential batch-1 ``gpt_prefill`` + ``gpt_decode_step``
   reference up to each first difference (allowed only where the
   reference's top-2 margin is under ``SERVE_TIE`` times its largest
   logit), the SLO p50 and p99, tokens/s, cache bytes and peak memory, and
   one decode tick of each engine under ``torch.profiler`` (launches, busy
   time, idle share; no flash or Gram-Schmidt kernel) with 20 ticks timed
   (``main_path_serve``); the same workload through the paged engine
   (block 16) and under self-drafted K = 4 speculation, each with the fp32
   slot engine's tokens bit for bit and every reachable proposal accepted,
   and eight prompts on one 32-token prefix, shared (one full prefill and
   seven suffix prefills, 224 prompt tokens saved) against unshared under
   the near-tie class, the pool's leak invariant every tick
   (``main_path_serve_paged``);
   ``powersgd_imdb.run`` in bf16 (K5 on bf16 heads, K1);
   ``diloco_cifar10.run`` with preset ``full`` (ResNet-152, batch 512, two
   rounds of H = 8 inner steps, the outer delta PowerSGD-compressed at rank
   4: K1 once a shape group a round), with one round profiled;
   ``bandwidth_study.run`` with preset ``full`` (ResNet-152, batch 256: exact,
   PowerSGD at ranks 1, 2 and 4, TopK 1 %, SignSGD, QSGD int8, local SGD and
   DiLoCo with PowerSGD at H = 8; each timed, its collectives recorded, its
   step projected over the fabrics for eight workers); then
   ``scripts/torch_bandwidth_artifact.py``'s phases in process
   (``bandwidth_artifact``, nothing else on the card): its structure from
   the study at preset small at world 1 projected for eight workers, the
   card's per-worker step of each flat row, local SGD and DiLoCo (batch
   32, 3 timed steps) and the flagship's step in fp32 and bf16, and the
   projection, each row's projected step the compute time plus the ring
   model's time of its bits, the flagship row's bits the study's; ``launch
   bare_init`` in a process of its own; then the host data plane
   (``main_path_data_plane``): the flagship at preset full on the xla
   pipeline (K1) for 6 steps under deterministic algorithms, fed by the
   numpy loader with ``prefetch=0`` and then by the native loader with
   ``prefetch=2``, the parameters after them bit for bit, the native
   loader's ``last_stats``, the ``data_load``, ``data_load/assemble`` and
   ``data_load/stage`` span p50s, the ``LoaderEvent`` and each step p50;
   5 prefetched steps with steps 1 and 2 under ``torch.profiler``, whose
   batch-sized host-to-device copies must read pinned memory off the
   step's stream; and 64 staged batches at each of depths 0, 1 and 2
   behind a consumer slowed by a long kernel, each bit for bit its source;
   then the checkpointed paths
   through a one-rank NCCL group, their checkpoints under a temporary
   directory that is removed after: ``resilient_resume`` (ResNet-152
   PowerSGD at batch 512, rank 4, the xla pipeline: K1) through
   ``resilient_train_loop``, 3 epochs of 2 steps, under deterministic
   algorithms (the ops without a deterministic kernel named): run
   uninterrupted twice (bitwise equal), crashed on entry to epoch 2 and
   resumed, preempted by ``guard.request()`` after step 1 of epoch 1 and
   resumed past it, and resumed past a flipped bit in the newest step
   (falling back to the one before, with a ``checkpoint_fallback``
   event), every resume holding params, momenta, EF memories, Q and BN
   buffers to the uninterrupted run's bit for bit, with the save
   (serialize, sha256, commit), the restore, the bytes on disk and the
   time from a resume's start to its first step; ``exact_resume``
   (``launch.main`` of ``exact_cifar10 --checkpoint-dir`` at preset full
   for 1 epoch, then 2: it resumes at epoch 1, 752,912,736 bits a step
   both times); and ``serve_hot_load`` (GPT-2 small of the serving shape,
   vocabulary 1024 and 96 positions, trained in fp32 at batch 8, T 64,
   PowerSGD rank 4 through ``resilient_train_loop``, 2 epochs of 2 steps:
   K5 causal forward and backward and K1; then ``serve_gpt`` preset full
   with ``checkpoint_dir``: the served params the trained ones bit for
   bit, ``checkpoint_step`` 1, the tokens against the sequential
   reference under ``SERVE_TIE``, the hot-load's time); then the
   model-parallel GPT entries through their own ``run()`` at GPT-2 small
   widths (dim 768, 12 layers, 12 heads, vocabulary 1024), every mesh axis
   of size 1 over the one-rank group, 3 steps each
   (``model_parallel_phases``): ``main_path_gpt_tp`` (T 1024, batch 16,
   the head replicated and vocabulary-parallel), ``main_path_gpt_sp``
   (T 1024, batch 8, ring and Ulysses), ``main_path_gpt_pp`` (one stage
   of 12 layers, 4 microbatches, T 1024, batch 16: K5 48 causal launches
   forward and 48 backward a step; a save at the end of epoch 0 and a
   resume bitwise the uninterrupted run under deterministic algorithms)
   and ``main_path_gpt_moe`` (8 experts, T 256, batch 16, capacity factor
   2, PowerSGD on the replicated parameters: top-1 and top-2 in fp32,
   top-1 in bf16; K5 12 causal launches each way a step, K1 once a shape
   group a step; the (T, E, C) dispatch bytes; ``switch_moe`` over the
   one-rank group bitwise the single-process call), each with its step
   p50, tokens a second, peak memory, launches, collectives and bits a
   step, and its first step's loss and gradients against plain ``GPTLM``
   (MoE: flash against einsum attention), the leaf of the largest
   difference named; then ``exact_cifar10.run(strategy="fsdp")`` at
   preset ``full`` (ZeRO-3 over the one-rank group: no kernel of the port),
   monolithic and at ``comm_chunks=4``, with 1,505,825,440 bits a step by
   kind, the step p50, peak memory, eval accuracy and 3 profiled steps,
   the unsharded parameters after two steps bit for bit the DDP step's and
   chunked bit for bit monolithic under deterministic algorithms
   (``main_path_exact_fsdp``), and a save of the FSDP state restored by
   ``restore_checkpoint_sharded`` whose next step is the uninterrupted
   run's bit for bit, with the save and restore times
   (``fsdp_checkpoint``); then the options that the ported entries no
   longer refuse, 2 steps each (``option_phases``): ``powersgd_cifar10``
   at ``compute_dtype="bfloat16"`` (ResNet-152 at flax's cast points,
   fp32 parameters, gradients and wire: 36,249,536 + 32 bits) on both
   pipelines with a profile of each, and its fused parameters after two
   steps against the xla ones at ``PARAM_TOL`` (``main_path_bf16``);
   ``gpt_lm`` plain and with ``remat`` in fp32 and bf16 (K5's forward 24
   launches a step, its backward 12), peak memory side by side, a profile
   of each remat run, and two remat steps bit for bit two plain ones under
   deterministic algorithms (``main_path_gpt_remat``); ``gpt_lm`` with
   ``scan_layers`` (13,302,784 + 32 bits in 6 shape groups), one forward
   and backward bit for bit the unrolled model's, and K1 at each stacked
   shape group, up to (1, 36864, 4), against its plain version
   (``main_path_gpt_scan``); ``powersgd_imdb`` plain and with ``remat``,
   the peaks, and one forward and backward bit for bit
   (``main_path_imdb_remat``); then the telemetry core
   (``telemetry_phases``): ``powersgd_cifar10`` at preset full on each
   pipeline, 4 steps off, on with a trace, on, off (``event_log``,
   ``audit_wire``, a health probe every 2 steps: K1, or K2b, K3 and K4,
   once a shape group a probe), the states with and without the probe bit
   for bit, each run log's steps, exact audit at 36,249,536 + 32 bits,
   probes, fidelity groups joined to the ledger and ``MemoryEvent``s from
   the card, the trace's step ranges and kernels, the probe on the kernels
   against their plain versions, its time a call and the step p50 with
   telemetry on against off (``main_path_telemetry``,
   ``main_path_telemetry_fused``), and ``exact_cifar10`` under FSDP with
   its exact audit (``main_path_telemetry_fsdp``); after the chaos and
   the adaptive phases, the run directory and the live plane
   (``live_phases``): ``launch exact_cifar10 --supervise --run-dir D
   --metrics-port 0 --adaptive-comm`` at preset full in a subprocess,
   clean (a scrape of ``/metrics`` mid-run, no page, the losses bit for
   bit the launch's without the plane: ``main_path_live``) and under a
   ``comm_throttle`` that the live detectors page on, nudging the worker
   to ``compress``, K1 there once a shape group a step
   (``main_path_live_nudge``); then the offline analyses on what those
   phases left (``offline_phases``, no training process): the telemetry
   runs' audited FLOPs joined with their steady step p50 into an MFU
   against the H100's bf16 peak (``main_path_mfu``), and
   ``scripts/torch_report.py``'s report of both live run directories (the
   step p50 the merged run's, the critical path over every step, no fabric
   matrix at world 1), the cost model calibrated on ``NVLink4(H100)``, a
   plan over the four fabric rows and its predictions, the launcher's
   ``apply_plan`` of it, and the predicted step against the measured one
   (``main_path_offline``); then the fleet control plane
   (``fleet_phases``, three paths side by side, no port kernel, in a thread
   beside section 4, whose comparisons time nothing):
   ``main_path_fleet``, a ``FleetScheduler`` over two logical chips of the
   card running ``serve_gpt`` preset full from a request spool, the
   supervised launch's ``exact_cifar10`` command and a crash-looper, the
   pool's SLO burn preempting the training job (exit 75 after its
   emergency checkpoint), which resumes when the pool finishes and ends on
   the unfaulted supervised run's final checkpoint bit for bit, the looper
   quarantined, every request served once and the report's fleet section;
   ``main_path_autoscale``, a ``ServingAutoscaler`` of ``serve_gpt``
   workers leasing three logical chips under a burst at 3x one worker's
   rate and a trickle (at least two workers, drained, no request lost, the
   leases granted and released); and ``main_path_fleet_cli``, ``launch
   fleet`` with ``bare_init`` placed on card 0 by its grant, a copy
   granted logical chip 1 refused (no card 1) and the looper; and, in a
   process of its own beside section 4 too, ``scripts/torch_accuracy_study.py
   --task cifar`` cut to 6 epochs at patience 2 (``accuracy_study``: the
   bits of both arms, each arm's best accuracy near the Bayes ceiling, the
   arms' delta, K1 in the PowerSGD arm by the process's own count), after
   K5's forward and backward at the study's DistilBERT tiers (D 8 and
   D 64, the IMDb draws' padding) against their plain versions;
4. two steps from the same weights and batches, deterministic cuDNN: plain
   Gram-Schmidt against the kernel; two DiLoCo rounds of ResNet-152 with
   the outer delta's Gram-Schmidt plain against the kernel; fused against xla; fused against xla
   with one extra power iteration (K2b's path); the small ResNet on the card
   against the same two steps on the CPU; DistilBERT with flash attention
   (K5) against ``attn_impl="einsum"`` on the card; the tiny DistilBERT
   on the card against the CPU; GPT-2 small with flash attention against
   einsum on the card; and the IMDb baseline, under either optimizer, with
   flash attention against einsum on the card; then, beside the fleet's
   thread, the run report and the perf gate over the two live run
   directories (``main_path_report``, no kernel): ``scripts/torch_report.py``
   (every key of the JAX package's report, the Chrome trace, ``--compare``,
   ``--watch`` and the event-log mode) and ``scripts/torch_gate.py`` (the
   clean run against itself, the nudged run against it, a CPU baseline);
5. one ``{"kernels": [...]}`` line (K5's forward and backward once per
   dtype): each kernel's launches on its paths, its
   time for one main-path step (CUDA events, ``ms``, and the profiler's
   device time, ``device_ms``), the plain version's, one PyTorch call's
   where one computes the same function (events and device time) and the
   least time the card could take; before it, the xla path's library calls
   for the same work (CUDA events and device time).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the port beside this script, it prints no result and exits 1.
"""

import atexit
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor-core) FLOP/s
# and dense TF32 and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# K5 computes each fp32 product as three TF32 tensor-core products (3xTF32);
# on bf16 heads q.k as one bf16 product and P.V as two (P split into two
# bf16 parts): three passes for the function's two products
FP32_AS_3XTF32_FLOPS = TF32_FLOPS / 3
BF16_ROUTE_FLOPS = BF16_FLOPS * 2 / 3

GS_TOL = 1e-5  # fp32 sums in another order; entries of P-hat are at most 1
# the fused kernels: P-hat as GS_TOL; P, Q, out and mem are sums of up to n
# or m products in another order, held to FUSED_TOL * max(1, max|plain|);
# M = G + E is one rounded add and must be bitwise equal
FUSED_TOL = 1e-5
PARAM_TOL = 1e-5  # the same, carried through two updates of lr 0.001
# cuDNN against PyTorch's CPU convolutions, fp32 without TF32: sums in
# another order, through a ResNet-18 and two PowerSGD steps
SMALL_TOL = 1e-4

# flash attention: out within ATTN_TOL * max(1, max|plain|) and lse within
# ATTN_TOL relative (fp32 sums over the keys in another order: the kernel
# in 64-key tiles, the plain version in block_k tiles); a fully masked row
# exactly 0 with lse 1e30
ATTN_TOL = 1e-5
# DistilBERT two-step checks (flash against einsum on the card, the tiny
# model on the card against the CPU): parameters and losses. At PowerSGD
# rank 1 every leaf is held to IMDB_TOL. At the slice's rank 16 every leaf
# whose first-step gradient has at least the rank r that the reducer gives
# it is held to IMDB_TOL; the others (the 2-label classifier, whose gradient
# has rank 1 < r = 2) get normalised rounding noise as P-hat's extra columns,
# which differs between any two summation orders, so there every leaf and
# the losses are held to IMDB_RANK16_TOL, set from the H100's readings
# (flash against einsum: 8.4e-6 in the parameters, 3.6e-6 in the losses)
IMDB_TOL = 1e-5
IMDB_RANK16_TOL = 5e-5

MAIN_STEPS, WARMUP_STEPS = 7, 2
FUSED_REPS = 10  # profiled calls per fused kernel's device time: K2b and torch.bmm have read 2.4 % apart, near the 2 % noise
PROFILE_STEPS = 3
# distilbert_base at batch 16, max_len 256: folded heads and launches per step
IMDB_B, IMDB_T, IMDB_H, IMDB_D, IMDB_LAYERS = 16, 256, 12, 64, 6
IMDB_BITS = 61_969_600  # the JAX reducer's payload bits per step over distilbert_base, rank 16
# exact DDP: every fp32 gradient of ResNet-50 (23,528,522) and of
# distilbert_base (66,955,010) once a step
EXACT_BITS = 752_912_704
BASELINE_BITS = 2_142_560_320
# the exact reducer's layouts on the main path and the collectives of each
# (25 MiB is torch DDP's default bucket cap)
EXACT_LAYOUTS = {
    "monolithic": ({}, 1),
    "bucketed": ({"bucket_bytes": 25 << 20}, 4),
    "chunked": ({"comm_chunks": 4}, 4),
    "ring": ({"comm_strategy": "ring"}, 1),
}
EXACT_PROFILE_STEPS = 1
TEXT_EVAL_BATCH = 64  # evaluate_text_classifier's batch
# Adam moves a parameter at most about lr a step (|m-hat| / sqrt(v-hat) is
# at most 1.0014 in two steps): the bound on two runs' difference where its
# gradient is zero in exact arithmetic, per step and lr
ADAM_NOISE_BOUND = 2.01
# GPT-2 small at vocabulary 1024 (gpt_lm's preset full): T 1024, global batch
# 16 (16,384 tokens a step), PowerSGD rank 4, 12 causal K5 launches a step
GPT_B, GPT_T, GPT_H, GPT_D, GPT_LAYERS = 16, 1024, 12, 64, 12
GPT_BITS = 25_575_424  # the JAX reducer's payload bits per step, rank 4
GPT_GROUPS = 4  # (1024, 768) x 2, (768, 768) x 48, (768, 3072) x 12, (3072, 768) x 12
# two fp32 steps of GPT-2 small, flash against einsum attention on the card:
# parameters and losses (both sum in fp32, K5's products in 3xTF32)
GPT_TOL = 1e-5
# gpt_generate at GPT-2's own vocabulary: batch 8, prompt 128, 32 new tokens
# (cut from 64 to make room for the bandwidth artifact's phase)
GEN_VOCAB, GEN_B, GEN_PROMPT, GEN_NEW = 50257, 8, 128, 32
# diloco_cifar10's preset full: ResNet-152 at global batch 512, H = 8 inner
# steps a round, PowerSGD rank 4 on the outer delta. The synthetic CIFAR-10
# set holds 4096 images, 8 global batches: one round an epoch, so two epochs
# under the cap of 16 steps an epoch are the two rounds
DILOCO_H, DILOCO_STEPS, DILOCO_ROUNDS = 8, 16, 2
# bandwidth_study's preset full (ResNet-152, global batch 256): a step
# configuration runs a warm-up, a recorded and STUDY_TIMED_STEPS timed steps,
# an avoidance row a warm-up, a recorded and STUDY_TIMED_ROUNDS timed rounds;
# the projection is for eight workers
STUDY_TIMED_STEPS, STUDY_TIMED_ROUNDS, STUDY_PROJECT_WORKERS = 3, 2, 8
STUDY_POWERSGD_ROWS = ("powersgd_r1", "powersgd_r2", "powersgd_r4")
# a decode step's logits against a full forward of the same prefix (the JAX
# package's own tolerance, test_decode_steps_match_full_forward): the cache's
# fp32 einsum against the forward's K5 and its GEMMs, in fp32
DECODE_TOL = 2e-4
# serve_gpt's preset full: GPT-2 small at vocabulary 1024, 8 slots, 32
# requests at 64 a second, each decoding 2 to 64 tokens (max_len 32 + 64)
SERVE_SLOTS, SERVE_REQUESTS, SERVE_RATE, SERVE_NEW, SERVE_MAX_LEN = 8, 32, 64.0, 64, 96
SERVE_BLOCK, SERVE_SPEC_K = 16, 4
# the dense slot cache of those 8 slots: 12 layers x K and V x (8, 96, 12, 64) fp32
SERVE_DENSE_KV_BYTES = 56_623_104
# eight prompts on one prefix of 32 tokens (two blocks), distinct 8-token
# suffixes, 16 new tokens each
SHARED_N, SHARED_PREFIX, SHARED_SUFFIX, SHARED_NEW = 8, 32, 8, 16
# tokens held across shapes (the engine at batch 8 against a sequential
# batch-1 reference; a suffix prefill against a full one): compared up to a
# request's first difference, which is allowed only where the reference's
# top-2 logit margin there is under SERVE_TIE * max|logit| (fp32); the
# expected count is 0. Same shapes are held bit for bit.
SERVE_TIE = 1e-4
SERVE_TICKS = 20  # decode ticks timed at 8 busy slots
# the checkpointed paths: ResNet-152 PowerSGD (powersgd_cifar10's preset
# full: batch 512, rank 4, the xla pipeline, K1) through
# resilient_train_loop, 3 epochs of 2 steps, the newest 2 checkpoints kept.
# Its runs: uninterrupted twice (6 + 6 steps), a crash on entry to epoch 2
# and its resume (4 + 2), a preemption after step 1 of epoch 1 and its
# resume (3 + 3), and a resume past a flipped bit in the newest step (2)
RESUME_EPOCHS, RESUME_STEPS, RESUME_KEEP = 3, 2, 2
RESUME_K1_STEPS = 26
# GPT-2 small of the serving shape (vocabulary 1024, 96 positions) trained
# in fp32 at batch 8, T 64, PowerSGD rank 4, 2 epochs of 2 steps (K5 causal
# forward and backward, K1), then hot-loaded by serve_gpt's preset full
HOT_B, HOT_T, HOT_EPOCHS, HOT_STEPS = 8, 64, 2, 2
# the model-parallel GPT entries at GPT-2 small widths, every mesh axis of
# size 1: (batch, T) of gpt_tp and gpt_sp, (batch, T, microbatches) of
# gpt_pp, (batch, T, local experts) of gpt_moe; 3 steps each. MoE's (T, E,
# C) dispatch and combine tensors: T = 16 * 256 = 4096 tokens, E = 8, C =
# 2 * k * 4096 / 8 = 1024 k, so 4096 * 8 * 1024 * 4 B = 134 MB each a layer
# at top-1 (268 MB at top-2)
MP_SIZES = {"tp": (16, 1024), "sp": (8, 1024), "pp": (16, 1024, 4), "moe": (16, 256, 8)}
MP_SIZES_SMALL = {"tp": (4, 32), "sp": (4, 32), "pp": (8, 32, 4), "moe": (8, 32, 8)}
MP_STEPS = 3
# the (B, T, H, D) of K5's launches there: a gpt_pp microbatch (16 / 4
# sequences) and a gpt_moe batch, each held against the plain version
MP_PP_HEADS, MP_MOE_HEADS = (4, 1024, 12, 64), (16, 256, 12, 64)
MOE_FACTOR = 2.0
# the MoE GPT's replicated parameters at rank 4: (1024, 768) the token
# table, (256, 768) the positions, (768, 8) the 12 routers, (768, 768) the
# 48 attention projections
MOE_GROUPS = 4
# a first step's loss and every gradient against the plain model's (flash
# against einsum attention, or the TP and sequence-parallel schedules'
# einsum against the flash kernel): fp32 sums in another order and K5's
# 3xTF32 products, relative to max(1, max|plain|) of each leaf. The key
# projections' biases have a gradient of 0 in exact arithmetic (a softmax
# ignores a shift of a row's scores): both sides hold the rounding of a sum
# over every token, up to 2.3e-9 on the H100. They are held to KEY_BIAS_TOL
# relative to max(1, max|plain|) of the same layer's query bias, a sum of
# the same kind that does not cancel (about 1e-3 at GPT-2 small's width):
# a key-gradient at fault reads of that order
MP_TOL = 1e-5
KEY_BIAS_TOL = 1e-7
# FSDP of exact_cifar10's preset full at world 1: one all-gather and one
# reduce-scatter of every leaf (2 x 752,912,704 bits) and the loss's 32
FSDP_BITS = 1_505_825_440
FSDP_CHUNKS = 4
# the ported options of ported entries (option_phases), OPT_STEPS steps
# each, the first untimed: ResNet-152 in bf16 on both pipelines (fp32
# parameters, gradients and wire: the fp32 bits, 36,249,536 + 32), GPT-2
# small with remat in fp32 and bf16 (K5's forward twice a layer a step)
# and under scan_layers (each stacked leaf one matrix, as the JAX reducer
# sees the scanned flax leaves: 13,302,784 bits in 6 shape groups, K1 on P
# stacks up to (1, 36864, 4)), and distilbert_base with remat
OPT_STEPS = 2
RESNET152_BITS = 36_249_536
SCAN_BITS, SCAN_GROUPS = 13_302_784, 6
# the telemetry core (telemetry_phases): powersgd_cifar10 at preset full for
# TELEMETRY_STEPS steps with the memory and health probe every
# TELEMETRY_EVERY steps (2 probes, each one diagnostic PowerSGD round: K1,
# or K2b, K3 and K4, once a shape group); the probe timed over
# TELEMETRY_PROBE_REPS calls
TELEMETRY_STEPS, TELEMETRY_EVERY, TELEMETRY_PROBE_REPS = 4, 2, 3
# the chaos plan and the guarded step (chaos_phases): ResNet-152 PowerSGD at
# powersgd_cifar10's preset full (batch 512, rank 4, the xla pipeline: K1
# once a shape group a step) through resilient_train_loop, 2 epochs of 2
# steps a run. The real steps (an injected step fault runs no step): clean
# 4; plan (a), a transient and a NaN retried, 4; plan (b), a bad and a
# short batch dropped, 2; one good step and a real NaN tried three times,
# 4; the oom fault, 0; ckpt_torn and ckpt_bitflip, each 4 and a resume of
# 2; the guarded step against the plain one in turns, CHAOS_TURNS each
CHAOS_EPOCHS, CHAOS_STEPS, CHAOS_TURNS = 2, 2, 11
CHAOS_K1_STEPS = 4 + 4 + 2 + 4 + 0 + 2 * (4 + 2) + 2 * CHAOS_TURNS
# the supervised launch: exact_cifar10 at preset full (ResNet-50, batch 256)
# for SUPERVISED_EPOCHS epochs of SUPERVISED_STEPS steps (16 is the whole
# synthetic epoch), once without faults and, beside it, once with proc_kill
# before epoch 1's second step in the first life and proc_preempt before its
# step 1 in the second (the emergency checkpoint after epoch 1's second
# step). main_path_fleet's training job runs the same command and must end
# on the unfaulted run's final checkpoint; its SLO-burn preemption lands
# about half a second after its first (audited, 2.7 s) step, and the 47
# steps after it (about 46 ms each on the H100) must outlast that
SUPERVISED_EPOCHS, SUPERVISED_STEPS = 3, 16
# the adaptive phases (adaptive_phases). main_path_adaptive: exact_cifar10
# --adaptive-comm at preset full (ResNet-50, batch 256, world 1) for 2
# epochs of ADAPTIVE_STEPS steps, a plan document ranking "compress" next to
# the baseline for NVLink4(H100), and a comm_stall of ADAPTIVE_STALL_S at
# step 2 (20 times the 0.05 s deadline floor): the deadline expires, the
# step is retried, epoch 0's verdict descends to "compress" (PowerSGD rank
# 4: K1 once a shape group a step of epoch 1). Then the carry run: 2 epochs
# of 3 steps, a scripted descent after epoch 0 (K1 in epoch 1), and the
# timed turns of the baseline rung's step: plain, with a no-op hook (the
# fence syncs), and guarded (the watchdog and CommDeadlineGuard(GuardedStep))
ADAPTIVE_STEPS, ADAPTIVE_STALL_S, ADAPTIVE_CARRY_STEPS, ADAPTIVE_TURNS = 4, 1.0, 3, 11
ADAPTIVE_LADDER = ["baseline", "compress", "compress-low-rank"]
# main_path_hierarchical: make_hierarchical_train_fn on ResNet-152 (batch
# 256) over a 1 x 1 grid, PowerSGD rank 4 across the outer group, sync_every
# HIER_H; for outer_async False and True: sync, sync, local, sync (K1 once a
# shape group a sync round), each round against the same round with K1's
# plain version from a copy of the state it started from. Reported beside it,
# unchecked: the K1 trajectory against the plain one over all the rounds,
# and the plain one against itself from parameters moved 1 ulp (the drift
# that training alone makes of a rounding-sized difference). HIER_H was cut
# from 4 to make room for the bandwidth artifact's phase
HIER_H, HIER_PLAN = 2, ("sync", "sync", "local", "sync")
# the live plane (live_phases): the supervising launcher of exact_cifar10
# --adaptive-comm at preset full (ResNet-50, batch 256, world 1) with a run
# dir, /metrics on an ephemeral port and --alert-restart-after 3, 2 epochs
# of LIVE_STEPS steps (>= 16: step_time_drift needs 10 steady steps, then 5
# drifted ones), the baseline in LIVE_CHUNKS fenced chunks (the throttle
# slows each chunk, not the step, and each chunk must stay inside its 0.05 s
# deadline floor). main_path_live: without faults, and the same launch
# without --run-dir and --metrics-port, the losses bit for bit.
# main_path_live_nudge: a comm_throttle on the grads from LIVE_THROTTLE_STEP
# to the end, sized from main_path_live's step p50 so that the step slows
# LIVE_SLOWDOWN times with each chunk's sleep at most LIVE_CHUNK_SLEEP_S:
# the drift alert, a nudge to compress, K1 once a shape group a step there.
# The nudged run's own clean steps have read 0.70 to 1.08 of that p50 on
# the H100, so at 2.2 the slowdown, which must reach 2, read 2.01 to 2.45.
# A chunk's window is its sleep plus its own time, up to 20 ms after the
# first step on the H100 (scripts/torch_live_deadline_bisect.py), more on a
# slower host: at 4 chunks and 35 ms a sleep the window came within the
# floor's last 15 ms and one expiry descended before the alert, so 8 chunks
# share the sleep, each at most 25 ms
LIVE_STEPS, LIVE_CHUNKS, LIVE_THROTTLE_STEP = 16, 8, 12
LIVE_SLOWDOWN, LIVE_CHUNK_SLEEP_S = 2.6, 0.025
LIVE_LADDER = ["baseline", "compress"]
# offline_phases reads what the telemetry and live phases left and launches
# no training process; the seconds predicted for it before its first run
OFFLINE_PREDICTED_S = 2.0
# main_path_report reads the two live run directories through
# scripts/torch_report.py and scripts/torch_gate.py and launches nothing; the
# seconds predicted for it before its first run. The keys of the JAX
# package's run report, which torch_report's must all carry; the Chrome
# trace's spans nest inside their parents up to SPAN_NEST_TOL_US (a span's
# stamp is its emission, a few microseconds after it closed)
REPORT_PREDICTED_S = 3.0
REPORT_KEYS = (
    "schema", "run_dir", "run_id", "world_size", "generated_unix", "n_events", "torn_lines", "startup_s", "ranks",
    "step_p50_s", "step_p95_s", "step_skew", "straggler_factor", "stragglers", "bandwidth", "critpath",
    "clock_skew_bound_s", "fabric_matrix", "compile", "comm_buckets", "hierarchy", "partitions", "mfu",
    "mfu_headline", "spans", "failures", "policy", "alerts", "data_drops", "recovery_latency_s", "recovery",
    "recovery_time_s", "slo", "kv_pool", "fleet", "memory", "fidelity", "fidelity_frontier",
)
SPAN_NEST_TOL_US = 1000.0
# the fleet control plane (fleet_phases), its three paths side by side on the
# one card. main_path_fleet: FLEET_CHIPS logical chips (LOCAL_RANK=0 in every
# job's environment) under a FleetScheduler; the serving pool (serve_gpt
# preset full from a request spool, SERVE_SLOTS slots, one request of its
# own), supervised_resume's training command and a crash-looper; once the
# pool has served and the training job has stepped, FLEET_FEED requests at
# FLEET_RATE a second (the first FLEET_BURST at once). The pool's own
# request fires the first slo_burn alert; the escalation needs
# FLEET_SUSTAIN alerts, so the preemption waits for the fed requests.
# main_path_autoscale: a ServingAutoscaler of 1 to STORM_MAX_WORKERS
# serve_gpt workers leasing STORM_CHIPS logical chips; once the first worker
# has served, a burst of STORM_BURST_S seconds at STORM_BURST_RATE requests
# a second (about 3x one worker's 28 a second: 933 tokens/s over 33 tokens
# a request), then, STORM_GAP_S after the burst (a new worker takes about 15
# s to serve, and the backlog drains after it), STORM_TRICKLE_S at
# STORM_TRICKLE_RATE; SLO STORM_SLO_S
FLEET_CHIPS, FLEET_FEED, FLEET_BURST, FLEET_RATE, FLEET_SUSTAIN = 2, 24, 4, 8.0, 2
STORM_CHIPS, STORM_MAX_WORKERS, STORM_SLO_S = 3, 3, 1.5
STORM_BURST_S, STORM_BURST_RATE, STORM_GAP_S, STORM_TRICKLE_S, STORM_TRICKLE_RATE = 8.0, 84.0, 20.0, 5.0, 9.0
# the seconds predicted for fleet_phases before its first run on the card
FLEET_PREDICTED_S = 110.0
# the host data plane (data_plane_phases). main_path_data_plane: the flagship
# (ResNet-152, batch 512, rank 4, the xla pipeline: K1 once a shape group a
# step) for DATA_PLANE_STEPS steps from the same seed under deterministic
# algorithms, in turns: (a) the numpy loader (iterate_batches) with
# prefetch=0, (b) the native loader with prefetch=2; then (b) again for
# DATA_PLANE_TRACE_STEPS steps under torch.profiler with steps 1 and 2
# recorded (the copies of batches 3 and 4 are staged in them); then the
# torn-batch check: TORN_BATCHES staged batches of the flagship's shape at
# each of TORN_DEPTHS, each behind a torch.cuda._sleep of TORN_SLEEP_CYCLES
# on the consumer's stream (about 1 ms at the H100's 1.98 GHz), cloned
# after it and read back against its source bit for bit
DATA_PLANE_STEPS, DATA_PLANE_TRACE_STEPS = 6, 5
TORN_BATCHES, TORN_DEPTHS, TORN_SLEEP_CYCLES = 64, (0, 1, 2), 2_000_000
# the seconds predicted for data_plane_phases before its first run on the card
DATA_PLANE_PREDICTED_S = 45.0
# the accuracy study (accuracy_study_phase): scripts/torch_accuracy_study.py
# with ACCURACY_ARGS on the card in a process of its own, beside section 4
# and the fleet (it times nothing compared): both arms' bits a step at 8
# workers and their ratio as in the JAX study's record, each arm's best
# accuracy within ACCURACY_CEILING_PTS of the Bayes ceiling, the arms' delta
# within ACCURACY_DELTA_PTS. Before it, in this process, K5's forward and
# backward (fp32) at ACCURACY_K5_SHAPES, the study's DistilBERT tiers (B, T,
# H, D), with the padding of the first batch of each tier's IMDb draw
ACCURACY_ARGS = ("--task", "cifar", "--seeds", "1", "--patience", "2", "--max-epochs", "6")
ACCURACY_BITS = {"exact": 22_446_944, "powersgd_r4": 1_243_104}
ACCURACY_RATIO, ACCURACY_CEILING_PTS, ACCURACY_DELTA_PTS = 18.1, 5.0, 3.0
ACCURACY_K5_SHAPES = {"imdb": (128, 64, 4, 8), "imdb_wide": (128, 32, 4, 64)}
ACCURACY_TIMEOUT_S = 600
# the seconds predicted for the accuracy study's process before its first run on the card
ACCURACY_PREDICTED_S = 30.0
# the bandwidth artifact (bandwidth_artifact_phase): its structure from
# bandwidth_study at preset small at world 1 (1 timed step a row, 1 timed
# round), projected for ARTIFACT_WORKERS; its chip phase at ARTIFACT_STEPS
# timed steps a row and ARTIFACT_FULL_STEPS flagship steps a dtype; each
# projected step within ARTIFACT_REL_TOL of the compute time plus the ring
# model's time of the row's bits
ARTIFACT_WORKERS, ARTIFACT_STEPS, ARTIFACT_FULL_STEPS, ARTIFACT_REL_TOL = 8, 3, 2, 1e-9
# the seconds predicted for bandwidth_artifact_phase before its first run on the card
ARTIFACT_PREDICTED_S = 15.0
# the supervised workers' deterministic algorithms, as chaos_guarded's
# deterministic_algorithms() sets them in process; any sitecustomize the
# interpreter had is run after it. With CHIP_SMOKE_LAUNCHES set, a process
# that ran the port's Gram-Schmidt wrapper appends its launch count to that
# file when it exits (the count of a supervised worker, whose launches the
# parent cannot see)
SUPERVISED_SITECUSTOMIZE = """import atexit, json, os, sys
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False


def _launches():
    out = os.environ.get("CHIP_SMOKE_LAUNCHES")
    gs = sys.modules.get("network_distributed_pytorch_tpu_torch.ops.gram_schmidt")
    if out and gs is not None:
        with open(out, "a") as f:
            f.write(json.dumps({"pid": os.getpid(), "gram_schmidt": gs.KERNEL.launches}) + "\\n")


atexit.register(_launches)
_here = os.path.dirname(os.path.abspath(__file__))
for _p in sys.path:
    _f = os.path.join(_p or ".", "sitecustomize.py")
    if os.path.abspath(_p or ".") != _here and os.path.isfile(_f):
        exec(compile(open(_f).read(), _f, "exec"), {"__name__": "sitecustomize", "__file__": _f})
        break
"""


def fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: {msg}\n")
    sys.exit(1)


_EMIT_LOCK = threading.Lock()  # fleet_phases runs in a thread of its own
_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since this module was imported (where the smoke's time goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()


def in_background(fn, *args):
    """Run ``fn(*args)`` in a thread of its own and return its future
    (``.result()`` re-raises what ``fn`` raised, a ``fail`` too)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return future


def cuda_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, by CUDA
    events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, part=None, reps=10):
    """Device time of the kernels whose name holds ``part`` (every kernel
    where ``part`` is None) in one call of ``fn()``, by ``torch.profiler``
    over ``reps`` calls after three warm-up calls; None where the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and (part is None or part in e.key)
    )
    return us / 1e3 / reps if us > 0 else None


def bound(nbytes, ops, flops=FP32_FLOPS):
    """The least time for ``nbytes`` of device memory traffic and ``ops``
    fp32 operations at ``flops`` per second: the larger of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gs_ops(g, n, r):
    # per column i: norm 2n, scale n, then 4n for each of the r-i-1 later columns
    return g * (3 * n * r + 4 * n * r * (r - 1) // 2)


def gs_bound(shapes):
    """Bytes (one read and one write of every P) and fp32 operations of the
    Gram-Schmidt of every (g, n, r) in ``shapes``."""
    return bound(sum(2 * g * n * r * 4 for g, n, r in shapes), sum(gs_ops(*s) for s in shapes))


def fused_bounds(shapes):
    """The least time of each fused kernel over every (g, n, m, r) in
    ``shapes``: fp32 bytes with each input read once and each output
    written once, and fp32 operations (a multiply-add counts 2)."""
    work = {}

    def add(name, nbytes, ops):
        b, o = work.get(name, (0, 0))
        work[name] = (b + nbytes, o + ops)

    for g, n, m, r in shapes:
        nm, nr, mr = g * n * m, g * n * r, g * m * r
        add("ef_compress", 4 * (3 * nm + mr + nr), nm + 2 * nm * r)  # G, E, Q in; M, P out
        add("compress", 4 * (nm + mr + nr), 2 * nm * r)  # M, Q in; P out
        add("orthogonalize_project", 4 * (nm + 2 * nr + mr), gs_ops(g, n, r) + 2 * nm * r)  # P, M in; P-hat, Q out
        add("decompress_residual", 4 * (3 * nm + nr + mr), 2 * nm * r + nm)  # P, Q, M in; out, mem out
    return {name: (bound(*w), w[0]) for name, w in work.items()}


def attention_bound(
    b, t, h, d, launches, keys=None, flops=FP32_AS_3XTF32_FLOPS, elem_bytes=4, causal=False
):
    """The least time of ``launches`` flash-attention forwards over
    (B*H, T, D) heads of ``elem_bytes`` per element (4: fp32, 2: bf16),
    ``keys`` of whose B T keys the mask lets through (None: every key). A
    padded key adds nothing to the function's result, so only the real
    keys' rows of k and v are counted: bytes are q read and out written
    once, k and v read once for each real key, the fp32 (B, T) mask read
    and the fp32 lse written once. Operations are 4 D (q.k and p.v) for each
    (query, key) pair the function attends: every query to every real key,
    or, ``causal``, each query to the keys at or before it, T (T + 1) / 2
    pairs a head (every key real); at ``flops`` per second."""
    keys = b * t if keys is None else keys
    if causal and keys != b * t:
        raise ValueError("the causal bound counts heads whose every key is real")
    nbytes = elem_bytes * (2 * b * h * t * d + 2 * h * d * keys) + 4 * (b * t + b * h * t)
    pairs = b * h * t * (t + 1) // 2 if causal else h * t * keys
    return bound(launches * nbytes, launches * 4 * d * pairs, flops)


def attention_bwd_work(b, t, h, d, launches, keys=None, elem_bytes=4, causal=False):
    """Bytes and operations of ``launches`` flash-attention backwards over
    (B*H, T, D) heads of ``elem_bytes`` per element, ``keys`` real keys as
    in ``attention_bound``. Bytes: q, out and dO read and dq, dk and dv
    written once (dk and dv for every key: a padded key's gradient is
    written as 0), k and v read once for each real key, the fp32 mask and
    lse read once. Operations: the five products S = q.k, dP = dO.v,
    dV += p.dO, dQ += dS.k and dK += dS.q, 2 D each for every (query, key)
    pair the function attends."""
    keys = b * t if keys is None else keys
    if causal and keys != b * t:
        raise ValueError("the causal bound counts heads whose every key is real")
    nbytes = elem_bytes * (6 * b * h * t * d + 2 * h * d * keys) + 4 * (b * t + b * h * t)
    pairs = b * h * t * (t + 1) // 2 if causal else h * t * keys
    return launches * nbytes, launches * 10 * d * pairs


def attention_bwd_bound(b, t, h, d, launches, keys=None, flops=FP32_AS_3XTF32_FLOPS, elem_bytes=4, causal=False):
    """The least time of ``attention_bwd_work`` at ``flops`` per second."""
    return bound(*attention_bwd_work(b, t, h, d, launches, keys, elem_bytes, causal), flops)


def attention_bounds(b, t, h, d, launches, keys=None):
    """``attention_bound`` at 3xTF32 (the peak K5's products run at) and at
    the fp32 SIMT peak, by name."""
    (ms, by), (simt_ms, simt_by) = (
        attention_bound(b, t, h, d, launches, keys, flops) for flops in (FP32_AS_3XTF32_FLOPS, FP32_FLOPS)
    )
    return {
        "bound_ms": ms, "bound_by": by, "bound_ops_peak": "3xTF32 tensor cores, 495/3 TFLOP/s",
        "bound_ms_fp32_simt": simt_ms, "bound_by_fp32_simt": simt_by,
    }


def attention_tiles(mask, t, h, q_rows=128, keys=64):
    """The (head, block of ``q_rows`` q rows, tile of ``keys`` keys) triples
    of one non-causal K5 launch over the (B, T) ``mask``: all of them, and
    those it skips because no key of the tile is valid."""
    import torch

    n_tiles, n_blocks = -(-t // keys), -(-t // q_rows)
    padded = torch.full((mask.shape[0], n_tiles * keys), -1e30, device=mask.device)
    padded[:, :t] = mask
    empty = (padded.view(mask.shape[0], n_tiles, keys) <= -1e29).all(-1)  # (B, tiles)
    return h * n_blocks * mask.shape[0] * n_tiles, h * n_blocks * int(empty.sum())


def check_flash_attention(fa, dev, gen, imdb_mask):
    """K5 against its plain version on the same inputs, case by case; fails
    past ATTN_TOL or where a fully masked row is not exactly 0 / 1e30; then,
    on the IMDb-padding case, fails unless NaN in K and V of every 64-key
    tile that holds only padding leaves out and lse bitwise unchanged.
    ``imdb_mask`` is the (16, 256) additive mask of the first synthetic-IMDb
    batch. Returns the errors and the full-width inputs."""
    import torch

    f32_min = torch.finfo(torch.float32).min
    full = (IMDB_B, IMDB_T, IMDB_H, IMDB_D)
    rows_masked = torch.zeros((4, IMDB_T))
    rows_masked[0, :] = -1e30
    rows_masked[1, :] = f32_min
    rows_masked[2, 100:] = -1e30
    # real keys only in the last tile: 1 to 64 of them at the end of each row
    left = torch.full((IMDB_B, IMDB_T), f32_min)
    # one real key in the middle of tile i % 4 of row i, the rest padding
    lone = torch.full((IMDB_B, IMDB_T), f32_min)
    for i in range(IMDB_B):
        left[i, IMDB_T - 1 - (i * 13) % 64 :] = 0.0
        lone[i, 64 * (i % 4) + 30] = 0.0
    t100 = torch.zeros((IMDB_B, 100))
    t100[:, 70:] = f32_min
    t100[1::2, 20:] = f32_min
    cases = {  # (b, t, h, d), mask, causal, block_q, block_k of the plain version
        "imdb_padding": (full, imdb_mask, False, 128, 128),
        "no_mask": (full, torch.zeros((IMDB_B, IMDB_T)), False, 128, 128),
        "causal": (full, imdb_mask, True, 128, 128),
        "fully_masked_rows": ((4, IMDB_T, IMDB_H, IMDB_D), rows_masked, False, 128, 128),
        "d128": ((2, IMDB_T, 4, 128), imdb_mask[:2], True, 128, 128),
        "block_q64_block_k128": (full, imdb_mask, True, 64, 128),
        "left_padding": (full, left, False, 128, 128),
        "lone_middle_key": (full, lone, False, 128, 128),
        "t100": ((IMDB_B, 100, IMDB_H, IMDB_D), t100, False, 100, 100),
    }
    report, kept = {}, None
    for name, ((b, t, h, d), mask, causal, bq, bk) in cases.items():
        q, k, v = (torch.randn((b * h, t, d), generator=gen).to(dev) for _ in range(3))
        mask = mask.to(dev)
        out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, bq, bk, d**-0.5)
        want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, causal, bq, bk, d**-0.5)
        torch.cuda.synchronize()
        err = (out - want_out).abs().max().item()
        lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
        tol = ATTN_TOL * max(1.0, want_out.abs().max().item())
        if not (math.isfinite(err) and err <= tol and math.isfinite(lse_err) and lse_err <= ATTN_TOL):
            fail(f"flash_attention {name}: max |kernel - plain| out {err} (tol {tol}), lse {lse_err} (tol {ATTN_TOL})")
        empty = (mask <= -1e29).all(dim=1).repeat_interleave(h)  # fully masked heads
        if empty.any():
            for o, l, who in ((out, lse, "kernel"), (want_out, want_lse, "plain")):
                if not (bool((o[empty] == 0).all()) and bool((l[empty] == 1e30).all())):
                    fail(f"flash_attention {name}: {who}'s fully masked rows are not 0 / 1e30")
        report[name] = {
            "shape": [b, t, h, d], "causal": causal, "plain_blocks": [bq, bk], "max_abs_err": err,
            "lse_max_rel_err": lse_err, "fully_masked_heads": int(empty.sum().item()),
        }
        if name == "imdb_padding":
            kept = (q, k, v, mask)
    # NaN in K and V of every all-padding tile of the IMDb case
    q, k, v, mask = kept
    empty = (mask.view(IMDB_B, IMDB_T // 64, 64) <= -1e29).all(-1).repeat_interleave(IMDB_H, 0)
    poison = empty.repeat_interleave(64, 1)[..., None]  # (BH, T, 1)
    clean = fa.flash_attention_fwd(q, k, v, mask, False, 128, 128, IMDB_D**-0.5)
    dirty = fa.flash_attention_fwd(
        q, *(torch.where(poison, float("nan"), x) for x in (k, v)), mask, False, 128, 128, IMDB_D**-0.5
    )
    torch.cuda.synchronize()
    if not (torch.equal(clean[0], dirty[0]) and torch.equal(clean[1], dirty[1])):
        fail("flash_attention: NaN in the all-padding tiles of K and V changed out or lse")
    report["imdb_padding"]["nan_poisoned_tiles"] = int(empty.sum())
    report["imdb_padding"]["nan_poisoned_bitwise_equal"] = True
    return report, kept


def bf16_ulp(x):
    """The spacing of bf16 at ``|x|`` (8 significant bits)."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp_min(-133))


def check_flash_attention_bf16(fa, dev, gen, imdb_mask):
    """K5 on bf16 q, k, v (and causal in fp32 at GPT's shape) against its
    plain version on the same inputs. A bf16 out: both sides sum in fp32 and
    round once, so each element within ATTN_TOL * max(1, max|plain|) plus 1
    bf16 ulp of the element; lse (fp32) within ATTN_TOL relative. Then NaN in
    the bf16 K and V of every all-padding tile must leave out and lse
    bitwise unchanged. Returns the errors and the inputs of the GPT cases."""
    import torch

    gpt = (GPT_B, GPT_T, GPT_H, GPT_D)
    full = (IMDB_B, IMDB_T, IMDB_H, IMDB_D)
    cases = {  # (b, t, h, d), mask or None (no mask), causal, dtype
        "imdb_padding_bf16": (full, imdb_mask, False, torch.bfloat16),
        "gpt_causal_bf16": (gpt, None, True, torch.bfloat16),
        "gpt_causal_fp32": (gpt, None, True, torch.float32),
        "t100_d40_bf16": ((IMDB_B, 100, 4, 40), imdb_mask[:, :100], False, torch.bfloat16),
        "d128_causal_bf16": ((2, IMDB_T, 4, 128), imdb_mask[:2], True, torch.bfloat16),
        # the model-parallel paths' own shapes: a gpt_pp microbatch, a gpt_moe batch
        "pp_microbatch_causal_fp32": (MP_PP_HEADS, None, True, torch.float32),
        "moe_causal_fp32": (MP_MOE_HEADS, None, True, torch.float32),
        "moe_causal_bf16": (MP_MOE_HEADS, None, True, torch.bfloat16),
    }
    report, kept = {}, {}
    for name, ((b, t, h, d), mask, causal, dtype) in cases.items():
        q, k, v = (torch.randn((b * h, t, d), generator=gen).to(dev).to(dtype) for _ in range(3))
        mask = torch.zeros((b, t)) if mask is None else mask
        mask = mask.to(dev)
        bq = 128 if t % 128 == 0 else t
        out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, bq, bq, d**-0.5)
        want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, causal, bq, bq, d**-0.5)
        torch.cuda.synchronize()
        if out.dtype != dtype or lse.dtype != torch.float32:
            fail(f"flash_attention {name}: out {out.dtype}, lse {lse.dtype}")
        err = (out.float() - want_out.float()).abs()
        tol = ATTN_TOL * max(1.0, want_out.float().abs().max().item())
        slack = err - tol - (bf16_ulp(want_out) if dtype == torch.bfloat16 else 0.0)
        lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
        if not (bool(torch.isfinite(err).all()) and slack.max().item() <= 0 and lse_err <= ATTN_TOL):
            fail(
                f"flash_attention {name}: max |kernel - plain| out {err.max().item()} (tol {tol}"
                f"{' + 1 bf16 ulp' if dtype == torch.bfloat16 else ''}), lse {lse_err} (tol {ATTN_TOL})"
            )
        report[name] = {
            "shape": [b, t, h, d], "causal": causal, "dtype": str(dtype).rsplit(".", 1)[-1],
            "max_abs_err": err.max().item(), "lse_max_rel_err": lse_err,
            "elements_differing": float((out != want_out).float().mean().item()),
            # at most 1: the bf16 rounding's share of the error, past the fp32 tolerance
            "max_err_past_fp32_tol_in_bf16_ulps": (
                ((err - tol).clamp_min(0) / bf16_ulp(want_out)).max().item() if dtype == torch.bfloat16 else None
            ),
        }
        if name == "imdb_padding_bf16":
            empty = (mask.view(b, t // 64, 64) <= -1e29).all(-1).repeat_interleave(h, 0)
            poison = empty.repeat_interleave(64, 1)[..., None]
            dirty = fa.flash_attention_fwd(
                q, *(torch.where(poison, float("nan"), x) for x in (k, v)), mask, False, 128, 128, d**-0.5
            )
            torch.cuda.synchronize()
            if not (torch.equal(out, dirty[0]) and torch.equal(lse, dirty[1])):
                fail("flash_attention bf16: NaN in the all-padding tiles of K and V changed out or lse")
            report[name]["nan_poisoned_tiles"] = int(empty.sum())
            report[name]["nan_poisoned_bitwise_equal"] = True
            kept["imdb_bf16"] = (q, k, v, mask)
        if name.startswith("gpt_"):
            kept[name] = (q, k, v, mask)
    return report, kept


def check_flash_attention_bwd(fa, dev, gen, imdb_mask):
    """K5's backward kernel against its plain version (``flash_attention_bwd``)
    on the same inputs, the forward kernel's own out and lse and the same
    cotangent, in fp32 and bf16, case by case. Each gradient within
    ATTN_TOL * max(1, max|plain|), a bf16 one plus 1 bf16 ulp of the element
    (both sides sum in fp32 and round once); the mask's gradient (fp32 in
    both) within the fp32 bound. Fails unless a second call gives the same
    bits, unless the fully masked heads' gradients are exactly 0, and,
    on the IMDb padding, unless NaN in K and V of every all-padding 64-key
    tile leaves dq and the real keys' dk and dv bitwise unchanged with every
    padded key's dk and dv exactly 0. Returns the errors, the largest per
    dtype, and the GPT-2 cases' inputs."""
    import torch

    f32_min = torch.finfo(torch.float32).min
    full = (IMDB_B, IMDB_T, IMDB_H, IMDB_D)
    rows_masked = torch.zeros((4, IMDB_T))
    rows_masked[0, :] = -1e30
    rows_masked[1, :] = f32_min
    rows_masked[2, 100:] = -1e30
    # a row with a single real key has dq = dk = 0 exactly, and both fp32
    # versions return their rounding noise there, the plain version's own of
    # the order of the tolerance: so every row here has two real keys or
    # more. Left padding: 2 to 64 keys at the end of each row; two lone keys,
    # one in tile i % 3 and one in the last tile, each alone in its tile
    left = torch.full((IMDB_B, IMDB_T), f32_min)
    lone = torch.full((IMDB_B, IMDB_T), f32_min)
    for i in range(IMDB_B):
        left[i, IMDB_T - 2 - (i * 13) % 63 :] = 0.0
        lone[i, 64 * (i % 3) + 30] = 0.0
        lone[i, 192 + 30] = 0.0
    t100 = torch.zeros((IMDB_B, 100))
    t100[:, 70:] = f32_min
    t100[1::2, 20:] = f32_min
    cases = {  # (b, t, h, d), mask (None: no mask), causal, need_dmask
        "imdb_padding": (full, imdb_mask, False, False),
        "no_mask": (full, None, False, False),
        "causal": (full, imdb_mask, True, False),
        "fully_masked_rows": ((4, IMDB_T, IMDB_H, IMDB_D), rows_masked, False, False),
        "left_padding": (full, left, False, False),
        "lone_middle_keys": (full, lone, False, False),
        "t100_d40": ((IMDB_B, 100, 4, 40), t100, False, False),
        "d128_causal": ((2, IMDB_T, 4, 128), imdb_mask[:2], True, False),
        "gpt_causal": ((GPT_B, GPT_T, GPT_H, GPT_D), None, True, False),
        "dmask": ((4, IMDB_T, IMDB_H, IMDB_D), imdb_mask[:4], False, True),
        "pp_microbatch_causal": (MP_PP_HEADS, None, True, False),
        "moe_causal": (MP_MOE_HEADS, None, True, False),
    }
    report, worst, kept = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).rsplit(".", 1)[-1]
        for name, ((b, t, h, d), mask, causal, need_dmask) in cases.items():
            q, k, v, do = (torch.randn((b * h, t, d), generator=gen).to(dev).to(dtype) for _ in range(4))
            mask = (torch.zeros((b, t)) if mask is None else mask).to(dev)
            scale = d**-0.5
            block = 128 if t % 128 == 0 else t
            out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, block, block, scale)
            got = fa.flash_attention_vjp(q, k, v, mask, out, lse, do, causal, block, scale, need_dmask)
            again = fa.flash_attention_vjp(q, k, v, mask, out, lse, do, causal, block, scale, need_dmask)
            want = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, causal, block, scale, need_dmask)
            torch.cuda.synchronize()
            errs = {}
            for grad, g, a, w in zip(("dq", "dk", "dv", "dmask"), got, again, want):
                if w is None:
                    continue
                if g.dtype != w.dtype or not torch.equal(g, a):
                    fail(f"flash_attention backward {tag} {name}: {grad} is {g.dtype} or a second call changed its bits")
                err = (g.float() - w.float()).abs()
                tol = ATTN_TOL * max(1.0, w.float().abs().max().item())
                ulp = bf16_ulp(w) if w.dtype == torch.bfloat16 else 0.0
                if not (bool(torch.isfinite(err).all()) and (err - tol - ulp).max().item() <= 0):
                    fail(
                        f"flash_attention backward {tag} {name}: max |kernel - plain| of {grad} {err.max().item()}"
                        f" (tol {tol}{' + 1 bf16 ulp' if w.dtype == torch.bfloat16 else ''})"
                    )
                errs[grad] = err.max().item()
                worst[tag] = max(worst.get(tag, 0.0), errs[grad])
            empty = (mask <= -1e29).all(dim=1).repeat_interleave(h)
            if empty.any() and not all(bool((g[empty] == 0).all()) for g in got[:3]):
                fail(f"flash_attention backward {tag} {name}: a fully masked head's gradient is not 0")
            report[f"{name}_{tag}"] = {
                "shape": [b, t, h, d], "causal": causal, "need_dmask": need_dmask, "max_abs_err": errs,
                "fully_masked_heads": int(empty.sum().item()), "second_call_bitwise_equal": True,
            }
            if name == "imdb_padding":
                tiles = (mask.view(b, t // 64, 64) <= -1e29).all(-1).repeat_interleave(h, 0)
                poison = tiles.repeat_interleave(64, 1)[..., None]
                dirty = fa.flash_attention_vjp(
                    q, *(torch.where(poison, float("nan"), x) for x in (k, v)), mask, out, lse, do, False, block, scale,
                    False,
                )
                torch.cuda.synchronize()
                real = (mask > -1e29).repeat_interleave(h, 0)  # (BH, T)
                if not (
                    torch.equal(dirty[0], got[0])
                    and all(torch.equal(x[real], y[real]) for x, y in zip(dirty[1:3], got[1:3]))
                    and all(bool((x[~real] == 0).all()) for x in (*dirty[1:3], *got[1:3]))
                ):
                    fail(f"flash_attention backward {tag}: NaN in the all-padding tiles changed a gradient")
                report[f"{name}_{tag}"].update(nan_poisoned_tiles=int(tiles.sum()), nan_poisoned_bitwise_equal=True)
            if name == "gpt_causal":
                kept[tag] = (q, k, v, mask, out, lse, do)
    return report, worst, kept


def check_fused_kernels(ps, gs, shapes, dev, gen, keep):
    """Each fused kernel against its plain version on the same inputs at
    every (g, n, m, r) in ``shapes``; fails past the tolerances. Returns the
    errors and K3's route per shape, and the inputs of the shapes in
    ``keep``. Each kernel's inputs are its plain predecessor's outputs. Fails
    unless K3's P-hat is K1's (``gs.gram_schmidt``) bit for bit, and unless a
    second launch of K2a, K2b and K3 on the same inputs gives the first's
    bits."""
    import torch

    report, kept = {}, {}
    for shape in shapes:
        g, n, m, r = shape
        x = {
            "grads": torch.randn((g, n, m), generator=gen).to(dev),
            "resid": torch.randn((g, n, m), generator=gen).to(dev),
            "q": torch.randn((g, m, r), generator=gen).to(dev),
        }
        got = {}
        got["m"], got["p"] = ps.fused_ef_compress(x["grads"], x["q"], x["resid"])
        x["m"], x["p"] = ps.ef_compress_reference(x["grads"], x["q"], x["resid"])
        got["p2"] = ps.fused_ef_compress(x["m"], x["q"])[1]
        want = {"m": x["m"], "p": x["p"], "p2": ps.compress_reference(x["m"], x["q"])}
        got["phat"], got["qn"] = ps.fused_orthogonalize_project(x["p"], x["m"])
        route = ps.ORTHOGONALIZE_PROJECT.last_route
        x["phat"], x["qn"] = ps.orthogonalize_project_reference(x["p"], x["m"])
        want["phat"], want["qn"] = x["phat"], x["qn"]
        got["out"], got["mem"] = ps.fused_decompress_residual(x["phat"], x["qn"], x["m"])
        want["out"], want["mem"] = ps.decompress_residual_reference(x["phat"], x["qn"], x["m"])
        k1_phat = gs.gram_schmidt(x["p"])
        again = {}
        again["m"], again["p"] = ps.fused_ef_compress(x["grads"], x["q"], x["resid"])
        again["p2"] = ps.fused_ef_compress(x["m"], x["q"])[1]
        again["phat"], again["qn"] = ps.fused_orthogonalize_project(x["p"], x["m"])
        torch.cuda.synchronize()
        if not torch.equal(got["m"], want["m"]):
            fail(f"ef_compress {shape}: M is not bitwise G + E")
        if not torch.equal(got["phat"], k1_phat):
            fail(f"orthogonalize_project {shape} ({route}): P-hat is not K1's bit for bit")
        for key, value in again.items():
            if not torch.equal(value, got[key]):
                fail(f"fused kernels {shape}: a second launch changed the bits of {key}")
        errs = {}
        for key in ("p", "p2", "phat", "qn", "out", "mem"):
            err = (got[key] - want[key]).abs().max().item()
            tol = FUSED_TOL if key == "phat" else FUSED_TOL * max(1.0, want[key].abs().max().item())
            if not math.isfinite(err) or err > tol:
                fail(f"fused kernels {shape}: max |kernel - plain| of {key} = {err} > {tol}")
            errs[key] = err
        report[str(shape)] = {
            "route": route, "phat_equals_k1": True, "second_launch_bitwise_equal": True,
            "ef_compress": {"m": 0.0, "p": errs["p"]},
            "compress": {"p": errs["p2"]},
            "orthogonalize_project": {"phat": errs["phat"], "q": errs["qn"]},
            "decompress_residual": {"out": errs["out"], "mem": errs["mem"]},
        }
        if shape in keep:
            kept[shape] = x
    return report, kept


def profile_main_path(
    dev, experiment, cfg, arrays, kernels, steps=PROFILE_STEPS, build=None, batches=None, units=None
):
    """Where a main-path step's time goes: ``torch.profiler`` over ``steps``
    steps of ``experiment``'s full preset with ``cfg`` on the data
    ``arrays`` (or the ``1 + steps`` global ``batches`` given, or the
    ``1 + steps`` inputs ``units(dev)`` gives, already on the card: a
    DiLoCo round's list of batches) through a one-rank NCCL group, after one
    warm-up step; ``build(group)`` makes the model, step and state where
    ``experiment.build`` does not take a group or takes more. ``kernels``
    maps each port kernel to a part of its device function's name. NCCL's
    kernels are summed apart. Device numbers are None where the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    group = initialize_distributed(DistributedConfig(), dev)
    try:
        model, step, state = (build or (lambda g: experiment.build(cfg, "full", dev, g)))(group)
        batches = units(dev) if units is not None else [
            tuple(torch.from_numpy(a).to(dev) for a in b)
            for b in (batches or accumulated_batches(arrays, cfg, 1 + steps)(0))
        ]
        state, loss = step(state, batches[0])
        loss.sum().item()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[1:]:
                state, loss = step(state, b)
                loss.sum().item()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        del model, step, state
    finally:
        shutdown_distributed()
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / steps
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    seen = busy_ms > 0
    per_kernel = {}
    for name, part in kernels.items():
        evs = [e for e in device if part in e.key]
        total_us, count = sum(e.self_device_time_total for e in evs), sum(e.count for e in evs)
        per_kernel[name] = {
            "launches_per_step": count / steps,
            "device_ms_per_step": total_us / 1e3 / steps if seen else None,
            "device_us_per_launch": total_us / max(count, 1) if seen else None,
        }
    nccl = [e for e in device if "nccl" in e.key.lower()]
    return {
        "phase": "profile", "experiment": experiment.__name__.rsplit(".", 1)[-1],
        "compress_impl": cfg.compress_impl, "steps": steps,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms if seen else None,
        "device_idle_share": 1 - busy_ms / wall_ms if seen else None,
        "kernels": per_kernel,
        "nccl_ms_per_step": sum(e.self_device_time_total for e in nccl) / 1e3 / steps if seen else None,
        "nccl_kernels": [
            {"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps, "calls_per_step": e.count / steps}
            for e in nccl
        ],
        "top_kernels": [
            {
                "name": e.key[:90],
                "ms_per_step": e.self_device_time_total / 1e3 / steps,
                "calls_per_step": e.count / steps,
            }
            for e in top
        ],
    }


def main_path_record(name, result, cfg, peak, model="resnet152"):
    """The ``main_path`` line of one run of ``powersgd_cifar10.run`` or
    ``exact_cifar10.run`` (``model``); fails on a non-finite loss."""
    import statistics

    losses = result["losses"]
    if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{name} losses {losses}")
    timed_ms = result["device_time_ms"][WARMUP_STEPS:]
    p50_ms = statistics.median(timed_ms)
    return {
        "phase": name, "model": model, "stem": "imagenet", "width": 64,
        "global_batch": cfg.global_batch_size, "world_size": result["num_devices"], "losses": losses,
        "timed_steps": len(timed_ms), "step_device_ms": timed_ms,
        "step_device_ms_p50": p50_ms,
        "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
        "images_per_s": cfg.global_batch_size / (p50_ms / 1e3),
        "peak_memory_bytes": peak, "bits_per_step": result["bits_per_step"],
    }


def reference_logits(gpt_model, model, prompt, tokens, max_len):
    """The sequential reference's logits before each of ``tokens``:
    ``gpt_prefill`` of the prompt at ``max_len``, then ``gpt_decode_step``
    at batch 1 fed ``tokens[:-1]`` (teacher forcing: up to a first
    difference, the reference's own tokens)."""
    import torch

    dev = model.wte.weight.device
    with torch.no_grad():
        logits, cache = gpt_model.gpt_prefill(model, torch.tensor([prompt], device=dev), max_len)
        rows = [logits[0]]
        for i, tok in enumerate(tokens[:-1]):
            logits, cache = gpt_model.gpt_decode_step(model, cache, torch.tensor([tok], device=dev), len(prompt) + i)
            rows.append(logits[0])
        return torch.stack(rows)


def near_tie(row):
    """``(margin, max|logit|)`` of one reference logit row: the top-2 margin
    and the scale the near-tie class measures it against."""
    top2 = row.topk(2).values
    return float(top2[0] - top2[1]), float(row.abs().max())


def tokens_against_reference(gpt_model, model, requests, max_len, name):
    """Each request's tokens against the sequential reference, up to its
    first difference; fails on a difference outside the near-tie class.
    Returns the differences found (each with its margin) and the tokens
    compared."""
    diffs, compared = [], 0
    for r in requests:
        ref = reference_logits(gpt_model, model, r.prompt, r.tokens, max_len)
        want = ref.argmax(-1).tolist()
        for i, tok in enumerate(r.tokens):
            compared += 1
            if want[i] != tok:
                margin, scale = near_tie(ref[i])
                diffs.append({"request": r.request_id, "token": i, "margin": margin, "max_abs_logit": scale})
                if not margin < SERVE_TIE * scale:
                    fail(f"{name}: {r.request_id} token {i} is {tok}, the reference's {want[i]}, margin {margin} >= {SERVE_TIE} x {scale}")
                break
    return diffs, compared


def tokens_against_each_other(gpt_model, model, got, want, max_len, name):
    """Requests ``got`` against the same requests ``want`` (run another
    way), up to each first difference, which must fall in the near-tie
    class of the sequential reference at that position."""
    diffs = []
    for a, b in zip(got, want):
        i = next((j for j, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y), None)
        if i is None:
            if len(a.tokens) != len(b.tokens):
                fail(f"{name}: {a.request_id} has {len(a.tokens)} tokens, {len(b.tokens)} the other way")
            continue
        margin, scale = near_tie(reference_logits(gpt_model, model, b.prompt, b.tokens[: i + 1], max_len)[i])
        diffs.append({"request": a.request_id, "token": i, "margin": margin, "max_abs_logit": scale})
        if not margin < SERVE_TIE * scale:
            fail(f"{name}: {a.request_id} differs at token {i} with margin {margin} >= {SERVE_TIE} x {scale}")
    return diffs


def profile_decode_tick(engine, requests):
    """``SERVE_TICKS`` decode ticks of ``engine`` with every slot busy, timed
    by the host clock (each ends in the tick's read of its tokens), then
    one more under ``torch.profiler``: its kernel launches, copies, busy
    time, idle share and the names of its kernels. Fails where a kernel of
    the port (flash attention, Gram-Schmidt) runs in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for r in requests:
        engine.submit(r)
    engine.step()  # the admissions and one tick
    engine.step()
    tick_ms = []
    for _ in range(SERVE_TICKS):
        t0 = time.perf_counter()
        engine.step()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    card = engine.device.type == "cuda"
    if card:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])) as prof:
        t0 = time.perf_counter()
        engine.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if engine.n_active != len(requests):
        fail(f"decode tick profile: {engine.n_active} slots busy, want {len(requests)}")
    engine.evict_all()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in device if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in device if e not in copies]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    port = [e.key for e in kernels if "flash" in e.key.lower() or "gram_schmidt" in e.key.lower()]
    if port:
        fail(f"a decode tick launched kernels of the port: {port}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "kernel_launches": sum(e.count for e in kernels), "copies": sum(e.count for e in copies),
        "copies_by_kind": {e.key: e.count for e in copies},
        "wall_ms": wall_ms, "device_busy_ms": busy_ms if busy_ms > 0 else None,
        "device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else None,
        "tick_ms_p50": statistics.median(tick_ms), "tick_ms": tick_ms, "port_kernels": port,
        "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in top],
    }


class StepHook:
    """A training step that calls ``hook(n)`` after its ``n``-th call."""

    def __init__(self, step, hook):
        self.step, self.hook, self.calls = step, hook, 0

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, state, batch):
        out = self.step(state, batch)
        self.calls += 1
        self.hook(self.calls)
        return out


class Events:
    """A telemetry sink that keeps ``(kind, step)`` of each failure event."""

    def __init__(self):
        self.seen = []

    def emit(self, event, record=None):
        # the loop's telemetry also carries its steps, epochs and spans
        from network_distributed_pytorch_tpu_torch.observe import FailureEvent

        if isinstance(event, FailureEvent):
            self.seen.append((event.kind, event.step))


class Crash(Exception):
    """A worker dying on entry to an epoch."""


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)``, warning where an op has
    no deterministic kernel (the warnings are yielded, for the record),
    cuBLAS's fixed workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8``) and
    deterministic cuDNN without autotuning; all restored after."""
    import torch

    saved = (
        torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
    )
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2], saved[3]
        if saved[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[4]


def tensors_of(state):
    """Params, momenta, EF memories, BN buffers and Q of a ``TrainState``,
    cloned on their device."""
    out = {"q": state.reducer_state.q_memory.clone()}
    for field in ("params", "momenta", "memories", "model_state"):
        out.update({f"{field}.{k}": v.detach().clone() for k, v in getattr(state, field).items()})
    return out


def bitwise_equal(got, want):
    """The names of ``want``'s tensors that ``got`` does not hold bit for bit."""
    import torch

    return [k for k in want if k not in got or not torch.equal(got[k], want[k])]


def resilience_phases(dev, drive, launches, kinds, images, labels, n_groups, smi, preset="full"):
    """``resilient_resume``, ``exact_resume`` and ``serve_hot_load``: the
    checkpointed paths on one card through a one-rank group, their
    checkpoints under a temporary directory removed at the end. ``drive``
    is ``main``'s (launch counts set to 0 just before each run, read just
    after into ``launches`` and ``kinds``); ``n_groups`` is the ResNet's
    shape groups. ``preset="small"`` (global batch 16) rehearses the
    phases on the CPU."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    from network_distributed_pytorch_tpu_torch import launch
    from network_distributed_pytorch_tpu_torch.experiments import gpt_lm, powersgd_cifar10, serve_gpt
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches, resilient_train_loop
    from network_distributed_pytorch_tpu_torch.models import gpt as gpt_model
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )
    from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer, embedding_leaves
    from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
    from network_distributed_pytorch_tpu_torch.resilience import PreemptionGuard, make_topology
    from network_distributed_pytorch_tpu_torch.serving.cache import restore_serving_params
    from network_distributed_pytorch_tpu_torch.utils.checkpoint import (
        REPLICATED_FILE,
        read_topology,
        restore_checkpoint,
        save_checkpoint,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_checkpoints_")
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        # ---- resilient_resume: ResNet-152 PowerSGD, bit for bit ------------------
        t_phase = time.perf_counter()  # each phase's wall time, its checks included
        cfg = powersgd_cifar10.default_config()
        cfg.compress_impl = "xla"
        if preset == "small":
            cfg.global_batch_size = 16
        batches = accumulated_batches([images, labels], cfg, max_steps_per_epoch=RESUME_STEPS)

        def crashing(epoch):
            if epoch == 2:
                raise Crash()
            return batches(epoch)

        def train(name, batches_fn=batches, hook=None, **kw):
            """``resilient_train_loop`` of a fresh ResNet-152 from the seed
            into ``root/name``; returns the state, the logger, the start
            epoch and the time from the call to the end of its first step."""
            _, step, state = powersgd_cifar10.build(cfg, preset, dev, group)
            first = []

            def on_step(n):
                if n == 1:
                    sync()
                    first.append(time.perf_counter())
                if hook is not None:
                    hook(n)

            topology = make_topology(
                1, global_batch=cfg.global_batch_size, data_seed=cfg.seed, bits_per_step=step.bits_per_step,
                rng_seed=cfg.seed,
            )
            t0 = time.perf_counter()
            state, logger, start = resilient_train_loop(
                StepHook(step, on_step), state, batches_fn, RESUME_EPOCHS, os.path.join(root, name), dev,
                keep_last=RESUME_KEEP, topology=topology, **kw,
            )
            return state, logger, start, (first[0] - t0) if first else None

        def resilient_resume():
            out = {}
            with deterministic_algorithms() as caught:
                state, logger, _, _ = train("ref")
                ref = tensors_of(state)
                out["losses"], out["bits_per_step"] = [r.loss for r in logger.records], logger.bits_per_step
                del state
                state, _, _, _ = train("again")
                out["uninterrupted_twice_differ_at"] = bitwise_equal(tensors_of(state), ref)
                del state
                try:
                    train("crash", batches_fn=crashing)
                    fail("resilient_resume: the crashing run did not crash")
                except Crash:
                    pass
                events = Events()
                state, logger, start, first_s = train("crash", telemetry=events)
                out["crash"] = {
                    "start_epoch": start, "steps": len(logger.records), "events": events.seen,
                    "resume_to_first_step_ms": first_s * 1e3, "differ_at": bitwise_equal(tensors_of(state), ref),
                }
                del state
                guard = PreemptionGuard()
                with guard:
                    _, logger, _, _ = train(
                        "preempt", hook=lambda n: guard.request() if n == RESUME_STEPS + 1 else None,
                        preemption_guard=guard,
                    )
                out["preempt_stop"] = {
                    "steps": len(logger.records), "saved": guard.checkpoint_saved,
                    "cursor": read_topology(os.path.join(root, "preempt", "step_1"))["epoch_cursor"],
                }
                events = Events()
                state, logger, start, first_s = train("preempt", telemetry=events)
                out["preempt"] = {
                    "start_epoch": start, "steps": len(logger.records), "events": events.seen,
                    "resume_to_first_step_ms": first_s * 1e3, "differ_at": bitwise_equal(tensors_of(state), ref),
                }
                del state
                # a flipped bit in the newest step: the resume falls back to step_1
                payload = os.path.join(root, "crash", f"step_{RESUME_EPOCHS - 1}", REPLICATED_FILE)
                with open(payload, "r+b") as f:
                    f.seek(os.path.getsize(payload) // 2)
                    byte = f.read(1)[0]
                    f.seek(-1, 1)
                    f.write(bytes([byte ^ 0x10]))
                events = Events()
                state, logger, start, first_s = train("crash", telemetry=events)
                out["bit_flip"] = {
                    "start_epoch": start, "steps": len(logger.records), "events": events.seen,
                    "resume_to_first_step_ms": first_s * 1e3, "differ_at": bitwise_equal(tensors_of(state), ref),
                }
                del ref
                # one save and one restore of the final state, timed apart
                timings = {}
                sync()
                t0 = time.perf_counter()
                path = save_checkpoint(os.path.join(root, "timed"), state, step=0, group=group, timings=timings)
                out["save_ms"] = (time.perf_counter() - t0) * 1e3
                out["save"] = {f"{k[:-2]}_ms": v * 1e3 for k, v in timings.items() if k.endswith("_s")}
                out["bytes_on_disk"] = timings["bytes"]
                sync()
                t0 = time.perf_counter()
                restore_checkpoint(path, state, group=group)
                sync()
                out["restore_ms"] = (time.perf_counter() - t0) * 1e3
                del state
            out["nondeterministic_ops_warned"] = sorted(
                {str(w.message).split(" does not have")[0] for w in caught if "deterministic" in str(w.message)}
            )
            return out

        result, peak = drive("resilient_resume", resilient_resume, {"gram_schmidt": RESUME_K1_STEPS * n_groups})
        if result["uninterrupted_twice_differ_at"]:
            fail(
                f"resilient_resume: two uninterrupted runs differ at {result['uninterrupted_twice_differ_at'][:5]};"
                f" ops without a deterministic kernel: {result['nondeterministic_ops_warned']}"
            )
        want = {
            "crash": (2, RESUME_STEPS, [("resumed", 1)]),
            "preempt": (1, RESUME_EPOCHS * RESUME_STEPS - RESUME_STEPS - 1, [("resumed", 1)]),
            "bit_flip": (2, RESUME_STEPS, [("checkpoint_fallback", 2), ("resumed", 1)]),
        }
        for name, (start, steps, events) in want.items():
            r = result[name]
            if (r["start_epoch"], r["steps"], r["events"]) != (start, steps, events) or r["differ_at"]:
                fail(f"resilient_resume {name}: {r}, want start epoch {start}, {steps} steps, events {events}")
        if result["preempt_stop"] != {"steps": RESUME_STEPS + 1, "saved": True, "cursor": {"epoch": 1, "batches_done": 1}}:
            fail(f"resilient_resume: the preempted run {result['preempt_stop']}")
        emit({
            "phase": "resilient_resume", "preset": preset, "global_batch": cfg.global_batch_size,
            "reducer_rank": cfg.reducer_rank, "compress_impl": "xla", "epochs": RESUME_EPOCHS,
            "steps_per_epoch": RESUME_STEPS, "keep_last": RESUME_KEEP, **result,
            "bitwise": "params, momenta, EF memories, Q and BN buffers of every resume equal the uninterrupted run's",
            "launches": launches["resilient_resume"], "peak_memory_bytes": peak, "nvidia_smi": smi,
            "wall_s": time.perf_counter() - t_phase,
        })

        # ---- exact_resume: exact_cifar10 --checkpoint-dir through the launcher ------
        t_phase = time.perf_counter()

        def exact_resume():
            runs = []
            for epochs in ("1", "2"):
                with contextlib.redirect_stdout(io.StringIO()):
                    runs.append(launch.main([
                        "exact_cifar10", "--preset", preset, "--epochs", epochs, "--max-steps-per-epoch", "2",
                        "--checkpoint-dir", os.path.join(root, "exact"), "--device", dev.type,
                        *(["--global-batch", "16"] if preset == "small" else []),
                    ]))
            return runs

        runs, peak = drive("exact_resume", exact_resume, {}, kernel_free=True)
        want_bits = EXACT_BITS + 32 if preset == "full" else runs[0]["bits_per_step"]
        if [r["start_epoch"] for r in runs] != [0, 1] or any(
            r["bits_per_step"] != want_bits or r["steps"] != 2 for r in runs
        ):
            fail(f"exact_resume: {[(r['start_epoch'], r['steps'], r['bits_per_step']) for r in runs]}")
        emit({
            "phase": "exact_resume", "preset": preset,
            "world_size": runs[0]["num_devices"], "start_epochs": [r["start_epoch"] for r in runs],
            "bits_per_step": [r["bits_per_step"] for r in runs], "losses": [r["losses"] for r in runs],
            "step_time_s": [r["step_time_s"] for r in runs], "peak_memory_bytes": peak,
            "wall_s": time.perf_counter() - t_phase,
        })

        # ---- serve_hot_load: train the serving shape, then serve its checkpoint -----
        t_phase = time.perf_counter()
        gpt_cfg = gpt_lm.default_config()
        max_len = serve_gpt.serving_max_len(preset, SERVE_NEW, "slot", SERVE_BLOCK)
        vocab = serve_gpt.PRESETS[preset][1]
        model = serve_gpt.build_model(preset, max_len, torch.float32, dev, gpt_cfg.seed)
        reducer = PowerSGDReducer(
            random_seed=gpt_cfg.seed, compression_rank=gpt_cfg.reducer_rank, matricize="last",
            features_last=embedding_leaves(model),
        )
        step = make_train_step(
            gpt_lm.lm_loss(), reducer, model, gpt_cfg.learning_rate, gpt_cfg.momentum, "ef_momentum", group
        )
        hot_groups = reducer.n_shape_groups(list(model.parameters()))
        hot_dir = os.path.join(root, "gpt")
        built = []

        def serve_hot_load():
            state, logger, _ = resilient_train_loop(
                step, step.init_state(),
                lambda e: gpt_lm.synthetic_lm_batches(vocab, HOT_B, HOT_T, HOT_STEPS, gpt_cfg.seed + e),
                HOT_EPOCHS, hot_dir, dev, keep_last=RESUME_KEEP,
                topology=make_topology(1, global_batch=HOT_B, bits_per_step=step.bits_per_step),
            )
            build_model = serve_gpt.build_model
            serve_gpt.build_model = lambda *a, **k: built.append(build_model(*a, **k)) or built[-1]
            try:
                served = serve_gpt.serve(
                    serve_gpt.default_config(), preset=preset, slots=SERVE_SLOTS, requests=SERVE_REQUESTS,
                    request_rate=SERVE_RATE, max_new_tokens=SERVE_NEW, checkpoint_dir=hot_dir, device=dev,
                )
            finally:
                serve_gpt.build_model = build_model
            return [r.loss for r in logger.records], served

        layers = model.config.n_layers
        trained_steps = HOT_EPOCHS * HOT_STEPS
        (losses, (summary, finished)), peak = drive(
            "serve_hot_load", serve_hot_load,
            {"gram_schmidt": trained_steps * hot_groups, "flash_attention": trained_steps * layers,
             "flash_attention_bwd": trained_steps * layers},
        )
        trained = dict(model.named_parameters())
        differ = [k for k, v in built[-1].named_parameters() if not torch.equal(v, trained[k])]
        if summary["checkpoint_step"] != HOT_EPOCHS - 1 or differ or summary["slo"]["n_finished"] != SERVE_REQUESTS:
            fail(f"serve_hot_load: checkpoint_step {summary['checkpoint_step']}, params differ at {differ[:5]}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"serve_hot_load: training losses {losses}")
        diffs, compared = tokens_against_reference(
            gpt_model, model, sorted(finished, key=lambda r: r.request_id), max_len, "serve_hot_load"
        )
        # the hot-load alone, into a model of other weights
        fresh = serve_gpt.build_model(preset, max_len, torch.float32, dev, gpt_cfg.seed + 1)
        sync()
        t0 = time.perf_counter()
        _, hot_step = restore_serving_params(hot_dir, dict(fresh.named_parameters()))
        sync()
        hot_load_ms = (time.perf_counter() - t0) * 1e3
        if hot_step != HOT_EPOCHS - 1 or any(not torch.equal(v, trained[k]) for k, v in fresh.named_parameters()):
            fail("serve_hot_load: restore_serving_params did not give the trained params")
        emit({
            "phase": "serve_hot_load", "preset": preset, "vocab": vocab, "positions": max_len,
            "global_batch": HOT_B, "seq_len": HOT_T, "epochs": HOT_EPOCHS, "steps_per_epoch": HOT_STEPS,
            "reducer_rank": gpt_cfg.reducer_rank, "shape_groups": hot_groups, "losses": losses,
            "bits_per_step": step.bits_per_step, "checkpoint_step": summary["checkpoint_step"],
            "served_params_bitwise": True, "hot_load_ms": hot_load_ms,
            "bytes_on_disk": sum(
                os.path.getsize(os.path.join(hot_dir, f"step_{HOT_EPOCHS - 1}", n))
                for n in os.listdir(os.path.join(hot_dir, f"step_{HOT_EPOCHS - 1}")) if n.endswith(".pt")
            ),
            "requests": SERVE_REQUESTS, "request_rate": SERVE_RATE, "slo_p50_total_s": summary["slo"]["p50_total_s"],
            "slo_p99_total_s": summary["slo"]["p99_total_s"], "tokens_per_s": summary["slo"]["tokens_per_s"],
            "vs_sequential_reference": {"tokens_compared": compared, "differences": diffs, "tie_class": SERVE_TIE},
            "launches": launches["serve_hot_load"], "k5_launches_by_kind": kinds["serve_hot_load"],
            "peak_memory_bytes": peak, "nvidia_smi": smi, "wall_s": time.perf_counter() - t_phase,
        })
        del model, fresh, built[:], step
    finally:
        shutdown_distributed()
        shutil.rmtree(root, ignore_errors=True)


def serving_phases(dev, drive, all_kernels, preset="full", max_new_tokens=SERVE_NEW):
    """``main_path_serve`` and ``main_path_serve_paged``: ``serve_gpt`` at
    ``preset`` through the slot engine (fp32 twice, bf16), its fp32 tokens
    against the sequential reference, a profiled decode tick of each
    engine; then the paged engine, self-drafted speculative decoding and
    eight prompts on one prefix, shared and unshared. ``drive(name, run,
    want, kernel_free)`` runs ``run()`` with the launch counts set to 0 just
    before it and read just after (``main``'s); every run here must launch
    no kernel of the port."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments import serve_gpt
    from network_distributed_pytorch_tpu_torch.models import gpt as gpt_model
    from network_distributed_pytorch_tpu_torch.serving import Request, poisson_workload
    from network_distributed_pytorch_tpu_torch.serving.engine import PagedEngine, SlotEngine

    max_len = serve_gpt.serving_max_len(preset, max_new_tokens, "slot", SERVE_BLOCK)
    if max_len % SERVE_BLOCK:
        fail(f"serve_gpt: max_len {max_len} is not a whole number of blocks: the paged engine's would differ")
    vocab = serve_gpt.PRESETS[preset][1]
    serve_cfg = serve_gpt.default_config()
    serve_model = serve_gpt.build_model(preset, max_len, torch.float32, dev, serve_cfg.seed)
    cfg = serve_model.config
    dense_bytes = cfg.n_layers * 2 * SERVE_SLOTS * max_len * cfg.dim * 4
    if preset == "full" and (max_len, dense_bytes) != (SERVE_MAX_LEN, SERVE_DENSE_KV_BYTES):
        fail(f"serve_gpt full: max_len {max_len}, dense cache {dense_bytes} B")

    def serve_run(dtype, **kw):
        cfg = serve_gpt.default_config()
        cfg.compute_dtype = dtype
        return serve_gpt.serve(
            cfg, preset=preset, slots=SERVE_SLOTS, requests=SERVE_REQUESTS, request_rate=SERVE_RATE,
            max_new_tokens=max_new_tokens, device=dev, **kw,
        )

    def served(name, summary, finished):
        slo = summary["slo"]
        if slo["n_finished"] != SERVE_REQUESTS or summary["live_requests_total"] != SERVE_REQUESTS:
            fail(f"{name}: {slo['n_finished']} of {SERVE_REQUESTS} requests finished")
        if not summary["decode_steps"] < summary["padded_static_decode_steps"]:
            fail(f"{name}: {summary['decode_steps']} decode steps, padded static {summary['padded_static_decode_steps']}")
        if summary["max_len"] != max_len:
            fail(f"{name}: max_len {summary['max_len']}")
        return sorted(finished, key=lambda r: r.request_id)

    def slo_ms(slo):
        out = {}
        for phase in ("queue", "prefill", "total"):
            for q in ("p50", "p99"):
                out[f"{q}_{phase}_ms"] = 1e3 * slo[f"{q}_{phase}_s"]
        for q in ("p50", "p99"):
            out[f"{q}_decode_ms_per_token"] = slo[f"{q}_decode_ms_per_token"]
        out["tokens_per_s"] = slo["tokens_per_s"]
        return out

    serve_runs, serve_reqs = {}, {}
    for name, dtype in (("serve_float32", "float32"), ("serve_float32_again", "float32"), ("serve_bfloat16", "bfloat16")):
        (summary, finished), peak = drive(name, lambda: serve_run(dtype), {}, kernel_free=True)
        serve_reqs[name] = served(name, summary, finished)
        serve_runs[name] = {
            "compute_dtype": dtype, "decode_steps": summary["decode_steps"], "prefills": summary["prefills"],
            "padded_static_decode_steps": summary["padded_static_decode_steps"], **slo_ms(summary["slo"]),
            "total_tokens": summary["slo"]["total_tokens"], "cache_bytes": summary["kv_cache_bytes"],
            "peak_memory_bytes": peak,
        }
    if [r.tokens for r in serve_reqs["serve_float32"]] != [r.tokens for r in serve_reqs["serve_float32_again"]]:
        fail("serve_gpt: a second fp32 run gave other tokens")
    if serve_runs["serve_float32"]["cache_bytes"] != dense_bytes:
        fail(f"serve_gpt: cache bytes {serve_runs['serve_float32']['cache_bytes']}, want {dense_bytes}")
    serve_diffs, serve_compared = tokens_against_reference(
        gpt_model, serve_model, serve_reqs["serve_float32"], max_len, "serve_gpt fp32"
    )
    workload = poisson_workload(serve_gpt.workload_config(preset, SERVE_SLOTS, 0.0, max_new_tokens, serve_cfg.seed))

    def busy_slots():  # eight requests that stay in their slots through the profiled ticks
        return [Request(request_id=r.request_id, prompt=r.prompt, max_new_tokens=max_new_tokens) for r in workload]

    ticks = {
        "slot_float32": profile_decode_tick(
            SlotEngine(serve_model, SERVE_SLOTS, max_len, device=dev), busy_slots()
        ),
        # without prefix sharing no request reserves a copy-on-write spare,
        # so the default pool holds all eight at their full horizon
        "paged_float32": profile_decode_tick(
            PagedEngine(serve_model, SERVE_SLOTS, max_len, block_len=SERVE_BLOCK, prefix_sharing=False, device=dev),
            busy_slots(),
        ),
        "slot_bfloat16": profile_decode_tick(
            SlotEngine(
                serve_gpt.build_model(preset, max_len, torch.bfloat16, dev, serve_cfg.seed),
                SERVE_SLOTS, max_len, device=dev,
            ),
            busy_slots(),
        ),
    }
    emit({
        "phase": "main_path_serve", "preset": preset, "vocab": vocab, "slots": SERVE_SLOTS,
        "requests": SERVE_REQUESTS, "request_rate": SERVE_RATE, "max_new_tokens": max_new_tokens, "max_len": max_len,
        "engine": "slot", "runs": serve_runs, "fp32_second_run_bitwise": True,
        "fp32_vs_sequential_reference": {
            "tokens_compared": serve_compared, "differences": serve_diffs, "tie_class": SERVE_TIE,
        },
        "decode_tick": ticks,
    })

    # the same workload through the paged engine (block 16, the default
    # pool: the dense cache's blocks + the garbage block), then with K = 4
    # self-drafted speculative decoding: the same shapes, so the same bits
    paged_runs = {}
    fp32_tokens = [r.tokens for r in serve_reqs["serve_float32"]]
    for name, kw in (("serve_paged", {}), ("serve_paged_spec", {"spec_k": SERVE_SPEC_K})):
        (summary, finished), peak = drive(
            name, lambda: serve_run("float32", engine="paged", block_len=SERVE_BLOCK, **kw), {}, kernel_free=True
        )
        reqs = served(name, summary, finished)
        if [r.tokens for r in reqs] != fp32_tokens:
            fail(f"{name}: tokens differ from the fp32 slot engine's")
        paged_runs[name] = {
            "decode_steps": summary["decode_steps"], "prefills": summary["prefills"],
            "padded_static_decode_steps": summary["padded_static_decode_steps"], **slo_ms(summary["slo"]),
            "kv": summary["kv"], "peak_memory_bytes": peak, "tokens_equal_slot_fp32": True,
        }
        if "spec" in summary:
            # self-drafted: every proposal the budget lets through is accepted
            rounds = sum(-(-(len(r.tokens) - 1) // SERVE_SPEC_K) for r in reqs)
            reachable = sum(len(r.tokens) - 1 for r in reqs) - rounds
            spec = summary["spec"]
            if spec["spec_accepted"] != reachable or spec["spec_rounds"] != summary["decode_steps"]:
                fail(f"{name}: {spec['spec_accepted']} proposals accepted of {reachable} the budgets let through")
            paged_runs[name]["spec"] = {**spec, "accept_rate_of_reachable": spec["spec_accepted"] / reachable}
    kv = paged_runs["serve_paged"]["kv"]

    # eight prompts on one 32-token prefix: one full prefill, seven suffix
    # prefills over the two linked prefix blocks; against the same requests
    # unshared (suffix prefills at M = 8 against full ones at M = 40: the
    # near-tie class), with the leak invariant checked every tick
    gen = torch.Generator().manual_seed(serve_cfg.seed + 4)
    prefix = torch.randint(0, vocab, (SHARED_PREFIX,), generator=gen).tolist()
    prompts = [prefix + torch.randint(0, vocab, (SHARED_SUFFIX,), generator=gen).tolist() for _ in range(SHARED_N)]
    shared_runs = {}
    for name, sharing in (("shared", True), ("unshared", False)):
        engine = PagedEngine(
            serve_model, SHARED_N, max_len, block_len=SERVE_BLOCK, prefix_sharing=sharing, device=dev,
            check_leaks=True,
        )
        reqs = [Request(request_id=f"p{i}", prompt=p, max_new_tokens=SHARED_NEW) for i, p in enumerate(prompts)]
        for k in all_kernels:
            k.reset()
        for r in reqs:
            engine.submit(r)
        t0 = time.perf_counter()
        engine.run(max_steps=10 * SHARED_NEW)
        wall_ms = (time.perf_counter() - t0) * 1e3  # run() ends in the last tick's read of its tokens
        if any(k.launches for k in all_kernels):
            fail(f"shared prefix ({name}) launched {[(k.name, k.launches) for k in all_kernels if k.launches]}")
        if any(len(r.tokens) != SHARED_NEW for r in reqs):
            fail(f"shared prefix ({name}): a request did not finish")
        stats = engine.stats()
        engine.evict_all()
        if engine.allocator.n_free != engine.allocator.n_usable:
            fail(f"shared prefix ({name}): {engine.allocator.n_usable - engine.allocator.n_free} blocks leaked")
        shared_runs[name] = {"reqs": reqs, "stats": {**stats, "wall_ms": wall_ms}}
    st = shared_runs["shared"]["stats"]
    if st["prefills"] != SHARED_N or st["prefix_hits_total"] != SHARED_N - 1 or st["prefill_tokens_saved_total"] < 224:
        fail(f"shared prefix: {st['prefills']} prefills, {st['prefix_hits_total']} hits, {st['prefill_tokens_saved_total']} tokens saved")
    shared_diffs = tokens_against_each_other(
        gpt_model, serve_model, shared_runs["shared"]["reqs"], shared_runs["unshared"]["reqs"], max_len,
        "shared prefix",
    )
    unshared_diffs, _ = tokens_against_reference(
        gpt_model, serve_model, shared_runs["unshared"]["reqs"], max_len, "shared prefix (unshared)"
    )
    emit({
        "phase": "main_path_serve_paged", "preset": preset, "vocab": vocab, "block_len": SERVE_BLOCK,
        "runs": paged_runs,
        "pool_bytes": kv["pool_bytes"], "dense_cache_bytes": dense_bytes, "pool_over_dense": kv["pool_bytes"] / dense_bytes,
        "cow_copies": kv["cow_copies_total"], "prefix_hits": kv["prefix_hits_total"],
        "shared_prefix": {
            "requests": SHARED_N, "prefix_tokens": SHARED_PREFIX, "suffix_tokens": SHARED_SUFFIX,
            "max_new_tokens": SHARED_NEW,
            **{k: st[k] for k in ("prefills", "prefill_tokens", "prefix_hits_total", "prefill_tokens_saved_total",
                                  "cow_copies_total", "decode_steps", "wall_ms")},
            "unshared_prefill_tokens": shared_runs["unshared"]["stats"]["prefill_tokens"],
            "unshared_wall_ms": shared_runs["unshared"]["stats"]["wall_ms"],
            "differences_vs_unshared": shared_diffs, "unshared_vs_reference_differences": unshared_diffs,
            "tie_class": SERVE_TIE, "leaks": 0,
        },
    })


def saved_leaves(path):
    """Every leaf of the payload files (``*.pt``) of the checkpoint at
    ``path``, by file and key path."""
    import torch

    leaves = {}

    def walk(key, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{key}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{key}/{i}", v)
        else:
            leaves[key] = x

    for name in sorted(os.listdir(path)):
        if name.endswith(".pt"):
            walk(name, torch.load(os.path.join(path, name), weights_only=True))
    return leaves


def worst_diff(got, want, names=None):
    """The largest ``|got - want|`` over the leaves ``names`` of ``want``
    (all by default), relative to ``max(1, max|want|)`` of its leaf, and
    that leaf."""
    worst, leaf = -1.0, None
    for k in want if names is None else names:
        w = want[k]
        d = (got[k].float() - w.float()).abs().max().item() / max(1.0, w.abs().max().item())
        if not d <= worst:
            worst, leaf = d, k
    return worst, leaf


def model_parallel_phases(dev, drive, launches, kinds, smi, preset="full"):
    """``main_path_gpt_tp``, ``_sp``, ``_pp`` and ``_moe``: the four
    model-parallel entry points through their own ``run()`` at GPT-2 small
    widths (dim 768, 12 layers, 12 heads, vocabulary 1024) on one card,
    every mesh axis of size 1 over a one-rank NCCL group. Each record: the
    step p50 by CUDA events (the first step is the warm-up), tokens a
    second, peak memory, K5's and K1's launches by kind, the collectives
    and bits a step, and the first step's loss and gradients against the
    plain ``GPTLM`` (or, for MoE, the einsum attention) with the leaf that
    sets the largest difference. ``drive`` is ``main``'s; ``preset="small"``
    rehearses the phases on the CPU."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments import gpt_moe, gpt_pp, gpt_sp, gpt_tp
    from network_distributed_pytorch_tpu_torch.experiments.gpt_lm import preset_vocab, synthetic_lm_batches
    from network_distributed_pytorch_tpu_torch.models import gpt as G
    from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
    from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
    from network_distributed_pytorch_tpu_torch.ops.orthogonalize import orthogonalize
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        make_mesh,
        shutdown_distributed,
    )
    from network_distributed_pytorch_tpu_torch.parallel.moe import switch_moe
    from network_distributed_pytorch_tpu_torch.utils.checkpoint import latest_step_path

    full = preset == "full"
    on_cuda = dev.type == "cuda"
    s = MP_SIZES if full else MP_SIZES_SMALL
    steps = MP_STEPS
    fwd32, bwd32 = fa.KERNEL.name, fa.BWD_KERNELS[torch.float32].name
    fwd16, bwd16 = fa.KERNEL_BF16.name, fa.BWD_KERNELS[torch.bfloat16].name

    def first_batch(vocab, b, t, seed):
        x, y = next(iter(synthetic_lm_batches(vocab, b, t, 1, seed)))
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    def grads_of(loss, leaves):
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    def timing(result, tokens_per_step):
        ms = [m for m in result["device_time_ms"][1:] if m is not None]
        p50 = statistics.median(ms) if ms else None
        return {
            "step_device_ms": result["device_time_ms"], "step_device_ms_p50": p50,
            "tokens_per_s": tokens_per_step / (p50 / 1e3) if p50 else None,
        }

    def comms(result):
        return {
            "collectives": result["hlo_collectives"], "collective_bytes": result["collective_bytes"],
            "bits_per_step": result["bits_per_step"],
        }

    def held(what, loss_got, loss_want, got, want):
        key_bias = [k for k in want if k.endswith("attn.k_proj.bias")]
        diff, leaf = worst_diff(got, want, [k for k in want if k not in key_bias])
        share, noise, bound, noise_leaf = 0.0, 0.0, None, None  # the key bias nearest its bound
        for k in key_bias:
            d = (got[k] - want[k]).abs().max().item()
            b = KEY_BIAS_TOL * max(1.0, want[k.replace("k_proj", "q_proj")].abs().max().item())
            if not d / b <= share:
                share, noise, bound, noise_leaf = d / b, d, b, k
        loss_diff = abs(loss_got - loss_want) / max(1.0, abs(loss_want))
        if not (diff <= MP_TOL and loss_diff <= MP_TOL and share <= 1.0):
            fail(
                f"{what}: gradients {diff} at {leaf}, loss {loss_diff} (tol {MP_TOL}), key biases {noise}"
                f" at {noise_leaf} (bound {bound})"
            )
        return {
            "max_grad_diff": diff, "max_grad_diff_leaf": leaf, "loss_diff": loss_diff, "tolerance": MP_TOL,
            "max_key_bias_grad_diff": noise, "key_bias_bound": bound, "max_key_bias_grad_diff_leaf": noise_leaf,
        }

    # ---- tensor parallelism: one model shard, the vocabulary-parallel head on and off
    tp_b, tp_t = s["tp"]
    cfg = gpt_tp.default_config()
    cfg.global_batch_size = tp_b
    record = {"phase": "main_path_gpt_tp", "preset": preset, "model_shards": 1, "global_batch": tp_b,
              "seq_len": tp_t, "steps": steps, "nvidia_smi": smi, "runs": {}}
    for vp in (False, True):
        name = "gpt_tp_vocab" if vp else "gpt_tp"
        result, peak = drive(
            name, lambda: gpt_tp.run(cfg, preset=preset, model_shards=1, vocab_parallel=vp, seq_len=tp_t, device=dev,
                                     max_steps_per_epoch=steps),
            {}, kernel_free=True,
        )
        record["runs"]["vocab_parallel" if vp else "replicated_head"] = {
            "losses": result["losses"], **timing(result, tp_b * tp_t), "peak_memory_bytes": peak, **comms(result),
            "launches": launches[name],
        }
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        tcfg = gpt_tp.tp_config(preset, tp_t, torch.float32)
        model = G.GPTLM(tcfg, device=dev, seed=cfg.seed)
        x, y = first_batch(tcfg.vocab_size, tp_b, tp_t, cfg.seed)
        params = dict(model.named_parameters())
        plain_loss = G.next_token_loss(model(x), y)
        plain = grads_of(plain_loss, params)
        for vp in (False, True):
            leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
            logits = G.tp_gpt_forward(tcfg, leaves, x, mesh.group("model"), vp)
            loss = (G.vocab_parallel_next_token_loss(logits, y, mesh.group("model")) if vp
                    else G.next_token_loss(logits, y))
            key = "vocab_parallel" if vp else "replicated_head"
            record["runs"][key]["vs_plain_gptlm"] = held(
                f"gpt_tp ({key}) against GPTLM", loss.item(), plain_loss.item(), grads_of(loss, leaves), plain,
            )
        del model, params, plain
    finally:
        shutdown_distributed()
    emit(record)

    # ---- sequence parallelism: one shard of the ring and of Ulysses
    sp_b, sp_t = s["sp"]
    cfg = gpt_sp.default_config()
    cfg.global_batch_size = sp_b
    record = {"phase": "main_path_gpt_sp", "preset": preset, "seq_shards": 1, "global_batch": sp_b, "seq_len": sp_t,
              "steps": steps, "nvidia_smi": smi, "runs": {}}
    for impl in G.SEQ_IMPLS:
        name = f"gpt_sp_{impl}"
        result, peak = drive(
            name, lambda: gpt_sp.run(cfg, preset=preset, seq_impl=impl, seq_len=sp_t, device=dev,
                                     max_steps_per_epoch=steps),
            {}, kernel_free=True,
        )
        record["runs"][impl] = {
            "losses": result["losses"], **timing(result, sp_b * sp_t), "peak_memory_bytes": peak, **comms(result),
            "launches": launches[name],
        }
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        mesh = make_mesh((1,), ("seq",))
        plain_model = gpt_sp.build_model(preset, sp_t, 1, "ring", torch.float32, dev, cfg.seed, None)
        x, y = first_batch(plain_model.config.vocab_size, sp_b, sp_t, cfg.seed)
        params = dict(plain_model.named_parameters())
        plain_loss = G.next_token_loss(plain_model(x), y)
        plain = grads_of(plain_loss, params)
        for impl in G.SEQ_IMPLS:
            model = gpt_sp.build_model(preset, sp_t, 1, impl, torch.float32, dev, cfg.seed, mesh.group("seq"))
            model.load_state_dict(plain_model.state_dict())
            loss = G.next_token_loss(model(x), y)
            record["runs"][impl]["vs_plain_gptlm"] = held(
                f"gpt_sp ({impl}) against GPTLM", loss.item(), plain_loss.item(),
                grads_of(loss, dict(model.named_parameters())), plain,
            )
            del model
        del plain_model, params, plain
    finally:
        shutdown_distributed()
    emit(record)

    # ---- pipeline: one stage of 12 layers, 1F1B over 4 microbatches (K5
    # once a layer and microbatch, forward and backward; no recompute)
    pp_b, pp_t, pp_mb = s["pp"]
    cfg = gpt_pp.default_config()
    cfg.global_batch_size = pp_b
    per_step = G.GPTConfig().n_layers * pp_mb if full else 2 * pp_mb
    result, peak = drive(
        "gpt_pp", lambda: gpt_pp.run(cfg, preset=preset, seq_len=pp_t, num_microbatches=pp_mb, device=dev,
                                     max_steps_per_epoch=steps),
        {fwd32: steps * per_step, bwd32: steps * per_step} if on_cuda else {},
    )
    if on_cuda and any(kinds["gpt_pp"][k] != {"causal": steps * per_step} for k in (fwd32, bwd32)):
        fail(f"gpt_pp: K5 launches by kind {kinds['gpt_pp']}")
    record = {
        "phase": "main_path_gpt_pp", "preset": preset, "stages": result["n_stages"],
        "layers_per_stage": result["layers_per_stage"], "microbatches": pp_mb, "global_batch": pp_b,
        "seq_len": pp_t, "steps": steps, "losses": result["losses"], **timing(result, pp_b * pp_t),
        "peak_memory_bytes": peak, **comms(result), "launches": launches["gpt_pp"],
        "k5_launches_by_kind": kinds["gpt_pp"], "k5_launches_per_step": per_step, "nvidia_smi": smi,
    }
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        mesh = make_mesh((1,), ("pipe",))
        # the plain model attends in einsum: the pipeline's K5 launches at a
        # microbatch's shape are held against plain attention
        model = (G.gpt_small if full else G.gpt_tiny)(
            device=dev, seed=cfg.seed, vocab_size=preset_vocab(preset), max_position_embeddings=pp_t, dropout=0.0,
            attn_impl="einsum",
        )
        x, y = first_batch(model.config.vocab_size, pp_b, pp_t, cfg.seed)
        params = dict(model.named_parameters())
        plain_loss = G.next_token_loss(model(x), y)
        plain = grads_of(plain_loss, params)
        embed, stages, final = G.split_gpt_params({k: v.detach() for k, v in params.items()}, 1)
        stage_cfg = dataclasses.replace(model.config, attn_impl="auto")  # K5, as gpt_pp.run's stages
        train = G.make_gpt_pipeline_train_fn(stage_cfg, model.config.n_layers, pp_mb, mesh.group("pipe"))
        before = [fa.KERNEL.launches, fa.BWD_KERNELS[torch.float32].launches]
        loss, (ge, g_stage, gf) = train(embed, stages[0], final, x, y)
        launched = [fa.KERNEL.launches - before[0], fa.BWD_KERNELS[torch.float32].launches - before[1]]
        if on_cuda and launched != [per_step, per_step]:
            fail(f"gpt_pp against GPTLM: {launched} K5 launches (forward, backward), want {per_step} each")
        got = {**ge, **gf, **{f"h.{j}.{k}": v[j] for k, v in g_stage.items() for j in range(model.config.n_layers)}}
        record["vs_plain_gptlm_full_batch"] = {
            **held("gpt_pp against GPTLM (einsum attention)", loss.item(), plain_loss.item(), got, plain),
            "k5_launches_forward_backward": launched,
        }
        del model, params, plain, got, embed, stages, final
    finally:
        shutdown_distributed()
    # save at the end of epoch 0 and resume: the final checkpoint (the
    # whole carry) bitwise the uninterrupted run's
    with tempfile.TemporaryDirectory() as root, deterministic_algorithms() as caught:
        runs, dirs = {}, {"whole": os.path.join(root, "whole"), "split": os.path.join(root, "split")}
        for label, epochs, ckpt in (("whole", 2, "whole"), ("first", 1, "split"), ("resumed", 2, "split")):
            c = gpt_pp.default_config()
            c.global_batch_size, c.training_epochs = pp_b, epochs
            t0 = time.perf_counter()
            result = gpt_pp.run(c, preset=preset, seq_len=pp_t, num_microbatches=pp_mb, device=dev,
                                max_steps_per_epoch=2, checkpoint_dir=dirs[ckpt])
            runs[label] = (result["losses"], time.perf_counter() - t0)
        whole, resumed = (saved_leaves(latest_step_path(dirs[k])) for k in ("whole", "split"))
        differ = sorted(set(whole) ^ set(resumed)) + [
            k for k in whole if k in resumed and not (
                torch.equal(whole[k], resumed[k]) if torch.is_tensor(whole[k]) else whole[k] == resumed[k]
            )
        ]
        losses_ok = runs["resumed"][0] == runs["whole"][0][2:]
        if differ or not losses_ok:
            fail(f"gpt_pp resume: {len(differ)} saved leaves differ from the uninterrupted run's ({differ[:3]}),"
                 f" losses {losses_ok}")
        record["resume"] = {
            "bitwise": True, "saved_leaves_compared": len(whole), "losses_whole": runs["whole"][0],
            "losses_resumed": runs["resumed"][0], "run_s": {k: v[1] for k, v in runs.items()},
            "nondeterministic_ops": sorted({str(w.message)[:120] for w in caught}),
        }
        del runs, whole, resumed
    emit(record)

    # ---- MoE: 8 local experts, capacity factor 2, PowerSGD on the replicated
    # parameters (K1), top-1 and top-2 in fp32, top-1 in bf16 (K5 12 causal
    # launches forward and backward a step, and 12 forward in the run's
    # routing diagnostics after training)
    moe_b, moe_t, moe_e = s["moe"]
    record = {"phase": "main_path_gpt_moe", "preset": preset, "experts": moe_e, "global_batch": moe_b,
              "seq_len": moe_t, "capacity_factor": MOE_FACTOR, "reducer": "powersgd", "steps": steps,
              "nvidia_smi": smi, "runs": {}}
    n_layers = G.GPTConfig().n_layers if full else 2
    for name, top_k, dtype in (("gpt_moe_top1", 1, "float32"), ("gpt_moe_top2", 2, "float32"),
                               ("gpt_moe_bf16", 1, "bfloat16")):
        cfg = gpt_moe.default_config()
        cfg.global_batch_size, cfg.compute_dtype = moe_b, dtype

        def go(cfg=cfg, top_k=top_k):
            return gpt_moe.run(cfg, preset=preset, experts_per_device=moe_e, reducer="powersgd", top_k=top_k,
                               capacity_factor=MOE_FACTOR, seq_len=moe_t, device=dev, max_steps_per_epoch=steps)

        groups = MOE_GROUPS if full else None
        f, b = (fwd32, bwd32) if dtype == "float32" else (fwd16, bwd16)
        w = {} if not on_cuda else {f: n_layers * (steps + 1), b: n_layers * steps, "gram_schmidt": steps * groups}
        result, peak = drive(name, go, w)
        if result["shape_groups"] != groups and on_cuda:
            fail(f"{name}: {result['shape_groups']} shape groups, expected {groups}")
        if on_cuda and any(kinds[name][k] and set(kinds[name][k]) != {"causal"} for k in (f, b)):
            fail(f"{name}: K5 launches by kind {kinds[name]}")
        record["runs"][name] = {
            "top_k": top_k, "compute_dtype": dtype, "capacity": result["capacity"], "losses": result["losses"],
            "final_ce": result["final_ce"], "final_aux_loss": result["final_aux_loss"],
            "final_dropped_fraction": result["final_dropped_fraction"],
            "dispatch_bytes_per_tensor_per_layer": result["dispatch_bytes_per_layer"],
            **timing(result, moe_b * moe_t), "peak_memory_bytes": peak, **comms(result),
            "shape_groups": result["shape_groups"], "launches": launches[name],
            "k5_launches_by_kind": kinds[name],
        }
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        world = make_mesh((1,), ("expert",)).group("expert")
        mcfg = gpt_moe.moe_config(preset, moe_t, torch.float32)
        base, routers, experts = gpt_moe.init_moe_params(mcfg, moe_e, 714)
        params = {**{f"base/{k}": v for k, v in base.items()}, **{f"router/{k}": v for k, v in routers.items()},
                  **{f"expert/{k}": v for k, v in experts.items()}}
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        x, y = first_batch(mcfg.vocab_size, moe_b, moe_t, 714)
        capacity = max(1, int(MOE_FACTOR * moe_b * moe_t / moe_e))
        pick = lambda p, pre: {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}  # noqa: E731
        out = {}
        for impl in ("flash", "einsum"):
            attn = gpt_moe.attention_template(dataclasses.replace(mcfg, attn_impl=impl))
            logits, aux, _ = gpt_moe.moe_gpt_forward(
                mcfg, pick(leaves, "base/"), pick(leaves, "expert/"), pick(leaves, "router/"), x, capacity, world, 1, attn
            )
            loss = G.next_token_loss(logits, y) + 0.01 * aux
            out[impl] = (loss.item(), grads_of(loss, leaves))
        record["flash_vs_einsum_first_step"] = held(
            "gpt_moe flash against einsum", out["flash"][0], out["einsum"][0], out["flash"][1], out["einsum"][1],
        )
        # switch_moe over the one-rank group (its all-to-alls through NCCL)
        # against the single-process path: bit for bit
        gen = torch.Generator().manual_seed(3)
        h = torch.randn((moe_b * moe_t, mcfg.dim), generator=gen).to(dev)
        layer = {k[len("h.0."):]: v.detach() for k, v in pick(params, "expert/").items() if k.startswith("h.0.")}
        layer = {k: v.to(dev) for k, v in layer.items()}
        router = routers["h.0"].to(dev)
        a = switch_moe(h, router, layer, gpt_moe.expert_mlp, world, capacity)
        b_ = switch_moe(h, router, layer, gpt_moe.expert_mlp, None, capacity)
        if not all(torch.equal(u, v) for u, v in zip(a, b_)):
            fail("switch_moe over a one-rank group differs from the single-process path")
        record["switch_moe_world1_vs_single_process_bitwise"] = True
        # K1 against plain Gram-Schmidt at the (g, n, r) of every shape group
        # that gpt_moe's PowerSGD reducer makes of the replicated parameters
        base_names = [k for k in params if not k.startswith("expert/")]
        reducer = gpt_moe.make_reducer(gpt_moe.default_config(), "powersgd", base_names)
        metas = reducer._metas([params[k] for k in base_names])
        k1_errs = {}
        for poss in reducer._shape_groups(metas):
            shape = (len(poss), metas[poss[0]].n, metas[poss[0]].r)
            p = torch.randn(shape, generator=gen).to(dev)
            err = (gs.gram_schmidt(p) - orthogonalize(p)).abs().max().item()
            if not err <= GS_TOL:
                fail(f"gram_schmidt {shape} (gpt_moe's reducer): max |kernel - plain| = {err} > {GS_TOL}")
            k1_errs[str(shape)] = err
        if full and len(k1_errs) != MOE_GROUPS:
            fail(f"gpt_moe's reducer: {len(k1_errs)} shape groups, expected {MOE_GROUPS}")
        record["gram_schmidt_vs_plain"] = {"max_abs_err": k1_errs, "tolerance": GS_TOL}
        del leaves, params, out
    finally:
        shutdown_distributed()
    emit(record)


def fsdp_phases(dev, drive, images, labels, smi, preset="full"):
    """``main_path_exact_fsdp`` and ``fsdp_checkpoint``: ``exact_cifar10``
    under ``strategy="fsdp"`` (ZeRO-3) through a one-rank group, where every
    gather is a copy and each reduce-scatter sums one term. The main path
    monolithic and at ``comm_chunks=4``, 2 warm-up and 5 timed steps each
    (step p50, peak memory, bits and collectives by kind, eval accuracy on
    the monolithic run), 3 profiled steps (busy time, idle share, NCCL);
    then, under deterministic algorithms, two steps from the same weights
    and batches: the unsharded FSDP parameters must equal the DDP step's
    bit for bit, and chunked FSDP the monolithic; and a save of the FSDP
    state after one step, restored by ``restore_checkpoint_sharded`` into
    a state of other weights, whose next step must equal the
    uninterrupted run's bit for bit (save and restore timed). No kernel of
    the port runs. ``drive`` is ``main``'s; ``preset="small"`` (global batch
    16) rehearses the phases on the CPU."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )
    from network_distributed_pytorch_tpu_torch.utils.checkpoint import restore_checkpoint_sharded, save_checkpoint

    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    def config(chunks=None):
        cfg = exact_cifar10.default_config()
        cfg.comm_chunks = chunks
        if preset == "small":
            cfg.global_batch_size = 16
        return cfg

    runs = {}
    for name, chunks in (("monolithic", None), ("chunked", FSDP_CHUNKS)):
        cfg = config(chunks)
        start = torch.cuda.memory_allocated(dev) if on_cuda else 0  # what earlier phases hold: the peak counts it
        result, peak = drive(
            f"exact_fsdp_{name}",
            lambda: exact_cifar10.run(
                cfg, preset=preset, device=dev, max_steps_per_epoch=MAIN_STEPS, eval_after=chunks is None,
                strategy="fsdp",
            ),
            {}, kernel_free=True,
        )
        losses = result["losses"]
        if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
            fail(f"exact_fsdp {name} losses {losses}")
        by_kind = {k: 8 * b for k, b in result["collectives"]["bytes_by_kind"].items()}
        want_bits = FSDP_BITS if preset == "full" else result["bits_per_step"]
        if result["bits_per_step"] != want_bits or sum(by_kind.values()) != want_bits:
            fail(f"exact_fsdp {name}: {result['bits_per_step']} bits a step, {by_kind} by kind (want {want_bits})")
        timed = result["device_time_ms"][WARMUP_STEPS:] if on_cuda else [1e3 * t for t in result["step_time_s"][WARMUP_STEPS:]]
        runs[name] = {
            "comm_chunks": chunks, "losses": losses, "step_device_ms" if on_cuda else "step_host_ms": timed,
            "step_ms_p50": statistics.median(timed),
            "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
            "images_per_s": cfg.global_batch_size / (statistics.median(timed) / 1e3),
            "peak_memory_bytes": peak, "allocated_at_start_bytes": start, "peak_above_start_bytes": peak - start,
            "bits_per_step": result["bits_per_step"], "bits_by_kind": by_kind,
            "collectives_by_kind": result["collectives"]["by_kind"], "eval_accuracy": result.get("eval_accuracy"),
        }
    profile = None
    if on_cuda:
        cfg = config()
        profile = profile_main_path(
            dev, exact_cifar10, cfg, [images, labels], {}, steps=PROFILE_STEPS,
            build=lambda group: exact_cifar10.build(cfg, preset, dev, group, strategy="fsdp"),
        )

    group = initialize_distributed(DistributedConfig(), dev)
    try:
        with deterministic_algorithms() as caught:
            cfg = config()
            batches = [
                tuple(torch.from_numpy(a).to(dev) for a in b)
                for b in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0)
            ]

            def two_steps(strategy, chunks=None):
                run_cfg = config(chunks)
                _, step, state = exact_cifar10.build(run_cfg, preset, dev, group, strategy=strategy)
                losses = []
                for b in batches:
                    state, loss = step(state, b)
                    losses.append(loss.item())
                params = step.unshard(state) if strategy == "fsdp" else {
                    k: v.detach().clone() for k, v in state.params.items()
                }
                return losses, params

            ddp_losses, ddp = two_steps("ddp")
            mono_losses, mono = two_steps("fsdp")
            chunked_losses, chunked = two_steps("fsdp", FSDP_CHUNKS)
            fsdp_vs_ddp = bitwise_equal(mono, ddp)
            chunked_vs_mono = bitwise_equal(chunked, mono)
            if fsdp_vs_ddp or chunked_vs_mono or not (ddp_losses == mono_losses == chunked_losses):
                fail(
                    f"exact_fsdp after 2 steps: FSDP differs from DDP at {fsdp_vs_ddp[:5]}, chunked from"
                    f" monolithic at {chunked_vs_mono[:5]}; losses {ddp_losses} {mono_losses} {chunked_losses}"
                )
            del ddp, mono, chunked
            emit({
                "phase": "main_path_exact_fsdp", "model": "resnet50" if preset == "full" else "resnet18",
                "preset": preset, "global_batch": cfg.global_batch_size, "world_size": 1,
                "runs": runs,
                "eval_note": "synthetic CIFAR-10 test split, 7 steps from random weights: a number, not a target",
                "params_after_2_steps": {"fsdp_vs_ddp_bitwise": True, "chunked_vs_monolithic_bitwise": True,
                                         "losses": ddp_losses},
                "nondeterministic_ops": sorted({str(w.message)[:120] for w in caught if w.category is UserWarning}),
                "profile": profile, "nvidia_smi": smi,
            })

            # ---- fsdp_checkpoint: the sharded restore, bit for bit ----------------
            root = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
            try:
                _, step, state = exact_cifar10.build(cfg, preset, dev, group, strategy="fsdp")
                state, _ = step(state, batches[0])
                sync()
                t0 = time.perf_counter()
                timings = {}
                path = save_checkpoint(root, state, step=0, group=group, timings=timings)
                save_ms = (time.perf_counter() - t0) * 1e3
                state, loss = step(state, batches[1])
                want = fsdp_tensors(state)
                fresh_cfg = config()
                fresh_cfg.seed += 1  # other weights: every tensor must come from the file
                _, fresh_step, fresh = exact_cifar10.build(fresh_cfg, preset, dev, group, strategy="fsdp")
                sync()
                t0 = time.perf_counter()
                fresh = restore_checkpoint_sharded(path, fresh, group)
                sync()
                restore_ms = (time.perf_counter() - t0) * 1e3
                fresh, fresh_loss = fresh_step(fresh, batches[1])
                differ = bitwise_equal(fsdp_tensors(fresh), want)
                if differ or loss.item() != fresh_loss.item():
                    fail(f"fsdp_checkpoint: the resumed step differs at {differ[:5]} (loss {loss.item()} {fresh_loss.item()})")
                emit({
                    "phase": "fsdp_checkpoint", "preset": preset, "tensors": len(want), "resumed_step_bitwise": True,
                    "save_ms": save_ms, "restore_ms": restore_ms, "bytes_on_disk": timings.get("bytes"),
                    "hash_s": timings.get("hash_s"), "nvidia_smi": smi,
                })
                del state, fresh, step, fresh_step
            finally:
                shutil.rmtree(root, ignore_errors=True)
    finally:
        shutdown_distributed()


def fsdp_tensors(state):
    """Every tensor of an ``FSDPState`` (shards, momenta, BN buffers), cloned
    on its device."""
    out = {f"param_shards.{k}": v.detach().clone() for k, v in state.param_shards.items()}
    out.update({f"opt_shards.{k}": v.clone() for k, v in state.opt_shards.items()})
    out.update({f"model_state.{k}": v.clone() for k, v in state.model_state.items()})
    return out


def option_phases(dev, drive, images, labels, n_groups, smi, preset="full"):
    """The options that the ported entries no longer refuse, each run with
    the launch counts set to 0 just before it and read just after
    (``drive``, ``main``'s), OPT_STEPS steps:

    - ``main_path_bf16``: ``powersgd_cifar10`` at ``compute_dtype=
      "bfloat16"`` on the xla (K1) and fused (K2a, K3, K4) pipelines, its
      bits the fp32 run's, p50, peak memory and a profile of each; then,
      under deterministic algorithms, the fused parameters after two steps
      against the xla ones at PARAM_TOL (both reduce the same fp32
      gradients);
    - ``main_path_gpt_remat``: ``gpt_lm`` plain and with ``remat`` in fp32
      and bf16 (K5's forward twice a layer a step, its backward once), the
      peaks side by side and a profile of each remat run; two steps of
      remat bit for bit two plain steps under deterministic algorithms;
    - ``main_path_gpt_scan``: ``gpt_lm`` with ``scan_layers`` (its bits and
      shape groups), one forward and backward bit for bit the unrolled
      model's, and K1 at every stacked shape group against its plain
      version;
    - ``main_path_imdb_remat``: ``powersgd_imdb`` plain and with ``remat``,
      the peaks, and one forward and backward of remat bit for bit plain.

    ``n_groups`` is the ResNet's shape groups; ``preset="small"`` rehearses
    the phases on the CPU (``drive`` of your own)."""
    import torch

    from network_distributed_pytorch_tpu_torch.data.imdb import prepare_imdb
    from network_distributed_pytorch_tpu_torch.experiments import gpt_lm, powersgd_cifar10, powersgd_imdb
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.models.gpt import next_token_loss, unstack_gpt_layer_params
    from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
    from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
    from network_distributed_pytorch_tpu_torch.ops.orthogonalize import orthogonalize

    full = preset == "full"
    on_cuda = dev.type == "cuda"
    steps = OPT_STEPS
    gen = torch.Generator().manual_seed(17)

    def timing(result, units_per_step):
        ms = [m for m in result["device_time_ms"][1:] if m is not None]
        p50 = statistics.median(ms) if ms else None
        return {
            "step_device_ms": result["device_time_ms"], "step_device_ms_p50": p50,
            "step_host_s_p50": statistics.median(result["step_time_s"][1:]),
            "per_s": units_per_step / (p50 / 1e3) if p50 else None,
        }

    def finite(name, result):
        losses = result["losses"]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            fail(f"{name} losses {losses}")
        return losses

    def profiled(experiment, cfg, kernels, build, batches=None, arrays=None):
        if not on_cuda:
            return None
        return profile_main_path(dev, experiment, cfg, arrays, kernels, build=build, batches=batches)

    def bitwise_grads(make, loss_of, transform=lambda g: g):
        """Loss and gradients of one forward and backward of each of the two
        models ``make(False)`` and ``make(True)``, under deterministic
        algorithms: the leaves that differ."""
        got = []
        with deterministic_algorithms():
            for flag in (False, True):
                model = make(flag)
                loss = loss_of(model)
                loss.backward()
                grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
                got.append((loss.detach().clone(), transform(grads) if flag else grads))
                del model, loss, grads
        (loss_a, a), (loss_b, b) = got
        differ = bitwise_equal(b, a) + ([] if torch.equal(loss_a, loss_b) else ["loss"])
        return differ, len(a)

    # ---- main_path_bf16: ResNet-152 in bf16 on both pipelines ----------------
    t_phase = time.perf_counter()

    def resnet_cfg(impl, dtype):
        cfg = powersgd_cifar10.default_config()
        cfg.training_epochs, cfg.compress_impl, cfg.compute_dtype = 1, impl, dtype
        if not full:
            cfg.global_batch_size = 16
        return cfg

    # the fp32 step's payload and the loss's 32 bits, which a run sums over its group
    want_bits = 32 + (RESNET152_BITS if full else powersgd_cifar10.build(
        resnet_cfg("xla", "float32"), preset, dev, None
    )[1].bits_per_step)
    record = {"phase": "main_path_bf16", "model": "resnet152" if full else "resnet18", "compute_dtype": "bfloat16",
              "steps": steps, "nvidia_smi": smi}
    for impl in ("xla", "pallas"):
        cfg = resnet_cfg(impl, "bfloat16")
        want = (
            {"gram_schmidt": steps * n_groups} if impl == "xla" else
            {"ef_compress": steps * n_groups, "orthogonalize_project": steps * n_groups,
             "decompress_residual": steps * n_groups}
        )
        name = f"bf16_{impl}"
        result, peak = drive(
            name, lambda: powersgd_cifar10.run(cfg, preset=preset, device=dev, max_steps_per_epoch=steps), want
        )
        losses = finite(name, result)
        if result["bits_per_step"] != want_bits or result["compute_dtype"] != "bfloat16":
            fail(f"{name}: {result['bits_per_step']} bits a step, the fp32 run's are {want_bits}")
        parts = {"xla": ("gram_schmidt",), "pallas": ("ef_compress", "orthogonalize_project", "decompress_residual")}
        record[impl] = {
            "losses": losses, **timing(result, cfg.global_batch_size), "peak_memory_bytes": peak,
            "bits_per_step": result["bits_per_step"], "shape_groups": result["shape_groups"],
            "profile": profiled(
                powersgd_cifar10, cfg, {k: k + "_kernel" for k in parts[impl]},
                lambda g, cfg=cfg: powersgd_cifar10.build(cfg, preset, dev, g), arrays=[images, labels],
            ),
        }
    finals = {}
    with deterministic_algorithms():
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            for impl in ("xla", "pallas"):
                cfg = resnet_cfg(impl, "bfloat16")
                model, step, state = powersgd_cifar10.build(cfg, preset, dev, group=None)
                for batch in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0):
                    state, _ = step(state, tuple(torch.from_numpy(a).to(dev) for a in batch))
                finals[impl] = {k: v.detach().cpu() for k, v in state.params.items()}
                del model, step, state
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    diff, leaf = worst_diff(finals["pallas"], finals["xla"])
    if not math.isfinite(diff) or diff > PARAM_TOL:
        fail(f"bf16 ResNet, fused vs xla after 2 steps: {diff} at {leaf} > {PARAM_TOL}")
    record.update(fused_vs_xla={"steps": 2, "max_param_diff": diff, "max_param_diff_leaf": leaf,
                                "tolerance": PARAM_TOL}, phase_s=time.perf_counter() - t_phase)
    emit(record)
    del finals

    # ---- main_path_gpt_remat: GPT-2 small plain and remat, fp32 and bf16 -----
    t_phase = time.perf_counter()
    gpt_b, gpt_t = (GPT_B, GPT_T) if full else (4, 32)
    layers, groups = (GPT_LAYERS, GPT_GROUPS) if full else (2, 3)
    record = {"phase": "main_path_gpt_remat", "model": "gpt2_small" if full else "gpt_tiny", "seq_len": gpt_t,
              "global_batch": gpt_b, "steps": steps, "nvidia_smi": smi}

    def gpt_cfg(dtype):
        cfg = gpt_lm.default_config()
        cfg.global_batch_size, cfg.compute_dtype = gpt_b, dtype
        return cfg

    for dtype in ("float32", "bfloat16"):
        fwd = (fa.KERNEL if dtype == "float32" else fa.KERNEL_BF16).name
        bwd = fa.BWD_KERNELS[getattr(torch, dtype)].name
        runs = {}
        for remat in (False, True):
            name = f"gpt_{'remat' if remat else 'plain'}_{dtype}"
            cfg = gpt_cfg(dtype)
            result, peak = drive(
                name,
                lambda: gpt_lm.run(cfg, preset=preset, seq_len=gpt_t, steps_per_epoch=steps, device=dev, remat=remat),
                {"gram_schmidt": steps * groups, fwd: steps * layers * (2 if remat else 1), bwd: steps * layers},
            )
            runs["remat" if remat else "plain"] = {
                "losses": finite(name, result), **timing(result, gpt_b * gpt_t), "peak_memory_bytes": peak,
                "bits_per_step": result["bits_per_step"],
            }
            if remat:
                vocab = result["vocab"]
                runs["remat"]["profile"] = profiled(
                    gpt_lm, cfg,
                    {"gram_schmidt": "gram_schmidt_kernel", "flash_attention": "flash_fwd", "flash_attention_bwd": "flash_bwd"},
                    lambda g, cfg=cfg: gpt_lm.build(cfg, preset, gpt_t, "powersgd", dev, g, remat=True),
                    batches=list(gpt_lm.synthetic_lm_batches(vocab, gpt_b, gpt_t, 1 + PROFILE_STEPS, cfg.seed)),
                )
        if runs["remat"]["bits_per_step"] != runs["plain"]["bits_per_step"]:
            fail(f"gpt remat {dtype}: bits {runs['remat']['bits_per_step']} against {runs['plain']['bits_per_step']}")
        # two steps of each from the same weights and batches, bit for bit
        finals = {}
        with deterministic_algorithms():
            for remat in (False, True):
                cfg = gpt_cfg(dtype)
                model, step, state = gpt_lm.build(cfg, preset, gpt_t, "powersgd", dev, None, remat=remat)
                losses = []
                for b in gpt_lm.synthetic_lm_batches(model.config.vocab_size, gpt_b, gpt_t, 2, cfg.seed):
                    state, loss = step(state, tuple(torch.from_numpy(a).to(dev) for a in b))
                    losses.append(loss.item())
                finals[remat] = (losses, {k: v.detach().clone() for k, v in state.params.items()})
                del model, step, state
        differ = bitwise_equal(finals[True][1], finals[False][1])
        if differ or finals[True][0] != finals[False][0]:
            fail(f"gpt remat {dtype}: 2 steps differ from plain at {differ[:3]}, losses {finals[True][0]} {finals[False][0]}")
        runs["two_steps_bitwise_equal_plain"] = True
        runs["peak_ratio_remat_to_plain"] = (
            runs["remat"]["peak_memory_bytes"] / runs["plain"]["peak_memory_bytes"]
            if runs["plain"]["peak_memory_bytes"] else None
        )
        record[dtype] = runs
        del finals
    record["phase_s"] = time.perf_counter() - t_phase
    emit(record)

    # ---- main_path_gpt_scan: GPT-2 small under scan_layers --------------------
    t_phase = time.perf_counter()
    cfg = gpt_cfg("float32")
    scan_groups = SCAN_GROUPS if full else 6
    result, peak = drive(
        "gpt_scan",
        lambda: gpt_lm.run(cfg, preset=preset, seq_len=gpt_t, steps_per_epoch=steps, device=dev, scan_layers=True),
        {"gram_schmidt": steps * scan_groups, fa.KERNEL.name: steps * layers,
         fa.BWD_KERNELS[torch.float32].name: steps * layers},
    )
    losses = finite("gpt_scan", result)
    if full and (result["shape_groups"], result["bits_per_step"]) != (SCAN_GROUPS, SCAN_BITS + 32):
        fail(f"gpt_scan: {result['bits_per_step']} bits (want {SCAN_BITS} + 32), {result['shape_groups']} groups")
    ids = next(iter(gpt_lm.synthetic_lm_batches(result["vocab"], gpt_b, gpt_t, 1, cfg.seed)))
    x, y = (torch.from_numpy(a).to(dev) for a in ids)
    differ, n_leaves = bitwise_grads(
        lambda scan: gpt_lm.build_model(preset, gpt_t, device=dev, seed=cfg.seed, scan_layers=scan),
        lambda model: next_token_loss(model(x), y), unstack_gpt_layer_params,
    )
    if differ:
        fail(f"gpt_scan: one forward and backward differ from the unrolled model at {differ[:3]}")
    # K1 at every stacked shape group, against its plain version
    model, step, _ = gpt_lm.build(cfg, preset, gpt_t, "powersgd", dev, None, scan_layers=True)
    leaves = list(model.parameters())
    metas = step.reducer._metas(leaves)
    k1 = []
    for poss in step.reducer._shape_groups(metas):
        shape = (len(poss), metas[poss[0]].n, metas[poss[0]].r)
        p = torch.randn(shape, generator=gen).to(dev)
        before = gs.KERNEL.launches
        got = gs.gram_schmidt(p)
        if on_cuda:
            torch.cuda.synchronize()
        err = (got - orthogonalize(p)).abs().max().item()
        if not err <= GS_TOL or (on_cuda and gs.KERNEL.launches != before + 1):
            fail(f"K1 at the stacked group {shape}: max err {err} (tol {GS_TOL})")
        k1.append({"shape": shape, "max_abs_err": err})
    del model, step
    emit({
        "phase": "main_path_gpt_scan", "model": "gpt2_small" if full else "gpt_tiny", "seq_len": gpt_t,
        "global_batch": gpt_b, "losses": losses, **timing(result, gpt_b * gpt_t), "peak_memory_bytes": peak,
        "bits_per_step": result["bits_per_step"], "shape_groups": result["shape_groups"],
        "grads_bitwise_equal_unrolled": True, "leaves_compared": n_leaves, "k1_stacked_groups": k1,
        "k1_tolerance": GS_TOL, "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi,
    })

    # ---- main_path_imdb_remat: distilbert_base plain and remat ----------------
    t_phase = time.perf_counter()
    imdb_layers, imdb_groups = (IMDB_LAYERS, 6) if full else (2, 6)
    record = {"phase": "main_path_imdb_remat", "model": "distilbert_base" if full else "distilbert_tiny",
              "steps": steps, "nvidia_smi": smi}
    for remat in (False, True):
        name = f"imdb_{'remat' if remat else 'plain'}"
        cfg = powersgd_imdb.default_config()
        cfg.training_epochs = 1
        result, peak = drive(
            name, lambda: powersgd_imdb.run(cfg, preset=preset, device=dev, max_steps_per_epoch=steps, remat=remat),
            {"gram_schmidt": steps * imdb_groups, fa.KERNEL.name: steps * imdb_layers * (2 if remat else 1),
             fa.BWD_KERNELS[torch.float32].name: steps * imdb_layers},
        )
        record["remat" if remat else "plain"] = {
            "losses": finite(name, result), **timing(result, result["global_batch"]), "peak_memory_bytes": peak,
            "bits_per_step": result["bits_per_step"], "max_len": result["max_len"],
        }
    max_len = record["plain"]["max_len"]
    split, _, _ = prepare_imdb(max_len=max_len, vocab_size=30522 if full else 1024, seed=cfg.seed)
    batch = [torch.from_numpy(split[k][:IMDB_B]).to(dev) for k in ("input_ids", "attention_mask", "labels")]
    differ, n_leaves = bitwise_grads(
        lambda remat: powersgd_imdb.build_model(preset, dev, seed=cfg.seed, remat=remat),
        lambda model: powersgd_imdb.sequence_classifier_loss()(model, batch),
    )
    if differ:
        fail(f"imdb remat: one forward and backward differ from plain at {differ[:3]}")
    record.update(
        grads_bitwise_equal_plain=True, leaves_compared=n_leaves,
        peak_ratio_remat_to_plain=(
            record["remat"]["peak_memory_bytes"] / record["plain"]["peak_memory_bytes"]
            if record["plain"]["peak_memory_bytes"] else None
        ),
        phase_s=time.perf_counter() - t_phase,
    )
    emit(record)


def telemetry_phases(dev, drive, launches, images, labels, n_groups, preset="full"):
    """The telemetry core and the training loop's probes
    (``main_path_telemetry`` on the xla pipeline, ``main_path_telemetry_fused``
    on the fused one, ``main_path_telemetry_fsdp``).

    ``powersgd_cifar10`` (ResNet-152, batch 512, rank 4, 21 shape groups
    at preset full) runs TELEMETRY_STEPS steps four times a pipeline, in
    turns under deterministic algorithms: off, on with the trace, on, off
    ("on": ``event_log``, ``audit_wire``, ``health_every=TELEMETRY_EVERY``;
    the first also ``trace_dir``). Each run's launches are counted by
    ``drive``: the probe's diagnostic round adds one launch a shape group
    of K1 (xla), or of K2b, K3 and K4 (fused), a probe. Every "on" run's
    final state (params, momenta, EF memories, Q, BN buffers and the
    reducer's generator) must equal the "off" runs' bit for bit: the probe
    reads the state and never writes it. Each run log must hold a
    ``StepEvent`` a step, the ``EpochEvent``, one exact ``CompileEvent`` at
    the step's bits, a finite ``TrainHealthEvent`` a probe, a
    ``FidelityEvent`` a fidelity group a probe whose tag is a ledger line,
    a ``MemoryEvent`` a probe from the card, and no ``audit_error`` or
    ``health_probe_error``; the trace its step ranges and the pipeline's
    kernels. Then the probe on the final state on the kernels against the
    same probe on their plain versions (GS_TOL, FUSED_TOL), its time a
    call, and the step p50 with telemetry on against off. Last,
    ``exact_cifar10`` under FSDP with its audit. Returns the traced runs'
    tags and, for each pipeline's phase, the MFU join's inputs (the audit
    of its third run and that run's steady step p50). ``preset="small"``
    rehearses on the CPU with a ``drive`` of your own."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10, powersgd_cifar10
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
    from network_distributed_pytorch_tpu_torch.ops import powersgd as ps
    from network_distributed_pytorch_tpu_torch.parallel import reducers as reducers_mod
    from network_distributed_pytorch_tpu_torch.utils.overlap import kernels_from_chrome_trace, overlap_report
    from network_distributed_pytorch_tpu_torch.utils.profiling import TRACE_NAME

    full = preset == "full"
    on_cuda = dev.type == "cuda"
    steps, probes = TELEMETRY_STEPS, TELEMETRY_STEPS // TELEMETRY_EVERY
    tmp = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    paths, mfu_inputs = {}, {}

    def records_of(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    def of(recs, kind):
        return [r for r in recs if r["event"] == kind]

    def config(impl, on, tag):
        cfg = powersgd_cifar10.default_config()
        cfg.training_epochs, cfg.compress_impl = 1, impl
        if not full:
            cfg.global_batch_size = 16
        if on:
            cfg.event_log = os.path.join(tmp, f"{tag}.jsonl")
            cfg.audit_wire, cfg.health_every = True, TELEMETRY_EVERY
        return cfg

    def check_log(name, path, want_bits, groups):
        """The run log's checks; returns its summary."""
        recs = records_of(path)
        counts = {k: len(of(recs, k)) for k in ("step", "epoch", "compile", "train_health", "fidelity", "memory")}
        if (counts["step"], counts["epoch"], counts["compile"], counts["train_health"]) != (steps, 1, 1, probes):
            fail(f"{name}: records {counts}")
        compile_ = of(recs, "compile")[0]
        if not compile_["exact"] or compile_["analytic_bytes"] * 8 != want_bits:
            fail(f"{name}: the audit {compile_}, want exact at {want_bits} bits")
        for h in of(recs, "train_health"):
            if not all(math.isfinite(h[k]) for k in ("grad_norm", "ef_memory_norm", "powersgd_rel_error", "loss")):
                fail(f"{name}: a health probe {h}")
        tags = {r["tag"] for r in of(recs, "collective")}
        fid = of(recs, "fidelity")
        if len(fid) != probes * (groups + 1) or any(r["tag"] not in tags for r in fid):
            fail(f"{name}: {len(fid)} fidelity events (want {probes * (groups + 1)}), tags {sorted({r['tag'] for r in fid})}"
                 f" against the ledger's {sorted(tags)}")
        bad = [r for r in of(recs, "failure") if r["kind"] in ("audit_error", "health_probe_error")]
        if bad:
            fail(f"{name}: {bad}")
        mem = of(recs, "memory")
        if on_cuda:
            limit = torch.cuda.get_device_properties(dev).total_memory
            if len(mem) != probes or not all(
                m["bytes_in_use"] > 0 and m["peak_bytes_in_use"] >= m["bytes_in_use"] and m["bytes_limit"] == limit
                for m in mem
            ):
                fail(f"{name}: memory events {mem} (the card holds {limit} bytes)")
        return {
            "records_by_kind": {k: sum(1 for r in recs if r["event"] == k) for k in sorted({r["event"] for r in recs})},
            "audit": {k: compile_[k] for k in ("analytic_bytes", "hlo_bytes", "exact", "hlo_by_kind", "compression_ratio")},
            "jsonl_bytes": os.path.getsize(path), "jsonl_bytes_per_step": os.path.getsize(path) / steps,
            "memory_peak_bytes": max((m["peak_bytes_in_use"] for m in mem), default=None),
            "memory_events": len(mem), "health": of(recs, "train_health"),
            "fidelity_worst": max(((r["rel_error"], r["group"], r["step"]) for r in fid), default=None),
        }

    def plain_pipeline(impl, reducer):
        """The probe's kernels swapped for their plain versions."""
        if impl == "xla":
            saved = reducer.orthogonalize_impl
            reducer.orthogonalize_impl = "eager"
            return lambda: setattr(reducer, "orthogonalize_impl", saved)
        saved = {k: getattr(reducers_mod, k) for k in (
            "fused_ef_compress", "fused_orthogonalize_project", "fused_decompress_residual")}
        reducers_mod.fused_ef_compress = lambda g, q, r=None: (
            (g, ps.compress_reference(g, q)) if r is None else ps.ef_compress_reference(g, q, r))
        reducers_mod.fused_orthogonalize_project = lambda p, m: ps.orthogonalize_project_reference(p, m)
        reducers_mod.fused_decompress_residual = ps.decompress_residual_reference
        return lambda: [setattr(reducers_mod, k, v) for k, v in saved.items()]

    def flat_probe(stats):
        out = {k: stats[k] for k in ("grad_norm", "ef_memory_norm", "powersgd_rel_error", "loss")}
        for g, vals in stats["fidelity"].items():
            out.update({f"{g}.{k}": v for k, v in vals.items()})
        return out

    def probe_check(impl, step, state):
        """The probe on the final state on the kernels, timed, then on
        their plain versions (inside the run: the probe's all-reduce needs
        its group)."""
        names = ("gram_schmidt",) if impl == "xla" else ("compress", "orthogonalize_project", "decompress_residual")
        ks = [k for k in (gs.KERNEL, *ps.KERNELS) if k.name in names]
        counts = {k.name: k.launches for k in ks}
        got = step.health_fn(state, batch)
        probe_launches = {k.name: k.launches - counts[k.name] for k in ks}
        t0 = time.perf_counter()
        for _ in range(TELEMETRY_PROBE_REPS):
            step.health_fn(state, batch)
        probe_ms = (time.perf_counter() - t0) * 1e3 / TELEMETRY_PROBE_REPS
        counts = {k.name: k.launches for k in ks}
        restore = plain_pipeline(impl, step.reducer)
        try:
            plain = step.health_fn(state, batch)
        finally:
            restore()
        plain_launches = {k.name: k.launches - counts[k.name] for k in ks}
        for k in ks:  # the checks' launches are not the run's
            k.launches = counts[k.name] - probe_launches[k.name] * (1 + TELEMETRY_PROBE_REPS)
        if on_cuda and (set(probe_launches.values()) != {n_groups} or any(plain_launches.values())):
            fail(f"{impl}: the probe launched {probe_launches}, its plain version {plain_launches}")
        tol = GS_TOL if impl == "xla" else FUSED_TOL
        got_f, plain_f = flat_probe(got), flat_probe(plain)
        if set(got_f) != set(plain_f):
            fail(f"{impl}: the probe's keys {sorted(got_f)} against its plain version's {sorted(plain_f)}")
        err = max(abs(got_f[k] - plain_f[k]) for k in plain_f)
        if not err <= tol:
            fail(f"{impl}: the probe on the kernels against its plain version: {err} > {tol}")
        return {
            "probe_launches": probe_launches, "probe_ms_per_call": probe_ms,
            "probe_against_plain_max_abs_err": err, "probe_tolerance": tol,
            "probe_rel_error": got["powersgd_rel_error"], "probe_rel_error_plain": plain["powersgd_rel_error"],
        }

    records = {}
    batch = tuple(torch.from_numpy(a).to(dev) for a in next(accumulated_batches(
        [images, labels], config("xla", False, ""), 1)(0)))
    for impl in ("xla", "pallas"):
        name = "main_path_telemetry" if impl == "xla" else "main_path_telemetry_fused"
        per_run = n_groups * steps
        runs, finals = [], []
        with deterministic_algorithms():
            for turn, on in enumerate((False, True, True, False)):
                tag = f"telemetry_{impl}_{turn}"
                cfg = config(impl, on, tag)
                if turn == 1:
                    cfg.trace_dir = os.path.join(tmp, f"trace_{impl}")
                extra = n_groups * probes if on else 0
                want = ({"gram_schmidt": per_run + extra} if impl == "xla" else {
                    "ef_compress": per_run, "compress": extra, "orthogonalize_project": per_run + extra,
                    "decompress_residual": per_run + extra})
                kept = {}
                loop = powersgd_cifar10.train_loop

                def keep(step, state, *args, turn=turn, **kwargs):
                    state, logger = loop(step, state, *args, **kwargs)
                    kept["state"] = state
                    if turn == 2:
                        kept["probe"] = probe_check(impl, step, state)
                    return state, logger

                powersgd_cifar10.train_loop = keep
                try:
                    result, peak = drive(tag, lambda: powersgd_cifar10.run(
                        cfg, preset=preset, device=dev, max_steps_per_epoch=steps), want if full else {})
                finally:
                    powersgd_cifar10.train_loop = loop
                runs.append((on, result, peak, cfg))
                # on the host, so that the runs' peaks do not hold the earlier finals
                finals.append({
                    **{k: v.cpu() for k, v in tensors_of(kept["state"]).items()},
                    "generator": kept["state"].reducer_state.generator.get_state(),
                })
                if turn == 2:
                    probe = kept["probe"]
                del kept
        paths[impl] = f"telemetry_{impl}_1"
        # the MFU join's inputs (offline_phases): the audit of the "on" run
        # without the trace and its steady step p50 (the first step dropped)
        steady = [r["step_time_s"] for r in of(records_of(runs[2][3].event_log), "step")][1:]
        mfu_inputs[name] = {
            "compile": of(records_of(runs[2][3].event_log), "compile")[0],
            "step_p50_s": statistics.median_low(steady) if steady else None, "n_steps": len(steady),
        }
        diffs = [bitwise_equal(f, finals[0]) for f in finals[1:]]
        if any(diffs):
            fail(f"{name}: the runs with the probe differ from those without it in {diffs}")
        want_bits = runs[1][1]["bits_per_step"]
        if full and want_bits != RESNET152_BITS + 32:
            fail(f"{name}: {want_bits} bits a step")
        log = check_log(name, runs[1][3].event_log, want_bits, n_groups)
        check_log(name, runs[2][3].event_log, want_bits, n_groups)
        trace_path = os.path.join(runs[1][3].trace_dir, TRACE_NAME)
        if not os.path.exists(trace_path):
            fail(f"{name}: no trace at {trace_path}")
        with open(trace_path) as f:
            trace_text = f.read()
        if f'"powersgd_cifar10#{steps - 1}"' not in trace_text:
            fail(f"{name}: the trace holds no range of step {steps - 1}")
        kernels_in_trace = kernels_from_chrome_trace(json.loads(trace_text))
        del trace_text
        if on_cuda:
            names = {k["name"] for k in kernels_in_trace}
            parts = ("gram_schmidt_kernel",) if impl == "xla" else (
                "ef_compress_kernel", "orthogonalize_project_kernel", "decompress_residual_kernel")
            missing = [p for p in parts if not any(p in n for n in names)]
            if missing:
                fail(f"{name}: the trace holds no {missing}")
        off = [m for on, r, _, _ in runs if not on for m in r["device_time_ms"][WARMUP_STEPS:] if m is not None]
        on_ = [m for on, r, _, _ in runs[2:3] for m in r["device_time_ms"][WARMUP_STEPS:] if m is not None]
        host = {
            label: statistics.median([s for i in idx for s in runs[i][1]["step_time_s"][WARMUP_STEPS:]])
            for label, idx in (("off", (0, 3)), ("on", (2,)), ("on_with_trace", (1,)))
        }
        records[impl] = {
            "phase": name, "model": "resnet152" if full else "resnet18_small", "compress_impl": impl,
            "global_batch": runs[0][3].global_batch_size, "steps": steps, "health_every": TELEMETRY_EVERY,
            "turns": ["off", "on+trace", "on", "off"], "bits_per_step": want_bits, "shape_groups": n_groups,
            "launches_by_turn": [launches.get(f"telemetry_{impl}_{turn}") for turn in range(4)],
            "state_bitwise_equal_with_and_without_probe": True, "log": log,
            "trace_bytes": os.path.getsize(trace_path), "trace_kernels": len(kernels_in_trace),
            "trace_overlap": {k: v for k, v in overlap_report(kernels_in_trace).items() if k != "collectives"},
            **probe,
            "step_device_ms_p50_off": statistics.median(off) if off else None,
            "step_device_ms_p50_on": statistics.median(on_) if on_ else None,
            "step_host_s_p50": host, "peak_memory_bytes": [r[2] for r in runs],
        }
        emit(records[impl])

    # exact_cifar10 under FSDP (ResNet-50) with its audit: the ledger of the
    # gathers, the reduce-scatters and the loss against what the step issued
    cfg = exact_cifar10.default_config()
    cfg.training_epochs, cfg.event_log, cfg.audit_wire = 1, os.path.join(tmp, "fsdp.jsonl"), True
    if not full:
        cfg.global_batch_size = 16
    result, _ = drive("telemetry_fsdp", lambda: exact_cifar10.run(
        cfg, preset=preset, device=dev, strategy="fsdp", max_steps_per_epoch=2), {}, kernel_free=True)
    recs = records_of(cfg.event_log)
    audits = of(recs, "compile")
    bits = FSDP_BITS if full else result["bits_per_step"]
    if (len(audits) != 1 or not audits[0]["exact"] or audits[0]["analytic_bytes"] * 8 != bits
            or result["bits_per_step"] != bits or of(recs, "failure")):
        fail(f"telemetry fsdp: audits {audits}, {result['bits_per_step']} bits (want {bits}), {of(recs, 'failure')}")
    emit({
        "phase": "main_path_telemetry_fsdp", "model": "resnet50" if full else "resnet18_small",
        "bits_per_step": bits, "audit": {k: audits[0][k] for k in ("analytic_bytes", "hlo_bytes", "exact", "hlo_by_kind")},
        "ledger": [{k: r[k] for k in ("tag", "op", "payload_bytes", "count")} for r in of(recs, "collective")],
    })
    shutil.rmtree(tmp, ignore_errors=True)
    return paths, mfu_inputs


def supervised_train_argv(preset, device, checkpoint_dir, event_log):
    """The training command of ``supervised_resume``'s launches and of
    ``main_path_fleet``'s training job: ``exact_cifar10`` at
    ``SUPERVISED_EPOCHS`` epochs of ``SUPERVISED_STEPS`` steps, checkpointed,
    with an event log (so with the audited first step)."""
    return [
        sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch", "exact_cifar10",
        "--preset", preset, "--device", device, "--epochs", str(SUPERVISED_EPOCHS),
        "--max-steps-per-epoch", str(SUPERVISED_STEPS), "--checkpoint-dir", checkpoint_dir, "--json",
        "--event-log", event_log, "--log-every", "0", *(["--global-batch", "16"] if preset == "small" else []),
    ]


def launch_bare_init():
    """``launch bare_init --json`` in a process of its own: its summary,
    which must name one device and the NCCL backend."""
    launched = subprocess.run(
        [sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch", "bare_init", "--json"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=300,
    )
    lines = launched.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if launched.returncode == 0 and lines else None
    if summary is None or summary.get("num_devices") != 1 or summary.get("backend") != "nccl":
        fail(f"launch bare_init exited {launched.returncode}: {launched.stdout[-2000:]} {launched.stderr[-2000:]}")
    return summary


def start_supervised_resume(dev, preset="full"):
    """Start ``supervised_resume``'s two launches (see ``chaos_phases``) in
    a thread: their processes launch no port kernel and this process reads
    no launch count of theirs, so ``main`` runs them while the kernels
    build, and times nothing until they have ended. Returns ``(future,
    root)``: the future's result is the phase's raw record, ``root`` the
    temporary directory of its files."""
    import torch

    from network_distributed_pytorch_tpu_torch.resilience import ChaosPlan, FaultSpec
    from network_distributed_pytorch_tpu_torch.utils.checkpoint import latest_step_path

    root = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    site = os.path.join(root, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(SUPERVISED_SITECUSTOMIZE)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([site, here, os.environ.get("PYTHONPATH", "")]))

    def launch_supervised(name, faults):
        run_dir = os.path.join(root, name)
        os.makedirs(run_dir)
        argv = supervised_train_argv(
            preset, dev.type, os.path.join(run_dir, "ckpt"), os.path.join(run_dir, "events.jsonl")
        ) + [
            "--supervise", "--num-processes", "1", "--restart-backoff", "0.05",
            "--worker-log-dir", os.path.join(run_dir, "logs"),
        ]
        if faults:
            ChaosPlan(faults).save(os.path.join(run_dir, "plan.json"))
            argv += ["--chaos-plan", os.path.join(run_dir, "plan.json")]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=run_dir, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            logs = ""
            for log in sorted(os.listdir(os.path.join(run_dir, "logs"))) if os.path.isdir(os.path.join(run_dir, "logs")) else []:
                with open(os.path.join(run_dir, "logs", log)) as f:
                    logs += f"--- {log}\n" + f.read()[-3000:]
            fail(f"supervised_resume {name}: exit {proc.returncode}: {proc.stderr[-2000:]} {logs}")
        events = []
        with open(os.path.join(run_dir, "events.jsonl")) as f:
            for line in f:
                try:
                    events.append(json.loads(line))
                except ValueError:
                    pass
        return json.loads(lines[-1]), events, wall, os.path.join(run_dir, "ckpt")

    def supervised_resume():
        # the unfaulted launch runs beside the faulted one (the workers'
        # algorithms are deterministic, so sharing the card changes no bit)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            clean_run = pool.submit(launch_supervised, "supervised_clean", [])
            faulted, events, wall, ckpt = launch_supervised("supervised_faulted", [
                FaultSpec(kind="proc_kill", step=SUPERVISED_STEPS + 1),
                FaultSpec(kind="proc_preempt", step=1, incarnation=1),
            ])
            clean, _, clean_wall, clean_ckpt = clean_run.result()
        steps = [e for e in events if e.get("event") == "step"]
        # each death to the first step the restarted worker finished
        recovery_ms = []
        for died, respawned in faulted["restart_times"]:
            after = [e["ts_mono"] for e in steps if e.get("ts_mono", 0) > respawned]
            recovery_ms.append((min(after) - died) * 1e3 if after else None)
        resumed = [e.get("message", "") for e in events if e.get("kind") == "resumed"]
        got = saved_leaves(latest_step_path(ckpt))
        want = saved_leaves(latest_step_path(clean_ckpt))
        differ = sorted(
            k for k in want
            if k not in got or (torch.is_tensor(want[k]) and not torch.equal(got[k], want[k]))
            or (not torch.is_tensor(want[k]) and got[k] != want[k])
        )
        return {
            "clean": clean, "faulted": faulted, "clean_wall_s": clean_wall, "faulted_wall_s": wall,
            "resumed": resumed, "death_to_first_step_ms": recovery_ms,
            "worker_exits": [e.get("message") for e in events if e.get("kind") == "worker_exit"],
            "final_checkpoint": os.path.basename(latest_step_path(ckpt)), "leaves": len(want),
            "differ_at": differ, "clean_ckpt": clean_ckpt, "wall_s": time.perf_counter() - t0,
        }


    return in_background(supervised_resume), root


def chaos_phases(dev, drive, images, labels, n_groups, smi, supervised, preset="full"):
    """``chaos_guarded`` and ``supervised_resume``: the chaos plan, the
    guarded step and the supervising launcher on one card, their files
    under a temporary directory removed at the end.

    ``chaos_guarded`` runs ResNet-152 PowerSGD through
    ``resilient_train_loop`` under deterministic algorithms: plan (a), a
    ``step_transient`` and a ``step_nan`` with ``step_retries=2``, must end
    bit for bit where the clean run ends; plan (b), a bad and a short batch
    with the batch guard, finite with one ``bad_batch_dropped`` a fault; a
    real NaN given to ``GuardedStep`` must leave the state bit for bit as
    it was once the guard gives up; the ``oom`` fault must write the report
    and raise ``OutOfMemoryError``; ``ckpt_torn`` and ``ckpt_bitflip`` must
    fall back to the previous epoch on resume (and land on the clean run);
    and the guarded step's time is held against the plain step's, in turns.

    ``supervised_resume`` runs ``launch exact_cifar10 --checkpoint-dir D
    --chaos-plan P --supervise --num-processes 1`` in a subprocess (started
    by :func:`start_supervised_resume`, ``supervised`` its return; ``main``
    starts it before the kernels' build), with
    ``proc_kill`` in the first life and ``proc_preempt`` in the second: it
    must succeed after 2 restarts, the second resuming mid-epoch from the
    emergency checkpoint, with a final checkpoint bit for bit that of the
    same launch without faults, which runs beside it (the workers run under
    deterministic algorithms, set by a ``sitecustomize`` on their
    ``PYTHONPATH``), and it reports the time from each death to the
    restarted worker's first step.
    ``preset="small"`` (global batch 16) rehearses both on the CPU.

    Returns the unfaulted run's checkpoint directory, moved out of the
    temporary directory (``fleet_phases`` holds its training job to it; the
    caller removes its parent)."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches, resilient_train_loop
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )
    from network_distributed_pytorch_tpu_torch.resilience import (
        ChaosPlan,
        FaultSpec,
        GuardedStep,
        NonFiniteLossError,
        OutOfMemoryError,
        make_topology,
    )
    from network_distributed_pytorch_tpu_torch.utils.checkpoint import latest_step_path, verify_checkpoint

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    supervised, root = supervised
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        # ---- chaos_guarded: ResNet-152 PowerSGD through the guarded loop ---------
        t_phase = time.perf_counter()
        cfg = powersgd_cifar10.default_config()
        cfg.compress_impl = "xla"
        if preset == "small":
            cfg.global_batch_size = 16
        batches = accumulated_batches([images, labels], cfg, max_steps_per_epoch=CHAOS_STEPS)

        def train(name, plan=None, **kw):
            _, step, state = powersgd_cifar10.build(cfg, preset, dev, group)
            events = Events()
            topology = make_topology(
                1, global_batch=cfg.global_batch_size, data_seed=cfg.seed, bits_per_step=step.bits_per_step,
                rng_seed=cfg.seed,
            )
            state, logger, start = resilient_train_loop(
                step, state, batches, CHAOS_EPOCHS, os.path.join(root, name), dev, topology=topology,
                telemetry=events, run_name=name, chaos_plan=plan, **kw,
            )
            return state, logger, start, [k for k, _ in events.seen]

        def chaos_guarded():
            out = {}
            with deterministic_algorithms():
                state, logger, _, _ = train("clean")
                ref = tensors_of(state)
                out["clean_losses"] = [r.loss for r in logger.records]
                del state
                plan = ChaosPlan([FaultSpec(kind="step_transient", step=1), FaultSpec(kind="step_nan", step=3)])
                state, logger, _, kinds = train("plan_a", plan, step_retries=2)
                out["plan_a"] = {
                    "steps": len(logger.records), "kinds": kinds, "differ_at": bitwise_equal(tensors_of(state), ref),
                }
                del state
                plan = ChaosPlan(
                    [FaultSpec(kind="loader_bad_batch", step=1), FaultSpec(kind="loader_short_batch", step=2)], seed=3
                )
                state, logger, _, kinds = train(
                    "plan_b", plan, guard_batches=True, expected_batch=cfg.global_batch_size
                )
                out["plan_b"] = {
                    "steps": len(logger.records), "kinds": kinds,
                    "finite": all(bool(torch.isfinite(v).all()) for v in state.params.values()),
                }
                del state
                # a real NaN on a real step: three attempts, then the state as it was
                _, step, state = powersgd_cifar10.build(cfg, preset, dev, group)
                good, bad = [
                    tuple(torch.from_numpy(a).to(dev) for a in b) for b in list(batches(0))[:2]
                ]
                state, _ = step(state, good)
                before = tensors_of(state)
                bad[0][0, 0, 0, 0] = float("nan")
                events = Events()
                guarded = GuardedStep(step, retries=2, backoff_seconds=0.0, telemetry=events, label="real_nan")
                try:
                    guarded(state, bad)
                    fail("chaos_guarded: a NaN batch gave a finite loss")
                except NonFiniteLossError:
                    pass
                out["real_nan"] = {
                    "kinds": [k for k, _ in events.seen], "differ_at": bitwise_equal(tensors_of(state), before),
                }
                # the guarded step against the plain one, in turns, from the same state
                plain_ms, guarded_ms = [], []
                good = [tuple(torch.from_numpy(a).to(dev) for a in b) for b in batches(1)][0]
                for turn in range(CHAOS_TURNS):
                    for fn, times in ((step, plain_ms), (guarded, guarded_ms)):
                        sync()
                        t0 = time.perf_counter()
                        state, loss = fn(state, good)
                        float(loss)
                        sync()
                        if turn:  # the first turn warms the snapshot's buffers
                            times.append((time.perf_counter() - t0) * 1e3)
                out["step_ms_p50"] = {"plain": statistics.median(plain_ms), "guarded": statistics.median(guarded_ms)}
                out["step_ms"] = {"plain": plain_ms, "guarded": guarded_ms}
                del state, guarded, before
                # the oom fault: the report in the working directory's artifacts/
                cwd = os.getcwd()
                os.makedirs(os.path.join(root, "oom"), exist_ok=True)
                os.chdir(os.path.join(root, "oom"))
                try:
                    train("oom", ChaosPlan([FaultSpec(kind="oom", step=0, payload={"bytes": 1 << 40})]), step_retries=2)
                    fail("chaos_guarded: the oom fault did not stop the run")
                except OutOfMemoryError:
                    pass
                finally:
                    os.chdir(cwd)
                with open(os.path.join(root, "oom", "artifacts", "oom_report.json")) as f:
                    report = json.load(f)
                out["oom"] = {"top_buffer": report["top_buffer"], "buffers": report["buffers"], "step": report["step"]}
                # the checkpoint faults: the resume falls back to step_0
                for kind in ("ckpt_torn", "ckpt_bitflip"):
                    train(kind, ChaosPlan([FaultSpec(kind=kind, step=1)], seed=3))
                    path = os.path.join(root, kind)
                    newest = latest_step_path(path)
                    state, logger, start, kinds = train(kind)
                    out[kind] = {
                        "newest_before_resume": os.path.basename(newest), "start_epoch": start,
                        "steps": len(logger.records), "kinds": kinds,
                        "step_1_verified_after": verify_checkpoint(os.path.join(path, "step_1"))[0],
                        "differ_at": bitwise_equal(tensors_of(state), ref),
                    }
                    del state
            return out

        result, peak = drive("chaos_guarded", chaos_guarded, {"gram_schmidt": CHAOS_K1_STEPS * n_groups})
        a, b = result["plan_a"], result["plan_b"]
        if a["differ_at"] or a["steps"] != CHAOS_EPOCHS * CHAOS_STEPS or a["kinds"].count("retry") != 2:
            fail(f"chaos_guarded plan (a): {a}")
        if not b["finite"] or b["kinds"].count("bad_batch_dropped") != 2 or b["steps"] != CHAOS_EPOCHS * CHAOS_STEPS - 2:
            fail(f"chaos_guarded plan (b): {b}")
        if result["real_nan"]["differ_at"] or result["real_nan"]["kinds"] != ["retry"] * 3:
            fail(f"chaos_guarded real NaN: {result['real_nan']}")
        for kind, newest in (("ckpt_torn", "step_0"), ("ckpt_bitflip", "step_1")):
            r = result[kind]
            if (r["newest_before_resume"], r["start_epoch"], r["steps"]) != (newest, 1, CHAOS_STEPS) or r["differ_at"] \
                    or not r["step_1_verified_after"] or (kind == "ckpt_bitflip" and "checkpoint_fallback" not in r["kinds"]):
                fail(f"chaos_guarded {kind}: {r}")
        emit({
            "phase": "chaos_guarded", "preset": preset, "global_batch": cfg.global_batch_size,
            "reducer_rank": cfg.reducer_rank, "compress_impl": "xla", "epochs": CHAOS_EPOCHS,
            "steps_per_epoch": CHAOS_STEPS, **result,
            "bitwise": "plan (a) and each checkpoint fault's resume: params, momenta, EF memories, Q and BN buffers"
                       " equal the clean run's; the real NaN: the state equals the state before the step",
            "launches": {"gram_schmidt": CHAOS_K1_STEPS * n_groups}, "peak_memory_bytes": peak, "nvidia_smi": smi,
            "wall_s": time.perf_counter() - t_phase,
        })
    finally:
        shutdown_distributed()

    try:
        result = supervised.result()
        f = result["faulted"]
        if not f["success"] or f["total_restarts"] != 2 or len(result["resumed"]) != 2 or result["differ_at"] \
                or "+2 steps" not in result["resumed"][-1] or None in result["death_to_first_step_ms"]:
            fail(f"supervised_resume: {result}")
        # the unfaulted run's checkpoints outlive this phase: main_path_fleet's
        # training job must end on its final checkpoint bit for bit
        kept = tempfile.mkdtemp(prefix="chip_smoke_clean_ckpt_")
        clean_ckpt = shutil.move(result.pop("clean_ckpt"), os.path.join(kept, "ckpt"))
        emit({
            "phase": "supervised_resume", "preset": preset, "epochs": SUPERVISED_EPOCHS,
            "steps_per_epoch": SUPERVISED_STEPS, **result,
            "bitwise": "every leaf of the final checkpoint equals the unfaulted supervised run's",
            "nvidia_smi": smi,
        })
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return clean_ckpt


def adaptive_phases(dev, drive, images, labels, smi, preset="full"):
    """``main_path_adaptive`` and ``main_path_hierarchical``: the adaptive
    communication path and the two-level round on one card (see the
    constants above); their files under a temporary directory removed at
    the end. ``preset="small"`` rehearses both on the CPU (the small
    ResNet-18, batch 16, and ResNet-18 for the round)."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10, powersgd_cifar10
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches, adaptive_train_loop
    from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss
    from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
    from network_distributed_pytorch_tpu_torch.ops.orthogonalize import orthogonalize
    from network_distributed_pytorch_tpu_torch.parallel import comm
    from network_distributed_pytorch_tpu_torch.parallel.hierarchical import (
        make_hierarchical_groups,
        make_hierarchical_train_fn,
    )
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )
    from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer
    from network_distributed_pytorch_tpu_torch.resilience import (
        ChaosPlan,
        CollectiveWatchdog,
        CommDeadlineGuard,
        FallbackController,
        FaultSpec,
        GuardedStep,
        StateSnapshot,
        ladder_from_plan,
    )

    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    def exact_state(state):
        """Params, momenta, EF memories and BN buffers, cloned (the exact
        reducer keeps no Q)."""
        return {f"{field}.{k}": v.detach().clone() for field in ("params", "momenta", "memories", "model_state")
                for k, v in getattr(state, field).items()}

    def kernel_names(fn):
        """The CUDA kernels ``fn()`` launches, by name and count (None on
        the CPU)."""
        if not on_cuda:
            fn()
            return None
        from torch.profiler import ProfilerActivity, profile

        # what was launched before (the snapshot's copies) must not land in the window
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        counts = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                counts[e.name] = counts.get(e.name, 0) + 1
        return counts

    root = tempfile.mkdtemp(prefix="chip_smoke_adaptive_")
    cfg = exact_cifar10.default_config()
    cfg.training_epochs = 2
    cfg.log_every = 0
    if preset == "small":
        cfg.global_batch_size = 16
    cfg.adaptive_comm = True
    cfg.comm_fabric = "NVLink4(H100)"
    cfg.plan_path = os.path.join(root, "plan_doc.json")
    with open(cfg.plan_path, "w") as f:
        json.dump({"ladder": {cfg.comm_fabric: ADAPTIVE_LADDER}}, f)
    cfg.chaos_plan = os.path.join(root, "chaos.json")
    ChaosPlan([FaultSpec(kind="comm_stall", step=2, payload={"stall_seconds": ADAPTIVE_STALL_S})]).save(cfg.chaos_plan)
    cfg.event_log = os.path.join(root, "events.jsonl")
    # the compress rung's shape groups: PowerSGD rank 4 over ResNet-50
    model = exact_cifar10.build_model(preset, dev, seed=cfg.seed)
    compress = PowerSGDReducer(random_seed=cfg.seed, compression_rank=cfg.reducer_rank)
    metas = compress._metas(list(model.parameters()))
    r50_shapes = [(len(p), metas[p[0]].n, metas[p[0]].r) for p in compress._shape_groups(metas)]
    del model
    n_groups = len(r50_shapes)
    try:
        # ---- main_path_adaptive ---------------------------------------------------
        t_phase = time.perf_counter()

        def main_path_adaptive():
            out = {}
            summary = exact_cifar10.run(cfg, preset=preset, device=dev, max_steps_per_epoch=ADAPTIVE_STEPS)
            with open(cfg.event_log) as f:
                events = [json.loads(line) for line in f]
            out["summary"] = {k: summary[k] for k in ("final_rung", "policy_decisions", "bits_per_step", "steps")}
            out["losses"] = summary["losses"]
            out["failures"] = [(e["kind"], e.get("label"), e.get("step")) for e in events if e.get("event") == "failure"]
            out["policy"] = [
                {k: e[k] for k in ("action", "trigger", "epoch", "rung_before", "rung_after",
                                   "predicted_bytes_per_step", "realized_bytes_per_step")}
                for e in events if e.get("event") == "policy"
            ]
            out["audits"] = [
                {k: e[k] for k in ("analytic_bytes", "hlo_bytes", "exact", "hlo_collective_count", "comm_config")}
                for e in events if e.get("event") == "compile"
            ]
            out["step_ms"] = [e["step_time_s"] * 1e3 for e in events if e.get("event") == "step"]
            # the carry: a scripted descent after epoch 0, the parameters
            # before it held against those after it
            group = initialize_distributed(DistributedConfig(), dev)
            try:
                model = exact_cifar10.build_model(preset, dev, seed=cfg.seed)
                factory = exact_cifar10.adaptive_step_factory(cfg, model, group)
                ladder = ladder_from_plan({"ladder": {cfg.comm_fabric: ADAPTIVE_LADDER}}, cfg.comm_fabric)
                built = []  # every state a step's init_state gave the loop, in order

                def keeping(overrides):
                    step = factory(overrides)
                    init = step.init_state

                    def init_state():
                        built.append(init())
                        return built[-1]

                    step.init_state = init_state
                    return step

                seen, carried = {}, {}

                class Scripted(FallbackController):
                    """Descends after epoch 0; checks the carry where the
                    loop reports the rebuild, before the new rung's first
                    step: the state it began with against the old one's
                    values at the verdict."""

                    def observe(self, health):
                        if health.epoch != 0:
                            return None
                        seen.update({f: {k: v.detach().clone() for k, v in getattr(built[-1], f).items()}
                                     for f in ("params", "momenta")})
                        return self._move(+1, "scripted", health.epoch)

                    def record(self, decision, **kw):
                        old, new = built[-2], built[-1]
                        carried.update(
                            rung=decision.rung_after,
                            params_bitwise=all(torch.equal(new.params[k], v) for k, v in seen["params"].items()),
                            momenta_bitwise=all(torch.equal(new.momenta[k], v) for k, v in seen["momenta"].items()),
                            params_same_tensors=all(new.params[k] is old.params[k] for k in old.params),
                            momenta_same_tensors=all(new.momenta[k] is old.momenta[k] for k in old.momenta),
                            memories_zero=all(not bool(m.any()) for m in new.memories.values()),
                        )
                        return super().record(decision, **kw)

                batches = accumulated_batches([images, labels], cfg, max_steps_per_epoch=ADAPTIVE_CARRY_STEPS)
                controller = Scripted(ladder=ladder)
                adaptive_train_loop(keeping, batches, 2, controller, dev, fabric=cfg.comm_fabric)
                out["carry"] = carried
                # the baseline rung's step: no hook, a no-op hook (the fence's
                # syncs) and the guard, in turns, each turn from the same state
                step = factory({})
                state = step.init_state()
                batch = tuple(torch.from_numpy(a).to(dev) for a in next(iter(batches(0))))
                watchdog = CollectiveWatchdog(n_workers=1, fabric=cfg.comm_fabric, label="timed")
                guarded = CommDeadlineGuard(GuardedStep(step, retries=2), watchdog, group=group)

                def noop(info):
                    pass

                def run_plain():
                    return step(state, batch)

                def run_hooked():
                    comm.add_fence_hook(noop)
                    try:
                        return step(state, batch)
                    finally:
                        comm.remove_fence_hook(noop)

                def run_guarded():
                    comm.add_fence_hook(watchdog)
                    try:
                        return guarded(state, batch)
                    finally:
                        comm.remove_fence_hook(watchdog)

                # hook-free against hooked from the same state (a snapshot):
                # the same kernels and the same bits; only the hooked one waits
                snap = StateSnapshot()
                snap.take(state)
                with deterministic_algorithms():
                    syncs = comm.fence_syncs()
                    plain_kernels = kernel_names(run_plain)
                    plain_syncs = comm.fence_syncs() - syncs
                    after_plain = exact_state(state)
                    snap.restore(state)
                    syncs = comm.fence_syncs()
                    hooked_kernels = kernel_names(run_hooked)
                    hooked_syncs = comm.fence_syncs() - syncs
                    after_hooked = exact_state(state)
                del snap
                out["hook_free_vs_hooked"] = {
                    "state_differs_at": bitwise_equal(after_hooked, after_plain),
                    "kernels_equal": plain_kernels == hooked_kernels,
                    # each kernel launched a different number of times: (hook-free, hooked)
                    "kernels_differ": {
                        k: ((plain_kernels or {}).get(k, 0), (hooked_kernels or {}).get(k, 0))
                        for k in set(plain_kernels or {}) | set(hooked_kernels or {})
                        if (plain_kernels or {}).get(k, 0) != (hooked_kernels or {}).get(k, 0)
                    },
                    "kernel_launches": sum((plain_kernels or {}).values()),
                    "fence_syncs": [plain_syncs, hooked_syncs],
                }
                times = {"plain": [], "hooked": [], "guarded": []}
                for turn in range(ADAPTIVE_TURNS):
                    for name, fn in (("plain", run_plain), ("hooked", run_hooked), ("guarded", run_guarded)):
                        sync()
                        t0 = time.perf_counter()
                        _, loss = fn()
                        float(loss)
                        sync()
                        if turn:  # the first turn warms the snapshot's buffers
                            times[name].append((time.perf_counter() - t0) * 1e3)
                watchdog.stop()
                p50 = {k: statistics.median(v) for k, v in times.items()}
                out["step_ms_p50"] = p50
                out["step_ms"] = times
                out["retire_sync_ms_per_step"] = p50["hooked"] - p50["plain"]
                out["guard_extra_ms_per_step"] = p50["guarded"] - p50["plain"]
                del state, step, guarded, model
            finally:
                shutdown_distributed()
            return out

        k1_adaptive = (ADAPTIVE_STEPS + ADAPTIVE_CARRY_STEPS) * n_groups
        result, peak = drive("main_path_adaptive", main_path_adaptive, {"gram_schmidt": k1_adaptive})
        # K1 at ResNet-50's compress groups against its plain version (these
        # launches are outside the path's count)
        gen = torch.Generator().manual_seed(5)
        xs = [torch.randn(shape, generator=gen).to(dev) for shape in r50_shapes]
        errs = [float((gs.gram_schmidt(x) - orthogonalize(x)).abs().max()) for x in xs]
        result["k1_resnet50"] = {"groups": len(xs), "tolerance": GS_TOL, "max_abs_err": max(errs)}
        if on_cuda:
            result["k1_resnet50"].update(
                ms=cuda_ms(lambda: [gs.gram_schmidt(x) for x in xs]),
                plain_ms=cuda_ms(lambda: [orthogonalize(x) for x in xs], reps=5),
            )
            result["k1_resnet50"]["bound_ms"], result["k1_resnet50"]["bound_by"] = gs_bound(r50_shapes)
        del xs
        kinds = [k for k, _, _ in result["failures"]]
        policy = result["policy"]
        if not policy or (policy[0]["rung_before"], policy[0]["rung_after"], policy[0]["epoch"]) != (
                "baseline", "compress", 0) or result["summary"]["final_rung"] not in ("compress", "compress-low-rank"):
            fail(f"main_path_adaptive: no descent to compress after epoch 0: {policy} {result['summary']}")
        if not {"chaos_injected", "comm_deadline", "comm_step_retry"} <= set(kinds):
            fail(f"main_path_adaptive: the stall did not expire and retry: {result['failures']}")
        audits = result["audits"]
        if len(audits) != 1 + len(policy) or not all(a["exact"] for a in audits) \
                or audits[0]["analytic_bytes"] != policy[0]["realized_bytes_per_step"] \
                or audits[1]["analytic_bytes"] != policy[0]["predicted_bytes_per_step"]:
            fail(f"main_path_adaptive: a rung's recorded bits differ from its bits_per_step: {audits} {policy}")
        if not all(math.isfinite(v) for v in result["losses"]) or len(result["losses"]) != 2 * ADAPTIVE_STEPS:
            fail(f"main_path_adaptive losses {result['losses']}")
        carry = result["carry"]
        if carry.get("rung") != "compress" or not all(carry[k] for k in (
                "params_bitwise", "momenta_bitwise", "params_same_tensors", "momenta_same_tensors",
                "memories_zero")):
            fail(f"main_path_adaptive: the switch did not carry the state: {carry}")
        hv = result["hook_free_vs_hooked"]
        if hv["state_differs_at"] or not hv["kernels_equal"] or hv["fence_syncs"][0] != 0 \
                or (on_cuda and hv["fence_syncs"][1] != 2):
            fail(f"main_path_adaptive: the hook-free step differs from the hooked one: {hv}")
        if result["k1_resnet50"]["max_abs_err"] > GS_TOL:
            fail(f"main_path_adaptive: K1 at ResNet-50's groups: {result['k1_resnet50']}")
        emit({
            "phase": "main_path_adaptive", "preset": preset, "global_batch": cfg.global_batch_size,
            "epochs": cfg.training_epochs, "steps_per_epoch": ADAPTIVE_STEPS, "ladder": ADAPTIVE_LADDER,
            "stall_s": ADAPTIVE_STALL_S, **result,
            "final_rung": result["summary"]["final_rung"], "policy_decisions": result["summary"]["policy_decisions"],
            "bitwise": "the carry: params and momenta after the switch equal those at the verdict (and are the same"
                       " tensors); the baseline rung's step with no hook equals it with a no-op hook (every tensor of"
                       " the state), with the same CUDA kernels",
            "launches": {"gram_schmidt": k1_adaptive}, "peak_memory_bytes": peak, "nvidia_smi": smi,
            "wall_s": time.perf_counter() - t_phase,
        })

        # ---- main_path_hierarchical ------------------------------------------------
        t_phase = time.perf_counter()
        hcfg = powersgd_cifar10.default_config()
        # 16 steps of the 4,096 synthetic images (the flagship's 512 gives 8)
        hcfg.global_batch_size = 16 if preset == "small" else 256
        hbatches = list(accumulated_batches([images, labels], hcfg, max_steps_per_epoch=HIER_H * len(HIER_PLAN))(0))
        rounds = [
            [tuple(torch.from_numpy(a).to(dev) for a in b) for b in hbatches[i * HIER_H:(i + 1) * HIER_H]]
            for i in range(len(HIER_PLAN))
        ]

        def hier_fn(impl, outer_async, group, groups):
            model = powersgd_cifar10.build_model(preset, dev, seed=hcfg.seed)
            reducer = PowerSGDReducer(random_seed=hcfg.seed, compression_rank=hcfg.reducer_rank, orthogonalize_impl=impl)
            kw = dict(outer_learning_rate=0.5, outer_momentum=0.5, outer_nesterov=False) if outer_async else {}
            return make_hierarchical_train_fn(
                image_classifier_loss(), model, inner_learning_rate=0.05, sync_every=HIER_H, outer_reducer=reducer,
                groups=groups, group=group, outer_async=outer_async, **kw,
            )

        @torch.no_grad()
        def copy_state(dst, src):
            """Every tensor of a round's carry, and the reducer's Q and generator."""
            for field in ("params", "anchors", "outer_momenta", "inner_opt", "memories", "inflight", "model_state"):
                for k, v in getattr(src, field).items():
                    getattr(dst, field)[k].copy_(v)
            dst.reducer_state.q_memory.copy_(src.reducer_state.q_memory)
            dst.reducer_state.generator.set_state(src.reducer_state.generator.get_state())

        def state_diff(a, b):
            """The largest difference over every tensor a round writes (under
            outer_async the round's outer update lands in inflight, not yet in
            the parameters) and Q, with where it is."""
            diffs = [
                (float((getattr(a, f)[k] - getattr(b, f)[k]).abs().max()), f"{f}.{k}")
                for f in ("params", "anchors", "outer_momenta", "memories", "inflight") for k in a.params
            ]
            diffs.append((float((a.reducer_state.q_memory - b.reducer_state.q_memory).abs().max()), "q_memory"))
            return max(diffs)

        def hier_runs(outer_async, group, groups):
            """The rounds with K1, each also run with K1's plain version from
            a copy of the state it started from: what each round writes held
            against the plain round's. Beside it, the trajectories: K1's
            against the plain version's over all the rounds, and the plain
            version's against itself from parameters (and anchors) moved 1
            ulp up."""
            fn, twin = hier_fn("auto", outer_async, group, groups), hier_fn("eager", outer_async, group, groups)
            state, twin_state = fn.init_state(), twin.init_state()
            plain, nudged = hier_fn("eager", outer_async, group, groups), hier_fn("eager", outer_async, group, groups)
            plain_state, nudged_state = plain.init_state(), nudged.init_state()
            copy_state(plain_state, state)
            copy_state(nudged_state, state)
            with torch.no_grad():
                for f in ("params", "anchors"):
                    for v in getattr(nudged_state, f).values():
                        v.copy_(torch.nextafter(v, torch.full_like(v, math.inf)))
            losses, plain_losses, recorded, by_level, round_ms, diffs = [], [], [], [], [], []
            k1_vs_plain, plain_vs_nudged = [], []
            k1 = 0
            for kind, batches in zip(HIER_PLAN, rounds):
                copy_state(twin_state, state)
                levels = {"inner": 0, "outer": 0}

                def by_tag(info, levels=levels):
                    if info["phase"] == "retire":
                        levels[info["tag"].split(".", 1)[0]] += info["payload_bytes"]

                comm.add_fence_hook(by_tag)
                sync()
                before = gs.KERNEL.launches
                t0 = time.perf_counter()
                try:
                    with comm.record_collectives() as records:
                        state, round_losses = fn(state, batches, local=kind == "local")
                    losses.append(round_losses.tolist())
                finally:
                    comm.remove_fence_hook(by_tag)
                sync()
                round_ms.append((time.perf_counter() - t0) * 1e3)
                k1 += gs.KERNEL.launches - before
                recorded.append(8 * sum(r.payload_bytes for r in records))
                by_level.append({k: 8 * v for k, v in levels.items()})
                twin_state, twin_losses = twin(twin_state, batches, local=kind == "local")
                plain_losses.append(twin_losses.tolist())
                diffs.append(state_diff(state, twin_state))
                plain_state, _ = plain(plain_state, batches, local=kind == "local")
                nudged_state, _ = nudged(nudged_state, batches, local=kind == "local")
                k1_vs_plain.append(state_diff(state, plain_state))
                plain_vs_nudged.append(state_diff(plain_state, nudged_state))
            bits = {
                "round": fn.bits_per_round, "local": fn.local_bits_per_round, "inner": fn.inner_bits_per_round,
                "outer": fn.outer_bits_per_round, "ledger_total": fn.ledger.total_bits(),
            }
            worst = max(diffs)
            return {
                "kernel": {"losses": losses, "recorded_bits": recorded, "hooked_bits": by_level, "round_ms": round_ms,
                           "bits": bits},
                "plain_losses": plain_losses, "k1_launches": k1,
                "max_state_diff_by_round": [d[0] for d in diffs],
                "max_state_diff": worst[0], "max_state_diff_at": worst[1],
                "trajectory_unchecked": {
                    "k1_vs_plain_by_round": [d[0] for d in k1_vs_plain], "k1_vs_plain_at": k1_vs_plain[-1][1],
                    "plain_vs_plain_1ulp_by_round": [d[0] for d in plain_vs_nudged],
                    "plain_vs_plain_1ulp_at": plain_vs_nudged[-1][1],
                },
            }

        def main_path_hierarchical():
            out = {}
            group = initialize_distributed(DistributedConfig(), dev)
            try:
                groups = make_hierarchical_groups(1, group)
                with deterministic_algorithms():
                    for outer_async in (False, True):
                        out["async" if outer_async else "sync"] = hier_runs(outer_async, group, groups)
            finally:
                shutdown_distributed()
            return out

        hmodel = powersgd_cifar10.build_model(preset, dev, seed=hcfg.seed)
        hred = PowerSGDReducer(random_seed=hcfg.seed, compression_rank=hcfg.reducer_rank)
        hmetas = hred._metas(list(hmodel.parameters()))
        h_groups = len(hred._shape_groups(hmetas))
        del hmodel
        syncs = sum(1 for k in HIER_PLAN if k == "sync")
        k1_hier = 2 * syncs * h_groups
        result, peak = drive("main_path_hierarchical", main_path_hierarchical, {"gram_schmidt": k1_hier})
        for name in ("sync", "async"):
            r = result[name]
            bits = r["kernel"]["bits"]
            want_recorded = [bits["local"] if k == "local" else bits["round"] for k in HIER_PLAN]
            want_hooked = [
                {"inner": bits["local"] - HIER_H * 32, "outer": 0} if k == "local"
                else {"inner": bits["inner"] - HIER_H * 32, "outer": bits["outer"]} for k in HIER_PLAN
            ]
            if (on_cuda and r["k1_launches"] != syncs * h_groups) or not math.isfinite(r["max_state_diff"]) \
                    or r["max_state_diff"] > PARAM_TOL or bits["ledger_total"] != bits["round"] \
                    or r["kernel"]["recorded_bits"] != want_recorded or r["kernel"]["hooked_bits"] != want_hooked:
                fail(f"main_path_hierarchical {name}: {r}")
        emit({
            "phase": "main_path_hierarchical", "preset": preset, "global_batch": hcfg.global_batch_size,
            "grid": "1 x 1", "sync_every": HIER_H, "rounds": list(HIER_PLAN), "outer_reducer_rank": hcfg.reducer_rank,
            "shape_groups": h_groups, **result, "tolerance": PARAM_TOL,
            "launches": {"gram_schmidt": k1_hier}, "peak_memory_bytes": peak, "nvidia_smi": smi,
            "wall_s": time.perf_counter() - t_phase,
        })
    finally:
        shutil.rmtree(root, ignore_errors=True)


def read_records(path, event=None):
    """The JSON objects of a JSON-lines file, torn lines skipped; with
    ``event``, only those of that event."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and (event is None or rec.get("event") == event):
                out.append(rec)
    return out


def start_live_plain(dev, preset="full"):
    """``main_path_live``'s launch without ``--run-dir`` and
    ``--metrics-port``, started in a thread: on the baseline rung its
    processes launch no port kernel, and only its losses are read, so
    ``main`` runs it while the kernels build. Returns ``(future, root,
    launch_live)``: the future's result is that launch's record, the rest
    :func:`live_launcher`'s."""
    root, launch_live = live_launcher(dev, preset)
    return in_background(launch_live, "live_plain", False), root, launch_live


def live_launcher(dev, preset="full", site_extra=""):
    """The live phases' files, under a temporary directory (the workers'
    ``sitecustomize``, with ``site_extra`` appended, and the plan
    document), and their launcher. Returns ``(root, launch_live)``:
    ``launch_live(name, plane, faults=(), env=None)`` runs one launch (see
    :func:`live_phases`), with ``env`` added to the workers'
    environment."""
    import urllib.request

    from network_distributed_pytorch_tpu_torch.observe import live
    from network_distributed_pytorch_tpu_torch.resilience import ChaosPlan

    root = tempfile.mkdtemp(prefix="chip_smoke_live_")
    site = os.path.join(root, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(SUPERVISED_SITECUSTOMIZE + site_extra)
    here = os.path.dirname(os.path.abspath(__file__))
    plan_doc = os.path.join(root, "plan_doc.json")
    with open(plan_doc, "w") as f:
        json.dump({"ladder": {"NVLink4(H100)": LIVE_LADDER}}, f)

    def launch_live(name, plane, faults=(), env=None):
        """One supervised launch: its summary, the worker's summary, its
        events, the mid-run scrape, its wall seconds and the worker's K1
        launches."""
        d = os.path.join(root, name)
        run_dir = os.path.join(d, "run")
        os.makedirs(d)
        launches_file = os.path.join(d, "launches.jsonl")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([site, here, os.environ.get("PYTHONPATH", "")]),
                   CHIP_SMOKE_LAUNCHES=launches_file, **(env or {}))
        argv = [
            sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch", "exact_cifar10",
            "--preset", preset, "--device", dev.type, "--epochs", "2", "--max-steps-per-epoch", str(LIVE_STEPS),
            "--supervise", "--num-processes", "1", "--alert-restart-after", "3", "--adaptive-comm",
            "--plan", plan_doc, "--comm-chunks", str(LIVE_CHUNKS), "--json", "--log-every", "0",
            "--worker-log-dir", os.path.join(d, "logs"), *(["--global-batch", "16"] if preset == "small" else []),
        ]
        if plane:
            argv += ["--run-dir", run_dir, "--metrics-port", "0"]
        if faults:
            ChaosPlan(list(faults)).save(os.path.join(d, "chaos.json"))
            argv += ["--chaos-plan", os.path.join(d, "chaos.json")]
        scrape, done = {}, threading.Event()

        def scraper():
            while not done.is_set():
                port = live.read_port_file(run_dir)
                if port is not None:
                    try:
                        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2.0) as resp:
                            body = resp.read().decode()
                        steps = [float(line.split()[-1]) for line in body.splitlines()
                                 if line.startswith("live_steps_total{")]
                        if steps and max(steps) > 0:
                            scrape.update(status=resp.status, port=port, steps_total=max(steps),
                                          lines=len(body.splitlines()), t=time.perf_counter())
                            return
                    except OSError:
                        pass
                time.sleep(0.05)

        thread = threading.Thread(target=scraper, daemon=True)
        if plane:
            thread.start()
        t0, t0_unix = time.perf_counter(), time.time()
        proc = subprocess.run(argv, cwd=d, env=env, capture_output=True, text=True, timeout=600)
        wall, t1_unix = time.perf_counter() - t0, time.time()
        done.set()
        if plane:
            thread.join(timeout=5.0)
        logs = os.path.join(d, "logs")
        log_text = ""
        for log in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
            with open(os.path.join(logs, log)) as f:
                log_text += f"--- {log}\n" + f.read()
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            fail(f"{name}: exit {proc.returncode}: {proc.stderr[-2000:]} {log_text[-4000:]}")
        worker = None
        for line in log_text.splitlines():
            if line.startswith("{") and '"losses"' in line:
                worker = json.loads(line)
        if worker is None:
            fail(f"{name}: no worker summary in {logs}: {log_text[-3000:]}")
        k1 = sum(r["gram_schmidt"] for r in read_records(launches_file))
        return {
            "summary": json.loads(lines[-1]), "worker": worker, "run_dir": run_dir, "scrape": scrape,
            "scrape_s_after_start": scrape["t"] - t0 if "t" in scrape else None, "wall_s": wall, "k1": k1,
            "unix": (t0_unix, t1_unix),
        }
    return root, launch_live


def live_phases(dev, drive, smi, started, preset="full"):
    """``main_path_live`` and ``main_path_live_nudge``: the run directory
    and the live telemetry plane of a supervised run, through the
    launcher's entry point in a subprocess (``launch exact_cifar10
    --supervise --run-dir D --metrics-port 0 --alert-restart-after 3
    --adaptive-comm --plan P``; see the constants above), the workers under
    deterministic algorithms by ``SUPERVISED_SITECUSTOMIZE``; files under
    the temporary directory of ``started``, the return of
    :func:`start_live_plain`, whose launch without the plane ``main``
    starts before the kernels' build.

    ``main_path_live``: the port file appears and a scrape while the run is
    alive returns 200 with step counters above 0; no critical alert, no
    ``alert:`` decision and no ``alert_restart``; ``merge_run`` finds the
    shard led by its ``run_start`` marker; the live step p50 within 5 % of
    ``rank_step_stats`` over the merged run; the losses bit for bit those
    of the same launch without ``--run-dir`` and ``--metrics-port``.

    ``main_path_live_nudge``: the same launch under a ``comm_throttle``: a
    ``step_time_drift`` or ``bandwidth_collapse`` alert in ``alerts.jsonl``
    and the supervisor's log, the worker's controller moving to
    ``compress`` on an ``alert:`` trigger (it fails, and says so, if the
    deadline guard moves the rung first), the audit exact on both rungs,
    finite losses, and K1 launched in the worker once a shape group a step
    on ``compress`` (its count from the worker's own wrapper, written at
    its exit). ``preset="small"`` rehearses both on the CPU (the small
    ResNet-18, global batch 16).

    Returns ``(k1, live)``: ``k1`` is that count; ``live`` names the temporary directory (the
    caller removes it once ``offline_phases`` has read it; this function
    removes it only when it fails) and, for each phase, its run directory,
    the merged run's and the live plane's step p50 and its steps."""
    from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10
    from network_distributed_pytorch_tpu_torch.observe import analytics, live, runlog
    from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer
    from network_distributed_pytorch_tpu_torch.resilience import FaultSpec

    plain_run, root, launch_live = started
    on_cuda = dev.type == "cuda"
    # the compress rung's shape groups (PowerSGD rank 4), from the model's shapes
    cfg = exact_cifar10.default_config()
    model = exact_cifar10.build_model(preset, "cpu", seed=cfg.seed)
    compress = PowerSGDReducer(random_seed=cfg.seed, compression_rank=4)
    n_groups = len(compress._shape_groups(compress._metas(list(model.parameters()))))
    del model

    def plane_of(run):
        """What the run directory holds: the supervisor's log, the shard,
        the alerts, the merge, and the live p50 against the report's."""
        run_dir = run["run_dir"]
        sup = read_records(os.path.join(run_dir, runlog.SUPERVISOR_LOG))
        shard = read_records(runlog.shard_path(run_dir, 0))
        merged = runlog.merge_run(run_dir)
        stats = analytics.rank_step_stats(merged.events)
        agg = live.LiveAggregator(run_dir)
        agg.poll()
        return {
            "sup": sup, "shard": shard, "alerts": read_records(os.path.join(run_dir, runlog.ALERTS_LOG), "alert"),
            "per_rank": merged.per_rank, "stats": stats, "torn_lines": merged.torn_lines,
            "live_p50_s": agg.registry.get_gauge("live_step_time_p50_seconds"),
            "report_p50_s": analytics.percentile([v["p50_s"] for v in stats.values()], 50) if stats else None,
            "manifest": runlog.RunManifest.load(run_dir),
        }

    def plane_summary(run, plane):
        steps = [r for r in plane["shard"] if r.get("event") == "step"]
        # where the wall went, on the host's clock (unix seconds from the spawn)
        spawned = plane["manifest"].spawns[0]["spawned_unix"] if plane["manifest"].spawns else None
        at = {"marker": plane["shard"][0].get("ts") if plane["shard"] else None,
              "first_step": steps[0].get("ts") if steps else None, "last_step": steps[-1].get("ts") if steps else None}
        for r in plane["sup"]:
            if r.get("kind") in ("worker_complete", "run_complete"):
                at[r["kind"]] = r.get("ts")
        at["exit"] = run["unix"][1]
        return {
            "parent_start_to_spawn_s": spawned - run["unix"][0] if spawned is not None else None,
            "wall_from_spawn_s": {k: (v - spawned if v is not None and spawned is not None else None)
                                  for k, v in at.items()},
            "supervisor_kinds": [r["kind"] for r in plane["sup"] if r.get("event") == "failure"],
            "alerts": [(a["alert"], a["severity"], a.get("rank"), a.get("step")) for a in plane["alerts"]],
            "policy": [{k: r.get(k) for k in ("trigger", "epoch", "rung_before", "rung_after",
                                               "predicted_bytes_per_step", "realized_bytes_per_step")}
                       for r in plane["shard"] if r.get("event") == "policy"],
            "audits": [{k: r.get(k) for k in ("analytic_bytes", "hlo_bytes", "exact")}
                       for r in plane["shard"] if r.get("event") == "compile"],
            "step_ms": [1e3 * r["step_time_s"] for r in steps],
            # where a deadline expired and the step it retried (the expiry's own step is None)
            "deadline_events": [{k: r.get(k) for k in ("kind", "label", "step", "message", "ts")}
                                for r in plane["shard"] if r.get("event") == "failure"
                                and r.get("kind") in ("comm_deadline", "comm_step_retry")],
            "per_rank": {str(k): v for k, v in plane["per_rank"].items()}, "torn_lines": plane["torn_lines"],
            "live_p50_s": plane["live_p50_s"], "report_p50_s": plane["report_p50_s"],
            "scrape": {k: v for k, v in run["scrape"].items() if k != "t"},
            "scrape_s_after_start": run["scrape_s_after_start"], "launch_wall_s": run["wall_s"],
            "run_id": run["summary"].get("run_id"), "spawns": len(plane["manifest"].spawns),
        }

    def check_plane(name, run, plane):
        out = plane_summary(run, plane)
        shard = plane["shard"]
        marker = shard[0] if shard else {}
        if run["scrape"].get("status") != 200 or not run["scrape"].get("steps_total", 0) > 0 \
                or run["scrape"]["steps_total"] >= 2 * LIVE_STEPS:
            fail(f"{name}: no scrape with step counters while the run was alive: {out['scrape']}")
        if (marker.get("event"), marker.get("kind"), marker.get("run_id")) != ("marker", "run_start",
                                                                              run["summary"]["run_id"]) \
                or plane["per_rank"][0].get("missing") or plane["per_rank"][0]["markers"] != 1 or plane["torn_lines"]:
            fail(f"{name}: the shard is not led by its run_start marker: {marker} {plane['per_rank']}")
        live_p50, rep_p50 = plane["live_p50_s"], plane["report_p50_s"]
        if not (live_p50 and rep_p50 and abs(live_p50 - rep_p50) <= 0.05 * rep_p50):
            fail(f"{name}: live step p50 {live_p50} against the merged run's {rep_p50}")
        if "alert_restart" in out["supervisor_kinds"] or not run["summary"]["success"] \
                or run["summary"]["total_restarts"] != 0:
            fail(f"{name}: the run restarted or failed: {run['summary']} {out['supervisor_kinds']}")
        if not all(math.isfinite(v) for v in run["worker"]["losses"]) \
                or len(run["worker"]["losses"]) != 2 * LIVE_STEPS:
            fail(f"{name}: losses {run['worker']['losses']}")
        return out

    try:
        # ---- main_path_live -------------------------------------------------------
        t_phase = time.perf_counter()

        def main_path_live():
            plain = plain_run.result()
            run = launch_live("live", plane=True)
            plane = plane_of(run)
            out = check_plane("main_path_live", run, plane)
            out["plain_launch_wall_s"] = plain["wall_s"]
            out["losses_differ_at"] = [i for i, (a, b) in enumerate(zip(run["worker"]["losses"],
                                                                        plain["worker"]["losses"])) if a != b]
            out["losses"] = run["worker"]["losses"]
            out["final_rung"] = run["worker"]["final_rung"]
            out["k1"] = run["k1"] + plain["k1"]
            out["run_dir"], out["steps"] = run["run_dir"], [r["step"] for r in plane["shard"] if r.get("event") == "step"]
            return out

        live_result, _ = drive("main_path_live", main_path_live, {}, kernel_free=True)
        if any(a[1] == "critical" for a in live_result["alerts"]) \
                or any(str(p["trigger"]).startswith("alert:") for p in live_result["policy"]):
            fail(f"main_path_live: a page on a clean run: {live_result['alerts']} {live_result['policy']}")
        if live_result["losses_differ_at"] or live_result["final_rung"] != "baseline" or live_result["k1"]:
            fail(f"main_path_live: the plane changed the training: {live_result}")
        clean_p50_s = statistics.median(live_result["step_ms"][2:]) / 1e3
        emit({
            "phase": "main_path_live", "preset": preset, "epochs": 2, "steps_per_epoch": LIVE_STEPS,
            "comm_chunks": LIVE_CHUNKS, "ladder": LIVE_LADDER, **live_result,
            "bitwise": "the losses equal those of the same launch without --run-dir and --metrics-port",
            "nvidia_smi": smi, "wall_s": time.perf_counter() - t_phase,
        })

        # ---- main_path_live_nudge ---------------------------------------------------
        t_phase = time.perf_counter()
        # the throttle: each of the baseline's fenced chunks sleeps its share
        # of (LIVE_SLOWDOWN - 1) clean steps, at most LIVE_CHUNK_SLEEP_S
        base_bytes = live_result["audits"][0]["analytic_bytes"]
        chunk_bytes = base_bytes / LIVE_CHUNKS
        chunk_sleep_s = min(LIVE_CHUNK_SLEEP_S, (LIVE_SLOWDOWN - 1.0) * clean_p50_s / LIVE_CHUNKS)
        throttle = {"bytes_per_s": chunk_bytes / chunk_sleep_s, "max_sleep_s": LIVE_CHUNK_SLEEP_S,
                    "duration_steps": 2 * LIVE_STEPS - LIVE_THROTTLE_STEP}

        def main_path_live_nudge():
            run = launch_live("live_nudge", plane=True, faults=[
                FaultSpec(kind="comm_throttle", step=LIVE_THROTTLE_STEP, payload=throttle)])
            plane = plane_of(run)
            out = check_plane("main_path_live_nudge", run, plane)
            # the steps after the decision, in the shard's order: the compress rung's
            after, on_compress = False, 0
            for r in plane["shard"]:
                if r.get("event") == "policy":
                    after = True
                elif r.get("event") == "step" and after:
                    on_compress += 1
            out.update(
                k1=run["k1"], steps_on_compress=on_compress, losses=run["worker"]["losses"],
                final_rung=run["worker"]["final_rung"], bits_per_step=run["worker"]["bits_per_step"],
                comm_deadlines=[r.get("step") for r in plane["shard"] if r.get("kind") == "comm_deadline"],
                alert_in_supervisor_log=[r["alert"] for r in plane["sup"] if r.get("event") == "alert"],
                run_dir=run["run_dir"], steps=[r["step"] for r in plane["shard"] if r.get("event") == "step"],
            )
            return out

        result, _ = drive("main_path_live_nudge", main_path_live_nudge, {}, kernel_free=True)
        policy, alerts = result["policy"], result["alerts"]
        comm = [a for a in alerts if a[0] in ("step_time_drift", "bandwidth_collapse")]
        if policy and not str(policy[0]["trigger"]).startswith("alert:"):
            fail(f"main_path_live_nudge: the rung moved on {policy[0]['trigger']!r} before any alert (the deadline"
                 f" guard moved it first): resize the throttle. {policy} {result['deadline_events']}"
                 f" chunk sleep {1e3 * chunk_sleep_s} ms, steps {result['step_ms']}")
        if not comm or comm[0][0] not in result["alert_in_supervisor_log"]:
            fail(f"main_path_live_nudge: no step_time_drift or bandwidth_collapse alert: {alerts}")
        if len(policy) != 1 or policy[0]["rung_after"] != "compress" or result["final_rung"] != "compress" \
                or policy[0]["trigger"] != f"alert:{comm[0][0]}:{comm[0][1]}":
            fail(f"main_path_live_nudge: no alert: decision to compress: {policy} {alerts}")
        audits = result["audits"]
        if len(audits) != 2 or not all(a["exact"] for a in audits) \
                or audits[0]["analytic_bytes"] != policy[0]["realized_bytes_per_step"] \
                or audits[1]["analytic_bytes"] != policy[0]["predicted_bytes_per_step"] \
                or 8 * audits[1]["analytic_bytes"] != result["bits_per_step"]:
            fail(f"main_path_live_nudge: the audits: {audits} {policy}")
        if preset == "full" and (audits[0]["analytic_bytes"], audits[1]["analytic_bytes"]) != (94_114_092, 1_516_540):
            fail(f"main_path_live_nudge: bytes a step {audits}, expected 94,114,092 then 1,516,540")
        want_k1 = result["steps_on_compress"] * n_groups
        if not result["steps_on_compress"] or (on_cuda and result["k1"] != want_k1):
            fail(f"main_path_live_nudge: K1 launched {result['k1']} times in the worker, expected"
                 f" {result['steps_on_compress']} steps x {n_groups} groups")
        step_ms = result["step_ms"]
        nudged_at = 2 * LIVE_STEPS - result["steps_on_compress"]  # the first step on compress
        throttled = step_ms[LIVE_THROTTLE_STEP + 1:nudged_at]
        slowdown = statistics.median(throttled) / (1e3 * clean_p50_s) if throttled else None
        if on_cuda and not (slowdown and slowdown >= 2.0):
            fail(f"main_path_live_nudge: the throttle slowed the step {slowdown}x, not 2x: resize it. {step_ms}")
        emit({
            "phase": "main_path_live_nudge", "preset": preset, "epochs": 2, "steps_per_epoch": LIVE_STEPS,
            "comm_chunks": LIVE_CHUNKS, "throttle": {"step": LIVE_THROTTLE_STEP, **throttle},
            "clean_step_p50_ms": 1e3 * clean_p50_s, "chunk_sleep_ms": 1e3 * chunk_sleep_s, "slowdown": slowdown,
            "alert_step": comm[0][3], "alert_steps_after_throttle": comm[0][3] - LIVE_THROTTLE_STEP,
            "first_step_on_compress": nudged_at, "shape_groups": n_groups, **result,
            "launches_in_worker": {"gram_schmidt": result["k1"]}, "nvidia_smi": smi,
            "wall_s": time.perf_counter() - t_phase,
        })
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    live = {"root": root, "runs": {
        name: {k: r[k] for k in ("run_dir", "report_p50_s", "live_p50_s", "steps")}
        for name, r in (("main_path_live", live_result), ("main_path_live_nudge", result))
    }}
    return result["k1"], live


def offline_phases(dev, drive, mfu_inputs, live, smi):
    """The offline analyses on what the telemetry and live phases left; no
    training process, no kernel (``drive`` holds every count at 0).

    ``main_path_mfu``: each telemetry phase's audit (``flops_per_step``
    from ``torch.utils.flop_counter``, ``flops_source`` ``"flop_counter"``)
    joined with its steady step p50 by ``observe.mfu.mfu_from_compile_records``;
    on the card the peak must be the table's ``"h100"`` row (a device kind
    the table does not know fails here) and the MFU in (0, 1).

    ``main_path_offline``: ``scripts/torch_report.py``'s ``run_report`` of
    each live run directory: its step p50 the merged run's that
    ``live_phases`` printed (and within 5 % of the live plane's, as there);
    the critical path over every step with ``blame_by_rank == {"0": 1.0}``
    and ``comm_share == 0.0`` (the real loop has no ``step/comm`` span); no
    fabric matrix at world 1; ``costmodel.calibrate(report,
    source_fabric="NVLink4(H100)")``, ``build_plan`` over the four fabric
    rows and ``prediction_events``: schema 1, every prediction above 0 s;
    the launcher's ``apply_plan`` of it: the ``ExperimentConfig`` takes the
    plan's knobs for ``NVLink4(H100)``. Printed, unchecked: the predicted
    step of the run's own config on ``NVLink4(H100)`` against the measured
    p50 (``join_realized``'s ``error``)."""
    import importlib.util

    from network_distributed_pytorch_tpu_torch import launch
    from network_distributed_pytorch_tpu_torch.observe import costmodel, mfu
    from network_distributed_pytorch_tpu_torch.utils.bandwidth import FABRICS_BYTES_PER_S

    on_cuda = dev.type == "cuda"
    t_offline = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "torch_report", os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "torch_report.py"))
    torch_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_report)

    # ---- main_path_mfu ------------------------------------------------------------
    def main_path_mfu():
        out = {}
        for name, inp in mfu_inputs.items():
            c = inp["compile"]
            joined = mfu.mfu_from_compile_records([c], inp["step_p50_s"], n_steps=inp["n_steps"])
            if len(joined) != 1 or not (c.get("flops_per_step") or 0) > 0 or c.get("flops_source") != "flop_counter":
                fail(f"main_path_mfu: {name}'s audit carries no counted FLOPs: {c}")
            m = joined[0].record()
            if on_cuda and (c.get("peak_flops_per_s") != mfu.PEAK_BF16_FLOPS["h100"]
                            or m["peak_flops_per_s"] != mfu.PEAK_BF16_FLOPS["h100"]):
                fail(f"main_path_mfu: {name} on {c.get('device_kind')!r}: peak {c.get('peak_flops_per_s')}, not the"
                     f" table's h100 row {mfu.PEAK_BF16_FLOPS['h100']}")
            if on_cuda and not (m["mfu"] is not None and 0 < m["mfu"] < 1):
                fail(f"main_path_mfu: {name}'s MFU {m['mfu']} is not in (0, 1): {m}")
            if not on_cuda and (m["mfu"] is not None or m["bound"] != "unknown"):
                fail(f"main_path_mfu: {name} on the CPU published {m}")
            out[name] = {k: m[k] for k in ("flops_per_step", "flops_source", "peak_flops_per_s", "mfu", "bound",
                                           "device_kind", "step_time_s", "n_steps", "exposed_comm_fraction")}
        return out

    t_phase = time.perf_counter()
    result, _ = drive("main_path_mfu", main_path_mfu, {}, kernel_free=True)
    emit({"phase": "main_path_mfu", "runs": result, "nvidia_smi": smi, "wall_s": time.perf_counter() - t_phase})

    # ---- main_path_offline --------------------------------------------------------
    def main_path_offline():
        out = {}
        tmp = tempfile.mkdtemp(prefix="chip_smoke_offline_")
        try:
            for name, run in live["runs"].items():
                t0 = time.perf_counter()
                _, report = torch_report.run_report(run["run_dir"])
                report_s = time.perf_counter() - t0
                p50 = report["step_p50_s"]
                if p50 != run["report_p50_s"] or not abs(p50 - run["live_p50_s"]) <= 0.05 * p50:
                    fail(f"main_path_offline: {name}'s report p50 {p50} against the merged run's {run['report_p50_s']}"
                         f" and the live plane's {run['live_p50_s']}")
                crit = report["critpath"]
                covered = {e["step"] for e in (crit or {}).get("events", [])}
                if crit is None or not set(run["steps"]) <= covered or crit["blame_by_rank"] != {"0": 1.0} \
                        or crit["comm_share"] != 0.0:
                    fail(f"main_path_offline: {name}'s critical path {crit and {k: crit[k] for k in crit if k != 'events'}}"
                         f" over steps {sorted(covered)} (the run's {run['steps']})")
                if report["fabric_matrix"] is not None or report["world_size"] != 1:
                    fail(f"main_path_offline: {name}: a fabric matrix at world {report['world_size']}")
                calib = costmodel.calibrate(report, source_fabric="NVLink4(H100)")
                plan = costmodel.build_plan(calib, fabrics=list(FABRICS_BYTES_PER_S))
                preds = costmodel.prediction_events(plan)
                if plan["schema"] != 1 or list(plan["fabrics"]) != list(FABRICS_BYTES_PER_S) or not preds \
                        or not all((p.predicted_step_s or 0) > 0 for p in preds):
                    fail(f"main_path_offline: {name}'s plan {plan.get('schema')} {list(plan.get('fabrics', {}))},"
                         f" predictions {[p.predicted_step_s for p in preds]}")
                path = os.path.join(tmp, f"{name}_plan.json")
                with open(path, "w") as f:
                    json.dump(plan, f)
                args = launch.build_parser().parse_args(["exact_cifar10", "--plan", path])
                before, cfg = launch.config_from_args(args), launch.config_from_args(args)
                with contextlib.redirect_stderr(io.StringIO()):
                    launch.apply_plan(cfg, args)
                best = costmodel.canonical_config(plan["fabrics"][cfg.comm_fabric]["best"]["config"])
                want = {
                    "comm_chunks": best["comm_chunks"] or before.comm_chunks, "comm_strategy": best["comm_strategy"],
                    "bucket_bytes": best["bucket_bytes"] or before.bucket_bytes,
                    "reducer_rank": best["reducer_rank"] or before.reducer_rank, "plan_path": path,
                }
                got = {k: getattr(cfg, k) for k in want}
                if got != want:
                    fail(f"main_path_offline: {name}: apply_plan gave {got}, the plan's {cfg.comm_fabric} pick {want}")
                joined = costmodel.join_realized(plan, "NVLink4(H100)", report)
                out[name] = {
                    "step_p50_s": p50, "report_s": report_s, "n_events": report["n_events"],
                    "critpath": {k: crit[k] for k in ("n_steps", "comm_share", "blame_by_rank", "blame_by_phase")},
                    "stragglers": report["stragglers"], "mfu": report["mfu"], "compile": report["compile"],
                    "calibration": {k: getattr(calib, k) for k in ("step_time_s", "compute_s", "dense_bytes",
                                                                   "exposed_fraction", "flops_per_step")},
                    "predictions": len(preds), "best": {f: plan["fabrics"][f]["best"]["config"]["name"]
                                                       for f in plan["fabrics"]},
                    "applied": got, "costmodel": joined,
                }
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return out

    t_phase = time.perf_counter()
    result, _ = drive("main_path_offline", main_path_offline, {}, kernel_free=True)
    emit({"phase": "main_path_offline", "runs": result, "nvidia_smi": smi, "wall_s": time.perf_counter() - t_phase})
    emit({"phase": "offline_phases", "wall_s": time.perf_counter() - t_offline, "predicted_s": OFFLINE_PREDICTED_S})


def report_phases(dev, drive, live, smi):
    """``main_path_report``: ``scripts/torch_report.py`` and
    ``scripts/torch_gate.py`` over the two live run directories (``live``,
    as ``live_phases`` returned it) through their entry points; no training
    process, no kernel (``drive`` holds every count at 0).

    The clean run's ``run_report`` (with ``trace_out``) carries every key of
    the JAX package's report, no alert, no descent, ``mfu_headline`` the
    largest MFU, and a measured HBM peak no larger than its limit where the
    directory holds ``MemoryEvent``s (else the peak's source is None). Its
    Chrome trace is JSON with one process row per rank, every span of the
    merged run once as a complete event of ``dur >= 0`` inside its
    parent's interval (up to ``SPAN_NEST_TOL_US``), and the steps on their
    own track. The nudged run's report: a ``step_time_drift`` alert, a
    descent to ``compress``, the policy timeline and the alert section in
    its text. ``--compare clean nudged``: the step-p50 ratio the two
    reports' and the alert counts 0 against at least 1. The gate: clean
    against itself exits 0; nudged against clean exits 1 with
    ``alerts_fired`` regressed and ``step_p50_s`` regressed exactly when the
    nudged p50 exceeds the clean one by the tolerance, and 0 with
    ``--advisory``; against a baseline that attests the CPU an advisory
    ``device_mismatch``, and 1 with ``--strict-device``. ``--watch
    --interval 0 --watch-iterations 2`` renders two frames; the event-log
    mode's ``--json`` on the clean run's rank-0 shard counts its records by
    kind as a plain count of its lines does."""
    import importlib.util

    from network_distributed_pytorch_tpu_torch.observe import runlog

    here = os.path.dirname(os.path.abspath(__file__))

    def script(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(here, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    torch_report, torch_gate = script("torch_report"), script("torch_gate")
    clean, nudged = (live["runs"][name]["run_dir"] for name in ("main_path_live", "main_path_live_nudge"))

    def quiet(fn, *args, **kwargs):
        """``fn``'s return, its standard output and its seconds (its
        standard error, the scripts' ``# report:`` and ``# gate:`` lines,
        goes nowhere)."""
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            ret = fn(*args, **kwargs)
        return ret, out.getvalue(), time.perf_counter() - t0

    def main_path_report():
        out = {"report_s": {}}
        tmp = tempfile.mkdtemp(prefix="chip_smoke_report_")
        try:
            # ---- the clean run and its trace
            trace_path = os.path.join(tmp, "trace.json")
            (text, rep), _, out["report_s"]["clean"] = quiet(torch_report.run_report, clean, trace_out=trace_path)
            missing = [k for k in REPORT_KEYS if k not in rep]
            if missing:
                fail(f"main_path_report: the clean report lacks {missing}")
            if rep["alerts"]["fired"] != 0 or rep["policy"]["descends"] != 0:
                fail(f"main_path_report: the clean run's alerts {rep['alerts']['by_kind']}, policy {rep['policy']}")
            mfus = [m["mfu"] for m in rep["mfu"] if m.get("mfu") is not None]
            if not mfus or rep["mfu_headline"] != max(mfus):
                fail(f"main_path_report: mfu_headline {rep['mfu_headline']} against the records' {mfus}")
            merged = runlog.merge_run(clean)
            n_memory = sum(1 for e in merged.events if e.get("event") == "memory")
            mem = rep["memory"]
            if n_memory:
                limit = (mem["measured"] or {}).get("bytes_limit")
                if mem["hbm_peak_source"] != "measured" or not mem["hbm_peak_bytes"] \
                        or (limit is not None and mem["hbm_peak_bytes"] > limit):
                    fail(f"main_path_report: {n_memory} MemoryEvents, memory section {mem}")
            elif mem["hbm_peak_source"] is not None:
                fail(f"main_path_report: no MemoryEvent, yet a peak from {mem['hbm_peak_source']}: {mem}")
            out["clean"] = {
                "step_p50_s": rep["step_p50_s"], "n_events": rep["n_events"], "mfu_headline": rep["mfu_headline"],
                "memory_events": n_memory, "hbm_peak_source": mem["hbm_peak_source"],
                "hbm_peak_bytes": mem["hbm_peak_bytes"], "text_lines": text.count("\n"),
            }

            # ---- the Chrome trace
            with open(trace_path) as f:
                trace = json.load(f)["traceEvents"]
            rows = [e for e in trace if e.get("ph") == "M" and e.get("name") == "process_name"]
            ranks = {int(r) for r in rep["ranks"]}
            if len(rows) != len({e["pid"] for e in rows}) or not ranks <= {e["pid"] for e in rows} \
                    or any(e["args"]["name"] != f"rank {e['pid']}" for e in rows if e["pid"] >= 0):
                fail(f"main_path_report: the trace's process rows {rows} for ranks {sorted(ranks)}")
            spans = [e for e in merged.events if e.get("event") == "span" and isinstance(e.get("dur_s"), (int, float))]
            complete = {}
            for e in trace:
                if e.get("ph") == "X" and e.get("cat") == "span":
                    complete.setdefault((e["pid"], e["args"].get("span_id")), []).append(e)
            if len(complete) != len(spans) or any(len(v) != 1 or v[0]["dur"] < 0 or v[0]["tid"] != 0
                                                  for v in complete.values()):
                fail(f"main_path_report: {len(spans)} spans in the run, {sum(map(len, complete.values()))} complete"
                     f" span events under {len(complete)} ids in the trace")
            worst_us = 0.0
            for (pid, _), (e,) in complete.items():
                parent = complete.get((pid, e["args"].get("parent_id")))
                if parent is not None:
                    p = parent[0]
                    worst_us = max(worst_us, p["ts"] - e["ts"], e["ts"] + e["dur"] - (p["ts"] + p["dur"]))
            if worst_us > SPAN_NEST_TOL_US:
                fail(f"main_path_report: a span reaches {worst_us} us outside its parent's interval")
            steps = [e for e in trace if e.get("cat") == "step"]
            n_steps = sum(1 for e in merged.events
                          if e.get("event") == "step" and isinstance(e.get("step_time_s"), (int, float)))
            if len(steps) != n_steps or {e["tid"] for e in steps} != {1}:
                fail(f"main_path_report: {len(steps)} steps on tracks {sorted({e['tid'] for e in steps})},"
                     f" {n_steps} in the run")
            out["trace"] = {"events": len(trace), "spans": len(complete), "steps": len(steps),
                            "process_rows": len(rows), "worst_nesting_excursion_us": worst_us}

            # ---- the nudged run
            (ntext, nrep), _, out["report_s"]["nudged"] = quiet(torch_report.run_report, nudged)
            pol = nrep["policy"]
            if "step_time_drift" not in nrep["alerts"]["by_kind"] or pol["descends"] < 1 \
                    or pol["final_rung"] != "compress":
                fail(f"main_path_report: the nudged run's alerts {nrep['alerts']['by_kind']}, policy {pol}")
            for section in ("policy — fallback ladder timeline", "live alerts — streaming detector verdicts"):
                if section not in ntext:
                    fail(f"main_path_report: the nudged run's text has no {section!r}")
            out["nudged"] = {"step_p50_s": nrep["step_p50_s"], "alerts": nrep["alerts"]["by_kind"],
                             "descends": pol["descends"], "final_rung": pol["final_rung"]}

            # ---- --compare clean nudged
            rc, cmp_line, out["report_s"]["compare"] = quiet(torch_report.main, ["--compare", clean, nudged, "--json"])
            doc = json.loads(cmp_line)
            m = doc["metrics"]
            if rc != 0 or m["step_p50_s"]["ratio"] != nrep["step_p50_s"] / rep["step_p50_s"] \
                    or m["alerts.fired"]["a"] != 0 or not m["alerts.fired"]["b"] >= 1:
                fail(f"main_path_report: --compare gave {rc} {m}")
            out["compare"] = {k: m[k] for k in ("step_p50_s", "alerts.fired", "policy.descends") if k in m}

            # ---- the gate
            paths = {}
            for name, doc in (("clean", rep), ("nudged", nrep), ("cpu", {**rep, "platform": "cpu"})):
                paths[name] = os.path.join(tmp, f"{name}.json")
                with open(paths[name], "w") as f:
                    json.dump(doc, f)
            gate = {}
            for name, argv in (
                ("clean_vs_clean", ["--report", paths["clean"], "--baseline", paths["clean"]]),
                ("nudged_vs_clean", ["--report", paths["nudged"], "--baseline", paths["clean"]]),
                ("nudged_vs_clean_advisory", ["--report", paths["nudged"], "--baseline", paths["clean"], "--advisory"]),
                ("clean_vs_cpu", ["--report", paths["clean"], "--baseline", paths["cpu"]]),
                ("clean_vs_cpu_strict", ["--report", paths["clean"], "--baseline", paths["cpu"], "--strict-device"]),
            ):
                rc, line, _ = quiet(torch_gate.main, argv)
                verdict = json.loads(line)
                gate[name] = {"rc": rc, "gate": verdict["gate"],
                              "regressed": sorted(v["metric"] for v in verdict["verdicts"] if v["regressed"]),
                              "verdicts": {v["metric"]: v["regressed"] for v in verdict["verdicts"]}}
            # the nudged run's step p50 regresses where it exceeds the clean
            # one by the default tolerance, 20 %; its other verdicts are
            # printed (the gate's arithmetic is held to the JAX gate's on the CPU)
            p50_regressed = nrep["step_p50_s"] > rep["step_p50_s"] * 1.2
            want = {"clean_vs_clean": (0, []), "clean_vs_cpu": (0, []), "clean_vs_cpu_strict": (1, ["device_mismatch"])}
            for name, (rc, regressed) in want.items():
                if (gate[name]["rc"], gate[name]["regressed"]) != (rc, regressed):
                    fail(f"main_path_report: the gate's {name}: {gate[name]}, expected exit {rc} with {regressed}")
            nvc = gate["nudged_vs_clean"]
            if nvc["rc"] != 1 or not nvc["verdicts"].get("alerts_fired") \
                    or nvc["verdicts"].get("step_p50_s") is not p50_regressed \
                    or gate["nudged_vs_clean_advisory"]["rc"] != 0 or gate["nudged_vs_clean_advisory"]["gate"] != "fail" \
                    or gate["clean_vs_cpu"]["verdicts"].get("device_mismatch") is not False:
                fail(f"main_path_report: the gate {gate} (step p50 regressed: {p50_regressed})")
            out["gate"] = {name: {k: g[k] for k in ("rc", "gate", "regressed")} for name, g in gate.items()}
            out["gate"]["nudged_vs_clean"]["verdicts"] = nvc["verdicts"]
            out["step_p50_ratio"] = nrep["step_p50_s"] / rep["step_p50_s"]

            # ---- the dashboard, twice over the finished clean run
            rc, frames, out["report_s"]["watch"] = quiet(
                torch_report.main, ["--run-dir", clean, "--watch", "--interval", "0", "--watch-iterations", "2"])
            if rc != 0 or frames.count("live: ") != 2:
                fail(f"main_path_report: --watch gave {rc} and {frames.count('live: ')} frames: {frames[-2000:]}")
            out["watch"] = {"frames": 2, "lines": frames.count("\n")}

            # ---- the event-log mode on the clean run's rank-0 shard
            shard = runlog.shard_path(clean, 0)
            rc, line, out["report_s"]["event_log"] = quiet(torch_report.main, [shard, "--json"])
            counts = {}
            with open(shard) as f:
                for raw in f:
                    try:
                        r = json.loads(raw)
                    except ValueError:
                        continue
                    if isinstance(r, dict):
                        counts[r.get("event", "raw")] = counts.get(r.get("event", "raw"), 0) + 1
            if rc != 0 or json.loads(line) != {"log": shard, "events": counts}:
                fail(f"main_path_report: the event-log mode gave {rc} {line[:2000]}, a count of the lines {counts}")
            out["event_log"] = {"events": counts}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return out

    t_phase = time.perf_counter()
    result, _ = drive("main_path_report", main_path_report, {}, kernel_free=True)
    emit({"phase": "main_path_report", **result, "nvidia_smi": smi, "wall_s": time.perf_counter() - t_phase,
          "predicted_s": REPORT_PREDICTED_S})


def fleet_phases(dev, smi, clean_ckpt, preset="full"):
    """``main_path_fleet``, ``main_path_autoscale`` and ``main_path_fleet_cli``:
    the fleet control plane over logical chips of the one card, the three
    side by side (each starts its own processes on the card), their files
    under a temporary directory removed at the end. No port kernel runs in
    any of them (the jobs are ``serve_gpt``, ``exact_cifar10`` and
    ``bare_init``), and none in this process: the phases read no launch
    count, so ``main`` runs them in a thread beside section 4's
    comparisons, which time nothing.

    ``main_path_fleet`` (the JAX package's fleet game day, with the port's
    entry points): a ``FleetScheduler`` over ``FLEET_CHIPS`` logical chips,
    every job on card 0 through ``LOCAL_RANK=0`` in its manifest's env, runs
    the serving pool ``svc`` (priority 10: ``launch serve_gpt --spool-dir``,
    the live plane armed with a hair-trigger ``DetectorConfig(slo_target_s=
    1e-3, slo_sustain=1, cooldown=2)``), ``train`` (priority 1:
    ``supervised_resume``'s command, deterministic through its
    ``sitecustomize``) and a crash-looper (``raise SystemExit(43)``, 3
    strikes, no restart). Once the pool has served and ``train`` has
    stepped, a thread feeds the pool's spool. It must end with ``svc`` and
    ``train`` completed, the looper quarantined (``last_rc`` 43), nothing
    unfinished; an ``slo_burn`` preemption of ``train`` (exit 75 after its
    emergency checkpoint), its lifecycle through ``preempting``, ``parked``,
    ``resumed`` and ``completed``, the resume mid-run; every spooled request
    done once; ``train``'s final checkpoint equal, leaf for leaf and bit for
    bit, to ``supervised_resume``'s unfaulted one (``clean_ckpt``); a
    finite positive goodput, and ``scripts/torch_report.py``'s fleet section
    giving the summary's numbers.

    ``main_path_autoscale`` (the JAX package's serving storm): a
    ``ServingAutoscaler`` of ``launch serve_gpt --spool-dir`` workers, 1 to
    ``STORM_MAX_WORKERS``, leasing from a ``FleetScheduler`` of
    ``STORM_CHIPS`` logical chips; once the first worker has served, a
    burst and then a trickle (see the constants). It must grow to at least
    two workers, drain, lose no request and serve none twice, with
    ``AutoscaleEvent``s up and down and lease ``ScheduleEvent``s granting
    and releasing every chip.

    ``main_path_fleet_cli``: ``launch fleet --spool-dir D --devices 2
    --run-dir R --submit jobs.json --out summary.json`` in a subprocess with
    ``launch bare_init`` (priority 2), the looper and, on the card, the
    same ``bare_init`` without ``LOCAL_RANK`` on logical chip 1: the first
    takes card 0 (its grant), the last must raise (no card 1) and be
    quarantined. It must exit 0.

    ``preset="small"`` rehearses all three on the CPU (``dev`` the CPU; the
    tiny GPT and the small ResNet, global batch 16)."""
    import importlib.util

    import torch

    from network_distributed_pytorch_tpu_torch.experiments import serve_gpt
    from network_distributed_pytorch_tpu_torch.observe import runlog, telemetry_for_run
    from network_distributed_pytorch_tpu_torch.observe.health import DetectorConfig
    from network_distributed_pytorch_tpu_torch.resilience import (
        PREEMPT_EXIT_CODE,
        AutoscalerConfig,
        FleetConfig,
        FleetScheduler,
        JobManifest,
        JobSpool,
        ServingAutoscaler,
    )
    from network_distributed_pytorch_tpu_torch.serving import FileSpool, poisson_workload
    from network_distributed_pytorch_tpu_torch.serving.frontend import MANIFEST, _atomic_write
    from network_distributed_pytorch_tpu_torch.utils.checkpoint import latest_step_path

    on_cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("torch_report", os.path.join(here, "scripts", "torch_report.py"))
    torch_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_report)
    base = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    launch_cmd = [sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch"]
    pythonpath = os.pathsep.join([here, os.environ.get("PYTHONPATH", "")])
    on_card = {"LOCAL_RANK": "0", "PYTHONPATH": pythonpath}  # every logical chip is card 0
    slo_s = STORM_SLO_S if preset == "full" else 0.05

    def events_in(path):
        return runlog.load_shard(path)[0] if os.path.exists(path) else []

    def shard_events(run_dir):
        out = []
        for name in sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []:
            if name.startswith("events_rank") and name.endswith(".jsonl"):
                out += events_in(os.path.join(run_dir, name))
        return out

    def finished(events):
        return [e for e in events if e.get("event") == "request" and e.get("state") == "finished"]

    def wait_for(pred, timeout_s, what):
        t0 = time.monotonic()
        while not pred():
            if time.monotonic() - t0 > timeout_s:
                return f"timed out after {timeout_s} s waiting for {what}"
            time.sleep(0.05)
        return None

    def feed(spool, requests):
        """Enqueue each request at its arrival offset: an open-loop load."""
        t0 = time.monotonic()
        for r in sorted(requests, key=lambda q: q.arrival_s):
            dt = r.arrival_s - (time.monotonic() - t0)
            if dt > 0:
                time.sleep(dt)
            spool.ensure([r])

    def workload(prefix, n, rate, seed, offset=0.0):
        reqs = poisson_workload(serve_gpt.workload_config(preset, n, rate, SERVE_NEW, seed))
        for r in reqs:
            r.request_id = f"{prefix}-{r.request_id}"
            r.arrival_s += offset
        return reqs

    def serve_argv(spool_dir, run_dir, rank, world):
        return launch_cmd + [
            "serve_gpt", "--preset", preset, "--device", dev.type, "--spool-dir", spool_dir, "--run-dir", run_dir,
            "--process-id", str(rank), "--num-processes", str(world), "--requests", "1", "--slots",
            str(SERVE_SLOTS), "--max-new-tokens", str(SERVE_NEW), "--max-wall-s", "900",
        ]

    def p99(values):
        return statistics.quantiles(values, n=100)[98] if len(values) > 1 else (values[0] if values else None)

    # ---- main_path_fleet: the game day ---------------------------------------------
    def main_path_fleet():
        root = os.path.join(base, "fleet")
        fleet_dir, req_dir = os.path.join(root, "run"), os.path.join(root, "requests")
        svc_dir = os.path.join(fleet_dir, "jobs", "svc.seg0")  # the pool runs one segment
        ckpt, train_log = os.path.join(root, "ckpt"), os.path.join(root, "train_events.jsonl")
        site = os.path.join(root, "site")
        os.makedirs(site)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(SUPERVISED_SITECUSTOMIZE)
        fed = workload("svc", FLEET_FEED, FLEET_RATE, 11)
        for r in fed[:FLEET_BURST]:
            r.arrival_s = 0.0
        spool = FileSpool(req_dir)
        # the whole feed manifested before the pool starts: it serves until all is done
        _atomic_write(os.path.join(req_dir, MANIFEST), {"request_ids": sorted(r.request_id for r in fed)})
        jobs = JobSpool(os.path.join(root, "jobs"))
        jobs.submit([
            JobManifest(
                job_id="svc", kind="serve", priority=10, steps=float(FLEET_FEED + 1), env=dict(on_card),
                argv=serve_argv(req_dir, svc_dir, "{rank}", "{world}"),
            ),
            JobManifest(
                job_id="train", kind="train", priority=1, steps=float(SUPERVISED_EPOCHS * SUPERVISED_STEPS),
                env={**on_card, "PYTHONPATH": os.pathsep.join([site, pythonpath])},
                argv=supervised_train_argv(preset, dev.type, ckpt, train_log)
                + ["--process-id", "{rank}", "--num-processes", "{world}"],
            ),
            JobManifest(job_id="looper", argv=[sys.executable, "-c", "raise SystemExit(43)"], max_strikes=3,
                        max_restarts=0, env=dict(on_card)),
        ])
        fed_at = {}

        def feeder():
            fed_at["error"] = wait_for(
                lambda: finished(shard_events(svc_dir)) and any(e.get("event") == "step" for e in events_in(train_log)),
                600, "the pool's first request and the training job's first step",
            )
            fed_at["wall"] = time.time()
            feed(spool, fed)

        segments = []

        class Scheduler(FleetScheduler):
            """Records each finished segment's supervisor result."""

            def _reap(self):
                for job_id, run in self._running.items():
                    if not run.thread.is_alive() and run.result is not None:
                        segments.append({"job": job_id, "exit_codes": dict(run.result.exit_codes),
                                         "preempted": run.result.preempted, "reason": run.result.reason})
                super()._reap()

        thread = threading.Thread(target=feeder, daemon=True)
        thread.start()
        t0 = time.perf_counter()
        summary = Scheduler(jobs, config=FleetConfig(
            n_devices=FLEET_CHIPS, max_wall_s=400.0, term_grace_s=60.0, escalation_sustain=FLEET_SUSTAIN,
            escalation_cooldown_s=1.0, serve_detector=DetectorConfig(slo_target_s=1e-3, slo_sustain=1, cooldown=2),
        ), run_dir=fleet_dir).run()
        wall = time.perf_counter() - t0
        thread.join(timeout=60)
        events = runlog.merge_run(fleet_dir).events
        by = {}
        for e in events:
            by.setdefault(e.get("event"), []).append(e)
        preempts = [e for e in by.get("preempt", []) if e.get("victim") == "train"]
        lifecycle = [(e["state"], e.get("ts")) for e in by.get("job", []) if e.get("job_id") == "train"]
        states = [s for s, _ in lifecycle]
        first = {}
        for s, ts in lifecycle:
            first.setdefault(s, ts)
        terms = [e for e in by.get("failure", []) if e.get("kind") == "worker_term"]
        train_events = events_in(train_log)
        got = saved_leaves(latest_step_path(ckpt)) if latest_step_path(ckpt) else {}
        want = saved_leaves(latest_step_path(clean_ckpt))
        differ = sorted(
            k for k in want
            if k not in got or (torch.is_tensor(want[k]) and not torch.equal(got[k], want[k]))
            or (not torch.is_tensor(want[k]) and got[k] != want[k])
        )
        served = [e["request_id"] for e in finished(shard_events(svc_dir))]
        _, report = torch_report.run_report(fleet_dir)
        return {
            "summary": summary, "wall_s": wall, "segments": segments, "feeder_error": fed_at.get("error"),
            "preempts": preempts, "train_states": states,
            "drain_ms": (terms[0]["ts"] - preempts[0]["ts"]) * 1e3 if preempts and terms else None,
            "park_to_resume_s": first["resumed"] - first["parked"] if "parked" in first and "resumed" in first
            else None,
            "preempt_to_fed_s": preempts[0]["ts"] - fed_at["wall"] if preempts and "wall" in fed_at else None,
            "worker_kinds": [e.get("kind") for e in train_events if e.get("event") == "failure"],
            "resumed": [e.get("message") for e in train_events if e.get("kind") == "resumed"],
            "train_steps": sum(1 for e in train_events if e.get("event") == "step"),
            "requests": {"manifested": len(spool.manifest_ids()), "done": len(spool.done_ids()),
                         "drained": spool.drained(), "served": len(served),
                         "served_once": sorted(served) == spool.manifest_ids()},
            "final_checkpoint": os.path.basename(latest_step_path(ckpt) or ""), "leaves": len(want),
            "differ_at": differ, "report_fleet": report["fleet"],
        }

    # ---- main_path_autoscale: the storm ---------------------------------------------
    def main_path_autoscale():
        root = os.path.join(base, "storm")
        spool_dir = os.path.join(root, "spool")
        os.makedirs(root)
        burst = workload("burst", int(STORM_BURST_S * STORM_BURST_RATE), STORM_BURST_RATE, 12)
        trickle = workload("tail", int(STORM_TRICKLE_S * STORM_TRICKLE_RATE), STORM_TRICKLE_RATE, 13,
                           offset=STORM_BURST_S + STORM_GAP_S)
        spool = FileSpool(spool_dir)
        _atomic_write(os.path.join(spool_dir, MANIFEST),
                      {"request_ids": sorted(r.request_id for r in burst + trickle)})
        telemetry = telemetry_for_run(event_log=os.path.join(root, runlog.SUPERVISOR_LOG), stdout=False)
        leases = FleetScheduler(JobSpool(os.path.join(root, "jobs")), config=FleetConfig(n_devices=STORM_CHIPS),
                                telemetry=telemetry)
        fed_at = {}

        def feeder():
            fed_at["error"] = wait_for(lambda: finished(events_in(runlog.shard_path(root, 0))), 600,
                                       "the first worker's first request")
            fed_at["wall"] = time.time()
            feed(spool, burst + trickle)

        thread = threading.Thread(target=feeder, daemon=True)
        thread.start()
        t0 = time.perf_counter()
        try:
            summary = ServingAutoscaler(
                lambda wid, chips: serve_argv(spool_dir, root, wid, STORM_MAX_WORKERS), spool, root,
                scheduler=leases,
                config=AutoscalerConfig(
                    min_workers=1, max_workers=STORM_MAX_WORKERS, chips_per_worker=1, queue_high=64,
                    queue_sustain=4, cooldown_s=2.0, burn_sustain=1, term_grace_s=10.0, max_wall_s=300.0,
                    detector_config=DetectorConfig(slo_target_s=slo_s, slo_sustain=1, cooldown=1),
                    owner="storm-pool",
                ),
                telemetry=telemetry, env=dict(os.environ, **on_card), log_dir=os.path.join(root, "logs"),
                run_id="storm",
            ).run()
        finally:
            telemetry.close()
        wall = time.perf_counter() - t0
        thread.join(timeout=60)
        control = events_in(os.path.join(root, runlog.SUPERVISOR_LOG))
        scale = [e for e in control if e.get("event") == "autoscale"]
        ups = [e for e in scale if e.get("direction") == "up"]
        leased = [e for e in control if e.get("event") == "schedule" and e.get("planner") == "lease"]
        alerts = [e for e in control if e.get("event") == "alert" and e.get("alert") == "slo_burn"]
        requests = finished(shard_events(root))
        counts = {}
        for e in requests:
            counts[e["request_id"]] = counts.get(e["request_id"], 0) + 1
        total = {e["request_id"]: e["total_s"] for e in requests}
        burn_ups = [e for e in ups if e.get("reason") == "slo_burn"]
        # each scaled-up worker's spawn to its first finished request
        first_served = {}
        for wid in {e.get("worker_id") for e in ups if e.get("reason") != "min_workers"}:
            done = [e["ts"] for e in finished(events_in(runlog.shard_path(root, wid)))]
            spawn = min(e["ts"] for e in ups if e.get("worker_id") == wid)
            first_served[str(wid)] = min(done) - spawn if done else None
        return {
            "summary": summary, "wall_s": wall, "feeder_error": fed_at.get("error"),
            "requests": {"manifested": len(spool.manifest_ids()), "done": len(spool.done_ids()),
                         "lost": sorted(set(spool.manifest_ids()) - set(spool.done_ids()))[:5],
                         "served_twice": sorted(k for k, n in counts.items() if n > 1)[:5],
                         "burst": len(burst), "trickle": len(trickle)},
            "ups": [(e.get("reason"), e.get("worker_id"), e.get("device_ranks")) for e in ups],
            "downs": [(e.get("reason"), e.get("worker_id")) for e in scale if e.get("direction") == "down"],
            "lease_grants": sum(1 for e in leased if e.get("world", 0) >= 1),
            "lease_releases": sum(1 for e in leased if e.get("world") == 0),
            "still_leased": leases.leased("storm-pool"),
            "alert_to_scale_up_ms": (burn_ups[0]["ts"] - alerts[0]["ts"]) * 1e3 if burn_ups and alerts else None,
            "spawn_to_first_served_s": first_served,
            "p99_total_s": {"burst": p99([total[r.request_id] for r in burst if r.request_id in total]),
                            "trickle": p99([total[r.request_id] for r in trickle if r.request_id in total])},
            "slo_target_s": slo_s,
        }

    # ---- main_path_fleet_cli: launch fleet ------------------------------------------
    def main_path_fleet_cli():
        root = os.path.join(base, "cli")
        os.makedirs(root)
        init = launch_cmd + ["bare_init", "--json", "--device", dev.type]
        env = {"PYTHONPATH": pythonpath}  # no LOCAL_RANK: each worker takes the card of its grant
        jobs = [JobManifest(job_id="init", argv=init, priority=2, env=env),
                JobManifest(job_id="looper", argv=[sys.executable, "-c", "raise SystemExit(43)"], max_strikes=3,
                            max_restarts=0)]
        if on_cuda:
            # logical chip 1 names a card this machine lacks: the worker must raise
            jobs.append(JobManifest(job_id="misplaced", argv=init, priority=1, max_strikes=1, max_restarts=0, env=env))
        with open(os.path.join(root, "jobs.json"), "w") as f:
            json.dump([j.to_wire() for j in jobs], f)
        out = os.path.join(root, "summary.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            launch_cmd + ["fleet", "--spool-dir", os.path.join(root, "spool"), "--devices", "2", "--run-dir",
                          os.path.join(root, "run"), "--submit", os.path.join(root, "jobs.json"), "--out", out],
            cwd=here, capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - t0
        summary = None
        if os.path.exists(out):
            with open(out) as f:
                summary = json.load(f)
        inits = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{") and "bare_init" in line]
        return {"rc": proc.returncode, "summary": summary, "wall_s": wall, "bare_init": inits,
                "raised": "names card 1, but this machine has 1 card" in proc.stderr, "stderr": proc.stderr[-3000:]}

    def run_all():
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            futures = {name: pool.submit(fn) for name, fn in (
                ("main_path_fleet", main_path_fleet), ("main_path_autoscale", main_path_autoscale),
                ("main_path_fleet_cli", main_path_fleet_cli))}
            return {name: fut.result() for name, fut in futures.items()}

    try:
        results = run_all()
    finally:
        shutil.rmtree(base, ignore_errors=True)

    r = results["main_path_fleet"]
    s = r["summary"]
    segs = {(g["job"], tuple(sorted(g["exit_codes"].values())), g["preempted"]) for g in r["segments"]}
    rf = r["report_fleet"] or {}
    if (s["completed"] != ["svc", "train"] or s["quarantined"] != ["looper"] or s["unfinished"]
            or s["jobs"]["looper"]["last_rc"] != 43 or r["feeder_error"]
            or not any(p.get("reason") == "slo_burn" and p.get("beneficiary") == "svc" for p in r["preempts"])
            or ("train", (PREEMPT_EXIT_CODE,), True) not in segs
            or [x for x in ("preempting", "parked", "resumed", "completed") if x not in r["train_states"]]
            or "preempt_checkpoint" not in r["worker_kinds"] or not r["resumed"]
            or not r["requests"]["drained"] or not r["requests"]["served_once"] or r["differ_at"] or not r["leaves"]
            or not (math.isfinite(s["goodput"]) and s["goodput"] > 0)
            or (rf.get("completed"), rf.get("quarantined"), rf.get("preemptions"), rf.get("weighted_work"))
            != (s["completed"], s["quarantined"], s["preemptions"], s["weighted_work"])
            or not math.isclose(rf.get("goodput") or 0.0, s["goodput"], rel_tol=1e-9)):
        fail(f"main_path_fleet: {r}")
    emit({
        "phase": "main_path_fleet", "preset": preset, "chips": FLEET_CHIPS,
        "placement": {f"logical chip {c}": f"{dev.type}:0 (LOCAL_RANK=0)" for c in range(FLEET_CHIPS)},
        "summary": s, "segments": r["segments"], "train_states": r["train_states"], "resumed": r["resumed"],
        "drain_ms": r["drain_ms"], "park_to_resume_s": r["park_to_resume_s"],
        "preempt_after_feed_s": r["preempt_to_fed_s"], "train_steps_logged": r["train_steps"],
        "chip_seconds": {j: rec["chip_seconds"] for j, rec in s["jobs"].items()}, "goodput": s["goodput"],
        "requests": r["requests"], "final_checkpoint": r["final_checkpoint"], "leaves": r["leaves"],
        "bitwise": "every leaf of train's final checkpoint equals supervised_resume's unfaulted run's",
        "report_fleet": rf, "nvidia_smi": smi, "wall_s": r["wall_s"],
    })

    r = results["main_path_autoscale"]
    s = r["summary"]
    if (r["feeder_error"] or s["workers_peak"] < 2 or not s["drained"] or r["requests"]["lost"]
            or r["requests"]["served_twice"] or r["requests"]["done"] != r["requests"]["manifested"]
            or not any(u[0] != "min_workers" for u in r["ups"]) or not r["downs"]
            or r["lease_grants"] < 2 or r["lease_releases"] != r["lease_grants"] or r["still_leased"]):
        fail(f"main_path_autoscale: {r}")
    emit({"phase": "main_path_autoscale", "preset": preset, "chips": STORM_CHIPS,
          "burst": {"seconds": STORM_BURST_S, "rate": STORM_BURST_RATE},
          "trickle": {"after_s": STORM_BURST_S + STORM_GAP_S, "seconds": STORM_TRICKLE_S, "rate": STORM_TRICKLE_RATE},
          **r, "nvidia_smi": smi})

    r = results["main_path_fleet_cli"]
    s = r["summary"] or {}
    quarantined = ["looper", "misplaced"] if on_cuda else ["looper"]
    if (r["rc"] != 0 or s.get("completed") != ["init"] or s.get("quarantined") != quarantined or s.get("unfinished")
            or len(r["bare_init"]) != 1 or (on_cuda and not r["raised"])):
        fail(f"main_path_fleet_cli: {r}")
    r.pop("stderr")
    emit({"phase": "main_path_fleet_cli", "preset": preset, **r, "nvidia_smi": smi})
    emit({"phase": "fleet_phases", "wall_s": time.perf_counter() - t_phase, "predicted_s": FLEET_PREDICTED_S})


def torn_batch_check(dev, depth, n=TORN_BATCHES, rows=512, features=3072, sleep_cycles=TORN_SLEEP_CYCLES):
    """``n`` batches (``rows`` x ``features`` float32 and ``rows`` int32
    labels, every element different from the batch before's) through
    ``device_prefetch`` at ``depth``, each received behind a long kernel on
    the consumer's stream (``torch.cuda._sleep``: the step is still running
    when the next batches are staged) and cloned there after it; after the
    last, every clone is read back. Returns the indices of the batches whose
    clone is not its source bit for bit: a slot rewritten before its copy
    had read it, or device memory handed out again while the consumer still
    read it, shows here."""
    import numpy as np
    import torch

    from network_distributed_pytorch_tpu_torch.data.loader import device_prefetch

    base = np.random.RandomState(depth).standard_normal((rows, features)).astype(np.float32)
    sources = [(base + np.float32(i), np.full(rows, i, np.int32)) for i in range(n)]
    clones = []
    for bx, by in device_prefetch(iter(sources), dev, depth=depth, label=f"torn_depth_{depth}"):
        if dev.type == "cuda":
            torch.cuda._sleep(sleep_cycles)
        clones.append((bx.clone(), by.clone()))
        del bx, by
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return [
        i for i, ((cx, cy), (sx, sy)) in enumerate(zip(clones, sources))
        if cx.cpu().numpy().tobytes() != sx.tobytes() or cy.cpu().numpy().tobytes() != sy.tobytes()
    ]


def staged_copies(trace_path, batch_bytes):
    """The host-to-device copies of at least ``batch_bytes`` in a Chrome
    trace of ``torch.profiler``: how many, whether each read pinned memory,
    their streams against the step's (the stream with the most kernel
    time), their times, and how many ran while a kernel of the step's
    stream ran. None where the trace holds no kernel."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        return None
    busy = {}
    for k in kernels:
        busy[k["args"]["stream"]] = busy.get(k["args"]["stream"], 0.0) + k["dur"]
    compute = max(busy, key=busy.get)
    on_compute = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels if k["args"]["stream"] == compute)
    copies = [
        e for e in events
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "") and e["args"].get("bytes", 0) >= batch_bytes
    ]

    def overlaps(c):
        lo, hi = c["ts"], c["ts"] + c["dur"]
        return any(a < hi and lo < b for a, b in on_compute)

    return {
        "copies": len(copies), "names": sorted({c["name"] for c in copies}),
        "pinned": bool(copies) and all("Pinned" in c["name"] for c in copies),
        "streams": sorted({c["args"]["stream"] for c in copies}), "step_stream": compute,
        "on_step_stream": sum(c["args"]["stream"] == compute for c in copies),
        "overlapping_a_step_kernel": sum(overlaps(c) for c in copies),
        "copy_us": [c["dur"] for c in copies],
        "copy_gb_per_s": [c["args"].get("bytes", 0) / max(c["dur"], 1e-3) / 1e3 for c in copies],
    }


def span_p50s(records, names=("data_load", "data_load/assemble", "data_load/stage")):
    """The median duration in ms of each span of ``names`` in ``records``,
    None where the run recorded none."""
    out = {}
    for name in names:
        durs = [r["dur_s"] * 1e3 for r in records if r.get("event") == "span" and r["name"] == name]
        out[name] = statistics.median(durs) if durs else None
    return out


DATA_PLANE_SOURCES = ("numpy", "native", "native1", "listed")


def data_plane_run(step, initial, snapshot, cfg, dev, images, labels, source, prefetch, steps, hook=None,
                   run_name="data_plane"):
    """One run of ``steps`` flagship steps of ``train_loop`` from
    ``initial`` (put back first by ``snapshot``, a ``StateSnapshot`` taken
    of it), under :func:`deterministic_algorithms`, at ``prefetch``, its
    batches from ``source``: ``"numpy"`` (``iterate_batches``: the numpy
    gather on the training thread), ``"native"`` (``accumulated_batches``:
    the native loader, the default path), ``"native1"`` (the native loader
    with one gather thread) or ``"listed"`` (the native loader's epoch
    gathered into a list before the loop: no worker thread while it
    steps). Returns ``(tensors, logger, sink, loader)``: the final state's
    tensors on the host, the step log, the telemetry records and the
    native loader (its ``last_stats``), None for ``"numpy"``."""
    import itertools

    from network_distributed_pytorch_tpu_torch.data.loader import iterate_batches
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches, train_loop
    from network_distributed_pytorch_tpu_torch.native import loader as native_loader
    from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry

    if source not in DATA_PLANE_SOURCES:
        raise ValueError(f"data plane source must be one of {DATA_PLANE_SOURCES}, got {source!r}")
    sink = MemorySink()
    snapshot.restore(initial)
    threads = native_loader._N_THREADS
    if source == "native1":
        native_loader._N_THREADS = 1
    try:
        with deterministic_algorithms():
            if source == "numpy":
                batches = lambda epoch: itertools.islice(  # noqa: E731
                    iterate_batches([images, labels], cfg.global_batch_size, seed=cfg.seed, epoch=epoch), steps
                )
            else:
                batches = accumulated_batches([images, labels], cfg, max_steps_per_epoch=steps)
            loader = getattr(batches, "loader", None)
            if source == "listed":
                listed = list(batches(0))
                batches = lambda epoch: iter(listed)  # noqa: E731
            state, logger = train_loop(
                step, initial, batches, 1, dev, telemetry=Telemetry([sink]), prefetch=prefetch,
                run_name=run_name, on_step_end=hook,
            )
            # on the host: the next run's peak must not hold this one's state
            out = {k: v.cpu() for k, v in tensors_of(state).items()}
    finally:
        native_loader._N_THREADS = threads
    return out, logger, sink, loader


def data_plane_phases(dev, drive, images, labels, n_groups, smi, preset="full"):
    """``main_path_data_plane``: the flagship fed as the JAX package feeds it
    (the native loader, ``device_prefetch`` over pinned slots and a side
    stream) against the numpy loader with synchronous copies, in turns, from
    the same state: the parameters after ``DATA_PLANE_STEPS`` steps bit for
    bit, the spans, the ``LoaderEvent``, the step p50s; a trace of the
    prefetched steps (the batch copies pinned, off the step's stream); and
    the torn-batch check at each of ``TORN_DEPTHS``. ``drive`` is
    ``main``'s; ``n_groups`` the ResNet's shape groups. ``preset="small"``
    (global batch 16) rehearses it on the CPU, where the trace and the
    slow consumer are left out."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10
    from network_distributed_pytorch_tpu_torch.native import native_available
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )
    from network_distributed_pytorch_tpu_torch.resilience.guards import StateSnapshot

    t_phase = time.perf_counter()
    on_cuda = dev.type == "cuda"
    cfg = powersgd_cifar10.default_config()
    cfg.compress_impl = "xla"
    if preset == "small":
        cfg.global_batch_size = 16
    want = {"gram_schmidt": DATA_PLANE_STEPS * n_groups}
    runs = {}
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        # one build; each run starts from its initial state, put back by the
        # guarded step's snapshot (which restores a step bit for bit)
        _, step, initial = powersgd_cifar10.build(cfg, preset, dev, group)
        snapshot = StateSnapshot()
        snapshot.take(initial)

        def version(native, steps=DATA_PLANE_STEPS, hook=None):
            """The native loader and prefetch=2, or the numpy loader and
            prefetch=0 (:func:`data_plane_run`)."""
            return data_plane_run(step, initial, snapshot, cfg, dev, images, labels, "native" if native else "numpy",
                                  2 if native else 0, steps, hook=hook)

        for name, native in (("data_plane_numpy", False), ("data_plane_native", True)):
            (tensors, logger, sink, loader), peak = drive(name, lambda native=native: version(native), want)
            # drive keeps each run's result: its tensors (on the host) are cleared below
            timed = logger.records[WARMUP_STEPS:]
            runs[name] = {
                "tensors": tensors, "loader": loader,
                "record": {
                    "loader": "native" if native else "numpy", "prefetch": 2 if native else 0,
                    "losses": [r.loss for r in logger.records],
                    "step_host_ms_p50": statistics.median(r.step_time_s * 1e3 for r in timed),
                    "step_device_ms_p50": (
                        statistics.median(r.device_time_ms for r in timed) if on_cuda else None
                    ),
                    "span_ms_p50": span_p50s(sink.records),
                    "loader_events": [
                        {k: e[k] for k in ("label", "batches", "samples", "samples_per_s", "prefetch_depth", "wait_s")}
                        for e in sink.of_kind("loader")
                    ],
                    "native_last_stats": loader.last_stats if loader is not None else None,
                    "peak_memory_bytes": peak,
                },
            }
        differ = bitwise_equal(runs["data_plane_native"]["tensors"], runs["data_plane_numpy"]["tensors"])
        for run in runs.values():
            run["tensors"].clear()
        if differ:
            fail(f"main_path_data_plane: the native prefetched run differs from the numpy one in {differ[:5]}")
        stats = runs["data_plane_native"]["loader"].last_stats if runs["data_plane_native"]["loader"] else None
        available = native_available()
        if not (available and stats and stats["native"]):
            fail(f"main_path_data_plane: native_available() {available}, the loader's last_stats {stats}")
        (event,) = runs["data_plane_native"]["record"]["loader_events"] or [None]
        if event is None or event["batches"] != DATA_PLANE_STEPS or event["prefetch_depth"] != 2:
            fail(f"main_path_data_plane: the prefetched run's LoaderEvent {event}")

        # the trace: DATA_PLANE_TRACE_STEPS prefetched steps, steps 1 and 2 recorded
        trace = None
        if on_cuda:
            tmp = tempfile.mkdtemp(prefix="chip_smoke_data_plane_")
            path = os.path.join(tmp, "trace.json")
            try:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=2, repeat=1),
                    on_trace_ready=lambda p: p.export_chrome_trace(path),
                )
                with prof:
                    (traced, *_), _ = drive(
                        "data_plane_trace",
                        lambda: version(True, DATA_PLANE_TRACE_STEPS, hook=lambda e, n, s: bool(prof.step())),
                        {"gram_schmidt": DATA_PLANE_TRACE_STEPS * n_groups},
                    )
                traced.clear()
                trace = staged_copies(path, int(images[:1].nbytes) * cfg.global_batch_size)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            if trace is None or trace["copies"] < 2 or not trace["pinned"] or trace["on_step_stream"]:
                fail(f"main_path_data_plane: the traced batch copies {trace}: not 2 or more, pinned, off the step's stream")
    finally:
        shutdown_distributed()

    # the torn-batch check: a slow consumer at each depth
    torn = {}
    t_torn = time.perf_counter()
    for depth in TORN_DEPTHS:
        bad = torn_batch_check(dev, depth, rows=cfg.global_batch_size)
        if bad:
            fail(f"main_path_data_plane: at depth {depth} the staged batches {bad[:8]} differ from their sources")
        torn[str(depth)] = {"batches": TORN_BATCHES, "torn": 0}
    numpy_rec, native_rec = runs["data_plane_numpy"]["record"], runs["data_plane_native"]["record"]
    emit({
        "phase": "main_path_data_plane", "model": "resnet152" if preset == "full" else "resnet18",
        "global_batch": cfg.global_batch_size,
        "steps": DATA_PLANE_STEPS, "timed_steps": DATA_PLANE_STEPS - WARMUP_STEPS,
        "params_bitwise_equal": True, "native_available": available, "native_last_stats": stats,
        "numpy_prefetch_0": numpy_rec, "native_prefetch_2": native_rec,
        "step_device_ms_p50_native_over_numpy": (
            native_rec["step_device_ms_p50"] / numpy_rec["step_device_ms_p50"] if on_cuda else None
        ),
        "step_host_ms_p50_native_over_numpy": native_rec["step_host_ms_p50"] / numpy_rec["step_host_ms_p50"],
        "trace": trace,
        "torn_batch_check": {
            "depths": torn, "sleep_cycles": TORN_SLEEP_CYCLES if on_cuda else 0,
            "batch_shape": [cfg.global_batch_size, 3072], "s": time.perf_counter() - t_torn,
        },
        "wall_s": time.perf_counter() - t_phase, "predicted_s": DATA_PLANE_PREDICTED_S, "nvidia_smi": smi,
    })


def load_script(name):
    """The module ``scripts/<name>`` beside this file, loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", name)
    spec = importlib.util.spec_from_file_location(name[: -len(".py")], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bandwidth_artifact_phase(dev, drive, study, n_groups, smi):
    """``scripts/torch_bandwidth_artifact.py`` on the card, in process, its
    record in a temporary directory: the structure from the study at preset
    small at world 1, projected for ARTIFACT_WORKERS (no Gloo spawn); the
    chip phase; the projection. K1 once a shape group in each PowerSGD step
    and DiLoCo round of the structure and the chip phase and in each of the
    flagship's steps. Fails unless every row is timed on the card, each
    projected step is the compute time plus the ring model's time of the
    row's bits (ARTIFACT_REL_TOL), and the flagship row's bits are those
    ``study`` (the smoke's ``bandwidth_study`` at preset full) records."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments import bandwidth_study
    from network_distributed_pytorch_tpu_torch.experiments.powersgd_cifar10 import build_model
    from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer
    from network_distributed_pytorch_tpu_torch.utils.bandwidth import allreduce_time_s

    artifact = load_script("torch_bandwidth_artifact.py")
    params = list(build_model("small", dev, seed=0).parameters())
    groups = {r: PowerSGDReducer(compression_rank=r, matricize="last").n_shape_groups(params) for r in (1, 2, 4)}
    del params
    rounds = max(1, ARTIFACT_STEPS // bandwidth_study.SCAN_SYNC_EVERY)
    k1 = (
        (sum(groups.values()) + groups[4]) * (2 + 1)  # the structure: a warm-up, a recorded and a timed step or round
        + sum(groups.values()) * (1 + ARTIFACT_STEPS) + groups[4] * (1 + rounds)  # the card's rows
        + n_groups * (1 + ARTIFACT_FULL_STEPS) * len(artifact.FULL_PRESET_RUNS)  # the flagship in each dtype
    )
    root = tempfile.mkdtemp(prefix="chip_smoke_bandwidth_")
    artifact.OUT = os.path.join(root, "TORCH_BANDWIDTH.json")

    def run():
        # the script's own conditions, PyTorch's cuDNN defaults: section 3
        # leaves deterministic cuDNN on from main_path_exact's bitwise check,
        # under which the fp32 flagship read 1.31 s a step against 0.12
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
        try:
            with contextlib.redirect_stdout(sys.stderr):  # the script's tables
                small = bandwidth_study.run(
                    preset="small", device=dev, timed_steps=1, timed_rounds=1, project_workers=ARTIFACT_WORKERS
                )
                with open(artifact.OUT, "w") as f:
                    json.dump({"structure": artifact.structure_record(small)}, f)
                artifact.phase_chip(steps=ARTIFACT_STEPS, device=dev, full_steps=ARTIFACT_FULL_STEPS)
                return artifact.phase_project()
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved

    t0 = time.perf_counter()
    try:
        art, peak = drive("bandwidth_artifact", run, {"gram_schmidt": k1})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    elapsed = time.perf_counter() - t0
    table, card = art["projection"]["table"], art["chip"]["compute_step_s"]
    timed = set(artifact.CHIP_CONFIGS) | {"local_sgd_h8", "diloco_psgd_r4_h8"}
    if set(card) != timed or set(table) != timed:
        fail(f"bandwidth_artifact timed {sorted(card)} and projected {sorted(table)}, not {sorted(timed)}")
    worst = 0.0
    for name, row in table.items():
        if row["compute_source"] != artifact.CARD_SOURCE or not (0 < row["compute_s"] < math.inf):
            fail(f"bandwidth_artifact {name}: compute {row['compute_s']} from {row['compute_source']!r}")
        for fabric, e in row["fabrics"].items():
            want = row["compute_s"] + allreduce_time_s(
                row["bits_per_step"] / 8.0, ARTIFACT_WORKERS, fabric, row["n_collectives"]
            )
            rel = abs(e["step_time_s"] - want) / want
            worst = max(worst, rel)
            if not rel <= ARTIFACT_REL_TOL:
                fail(f"bandwidth_artifact {name} over {fabric}: {e['step_time_s']} s against {want} s")
    full = art.get("full_preset") or {}
    want_bits = {k: study["results"][k]["bits_per_step"] for k in ("exact", "powersgd_r4")}
    if full.get("bits_per_step") != want_bits:
        fail(f"bandwidth_artifact's flagship bits {full.get('bits_per_step')}, the study's {want_bits}")
    full_times = {k: r["chip_step_s"] for k, r in full["chip_rows"].items()}
    if set(full_times) != set(artifact.FULL_PRESET_RUNS) or not all(0 < t < math.inf for t in full_times.values()):
        fail(f"bandwidth_artifact's flagship rows {full_times}")
    if smi not in full["source"] or any("skipped" in v for v in art["speedup_vs_exact"].values()):
        fail(f"bandwidth_artifact: source {full['source']!r}, speed-ups {art['speedup_vs_exact']}")
    emit({
        "phase": "bandwidth_artifact", "predicted_s": ARTIFACT_PREDICTED_S, "elapsed_s": elapsed,
        "structure": {"world_size": art["structure"]["num_devices"], "projected_workers": ARTIFACT_WORKERS},
        "steps_timed": ARTIFACT_STEPS, "batch_per_worker": art["chip"]["batch_per_worker"],
        "compute_step_s": card, "flagship": full["chip_rows"], "flagship_bits": full["bits_per_step"],
        "speedup_vs_exact": art["speedup_vs_exact"], "projection_worst_rel_err": worst,
        "launches": {"gram_schmidt": k1}, "peak_memory_bytes": peak, "nvidia_smi": smi,
    })


def start_accuracy_study():
    """Start ``scripts/torch_accuracy_study.py`` with ACCURACY_ARGS on the
    card in a process of its own, its record and its standard error in a
    temporary directory."""
    root = tempfile.mkdtemp(prefix="chip_smoke_accuracy_")
    out = os.path.join(root, "accuracy.json")
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "torch_accuracy_study.py")
    with open(os.path.join(root, "stderr.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, script, *ACCURACY_ARGS, "--device", "cuda", "--out", out],
            stdout=subprocess.PIPE, stderr=log, text=True,
        )
    atexit.register(stop_process, proc)  # a phase that fails before the study is read leaves no process behind
    return {"proc": proc, "root": root, "out": out, "t0": time.perf_counter()}


def stop_process(proc) -> None:
    """Kill ``proc`` if it still runs, and reap it."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def check_study_attention(fa, dev, gen):
    """K5's forward and backward kernels (fp32) at the accuracy study's
    DistilBERT tiers (ACCURACY_K5_SHAPES: D 8 on the tiny tier, 64 on the
    wide one) against their plain versions on random q, k, v and dO, with
    the padding of the first training batch of each tier's IMDb draw; each
    within ATTN_TOL * max(1, max|plain|), one launch of each kernel."""
    import torch

    from network_distributed_pytorch_tpu_torch.data.loader import iterate_batches

    study = load_script("torch_accuracy_study.py")
    report = {}
    for tier, (b, t, h, d) in ACCURACY_K5_SHAPES.items():
        train = study.imdb_task(0, wide=tier == "imdb_wide")["train"]
        first = next(iterate_batches([train["attention_mask"]], b, shuffle=True, seed=1234))[0]
        if first.shape != (b, t):
            fail(f"{tier}: the first batch's mask is {first.shape}, not {(b, t)}")
        mask = torch.where(torch.from_numpy(first) > 0, 0.0, torch.finfo(torch.float32).min).to(dev)
        q, k, v, do = (torch.randn((b * h, t, d), generator=gen).to(dev) for _ in range(4))
        scale = d**-0.5
        bwd = fa.BWD_KERNELS[torch.float32]
        before = (fa.KERNEL.launches, bwd.launches)
        out, lse = fa.flash_attention_fwd(q, k, v, mask, False, t, t, scale)
        grads = fa.flash_attention_vjp(q, k, v, mask, out, lse, do, False, t, scale, False)
        torch.cuda.synchronize()
        launched = (fa.KERNEL.launches - before[0], bwd.launches - before[1])
        want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, False, t, t, scale)
        want = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, False, t, scale, False)
        if launched != (1, 1):
            fail(f"flash_attention at the {tier} tier launched {launched} (forward, backward), not one each")
        errs = {}
        for name, g, w in (("out", out, want_out), ("dq", grads[0], want[0]), ("dk", grads[1], want[1]),
                           ("dv", grads[2], want[2])):
            err = (g - w).abs().max().item()
            tol = ATTN_TOL * max(1.0, w.abs().max().item())
            if not (math.isfinite(err) and err <= tol):
                fail(f"flash_attention at the {tier} tier {(b, t, h, d)}: max |kernel - plain| of {name} {err} (tol {tol})")
            errs[name] = err
        lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
        if not (math.isfinite(lse_err) and lse_err <= ATTN_TOL):
            fail(f"flash_attention at the {tier} tier: lse {lse_err} (tol {ATTN_TOL})")
        report[tier] = {
            "shape": [b, t, h, d], "real_keys": int(first.sum()), "keys": b * t, "max_abs_err": errs,
            "lse_max_rel_err": lse_err, "tolerance": ATTN_TOL,
        }
    return report


def accuracy_study_phase(started, k5, n_groups, smi):
    """Wait for the accuracy study started by :func:`start_accuracy_study`
    and hold its record: both arms' bits at 8 workers and their ratio, each
    arm's best accuracy within ACCURACY_CEILING_PTS of the Bayes ceiling,
    the delta within ACCURACY_DELTA_PTS, K1 once a shape group a step of
    the PowerSGD arm and never in the exact one (the process's own count).
    Returns the PowerSGD arm's K1 launches."""
    proc = started["proc"]
    try:
        try:
            stdout, _ = proc.communicate(timeout=ACCURACY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"the accuracy study did not end in {ACCURACY_TIMEOUT_S} s")
        wall = time.perf_counter() - started["t0"]
        with open(os.path.join(started["root"], "stderr.log")) as f:
            err_tail = f.read()[-3000:]
        if proc.returncode:
            fail(f"the accuracy study exited {proc.returncode}: {err_tail}")
        with open(started["out"]) as f:
            rec = json.load(f)["cifar"]
        slim = json.loads(stdout.strip().splitlines()[-1])["cifar"]
    finally:
        shutil.rmtree(started["root"], ignore_errors=True)
    arms = rec["arms"]
    ceiling = rec["hardness"]["accuracy_ceiling_nearest_mean"]
    bits = {name: a["bits_per_step"] for name, a in arms.items()}
    if bits != ACCURACY_BITS or rec["gradient_bytes_ratio"] != ACCURACY_RATIO:
        fail(f"accuracy_study: bits {bits}, ratio {rec['gradient_bytes_ratio']}")
    for name, a in arms.items():
        if not abs(a["best_accuracy"] - ceiling) * 100 <= ACCURACY_CEILING_PTS:
            fail(f"accuracy_study {name}: best {a['best_accuracy']} against the ceiling {ceiling}")
    if not abs(rec["accuracy_delta_pts"]) <= ACCURACY_DELTA_PTS:
        fail(f"accuracy_study: delta {rec['accuracy_delta_pts']} points")
    k1 = {name: a["kernel_launches"]["gram_schmidt"] for name, a in arms.items()}
    if k1 != {"exact": 0, "powersgd_r4": arms["powersgd_r4"]["total_steps"] * n_groups}:
        fail(f"accuracy_study: K1 launched {k1}, {n_groups} groups a step of the PowerSGD arm")
    if rec["nvidia_smi"] != smi or rec["workers"] != 1 or slim["gradient_bytes_ratio"] != ACCURACY_RATIO:
        fail(f"accuracy_study: {rec['nvidia_smi']!r}, world {rec['workers']}, the line {slim}")
    emit({
        "phase": "accuracy_study", "predicted_s": ACCURACY_PREDICTED_S, "wall_s": wall, "args": list(ACCURACY_ARGS),
        "ceiling": ceiling, "accuracy_delta_pts": rec["accuracy_delta_pts"],
        "gradient_bytes_ratio": rec["gradient_bytes_ratio"], "departure": rec["departure"],
        "arms": {
            name: {k: a[k] for k in ("eval_accuracy_curve", "best_accuracy", "final_accuracy", "epochs_run",
                                     "plateaued", "total_steps", "bits_per_step", "wall_s", "kernel_launches")}
            for name, a in arms.items()
        },
        "flash_attention_at_study_tiers": k5, "nvidia_smi": smi,
    })
    return k1["powersgd_r4"]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
        from network_distributed_pytorch_tpu_torch.data.imdb import prepare_imdb
        from network_distributed_pytorch_tpu_torch.experiments import (
            bandwidth_study,
            diloco_cifar10,
            exact_cifar10,
            gpt_generate,
            gpt_lm,
            imdb_baseline,
            powersgd_cifar10,
            powersgd_imdb,
        )
        from network_distributed_pytorch_tpu_torch.models import gpt as gpt_model
        from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches, image_classifier_loss
        from network_distributed_pytorch_tpu_torch.ops import _build
        from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
        from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
        from network_distributed_pytorch_tpu_torch.ops import powersgd as ps
        from network_distributed_pytorch_tpu_torch.ops.orthogonalize import orthogonalize
        from network_distributed_pytorch_tpu_torch.parallel.localsgd import make_diloco_train_fn
        from network_distributed_pytorch_tpu_torch.parallel.mesh import (
            DistributedConfig,
            initialize_distributed,
            shutdown_distributed,
        )
        from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    from network_distributed_pytorch_tpu_torch.hostenv import backend_preflight

    # the CUDA preflight first: the device count and the first card's name,
    # under a wall deadline (a wedged driver is a verdict, not a hang)
    preflight = backend_preflight()
    emit({"phase": "preflight", **preflight})
    if not preflight["ok"]:
        fail(f"the CUDA preflight failed: {preflight['cause']}")

    # ---- 1. the card and the build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # processes that launch no port kernel run while the kernels build (the
    # card is otherwise idle): supervised_resume's two launches (checked by
    # chaos_phases), main_path_live's launch without the live plane (by
    # live_phases) and bare_init. Section 2 checks every kernel beside them
    # and waits for them before its first timing; only section 4, which
    # times nothing, later has a neighbour
    supervised = start_supervised_resume(torch.device("cuda", 0))
    live_plain = start_live_plain(torch.device("cuda", 0))
    bare_init = in_background(launch_bare_init)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({
        "phase": "setup", "nvidia_smi": smi, "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "kernel_build_s": build_s, "libraries": [os.path.basename(p) for p in libs],
    })
    dev = torch.device("cuda", 0)

    # ---- 2. each kernel against its plain version ------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    def reducer_groups(experiment, cfg):
        """(g, n, m, r) of every shape group of ``experiment``'s full preset."""
        model, step, _ = experiment.build(cfg, "full", dev, group=None)
        params = list(model.parameters())
        metas = step.reducer._metas(params)
        return [
            (len(poss), metas[poss[0]].n, metas[poss[0]].m, metas[poss[0]].r)
            for poss in step.reducer._shape_groups(metas)
        ]

    group_shapes = reducer_groups(powersgd_cifar10, powersgd_cifar10.default_config())
    imdb_cfg = powersgd_imdb.default_config()
    imdb_cfg.global_batch_size = IMDB_B
    imdb_group_shapes = reducer_groups(powersgd_imdb, imdb_cfg)
    main_shapes = [(g, n, r) for g, n, _, r in group_shapes]
    imdb_shapes = [(g, n, r) for g, n, _, r in imdb_group_shapes]
    extra_shapes = [
        (3, 100, 4), (1, 4608, 1), (1, 4608, 8), (1, 4608, 32),
        (1, 30522, 32), (1, 30523, 16), (1, 17, 16), (25, 768, 16),
    ]
    gen = torch.Generator().manual_seed(0)
    errs, routes = {}, {}
    inputs = {}
    for shape in main_shapes + imdb_shapes + extra_shapes:
        x = torch.randn(shape, generator=gen).to(dev)
        got = gs.gram_schmidt(x)
        routes[str(shape)] = {"route": gs.KERNEL.last_route, "cluster": gs.KERNEL.last_cluster}
        want = orthogonalize(x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not math.isfinite(err) or err > GS_TOL:
            fail(f"gram_schmidt {shape}: max |kernel - plain| = {err} > {GS_TOL}")
        errs[str(shape)] = err
        inputs[shape] = x
    word_table, streamed = routes[str((1, 30522, 16))], routes[str((1, 30522, 32))]
    if word_table["route"] != "on_chip" or word_table["cluster"] < 2:
        fail(f"gram_schmidt (1, 30522, 16) took {word_table}, not P on chip over a cluster of CTAs")
    if streamed["route"] != "streaming":
        fail(f"gram_schmidt (1, 30522, 32) took {streamed}, not the streaming route")
    main_inputs = [inputs[s] for s in main_shapes]
    # flash attention at DistilBERT's width, with the first synthetic-IMDb
    # batch's padding (about 214 of 256 keys per row)
    imdb_full, imdb_val, _ = prepare_imdb(max_len=IMDB_T, seed=imdb_cfg.seed)
    imdb_arrays = [imdb_full["input_ids"], imdb_full["attention_mask"], imdb_full["labels"]]
    first_amask = torch.from_numpy(next(accumulated_batches(imdb_arrays, imdb_cfg)(0))[1])
    imdb_mask = torch.where(first_amask > 0, 0.0, torch.finfo(torch.float32).min)
    attn_report, (aq, ak, av, amask) = check_flash_attention(fa, dev, gen, imdb_mask)
    bf16_report, bf16_inputs = check_flash_attention_bf16(fa, dev, gen, imdb_mask)
    bwd_report, bwd_err, bwd_inputs = check_flash_attention_bwd(fa, dev, gen, imdb_mask)
    extra_groups = [
        (3, 100, 37, 8), (1, 2, 3, 2), (2, 70, 7, 3), (2, 50, 10, 4), (2, 5, 256, 4),
        (1, 4608, 512, 1), (1, 4608, 512, 8), (1, 4608, 512, 32),
    ]
    report, kept = check_fused_kernels(ps, gs, group_shapes + extra_groups, dev, gen, set(group_shapes))
    if report[str((1, 4608, 512, 32))]["route"] != "two_launch":
        fail("orthogonalize_project at r = 32, n = 4608 did not take the two-launch route")
    # every check above times nothing, so it runs beside the launches started
    # before the build; the first timing waits for them to end
    t_wait = time.perf_counter()
    for started in (supervised[0], live_plain[0], bare_init):
        started.result()
    emit({"phase": "launches_before_timing", "waited_s": time.perf_counter() - t_wait,
          "supervised_resume_s": supervised[0].result()["wall_s"]})
    gs_ms = cuda_ms(lambda: [gs.gram_schmidt(x) for x in main_inputs])
    plain_ms = cuda_ms(lambda: [orthogonalize(x) for x in main_inputs], reps=10)
    bound_ms, bound_by = gs_bound(main_shapes)
    per_group_ms = {
        str(s): cuda_ms(lambda x=inputs[s]: gs.gram_schmidt(x)) for s in main_shapes
    }
    main_err = max(errs[str(s)] for s in main_shapes + imdb_shapes)
    # the DistilBERT path's six groups, (30522, 16) among them
    imdb_inputs = [inputs[s] for s in imdb_shapes]
    gs_imdb = {
        "groups": len(imdb_shapes), "max_abs_err": max(errs[str(s)] for s in imdb_shapes),
        "ms_per_step": cuda_ms(lambda: [gs.gram_schmidt(x) for x in imdb_inputs]),
        "device_ms_per_step": device_ms(lambda: [gs.gram_schmidt(x) for x in imdb_inputs], "gram_schmidt_kernel"),
        "plain_ms_per_step": cuda_ms(lambda: [orthogonalize(x) for x in imdb_inputs], reps=5),
        "ms_per_group": {str(s): cuda_ms(lambda x=inputs[s]: gs.gram_schmidt(x)) for s in imdb_shapes},
        "device_ms_per_group": {
            str(s): device_ms(lambda x=inputs[s]: gs.gram_schmidt(x), "gram_schmidt_kernel") for s in imdb_shapes
        },
    }
    gs_imdb["bound_ms"], gs_imdb["bound_by"] = gs_bound(imdb_shapes)
    gs_device_ms = device_ms(lambda: [gs.gram_schmidt(x) for x in main_inputs], "gram_schmidt_kernel")
    emit({
        "phase": "gram_schmidt", "tolerance": GS_TOL, "max_abs_err": errs, "route_and_cluster": routes,
        "main_path_groups": len(main_shapes), "ms_per_step": gs_ms, "device_ms_per_step": gs_device_ms,
        "plain_ms_per_step": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "ms_per_group": per_group_ms, "imdb_path": gs_imdb,
    })
    del inputs, main_inputs, imdb_inputs

    # flash attention: one DistilBERT step's launches timed with the IMDb mask
    # and without one, each beside SDPA on the same inputs
    scale = IMDB_D**-0.5
    sdpa_q, sdpa_k, sdpa_v = (x.view(IMDB_B, IMDB_H, IMDB_T, IMDB_D) for x in (aq, ak, av))
    launches_before = fa.KERNEL.launches

    def attention_row(mask):
        """One DistilBERT step's IMDB_LAYERS forwards over ``mask``: the
        kernel, its plain version and SDPA given the same additive mask."""
        sdpa_mask = mask[:, None, None, :]
        kernel = lambda: [fa.flash_attention_fwd(aq, ak, av, mask, False, 128, 128, scale) for _ in range(IMDB_LAYERS)]
        library = lambda: [
            torch.nn.functional.scaled_dot_product_attention(sdpa_q, sdpa_k, sdpa_v, attn_mask=sdpa_mask)
            for _ in range(IMDB_LAYERS)
        ]
        walked, skipped = attention_tiles(mask, IMDB_T, IMDB_H)
        # the mask's real keys: the work the function needs on this data
        valid_keys = int((mask > -1e29).sum())
        return {
            "ms": cuda_ms(kernel, reps=20),
            "device_ms": device_ms(kernel, "flash_fwd_kernel"),
            "plain_ms": cuda_ms(
                lambda: [fa.flash_attention_reference(aq, ak, av, mask, False, 128, 128, scale) for _ in range(IMDB_LAYERS)],
                reps=5,
            ),
            "library_ms": cuda_ms(library, reps=20),
            "library_device_ms": device_ms(library),
            **attention_bounds(IMDB_B, IMDB_T, IMDB_H, IMDB_D, IMDB_LAYERS, keys=valid_keys),
            "bound_ms_all_keys": attention_bound(IMDB_B, IMDB_T, IMDB_H, IMDB_D, IMDB_LAYERS)[0],
            "mean_valid_keys_per_row": valid_keys / IMDB_B,
            "tiles_walked_per_launch": walked - skipped, "tiles_skipped_per_launch": skipped,
        }

    attn_row = attention_row(amask)
    attn_row["max_abs_err"] = max(r["max_abs_err"] for r in attn_report.values())
    no_mask_row = attention_row(torch.zeros_like(amask))
    emit({
        "phase": "flash_attention", "tolerance": ATTN_TOL, "cases": attn_report,
        "launches_per_step": IMDB_LAYERS, "per_step": attn_row, "per_step_no_mask": no_mask_row,
        "us_per_launch": attn_row["ms"] * 1e3 / IMDB_LAYERS,
        "timing_launches": fa.KERNEL.launches - launches_before,
    })
    del aq, ak, av, amask, sdpa_q, sdpa_k, sdpa_v

    # K5 on bf16 heads and causal at GPT's shape (checked above); one step's
    # launches of each path's case timed beside SDPA on the same inputs
    def attention_step(q, k, v, mask, causal, b, t, h, d, layers):
        """One step's ``layers`` K5 forwards on folded heads, the plain
        version and SDPA (``is_causal``, or the mask's real keys as a
        boolean mask) on the same inputs, and the bounds."""
        scale_ = d**-0.5
        sq, sk, sv = (x.view(b, h, t, d) for x in (q, k, v))
        keep_keys = (mask > -1e29)[:, None, None, :]
        kernel = lambda: [fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, scale_) for _ in range(layers)]
        library = lambda: [
            torch.nn.functional.scaled_dot_product_attention(
                sq, sk, sv, **({"is_causal": True} if causal else {"attn_mask": keep_keys})
            )
            for _ in range(layers)
        ]
        valid_keys = int((mask > -1e29).sum())
        elem = q.element_size()
        peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_AS_3XTF32_FLOPS
        route = BF16_ROUTE_FLOPS if q.dtype == torch.bfloat16 else FP32_AS_3XTF32_FLOPS
        bkw = dict(keys=None if causal else valid_keys, elem_bytes=elem, causal=causal)
        (b_ms, b_by), (r_ms, r_by) = (attention_bound(b, t, h, d, layers, flops=f, **bkw) for f in (peak, route))
        return {
            "launches_per_step": layers, "dtype": str(q.dtype).rsplit(".", 1)[-1], "causal": causal,
            "ms": cuda_ms(kernel, reps=10),
            "device_ms": device_ms(kernel, "flash_fwd"),
            "plain_ms": cuda_ms(
                lambda: [fa.flash_attention_reference(q, k, v, mask, causal, 128, 128, scale_) for _ in range(layers)],
                reps=2,
            ),
            "library_ms": cuda_ms(library, reps=10),
            "library_device_ms": device_ms(library),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ops_peak": "bf16 tensor cores, 989 TFLOP/s" if elem == 2 else "3xTF32 tensor cores, 495/3 TFLOP/s",
            "bound_ms_kernel_route": r_ms, "bound_by_kernel_route": r_by,
            "kernel_route_peak": (
                "bf16, q.k once and P.V twice: 989 x 2/3 TFLOP/s" if elem == 2 else "3xTF32, 495/3 TFLOP/s"
            ),
        }

    gpt_rows = {
        name: attention_step(*bf16_inputs[name], True, GPT_B, GPT_T, GPT_H, GPT_D, GPT_LAYERS)
        for name in ("gpt_causal_fp32", "gpt_causal_bf16")
    }
    imdb_bf16_row = attention_step(*bf16_inputs["imdb_bf16"], False, IMDB_B, IMDB_T, IMDB_H, IMDB_D, IMDB_LAYERS)
    bf16_err = max(r["max_abs_err"] for n, r in bf16_report.items() if n.endswith("bf16"))
    emit({
        "phase": "flash_attention_bf16_causal",
        "tolerance": f"fp32 cases {ATTN_TOL} * max(1, max|plain|); bf16 out that plus 1 bf16 ulp of the element",
        "cases": bf16_report, "gpt_per_step": gpt_rows, "imdb_bf16_per_step": imdb_bf16_row,
    })
    del bf16_inputs

    # K5's backward kernel (checked above against its plain version): one
    # GPT-2 step's 12 causal backwards timed in each dtype beside the plain
    # version and SDPA's backward on the same inputs

    def backward_step(q, k, v, mask, out, lse, do, b, t, h, d, layers):
        """One step's ``layers`` causal K5 backwards on the forward's own out
        and lse: the kernel, the plain version and SDPA's backward (the
        gradient of its ``is_causal`` out in q, k and v with the same dO,
        its forward excluded), and the bounds."""
        scale_ = d**-0.5
        kernel = lambda: [  # noqa: E731
            fa.flash_attention_vjp(q, k, v, mask, out, lse, do, True, 128, scale_, False) for _ in range(layers)
        ]
        plain = lambda: [  # noqa: E731
            fa.flash_attention_bwd(q, k, v, mask, out, lse, do, True, 128, scale_, need_dmask=False)
            for _ in range(layers)
        ]
        sq, sk, sv = (x.view(b, h, t, d).detach().requires_grad_() for x in (q, k, v))
        sout = torch.nn.functional.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
        library = lambda: [  # noqa: E731
            torch.autograd.grad(sout, (sq, sk, sv), do.view(b, h, t, d), retain_graph=True) for _ in range(layers)
        ]
        bf16 = q.dtype == torch.bfloat16
        # the kernels' own passes: S and dP in both kernels, dV, dK and dQ
        # once each; bf16 one pass for S and dP and two for the split P and
        # dS (10 of the function's 5 products), fp32 three TF32 passes for
        # each of 7 products (21)
        peak, route = (BF16_FLOPS, BF16_FLOPS * 5 / 10) if bf16 else (FP32_AS_3XTF32_FLOPS, TF32_FLOPS * 5 / 21)
        bkw = dict(elem_bytes=q.element_size(), causal=True)
        (b_ms, b_by), (r_ms, r_by) = (attention_bwd_bound(b, t, h, d, layers, flops=f, **bkw) for f in (peak, route))
        row = {
            "launches_per_step": layers, "dtype": str(q.dtype).rsplit(".", 1)[-1], "causal": True,
            "ms": cuda_ms(kernel, reps=5),
            "device_ms": device_ms(kernel, "flash_bwd", reps=3),
            "plain_ms": cuda_ms(plain, reps=2),
            "plain_device_ms": device_ms(plain, reps=2),
            "library_ms": cuda_ms(library, reps=5),
            "library_device_ms": device_ms(library, reps=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ops_peak": "bf16 tensor cores, 989 TFLOP/s" if bf16 else "3xTF32 tensor cores, 495/3 TFLOP/s",
            "bound_ms_kernel_route": r_ms, "bound_by_kernel_route": r_by,
            "kernel_route_peak": "10 bf16 passes of the 5 products" if bf16 else "21 TF32 passes of the 5 products",
        }
        del sq, sk, sv, sout
        return row

    gpt_bwd = {
        tag: backward_step(*bwd_inputs[tag], GPT_B, GPT_T, GPT_H, GPT_D, GPT_LAYERS) for tag in ("float32", "bfloat16")
    }
    emit({
        "phase": "flash_attention_bwd",
        "tolerance": (
            f"dq, dk, dv: fp32 {ATTN_TOL} * max(1, max|plain|), bf16 that plus 1 bf16 ulp of the element;"
            " dmask (fp32) the fp32 bound"
        ),
        "cases": bwd_report, "max_abs_err": bwd_err, "gpt_per_step": gpt_bwd,
    })
    del bwd_inputs

    # the fused kernels (checked above at every main-path shape group and a
    # few others), timed at the main path's groups
    main_x = [kept[s] for s in group_shapes]
    timed = {  # name: (kernel, plain version, one PyTorch call or None, the xla path's calls)
        "ef_compress": (
            lambda x: ps.fused_ef_compress(x["grads"], x["q"], x["resid"]),
            lambda x: ps.ef_compress_reference(x["grads"], x["q"], x["resid"]),
            None,
            lambda x: torch.bmm(x["grads"] + x["resid"], x["q"]),
        ),
        "compress": (
            lambda x: ps.fused_ef_compress(x["m"], x["q"]),
            lambda x: ps.compress_reference(x["m"], x["q"]),
            lambda x: torch.bmm(x["m"], x["q"]),
            lambda x: torch.bmm(x["m"], x["q"]),
        ),
        "orthogonalize_project": (
            lambda x: ps.fused_orthogonalize_project(x["p"], x["m"]),
            lambda x: ps.orthogonalize_project_reference(x["p"], x["m"]),
            None,
            lambda x: torch.bmm(x["m"].transpose(1, 2), gs.gram_schmidt(x["p"])),
        ),
        "decompress_residual": (
            lambda x: ps.fused_decompress_residual(x["phat"], x["qn"], x["m"]),
            lambda x: ps.decompress_residual_reference(x["phat"], x["qn"], x["m"]),
            None,
            lambda x: (lambda out: (out, x["m"] - out))(torch.bmm(x["phat"], x["qn"].transpose(1, 2))),
        ),
    }

    def step_ms(fn, reps):
        return cuda_ms(lambda: [fn(x) for x in main_x], reps=reps)

    bounds = fused_bounds(group_shapes)
    device_fn = {  # a part of each kernel's device function name
        "ef_compress": "ef_compress_kernel", "compress": "ef_compress_kernel",
        "orthogonalize_project": "orthogonalize_project_kernel",
        "decompress_residual": "decompress_residual_kernel",
    }
    fused_rows = {}
    for name, (kernel, plain, library, _) in timed.items():
        (b_ms, b_by), nbytes = bounds[name]
        fused_rows[name] = {
            "max_abs_err": max(max(report[str(s)][name].values()) for s in group_shapes),
            "ms": step_ms(kernel, 20), "plain_ms": step_ms(plain, 5),
            "device_ms": device_ms(lambda: [kernel(x) for x in main_x], device_fn[name], reps=FUSED_REPS),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "library_ms": step_ms(library, 20) if library is not None else None,
            "library_device_ms": (
                device_ms(lambda: [library(x) for x in main_x], reps=FUSED_REPS) if library is not None else None
            ),
        }
    xla_ms = {name: step_ms(xla, 20) for name, (_, _, _, xla) in timed.items()}
    xla_device_ms = {
        name: device_ms(lambda xla=xla: [xla(x) for x in main_x], reps=FUSED_REPS) for name, (_, _, _, xla) in timed.items()
    }
    # each redesigned kernel's device time per shape group, and torch.bmm's for K2b's work
    per_group = {
        str(s): {
            **{
                name: device_ms(lambda x=x, k=timed[name][0]: k(x), device_fn[name], reps=FUSED_REPS)
                for name in ("ef_compress", "compress", "orthogonalize_project")
            },
            "torch_bmm": device_ms(lambda x=x: torch.bmm(x["m"], x["q"]), reps=FUSED_REPS),
        }
        for s, x in zip(group_shapes, main_x)
    }
    emit({
        "phase": "fused_kernels", "tolerance": FUSED_TOL, "main_path_groups": len(group_shapes),
        "per_shape": report, "per_step": fused_rows, "device_ms_per_group": per_group,
    })
    del kept, main_x
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default

    # ---- 3. the main paths: ResNet xla and fused, DistilBERT ---------------------
    k5_kernels = (fa.KERNEL, fa.KERNEL_BF16, *fa.BWD_KERNELS.values())
    all_kernels = (gs.KERNEL, *ps.KERNELS, *k5_kernels)
    device_fns = {  # a part of each kernel's device function names (fp32 and bf16)
        "gram_schmidt": "gram_schmidt_kernel", "ef_compress": "ef_compress_kernel",
        "orthogonalize_project": "orthogonalize_project_kernel",
        "decompress_residual": "decompress_residual_kernel", "flash_attention": "flash_fwd",
        # the backward's entry launches three device functions: the rowsum
        # pre-pass, dK/dV and dQ
        "flash_attention_bwd": "flash_bwd",
    }
    images, labels, _ = load_cifar10_or_synthetic(train=True)
    results = {}
    launches = {}
    kinds = {}  # K5's launches (forward and backward) of each path by kind (causal or masked)
    profiles = {}

    def drive(name, run, want, kernel_free=False):
        """``run()`` with every launch count set to 0 just before it and
        read just after; fails unless they are ``want`` (all 0 only where
        the path is ``kernel_free``)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for k in all_kernels:
            k.reset()
        result = run()
        launches[name] = {k.name: k.launches for k in all_kernels}
        kinds[name] = {k.name: dict(k.by_kind) for k in k5_kernels}
        full_want = {k.name: want.get(k.name, 0) for k in all_kernels}
        if launches[name] != full_want or not (kernel_free or any(full_want.values())):
            fail(f"{name} launched {launches[name]}, expected {full_want}")
        results[name] = result
        return result, torch.cuda.max_memory_allocated(dev)

    for impl in ("xla", "pallas"):
        cfg = powersgd_cifar10.default_config()
        cfg.training_epochs = 1
        cfg.compress_impl = impl
        expected = MAIN_STEPS * len(group_shapes)
        want = (
            {"gram_schmidt": expected} if impl == "xla" else
            {"ef_compress": expected, "orthogonalize_project": expected, "decompress_residual": expected}
        )
        result, peak = drive(
            impl, lambda: powersgd_cifar10.run(cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS), want
        )
        record = main_path_record("main_path" if impl == "xla" else "main_path_fused", result, cfg, peak)
        record.update(
            compress_impl=cfg.compress_impl, reducer_rank=cfg.reducer_rank,
            shape_groups=result["shape_groups"], launches=launches[impl],
        )
        emit(record)
        profiles[impl] = profile_main_path(dev, powersgd_cifar10, cfg, [images, labels], {
            k: device_fns[k] for k in ("gram_schmidt", "ef_compress", "orthogonalize_project", "decompress_residual")
        })
        emit(profiles[impl])
    if results["pallas"]["bits_per_step"] != results["xla"]["bits_per_step"]:
        fail(f"bits per step: fused {results['pallas']['bits_per_step']} != xla {results['xla']['bits_per_step']}")


    # DistilBERT/IMDb: flash attention once per layer and K1 once per shape
    # group in every step
    cfg = powersgd_imdb.default_config()
    cfg.training_epochs = 1
    result, peak = drive(
        "imdb", lambda: powersgd_imdb.run(cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS),
        {
            "gram_schmidt": MAIN_STEPS * len(imdb_shapes), "flash_attention": MAIN_STEPS * IMDB_LAYERS,
            "flash_attention_bwd": MAIN_STEPS * IMDB_LAYERS,
        },
    )
    losses = result["losses"]
    if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"imdb losses {losses}")
    if result["bits_per_step"] != IMDB_BITS + 32 or result["shape_groups"] != len(imdb_shapes):
        fail(f"imdb bits per step {result['bits_per_step']} (want {IMDB_BITS} + 32), groups {result['shape_groups']}")
    timed_ms = result["device_time_ms"][WARMUP_STEPS:]
    p50_ms = statistics.median(timed_ms)
    emit({
        "phase": "main_path_imdb", "model": "distilbert_base", "global_batch": result["global_batch"],
        "max_len": result["max_len"], "reducer_rank": result["reducer_rank"],
        "world_size": result["num_devices"], "losses": losses, "timed_steps": len(timed_ms),
        "step_device_ms": timed_ms, "step_device_ms_p50": p50_ms,
        "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
        "sequences_per_s": result["global_batch"] / (p50_ms / 1e3), "peak_memory_bytes": peak,
        "bits_per_step": result["bits_per_step"], "shape_groups": result["shape_groups"],
        "launches": launches["imdb"],
    })
    imdb_cfg = powersgd_imdb.default_config()
    imdb_cfg.global_batch_size = IMDB_B
    profiles["imdb"] = profile_main_path(dev, powersgd_imdb, imdb_cfg, imdb_arrays, {
        k: device_fns[k] for k in ("gram_schmidt", "flash_attention", "flash_attention_bwd")
    })
    emit(profiles["imdb"])

    # exact DDP of ResNet-50 under each reducer layout: no kernel of the port
    # runs, every gradient rides NCCL (a world of one)
    exact = {}
    for layout, (fields, collectives) in EXACT_LAYOUTS.items():
        cfg = exact_cifar10.default_config()
        for k, v in fields.items():
            setattr(cfg, k, v)
        start = torch.cuda.memory_allocated(dev)  # what earlier phases hold: the peak counts it
        result, peak = drive(
            f"exact_{layout}",
            lambda: exact_cifar10.run(
                cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS, eval_after=layout == "monolithic"
            ),
            {}, kernel_free=True,
        )
        record = main_path_record(f"exact_{layout}", result, cfg, peak, model="resnet50")
        if result["bits_per_step"] != EXACT_BITS + 32 or result["n_collectives"] != collectives:
            fail(
                f"exact {layout}: {result['bits_per_step']} bits per step (want {EXACT_BITS} + 32),"
                f" {result['n_collectives']} collectives (want {collectives})"
            )
        exact[layout] = {**record, "reducer": fields, "n_collectives": collectives, "allocated_at_start_bytes": start}
    # the layouts' parameters after two steps from the same weights and
    # batches, with deterministic cuDNN: bit for bit, since every layout
    # reduces the same values over one rank
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        first = None
        for layout, (fields, _) in EXACT_LAYOUTS.items():
            cfg = exact_cifar10.default_config()
            for k, v in fields.items():
                setattr(cfg, k, v)
            model, step, state = exact_cifar10.build(cfg, "full", dev, group)
            for batch in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0):
                state, loss = step(state, tuple(torch.from_numpy(a).to(dev) for a in batch))
            params = {k: v.detach().clone() for k, v in state.params.items()}
            del model, step, state
            if first is None:
                first = params
            elif not all(torch.equal(params[k], first[k]) for k in first):
                fail(f"exact {layout}: parameters after 2 steps differ from the monolithic layout's")
        del first, params
    finally:
        shutdown_distributed()
        torch.backends.cudnn.deterministic = False
    profiles["exact"] = profile_main_path(
        dev, exact_cifar10, exact_cifar10.default_config(), [images, labels], {}, steps=EXACT_PROFILE_STEPS
    )
    emit({
        "phase": "main_path_exact", "model": "resnet50", "parameters": 23_528_522, "leaves": 161,
        "layouts": exact, "params_after_2_steps_bitwise_equal": True,
        "eval_accuracy": results["exact_monolithic"]["eval_accuracy"],
        "eval_note": "synthetic CIFAR-10 test split, 7 steps from random weights: a number, not a target",
        "profile": profiles["exact"],
    })

    # the single-node IMDb baseline: one process, no group, K5 in each layer
    # of every training step and of every evaluation batch
    eval_batches = -(-len(imdb_val["labels"]) // TEXT_EVAL_BATCH)
    baseline = {}
    for opt in imdb_baseline.OPTIMIZERS:
        cfg = imdb_baseline.default_config(opt)
        cfg.training_epochs = 1
        result, peak = drive(
            f"imdb_baseline_{opt}",
            lambda: imdb_baseline.run(
                cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS, optimizer_name=opt, eval_after=True
            ),
            # the backward in training only
            {
                "flash_attention": (MAIN_STEPS + eval_batches) * IMDB_LAYERS,
                "flash_attention_bwd": MAIN_STEPS * IMDB_LAYERS,
            },
        )
        losses = result["losses"]
        if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
            fail(f"imdb_baseline {opt} losses {losses}")
        if result["bits_per_step"] != BASELINE_BITS:
            fail(f"imdb_baseline {opt}: {result['bits_per_step']} bits per step, want {BASELINE_BITS}")
        timed_ms = result["device_time_ms"][WARMUP_STEPS:]
        p50_ms = statistics.median(timed_ms)
        baseline[opt] = {
            "epochs_of_the_reference": imdb_baseline.OPTIMIZERS[opt], "learning_rate": cfg.learning_rate,
            "losses": losses, "timed_steps": len(timed_ms), "step_device_ms": timed_ms,
            "step_device_ms_p50": p50_ms,
            "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
            "sequences_per_s": result["global_batch"] / (p50_ms / 1e3), "peak_memory_bytes": peak,
            "bits_per_step": result["bits_per_step"], "launches": launches[f"imdb_baseline_{opt}"],
            "flash_launches_training": MAIN_STEPS * IMDB_LAYERS,
            "flash_launches_eval": eval_batches * IMDB_LAYERS, "eval_sequences": len(imdb_val["labels"]),
            "eval_accuracy": result["eval_accuracy"],
        }
    baseline_cfg = imdb_baseline.default_config()
    profiles["imdb_baseline"] = profile_main_path(
        dev, imdb_baseline, baseline_cfg, imdb_arrays,
        {k: device_fns[k] for k in ("flash_attention", "flash_attention_bwd")},
        build=lambda group: imdb_baseline.build(baseline_cfg, "full", dev),  # one process: no group
    )
    emit({
        "phase": "main_path_imdb_baseline", "model": "distilbert_base", "global_batch": IMDB_B, "max_len": IMDB_T,
        "world_size": 1, "optimizers": baseline, "profile_sgd_nesterov": profiles["imdb_baseline"],
        "eval_note": "synthetic IMDb validation split, 7 steps from random weights: a number, not a target",
    })

    # GPT-2 small LM training (gpt_lm's preset full, T 1024, batch 16,
    # PowerSGD rank 4): K5 causal once per layer and K1 once per shape group
    # in every step, in fp32 and then in bf16 (K5 on bf16 heads)
    gpt_runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = gpt_lm.default_config()
        cfg.global_batch_size, cfg.compute_dtype = GPT_B, dtype
        k5 = "flash_attention" if dtype == "float32" else "flash_attention_bf16"
        k5_bwd = fa.BWD_KERNELS[getattr(torch, dtype)].name
        name = f"gpt_{dtype}"
        result, peak = drive(
            name,
            lambda: gpt_lm.run(cfg, preset="full", seq_len=GPT_T, steps_per_epoch=MAIN_STEPS, device=dev),
            {"gram_schmidt": MAIN_STEPS * GPT_GROUPS, k5: MAIN_STEPS * GPT_LAYERS, k5_bwd: MAIN_STEPS * GPT_LAYERS},
        )
        for kernel in (k5, k5_bwd):
            if kinds[name][kernel] != {"causal": MAIN_STEPS * GPT_LAYERS}:
                fail(f"{name}: {kernel} launches by kind {kinds[name][kernel]}, want every one causal")
        losses = result["losses"]
        if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
            fail(f"{name} losses {losses}")
        if result["bits_per_step"] != GPT_BITS + 32 or result["shape_groups"] != GPT_GROUPS:
            fail(f"{name}: {result['bits_per_step']} bits per step (want {GPT_BITS} + 32), {result['shape_groups']} groups")
        timed_ms = result["device_time_ms"][WARMUP_STEPS:]
        p50_ms = statistics.median(timed_ms)
        profiles[name] = profile_main_path(
            dev, gpt_lm, cfg, None,
            {k: device_fns[k] for k in ("gram_schmidt", "flash_attention", "flash_attention_bwd")},
            build=lambda group: gpt_lm.build(cfg, "full", GPT_T, "powersgd", dev, group),
            batches=list(gpt_lm.synthetic_lm_batches(result["vocab"], GPT_B, GPT_T, 1 + PROFILE_STEPS, cfg.seed)),
        )
        gpt_runs[dtype] = {
            "losses": losses, "final_perplexity": result["final_perplexity"], "timed_steps": len(timed_ms),
            "step_device_ms": timed_ms, "step_device_ms_p50": p50_ms,
            "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
            "tokens_per_s": result["tokens_per_step"] / (p50_ms / 1e3), "peak_memory_bytes": peak,
            "bits_per_step": result["bits_per_step"], "launches": launches[name], "k5_launches_by_kind": kinds[name],
            "profile": profiles[name],
        }
    busy_bf16 = profiles["gpt_bfloat16"]["device_busy_ms_per_step"]
    bwd_bf16 = gpt_bwd["bfloat16"]["device_ms"]
    emit({
        "phase": "main_path_gpt", "model": "gpt2_small", "vocab": 1024, "seq_len": GPT_T, "global_batch": GPT_B,
        "tokens_per_step": GPT_B * GPT_T, "reducer_rank": gpt_lm.default_config().reducer_rank,
        "parameters": result["parameters"], "shape_groups": GPT_GROUPS, "world_size": result["num_devices"],
        "runs": gpt_runs,
        "losses_fp32_and_bf16": [gpt_runs["float32"]["losses"], gpt_runs["bfloat16"]["losses"]],
        "k5_backward_device_ms_per_step": {k: v["device_ms"] for k, v in gpt_bwd.items()},
        "k5_backward_share_of_bf16_busy": bwd_bf16 / busy_bf16 if bwd_bf16 and busy_bf16 else None,
    })

    # GPT-2 small decoding at GPT-2's own vocabulary (gpt_generate): no
    # kernel of the port (prefill and decode attend in plain fp32 PyTorch,
    # as the JAX package's do)
    gen_runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = gpt_generate.default_config()
        cfg.compute_dtype = dtype
        result, peak = drive(
            f"generate_{dtype}",
            lambda: gpt_generate.run(
                cfg, preset="full", batch=GEN_B, prompt_len=GEN_PROMPT, max_new_tokens=GEN_NEW, vocab=GEN_VOCAB,
                device=dev,
            ),
            {}, kernel_free=True,
        )
        gen_runs[dtype] = {**result, "peak_memory_bytes": peak}
    # at full width in fp32: each decode step's logits against a full forward
    # of the same prefix (einsum attention: a prefix of 129 to 159 tokens does
    # not divide into K5's blocks), and the greedy tokens against the full
    # forwards' wherever the top two logits stand more than the tolerance apart
    total = GEN_PROMPT + GEN_NEW
    model = gpt_generate.build_model("full", total, GEN_VOCAB, torch.float32, dev, seed=cfg.seed)
    naive = gpt_model.GPTLM(dataclasses.replace(model.config, attn_impl="einsum"), device=dev, seed=cfg.seed)
    naive.load_state_dict(model.state_dict())
    prompt = torch.randint(
        0, GEN_VOCAB, (GEN_B, GEN_PROMPT), generator=torch.Generator().manual_seed(cfg.seed + 1)
    ).to(dev)
    decode_err, sure_tokens = 0.0, 0
    with torch.no_grad():
        tokens = gpt_model.generate(model, prompt, GEN_NEW)
        if tokens[0, :8].tolist() != gen_runs["float32"]["sample_head"]:
            fail(f"generate: {tokens[0, :8].tolist()} != the run's sample head {gen_runs['float32']['sample_head']}")
        logits, cache = gpt_model.gpt_prefill(model, prompt, total)
        ids = prompt
        for i in range(GEN_NEW):
            full = naive(ids)[:, -1]
            tol = DECODE_TOL * max(1.0, full.abs().max().item())
            err = (logits - full).abs().max().item()
            if not err <= tol:
                fail(f"generate: decode logits at position {ids.shape[1] - 1} differ from a full forward by {err} > {tol}")
            decode_err = max(decode_err, err)
            top2 = full.topk(2).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
            if not torch.equal(full.argmax(-1)[sure], tokens[sure, i]):
                fail(f"generate: greedy token {i} differs from the full forward's where the margin exceeds {2 * tol}")
            sure_tokens += int(sure.sum())
            if i + 1 < GEN_NEW:
                logits, cache = gpt_model.gpt_decode_step(model, cache, tokens[:, i], ids.shape[1])
            ids = torch.cat([ids, tokens[:, i : i + 1]], dim=1)
    del model, naive, cache
    emit({
        "phase": "main_path_gpt_generate", "model": "gpt2_small", "vocab": GEN_VOCAB, "batch": GEN_B,
        "prompt_len": GEN_PROMPT, "max_new_tokens": GEN_NEW, "runs": gen_runs,
        "decode_vs_full_forward_max_abs_err": decode_err, "tolerance": DECODE_TOL,
        "greedy_tokens_checked": sure_tokens, "greedy_tokens": GEN_B * GEN_NEW,
    })

    # GPT-2 small served (serve_gpt's preset full): no kernel of the port
    # (the serving steps attend in plain fp32 PyTorch, the paged ops are
    # torch indexing, as the JAX package's are XLA)
    serving_phases(dev, drive, all_kernels)

    # DistilBERT/IMDb PowerSGD in bf16: K5 on bf16 heads once per layer
    cfg = powersgd_imdb.default_config()
    cfg.training_epochs, cfg.compute_dtype = 1, "bfloat16"
    result, peak = drive(
        "imdb_bf16", lambda: powersgd_imdb.run(cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS),
        {
            "gram_schmidt": MAIN_STEPS * len(imdb_shapes), "flash_attention_bf16": MAIN_STEPS * IMDB_LAYERS,
            "flash_attention_bwd_bf16": MAIN_STEPS * IMDB_LAYERS,
        },
    )
    for kernel in ("flash_attention_bf16", "flash_attention_bwd_bf16"):
        if kinds["imdb_bf16"][kernel] != {"masked": MAIN_STEPS * IMDB_LAYERS}:
            fail(f"imdb_bf16: {kernel} launches by kind {kinds['imdb_bf16'][kernel]}")
    losses = result["losses"]
    if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"imdb_bf16 losses {losses}")
    if result["bits_per_step"] != IMDB_BITS + 32:
        fail(f"imdb_bf16 bits per step {result['bits_per_step']} (want {IMDB_BITS} + 32)")
    timed_ms = result["device_time_ms"][WARMUP_STEPS:]
    p50_ms = statistics.median(timed_ms)
    bf16_cfg = powersgd_imdb.default_config()
    bf16_cfg.global_batch_size, bf16_cfg.compute_dtype = IMDB_B, "bfloat16"
    profiles["imdb_bf16"] = profile_main_path(dev, powersgd_imdb, bf16_cfg, imdb_arrays, {
        k: device_fns[k] for k in ("gram_schmidt", "flash_attention", "flash_attention_bwd")
    })
    emit({
        "phase": "main_path_imdb_bf16", "model": "distilbert_base", "compute_dtype": "bfloat16",
        "global_batch": result["global_batch"], "max_len": result["max_len"], "reducer_rank": result["reducer_rank"],
        "losses": losses, "losses_fp32": results["imdb"]["losses"], "timed_steps": len(timed_ms),
        "step_device_ms": timed_ms, "step_device_ms_p50": p50_ms,
        "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
        "sequences_per_s": result["global_batch"] / (p50_ms / 1e3), "peak_memory_bytes": peak,
        "bits_per_step": result["bits_per_step"], "launches": launches["imdb_bf16"],
        "k5_launches_by_kind": kinds["imdb_bf16"], "profile": profiles["imdb_bf16"],
    })

    # DiLoCo on ResNet-152 (diloco_cifar10's preset full, batch 512): two
    # rounds of 8 inner steps, the outer delta PowerSGD-compressed at rank 4,
    # K1 once a shape group a round and no other kernel
    cfg = diloco_cifar10.default_config()
    cfg.training_epochs = DILOCO_ROUNDS
    result, peak = drive(
        "diloco",
        lambda: diloco_cifar10.run(
            cfg, preset="full", device=dev, sync_every=DILOCO_H, reducer="powersgd", max_steps_per_epoch=DILOCO_STEPS
        ),
        {"gram_schmidt": DILOCO_ROUNDS * len(group_shapes)},
    )
    losses = result["losses"]
    if result["rounds"] != DILOCO_ROUNDS or not all(math.isfinite(v) for v in losses):
        fail(f"diloco: {result['rounds']} rounds, losses {losses}")
    # one PowerSGD pass over the parameters (the xla pipeline's bits) and H loss all-reduces
    want_bits = results["xla"]["bits_per_step"] - 32 + DILOCO_H * 32
    if result["bits_per_round"] != want_bits or result["shape_groups"] != len(group_shapes):
        fail(f"diloco: {result['bits_per_round']} bits a round (want {want_bits}), {result['shape_groups']} groups")
    round_p50 = statistics.median(result["round_device_ms"])

    def diloco_rounds(device, cfg=cfg):
        """Each round's batches, one epoch a round, on ``device``."""
        return [
            [tuple(torch.from_numpy(a).to(device) for a in b) for b in accumulated_batches([images, labels], cfg)(e)]
            for e in range(DILOCO_ROUNDS)
        ]

    profiles["diloco"] = profile_main_path(
        dev, diloco_cifar10, cfg, None, {"gram_schmidt": device_fns["gram_schmidt"]}, steps=1,
        build=lambda group: diloco_cifar10.build(cfg, "full", dev, group, DILOCO_H, "powersgd"),
        units=diloco_rounds,  # a warm-up round and a profiled one
    )
    emit({
        "phase": "main_path_diloco", "model": "resnet152", "stem": "imagenet", "width": 64,
        "global_batch": cfg.global_batch_size, "sync_every": DILOCO_H, "reducer": "powersgd",
        "reducer_rank": result["reducer_rank"], "world_size": result["num_devices"], "rounds": result["rounds"],
        "losses": losses, "round_device_ms": result["round_device_ms"], "round_device_ms_p50": round_p50,
        "round_host_s": result["round_time_s"],
        "images_per_s": cfg.global_batch_size * DILOCO_H / (round_p50 / 1e3),
        # the first round's span holds the new model's first allocations; the last is steady
        "images_per_s_last_round": cfg.global_batch_size * DILOCO_H / (result["round_device_ms"][-1] / 1e3),
        "bits_per_round": result["bits_per_round"], "bits_per_step": result["bits_per_step"],
        "shape_groups": result["shape_groups"], "peak_memory_bytes": peak, "launches": launches["diloco"],
        "nvidia_smi": smi, "profile_one_round": profiles["diloco"],
    })

    # the bandwidth study at its full preset on one card: each configuration
    # timed, its collectives recorded, its step projected for eight workers;
    # K1 once a shape group in each PowerSGD step and each DiLoCo round
    study_k1 = len(group_shapes) * (
        len(STUDY_POWERSGD_ROWS) * (2 + STUDY_TIMED_STEPS) + (2 + STUDY_TIMED_ROUNDS)
    )
    study, peak = drive(
        "bandwidth_study",
        lambda: bandwidth_study.run(
            preset="full", device=dev, timed_steps=STUDY_TIMED_STEPS, timed_rounds=STUDY_TIMED_ROUNDS,
            project_workers=STUDY_PROJECT_WORKERS,
        ),
        {"gram_schmidt": study_k1},
    )
    rows = study["results"]
    for name, r in rows.items():
        recorded = r.get("recorded_bits_per_step", r.get("recorded_bits_per_round"))
        if recorded != r.get("bits_per_round", r["bits_per_step"]) or not math.isfinite(r["final_loss"]):
            fail(f"bandwidth_study {name}: recorded {recorded} bits against {r}")
    if not set(STUDY_POWERSGD_ROWS) <= set(rows) or len(rows) != 9:
        fail(f"bandwidth_study ran {sorted(rows)}")
    emit({
        "phase": "bandwidth_study", "model": "resnet152", "global_batch": study["global_batch"],
        "world_size": study["num_devices"], "projected_workers": study["projected_workers"],
        "rows": {
            name: {
                k: r.get(k) for k in (
                    "measured_step_s", "bits_per_step", "bits_per_round", "projected_bits_per_step",
                    "compression_ratio", "collectives", "collectives_per_round", "projected_step_s",
                    "steps_run", "rounds_run",
                )
            }
            for name, r in rows.items()
        },
        "table": study["table"], "launches": launches["bandwidth_study"], "peak_memory_bytes": peak,
        "nvidia_smi": smi,
    })

    # the bandwidth artifact's structure, card and projection phases, with
    # nothing else on the card while its rows are timed
    bandwidth_artifact_phase(dev, drive, study, len(group_shapes), smi)

    # bare_init through the launcher, in a process of its own (run while
    # the kernels built)
    emit({"phase": "bare_init", "summary": bare_init.result()})

    # the host data plane: the flagship fed by the native loader through
    # device_prefetch (pinned slots, a side stream) against the numpy loader
    # and synchronous copies, in turns, bit for bit; the trace; torn batches
    data_plane_phases(dev, drive, images, labels, len(group_shapes), smi)

    # the checkpointed paths: ResNet-152 PowerSGD resumed bit for bit (K1),
    # exact_cifar10 --checkpoint-dir through the launcher, and GPT-2 small of
    # the serving shape trained (K5, K1) and hot-loaded by serve_gpt
    resilience_phases(dev, drive, launches, kinds, images, labels, len(group_shapes), smi)

    # the model-parallel GPT entries at GPT-2 small widths on one card
    model_parallel_phases(dev, drive, launches, kinds, smi)

    # exact_cifar10 under FSDP (ZeRO-3) at preset full, and its sharded restore
    fsdp_phases(dev, drive, images, labels, smi)

    # the ported options: ResNet-152 in bf16, GPT-2 remat and scan_layers, DistilBERT remat
    option_phases(dev, drive, images, labels, len(group_shapes), smi)

    # the telemetry core: run logs, the wire audit, the health and fidelity
    # probe (K1; K2b, K3, K4), the memory sampler and the trace
    telemetry_paths, telemetry_mfu = telemetry_phases(dev, drive, launches, images, labels, len(group_shapes))

    # the chaos plan and the guarded step on ResNet-152 (K1), and the
    # supervising launcher restarting exact_cifar10 at preset full
    clean_ckpt = chaos_phases(dev, drive, images, labels, len(group_shapes), smi, supervised)

    # adaptive communication: exact_cifar10 --adaptive-comm at preset full
    # under a stall (K1 once it descends to compress) and the two-level round
    # on ResNet-152 (K1 in its PowerSGD outer reduction)
    adaptive_phases(dev, drive, images, labels, smi)

    # the run directory and the live plane: the supervising launcher of
    # exact_cifar10 --adaptive-comm with --run-dir and --metrics-port, clean
    # and under a throttle that the live detectors page on (K1 in the worker
    # once the alert nudges it to compress)
    k1_live_worker, live_dirs = live_phases(dev, drive, smi, live_plain)

    # the offline analyses on what those phases left: the flagship's MFU, and
    # the report, critical path, plan and apply_plan of the live run dirs
    # (which stay until main_path_report, after section 4, has read them)
    try:
        offline_phases(dev, drive, telemetry_mfu, live_dirs, smi)
    except BaseException:
        shutil.rmtree(live_dirs["root"], ignore_errors=True)
        raise

    # the fleet control plane: a game day (a serving pool's SLO burn preempts
    # supervised_resume's training command, which resumes bit for bit), a
    # serving storm under the autoscaler and launch fleet. Its jobs are
    # processes of their own and launch no port kernel, and this process
    # reads no launch count for it, so it runs beside section 4, whose
    # comparisons time nothing (a phase that fails there exits from .result())
    fleet = in_background(fleet_phases, dev, smi, clean_ckpt)
    # the accuracy study's cut CIFAR task in a process of its own, beside
    # section 4 and the fleet (none of them times anything compared); K5 at
    # its DistilBERT tiers is checked here, before section 4 reads K5's counts
    accuracy = start_accuracy_study()
    small = powersgd_cifar10.build_model("small", dev, seed=0)
    accuracy_groups = PowerSGDReducer(compression_rank=4, matricize="last").n_shape_groups(list(small.parameters()))
    del small
    study_k5 = check_study_attention(fa, dev, gen)

    # ---- 4. two steps against two steps ---------------------------------------
    # with deterministic cuDNN and no TF32, so that only what is compared differs
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False

    def two_steps(cfg, preset, device, n_power_iterations=0):
        model, step, state = powersgd_cifar10.build(cfg, preset, device, group=None)
        step.reducer.n_power_iterations = n_power_iterations
        losses = []
        for batch in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0):
            state, loss = step(state, tuple(torch.from_numpy(a).to(device) for a in batch))
            losses.append(loss.item())
        return losses, {k: v.detach().cpu() for k, v in state.params.items()}

    def max_diff(a, b):
        return max((a[k] - b[k]).abs().max().item() for k in a)

    def worst_leaf(a, b):  # the leaf of a that sets max_diff(a, b)
        return max(a, key=lambda k: (a[k] - b[k]).abs().max().item())

    def full_config(**fields):
        cfg = powersgd_cifar10.default_config()
        for k, v in fields.items():
            setattr(cfg, k, v)
        return cfg

    # the main path with the plain Gram-Schmidt against the kernel
    finals = {impl: two_steps(full_config(orthogonalize_impl=impl), "full", dev)[1] for impl in ("eager", "cuda")}
    diff = max_diff(finals["eager"], finals["cuda"])
    if not math.isfinite(diff) or diff > PARAM_TOL:
        fail(f"params after 2 steps, eager vs cuda Gram-Schmidt: max diff {diff} > {PARAM_TOL}")
    emit({"phase": "eager_vs_cuda", "steps": 2, "max_param_diff": diff, "tolerance": PARAM_TOL})

    # DiLoCo on the ResNet-152 parameters: two rounds of 8 inner steps from
    # the same weights and batches, the outer delta compressed by PowerSGD
    # with K1 and with its plain version
    def diloco_two_rounds(impl):
        cfg = diloco_cifar10.default_config()
        model = powersgd_cifar10.build_model("full", dev, seed=cfg.seed)
        reducer = PowerSGDReducer(
            random_seed=cfg.seed, compression_rank=cfg.reducer_rank, matricize="last", orthogonalize_impl=impl
        )
        rnd = make_diloco_train_fn(
            image_classifier_loss(), model, inner_learning_rate=0.05, sync_every=DILOCO_H, reducer=reducer
        )
        state = rnd.init_state()
        before = gs.KERNEL.launches
        losses = []
        for batches in diloco_rounds(dev):
            state, round_losses = rnd(state, batches)
            losses.append(round_losses.tolist())
        return losses, {k: v.detach().cpu() for k, v in state.params.items()}, gs.KERNEL.launches - before

    (losses_a, params_a, k1_a), (losses_b, params_b, k1_b) = (diloco_two_rounds(i) for i in ("cuda", "eager"))
    diff = max_diff(params_a, params_b)
    if (k1_a, k1_b) != (DILOCO_ROUNDS * len(group_shapes), 0):
        fail(f"diloco cuda vs eager: K1 launched {k1_a} and {k1_b} times")
    if not math.isfinite(diff) or diff > PARAM_TOL:
        fail(f"params after {DILOCO_ROUNDS} DiLoCo rounds, cuda vs eager Gram-Schmidt: max diff {diff} > {PARAM_TOL}")
    emit({
        "phase": "diloco_eager_vs_cuda", "rounds": DILOCO_ROUNDS, "sync_every": DILOCO_H,
        "losses": [losses_a, losses_b], "k1_launches": [k1_a, k1_b], "max_param_diff": diff,
        "max_param_diff_leaf": worst_leaf(params_a, params_b), "tolerance": PARAM_TOL,
    })
    del params_a, params_b

    # the fused main path against xla; then with one extra power iteration,
    # whose second round runs K2b
    for phase, extra_rounds in (("fused_vs_xla", 0), ("fused_vs_xla_power_iteration", 1)):
        finals = {}
        for impl in ("xla", "pallas"):
            for k in ps.KERNELS:
                k.launches = 0
            finals[impl] = two_steps(full_config(compress_impl=impl), "full", dev, extra_rounds)[1]
        counts = {k.name: k.launches for k in ps.KERNELS}
        groups = results["pallas"]["shape_groups"]
        want = {
            "ef_compress": 2 * groups, "compress": 2 * groups * extra_rounds,
            "orthogonalize_project": 2 * groups * (1 + extra_rounds), "decompress_residual": 2 * groups,
        }
        if counts != want:
            fail(f"{phase}: fused launches {counts}, expected {want}")
        if extra_rounds:
            compress_by_path = {phase: counts["compress"]}
        diff = max_diff(finals["xla"], finals["pallas"])
        if not math.isfinite(diff) or diff > PARAM_TOL:
            fail(f"params after 2 steps, {phase}: max diff {diff} > {PARAM_TOL}")
        emit({
            "phase": phase, "steps": 2, "n_power_iterations": extra_rounds, "fused_launches": counts,
            "max_param_diff": diff, "tolerance": PARAM_TOL,
        })

    # a small input against the CPU path, which the CPU tests hold against
    # the JAX package: the small preset at global batch 16, on the card and
    # on the CPU, from the same seed and batches
    cfg = full_config(global_batch_size=16)
    (cpu_losses, cpu_params), (gpu_losses, gpu_params) = (
        two_steps(cfg, "small", torch.device("cpu")), two_steps(cfg, "small", dev)
    )
    diff = max_diff(cpu_params, gpu_params)
    loss_diff = max(abs(a - b) for a, b in zip(cpu_losses, gpu_losses))
    if not (math.isfinite(diff) and diff <= SMALL_TOL and loss_diff <= SMALL_TOL):
        fail(f"small preset, cuda vs cpu: params {diff}, losses {loss_diff} > {SMALL_TOL}")
    emit({
        "phase": "cuda_vs_cpu", "preset": "small", "global_batch": 16, "steps": 2,
        "losses_cuda": gpu_losses, "losses_cpu": cpu_losses,
        "max_param_diff": diff, "max_loss_diff": loss_diff, "tolerance": SMALL_TOL,
    })

    # DistilBERT: flash attention (the kernel) against einsum attention on
    # the card at full width; then the tiny model on the card against the CPU
    imdb_small, _, _ = prepare_imdb(max_len=64, vocab_size=1024, seed=imdb_cfg.seed)

    def imdb_two_steps(preset, device, arrays, **fields):
        """Losses and parameters after two steps, and the names of the
        compressed leaves whose gradient on the first batch has a rank below
        the reducer's r for them."""
        cfg = powersgd_imdb.default_config()
        cfg.global_batch_size = IMDB_B
        for k, v in fields.items():
            setattr(cfg, k, v)
        model, step, state = powersgd_imdb.build(cfg, preset, device, group=None)
        batches = [
            tuple(torch.from_numpy(a).to(device) for a in batch)
            for batch in accumulated_batches(arrays, cfg, max_steps_per_epoch=2)(0)
        ]
        names, leaves = zip(*model.named_parameters())
        powersgd_imdb.sequence_classifier_loss()(model, batches[0]).backward()
        deficient = sorted(
            names[m.leaf_index] for m in step.reducer._metas(list(leaves))
            if int(torch.linalg.matrix_rank(leaves[m.leaf_index].grad)) < m.r
        )
        losses = []
        for batch in batches:  # the step sets every .grad to None first
            state, loss = step(state, batch)
            losses.append(loss.item())
        return losses, {k: v.detach().cpu() for k, v in state.params.items()}, deficient

    small_arrays = [imdb_small["input_ids"], imdb_small["attention_mask"], imdb_small["labels"]]
    for phase, preset, arrays, sides in (
        ("imdb_flash_vs_einsum", "full", imdb_arrays,
         ((dev, {"attn_impl": "flash"}), (dev, {"attn_impl": "einsum"}))),
        ("imdb_cuda_vs_cpu", "small", small_arrays, ((dev, {}), (torch.device("cpu"), {}))),
    ):
        record = {"phase": phase, "preset": preset, "global_batch": IMDB_B, "steps": 2, "tolerance_full_rank_leaves": IMDB_TOL}
        for rank in (1, powersgd_imdb.default_config().reducer_rank):
            before = fa.KERNEL.launches
            (losses_a, params_a, deficient), (losses_b, params_b, _) = (
                imdb_two_steps(preset, device, arrays, reducer_rank=rank, **fields) for device, fields in sides
            )
            if rank == 1 and deficient:
                fail(f"{phase} at rank 1: leaves of gradient rank 0: {deficient}")
            full_rank = {k: v for k, v in params_a.items() if k not in deficient}
            diff_full_rank = max_diff(full_rank, params_b)
            diff = max_diff(params_a, params_b)
            loss_diff = max(abs(a - b) for a, b in zip(losses_a, losses_b))
            tol = IMDB_TOL if rank == 1 else IMDB_RANK16_TOL
            if not (math.isfinite(diff) and diff_full_rank <= IMDB_TOL and diff <= tol and loss_diff <= tol):
                fail(
                    f"{phase} at rank {rank}: params {diff_full_rank} over the leaves of full gradient rank"
                    f" (tol {IMDB_TOL}), {diff} over all and losses {loss_diff} (tol {tol})"
                )
            record[f"rank_{rank}"] = {
                "losses": [losses_a, losses_b], "max_param_diff_full_rank_leaves": diff_full_rank,
                "max_param_diff": diff, "max_loss_diff": loss_diff, "tolerance_all_leaves_and_losses": tol,
                "rank_deficient_leaves": deficient, "flash_launches": fa.KERNEL.launches - before,
            }
        emit(record)

    # GPT-2 small: flash attention (K5, causal) against einsum on the card,
    # two fp32 PowerSGD steps from the same weights and batches
    def gpt_two_steps(attn_impl):
        cfg = gpt_lm.default_config()
        cfg.global_batch_size, cfg.attn_impl = GPT_B, attn_impl
        model, step, state = gpt_lm.build(cfg, "full", GPT_T, "powersgd", dev, group=None)
        batches = [
            tuple(torch.from_numpy(a).to(dev) for a in b)
            for b in gpt_lm.synthetic_lm_batches(model.config.vocab_size, GPT_B, GPT_T, 2, cfg.seed)
        ]
        names, leaves = zip(*model.named_parameters())
        gpt_lm.lm_loss()(model, batches[0]).backward()
        deficient = sorted(
            names[m.leaf_index] for m in step.reducer._metas(list(leaves))
            if int(torch.linalg.matrix_rank(leaves[m.leaf_index].grad)) < m.r
        )
        k5 = (fa.KERNEL, fa.BWD_KERNELS[torch.float32])
        losses, before = [], [k.launches for k in k5]
        for batch in batches:  # the step sets every .grad to None first
            state, loss = step(state, batch)
            losses.append(loss.item())
        launched = [k.launches - b for k, b in zip(k5, before)]  # forward, backward
        return losses, {k: v.detach().cpu() for k, v in state.params.items()}, deficient, launched

    (losses_a, params_a, deficient, flash_launches), (losses_b, params_b, _, einsum_launches) = (
        gpt_two_steps(i) for i in ("flash", "einsum")
    )
    diff, loss_diff = max_diff(params_a, params_b), max(abs(a - b) for a, b in zip(losses_a, losses_b))
    if (flash_launches, einsum_launches) != ([2 * GPT_LAYERS] * 2, [0, 0]) or deficient:
        fail(
            f"gpt flash vs einsum: {flash_launches} and {einsum_launches} K5 launches (forward, backward) in 2"
            f" steps, rank-deficient leaves {deficient}"
        )
    if not (math.isfinite(diff) and diff <= GPT_TOL and loss_diff <= GPT_TOL):
        fail(f"gpt flash vs einsum: params {diff}, losses {loss_diff} (tol {GPT_TOL})")
    emit({
        "phase": "gpt_flash_vs_einsum", "model": "gpt2_small", "global_batch": GPT_B, "seq_len": GPT_T, "steps": 2,
        "losses": [losses_a, losses_b], "max_param_diff": diff, "max_param_diff_leaf": worst_leaf(params_a, params_b),
        "max_loss_diff": loss_diff, "tolerance": GPT_TOL, "rank_deficient_leaves": deficient, "flash_launches_forward_backward": flash_launches,
    })
    del params_a, params_b

    # the IMDb baseline: flash attention (K5) against einsum on the card, two
    # steps from the same weights. Exact gradients: every leaf to IMDB_TOL,
    # but for AdamW the attention's key biases, whose gradient is zero in
    # exact arithmetic (a softmax does not change when all of a query's
    # scores move together): Adam scales their rounding noise up to about lr
    # a step, so there they are held to Adam's bound
    def baseline_two_steps(opt, attn_impl):
        cfg = imdb_baseline.default_config(opt)
        cfg.attn_impl = attn_impl
        model, step, state = imdb_baseline.build(cfg, "full", dev, opt)
        losses = []
        for batch in accumulated_batches(imdb_arrays, cfg, max_steps_per_epoch=2)(0):
            state, loss = step(state, tuple(torch.from_numpy(a).to(dev) for a in batch))
            losses.append(loss.item())
        return losses, {k: v.detach().cpu() for k, v in state.params.items()}

    record = {"phase": "imdb_baseline_flash_vs_einsum", "preset": "full", "global_batch": IMDB_B, "steps": 2,
              "tolerance": IMDB_TOL}
    for opt in imdb_baseline.OPTIMIZERS:
        k5 = (fa.KERNEL, fa.BWD_KERNELS[torch.float32])
        before = [k.launches for k in k5]
        (losses_a, params_a), (losses_b, params_b) = (baseline_two_steps(opt, impl) for impl in ("flash", "einsum"))
        flash_launches = [k.launches - b for k, b in zip(k5, before)]  # forward, backward
        noise = {k for k in params_a if k.endswith("attention.k_lin.bias")} if opt == "adamw" else set()
        bound = ADAM_NOISE_BOUND * imdb_baseline.default_config(opt).learning_rate * 2
        kept = {k: v for k, v in params_a.items() if k not in noise}
        diff = max_diff(kept, params_b)
        noise_diff = max_diff({k: params_a[k] for k in noise}, params_b) if noise else 0.0
        loss_diff = max(abs(a - b) for a, b in zip(losses_a, losses_b))
        if flash_launches != [2 * IMDB_LAYERS] * 2:
            fail(f"imdb_baseline {opt}: flash attention launched {flash_launches} times (forward, backward) in 2 steps")
        if not (math.isfinite(diff) and diff <= IMDB_TOL and loss_diff <= IMDB_TOL and noise_diff <= bound):
            fail(
                f"imdb_baseline {opt}, flash vs einsum: params {diff}, losses {loss_diff} (tol {IMDB_TOL}),"
                f" key biases {noise_diff} (bound {bound})"
            )
        record[opt] = {
            "losses": [losses_a, losses_b], "max_param_diff": diff, "max_param_diff_leaf": worst_leaf(kept, params_b),
            "max_loss_diff": loss_diff, "key_bias_leaves": len(noise), "max_key_bias_diff": noise_diff, "key_bias_bound": bound,
            "flash_launches_forward_backward": flash_launches,
        }
    emit(record)

    # the run report and the perf gate over the live run directories. It
    # launches nothing, but drive sets every launch count to 0, and section
    # 4 reads them, so it runs after section 4, beside the fleet's thread
    # (whose jobs are processes of their own)
    try:
        report_phases(dev, drive, live_dirs, smi)
    finally:
        shutil.rmtree(live_dirs["root"], ignore_errors=True)
    try:
        fleet.result()
    finally:
        shutil.rmtree(os.path.dirname(clean_ckpt), ignore_errors=True)
    k1_accuracy = accuracy_study_phase(accuracy, study_k5, accuracy_groups, smi)

    # ---- 5. the kernels ------------------------------------------------------
    # what the xla path runs for the same work, as a yardstick for later work
    emit({"phase": "xla_yardstick", "ms_per_step": xla_ms, "device_ms_per_step": xla_device_ms})
    source = "network_distributed_pytorch_tpu_torch/csrc/powersgd.cu"
    pallas = "network_distributed_pytorch_tpu/ops/pallas_powersgd.py"
    replaces = {  # the Pallas kernel bodies
        "ef_compress": f"{pallas}:78", "compress": f"{pallas}:88",
        "orthogonalize_project": f"{pallas}:96", "decompress_residual": f"{pallas}:121",
    }
    k1_paths = {
        "resnet152_xla": "xla", "distilbert_imdb": "imdb", "distilbert_imdb_bf16": "imdb_bf16",
        # data_plane_phases: the numpy loader's run, the native prefetched one and the traced one
        "resnet152_data_plane_numpy": "data_plane_numpy", "resnet152_data_plane_native": "data_plane_native",
        "resnet152_data_plane_trace": "data_plane_trace",
        "gpt2_small_fp32": "gpt_float32", "gpt2_small_bf16": "gpt_bfloat16",
        "resnet152_diloco": "diloco", "bandwidth_study": "bandwidth_study",
        # the bandwidth artifact: ResNet-18 w16 rows (structure and card) and the flagship in fp32 and bf16
        "bandwidth_artifact": "bandwidth_artifact",
        "resnet152_resilient_resume": "resilient_resume", "gpt2_small_serve_hot_load": "serve_hot_load",
        "gpt2_small_moe_top1": "gpt_moe_top1", "gpt2_small_moe_top2": "gpt_moe_top2",
        "gpt2_small_moe_bf16": "gpt_moe_bf16",
        # option_phases: ResNet-152 in bf16, GPT-2 plain and remat, scan_layers, DistilBERT plain and remat
        "resnet152_bf16_xla": "bf16_xla", "gpt2_small_opt_plain_fp32": "gpt_plain_float32",
        "gpt2_small_remat_fp32": "gpt_remat_float32", "gpt2_small_opt_plain_bf16": "gpt_plain_bfloat16",
        "gpt2_small_remat_bf16": "gpt_remat_bfloat16", "gpt2_small_scan_layers": "gpt_scan",
        "distilbert_imdb_opt_plain": "imdb_plain", "distilbert_imdb_remat": "imdb_remat",
        # telemetry_phases: TELEMETRY_STEPS steps and a probe every TELEMETRY_EVERY, each once a shape group
        "resnet152_telemetry_xla": telemetry_paths["xla"],
        # chaos_phases: the guarded runs, the real NaN's three attempts and the timed turns
        "resnet152_chaos_guarded": "chaos_guarded",
        # adaptive_phases: ResNet-50's compress rung and ResNet-152's hierarchical outer reduction
        "resnet50_adaptive": "main_path_adaptive", "resnet152_hierarchical": "main_path_hierarchical",
    }
    kernels = [{
        "name": "gram_schmidt",
        "route": "cuda",
        "source": "network_distributed_pytorch_tpu_torch/csrc/gram_schmidt.cu",
        "replaces": "network_distributed_pytorch_tpu/ops/pallas_orthogonalize.py:28",
        # on every path that runs it: ResNet (xla pipeline), DistilBERT (fp32, bf16), GPT-2 (fp32, bf16),
        # DiLoCo's outer delta (ResNet-152) and the bandwidth study's PowerSGD rows
        "launches": sum(launches[path]["gram_schmidt"] for path in k1_paths.values()),
        "launches_by_path": {name: launches[path]["gram_schmidt"] for name, path in k1_paths.items()},
        # launched in a supervised worker process (live_phases), counted by
        # the worker's own wrapper at its exit: steps on compress x groups
        "launches_in_supervised_workers": {"resnet50_live_nudge": k1_live_worker},
        # launched in the accuracy study's process (accuracy_study), counted by its own wrapper
        "launches_in_accuracy_study": {"resnet18_w16_powersgd_r4": k1_accuracy},
        "max_abs_err": main_err,
        "ms": gs_ms,
        "device_ms": gs_device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this sequential Gram-Schmidt
        "library_device_ms": None,
        "device_ms_in_path_profile": profiles["xla"]["kernels"]["gram_schmidt"]["device_ms_per_step"],
        # the same 21 groups once a DiLoCo round
        "device_ms_in_diloco_round_profile": profiles["diloco"]["kernels"]["gram_schmidt"]["device_ms_per_step"],
        # ms, device_ms, plain_ms and bound_ms above are one ResNet step's; one DistilBERT step's:
        "distilbert_imdb": {
            **{k: gs_imdb[k] for k in ("ms_per_step", "device_ms_per_step", "plain_ms_per_step", "bound_ms", "bound_by")},
            "device_ms_in_path_profile": profiles["imdb"]["kernels"]["gram_schmidt"]["device_ms_per_step"],
            "device_ms_per_group": gs_imdb["device_ms_per_group"],
        },
        "route_and_cluster": routes,
    }]
    for name, row in fused_rows.items():
        fused_paths = {
            "resnet152_fused": "pallas", "resnet152_bf16_fused": "bf16_pallas",
            # the telemetry run's probes: the probe's round is K2b's first main path
            "resnet152_telemetry_fused": telemetry_paths["pallas"],
        }
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces[name],
            "launches": sum(launches[path][name] for path in fused_paths.values()) + (
                sum(compress_by_path.values()) if name == "compress" else 0
            ),
            # K2b: the health probe's diagnostic round, and the phase with an extra power iteration
            "launches_by_path": {
                **{k: launches[v][name] for k, v in fused_paths.items()},
                **(compress_by_path if name == "compress" else {}),
            },
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "library_device_ms": row["library_device_ms"],
        })
    k5_paths = {
        "distilbert_imdb": "imdb",
        **{f"imdb_baseline_{opt}": f"imdb_baseline_{opt}" for opt in imdb_baseline.OPTIMIZERS},
        "gpt2_small_fp32": "gpt_float32",
        "gpt2_small_serve_hot_load": "serve_hot_load",
        "gpt2_small_pp": "gpt_pp",
        "gpt2_small_moe_top1": "gpt_moe_top1",
        "gpt2_small_moe_top2": "gpt_moe_top2",
        "gpt2_small_opt_plain_fp32": "gpt_plain_float32",
        "gpt2_small_remat_fp32": "gpt_remat_float32",  # the forward twice a layer a step
        "gpt2_small_scan_layers": "gpt_scan",
        "distilbert_imdb_opt_plain": "imdb_plain",
        "distilbert_imdb_remat": "imdb_remat",
    }
    k5_bf16_paths = {
        "gpt2_small_bf16": "gpt_bfloat16", "distilbert_imdb_bf16": "imdb_bf16", "gpt2_small_moe_bf16": "gpt_moe_bf16",
        "gpt2_small_opt_plain_bf16": "gpt_plain_bfloat16", "gpt2_small_remat_bf16": "gpt_remat_bfloat16",
    }

    def by_kind(name, paths):
        total = {}
        for path in paths.values():
            for kind, n in kinds[path][name].items():
                total[kind] = total.get(kind, 0) + n
        return total

    k5 = {k: v for k, v in attn_row.items() if k != "max_abs_err"}
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "network_distributed_pytorch_tpu_torch/csrc/flash_attention.cu",
        "replaces": "network_distributed_pytorch_tpu/ops/flash_attention.py:76",
        # fp32 heads, on every path that runs them: PowerSGD DistilBERT, the
        # single-node baseline (masked) and GPT-2 small (causal)
        "launches": sum(launches[path]["flash_attention"] for path in k5_paths.values()),
        "launches_by_path": {name: launches[path]["flash_attention"] for name, path in k5_paths.items()},
        "launches_by_kind": by_kind("flash_attention", k5_paths),
        "max_abs_err": max(
            attn_row["max_abs_err"], *(r["max_abs_err"] for n, r in bf16_report.items() if n.endswith("fp32"))
        ),
        # one step's launches on the first IMDb batch's mask; SDPA given the same additive mask
        **k5,
        "device_ms_in_path_profile": profiles["imdb"]["kernels"]["flash_attention"]["device_ms_per_step"],
        "device_ms_in_baseline_profile": profiles["imdb_baseline"]["kernels"]["flash_attention"]["device_ms_per_step"],
        "no_mask": no_mask_row,
        # one GPT-2 step's 12 causal launches at (16 x 12, 1024, 64); SDPA is_causal
        "gpt_causal": {
            **gpt_rows["gpt_causal_fp32"],
            "device_ms_in_path_profile": profiles["gpt_float32"]["kernels"]["flash_attention"]["device_ms_per_step"],
        },
    })
    bf16_row = gpt_rows["gpt_causal_bf16"]
    kernels.append({
        "name": "flash_attention_bf16", "route": "cuda",
        "source": "network_distributed_pytorch_tpu_torch/csrc/flash_attention.cu",
        "replaces": "network_distributed_pytorch_tpu/ops/flash_attention.py:76",
        # bf16 heads: GPT-2 small (causal) and PowerSGD DistilBERT (masked) in bf16
        "launches": sum(launches[path]["flash_attention_bf16"] for path in k5_bf16_paths.values()),
        "launches_by_path": {name: launches[path]["flash_attention_bf16"] for name, path in k5_bf16_paths.items()},
        "launches_by_kind": by_kind("flash_attention_bf16", k5_bf16_paths),
        "max_abs_err": bf16_err,
        # one GPT-2 step's 12 causal launches on bf16 heads; SDPA is_causal on the same bf16 inputs
        **bf16_row,
        "device_ms_in_path_profile": profiles["gpt_bfloat16"]["kernels"]["flash_attention"]["device_ms_per_step"],
        "imdb_mask": {
            **imdb_bf16_row,
            "device_ms_in_path_profile": profiles["imdb_bf16"]["kernels"]["flash_attention"]["device_ms_per_step"],
        },
    })
    for tag, paths in (("float32", k5_paths), ("bfloat16", k5_bf16_paths)):
        name = fa.BWD_KERNELS[getattr(torch, tag)].name
        gpt_path = "gpt_float32" if tag == "float32" else "gpt_bfloat16"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "network_distributed_pytorch_tpu_torch/csrc/flash_attention_bwd.cu",
            # _flash_bwd_chunked, the custom_vjp backward (an XLA scan, not a Pallas kernel)
            "replaces": "network_distributed_pytorch_tpu/ops/flash_attention.py:152",
            "launches": sum(launches[path][name] for path in paths.values()),
            "launches_by_path": {label: launches[path][name] for label, path in paths.items()},
            "launches_by_kind": by_kind(name, paths),
            "max_abs_err": bwd_err[tag],
            # one GPT-2 step's 12 causal backwards at (16 x 12, 1024, 64); SDPA's backward on the same inputs
            **gpt_bwd[tag],
            # the three device functions of each call, in the GPT-2 path's profile
            "device_ms_in_path_profile": profiles[gpt_path]["kernels"]["flash_attention_bwd"]["device_ms_per_step"],
        })
    emit({"kernels": kernels})
    # the card's name and power limit, exactly as nvidia-smi gives them
    sys.stdout.write(smi + "\n")
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })


if __name__ == "__main__":
    main()
