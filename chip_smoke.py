#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (climsim_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from climsim_tpu_torch/ops/csrc (nvcc, sm_90a)
   and prints the build time and the compiler's register/spill report
   (fused_gn_silu_conv3's by tiling; it must not spill).
3. Checks each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it (B = 1, 7, 384, 6144; the v2_rh
   width 557 and the v5 width 1405 for the input transform, and the v1
   trainer's 124 at its config up to its batch of 32768; the full
   557 -> 1024 x 4 -> 368 MLP_v2rh for the fused MLPs, also at B = 50,
   ragged widths, and hidden widths of 1536 at B = 384 and 6144), and
   times both with CUDA events at B = 384 and 6144.  Kernel 1 must be
   bit-equal to plain everywhere, and on x[1:] of 6145 v2_rh rows (a start
   off a 16-byte boundary), and so must its pipelined path (bulk-copied
   row tiles, which its plan takes past half the L2) forced at B = 7,
   6144, v5 1024 and v1 32768; it is timed by device time (CUDA-graph
   replays) at v2_rh B = 1 (the launch floor), 384 and 6144, v1 B = 32768
   and v5 B = 1024, each beside its bound, with the wrapper's host cost a
   call (back-to-back calls) at 384 and 6144.  Kernels 2 and 3
   (one tensor-core kernel, its plan printed, its plan's shared memory
   held against the kernel's own layout):
   a row's bits alone and inside its batch (50 in 384, 7 in 6144) must
   be equal, kernel 2 with one bf16 pass (a planted fault) must fail the
   tolerance, and they are timed as CUDA-graph replays beside a cuBLAS
   bf16 chain of the same five products (a yardstick, never called by
   the port).
4. Serves the full-width MLP_v2rh (random weights from --seed, in the flax
   layout, moved across by the weight porter) through the port's
   CouplingServer, bf16 and then int8 weights: three concurrent 384-column
   chunks, one ragged 50-row request, then N_LOOP sequential requests.
   Every reply must equal the direct wrapper call on the card, match the
   plain path (the same wrapper on the CPU) within tolerance, and the
   launch counts of all three kernels must have risen in that run.
5. Checks the U-Net kernels against their plain versions on the card:
   fused_gn_silu_conv3 at the 13 (L, C, Cout) shapes of the unet_v5
   forward and two ragged ones at B = 1, 7, 50, 384, 1024, an offset-1e3
   case, a control that must fail, and (8, 1024, 512) at B = 1024, where
   the plan takes fewer samples a tile (bit-equal to another tiling of
   them); then times every chain shape at
   B = 384 and 1024 beside its bound (CUDA-graph replays: device time);
   fused_constraint_head within HEAD_TOL at B = 1, 7, 384, 6144 (whether
   bit-equal is printed), and with t, qc and qi as views of a (B, 1525)
   row at B = 7 and 6144, bit-equal to contiguous copies, its pipelined
   path forced there bit-equal to the direct one; timed as kernel 1 is,
   at B = 1, 384 and 6144.
6. Serves the full-width U-Net v5 (the unet_v5 preset, 21,231,125
   parameters, random flax-layout weights from --seed with every conv at
   full xavier scale, moved across by the porter) through the v5 coupling
   wrapper on raw v4 columns over CouplingServer: the same traffic as 4.
   Every reply must be finite, (B, 368), equal to the direct wrapper call
   (or within SERVED_TOL where a plain op is not batch-invariant; the ops
   are probed and printed), and within 2e-2 * max|y| of the all-plain
   path on the card; kernels 1, 4 and 5 must have been launched 1, 1 and
   82 times a device call of that run.  Kernel 5 must give a sample the
   same bits in any batch: 50 rows alone and inside 384, 7 alone and
   inside 1024.
6a. Serves the two-stage U-Net v5: the regressor of 6 and a full-width
   unet_v5_classifier (strato_lev_out=12, random flax-layout weights)
   gating the qn tendency (online.two_stage), through the v5 wrapper on
   raw v4 columns, N_TWO_STAGE sequential requests after 6's traffic.
   Kernels 1, 4 and 5 launched 1, 1 and 164 times a device call; the
   fused classifier's classes equal the plain one's except at near ties
   (top two plain logits within NET_TOL of the largest unforced logit),
   which are counted; the qc and qi tendencies of the levels whose top
   two lie within twice the largest gap between the engines' logits (where
   a class can flip) are left out of the reply checks (against the
   direct call and the all-plain path, as 6; the three full chunks must
   be bit-equal to the direct call);
   the top 12 levels class 0; at class-1 levels the reply's qn tendency
   drives the qn the gate recovers to zero within CLASS1_ATOL, and how
   close it drives the raw qn is printed.
6b. Serves the full-width unet_v4 U-Net through make_v4_wrapper (kernel 1
   with the qc/qi rates, then the fused engine), N_V4 sequential
   requests, held as 6; 82 kernel-5 launches a device call.
6c. Train -> bundle -> serve: fits the full-width mlp_v2rh preset for
   FIT_EPOCHS epochs (fit, a top-K checkpointer, plateau and early
   stopping) on FIT_ROWS synthetic columns with norms computed from them,
   after its initial validation loss matched the CPU's; the validation
   loss must fall and the top-K best be the best epoch.  Then
   package_e3sm.build_bundle(verify=True) exports the top-K best (buckets
   384 and 1536, those norms by --norms) and the two-stage unet_v5 of 6a
   (both networks through save_state) as torch.export programs, prints
   their export seconds and bytes, and serves each through serve's
   --bundle path: replies within BUNDLE_TOL of the live wrapper, the
   kernels launched inside the loaded programs as on the live path, and a
   --batch the bundle lacks refused.
6d. Rolls out and scores on the card (online.driver, eval): HybridDriver
   around the U-Net v5 wrapper of 6 for ROLL_STEPS steps (one simulated
   day) from 384 synthetic v4 columns, forced by Newtonian relaxation
   toward the initial state (tau 2 days) with a 1.5 K/day diurnal cycle
   (scripts/online_eval.py's defaults): kernels 1, 4 and 5 launched 1, 1
   and 82 times a step, trajectories finite, q1, qc and qi >= 0; step
   1's tendencies within NET_TOL * max|y| of the all-plain path (its gap
   over PLAIN_STEPS steps printed); the same steps as three segments
   with start_step within ROLL_TOL of the one rollout, and segments that
   drop start_step (planted) outside it.  A 3-member ensemble (members
   0.05 K apart, 1152 rows a step) for 24 steps: step 1 within ROLL_TOL
   of the member loop, the later steps' gaps printed.  V2RHDriver around
   the fast MLP_v2rh wrappers (bf16, int8) for ROLL_STEPS steps (kernels
   1 and 2 or 3 once a step; step 1 against the plain versions), and the
   two-stage U-Net v5 of 6a for 12 steps (164 kernel-5 launches a step).
   Each rollout's ms a simulated step (the median of ROLL_TIMED steps,
   each synchronized, after ROLL_WARM) and over the whole rollout.  Then
   the U-Net v5's predictions (fused and plain) on 4 x 384 synthetic v5
   columns scored in W/m^2 by offline_score and by StreamingScorer over
   384-column chunks, within SCORE_TOL of each other, and the online
   diagnostics of the 72-step rollout (drift, precipitation,
   microphysics, error growth, water residual), which must be finite.
   With --profile, a 24-step U-Net v5 and MLP_v2rh bf16 rollout are
   traced: the card's busy share, device ops a step, device-to-host
   copies.
6e. bench_server's legs (python -m climsim_tpu_torch.bench_server) on the
   four served paths (MLP_v2rh bf16 and int8, U-Net v5, two-stage U-Net
   v5) at B = 384: the direct wrapper call, the served round trip with 1
   and 8 concurrent clients (bench_server.REQUESTS a client: medians,
   p90, p99, columns/s, rows a device call, pad fraction, device-call
   times); and the programs the bundle phase built at 384 (MLP_v2rh and
   the two-stage U-Net v5), each beside the live wrapper it was exported
   from.  Nothing is exported anew here.
7. Checks the fused MLP-training kernel (kernel 6: its pack, its forward
   on kernel 2's tensor-core kernel, its backward's recompute and TMA-fed
   wgmma GEMM) against its plain version on the card, forward and
   backward, at the v1 widths (124 -> 768, 640, 512, 640, 640 -> 128) and
   the MLP_v2rh widths (557 -> 1024 x 4 -> 368), B = 1, 7, 384, 32768,
   and ragged widths (124, 130, 128, 10) at B = 1, 7: the forward within
   kernel 2's tolerance; dW and db within K6_GRAD_TOL (rel-L2 and cosine
   a tensor), with a float32 control that must fail it, two runs
   bit-equal, and two values of tile_b within the JAX test's tolerance.
   The pack must be bit-equal to its plain version, the forward with one
   bf16 pass (a planted fault) must fail the forward tolerance at v1, B =
   32768, and the plan's GEMM shared memory and partials must be the
   kernel's own.  Then times the pack, and forward, backward and both (through
   make_fused_mlp_train) against the plain versions and plain autograd
   at K6_TIMED, beside the bound, the three-pass floor and a cuBLAS bf16
   chain of the same products.  The relu mask's edge: hidden units at
   2^-130 (a nonzero bf16 subnormal) and 2^-140 must get db 0 from the
   kernel, as from the plain version and JAX, and two runs be bit-equal.
8. Trains through kernel 6: 30 Adam steps on one fixed 32768-row batch at
   the v1 widths; the loss must fall by 10% and follow the same 30 steps
   through the plain version within K6_CURVE_TOL, which the plain
   version with its last layer frozen must fail (the float32 control's
   curve is printed); the pack's, the forward's and the backward's
   launch counts must have risen in that run, 30 or more each.
9. The slice's main path: trains the full-width v1 MLP (weights from a
   flax-layout tree made from --seed, moved across by port_flax_mlp)
   through mlp_trainer, DeviceResidentLoader (196,608 rows,
   block_shuffle=128) and its epoch runner: bench_train's core, a
   warm-up call and TRAIN_REPS timed calls of TRAIN_EPOCHS epochs.  The
   first step's loss must match the CPU's within FIRST_LOSS_TOL, every
   epoch's loss be finite and the last below the first, and the input
   transform kernel have been launched in that run; prints samples/s
   and a torch.profiler split of the step's device time.
9a. Trains the full-width v1 MLP from a split past the card's memory:
   STREAM_ROWS synthetic v1 rows (2.11 GB) written as an .npy pair to a
   temporary directory and memory-mapped (bench_chunked.write_split).
   The native loader is built with g++.  Copy checks: one untimed epoch
   each of ChunkedLoader (B = 32768, K = 8, prefetch 2), BatchLoader and
   NativeLoader (B = 32768) whose copy stream waits STREAM_COPY_SLOWER
   times the producer's gather before each staging's copies, and whose
   consumer waits STREAM_SLOWER times it on the card before reading each
   batch and never waits on the host, so pinned slots come round while
   their copies are pending and freed batches' memory is handed out
   while their reads are pending: every batch must be bit-equal to the
   rows its indices name, gathered on the card from a copy of the split
   there (the native loader's order from its CPU run).  A BatchLoader
   with a short last batch, over two epochs: every batch its rows, no
   pinned slot allocated anew.  Then fit, STREAM_EPOCHS epochs,
   over each loader and over DeviceResidentLoader on the same split:
   kernel 1 launched once a step, the losses finite, the first loss the
   CPU's within FIRST_LOSS_TOL, and fit over ChunkedLoader bit-equal to
   the per-step loop over the same superbatches.  Prints each loader's
   samples/s, whole and from its first batch's arrival (FillClock),
   bench_chunked's four legs (compute, transfer, gather, overlap) and the card's busy share over one ChunkedLoader epoch
   (torch.profiler).
10. Checks 5' (kernel 5 under its custom VJP, ops.unet_fused.
   make_trainable_fused_block) at every fused chain shape of the unet_v5
   training step, B = 16 and 1024: the forward within GN_TOL of the plain
   forward (the float32 control must fail), every gradient bit-equal to
   autograd of the plain chain (cuDNN off in that phase only: its
   convolutions are not reproducible), one kernel-5 launch a call; times
   forward + backward at B = 1024.
11. This slice's main path: trains the full-width U-Net v5 (the unet_v5
   preset with fused_gn_conv=True, flax-layout weights from --seed moved
   across by port_flax_unet) through unet_trainer and
   DeviceResidentLoader at B = 1024 for UNET_EPOCHS epochs
   (bench_unet_train's core).  The first loss on 16 rows must match the
   CPU's within UNET_FIRST_LOSS_TOL, the loss be finite and fall, and kernels
   1 and 5 have been launched once a step and once a fused chain a step
   (twice under remat_blocks); then the plain arm is timed beside it, a
   step of each is split by torch.profiler, peak memory is read, and 30
   steps through the kernel (at UNET_CURVE_BATCH rows) follow the same
   trainer with the plain chain forward: the losses within
   UNET_CURVE_TOL, the parameters' moves within UNET_MOVE_TOL, which a
   planted fault (dw dropped in 5''s backward) must fail.
12. With --profile, prints the fused MLPs' plans and traces the served
   paths (MLP bf16 and int8, U-Net v5, two-stage v5, v4) with
   torch.profiler (device time per kernel and copy, the card's busy
   share, kernel 5's share of it, the costliest host ops).
13. Prints one JSON line of the kernels' results (each with its bound:
   the larger of its bytes over the memory rate and its operations over
   the peak, at the timed shape; the launches include 6d's rollouts) and
   the paths' results (6d's under "rollouts"), then, last,
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Each phase prints its seconds (kept in the result line as
"phase_seconds").  Nothing is caught: any failure exits non-zero and
prints no result.
Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial

import numpy as np

FULL_HIDDEN = (1024, 1024, 1024, 1024)
KERNEL_ROWS = (1, 7, 384, 6144)
MLP_ROWS = (1, 7, 50, 384, 6144)   # kernels 2 and 3, 50: a ragged request
TIMED_ROWS = (384, 6144)
IO_TIMED_ROWS = (1, 384, 6144)   # kernels 1 (v2_rh) and 4, device time
N_LOOP = 1000   # sequential requests a weight type: p99 has 10 beyond it
N_TRACE = 100   # served requests a weight type under --profile
# Tolerances (rtol, atol) of the JAX package's tests for the same
# functions (tests/test_pallas_kernels.py:28, :88).
TOL = {"fused_input_transform": (1e-5, 1e-7),
       "fused_mlp_forward": (2e-4, 1e-4)}
# The int8 kernel rounds every activation to bf16 before its product.
# Where its float32 sum differs in the last bits from the plain version's
# (cuBLAS sums in another order), a rounding can flip by 2**-8 relative
# and carry through the later layers.  On an H100 that left 0 to 11% of
# the whole network's output elements outside TOL["fused_mlp_forward"]
# (one flipped row of seven is 11%), against 89-93% for float32
# activations in place of the rounding.  So the int8 kernel is checked
# link by link instead (int8_chain): every prefix of the network through
# the kernel, each layer against the plain version of that layer alone,
# fed the kernel's own output of the layers before it.  Both sides round
# the same float32 values to bf16, nothing can flip, and no element may
# fall outside the tolerance.  A control runs the same chain with float32
# activations and must fail it.
SOURCES = {
    "fused_input_transform": (
        "climsim_tpu_torch/ops/csrc/fused_input_transform.cu",
        "climsim_tpu/ops/kernels.py:64"),
    "fused_mlp_forward": ("climsim_tpu_torch/ops/csrc/fused_mlp_forward.cu",
                          "climsim_tpu/ops/kernels.py:228"),
    "fused_mlp_forward_int8": (
        "climsim_tpu_torch/ops/csrc/fused_mlp_forward_int8.cu",
        "climsim_tpu/ops/kernels.py:331"),
}


# The U-Net path's kernels (the served MLP path's are SOURCES above).
UNET_SOURCES = {
    "fused_gn_silu_conv3": (
        "climsim_tpu_torch/ops/csrc/fused_gn_silu_conv3.cu",
        "climsim_tpu/ops/unet_fused.py:100"),
    "fused_constraint_head": (
        "climsim_tpu_torch/ops/csrc/fused_constraint_head.cu",
        "climsim_tpu/ops/kernels.py:144"),
}
# (L, C, Cout) -> calls: the 82 fused chains of one unet_v5 forward
UNET_CHAINS = {
    (64, 128, 128): 13, (64, 256, 128): 4, (64, 256, 256): 1,
    (64, 384, 128): 1, (32, 128, 128): 1, (32, 128, 256): 1,
    (32, 256, 256): 13, (32, 384, 256): 1, (32, 512, 256): 4,
    (16, 256, 256): 15, (16, 512, 256): 5, (8, 256, 256): 18,
    (8, 512, 256): 5}
GN_ROWS = (1, 7, 50, 384, 1024)
GN_TIMED_ROWS = (384, 1024)
# ragged shapes the plan must take: L fills no tile, Cout no 64-column box
GN_RAGGED = ((60, 64, 48), (15, 128, 80))
# a chain of the 256-channel unet_v5 whose first tiling overflows shared
# memory at B = 1024 (the plan steps the samples a tile down)
GN_STEPPED = (8, 1024, 512)
# fused_gn_silu_conv3 against its plain version: max |kernel - plain| <=
# GN_TOL * max|plain|.  Both round the normalized activations to bf16;
# their float32 group statistics differ in the last bits, so a rounding
# flips now and then (2**-8 of one term of a 3C-term sum).  On an H100
# that left at most 2.92e-4 * max|y| over the 13 shapes at B = 1, 7, 384
# (the first design of the kernel) and 4.34e-4 over them and GN_RAGGED at
# GN_ROWS (the present one); float32 activations in place of the rounding
# (the control, which must fail) left 1.42e-3 to 1.89e-3 (1.44e-3 at
# least over the present checks).  With
# an offset of 1e3 on x, float32 resolves the centred values to ~6e-5
# only, the two sides' statistics differ more, flips are many (7.7e-4 *
# max|y|), and the case is held at the JAX test's 2e-2 * max|y|
# (tests/test_pallas_kernels.py:156-173), which a one-pass variance,
# E[x^2] - mean^2, fails there.
# Kernel 6, the fused MLP-training kernel (forward and backward).
K6_SOURCES = {
    "fused_mlp_train_pack": (
        "climsim_tpu_torch/ops/csrc/fused_mlp_train_fwd.cu",
        "climsim_tpu/ops/fused_mlp_train.py:57"),
    "fused_mlp_train_fwd": (
        "climsim_tpu_torch/ops/csrc/fused_mlp_train_fwd.cu",
        "climsim_tpu/ops/fused_mlp_train.py:50"),
    "fused_mlp_train_bwd": (
        "climsim_tpu_torch/ops/csrc/fused_mlp_train_bwd.cu",
        "climsim_tpu/ops/fused_mlp_train.py:64"),
}
# 5': its forward is kernel 5, its backward autograd of the plain chain
TRAINABLE_SOURCE = ("climsim_tpu_torch/ops/unet_fused.py:145",
                    "climsim_tpu/ops/unet_fused.py:160")
V1_WIDTHS = (124, 768, 640, 512, 640, 640, 128)
V2RH_WIDTHS = (557, 1024, 1024, 1024, 1024, 368)
K6_ROWS = (1, 7, 384, 32768)
# kernel 6 timed (device time, back-to-back calls) at these (widths, B);
# the first is the one the kernels line reports
K6_TIMED = (("v1", 32768), ("v2rh", 32768), ("v1", 384), ("v2rh", 384),
            ("v1", 1), ("v1", 7))
# (label, widths, batch sizes, whether the float32 control must fail):
# the two served MLPs, then ragged widths (a hidden width of 2 mod 64, an
# output of 10) that the padded layers and saves must take at odd B
K6_NETS = (("v1", V1_WIDTHS, K6_ROWS, True),
           ("v2rh", V2RH_WIDTHS, K6_ROWS, True),
           ("ragged", (124, 130, 128, 10), (1, 7), False))
# kernel 1 at the v1 trainer's config: the serving sizes and its batch
V1_TRANSFORM_ROWS = KERNEL_ROWS + (32768,)
# dW and db against the plain backward, a tensor at a time: rel-L2 at most
# K6_GRAD_TOL[0] and cosine at least K6_GRAD_TOL[1].  Both sides round the
# same float32 h and dh to bf16 and differ only in their float32 orders of
# summation; but a rounding that flips (2**-8 of a value) changes the next
# layer's sums, which flip others, and the rel-L2 grows about as
# sqrt(delta * 2**-8) a layer down the network.  On an H100 that took the
# kernel to 1.19e-3 of the plain dW at the v1 input layer (B = 7; 3.6e-6,
# 6.1e-5, 4.0e-4, 6.9e-4 in the layers above it), and at B = 32768 the
# kernel and the plain version to 5.6e-4 and 3.7e-4 of their twin with
# float64 sums; so the bound is 1.6e-3, not 1e-3.  The control keeps h and
# dh in float32 (the roundings left out) and was 2.25e-3 to 4.42e-3 off on
# every dW: it must fail the rel-L2 bound there.  The cosine, 0.99999, is
# tighter than 0.9999 as measured (at least 0.9999993).
K6_GRAD_TOL = (1.6e-3, 0.99999)
K6_TILE_TOL = (2e-2, 1e-4)    # tests/test_fused_train.py:83-84
K6_TILE_B = (128, 512)
# The 30-step loss curve through the kernels against the plain version's,
# relative, a step at a time: K6_CURVE_TOL[0] over the first 10 steps,
# K6_CURVE_TOL[1] after.  Adam divides each update by the root of its
# second moment, so gradients that differ in flipped roundings move the
# weights apart, and the loss spike near step 15 amplifies it.  On an
# H100 the kernel's curve was within 4.3e-6 to 6.2e-6 of the plain one
# over the first 10 steps and 1.21e-2 to 1.60e-2 after; the plain version
# against its twin with float64 sums: 1.0e-5 and 1.93e-2.  The float32
# control backward (gradients 2.3e-3 to 4.4e-3 off, see K6_GRAD_TOL)
# was 1.0e-5 and 1.27e-2 off: Adam's update hardly moves with noise of
# that size, so no bound here tells the roundings apart, and the gradient
# check alone decides them.  The curve catches gross faults: the plain
# version with the last layer's weights frozen must fail the early bound.
K6_CURVE_TOL = (1e-4, 5e-2)
K6_CURVE_EARLY = 10
# the trainer's first loss on the card against the CPU's: both round the
# same operands to bf16, the sums' orders differ (2.5e-7 on an H100)
FIRST_LOSS_TOL = 1e-5
# the streaming phase (9a): a v1 split of 8 superbatches of K x B rows,
# 2.11 GB, written as an .npy pair and memory-mapped
STREAM_ROWS = 2_097_152
STREAM_BATCH = 32768
STREAM_K = 8
STREAM_EPOCHS = 2          # fit epochs a loader; the rate is the second's
STREAM_LEG_REPS = 2        # bench_chunked's legs
# the copy check delays the card (torch.cuda._sleep, at SLEEP_HZ cycles a
# second) by these multiples of the producer's gather of a batch: the copy
# stream before each staging's copies, and the consumer before it reads a
# batch.  The copies then fall behind the producer, which comes round to a
# slot prefetch + 2 stagings later, from the second staging on; the reads
# fall behind the copies, whose allocations reuse a freed batch's memory a
# few stagings after it was freed, from the third on
STREAM_COPY_SLOWER = 3.0
STREAM_SLOWER = 7.0
STREAM_REMAINDER_ROWS = 132_768   # 4 full batches and one of 1,696 rows
SLEEP_HZ = 1.98e9          # the H100 SXM's highest SM clock
TRAIN_ROWS = 196_608          # 6 batches of 32768, as bench.py
TRAIN_EPOCHS = 40
TRAIN_REPS = 3
GN_TOL = 5e-4
GN_OFFSET_TOL = 2e-2
# 5' (kernel 5 under its custom VJP) and the U-Net v5 trainer
TRAINABLE_ROWS = (16, 1024)
UNET_BATCH = 1024         # the unet_v5 preset's (climsim_tpu/config.py:163)
UNET_POOL = 4             # batches on the card
UNET_EPOCHS = 2
UNET_FIRST_ROWS = 16
UNET_FIRST_BATCHES = 4
# The U-Net trainer's first loss on 16 rows, card against CPU.  Not 1e-5:
# on an H100 the all-plain model (no kernel) was 9.3e-6 to 2.6e-5 from
# the CPU over four 16-row batches, and the fused one 3.9e-6 to 3.4e-5,
# as far as the float32 control (chains without the bf16 roundings, 2.0e-5
# to 3.7e-5): the float32 sums of 40 blocks differ in order, the bf16
# roundings after them flip, and a mean over 16 x 308 outputs cannot tell
# the roundings apart.  This check catches gross faults; the 5' checks
# decide the roundings.
UNET_FIRST_LOSS_TOL = 1e-4
# 30 steps through kernel 5 against the same trainer with the plain chain
# forward, at UNET_CURVE_BATCH rows a step (a step at B = 1024 takes 1.6 s
# on an H100).  The losses, relative, a step at a time: UNET_CURVE_TOL[0]
# over the first UNET_CURVE_EARLY steps, UNET_CURVE_TOL[1] after.  The
# loss hardly depends on the fused chains' parameters in 30 steps: on an
# H100 the kernel's curve was 1.0e-5 / 2.3e-5 from the plain forward's,
# and with the chains' weight gradients dropped only 1.4e-4 / 9.5e-5.  So
# the parameters' moves over the 30 steps are compared too, rel-L2 over
# all of them, within UNET_MOVE_TOL: the kernel's were 3.7e-3 from the
# plain forward's, and the planted fault's, dw dropped in 5''s backward
# (the 82 chains' conv kernels do not learn), 0.83.  2e-2 also catches a
# fault as small as the norms' scales frozen, about (20k / 21M) ** 0.5 of
# the moves.
UNET_CURVE_STEPS = 30
UNET_CURVE_EARLY = 10
UNET_CURVE_BATCH = 256
UNET_CURVE_TOL = (1e-4, 1e-3)
UNET_MOVE_TOL = 2e-2
# the card's rates for the bounds (H100 SXM data sheet, dense)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}
HEAD_TOL = (2e-4, 1e-9)   # tests/test_pallas_kernels.py:69
NET_TOL = 2e-2            # * max|y|, tests/test_unet_infer.py:44-46
# served reply against the direct call where a plain op's result depends
# on the batch it runs in (normalized units, * max|y|)
SERVED_TOL = 2e-3


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip()


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare_timed(torch, kernel, plain, iters):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain; each the mean of its two turns."""
    p1 = time_ms(torch, plain, iters)
    k1 = time_ms(torch, kernel, iters)
    k2 = time_ms(torch, kernel, iters)
    p2 = time_ms(torch, plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def errors(got, want):
    d = (got.double() - want.double()).abs()
    rel = d / want.double().abs().clamp_min(1e-30)
    return float(d.max()), float(rel.max())


def outside(got, want, rtol, atol):
    """Share of the elements of ``got`` outside rtol/atol of ``want``."""
    return float(((got - want).abs() > atol + rtol * want.abs()).double()
                 .mean())


def check_close(torch, name, got, want, rtol, atol):
    """Require got == want within rtol/atol.  Returns (max abs, max rel)
    err."""
    require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} "
            f"!= {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    share = outside(got, want, rtol, atol)
    require(share == 0, f"{name}: {share:.3%} of the elements outside "
            f"rtol={rtol} atol={atol}; max abs err {errors(got, want)[0]:.3e}")
    return errors(got, want)


def int8_chain(torch, K, x, mlp, run):
    """Run ``run(x, net, relu_tail)`` on every prefix ``net`` of the int8
    network ``mlp`` and hold its output against the plain version of the
    prefix's last layer alone, fed ``run``'s output of the prefix before
    it.  Returns (the largest share of elements outside
    TOL["fused_mlp_forward"] at any link, max abs err)."""
    layers = list(mlp.layers())
    h, worst, err = x, 0.0, 0.0
    for i, (q, b, s) in enumerate(layers):
        # a last layer's relu_tail that covers every output is the relu
        # between layers
        tail = 8 if i == len(layers) - 1 else q.shape[1]
        got = run(x, K.pack_layers(layers[:i + 1]), tail)
        want = K.fused_mlp_forward_int8_plain(h, K.pack_layers([(q, b, s)]),
                                              tail)
        require(bool(torch.isfinite(got).all()), "non-finite output")
        worst = max(worst, outside(got, want, *TOL["fused_mlp_forward"]))
        err = max(err, errors(got, want)[0])
        h = got
    return worst, err


def check_int8(torch, K, name, x, mlp):
    """The int8 kernel on ``x`` through int8_chain, with its control.
    Returns the chain's max abs err, and that of the whole network against
    the plain version, which flips may put outside the tolerance."""
    share, chain_err = int8_chain(torch, K, x, mlp, K.fused_mlp_forward_int8)
    deq = [(q.float() * s).numpy(force=True) for q, _, s in mlp.layers()]
    f32 = list(K.pack_mlp(deq, [b for _, b, _ in mlp.layers()],
                          torch.float32, x.device).layers())

    def float32_activations(h, net, relu_tail):
        return K.fused_mlp_forward_plain(
            h, K.pack_layers(f32[:len(net.widths) - 1]), relu_tail)

    control, _ = int8_chain(torch, K, x, mlp, float32_activations)
    got = K.fused_mlp_forward_int8(x, mlp, 8)
    want = K.fused_mlp_forward_int8_plain(x, mlp, 8)
    print(f"  {name}: B={x.shape[0]} link by link max_abs_err="
          f"{chain_err:.3e}, {share:.4%} outside (control: {control:.4%}); "
          f"whole network {outside(got, want, *TOL['fused_mlp_forward']):.4%}"
          f" outside, max_abs_err={errors(got, want)[0]:.3e}", flush=True)
    require(share == 0, f"{name}: {share:.4%} of the elements outside "
            f"{TOL['fused_mlp_forward']} at a link of the chain")
    require(control > 0, f"{name}: float32 activations pass the chain too")
    return chain_err, errors(got, want)[0]


def flax_tree(spec, hidden, seed):
    """A flax-layout OnlineMLP parameter tree of numpy arrays: lecun-normal
    kernels (unit normal truncated to +/-2, std sqrt(1/fan_in)), small
    random biases."""
    rng = np.random.default_rng(seed)
    widths = (spec.input_len, *hidden, spec.output_len)

    def dense(din, dout):
        z = rng.standard_normal((din, dout))
        bad = np.abs(z) > 2
        while bad.any():
            z[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(z) > 2
        std = np.sqrt(1.0 / din) / 0.87962566103423978
        return {"kernel": (z * std).astype(np.float32),
                "bias": (0.01 * rng.standard_normal(dout)).astype(np.float32)}

    pairs = list(zip(widths[:-1], widths[1:]))
    return {"MLPTrunk_0": {f"Dense_{i}": dense(*p)
                           for i, p in enumerate(pairs[:-1])},
            "out": dense(*pairs[-1])}


def with_nonfinite(x):
    x = x.copy()
    x[0, 3] = np.nan
    if x.shape[0] > 2:
        x[1, 9] = np.inf
        x[2, min(130, x.shape[1] - 1)] = -np.inf
    return x


def kernel_checks(torch, K, T, specs, model, columns):
    """Each kernel against its plain version on the card; ``specs`` maps
    "v2_rh", "v5" and "v1" to (VarSpec, NormStats).  Returns {name:
    {"max_abs_err", "ms": {B: ms}, "plain_ms": {B: ms}}}, and for the
    int8 kernel "whole_network_max_abs_err" (see int8_chain)."""
    dev = torch.device("cuda")
    res = {n: {"max_abs_err": 0.0, "ms": {}, "plain_ms": {}}
           for n in SOURCES}
    res["fused_input_transform"] = {"max_abs_err": 0.0}
    spec, stats = specs["v2_rh"]

    def record(name, b, err):
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err[0])
        print(f"  {name:24s} B={b:5d} max_abs_err={err[0]:.3e} "
              f"max_rel_err={err[1]:.3e}", flush=True)

    # -- kernel 1: the v2_rh serving config, the v5 online config, and the
    # v1 trainer's (the default TransformConfig) up to its batch ---------
    v2_consts = T.input_transform_consts(
        spec, stats, T.TransformConfig(input_clip=True,
                                       input_clip_rhonly=True), dev)
    v5_consts = T.input_transform_consts(*specs["v5"], T.v5_online_config(),
                                         dev)
    v1_consts = T.input_transform_consts(*specs["v1"], T.TransformConfig(),
                                         dev)
    for label, consts, rows in (("v2_rh", v2_consts, KERNEL_ROWS),
                                ("v5", v5_consts, KERNEL_ROWS),
                                ("v1", v1_consts, V1_TRANSFORM_ROWS)):
        for b in rows:
            x = torch.from_numpy(with_nonfinite(columns[label][:b])).to(dev)
            got = K.fused_input_transform(x, consts)
            want = K.fused_input_transform_plain(x, consts)
            require_equal(torch, f"transform {label} B={b}", got, want)
            record("fused_input_transform", b, errors(got, want))
    # an x that starts mid-row (4 bytes past a 16-byte boundary): the
    # kernel's ordinary-load path, and the ragged last tile (6144 rows of
    # 557 floats at 4 rows a tile: none; 6145 - 1 in the plan's tiles)
    full = torch.from_numpy(with_nonfinite(
        columns["v2_rh_6145"])).to(dev)
    x = full[1:]
    require(x.data_ptr() % 16 != 0, "x[1:] is 16-byte aligned")
    got = K.fused_input_transform(x, v2_consts)
    require_equal(torch, "transform v2_rh x[1:] of 6145 rows", got,
                  K.fused_input_transform_plain(x, v2_consts))
    require_equal(torch, "transform v2_rh x[1:] against its copy", got,
                  K.fused_input_transform(x.clone(), v2_consts))
    print("  fused_input_transform    x[1:] of 6145 v2_rh rows (unaligned): "
          "bit-equal to plain and to its contiguous copy", flush=True)
    # the pipelined path (row tiles by bulk copies), which the plan takes
    # past half the L2, forced at the main path's shapes and a ragged 7
    for label, consts, b in (("v2_rh", v2_consts, 7),
                             ("v2_rh", v2_consts, 6144),
                             ("v5", v5_consts, 1024),
                             ("v1", v1_consts, 32768)):
        x = torch.from_numpy(with_nonfinite(columns[label][:b])).to(dev)
        plan = K.plan_input_transform(b, x.shape[1], *K._device_limits(0),
                                      direct=False)
        require_equal(torch, f"transform {label} B={b} pipelined",
                      K._launch_transform(x, consts, plan),
                      K.fused_input_transform_plain(x, consts))
        print(f"  fused_input_transform    {label} B={b} pipelined "
              f"({plan.rows} rows a tile, {plan.stages} stages, {plan.grid} "
              "CTAs): "
              "bit-equal to plain", flush=True)
    res["fused_input_transform"]["bit_equal"] = (
        "plain at every checked shape, direct and pipelined, and x[1:] of "
        "6145 v2_rh rows")
    cases = [(f"v2_rh B={b}", transform_case(torch, K, columns["v2_rh"][:b],
                                             v2_consts), b in TIMED_ROWS)
             for b in IO_TIMED_ROWS]
    cases += [("v1 B=32768", transform_case(torch, K, columns["v1"][:32768],
                                            v1_consts), False),
              ("v5 B=1024", transform_case(torch, K, columns["v5"][:1024],
                                           v5_consts), False)]
    res["fused_input_transform"]["times"] = io_times(
        torch, "fused_input_transform", cases)

    # -- kernels 2 and 3: the full-width MLP on normalized columns --------
    ws, bs = K.mlp_params_to_matrices(model.state_dict())
    packed = {w: K.pack_mlp(ws, bs, dt, dev) for w, dt in (
        ("bf16", torch.bfloat16), ("f32", torch.float32), ("int8", "int8"))}
    xn = K.fused_input_transform_plain(
        torch.from_numpy(columns["v2_rh"]).to(dev), v2_consts)
    for b in MLP_ROWS:
        x = xn[:b].contiguous()
        for w in ("bf16", "f32"):
            got = K.fused_mlp_forward(x, packed[w], 8)
            want = K.fused_mlp_forward_plain(x, packed[w], 8)
            err = check_close(torch, f"fused_mlp_forward[{w}]", got, want,
                              *TOL["fused_mlp_forward"])
            if w == "bf16":
                record("fused_mlp_forward", b, err)
        r = res["fused_mlp_forward_int8"]
        chain_err, whole_err = check_int8(
            torch, K, "fused_mlp_forward_int8", x, packed["int8"])
        r["max_abs_err"] = max(r["max_abs_err"], chain_err)
        r["whole_network_max_abs_err"] = max(
            r.get("whole_network_max_abs_err", 0.0), whole_err)
        # weight-only int8 stays within quantization error of float32
        got = K.fused_mlp_forward_int8(x, packed["int8"], 8)
        f32 = K.fused_mlp_forward_plain(x, packed["f32"], 8)
        q_err = float(((got - f32).abs() / (f32.abs().mean() + 1e-6)).mean())
        require(q_err < 0.02, f"int8 vs f32 mean error {q_err:.4f}")
        r["int8_vs_f32_mean_err"] = max(r.get("int8_vs_f32_mean_err", 0.0),
                                        q_err)
    # a row's bits do not depend on its batch (the server pads a 50-row
    # request to 384): 50 rows alone and inside 384, 7 inside 6144
    for name, kern, p in (("fused_mlp_forward", K.fused_mlp_forward,
                           packed["bf16"]),
                          ("fused_mlp_forward_int8", K.fused_mlp_forward_int8,
                           packed["int8"])):
        for n, b in ((50, 384), (7, 6144)):
            alone = kern(xn[:n].contiguous(), p, 8)
            inside = kern(xn[:b].contiguous(), p, 8)[:n]
            require(torch.equal(alone, inside), f"{name}: {n} rows alone "
                    f"differ from the same rows inside {b}")
        res[name]["batch_invariant"] = "50 in 384, 7 in 6144"
        print(f"  {name}: 50 rows alone bit-equal inside 384, 7 inside 6144",
              flush=True)
    # the planted fault: kernel 2 with the activations' hi part alone (one
    # bf16 pass, the change of numerics the three-part split avoids) must
    # fail the tolerance; two parts are printed for the record
    x = xn[:384].contiguous()
    want = K.fused_mlp_forward_plain(x, packed["bf16"], 8)
    faults = {}
    for passes in (1, 2):
        got = K._launch_wgmma(x, packed["bf16"], 8, passes)
        faults[passes] = (outside(got, want, *TOL["fused_mlp_forward"]),
                          errors(got, want)[0])
    print(f"  fused_mlp_forward B=384 with the hi part alone: "
          f"{faults[1][0]:.4%} outside {TOL['fused_mlp_forward']}, max_abs_err"
          f" {faults[1][1]:.3e}; hi + mid: {faults[2][0]:.4%} outside, "
          f"max_abs_err {faults[2][1]:.3e}", flush=True)
    require(faults[1][0] > 0, "kernel 2 with one bf16 pass passes the "
            "tolerance: the check cannot see the split")
    res["fused_mlp_forward"]["one_pass_fault_outside"] = faults[1][0]
    res["fused_mlp_forward"]["two_pass_outside"] = faults[2][0]
    res["fused_mlp_forward"]["two_pass_max_abs_err"] = faults[2][1]
    # ragged widths: the padded device layout through the same kernel
    rng = np.random.default_rng(1)
    ragged = (spec.input_len, 97, 64, 30, spec.output_len)
    rw = [rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i)
          for i, o in zip(ragged[:-1], ragged[1:])]
    rb = [(0.1 * rng.standard_normal(o)).astype(np.float32)
          for o in ragged[1:]]
    for b in (7, 384):
        x = xn[:b].contiguous()
        for dt in (torch.float32, torch.bfloat16):
            p = K.pack_mlp(rw, rb, dt, dev)
            check_close(torch, f"fused_mlp_forward[ragged {dt}]",
                        K.fused_mlp_forward(x, p, 8),
                        K.fused_mlp_forward_plain(x, p, 8),
                        *TOL["fused_mlp_forward"])
        p = K.pack_mlp(rw, rb, "int8", dev)
        check_int8(torch, K, "fused_mlp_forward_int8[ragged]", x, p)
    print(f"  ragged widths {ragged}: bf16, f32, int8 match", flush=True)
    # hidden widths past 1024: past one wave of clusters 8 CTAs cannot
    # cover such a layer, so the plan keeps clusters of 16 over 128-row
    # tiles, two chunks a CTA
    wide = (spec.input_len, 1536, 1536, 1536, 1536, spec.output_len)
    wide_w = [rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i)
              for i, o in zip(wide[:-1], wide[1:])]
    wide_b = [(0.1 * rng.standard_normal(o)).astype(np.float32)
              for o in wide[1:]]
    wide_plans = {}
    for b in (384, 6144):
        x = xn[:b].contiguous()
        p = K.pack_mlp(wide_w, wide_b, torch.bfloat16, dev)
        check_close(torch, f"fused_mlp_forward[{wide}]",
                    K.fused_mlp_forward(x, p, 8),
                    K.fused_mlp_forward_plain(x, p, 8),
                    *TOL["fused_mlp_forward"])
        plan = K._mlp_plan(b, p, dev)
        wide_plans[b] = (plan.cluster, plan.rows, plan.nb)
        p = K.pack_mlp(wide_w, wide_b, "int8", dev)
        check_int8(torch, K, f"fused_mlp_forward_int8[{wide}]", x, p)
    require(wide_plans[6144] == (16, 128, 2), f"widths {wide} at B=6144 "
            f"planned {wide_plans[6144]}, want cluster 16 x 128 rows")
    print(f"  widths {wide}: bf16, int8 match; plans (cluster, rows, chunks "
          f"a CTA) {wide_plans}", flush=True)
    # the plan's shared memory is the kernel's own layout
    lib = K._build.load()
    for int8 in (False, True):
        for nwg in (1, 2):
            for nb in range(1, K.MLP_MAX_NB + 1):
                for st in range(2, K.MLP_STAGES + 1):
                    got = lib.cst_mlp_forward_smem(int(int8), nwg, nb, st)
                    want = K._mlp_smem(int8, nwg, nb, st)
                    require(got == want, f"_mlp_smem({int8}, {nwg}, {nb}, "
                            f"{st}) = {want}, the kernel takes {got}")
    print("  plan_mlp_forward's shared memory equals the kernel's layout",
          flush=True)
    # device time (CUDA-graph replays, warm L2), in turns plain, kernel,
    # kernel, plain; beside it a cuBLAS bf16 chain of the same five
    # products, a yardstick the port never calls
    from climsim_tpu_torch.bench_gn_conv3 import time_ms as graph_ms

    wb = [w.to(device=dev, dtype=torch.bfloat16) for w in ws]
    bb = [b.to(device=dev, dtype=torch.bfloat16) for b in bs]

    def cublas_chain(x):
        h = x.to(torch.bfloat16)
        for i, (w, b) in enumerate(zip(wb, bb)):
            h = h @ w + b
            if i < len(wb) - 1:
                h = torch.relu(h)
        return h

    for b in TIMED_ROWS:
        x = xn[:b].contiguous()
        for name, kern, plain, p in (
                ("fused_mlp_forward", K.fused_mlp_forward,
                 K.fused_mlp_forward_plain, packed["bf16"]),
                ("fused_mlp_forward_int8", K.fused_mlp_forward_int8,
                 K.fused_mlp_forward_int8_plain, packed["int8"])):
            p1 = graph_ms(torch, lambda: plain(x, p, 8), 20)
            k1 = graph_ms(torch, lambda: kern(x, p, 8), 20)
            k2 = graph_ms(torch, lambda: kern(x, p, 8), 20)
            p2 = graph_ms(torch, lambda: plain(x, p, 8), 20)
            res[name]["ms"][b] = (k1 + k2) / 2
            res[name]["plain_ms"][b] = (p1 + p2) / 2
            res[name].setdefault("cublas_chain_ms", {})[b] = graph_ms(
                torch, lambda: cublas_chain(x), 20)
            plan = K._mlp_plan(b, p, dev)
            res[name].setdefault("plans", {})[b] = {
                "cluster": plan.cluster, "rows": plan.rows, "nb": plan.nb,
                "stages": plan.stages, "grid": plan.grid}
    for name, r in res.items():
        if name == "fused_input_transform":
            continue        # timed by io_times, printed there
        for b in TIMED_ROWS:
            print(f"  {name:24s} B={b:5d} kernel {r['ms'][b]:.4f} ms  "
                  f"plain {r['plain_ms'][b]:.4f} ms"
                  + (f"  cuBLAS bf16 chain {r['cublas_chain_ms'][b]:.4f} ms"
                     f"  plan {r['plans'][b]}" if "plans" in r else ""),
                  flush=True)
    return res


def unet_flax_tree(model, seed):
    """A flax-layout ClimSimUNet tree of numpy arrays at ``model``'s widths:
    every conv kernel (K, Cin, Cout) xavier-uniform at full scale (the
    init scales conv1, the attention proj and out_conv by 1e-5, which would
    hide half of the fused chains), conv biases 0.1 N(0, 1), GroupNorm
    scale 1 + 0.2 N and bias 0.1 N, emb_loc N(0, 1)."""
    rng = np.random.default_rng(seed)
    state = model.state_dict()
    tree = {"emb_loc": rng.standard_normal(
        tuple(state["emb_loc"].shape)).astype(np.float32)}
    for key, v in state.items():
        if key == "emb_loc":
            continue
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        if state[".".join(path + ["weight"])].dim() == 3:    # a conv
            node = node.setdefault("Conv_0", {})
            if leaf == "weight":
                cout, cin, k = v.shape
                lim = np.sqrt(6.0 / ((cin + cout) * k))
                a = rng.uniform(-lim, lim, (k, cin, cout))
            else:
                a = 0.1 * rng.standard_normal(v.shape[0])
            leaf = {"weight": "kernel", "bias": "bias"}[leaf]
        elif leaf == "weight":                                # a GroupNorm
            a, leaf = 1.0 + 0.2 * rng.standard_normal(v.shape[0]), "scale"
        else:
            a = 0.1 * rng.standard_normal(v.shape[0])
        node[leaf] = a.astype(np.float32)
    return tree


def gn_checks(torch, PU, seed):
    """fused_gn_silu_conv3 against its plain version at every chain shape
    of the unet_v5 forward and the GN_RAGGED shapes, B in GN_ROWS, with the
    float32-activation control and the offset-1e3 case; then every chain
    shape timed at GN_TIMED_ROWS beside its bound, kernel against plain in
    turns, each from a replayed CUDA graph (device time, no host time a
    call), and the 82-chain sums."""
    from climsim_tpu_torch.bench_gn_conv3 import (chain_args,
                                                  chain_bound_ms)
    from climsim_tpu_torch.bench_gn_conv3 import time_ms as graph_ms

    g = torch.Generator(device="cuda").manual_seed(seed)
    res = {"max_abs_err": 0.0, "max_err_rel": 0.0, "control_min_rel": 1e9,
           "per_shape_ms": {}, "per_shape_plain_ms": {},
           "per_shape_bound_ms": {}, "plans": {}}

    def reading(label, a, tol=GN_TOL, control=True):
        got = PU.fused_gn_silu_conv3(*a)
        want = PU.xla_gn_silu_conv3_plain(*a)
        require(got.shape == want.shape, f"{label}: shape {got.shape}")
        require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        ctl = float((PU.xla_gn_silu_conv3_plain(
            *a[:3], a[3].float(), a[4]) - want).abs().max())
        print(f"  fused_gn_silu_conv3 {label:30s} max_abs_err={err:.3e} "
              f"({err / scale:.3e} of max|y|); control {ctl / scale:.3e}",
              flush=True)
        require(err <= tol * scale, f"{label}: {err / scale:.3e} of "
                f"max|y| > {tol}")
        if control:
            require(ctl > tol * scale,
                    f"{label}: the float32-activation control passes")
            res["control_min_rel"] = min(res["control_min_rel"], ctl / scale)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["max_err_rel"] = max(res["max_err_rel"], err / scale)
        else:
            res["offset_err_rel"] = err / scale

    for (l, c, cout) in (*UNET_CHAINS, *GN_RAGGED):
        for b in GN_ROWS:
            reading(f"L={l} C={c} Cout={cout} B={b}",
                    chain_args(torch, g, b, l, c, cout))
    reading("L=64 C=128 Cout=128 B=7 +1e3", chain_args(
        torch, g, 7, 64, 128, 128, offset=1e3), GN_OFFSET_TOL, False)
    # a chain whose first tiling overflows shared memory at the trainer's
    # batch (the 256-channel unet_v5's): the plan takes fewer samples a
    # tile, within GN_TOL and bit-equal to another tiling of the samples
    l, c, cout = GN_STEPPED
    a = chain_args(torch, g, UNET_BATCH, l, c, cout)
    reading(f"L={l} C={c} Cout={cout} B={UNET_BATCH} (stepped)", a)
    plan = PU._device_plan(UNET_BATCH, l, c, cout, a[0].device)
    props = torch.cuda.get_device_properties(a[0].device)
    other = PU.plan_gn_silu_conv3(UNET_BATCH, l, c, cout,
                                  props.shared_memory_per_block_optin,
                                  props.multi_processor_count, (1, 1))
    got = PU.fused_gn_silu_conv3(*a)
    out = torch.empty_like(got)
    PU._launch(*a, out, other)
    require(torch.equal(out, got), f"L={l} C={c} Cout={cout}: the stepped "
            f"plan and tiling (1, 1) differ")
    res["stepped"] = {"shape": [UNET_BATCH, l, c, cout],
                      "plan": {"samples": plan.samples, "n_tile": plan.n_tile,
                               "stages": plan.stages},
                      "other": {"samples": other.samples,
                                "n_tile": other.n_tile}}
    print(f"  fused_gn_silu_conv3 L={l} C={c} Cout={cout} B={UNET_BATCH}: "
          f"plan {plan.samples} samples x {plan.n_tile} columns, bit-equal "
          f"to {other.samples} x {other.n_tile}", flush=True)
    for b in GN_TIMED_ROWS:
        ms = plain_ms = bound_ms = 0.0
        for (l, c, cout), calls in UNET_CHAINS.items():
            a = chain_args(torch, g, b, l, c, cout)
            p1 = graph_ms(torch, lambda: PU.xla_gn_silu_conv3_plain(*a), 5)
            k1 = graph_ms(torch, lambda: PU.fused_gn_silu_conv3(*a), 20)
            k2 = graph_ms(torch, lambda: PU.fused_gn_silu_conv3(*a), 20)
            p2 = graph_ms(torch, lambda: PU.xla_gn_silu_conv3_plain(*a), 5)
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            bound = chain_bound_ms(b, l, c, cout)[0]
            plan = PU._device_plan(b, l, c, cout, a[0].device)
            key = f"B{b}_{l}x{c}x{cout}"
            res["per_shape_ms"][key] = k
            res["per_shape_plain_ms"][key] = p
            res["per_shape_bound_ms"][key] = bound
            res["plans"][key] = {"rows": plan.rows, "n_tile": plan.n_tile,
                                 "samples": plan.samples,
                                 "stages": plan.stages, "grid": plan.grid}
            ms, plain_ms = ms + calls * k, plain_ms + calls * p
            bound_ms += calls * bound
            print(f"  fused_gn_silu_conv3 L={l:2d} C={c:3d} Cout={cout} "
                  f"B={b:4d} x{calls:2d}: kernel {k:.4f} ms  plain {p:.4f} "
                  f"ms  bound {bound:.4f} ms ({bound / k:.1%} of it); tile "
                  f"{plan.rows}x{plan.n_tile}, {plan.samples} samples, "
                  f"{plan.stages} stages, {plan.grid} blocks", flush=True)
        sfx = "" if b == 384 else f"_b{b}"
        res["ms" + sfx], res["plain_ms" + sfx] = ms, plain_ms
        res["bound_ms" + sfx] = bound_ms
        print(f"  fused_gn_silu_conv3 per forward (82 chains, B={b}): kernel "
              f"{ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bound_ms:.3f} "
              f"ms ({bound_ms / ms:.1%} of it)", flush=True)
    return res


def head_checks(torch, K, stats5, seed):
    """fused_constraint_head against its plain version at B in KERNEL_ROWS
    (within HEAD_TOL; whether bit-equal is printed), on t, qc and qi as
    strided views of a raw (B, 1525) v4 row (bit-equal to the kernel on
    contiguous copies) at B = 7 and 6144; timed at IO_TIMED_ROWS."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    consts = K.constraint_head_consts(stats5.out_scale, 15, device="cuda")
    res = {"max_abs_err": 0.0, "bit_equal": []}

    def head_args(b):
        """y, and t, qc, qi as views of a raw (b, 1525) row"""
        def u(*shape):
            return torch.rand(*shape, device="cuda", generator=g)
        raw = torch.randn(b, 1525, device="cuda", generator=g)
        raw[:, 0:60] = 250.0 + 40.0 * u(b, 60)
        raw[:, 120:240] = 1e-5 * u(b, 120)
        return (torch.randn(b, 308, device="cuda", generator=g),
                raw[:, 0:60], raw[:, 120:180], raw[:, 180:240], consts,
                1200.0)

    def contiguous(a):
        return (a[0], *(v.contiguous() for v in a[1:4]), *a[4:])

    for b in KERNEL_ROWS:
        a = contiguous(head_args(b))
        got = K.fused_constraint_head(*a)
        want = K.fused_constraint_head_plain(*a)
        err = check_close(torch, "fused_constraint_head", got, want,
                          *HEAD_TOL)
        res["max_abs_err"] = max(res["max_abs_err"], err[0])
        if torch.equal(got, want):
            res["bit_equal"].append(b)
        print(f"  fused_constraint_head    B={b:5d} max_abs_err={err[0]:.3e}"
              f" max_rel_err={err[1]:.3e} bit-equal to plain: "
              f"{torch.equal(got, want)}", flush=True)
    for b in (7, 6144):
        a = head_args(b)
        require(a[1].stride() == (1525, 1), "t is not a view of the row")
        got = K.fused_constraint_head(*a)
        require_equal(torch, f"fused_constraint_head B={b} strided", got,
                      K.fused_constraint_head(*contiguous(a)))
        check_close(torch, "fused_constraint_head strided", got,
                    K.fused_constraint_head_plain(*a), *HEAD_TOL)
        # the pipelined path, which the plan takes past half the L2
        plan = K.plan_constraint_head(b, *K._device_limits(0), direct=False)
        require_equal(torch, f"fused_constraint_head B={b} pipelined",
                      K._launch_head(*a, plan), got)
        print(f"  fused_constraint_head    B={b:5d} t, qc, qi views of a "
              "(B, 1525) row: bit-equal to contiguous copies, and pipelined "
              f"({plan.rows} rows a tile, {plan.grid} CTAs) bit-equal to "
              "direct", flush=True)
    res["times"] = io_times(torch, "fused_constraint_head", [
        (f"B={b}", head_case(torch, K, head_args(b)), b in TIMED_ROWS)
        for b in IO_TIMED_ROWS])
    return res


def require_equal(torch, name, got, want):
    """Require got bit-equal to want (finite, of one shape)."""
    require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
            f"{tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    require(torch.equal(got, want), f"{name}: not bit-equal; max abs err "
            f"{errors(got, want)[0]:.3e}")


def transform_case(torch, K, cols, consts):
    """(kernel call, plain call, (bytes, operations)) of kernel 1 on the
    numpy columns ``cols``: x read and out written once, the seven
    constant rows read once; about six operations an element."""
    x = torch.from_numpy(cols).to("cuda")
    b, d = x.shape
    return (lambda: K.fused_input_transform(x, consts),
            lambda: K.fused_input_transform_plain(x, consts),
            (8 * b * d + 4 * 7 * d, 6 * b * d))


def head_case(torch, K, a):
    """(kernel call, plain call, (bytes, operations)) of kernel 4 on the
    arguments ``a``: y, t, qc, qi read and out written once (3424 B a row),
    the (2, 308) constants once; about four operations an output."""
    b = a[0].shape[0]
    return (lambda: K.fused_constraint_head(*a),
            lambda: K.fused_constraint_head_plain(*a),
            (4 * b * (308 + 3 * 60 + 368) + 4 * 2 * 308, 4 * b * 368))


def io_times(torch, name, cases):
    """label -> {"ms", "plain_ms", "bound_ms", "bound_by"} of kernel 1 or 4
    at each of ``cases`` (label, (kernel, plain, (bytes, operations)),
    host): device time, CUDA-graph replays (the host's time a call left
    out), in turns plain, kernel, kernel, plain; the bound at the same
    shape; where ``host`` is set, also "host_ms", the wrapper's host cost a
    call (back-to-back calls, compare_timed: the card waits on the host)."""
    from climsim_tpu_torch.bench_gn_conv3 import time_ms as graph_ms

    out = {}
    for label, (kern, plain, work), host in cases:
        p1 = graph_ms(torch, plain, 20)
        k1 = graph_ms(torch, kern, 50)
        k2 = graph_ms(torch, kern, 50)
        p2 = graph_ms(torch, plain, 20)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        bound_ms, by = bound(*work, "f32")
        r = out[label] = {"ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": by}
        if host:
            r["host_ms"] = compare_timed(torch, kern, plain, 200)[0]
        print(f"  {name:24s} {label:10s} device {ms * 1e3:8.3f} us  bound "
              f"{bound_ms * 1e3:7.3f} us ({bound_ms / ms:6.1%} of it)  "
              f"plain {plain_ms * 1e3:8.3f} us"
              + (f"  host cost a call {r['host_ms'] * 1e3:7.3f} us"
                 if host else ""), flush=True)
    floor = next(v["ms"] for k, v in out.items() if k.endswith(" B=1")
                 or k == "B=1")
    print(f"  {name}: the launch floor at the served batch (its own time at "
          f"B = 1) {floor * 1e3:.3f} us", flush=True)
    return out


def batch_invariance(torch, F, PU, unet_apply_fused, unet, xn):
    """Print which ops give the first 50 rows the same bits alone as inside
    the 384-row batch (the server pads a 50-row request to 384), and
    require it of kernel 5: 50 rows inside 384, and 7 inside 1024."""
    from climsim_tpu_torch.bench_gn_conv3 import chain_args

    g = torch.Generator(device="cuda").manual_seed(7)

    def same(fn, x, n=50):
        return bool(torch.equal(fn(x[:n]), fn(x)[:n]))

    h = unet.assemble(xn)
    w3 = unet.enc64_conv.weight.detach()
    w1 = torch.randn(256, 512, device="cuda", generator=g)
    q = torch.randn(384, 8, 4, 64, device="cuda", generator=g)
    a = chain_args(torch, g, 384, 64, 128, 128)
    b = chain_args(torch, g, 1024, 8, 512, 256)
    probes = {
        "conv3, F.conv1d (cuDNN)": same(lambda x: F.conv1d(
            x.transpose(1, 2), w3, padding=1), h),
        "1x1 conv, matmul (cuBLAS)": same(
            lambda x: x @ w1.t(), torch.randn(384, 8, 512, device="cuda",
                                              generator=g)),
        "attention scores, einsum (cuBLAS)": same(
            lambda x: torch.einsum("blhd,bmhd->bhlm", x, x), q),
        "fused_gn_silu_conv3 kernel": same(
            lambda x: PU.fused_gn_silu_conv3(x.contiguous(), *a[1:]), a[0]),
        "fused_gn_silu_conv3 kernel, 7 in 1024 (L=8 C=512)": same(
            lambda x: PU.fused_gn_silu_conv3(x.contiguous(), *b[1:]), b[0],
            7),
        "whole engine": same(lambda x: unet_apply_fused(unet, x), xn),
    }
    for name, ok in probes.items():
        print(f"  batch-invariant (50 rows in 384 unless named): {name}: "
              f"{ok}", flush=True)
    for name, ok in probes.items():
        require(ok or "fused_gn_silu_conv3" not in name,
                f"{name}: a sample's output depends on its batch")
    return probes


def profile(torch, K, model, stats, spec, chunk):
    """--profile: the fused MLPs' plan at each batch, then a trace_served
    of 384-column requests a weight type."""
    from climsim_tpu_torch.online.server import (CouplingClient,
                                                 CouplingServer)
    from climsim_tpu_torch.online.wrapper import make_fast_mlp_wrapper

    dev = torch.device("cuda")
    ws, bs = K.mlp_params_to_matrices(model.state_dict())
    weights = (("bf16", torch.bfloat16), ("int8", "int8"))
    print("profile: the fused MLPs' plans", flush=True)
    for w, dt in weights:
        p = K.pack_mlp(ws, bs, dt, dev)
        for b in (1, 50, 384, 1536, 6144):
            plan = K._mlp_plan(b, p, dev)
            print(f"  {w} B={b:5d}: clusters of {plan.cluster} over "
                  f"{plan.rows}-row tiles, {plan.nb} chunks a CTA, "
                  f"{plan.stages} stages, {plan.grid} CTAs, {plan.smem} B of "
                  "shared memory", flush=True)
    for w, dt in weights:
        wrap = make_fast_mlp_wrapper(model, stats, spec, dt, device="cuda")
        srv = CouplingServer(wrap, spec.input_len, base_chunk=384,
                             max_batch=6144, device="cuda").start()
        try:
            trace_served(torch, CouplingClient, srv, chunk, f"served {w}")
        finally:
            srv.stop()


def device_events(prof):
    """(name, ms) of every kernel, copy and fill on the device's own
    timeline.  ``key_averages()`` also carries each host op's device time
    (the kernels it launched), so summing its entries counts a kernel
    launched by a torch op twice; kernels launched through ctypes (1 to
    5) run under no torch op and appear once either way."""
    from torch.autograd import DeviceType

    return [(ev.name, ev.device_time_total / 1e3) for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and not ev.is_user_annotation]


def device_summary(evs, per, unit):
    """Print the ten costliest device ops by name, then every copy and
    every kernel of the port, in ``unit`` (per ``per`` calls)."""
    by_name: dict = {}
    for name, ms in evs:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + ms)
    ours = ("Memcpy", "transform_kernel", "mlp_wgmma_kernel",
            "constraint_head_kernel", "gn_silu_conv3_kernel")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for i, (name, (n, t)) in enumerate(ranked):
        if i < 10 or any(k in name for k in ours):
            print(f"  device {t * 1e3 / per:9.2f} us/{unit} {n:6d} x "
                  f"{name[:80]}")


def trace_served(torch, CouplingClient, srv, chunk, label):
    """torch.profiler trace of N_TRACE sequential requests of ``chunk`` to
    ``srv``: device time per kernel and copy, the card's busy share of the
    traced wall time, and the host ops that take longest."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    cl = CouplingClient("127.0.0.1", srv.port)
    for _ in range(20):
        cl.step(chunk)
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(N_TRACE):
            cl.step(chunk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cl.close()
    evs = device_events(prof)
    busy_ms = sum(ms for _, ms in evs)
    k5_ms = sum(ms for name, ms in evs if "gn_silu_conv3_kernel" in name)
    print(f"profile: {label}, {N_TRACE} requests in {wall_ms:.1f} ms; "
          f"card busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}); kernel 5 "
          f"{k5_ms:.3f} ms ({k5_ms / max(busy_ms, 1e-9):.1%} of the busy "
          f"time); {len(evs) / N_TRACE:.1f} device ops a request",
          flush=True)
    device_summary(evs, N_TRACE, "request")
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"  host   {e.self_cpu_time_total / N_TRACE:9.2f} "
              f"us/request {e.count:6d} x {e.key[:80]}")


def v5_transform(T):
    """The v5 wrapper's input transform (climsim_tpu/online/wrapper.py:84)."""
    return T.TransformConfig(qn_transform=True, qinput_prune=True,
                             strato_lev=15, input_clip=True,
                             input_clip_rhonly=True)


def plain_v5_path(torch, K, T, PW, physics, apply, spec5, stats5):
    """The served v5 path with every kernel's plain version, on the card:
    raw v4 (B, 1525) -> (B, 368), ``apply`` the all-plain model (the
    U-Net engine with fused=False, or the two-stage gate over two)."""
    consts = T.input_transform_consts(spec5, stats5, v5_transform(T), "cuda")
    head = K.constraint_head_consts(stats5.out_scale, 15, device="cuda")

    def run(x):
        xn = K.fused_input_transform_plain(PW.convert_v4_to_v5(x), consts)
        y = apply(xn)
        return K.fused_constraint_head_plain(
            y, x[:, 0:60], x[:, 120:180], x[:, 180:240], head,
            physics.DT_TIMESTEP)

    return run


def drive(CouplingClient, srv, chunks, ragged, n_loop):
    """The main path: concurrent chunks, a ragged request, a latency loop.
    Returns (replies, client round-trip ms list)."""
    replies = [None] * len(chunks)

    def call(i):
        cl = CouplingClient("127.0.0.1", srv.port)
        replies[i] = cl.step(chunks[i])
        cl.close()

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(chunks))]
    for t in threads:
        t.start()
    cl = CouplingClient("127.0.0.1", srv.port)
    replies.append(cl.step(ragged))
    for t in threads:
        t.join(timeout=120)
        require(not t.is_alive(), "a client thread did not finish")
    lat = []
    for i in range(n_loop):
        t0 = time.perf_counter()
        cl.step(chunks[i % len(chunks)])
        lat.append((time.perf_counter() - t0) * 1e3)
    cl.close()
    return replies, lat


N_TWO_STAGE = 200   # sequential requests of the two-stage v5 path
N_V4 = 100          # sequential requests of the v4 path
STRATO_CLS = 12     # levels the unet_v5_classifier preset forces to class 0
CLASS1_ATOL = 1e-8  # tests/test_shardmap_twostage.py:100
BUNDLE_TOL = 1e-5   # * max(1, max|want|), scripts/package_e3sm.py:187-205
# phase (c): the mlp_v2rh preset trained, bundled and served
FIT_ROWS, FIT_VAL_ROWS, FIT_EPOCHS = 32768, 8192, 3


def scale368(torch, stats5):
    """out_scale in the 368 contract's layout (qc and qi take qn's): the
    replies in normalized units."""
    s5 = stats5.out_scale.astype(np.float64)
    return torch.as_tensor(np.concatenate(
        [s5[:120], s5[120:180], s5[120:180], s5[180:]]), dtype=torch.float32)


def serve_run(torch, K, CouplingClient, CouplingServer, wrap, n_features,
              chunks, ragged, n_loop, profile_label=None):
    """Serve ``wrap`` over CouplingServer and drive it (drive); the launch
    counts are set to 0 just before and read just after.  Returns
    (replies, round-trip ms, launches, the server's summary)."""
    srv = CouplingServer(wrap, n_features, base_chunk=384, max_batch=6144,
                         device="cuda").start()
    try:
        K.reset_launches()
        replies, lat = drive(CouplingClient, srv, chunks, ragged, n_loop)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        summary = srv.stats.summary()
        if profile_label:
            trace_served(torch, CouplingClient, srv, chunks[0],
                         profile_label)
    finally:
        srv.stop()
    return replies, lat, launches, summary


def require_per_call(launches, summary, per_call, label):
    """Each kernel of ``per_call`` launched that many times a device call
    of the run, and no other kernel of the U-Net path."""
    for name in ("fused_input_transform", "fused_gn_silu_conv3",
                 "fused_constraint_head"):
        want = per_call.get(name, 0) * summary["batches"]
        require(launches[name] == want,
                f"{label}: {name} launched {launches[name]} times in "
                f"{summary['batches']} device calls, want {want}")


def compare_served(torch, label, xs, replies, direct, plain, scale,
                   exclude=None, exact=0):
    """Each reply: (B, 368), finite, equal to the direct call on the card
    (bit-equal, or within SERVED_TOL * max|y| where a plain op is not
    batch-invariant; the first ``exact`` replies bit-equal), and within
    NET_TOL * max|y| of the all-plain path, in normalized units (times
    ``scale``).  ``exclude(i)``: a (B, 368) mask of request i's entries
    left out of both comparisons (the two-stage path's near-tied
    classes)."""
    n_equal, direct_err, net_err, net_outside = 0, 0.0, 0.0, 0.0
    for i, (x, y) in enumerate(zip(xs, replies)):
        require(y.shape == (x.shape[0], 368), f"{label}: reply shape "
                f"{y.shape}")
        require(bool(np.isfinite(y).all()), f"{label}: non-finite reply")
        with torch.inference_mode():
            xc = torch.from_numpy(x).cuda()
            want = direct(xc).cpu() * scale
            ref = plain(xc).cpu() * scale
        got = torch.from_numpy(y.copy()) * scale
        keep = (torch.ones_like(got, dtype=torch.bool) if exclude is None
                else ~exclude(i))
        if torch.equal(got, want):
            n_equal += 1
        else:
            require(i >= exact, f"{label} reply {i} is not bit-equal to "
                    "the direct call")
            d = float(((got - want).abs() * keep).max() / want.abs().max())
            direct_err = max(direct_err, d)
            require(d <= SERVED_TOL, f"{label} reply {d:.3e} of max|y| "
                    f"from the direct call (> SERVED_TOL {SERVED_TOL})")
        e = float(((got - ref).abs() * keep).max() / ref.abs().max())
        net_err = max(net_err, e)
        require(e <= NET_TOL, f"{label} reply {e:.3e} of max|y| from the "
                f"plain path (> {NET_TOL})")
        net_outside = max(net_outside, outside(got[keep], ref[keep], 2e-4,
                                               1e-4))
    return {"bit_equal_to_direct": n_equal, "replies": len(replies),
            "direct_err_of_max_y": direct_err,
            "plain_err_of_max_y": net_err,
            "plain_outside_2e-4_1e-4": net_outside}


def report_served(card, label, summary, lat, cmp):
    """Print a served path's device-call and round-trip p50 / p99 beside
    the card, and its replies' errors; returns them as a dict."""
    lat = np.asarray(lat)
    out = {"requests": summary["requests"], "device_calls": summary["batches"],
           "device_call_ms_p50": summary["latency_ms_p50"],
           "device_call_ms_p99": summary["latency_ms_p99"],
           "round_trip_ms_p50": float(np.percentile(lat, 50)),
           "round_trip_ms_p99": float(np.percentile(lat, 99)), **cmp}
    print(f"{card}: {label}: {out['requests']} requests, "
          f"{out['device_calls']} device calls, device call p50 "
          f"{out['device_call_ms_p50']:.3f} ms p99 "
          f"{out['device_call_ms_p99']:.3f} ms; 384-column round trip p50 "
          f"{out['round_trip_ms_p50']:.3f} ms p99 "
          f"{out['round_trip_ms_p99']:.3f} ms", flush=True)
    print(f"  replies: {cmp['bit_equal_to_direct']} of {cmp['replies']} "
          f"bit-equal to the direct call (largest gap "
          f"{cmp['direct_err_of_max_y']:.3e} of max|y|); against the "
          f"all-plain path {cmp['plain_err_of_max_y']:.3e} of max|y| "
          f"(tolerance {NET_TOL}), "
          f"{cmp['plain_outside_2e-4_1e-4']:.4%} of the elements outside "
          "rtol 2e-4 / atol 1e-4", flush=True)
    return out


def two_stage_phase(torch, card, unet, stats5, grid, seed, profile):
    """(a) The two-stage U-Net v5 served: the unet_v5 regressor ``unet``
    and a unet_v5_classifier (random flax-layout weights from ``seed``,
    moved across by the porter) gating the qn tendency, through
    make_wrapper on raw v4 columns over CouplingServer.  Returns
    (the classifier, the live wrapper, the results)."""
    from climsim_tpu_torch import get_varspec, physics
    from climsim_tpu_torch.config import PRESETS
    from climsim_tpu_torch.data import transforms as T
    from climsim_tpu_torch.data.synthetic import synthetic_inputs
    from climsim_tpu_torch.models import build_model
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.online.server import (CouplingClient,
                                                 CouplingServer)
    from climsim_tpu_torch.online.two_stage import make_two_stage_apply
    from climsim_tpu_torch.ops import kernels as K
    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
    from climsim_tpu_torch.utils.migrate import port_flax_unet

    spec5, spec4 = get_varspec("v5"), get_varspec("v4")
    kw = PRESETS["unet_v5_classifier"].model_kw
    require(kw["strato_lev_out"] == STRATO_CLS, "the classifier preset")
    cls = build_model("unet_classifier", spec5, **kw)
    cls.load_state_dict(port_flax_unet(unet_flax_tree(cls, seed + 50), cls))
    cls = cls.to("cuda").eval()
    n_cls = sum(p.numel() for p in cls.parameters())
    print(f"U-Net v5 classifier (unet_v5_classifier preset, strato_lev_out="
          f"{STRATO_CLS}): {n_cls} parameters", flush=True)

    def gate(fused):
        return make_two_stage_apply(
            partial(unet_apply_fused, unet, fused=fused),
            partial(unet_apply_fused, cls, fused=fused), stats=stats5,
            device="cuda")

    wrap = PW.make_wrapper(gate(True), stats5,
                           PW.WrapperConfig(input_version="v4"),
                           device="cuda")
    plain = plain_v5_path(torch, K, T, PW, physics, gate(False), spec5,
                          stats5)
    chunks = [synthetic_inputs(spec4, 384, grid, seed=seed + 60 + i)
              for i in range(3)]
    ragged = synthetic_inputs(spec4, 50, grid, seed=seed + 70)
    replies, lat, launches, summary = serve_run(
        torch, K, CouplingClient, CouplingServer, wrap, spec4.input_len,
        chunks, ragged, N_TWO_STAGE,
        "served two-stage U-Net v5" if profile else None)
    print(f"launches in the served two-stage run: {launches}", flush=True)
    per_call = {"fused_input_transform": 1, "fused_gn_silu_conv3": 164,
                "fused_constraint_head": 1}
    require_per_call(launches, summary, per_call, "the two-stage path")

    # The classes, fused engine against plain, on every request's columns.
    # bf16 sums may flip an argmax where the plain logits' top two lie
    # within the U-Net path's tolerance of each other (NET_TOL of the
    # largest unforced logit): such a flip is allowed and counted.  A
    # flip can happen only where the top two lie within twice the largest
    # gap between the two engines' logits; there the level's qc and qi
    # tendencies are left out of the reply comparisons (its class may
    # differ between the served and the direct call too).
    consts = T.input_transform_consts(spec5, stats5, v5_transform(T), "cuda")
    sl = spec5.input_slices["state_qn"]
    div, sub = (torch.as_tensor(a[sl], dtype=torch.float32, device="cuda")
                for a in (stats5.inp_div, stats5.inp_sub))
    lbd = torch.clamp(torch.as_tensor(stats5.lbd_qn, dtype=torch.float32,
                                      device="cuda"), min=1e-12)
    xs = chunks + [ragged]
    ties, flips, n_ties, n_open, logit_err = [], 0, 0, 0, 0.0
    n1, rec_max, raw_max, raw_ok = 0, 0.0, 0.0, 0
    for x, y in zip(xs, replies):
        with torch.inference_mode():
            xc = torch.from_numpy(x).cuda()
            xn = K.fused_input_transform_plain(PW.convert_v4_to_v5(xc),
                                               consts)
            lf, lp = (unet_apply_fused(cls, xn, fused=f)
                      for f in (True, False))
        top = lp[:, STRATO_CLS:].abs().max()
        gap = (lf - lp).abs().max()
        logit_err = max(logit_err, float(gap / top))
        two = lp.topk(2, dim=-1).values
        margin = two[..., 0] - two[..., 1]                     # (B, 60)
        tie, can_flip = margin < NET_TOL * top, margin <= 2 * gap
        kf, kp = lf.argmax(-1), lp.argmax(-1)
        flip = kf != kp
        require(not bool((flip & ~(tie & can_flip)).any()),
                "the fused classifier's class differs from plain's beyond "
                "a near tie")
        require(bool((kf[:, :STRATO_CLS] == 0).all()
                     and (kp[:, :STRATO_CLS] == 0).all()),
                f"the top {STRATO_CLS} levels must be class 0")
        flips, n_ties = flips + int(flip.sum()), n_ties + int(tie.sum())
        n_open += int(can_flip.sum())
        ties.append(can_flip.cpu())
        # class 1: the reply's qn tendency (dqc + dqi) is the exact
        # evaporation of the qn the gate recovers from its input (the
        # gate's float32 formula, climsim_tpu/online/two_stage.py:67-70);
        # against the raw qn it is reported (below the head's zeroed
        # top 15 levels)
        one = (kp == 1) & ~can_flip
        one[:, :15] = False
        yq = torch.from_numpy(y[:, 120:180] + y[:, 180:240]).cuda()
        with torch.inference_mode():
            xq = xn[:, sl] * div + sub
            rec = -torch.log(torch.clamp(1.0 - xq, 1e-12, 1.0)) / lbd
        raw = xc[:, 120:180] + xc[:, 180:240]
        r_rec = (rec + yq * 1200.0).abs()[one]
        r_raw = (raw + yq * 1200.0).abs()[one]
        n1 += int(one.sum())
        if one.any():
            rec_max = max(rec_max, float(r_rec.max()))
            raw_max = max(raw_max, float(r_raw.max()))
            raw_ok += int((r_raw <= CLASS1_ATOL).sum())
    require(n1 > 0, "no class-1 level to check")
    require(rec_max <= CLASS1_ATOL, f"class 1: recovered qn + dqn * 1200 "
            f"= {rec_max:.3e} (> {CLASS1_ATOL})")

    def exclude(i):
        m = torch.zeros(xs[i].shape[0], 368, dtype=torch.bool)
        m[:, 120:180] = ties[i]
        m[:, 180:240] = ties[i]
        return m

    # the full 384-column chunks bit-equal to the direct call (kernel 5
    # gives a sample the same bits in any batch), the padded 50 rows not
    cmp = compare_served(torch, "served two-stage", xs, replies, wrap,
                         plain, scale368(torch, stats5), exclude,
                         exact=len(chunks))
    res = report_served(card, "served two-stage U-Net v5", summary, lat,
                        cmp)
    res.update(classifier_parameters=n_cls, launches_a_call=per_call,
               class_flips=flips, near_ties=n_ties, left_out=n_open,
               levels=sum(t.numel() for t in ties),
               logit_err_of_max=logit_err, class1_levels=n1,
               class1_recovered_residual_max=rec_max,
               class1_raw_within_atol=raw_ok,
               class1_raw_residual_max=raw_max, launches=launches)
    print(f"  classes: {flips} fused/plain disagreements, all at near ties "
          f"({n_ties} of {res['levels']} levels within {NET_TOL} of the "
          f"largest logit; fused logits {logit_err:.3e} of it from plain; "
          f"the {n_open} levels within twice that gap left out of the "
          "reply checks); "
          f"top {STRATO_CLS} levels class 0; class 1 at {n1} levels: "
          f"recovered qn + dqn * 1200 <= {rec_max:.3e} (tolerance "
          f"{CLASS1_ATOL}); against the raw qn {raw_ok} of {n1} within "
          f"{CLASS1_ATOL}, largest {raw_max:.3e} (float32 cannot invert "
          "1 - exp(-lbd qn) where it rounds to 1)", flush=True)
    return cls, wrap, res


def v4_phase(torch, card, grid, seed, profile):
    """(b) The unet_v4 U-Net served through make_v4_wrapper on raw v4
    columns (kernel 1 with the qc/qi rates, then the fused engine), held
    to the all-plain path."""
    from climsim_tpu_torch import get_varspec, load_asset_norms
    from climsim_tpu_torch.config import PRESETS
    from climsim_tpu_torch.data import transforms as T
    from climsim_tpu_torch.data.synthetic import synthetic_inputs
    from climsim_tpu_torch.models import build_model
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.online.server import (CouplingClient,
                                                 CouplingServer)
    from climsim_tpu_torch.ops import kernels as K
    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
    from climsim_tpu_torch.utils.migrate import port_flax_unet

    spec4, stats4 = get_varspec("v4"), load_asset_norms("v4")
    unet4 = build_model("unet", spec4, **PRESETS["unet_v4"].model_kw)
    unet4.load_state_dict(port_flax_unet(unet_flax_tree(unet4, seed + 80),
                                         unet4))
    unet4 = unet4.to("cuda").eval()
    n4 = sum(p.numel() for p in unet4.parameters())
    print(f"U-Net v4 (unet_v4 preset): {n4} parameters", flush=True)
    wrap = PW.make_v4_wrapper(partial(unet_apply_fused, unet4), stats4,
                              spec4, device="cuda")
    # make_v4_wrapper's default switches are the v5 wrapper's; on the v4
    # columns they apply the qc and qi rates
    consts = T.input_transform_consts(spec4, stats4, v5_transform(T),
                                      "cuda")
    require(int(consts[6].sum()) == 120, "kernel 1 takes the qc/qi rates")
    zero = PW._out_zero_mask(spec4, PW.V4_OUT_ZERO, "cuda")
    inv = PW._out_scale_inv(stats4, "cuda")

    def plain(x):
        xn = K.fused_input_transform_plain(x, consts)
        return unet_apply_fused(unet4, xn, fused=False) * zero * inv

    chunks = [synthetic_inputs(spec4, 384, grid, seed=seed + 81 + i)
              for i in range(3)]
    ragged = synthetic_inputs(spec4, 50, grid, seed=seed + 85)
    replies, lat, launches, summary = serve_run(
        torch, K, CouplingClient, CouplingServer, wrap, spec4.input_len,
        chunks, ragged, N_V4, "served U-Net v4" if profile else None)
    print(f"launches in the served v4 run: {launches}", flush=True)
    per_call = {"fused_input_transform": 1, "fused_gn_silu_conv3": 82}
    require_per_call(launches, summary, per_call, "the v4 path")
    cmp = compare_served(torch, "served v4", chunks + [ragged], replies,
                         wrap, plain, torch.as_tensor(
                             stats4.out_scale, dtype=torch.float32))
    res = report_served(card, "served U-Net v4", summary, lat, cmp)
    res.update(parameters=n4, launches_a_call=per_call, launches=launches)
    return res


def bundle_phase(torch, card, kind, unet, cls, wrap2, grid, seed, tmp):
    """(c) Train -> bundle -> serve: fit the full-width mlp_v2rh preset on
    synthetic columns with a top-K checkpointer, bundle its best epoch and
    the two-stage unet_v5 (the regressor and classifier of phase (a),
    saved by save_state) with package_e3sm.build_bundle(verify=True), and
    serve both through serve's --bundle path.  ``wrap2``: phase (a)'s live
    two-stage wrapper, which the unet_v5 bundle's program must equal.
    Returns (results, {preset: (its program at 384, loaded, and the live
    wrapper it was exported from)}) for phase 6e."""
    import os

    from climsim_tpu_torch import get_varspec, serve
    from climsim_tpu_torch.config import PRESETS
    from climsim_tpu_torch.data.pipeline import DeviceResidentLoader
    from climsim_tpu_torch.data.synthetic import synthetic_inputs, \
        synthetic_split
    from climsim_tpu_torch.norms import compute_norms_from_data
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.online.server import CouplingClient
    from climsim_tpu_torch.ops import kernels as K
    from climsim_tpu_torch.package_e3sm import build_bundle
    from climsim_tpu_torch.train import loop as L
    from climsim_tpu_torch.train.checkpoints import (TopKCheckpointer,
                                                     save_state)
    from climsim_tpu_torch.train.recipes import online_mlp_trainer
    from climsim_tpu_torch.utils.migrate import port_flax_online_mlp

    spec = get_varspec("v2_rh")
    cfg = PRESETS["mlp_v2rh"]
    hidden, bs = tuple(cfg.model_kw["hidden"]), cfg.data.batch_size
    x, y = synthetic_split(spec, FIT_ROWS + FIT_VAL_ROWS, grid=grid,
                           seed=seed + 90)
    xt, yt, xv, yv = (x[:FIT_ROWS], y[:FIT_ROWS], x[FIT_ROWS:],
                      y[FIT_ROWS:])
    # norms computed from the training split (the config's norms=
    # "compute"): the packaged v2_rh norms scale the synthetic upper-level
    # water tendencies, which the data they were made from does not have,
    # by up to 1e12, and that noise would be the whole loss.  The bundle
    # takes these norms by --norms, as a deployment takes the norms its
    # checkpoint was trained with.
    stats = compute_norms_from_data(spec, xt, yt)
    norms_path = os.path.join(tmp, "norms_fit.npz")
    stats.save_npz(norms_path)
    steps = FIT_ROWS // bs
    tree = flax_tree(spec, hidden, seed + 91)

    def trainer(device):
        tr = online_mlp_trainer(spec, stats, (xt, yt), seed, hidden=hidden,
                                steps_per_epoch=steps, cfg=cfg.transform,
                                device=device)
        tr.model.load_state_dict(port_flax_online_mlp(tree))
        return tr

    gpu, cpu = trainer("cuda"), trainer("cpu")
    val = DeviceResidentLoader(xv, yv, bs, shuffle=False, device="cuda")
    first = L.evaluate(gpu.eval_step, gpu.model, val)
    want = L.evaluate(cpu.eval_step, cpu.model, DeviceResidentLoader(
        xv, yv, bs, shuffle=False, device="cpu"))
    gap = abs(first - want) / abs(want)
    print(f"fit mlp_v2rh ({spec.input_len} -> {'x'.join(map(str, hidden))} "
          f"-> {spec.output_len}, B={bs}, {FIT_ROWS} + {FIT_VAL_ROWS} rows): "
          f"initial validation loss card {first:.8f}, CPU {want:.8f}, gap "
          f"{gap:.3e} (tolerance {FIRST_LOSS_TOL})", flush=True)
    require(gap <= FIRST_LOSS_TOL, "the initial validation loss on the "
            "card is not the CPU's")
    topk_dir = os.path.join(tmp, "topk")
    K.reset_launches()
    t0 = time.perf_counter()
    _, hist = L.fit(gpu.train_step, gpu.eval_step, gpu.state,
                    DeviceResidentLoader(xt, yt, bs, seed=seed,
                                         device="cuda"),
                    val, FIT_EPOCHS, ckpt=TopKCheckpointer(topk_dir, k=2),
                    plateau=L.PlateauController(patience=1),
                    early=L.EarlyStopping(patience=2))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(K.LAUNCHES)
    vals = [r["val_loss"] for r in hist.rows]
    require(len(vals) == FIT_EPOCHS and bool(np.isfinite(vals).all()),
            f"validation losses {vals}")
    require(vals[-1] < vals[0], f"the validation loss did not fall: {vals}")
    best = TopKCheckpointer(topk_dir, k=2).best()
    require(best[1] == steps * (1 + int(np.argmin(vals))),
            f"top-K best {best} is not the best epoch of {vals}")
    require(fit_launches["fused_input_transform"] > 0,
            "fit did not launch the input transform")
    print(f"  fit: {FIT_EPOCHS} epochs in {fit_s:.2f} s, validation losses "
          f"{vals}; top-K best: step {best[1]} ({best[0]:.8f})", flush=True)

    out = {"fit": {"initial_val_loss": first, "initial_val_loss_cpu": want,
                   "gap": gap, "val_losses": vals, "best": list(best),
                   "seconds": fit_s, "launches": fit_launches}}
    ckpts = {}
    for name, m in (("unet_v5", unet), ("unet_v5_classifier", cls)):
        ckpts[name] = os.path.join(tmp, f"{name}.pt")
        save_state(ckpts[name], m)
    bundles = {
        "mlp_v2rh": (os.path.join(tmp, "mlp_v2rh"), dict(
            ckpt=topk_dir, buckets=[384, 1536], norms=norms_path)),
        "unet_v5": (os.path.join(tmp, "unet_v5"), dict(
            ckpt=ckpts["unet_v5"], buckets=[384],
            cls_ckpt=ckpts["unet_v5_classifier"]))}
    best_mlp = TopKCheckpointer(topk_dir, k=2).load_best(
        trainer("cpu").model)
    live = {"mlp_v2rh": PW.make_v2rh_wrapper(
        best_mlp.to("cuda").eval(), stats, spec, tcfg=cfg.transform,
        device="cuda"), "unet_v5": wrap2}
    programs = {}
    per_call = {"mlp_v2rh": {"fused_input_transform": 1},
                "unet_v5": {"fused_input_transform": 1,
                            "fused_gn_silu_conv3": 164,
                            "fused_constraint_head": 1}}
    for preset, (d, kw) in bundles.items():
        meta = build_bundle(preset, kw.pop("ckpt"), d, verify=True,
                            seed=seed, device="cuda", **kw)
        require(meta["platform"] == "cuda" and meta["device_name"] == kind,
                f"bundle platform {meta['platform']} {meta['device_name']}")
        require(meta["norms"]["source"].get("path") == kw.get("norms"),
                f"bundle norms {meta['norms']['source']}")
        for a in meta["artifacts"].values():
            print(f"  bundle {preset}: b={a['batch']} exported in "
                  f"{a['export_s']:.2f} s, {a['bytes']} bytes, program "
                  f"{a['verify_max_abs_diff']:.3e} from the live wrapper",
                  flush=True)
        try:
            serve.make_server(serve.parse_args(
                ["--bundle", d, "--batch", "768", "--port", "0",
                 "--device", "cuda"]))
            raise RuntimeError(f"{preset}: a bucket of 768 was served")
        except ValueError as e:
            refused = str(e)
        print(f"  --batch 768 refused: {refused}", flush=True)
        srv, _ = serve.make_server(serve.parse_args(
            ["--bundle", d, "--batch", "384", "--port", "0",
             "--device", "cuda"]))
        in_spec = get_varspec(meta["input_version"])
        xs = [synthetic_inputs(in_spec, 384, grid, seed=seed + 100 + i)
              for i in range(3)]
        srv.start()
        try:
            K.reset_launches()
            cl = CouplingClient("127.0.0.1", srv.port)
            replies = [cl.step(x) for x in xs]
            cl.close()
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            summary = srv.stats.summary()
        finally:
            srv.stop()
        require_per_call(launches, summary, per_call[preset],
                         f"the {preset} bundle's program")
        err, n_equal = 0.0, 0
        for x, got in zip(xs, replies):
            with torch.inference_mode():
                want = live[preset](torch.from_numpy(x).cuda()).cpu()
            got = torch.from_numpy(got.copy())
            e = float((got - want).abs().max())
            require(e <= BUNDLE_TOL * max(1.0, float(want.abs().max())),
                    f"{preset} bundle reply {e:.3e} from the live wrapper")
            err, n_equal = max(err, e), n_equal + bool(torch.equal(got, want))
        print(f"  served --bundle {preset} b=384: {len(replies)} replies, "
              f"{n_equal} bit-equal to the live wrapper, largest gap "
              f"{err:.3e} (tolerance {BUNDLE_TOL} * max(1, max|y|)); "
              f"launches {launches}", flush=True)
        out[preset] = {"artifacts": meta["artifacts"], "refused": refused,
                       "served_max_abs_diff": err, "bit_equal": n_equal,
                       "launches": launches,
                       "launches_a_call": per_call[preset]}
        programs[preset] = (PW.load_aot(serve.resolve_bundle(d, 384)[0]),
                            live[preset])
    return out, programs


# --------------------------------------------------------------------------
# phase 6e: bench_server's legs on the served paths
# --------------------------------------------------------------------------
def server_phase(torch, card, grid, seed, paths):
    """bench_server.measure on each served path at B = 384: the direct
    call, the served round trip with 1 and 8 clients (bench_server's
    CLIENTS, REQUESTS requests a client); and, for the paths whose
    program the bundle phase built (``program`` not None), the loaded
    program's call beside the live wrapper it was exported from.
    ``paths``: name -> (wrapper, input spec, program, live wrapper)."""
    from climsim_tpu_torch import bench_server as BS
    from climsim_tpu_torch.data.synthetic import synthetic_inputs

    out = {}
    for name, (wrap, spec_in, program, live) in paths.items():
        t0 = time.perf_counter()
        chunks = [synthetic_inputs(spec_in, 384, grid, seed=seed + 300 + i)
                  for i in range(max(BS.CLIENTS))]
        res = BS.measure(wrap, spec_in.input_len, chunks, program, live,
                         BS.CLIENTS, BS.REQUESTS[name], device="cuda")
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
        p = res["direct_ms"]
        line = (f"bench_server {name} ({card}): direct p50 {p['p50']:.3f} "
                f"p90 {p['p90']:.3f} p99 {p['p99']:.3f} ms")
        if program is not None:
            q, r = res["program_ms"], res["program_live_ms"]
            line += (f"; program p50 {q['p50']:.3f} p90 {q['p90']:.3f} "
                     f"p99 {q['p99']:.3f} ms against its live wrapper's "
                     f"p50 {r['p50']:.3f} p90 {r['p90']:.3f} p99 "
                     f"{r['p99']:.3f} ms")
        print(line, flush=True)
        for c, v in res["served"].items():
            rt, dc = v["round_trip_ms"], v["device_call_ms"]
            require(v["requests"] == int(c) * BS.REQUESTS[name]
                    and v["device_calls"] >= 1, f"{name}: {v}")
            print(f"  {c} client(s): round trip p50 {rt['p50']:.3f} p90 "
                  f"{rt['p90']:.3f} p99 {rt['p99']:.3f} ms; "
                  f"{v['columns_per_s']:.1f} columns/s; "
                  f"{v['device_calls']} device calls of "
                  f"{v['rows_per_call']:.1f} rows, pad "
                  f"{v['pad_fraction']:.4f}; device call p50 "
                  f"{dc['p50']:.3f} p99 {dc['p99']:.3f} ms", flush=True)
        print(f"  ({res['seconds']:.1f} s)", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 9a: training from a split past the card's memory
# --------------------------------------------------------------------------
def stream_copy_check(torch, label, loader, want, batches, gather_s):
    """One untimed epoch of ``loader`` with the card made slower than the
    producer, whose ``gather_s`` is the host gather of one batch: the
    copy stream waits STREAM_COPY_SLOWER gathers before each staging's
    copies, so a pinned slot comes round again while its copy is pending,
    and the consumer waits STREAM_SLOWER gathers on the card before it
    reads each batch and never waits on the host, so a batch's memory is
    handed out again while its read is pending.  Every batch must be
    bit-equal to ``want(s)``, its rows gathered on the card from a copy
    of the split there: a slot refilled before its copy ended, or a batch
    freed under the consumer's stream (no ``record_stream``), gives wrong
    rows."""
    ring = loader._ring
    stage = ring.stage
    copy_cycles = int(STREAM_COPY_SLOWER * gather_s * SLEEP_HZ)

    def slow_stage(shapes, dtypes, fill):
        with torch.cuda.stream(ring.stream):
            torch.cuda._sleep(copy_cycles)
        return stage(shapes, dtypes, fill)

    ring.stage = slow_stage
    cycles = int(STREAM_SLOWER * gather_s * SLEEP_HZ)
    bad, n = [], 0
    t0 = time.perf_counter()
    try:
        for s, (xb, yb) in enumerate(loader):
            torch.cuda._sleep(cycles)
            wx, wy = want(s)
            bad.append((xb.reshape(wx.shape) != wx).sum()
                       + (yb.reshape(wy.shape) != wy).sum())
            n += 1
    finally:
        del ring.stage
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    wrong = int(torch.stack(bad).sum())
    print(f"  copy check {label}: {n} batches, {wrong} elements off their "
          f"rows; host loop {host_s:.2f} s, card done at {card_s:.2f} s "
          f"(copies wait {STREAM_COPY_SLOWER * gather_s * 1e3:.1f} ms, the "
          f"consumer {STREAM_SLOWER * gather_s * 1e3:.1f} ms a batch; "
          f"{ring._next} stagings through {len(ring._bufs)} pinned slots)",
          flush=True)
    require(n == batches, f"{label}: {n} batches of {batches}")
    require(wrong == 0, f"{label}: {wrong} elements differ from the rows "
            "their indices name")
    return {"batches": n, "host_s": host_s, "card_s": card_s,
            "copy_delay_ms": STREAM_COPY_SLOWER * gather_s * 1e3,
            "delay_ms": STREAM_SLOWER * gather_s * 1e3}


class FillClock:
    """Forwards to ``loader``; each pass appends to ``spans`` the seconds
    from the arrival of its first batch to the end of the card's work on
    its last: the epoch less its pipeline fill (the first batch's gather
    and copy), which every pass of a loader pays and an epoch of the
    high-res set would pay once in some 21,700 superbatches."""

    def __init__(self, torch, loader):
        self.torch, self.loader, self.spans = torch, loader, []

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        t0 = None
        for item in self.loader:
            if t0 is None:
                t0 = time.perf_counter()
            yield item
        self.torch.cuda.synchronize()
        self.spans.append(time.perf_counter() - t0)


def stream_copy_checks(torch, paths, seed):
    """The copy checks of ChunkedLoader, BatchLoader and NativeLoader over
    the .npy pair at ``paths`` (stream_copy_check), and a BatchLoader
    whose last batch is short: two epochs of it, every batch its rows,
    and no pinned slot allocated anew in the second."""
    from climsim_tpu_torch.data import native as PN
    from climsim_tpu_torch.data.pipeline import (BatchLoader, ChunkedLoader,
                                                 take_rows)

    b, k = STREAM_BATCH, STREAM_K
    x = np.load(paths[0], mmap_mode="r")
    y = np.load(paths[1], mmap_mode="r")
    rows = x.shape[0]
    xd = torch.as_tensor(np.load(paths[0], mmap_mode="c")).cuda()
    yd = torch.as_tensor(np.load(paths[1], mmap_mode="c")).cuda()
    perm = torch.as_tensor(
        np.random.default_rng(seed).permutation(rows)).cuda()
    probe = np.random.default_rng(1).permutation(rows)[:k * b]
    buf_x = np.empty((k * b, x.shape[1]), np.float32)
    buf_y = np.empty((k * b, y.shape[1]), np.float32)
    for _ in range(2):   # the second: the first maps the split's pages in
        g0 = time.perf_counter()
        take_rows(x, probe, buf_x)
        take_rows(y, probe, buf_y)
        gather_s = time.perf_counter() - g0   # the producer's, a superbatch
    del buf_x, buf_y

    def rows_of(r):
        return lambda s: (xd[perm[s * r:(s + 1) * r]],
                          yd[perm[s * r:(s + 1) * r]])

    checks = {
        "chunked": stream_copy_check(
            torch, "ChunkedLoader", ChunkedLoader(x, y, b, k, seed=seed,
                                                  prefetch=2),
            rows_of(k * b), rows // (k * b), gather_s),
        "batch": stream_copy_check(
            torch, "BatchLoader", BatchLoader(x, y, b, seed=seed),
            rows_of(b), rows // b, gather_s / k)}
    ref = PN.NativeLoader(*paths, b, seed=seed, device="cpu")
    ref_x, ref_y = (torch.cat(t).cuda() for t in zip(*ref))
    ref.close()
    native = PN.NativeLoader(*paths, b, seed=seed)
    checks["native"] = stream_copy_check(
        torch, "NativeLoader", native,
        lambda s: (ref_x[s * b:(s + 1) * b], ref_y[s * b:(s + 1) * b]),
        rows // b, gather_s / k)
    native.close()
    del ref_x, ref_y

    # the short last batch fills the leading rows of a full-size slot: 5
    # stagings an epoch through 4 slots, so the short one and a full one
    # take turns in a slot, and no slot is allocated anew in epoch 2
    n = STREAM_REMAINDER_ROWS
    loader = BatchLoader(x[:n], y[:n], b, seed=seed, drop_remainder=False)
    rng = np.random.default_rng(seed)
    sizes, slots = [], None
    for _ in range(2):
        order = torch.as_tensor(rng.permutation(n)).cuda()
        for s, (xb, yb) in enumerate(loader):
            idx = order[s * b:(s + 1) * b]
            require(torch.equal(xb, xd[idx]) and torch.equal(yb, yd[idx]),
                    f"BatchLoader over {n} rows: batch {s} is not its rows")
            sizes.append(xb.shape[0])
        now = list(loader._ring._bufs)
        require(slots is None or all(a is c for a, c in zip(now, slots)),
                f"BatchLoader over {n} rows: a pinned slot was allocated "
                "anew in epoch 2")
        slots = now
    want = ([b] * (n // b) + [n % b]) * 2
    require(sizes == want, f"BatchLoader over {n} rows: batches of {sizes}")
    print(f"  remainder: BatchLoader over {n} rows, batches of "
          f"{sizes[:len(sizes) // 2]} in each of 2 epochs, every batch its "
          f"rows, {len(slots)} pinned slots allocated once", flush=True)
    checks["remainder"] = {"rows": n, "batches": sizes}
    del xd, yd, perm
    return checks


def streaming_phase(torch, K, card, seed):
    """The v1 MLP trained from a memory-mapped split of STREAM_ROWS rows
    through the streaming loaders: the copy checks, fit over each loader
    (the chunk runner bit-equal to the per-step loop, the first loss the
    CPU's, kernel 1 once a step), the rates beside DeviceResidentLoader's,
    bench_chunked's legs and the card's busy share over an epoch."""
    from climsim_tpu_torch import bench_chunked as BC
    from climsim_tpu_torch import get_varspec, load_asset_norms
    from climsim_tpu_torch.data import native as PN
    from climsim_tpu_torch.data.pipeline import (BatchLoader, ChunkedLoader,
                                                 DeviceResidentLoader)
    from climsim_tpu_torch.train import loop as L
    from climsim_tpu_torch.train import recipes

    b, k = STREAM_BATCH, STREAM_K
    out, times = {}, {}
    t0 = time.perf_counter()
    PN.load()
    times["native_build"] = time.perf_counter() - t0
    print(f"native loader build+load: {times['native_build']:.1f} s "
          f"({PN.library_path().parent.name})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = BC.write_split(tmp, STREAM_ROWS, seed + 200)
        times["split"] = time.perf_counter() - t0
        x = np.load(paths[0], mmap_mode="r")
        y = np.load(paths[1], mmap_mode="r")
        gb = (x.nbytes + y.nbytes) / 1e9
        print(f"streaming split: {x.shape[0]} rows of {x.shape[1]} + "
              f"{y.shape[1]} float32 ({gb:.2f} GB) written in "
              f"{times['split']:.1f} s, memory-mapped", flush=True)

        # -- the copy checks ------------------------------------------------
        t0 = time.perf_counter()
        checks = stream_copy_checks(torch, paths, seed)
        times["copy_checks"] = time.perf_counter() - t0
        out["copy_checks"] = checks

        # -- training through each loader ------------------------------------
        t0 = time.perf_counter()
        spec, stats = get_varspec("v1"), load_asset_norms("v1")

        def trainer(device):
            return recipes.mlp_trainer(spec, stats, None, seed,
                                       hidden=BC.HIDDEN,
                                       steps_per_epoch=1000, device=device)

        first_rows = np.random.default_rng(seed).permutation(
            STREAM_ROWS)[:b]
        xb, yb = (torch.from_numpy(np.array(a[first_rows])) for a in (x, y))
        tr = trainer("cuda")
        first = float(tr.eval_step(tr.model, xb.cuda(), yb.cuda())["loss"])
        cpu = trainer("cpu")
        want = float(cpu.eval_step(cpu.model, xb, yb)["loss"])
        del cpu
        gap = abs(first - want) / abs(want)
        print(f"  first loss of the streamed v1 MLP: card {first:.8f}, CPU "
              f"{want:.8f}, gap {gap:.3e} (tolerance {FIRST_LOSS_TOL})",
              flush=True)
        require(gap <= FIRST_LOSS_TOL, "the streamed trainer's first loss "
                "on the card is not the CPU's")
        out["first_loss"] = {"card": first, "cpu": want, "gap": gap}

        loaders = {
            "chunked": lambda: ChunkedLoader(x, y, b, k, seed=seed),
            "batch": lambda: BatchLoader(x, y, b, seed=seed),
            "native": lambda: PN.NativeLoader(*paths, b, seed=seed),
            "resident": lambda: DeviceResidentLoader(
                x, y, b, seed=seed, block_shuffle=128)}
        fits, launches = {}, dict.fromkeys(K.LAUNCHES, 0)
        for name, make in loaders.items():
            tr = tr if name == "chunked" else trainer("cuda")
            loader = make()
            kind = type(loader).__name__
            if name != "resident":
                loader = FillClock(torch, loader)
            K.reset_launches()
            state, hist = L.fit(tr.train_step, tr.eval_step, tr.state,
                                loader, None, STREAM_EPOCHS, verbose=False)
            torch.cuda.synchronize()
            tr.state = state
            got = dict(K.LAUNCHES)
            steps = STREAM_EPOCHS * loader.steps_per_epoch
            losses = [r["train_loss"] for r in hist.rows]
            require(all(np.isfinite(losses)), f"{name}: losses {losses}")
            require(got["fused_input_transform"] == steps,
                    f"{name}: kernel 1 launched {got['fused_input_transform']}"
                    f" times in {steps} steps")
            if name != "resident":
                launches = {n: launches[n] + got[n] for n in launches}
            fits[name] = {"samples_per_s": hist.rows[-1]["samples_per_sec"],
                          "epoch_samples_per_s": [r["samples_per_sec"]
                                                  for r in hist.rows],
                          "losses": losses, "steps": steps,
                          "kernel1_launches": got["fused_input_transform"]}
            steady = ""
            if name != "resident":
                rows = loader.steps_per_epoch * b
                fits[name]["steady_samples_per_s"] = rows / loader.spans[-1]
                fits[name]["epoch_steady_samples_per_s"] = [
                    rows / t for t in loader.spans]
                steady = (f", {fits[name]['steady_samples_per_s']:.1f} "
                          "from its first batch's arrival")
            if name == "chunked":
                # the same superbatches, a step at a time
                ref_tr, again = trainer("cuda"), make()
                st = ref_tr.state
                for _ in range(STREAM_EPOCHS):
                    for xc, yc in again:
                        for xs, ys in zip(xc, yc):
                            st, _ = ref_tr.train_step(st, xs, ys)
                same = all(torch.equal(a, c) for a, c in zip(
                    tr.model.state_dict().values(),
                    ref_tr.model.state_dict().values()))
                require(same and st.step == state.step, "fit over "
                        "ChunkedLoader is not the per-step loop, bit for bit")
                fits[name]["bit_equal_to_the_step_loop"] = True
                del ref_tr, st, again
                chunked_tr = tr
            if name == "native":
                loader.close()
            print(f"  fit over {kind}: {STREAM_EPOCHS} "
                  f"epochs of {loader.steps_per_epoch} steps, losses "
                  f"{losses}; kernel 1 {got['fused_input_transform']} "
                  f"launches; {fits[name]['samples_per_s']:.1f} samples/s"
                  f"{steady} (epoch 2; {card})", flush=True)
        times["fits"] = time.perf_counter() - t0
        out["fits"] = fits

        # -- bench_chunked's legs, and the busy share ------------------------
        t0 = time.perf_counter()
        loader = ChunkedLoader(x, y, b, k, seed=seed + 1)
        out["legs"] = BC.legs(chunked_tr, loader, STREAM_LEG_REPS)
        lg = out["legs"]
        print(f"  bench_chunked legs ({card}), ms a superbatch of "
              f"{lg['superbatch_mb']:.1f} MB: compute {lg['compute_ms']:.2f}"
              f", transfer {lg['transfer_ms']:.2f} "
              f"({lg['transfer_gb_s']:.2f} GB/s), gather "
              f"{lg['gather_ms']:.2f} ({lg['gather_gb_s']:.2f} GB/s), "
              f"overlap {lg['overlap_ms']:.2f}, {lg['steady_ms']:.2f} from "
              f"the first superbatch's arrival; efficiency "
              f"{lg['efficiency']:.3f} ({lg['steady_efficiency']:.3f} "
              f"steady); bound by {lg['bound_leg']}",
              flush=True)
        out["busy"] = stream_busy(torch, chunked_tr, loader)
        times["legs_and_trace"] = time.perf_counter() - t0
        del loader, x, y
    out["seconds"] = times
    out["launches"] = launches
    print(f"  streaming phase seconds: " + ", ".join(
        f"{n} {v:.1f}" for n, v in times.items()), flush=True)
    return out


def stream_busy(torch, tr, loader):
    """torch.profiler over one ChunkedLoader epoch through the chunk
    runner: the card's busy share (kernels and fills on the device's
    timeline, copies apart) of the epoch's wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    run = loader.make_chunk_runner(tr.train_step)
    state = tr.state
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for xc, yc in loader:
            state, m = run(state, xc, yc)
        m["loss"].item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tr.state = state
    evs = device_events(prof)
    copy_ms = sum(ms for n, ms in evs if "Memcpy" in n)
    busy_ms = sum(ms for n, ms in evs if "Memcpy" not in n)
    print(f"  profile: one ChunkedLoader epoch, {wall_ms:.1f} ms; kernels "
          f"{busy_ms:.1f} ms (busy {busy_ms / wall_ms:.1%}), copies "
          f"{copy_ms:.1f} ms ({copy_ms / wall_ms:.1%})", flush=True)
    return {"wall_ms": wall_ms, "kernel_ms": busy_ms, "copy_ms": copy_ms,
            "busy_share": busy_ms / wall_ms, "copy_share": copy_ms / wall_ms}


def rel_l2(got, want) -> float:
    d = (got.double() - want.double()).norm()
    return float(d / want.double().norm().clamp_min(1e-300))


def cosine(got, want) -> float:
    a, b = got.double().flatten(), want.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def k6_net(torch, g, widths):
    """Random float32 weights (lecun-scaled normal) and biases on the
    card, in the kernel's (d_in, d_out) layout."""
    ws = [torch.randn(i, o, device="cuda", generator=g) / i ** 0.5
          for i, o in zip(widths[:-1], widths[1:])]
    bs = [0.1 * torch.randn(o, device="cuda", generator=g)
          for o in widths[1:]]
    return ws, bs


def kernel6_checks(torch, FT, seed):
    """Kernel 6 forward and backward against their plain versions for each
    of K6_NETS, the control, bit-equality and tile_b; then the times at
    B = 32768, v1 widths."""
    from climsim_tpu_torch.bench_mlp_train import bounds_ms as k6_bounds

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    res = {"fwd_max_abs_err": 0.0, "bwd_max_abs_err": 0.0,
           "bwd_max_rel_l2": 0.0, "bwd_min_cos": 1.0,
           "control_min_rel_l2": 1e9, "tile_b_max_abs_err": 0.0}
    for label, widths, rows, control in K6_NETS:
        ws, bs = k6_net(torch, g, widths)
        for b in rows:
            x = torch.randn(b, widths[0], device="cuda", generator=g)
            dy = torch.randn(b, widths[-1], device="cuda", generator=g) / b
            err = check_close(torch, f"fused_mlp_train_fwd {label}",
                              FT.fused_mlp_train_fwd(x, ws, bs),
                              FT.fused_mlp_train_fwd_plain(x, ws, bs),
                              *TOL["fused_mlp_forward"])
            res["fwd_max_abs_err"] = max(res["fwd_max_abs_err"], err[0])
            got = FT.fused_mlp_train_bwd(x, dy, ws, bs, K6_TILE_B[0])
            again = FT.fused_mlp_train_bwd(x, dy, ws, bs, K6_TILE_B[0])
            other = FT.fused_mlp_train_bwd(x, dy, ws, bs, K6_TILE_B[1])
            want = FT.fused_mlp_train_bwd_plain(x, dy, ws, bs)
            ctl = FT.fused_mlp_train_bwd_plain(x, dy, ws, bs, rounded=False)
            names = [f"dW{i}" for i in range(len(ws))] + [
                f"db{i}" for i in range(len(ws))]
            rels, coss, ctls = [], [], []
            for name, a, a2, a3, w, c in zip(names, got[0] + got[1],
                                             again[0] + again[1],
                                             other[0] + other[1],
                                             want[0] + want[1],
                                             ctl[0] + ctl[1]):
                require(bool(torch.isfinite(a).all()), f"{name}: non-finite")
                require(torch.equal(a, a2), f"{label} B={b} {name}: two "
                        "runs of the backward differ")
                share = outside(a3, a, *K6_TILE_TOL)
                require(share == 0, f"{label} B={b} {name}: tile_b "
                        f"{K6_TILE_B[1]} against {K6_TILE_B[0]}: {share:.3%}"
                        f" outside {K6_TILE_TOL}")
                res["tile_b_max_abs_err"] = max(res["tile_b_max_abs_err"],
                                                errors(a3, a)[0])
                r, cs = rel_l2(a, w), cosine(a, w)
                require(r <= K6_GRAD_TOL[0] and cs >= K6_GRAD_TOL[1],
                        f"{label} B={b} {name}: rel-L2 {r:.3e}, cosine "
                        f"{cs:.8f} against {K6_GRAD_TOL}")
                rels.append(r)
                coss.append(cs)
                res["bwd_max_abs_err"] = max(res["bwd_max_abs_err"],
                                             errors(a, w)[0])
                if name.startswith("dW"):
                    cr = rel_l2(c, w)
                    ctls.append(cr)
                    require(not control or cr > K6_GRAD_TOL[0],
                            f"{label} B={b} {name}: the float32 control "
                            f"passes ({cr:.3e})")
            res["bwd_max_rel_l2"] = max(res["bwd_max_rel_l2"], *rels)
            res["bwd_min_cos"] = min(res["bwd_min_cos"], *coss)
            if control:
                res["control_min_rel_l2"] = min(res["control_min_rel_l2"],
                                                *ctls)
            print(f"  kernel 6 {label:4s} B={b:5d} fwd max_abs_err="
                  f"{err[0]:.3e}; bwd rel-L2 max {max(rels):.3e} cos min "
                  f"{min(coss):.8f}; control rel-L2 min {min(ctls):.3e}; "
                  "bit-equal; tile_b ok", flush=True)
    # the pack against its plain version, and the planted fault: the
    # forward with the activations' hi part alone (one bf16 pass) must fail
    # the forward tolerance at v1, B = 32768
    nets = {"v1": k6_net(torch, g, V1_WIDTHS),
            "v2rh": k6_net(torch, g, V2RH_WIDTHS)}
    ws, bs = nets["v1"]
    x = torch.randn(32768, V1_WIDTHS[0], device="cuda", generator=g)
    pack = FT.pack_train_params(ws, bs)
    want = FT.pack_train_params_plain(ws, bs)
    require(torch.equal(pack.w, want.w) and torch.equal(pack.b, want.b),
            "fused_mlp_train_pack differs from its plain version")
    res["pack_ms"], res["pack_plain_ms"] = compare_timed(
        torch, lambda: FT.pack_train_params(ws, bs),
        lambda: FT.pack_train_params_plain(ws, bs), 20)
    plan = FT._train_plan(32768, V1_WIDTHS, K6_TILE_B[0], x.device)
    yp = FT.fused_mlp_train_fwd_plain(x, ws, bs)
    faults = {}
    for passes in (1, 3):
        y1 = FT._launch_forward(x, pack, plan, passes)
        faults[passes] = outside(y1, yp, *TOL["fused_mlp_forward"])
    print(f"  kernel 6 forward v1 B=32768 with the hi part alone: "
          f"{faults[1]:.4%} outside {TOL['fused_mlp_forward']} (three "
          f"passes: {faults[3]:.4%}); pack bit-equal to plain", flush=True)
    require(faults[3] == 0 and faults[1] > 0, "kernel 6's forward with one "
            "bf16 pass passes the tolerance: the check cannot see the split")
    res["one_pass_fault_outside"] = faults[1]
    res["mask_edge"] = k6_mask_edge(torch, FT, g)
    lib = FT._build.load()
    for bn in FT.GEMM_BN:
        for st in range(2, FT.GEMM_MAX_STAGES + 1):
            require(lib.cst_mlp_train_gemm_smem(bn, st) == FT._gemm_smem(bn, st),
                    f"_gemm_smem({bn}, {st}) is not the kernel's layout")
    require(lib.cst_fused_mlp_train_partials(
        (ctypes.c_int * len(V1_WIDTHS))(*V1_WIDTHS), len(V1_WIDTHS) - 1,
        32768, plan.args()) == plan.partial,
        "plan_mlp_train's partials are not the kernel's count")
    # device time (CUDA events around back-to-back calls), in turns plain,
    # kernel, kernel, plain; beside them a cuBLAS bf16 chain of the same
    # products, one pass (a yardstick the port never calls): the forward's,
    # and the backward's dW and dh products on bf16 operands
    res["ms"], res["plain_ms"], res["cublas_chain_ms"] = {}, {}, {}
    res["bounds"] = {}
    for label, b in K6_TIMED:
        widths = dict(v1=V1_WIDTHS, v2rh=V2RH_WIDTHS)[label]
        ws, bs = nets[label]
        x = torch.randn(b, widths[0], device="cuda", generator=g)
        dy = torch.randn(b, widths[-1], device="cuda", generator=g) / b
        iters = 5 if b > 384 else 20
        t, tp, tc = {}, {}, {}
        t["fwd"], tp["fwd"] = compare_timed(
            torch, lambda: FT.fused_mlp_train_fwd(x, ws, bs),
            lambda: FT.fused_mlp_train_fwd_plain(x, ws, bs), iters)
        t["bwd"], tp["bwd"] = compare_timed(
            torch, lambda: FT.fused_mlp_train_bwd(x, dy, ws, bs),
            lambda: FT.fused_mlp_train_bwd_plain(x, dy, ws, bs), iters)
        wg = [w.clone().requires_grad_() for w in ws]
        bg = [c.clone().requires_grad_() for c in bs]

        def step(apply):
            def run():
                apply(x, wg, bg).backward(dy)
            return run

        t["fwd_bwd"], tp["fwd_bwd_autograd"] = compare_timed(
            torch, step(FT.make_fused_mlp_train(widths)),
            step(FT.fused_mlp_train_fwd_plain), iters)
        wb = [w.to(torch.bfloat16) for w in ws]
        bb = [c.to(torch.bfloat16) for c in bs]
        hs = [h.to(torch.bfloat16) for h in
              FT._forward_acts(x, ws, bs)[:-1]]
        dyb = dy.to(torch.bfloat16)

        def fwd_chain():
            h = x.to(torch.bfloat16)
            for i, (w, c) in enumerate(zip(wb, bb)):
                h = h @ w + c
                if i < len(wb) - 1:
                    h = torch.relu(h)
            return h

        def bwd_chain():
            d = dyb
            for i in range(len(wb) - 1, -1, -1):
                hs[i].t() @ d
                if i:
                    d = (d @ wb[i].t()) * (hs[i] > 0)
            return d

        tc["fwd"] = time_ms(torch, fwd_chain, iters)
        tc["bwd"] = time_ms(torch, bwd_chain, iters)
        key = f"{label}_B{b}"
        res["ms"][key], res["plain_ms"][key] = t, tp
        res["cublas_chain_ms"][key] = tc
        res["bounds"][key] = k6_bounds(widths, b)
        print(f"  kernel 6 {label} B={b}: " + ", ".join(
            f"{k} {v:.4f} ms (plain {tp[k if k != 'fwd_bwd' else 'fwd_bwd_autograd']:.4f})"
            for k, v in t.items()) + f"; cuBLAS bf16 chain fwd {tc['fwd']:.4f}"
            f" bwd {tc['bwd']:.4f}; bound / three-pass floor "
            + ", ".join(f"{k} {v['bound_ms']:.4f} / "
                        f"{v['three_pass_floor_ms']:.4f}"
                        for k, v in res["bounds"][key].items()), flush=True)
    return res


def k6_mask_edge(torch, FT, g):
    """The relu mask's edge (F3): at the v1 widths, B = 384, hidden units 0
    and 1 of the first layer get zero weights and biases 2^-130 (a nonzero
    bf16 subnormal) and 2^-140 (which bf16 rounds to 0).  JAX's VJP on the
    CPU flushes both in the relu, so their db must be 0 in the kernel and
    in the plain version alike, and the kernel's two runs bit-equal."""
    ws, bs = k6_net(torch, g, V1_WIDTHS)
    ws[0][:, :2] = 0.0
    bs[0][0], bs[0][1] = 2.0 ** -130, 2.0 ** -140
    x = torch.randn(384, V1_WIDTHS[0], device="cuda", generator=g)
    dy = torch.randn(384, V1_WIDTHS[-1], device="cuda", generator=g) / 384
    got = FT.fused_mlp_train_bwd(x, dy, ws, bs)
    again = FT.fused_mlp_train_bwd(x, dy, ws, bs)
    want = FT.fused_mlp_train_bwd_plain(x, dy, ws, bs)
    require(all(torch.equal(a, b) for a, b in zip(got[0] + got[1],
                                                  again[0] + again[1])),
            "kernel 6 at the mask's edge: two runs differ")
    edge = got[1][0][:2].tolist()
    require(edge == [0.0, 0.0] and want[1][0][:2].tolist() == edge,
            f"kernel 6's db of the units at 2^-130 and 2^-140: {edge}, plain "
            f"{want[1][0][:2].tolist()}; JAX's is 0")
    r = rel_l2(got[1][0], want[1][0])
    require(r <= K6_GRAD_TOL[0], f"kernel 6 at the mask's edge: db0 rel-L2 "
            f"{r:.3e}")
    print(f"  kernel 6 mask edge: db of the units at 2^-130 and 2^-140 is "
          f"{edge} (plain {want[1][0][:2].tolist()}); db0 rel-L2 {r:.3e}; "
          "two runs bit-equal", flush=True)
    return {"db_at_2^-130": edge[0], "db_at_2^-140": edge[1],
            "db0_rel_l2": r}


def kernel6_training(torch, FT, K, seed):
    """30 Adam steps (lr 1e-3) on one fixed 32768-row batch at the v1
    widths through the kernels, then through the plain versions from the
    same start; the targets are a fixed random tanh map of x, so there is
    something to learn.  Also runs the float32 control backward and a
    gross fault (the last layer frozen) through the same steps.  Returns
    (launches, {curve: its two largest gaps to the plain curve, the first
    K6_CURVE_EARLY steps and after})."""
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    ws0, bs0 = k6_net(torch, g, V1_WIDTHS)
    x = torch.randn(32768, V1_WIDTHS[0], device="cuda", generator=g)
    teacher = torch.randn(V1_WIDTHS[0], V1_WIDTHS[-1], device="cuda",
                          generator=g) / V1_WIDTHS[0] ** 0.5
    y = torch.tanh(x @ teacher)

    def train(apply):
        ws = [w.clone().requires_grad_() for w in ws0]
        bs = [b.clone().requires_grad_() for b in bs0]
        opt = torch.optim.Adam(ws + bs, lr=1e-3, eps=1e-8)
        losses = []
        for _ in range(31):
            opt.zero_grad(set_to_none=True)
            loss = ((apply(x, ws, bs) - y) ** 2).mean()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).cpu().tolist()

    def gaps(curve, want):
        g = [abs(a - b) / abs(b) for a, b in zip(curve, want)]
        return max(g[:K6_CURVE_EARLY]), max(g[K6_CURVE_EARLY:])

    K.reset_launches()
    got = train(FT.make_fused_mlp_train(V1_WIDTHS))
    torch.cuda.synchronize()
    launches = {k: K.LAUNCHES[k] for k in K6_SOURCES}
    plain = FT.make_fused_mlp_train_plain(V1_WIDTHS)
    want = train(plain)
    curves = {
        "kernel": got,
        "float32_control": train(
            FT.make_fused_mlp_train_plain(V1_WIDTHS, rounded=False)),
        "frozen_last_layer": train(lambda x, ws, bs: plain(
            x, ws[:-1] + [ws[-1].detach()], bs))}
    gap = {k: gaps(c, want) for k, c in curves.items()}
    print(f"kernel 6 training, 30 Adam steps, v1 widths, B=32768: loss "
          f"{got[0]:.6f} -> {got[-1]:.6f} ({got[-1] / got[0]:.3f} of the "
          f"first); plain {want[0]:.6f} -> {want[-1]:.6f}; largest gap to "
          f"the plain curve in the first {K6_CURVE_EARLY} steps and after "
          f"(tolerance {K6_CURVE_TOL}): " + ", ".join(
              f"{k} {a:.3e} {b:.3e}" for k, (a, b) in gap.items())
          + f"; launches {launches}", flush=True)
    require(all(np.isfinite(got)), "kernel 6 training: non-finite loss")
    require(got[-1] <= 0.9 * got[0], "kernel 6 training: the loss fell "
            f"by less than 10% ({got[0]:.6f} -> {got[-1]:.6f})")
    require(gap["kernel"][0] <= K6_CURVE_TOL[0]
            and gap["kernel"][1] <= K6_CURVE_TOL[1],
            f"kernel 6 training: the loss curve is {gap['kernel']} from the "
            f"plain version's: {got} against {want}")
    require(gap["frozen_last_layer"][0] > K6_CURVE_TOL[0],
            "kernel 6 training: the curve with the last layer frozen passes")
    for name, n in launches.items():
        require(n >= 30, f"{name} launched {n} times in 30 steps")
    return launches, gap


def mlp_flax_tree(spec, hidden, seed):
    """A flax-layout v1 ClimSimMLP parameter tree of numpy arrays, drawn as
    flax_tree draws each Dense."""
    base = flax_tree(spec, (*hidden, spec.output_len), seed)
    trunk = base["MLPTrunk_0"]
    prehead = trunk.pop(f"Dense_{len(hidden)}")
    out = base["out"]   # (output_len, output_len): split into the head
    lin = spec.output_len - len(spec.output_scalar_vars)
    return {"MLPTrunk_0": trunk, "prehead": prehead, "LinReluHead_0": {
        "out_linear": {"kernel": out["kernel"][:, :lin],
                       "bias": out["bias"][:lin]},
        "out_relu": {"kernel": out["kernel"][:, lin:],
                     "bias": out["bias"][lin:]}}}


def step_split(torch, tr, loader):
    """torch.profiler over two epochs of the trainer: device time by part
    (GEMMs, Adam, kernel 1, the rest), and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    run = loader.make_epoch_runner(tr.train_step)
    tr.state, _ = run(tr.state, 1)
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.state, m = run(tr.state, 2)
        m["loss"].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = 2 * loader.steps_per_epoch
    parts = {"GEMM": 0.0, "Adam": 0.0, "kernel 1": 0.0, "other": 0.0}
    ranked = []
    for e in prof.key_averages():
        t = e.self_device_time_total / 1e3
        # the kernels and copies themselves: a host op (aten::mm) carries
        # its kernels' time too
        if t <= 0 or e.device_type != DeviceType.CUDA:
            continue
        ranked.append((t, e.count, e.key))
        key = e.key.lower()
        if "transform_kernel" in key:
            parts["kernel 1"] += t
        elif "adam" in key or "multi_tensor" in key:
            parts["Adam"] += t
        elif "gemm" in key or "cutlass" in key or "sm90_xmma" in key:
            parts["GEMM"] += t
        else:
            parts["other"] += t
    busy = sum(parts.values())
    print(f"profile: trainer, {steps} steps in {wall_ms:.1f} ms; card busy "
          f"{busy:.1f} ms ({busy / wall_ms:.1%}); per step: " + ", ".join(
              f"{k} {v / steps:.3f} ms" for k, v in parts.items()),
          flush=True)
    for t, n, key in sorted(ranked, reverse=True)[:8]:
        print(f"  device {t / steps:8.3f} ms/step {n:6d} x {key[:90]}")
    return {k: v / steps for k, v in parts.items()}, busy / wall_ms


def train_v1(torch, K, seed):
    """The slice's main path: the full-width v1 MLP through bench_train's
    core on the card, its first loss against the CPU's."""
    from climsim_tpu_torch import bench_train, get_varspec, load_asset_norms
    from climsim_tpu_torch.train import recipes
    from climsim_tpu_torch.utils.migrate import port_flax_mlp

    spec = get_varspec("v1")
    state = port_flax_mlp(mlp_flax_tree(spec, bench_train.HIDDEN, seed))
    t0 = time.perf_counter()
    tr, loader, _ = bench_train.build(
        "cuda", seed, pool=TRAIN_ROWS // bench_train.BATCH,
        state_dict=state)
    print(f"v1 MLP {'x'.join(map(str, bench_train.HIDDEN))}: "
          f"{sum(p.numel() for p in tr.model.parameters())} parameters; "
          f"{loader.n} rows on the card, {loader.steps_per_epoch} steps an "
          f"epoch of {loader.batch_size} (set-up "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    xb, yb = next(iter(loader))
    loader.set_epoch(0)
    first = float(tr.eval_step(tr.model, xb, yb)["loss"])
    cpu = recipes.mlp_trainer(spec, load_asset_norms("v1"), None, seed,
                              hidden=bench_train.HIDDEN, device="cpu")
    cpu.model.load_state_dict(state)
    want = float(cpu.eval_step(cpu.model, xb.cpu(), yb.cpu())["loss"])
    gap = abs(first - want) / abs(want)
    print(f"  first step's loss: card {first:.8f}, CPU {want:.8f}, gap "
          f"{gap:.3e} (tolerance {FIRST_LOSS_TOL})", flush=True)
    require(gap <= FIRST_LOSS_TOL, f"first loss {first} on the card, "
            f"{want} on the CPU")
    K.reset_launches()
    res = bench_train.throughput(tr, loader, TRAIN_EPOCHS, TRAIN_REPS)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    losses = res["epoch_loss"]
    print(f"launches in the training run: {launches}", flush=True)
    require(launches["fused_input_transform"] > 0,
            "fused_input_transform was not launched by the trainer")
    require(all(np.isfinite(losses)), "non-finite training loss")
    require(losses[-1] < losses[0], f"training loss did not fall: "
            f"{losses[0]} -> {losses[-1]}")
    print(f"trained v1 MLP: {len(losses)} epochs, loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; calls of {TRAIN_EPOCHS} epochs: "
          + " ".join(f"{t:.3f}" for t in res["call_s"])
          + f" s; best {res['samples_per_s']:.1f} samples/s", flush=True)
    res["split_ms"], res["busy"] = step_split(torch, tr, loader)
    res.update(first_loss=first, first_loss_cpu=want, first_gap=gap,
               launches=launches)
    return res


def trainable_checks(torch, K, PU, seed):
    """5' (kernel 5 under its custom VJP) at every fused chain shape of the
    unet_v5 step and B in TRAINABLE_ROWS: the forward against the plain
    forward on the bf16-rounded weight within GN_TOL (the float32 control
    must fail), every gradient bit-equal to autograd of the plain chain at
    the same inputs and cotangent (cuDNN off here only), one
    launch a call; then forward + backward timed at B = 1024 against that
    autograd, weighted by each shape's count in a step."""
    from climsim_tpu_torch.bench_gn_conv3 import chain_args

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    res = {"max_abs_err": 0.0, "max_err_rel": 0.0, "control_min_rel": 1e9}
    names = ("dx", "dgamma", "dbeta", "dw", "db")
    bf16 = torch.bfloat16
    # Bit-equality needs reproducible convolutions.  cuDNN's were not on
    # an H100, even with deterministic set: two runs of the plain chain's
    # autograd gave different weight gradients at L=64 C=256 Cout=128
    # B=1024.  So this phase sets deterministic and turns cuDNN off, and
    # the convolutions run as PyTorch's own im2col and cuBLAS products.
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.enabled
    cudnn.deterministic, cudnn.enabled = True, False
    try:
        K.reset_launches()
        calls = 0
        for (l, c, cout) in UNET_CHAINS:
            f = PU.make_trainable_fused_block(PU._num_groups(c))
            for b in TRAINABLE_ROWS:
                a = chain_args(torch, g, b, l, c, cout, wdtype=torch.float32)
                cot = torch.randn(b, l, cout, device="cuda", generator=g)
                ins = [t.clone().requires_grad_() for t in a]
                y = f(*ins)
                calls += 1
                got = torch.autograd.grad(y, ins, cot)
                ref_ins = [t.clone().requires_grad_() for t in a]
                want = torch.autograd.grad(PU.xla_gn_silu_conv3_plain(
                    *ref_ins, bf16, f32_accum=False), ref_ins, cot)
                for name, x, w in zip(names, got, want):
                    require(x.dtype == torch.float32 and x.shape == w.shape
                            and x.stride() == w.stride(),
                            f"5' {name}: {x.dtype} {tuple(x.shape)} "
                            f"{x.stride()}")
                    require(torch.equal(x, w), f"5' L={l} C={c} Cout={cout} "
                            f"B={b}: {name} differs from autograd of the "
                            f"plain chain (rel-L2 {rel_l2(x, w):.3e})")
                plain = PU.xla_gn_silu_conv3_plain(*a[:3], a[3].to(bf16),
                                                   a[4])
                scale = float(plain.abs().max())
                err = float((y.detach() - plain).abs().max())
                ctl = float((PU.xla_gn_silu_conv3_plain(*a) - plain).abs()
                            .max())
                require(err <= GN_TOL * scale, f"5' L={l} C={c} B={b}: "
                        f"forward {err / scale:.3e} of max|y|")
                require(ctl > GN_TOL * scale, f"5' L={l} C={c} B={b}: the "
                        "float32 control passes")
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["max_err_rel"] = max(res["max_err_rel"], err / scale)
                res["control_min_rel"] = min(res["control_min_rel"],
                                             ctl / scale)
        torch.cuda.synchronize()
        res["launches"] = K.LAUNCHES["fused_gn_silu_conv3"]
        require(res["launches"] == calls, f"5': {res['launches']} launches "
                f"in {calls} calls")
    finally:
        cudnn.deterministic, cudnn.enabled = saved
    print(f"  5' at {len(UNET_CHAINS)} shapes x B={TRAINABLE_ROWS}: forward "
          f"max {res['max_err_rel']:.3e} of max|y| (control min "
          f"{res['control_min_rel']:.3e}); dx, dgamma, dbeta, dw, db "
          f"bit-equal to autograd of the plain chain; {calls} launches",
          flush=True)
    ms = plain_ms = 0.0
    for (l, c, cout), n in UNET_CHAINS.items():
        f = PU.make_trainable_fused_block(PU._num_groups(c))
        a = [t.requires_grad_() for t in chain_args(
            torch, g, UNET_BATCH, l, c, cout, wdtype=torch.float32)]
        cot = torch.randn(UNET_BATCH, l, cout, device="cuda", generator=g)

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(*a), a, cot)

        k, p = compare_timed(torch, fwd_bwd(f), fwd_bwd(
            lambda *t: PU.xla_gn_silu_conv3_plain(*t, bf16, f32_accum=False)),
            5)
        ms, plain_ms = ms + n * k, plain_ms + n * p
    res["ms"], res["plain_ms"] = ms, plain_ms
    print(f"  5' forward + backward, the 82 chains of a B={UNET_BATCH} step: "
          f"{ms:.3f} ms; autograd of the plain chain {plain_ms:.3f} ms",
          flush=True)
    return res


def unet_split(torch, PU, tr, batches, steps=2):
    """torch.profiler over ``steps`` train steps: device time a step by
    part -- kernel 5, the 5' backward's recompute (everything under its
    range), convs and GEMMs outside it, Adam, kernel 1, the rest -- and
    the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    st = tr.state
    for xb, yb in batches[:2]:
        st, m = tr.train_step(st, xb, yb)
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            st, m = tr.train_step(st, *batches[i % len(batches)])
        m["loss"].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tr.state = st
    events = prof.events()
    inside = set()

    def mark(ev):
        inside.add(id(ev))
        for ch in ev.cpu_children:
            mark(ch)

    for ev in events:
        if ev.name == PU.BACKWARD_RANGE:
            mark(ev)

    def part(name):
        key = name.lower()
        if "gn_silu_conv3_kernel" in key:
            return "kernel 5"
        if "transform_kernel" in key:
            return "kernel 1"
        if "adam" in key or "multi_tensor" in key:
            return "Adam"
        if any(s in key for s in ("gemm", "conv", "cutlass", "xmma", "cudnn",
                                  "fft", "region_transform", "sm90",
                                  "implicit", "grad")):
            return "convs and GEMMs"
        return "other"

    # every kernel and copy from the device's own events (kernels 1 and 5
    # are launched through ctypes, under no torch op), not the ranges that
    # mirror record_function on the device's timeline; the recompute is
    # what ran under 5''s backward range, taken out of its parts
    parts = dict.fromkeys(("kernel 5", "5' backward recompute",
                           "convs and GEMMs", "Adam", "kernel 1", "other"),
                          0.0)
    by_name: dict = {}
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            if ev.is_user_annotation:
                continue
            t = ev.device_time_total / 1e3
            parts[part(ev.name)] += t
            by_name[ev.name] = by_name.get(ev.name, 0.0) + t
        elif id(ev) in inside:
            for kern in ev.kernels:
                t = kern.duration / 1e3
                parts[part(kern.name)] -= t
                parts["5' backward recompute"] += t
    busy = sum(parts.values())
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device {t / steps:9.3f} ms/step {name[:100]}")
    # one stream: the device's work cannot outlast the wall clock
    require(busy <= 1.02 * wall_ms, f"the split counts {busy:.1f} ms of "
            f"device time in {wall_ms:.1f} ms")
    return {k: v / steps for k, v in parts.items()}, busy / wall_ms


def train_unet(torch, K, PU, unet_flax_tree_fn, seed):
    """The slice's main path: the full-width U-Net v5 (unet_v5 preset,
    fused_gn_conv=True) through unet_trainer and DeviceResidentLoader at
    B = 1024 (bench_unet_train's core), its first loss on 16 rows against
    the CPU's, UNET_CURVE_STEPS steps against the plain chain forward and
    a planted fault, the plain arm timed beside it, a profile of a step,
    and peak memory."""
    from climsim_tpu_torch import bench_unet_train as BU
    from climsim_tpu_torch.models.unet import ClimSimUNet
    from climsim_tpu_torch.train import recipes
    from climsim_tpu_torch.utils.migrate import port_flax_unet
    from climsim_tpu_torch import get_varspec, load_asset_norms

    spec, stats = get_varspec("v5"), load_asset_norms("v5")
    t0 = time.perf_counter()
    data = BU.pool(UNET_BATCH * UNET_POOL, seed)
    probe = ClimSimUNet(spec, **BU.model_kw("fused"))
    state = port_flax_unet(unet_flax_tree_fn(probe, seed + 5), probe)
    tr, loader = BU.build("cuda", "fused", data, seed, UNET_BATCH, state)
    chains = tr.model.fused_chains(UNET_BATCH)
    n_chains = sum(chains.values())
    require(chains == UNET_CHAINS, f"the step's fused chains: {chains}")
    print(f"U-Net v5 training (unet_v5, fused_gn_conv=True): "
          f"{sum(p.numel() for p in tr.model.parameters())} parameters, "
          f"{n_chains} fused chains a forward; {loader.n} rows on the card, "
          f"{loader.steps_per_epoch} steps an epoch of {UNET_BATCH} (set-up "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    # the first loss on 16-row batches, card against CPU: through 5', and
    # for scale the all-plain model and the float32 control (the chains
    # without their bf16 roundings, on the card)
    plain_tr, _ = BU.build("cuda", "plain", data, seed, UNET_BATCH, state)
    cpu = {arm: recipes.unet_trainer(spec, stats, None, seed,
                                     model_kw=BU.model_kw(arm), device="cpu")
           for arm in ("fused", "plain")}
    for t in cpu.values():
        t.model.load_state_dict(state)
    kernel_fn = PU.fused_gn_silu_conv3

    def unrounded(x, gamma, beta, w, b):
        return PU.xla_gn_silu_conv3_plain(x, gamma, beta, w.float(), b)

    first_gaps = {"fused": [], "plain": [], "float32_control": []}
    for i in range(UNET_FIRST_BATCHES):
        rows = slice(i * UNET_FIRST_ROWS, (i + 1) * UNET_FIRST_ROWS)
        xb, yb = (torch.from_numpy(a[rows]) for a in data)

        def loss(t, dev):
            return float(t.eval_step(t.model, xb.to(dev), yb.to(dev))["loss"])

        want = {arm: loss(t, "cpu") for arm, t in cpu.items()}
        got = {"fused": loss(tr, "cuda"), "plain": loss(plain_tr, "cuda")}
        try:
            PU.fused_gn_silu_conv3 = unrounded
            got["float32_control"] = loss(tr, "cuda")
        finally:
            PU.fused_gn_silu_conv3 = kernel_fn
        for arm, v in got.items():
            ref = want["plain" if arm == "plain" else "fused"]
            first_gaps[arm].append(abs(v - ref) / abs(ref))
    gap = max(first_gaps["fused"])
    print(f"  first loss on {UNET_FIRST_BATCHES} batches of "
          f"{UNET_FIRST_ROWS} rows, card against CPU: " + ", ".join(
              f"{arm} " + " ".join(f"{v:.2e}" for v in g)
              for arm, g in first_gaps.items())
          + f" (tolerance {UNET_FIRST_LOSS_TOL})", flush=True)
    require(gap <= UNET_FIRST_LOSS_TOL, f"U-Net first loss {gap:.3e} from "
            "the CPU's")
    del cpu

    # the main path: UNET_EPOCHS epochs through the epoch runner
    from climsim_tpu_torch.bench_train import throughput

    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    res = throughput(tr, loader, 1, UNET_EPOCHS - 1)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    steps = UNET_EPOCHS * loader.steps_per_epoch
    losses = res["epoch_loss"]
    peak = {"fused": torch.cuda.max_memory_allocated()}
    print(f"  launches in the training run ({steps} steps): {launches}",
          flush=True)
    require(launches["fused_gn_silu_conv3"] == n_chains * steps,
            f"kernel 5 launched {launches['fused_gn_silu_conv3']} times in "
            f"{steps} steps of {n_chains} fused chains")
    require(launches["fused_input_transform"] == steps,
            "fused_input_transform was not launched once a step")
    require(all(np.isfinite(losses)), f"non-finite U-Net loss: {losses}")
    require(losses[-1] < losses[0], f"U-Net training loss did not fall: "
            f"{losses}")
    print(f"  trained U-Net v5: {UNET_EPOCHS} epochs, loss "
          + " -> ".join(f"{v:.6f}" for v in losses) + "; epoch walls "
          + " ".join(f"{t:.3f}" for t in res["call_s"]) + " s; peak "
          f"{peak['fused'] / 2**30:.2f} GiB", flush=True)

    # under remat, kernel 5 runs again in the backward: twice a chain
    batches = list(loader)
    xb, yb = batches[0]
    tr.model.remat_blocks = True
    K.reset_launches()
    tr.state, _ = tr.train_step(tr.state, xb, yb)
    torch.cuda.synchronize()
    tr.model.remat_blocks = False
    remat_launches = K.LAUNCHES["fused_gn_silu_conv3"]
    require(remat_launches == 2 * n_chains, f"remat step: kernel 5 launched "
            f"{remat_launches} times, want {2 * n_chains}")

    # the plain arm beside it, in turns: plain, fused, fused, plain
    run = {"fused": loader.make_epoch_runner(tr.train_step),
           "plain": loader.make_epoch_runner(plain_tr.train_step)}
    trainers = {"fused": tr, "plain": plain_tr}

    def epoch_s(arm):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainers[arm].state, m = run[arm](trainers[arm].state, 1)
        m["loss"].cpu()
        return time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    epoch_s("plain")                        # warm-up, and its peak memory
    peak["plain"] = torch.cuda.max_memory_allocated()
    walls = {"plain": [epoch_s("plain")], "fused": []}
    walls["fused"] += [epoch_s("fused"), epoch_s("fused")]
    walls["plain"].append(epoch_s("plain"))
    rows = loader.n
    sps = {a: rows / min(w) for a, w in walls.items()}
    step_ms = {a: 1e3 * min(w) / loader.steps_per_epoch
               for a, w in walls.items()}
    print(f"  epochs in turns (plain, fused, fused, plain): " + "; ".join(
        f"{a} " + " ".join(f"{t:.3f}" for t in w) + f" s, best "
        f"{sps[a]:.1f} samples/s, {step_ms[a]:.2f} ms a step"
        for a, w in walls.items()) + f"; peak memory plain "
        f"{peak['plain'] / 2**30:.2f} GiB", flush=True)
    split = {a: unet_split(torch, PU, trainers[a], batches)
             for a in ("fused", "plain")}
    for a, (parts, busy) in split.items():
        print(f"profile: U-Net {a} step at B={UNET_BATCH}: card busy "
              f"{busy:.1%}; per step " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in parts.items()), flush=True)
    del plain_tr, trainers, run

    # UNET_CURVE_STEPS steps from the same weights on the same batches:
    # the kernel, the plain chain forward, and the planted fault (dw
    # dropped in 5''s backward), which must fail the curve bound
    def curve():
        """(the losses, every parameter's move over the steps)."""
        t, ld = BU.build("cuda", "fused", data, seed, UNET_CURVE_BATCH,
                         state)
        st, out, bs = t.state, [], list(ld)
        for i in range(UNET_CURVE_STEPS):
            st, m = t.train_step(st, *bs[i % len(bs)])
            out.append(m["loss"])
        move = torch.cat([(p.detach() - state[k].to(p.device)).flatten()
                          for k, p in t.model.named_parameters()])
        return torch.stack(out).cpu().tolist(), move

    K.reset_launches()
    got, move_k = curve()
    torch.cuda.synchronize()
    require(K.LAUNCHES["fused_gn_silu_conv3"] == n_chains * UNET_CURVE_STEPS,
            "the kernel curve did not launch kernel 5 in every chain")
    backward = PU._TrainableBlock.backward
    try:
        PU.fused_gn_silu_conv3 = PU.xla_gn_silu_conv3_plain
        K.reset_launches()
        want, move_p = curve()
        require(K.LAUNCHES["fused_gn_silu_conv3"] == 0,
                "the plain-forward curve launched kernel 5")
        PU.fused_gn_silu_conv3 = kernel_fn

        def no_dw(ctx, g):
            dx, dgamma, dbeta, _, *rest = backward(ctx, g)
            return (dx, dgamma, dbeta, None, *rest)

        PU._TrainableBlock.backward = staticmethod(no_dw)
        fault, move_f = curve()
    finally:
        PU.fused_gn_silu_conv3 = kernel_fn
        PU._TrainableBlock.backward = backward

    def gaps(c):
        d = [abs(a - b) / abs(b) for a, b in zip(c, want)]
        return max(d[:UNET_CURVE_EARLY]), max(d[UNET_CURVE_EARLY:])

    gap_k, gap_f = gaps(got), gaps(fault)
    upd_k, upd_f = rel_l2(move_k, move_p), rel_l2(move_f, move_p)
    print(f"U-Net v5 curve, {UNET_CURVE_STEPS} Adam steps at "
          f"B={UNET_CURVE_BATCH}: kernel {got[0]:.6f} -> {got[-1]:.6f}, plain "
          f"forward {want[0]:.6f} -> {want[-1]:.6f}; largest gap to the "
          f"plain curve in the first {UNET_CURVE_EARLY} steps and after "
          f"(tolerance {UNET_CURVE_TOL}): kernel {gap_k[0]:.3e} "
          f"{gap_k[1]:.3e}, dw dropped {gap_f[0]:.3e} {gap_f[1]:.3e}; the "
          f"parameters' moves against the plain forward's, rel-L2 "
          f"(tolerance {UNET_MOVE_TOL}): kernel {upd_k:.3e}, dw dropped "
          f"{upd_f:.3e}", flush=True)
    print("  curves: " + json.dumps({"kernel": got, "plain": want,
                                     "fault": fault}), flush=True)
    require(all(np.isfinite(got)) and got[-1] < got[0],
            f"the kernel curve did not fall: {got}")
    require(gap_k[0] <= UNET_CURVE_TOL[0] and gap_k[1] <= UNET_CURVE_TOL[1],
            f"the kernel's curve is {gap_k} from the plain forward's")
    require(upd_k <= UNET_MOVE_TOL, f"the kernel's parameters moved "
            f"{upd_k:.3e} (rel-L2) from the plain forward's")
    require(upd_f > UNET_MOVE_TOL, f"with dw dropped the parameters moved "
            f"within {UNET_MOVE_TOL} of the plain forward's ({upd_f:.3e})")
    return {"samples_per_s": sps, "step_ms": step_ms, "epoch_walls": walls,
            "main_path_epoch_s": res["call_s"], "epoch_loss": losses,
            "first_loss_gaps": first_gaps, "peak_mem_bytes": peak,
            "launches": launches, "steps": steps,
            "remat_step_k5_launches": remat_launches,
            "split_ms": {a: s[0] for a, s in split.items()},
            "busy": {a: s[1] for a, s in split.items()},
            "curve_gaps": {"kernel": gap_k, "dw_dropped": gap_f},
            "move_gaps": {"kernel": upd_k, "dw_dropped": upd_f}}


def bound(nbytes: float, ops: float, kind: str):
    """(the least time in ms, "bytes" or "operations"): the larger of the
    bytes over the card's memory rate and the operations over its peak
    for ``kind`` (H100 SXM data sheet)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mlp_work(widths, b, wbytes):
    """(bytes, multiply-add operations) of a fused MLP forward at batch b:
    x in, y out (float32), every weight (``wbytes`` each) and bias read
    once."""
    n_w = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    n_b = sum(widths[1:])
    return (4 * b * (widths[0] + widths[-1]) + wbytes * n_w + 4 * n_b,
            2 * b * n_w, n_w, n_b)


# phase (d): the hybrid rollout driver over the served wrappers, and the
# offline and online scoring modules
ROLL_STEPS = 72           # one simulated day at 1200 s a step
ROLL_SEG = 24             # the segmented run: three segments of 24
ENS_MEMBERS, ENS_STEPS = 3, 24
TWO_STAGE_STEPS = 12
PLAIN_STEPS = 3           # the all-plain path's steps beside the kernels'
ROLL_WARM, ROLL_TIMED = 3, 24   # host-clock steps: warm-up, then timed
ROLL_PROFILED = 24        # --profile: steps of a traced rollout
# the driver's float32 tolerance (tests/test_online.py:167): the segmented
# run against the one rollout, the ensemble against the member loop
ROLL_TOL = (1e-5, 1e-6)
TAU_DAYS, DIURNAL = 2.0, 1.5    # scripts/online_eval.py's defaults
ENS_PERTURB_K = 0.05            # scripts/online_eval.py:1199
SCORE_STEPS = 4           # time steps of 384 columns scored offline
SCORE_TOL = 1e-10         # streaming vs in-memory, tests/test_metrics.py:164
SCORED = ("ptend_t", "ptend_q0001", "ptend_qn", "ptend_u", "cam_out_PRECC",
          "cam_out_NETSW")
KERNEL_NAMES = ("fused_input_transform", "fused_mlp_forward",
                "fused_mlp_forward_int8", "fused_constraint_head",
                "fused_gn_silu_conv3")


def counted(torch, K, fn):
    """fn() with the launch counts set to 0 just before and read just
    after; returns (its result, the counts, host-clock ms to the end of
    its device work)."""
    K.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(K.LAUNCHES), (time.perf_counter() - t0) * 1e3


def require_per_step(launches, steps, per_step, label):
    """Each of the five kernels launched per_step[name] times a step (0
    where it is not named) in a run of ``steps`` steps."""
    for name in KERNEL_NAMES:
        want = per_step.get(name, 0) * steps
        require(launches[name] == want, f"{label}: {name} launched "
                f"{launches[name]} times in {steps} steps, want {want}")


def state_checks(torch, label, final, traj):
    """Finite trajectories and final state, q1, qc and qi >= 0, and a
    finite water residual."""
    for k, v in traj.items():
        require(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
    for f in ("t", "q1", "qc", "qi", "u", "v", "prvphy", "dyn"):
        require(bool(torch.isfinite(getattr(final, f)).all()),
                f"{label}: non-finite final {f}")
    for f in ("q1", "qc", "qi"):
        require(bool((getattr(final, f) >= 0).all()),
                f"{label}: negative final {f}")
    require(bool((traj["q1"] >= 0).all() and (traj["qn"] >= 0).all()),
            f"{label}: negative q1 or qn in the trajectory")


def step_ms(torch, driver, state, start):
    """Host-clock ms a step, after ROLL_WARM warm-up steps: of ROLL_TIMED
    single steps (rollouts of 1, each ended by a synchronize: the host
    model waits for every step's tendencies), and of one rollout of
    ROLL_TIMED steps with one synchronize at its end (the host runs
    ahead).  Returns (the single steps' list, the rollout's ms a step)."""
    s, _ = driver.rollout(state, ROLL_WARM, start_step=start)
    torch.cuda.synchronize()
    ms = []
    for i in range(ROLL_TIMED):
        t0 = time.perf_counter()
        s, _ = driver.rollout(s, 1, start_step=start + ROLL_WARM + i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    driver.rollout(s, ROLL_TIMED, start_step=start + ROLL_WARM + ROLL_TIMED)
    torch.cuda.synchronize()
    return ms, (time.perf_counter() - t0) * 1e3 / ROLL_TIMED


def roll_gap(a, b, keys=("t", "q1", "qn", "u", "precc", "water_res")):
    """key -> max |a - b| / max |b| of two trajectories (or of one step
    of them)."""
    return {k: float((a[k] - b[k]).abs().max() / b[k].abs().max())
            for k in keys}


def within(a, b, tol=ROLL_TOL):
    """Every key of trajectories a and b within rtol / atol."""
    return all(bool(((a[k] - b[k]).abs()
                     <= tol[1] + tol[0] * b[k].abs()).all()) for k in b)


def trace_rollout(torch, label, run, steps):
    """torch.profiler trace of run() (``steps`` steps, after one warm-up
    call): the card's busy share, the device ops a step (kernels, copies
    and fills) and the device-to-host copies in the trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    run()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = device_events(prof)
    busy_ms = sum(ms for _, ms in evs)
    d2h = sorted({name for name, _ in evs if "DtoH" in name})
    out = {"steps": steps, "wall_ms": wall_ms, "busy_ms": busy_ms,
           "busy": busy_ms / wall_ms, "device_ops_a_step": len(evs) / steps,
           "dtoh_copies": sum(1 for name, _ in evs if "DtoH" in name),
           "dtoh_ops": d2h,
           "kernel5_ms_a_step": sum(ms for name, ms in evs
                                    if "gn_silu_conv3_kernel" in name)
           / steps}
    print(f"profile: {label} rollout, {steps} steps in {wall_ms:.1f} ms: "
          f"card busy {busy_ms:.3f} ms ({out['busy']:.1%}), "
          f"{out['device_ops_a_step']:.1f} device ops a step, "
          f"{out['dtoh_copies']} device-to-host copies {d2h}", flush=True)
    device_summary(evs, steps, "step")
    return out


def rollout_phase(torch, card, unet, wrap5, plain5, cls, wrap2, model, stats,
                  spec, stats5, grid, seed, profile):
    """(d) Rollouts and scores on the card: HybridDriver around the served
    U-Net v5 wrapper (ROLL_STEPS steps, a segmented run of the same steps,
    the all-plain path's first steps), a ENS_MEMBERS-member ensemble,
    V2RHDriver around the fast MLP_v2rh wrappers (bf16, int8), the
    two-stage U-Net v5; offline scores of the U-Net v5's predictions (the
    in-memory and the streaming scorer) and online diagnostics of the
    U-Net v5 rollout.  Returns the results and each counted run's
    launches."""
    import dataclasses

    from climsim_tpu_torch import get_varspec, physics
    from climsim_tpu_torch.data import transforms as T
    from climsim_tpu_torch.data.synthetic import (synthetic_inputs,
                                                  synthetic_split)
    from climsim_tpu_torch.eval import online_diags as D
    from climsim_tpu_torch.eval.scoring import offline_score
    from climsim_tpu_torch.eval.streaming import StreamingScorer
    from climsim_tpu_torch.online import driver as PD
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.online.two_stage import make_two_stage_apply
    from climsim_tpu_torch.online.wrapper import make_fast_mlp_wrapper
    from climsim_tpu_torch.ops import kernels as K
    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused

    spec4, spec5 = get_varspec("v4"), get_varspec("v5")
    s368 = scale368(torch, stats5).cuda()
    res, all_launches = {}, []
    x0 = synthetic_inputs(spec4, 384, grid, seed=seed + 80)
    with torch.inference_mode():
        s0 = PD.initial_state(x0, grid, device="cuda")
        forcing = PD.newtonian_relaxation(
            s0.t, s0.q1, s0.u, tau_steps=TAU_DAYS * 72, lat=grid.lat,
            diurnal_amp_k_per_day=DIURNAL, device="cuda")

        def main_run(label, wrap, per_step, steps, cls_=PD.HybridDriver):
            drv = cls_(wrap, grid, dyn_forcing=forcing)
            (final, traj), launches, _ = counted(
                torch, K, lambda: drv.rollout(s0, steps))
            require_per_step(launches, steps, per_step, label)
            state_checks(torch, label, final, traj)
            ms, piped = step_ms(torch, drv, final, steps)
            out = {"steps": steps, "columns": 384,
                   "ms_a_step_median": float(np.median(ms)),
                   "ms_a_step_p90": float(np.percentile(ms, 90)),
                   "ms_a_step_pipelined": piped,
                   "launches_a_step": {k: v / steps
                                       for k, v in launches.items()}}
            all_launches.append(launches)
            print(f"{card}: {label} rollout, 384 columns: "
                  f"{out['ms_a_step_median']:.3f} ms a simulated step "
                  f"(median of {ROLL_TIMED} synchronized steps after "
                  f"{ROLL_WARM}; p90 {out['ms_a_step_p90']:.3f}), "
                  f"{out['ms_a_step_pipelined']:.3f} ms a step over "
                  f"{ROLL_TIMED} steps with one synchronize; kernel launches a "
                  f"step {[launches[k] // steps for k in KERNEL_NAMES]} "
                  "(kernels 1, 2, 3, 4, 5)", flush=True)
            return drv, final, traj, out

        # -- 1. U-Net v5 -------------------------------------------------
        per5 = {"fused_input_transform": 1, "fused_constraint_head": 1,
                "fused_gn_silu_conv3": 82}
        drv5, final5, traj5, r = main_run("U-Net v5", wrap5, per5,
                                          ROLL_STEPS)
        plain_drv = PD.HybridDriver(plain5, grid, dyn_forcing=forcing)
        _, tf = drv5.step(s0, 0)
        _, tp = plain_drv.step(s0, 0)
        gap1 = float(((tf - tp) * s368).abs().max()
                     / (tp * s368).abs().max())
        require(gap1 <= NET_TOL, f"U-Net v5 rollout: step 1's tendencies "
                f"{gap1:.3e} of max|y| from the all-plain path (> {NET_TOL})")
        _, traj_p = plain_drv.rollout(s0, PLAIN_STEPS)
        plain_gaps = [roll_gap({k: v[i] for k, v in traj5.items()},
                               {k: v[i] for k, v in traj_p.items()})
                      for i in range(PLAIN_STEPS)]
        segs = {}
        for planted in (False, True):
            s, parts = s0, []
            for k in range(ROLL_STEPS // ROLL_SEG):
                s, tr = drv5.rollout(
                    s, ROLL_SEG, start_step=0 if planted else k * ROLL_SEG)
                parts.append(tr)
            segs[planted] = {k: torch.cat([p[k] for p in parts])
                             for k in traj5}
        seg_gap = roll_gap(segs[False], traj5)
        require(within(segs[False], traj5), f"U-Net v5: the segmented "
                f"rollout is {seg_gap} from the one rollout (> {ROLL_TOL})")
        planted_gap = roll_gap(segs[True], traj5)
        require(not within(segs[True], traj5), "U-Net v5: segments that "
                "restart the diurnal phase at 0 (planted) pass the "
                "segmented check")
        r.update(step1_tendency_gap_of_max_y=gap1,
                 plain_gaps_by_step=plain_gaps,
                 segmented_gap=seg_gap, planted_segmented_gap=planted_gap,
                 segmented_bit_equal=all(torch.equal(segs[False][k],
                                                     traj5[k])
                                         for k in traj5))
        print(f"  step 1 against the all-plain path: {gap1:.3e} of max|y| "
              f"(tolerance {NET_TOL}); the plain path's gap a step "
              f"(max |a - b| / max |b|; t, q1, qn, u, precc, water_res): "
              + "; ".join(", ".join(f"{v:.2e}" for v in g.values())
                          for g in plain_gaps), flush=True)
        print(f"  {ROLL_STEPS // ROLL_SEG} segments of {ROLL_SEG} against "
              f"the one rollout: {max(seg_gap.values()):.3e} (bit-equal: "
              f"{r['segmented_bit_equal']}; tolerance {ROLL_TOL}); with "
              f"start_step dropped (planted) {max(planted_gap.values()):.3e}"
              ", caught", flush=True)
        res["unet_v5"] = r

        # -- 2. a perturbed-IC ensemble ----------------------------------
        mrng = np.random.default_rng(1234)
        members = [s0] + [dataclasses.replace(s0, t=s0.t + torch.as_tensor(
            ENS_PERTURB_K * mrng.standard_normal((384, 60)).astype(
                np.float32), device="cuda"))
            for _ in range(ENS_MEMBERS - 1)]
        stacked = PD.stack_states(members)
        (ef, et), launches, _ = counted(
            torch, K, lambda: drv5.rollout_ensemble(stacked, ENS_STEPS))
        require_per_step(launches, ENS_STEPS, per5, "the ensemble")
        all_launches.append(launches)
        state_checks(torch, "the ensemble",
                     PD.map_state(lambda a: a.flatten(0, 1), ef),
                     {k: v.flatten(0, 1) for k, v in et.items()})
        loop = [drv5.rollout(m, ENS_STEPS)[1] for m in members]
        ens_gaps = [max(max(roll_gap({k: v[m, i] for k, v in et.items()},
                                     {k: v[i] for k, v in loop[m].items()})
                            .values()) for m in range(ENS_MEMBERS))
                    for i in range(ENS_STEPS)]
        for m in range(ENS_MEMBERS):
            require(within({k: v[m, 0] for k, v in et.items()},
                           {k: v[0] for k, v in loop[m].items()}),
                    f"the ensemble's member {m} at step 1 is not within "
                    f"{ROLL_TOL} of its own rollout")
        ms, piped = step_ms(torch, drv5,
                            PD.map_state(lambda a: a.flatten(0, 1), ef),
                            ENS_STEPS)
        r = {"members": ENS_MEMBERS, "steps": ENS_STEPS,
             "rows_a_step": ENS_MEMBERS * 384,
             "ms_a_step_median": float(np.median(ms)),
             "ms_a_member_step": float(np.median(ms)) / ENS_MEMBERS,
             "ms_a_step_pipelined": piped,
             "launches_a_step": {k: v / ENS_STEPS
                                 for k, v in launches.items()},
             "member_loop_gap_by_step": ens_gaps}
        print(f"{card}: {ENS_MEMBERS}-member ensemble, "
              f"{ENS_MEMBERS * 384} rows a step: {r['ms_a_step_median']:.3f}"
              f" ms a step, {r['ms_a_member_step']:.3f} ms a member-step "
              f"({r['ms_a_step_pipelined']:.3f} ms a step over {ROLL_TIMED} "
              "with one synchronize); against the member loop at step 1 "
              f"within {ROLL_TOL}; the gap a step (max over members and "
              f"keys): {', '.join(f'{g:.2e}' for g in ens_gaps)}",
              flush=True)
        res["ensemble"] = r

        # -- 3. MLP_v2rh through V2RHDriver, bf16 and int8 ----------------
        in_consts = T.input_transform_consts(spec, stats, T.TransformConfig(
            input_clip=True, input_clip_rhonly=True), "cuda")
        out_inv = torch.as_tensor(1.0 / stats.out_scale, dtype=torch.float32,
                                  device="cuda")
        scale2 = torch.as_tensor(stats.out_scale, dtype=torch.float32,
                                 device="cuda")
        ws, bs = K.mlp_params_to_matrices(model.state_dict())
        for w, dt, kern in (("bf16", torch.bfloat16, "fused_mlp_forward"),
                            ("int8", "int8", "fused_mlp_forward_int8")):
            wrap = make_fast_mlp_wrapper(model, stats, spec, dt,
                                         device="cuda")
            drv, _, _, r = main_run(
                f"MLP_v2rh {w}", wrap, {"fused_input_transform": 1,
                                        kern: 1}, ROLL_STEPS, PD.V2RHDriver)
            mlp = K.pack_mlp(ws, bs, dt, "cuda")
            plain = (K.fused_mlp_forward_int8_plain if w == "int8"
                     else K.fused_mlp_forward_plain)
            xs = drv.assemble_v4(s0)
            got = wrap(xs) * scale2
            want = plain(K.fused_input_transform_plain(xs, in_consts), mlp,
                         len(spec.output_scalar_vars)) * out_inv * scale2
            r["step1_tendency_max_abs_err"] = float((got - want).abs().max())
            r["step1_outside_2e-4_1e-4"] = outside(got.cpu(), want.cpu(),
                                                   *TOL["fused_mlp_forward"])
            if w == "bf16":
                check_close(torch, "MLP_v2rh bf16 rollout, step 1", got.cpu(),
                            want.cpu(), *TOL["fused_mlp_forward"])
            print(f"  step 1 against the plain versions (normalized units): "
                  f"max |err| {r['step1_tendency_max_abs_err']:.3e}, "
                  f"{r['step1_outside_2e-4_1e-4']:.4%} outside rtol 2e-4 / "
                  "atol 1e-4" + (" (printed: int8 is held link by link, "
                                 "phase 4)" if w == "int8" else ""),
                  flush=True)
            res[f"mlp_v2rh_{w}"] = r

        # -- 4. the two-stage U-Net v5 ------------------------------------
        drv2, _, _, r = main_run("two-stage U-Net v5", wrap2, {
            "fused_input_transform": 1, "fused_constraint_head": 1,
            "fused_gn_silu_conv3": 164}, TWO_STAGE_STEPS)
        plain2 = plain_v5_path(torch, K, T, PW, physics,
                               make_two_stage_apply(
                                   partial(unet_apply_fused, unet,
                                           fused=False),
                                   partial(unet_apply_fused, cls,
                                           fused=False),
                                   stats=stats5, device="cuda"),
                               spec5, stats5)
        x4 = drv2.assemble_v4(s0)
        tf, tp = wrap2(x4) * s368, plain2(x4) * s368
        r["step1_tendency_gap_of_max_y"] = float(
            (tf - tp).abs().max() / tp.abs().max())
        print(f"  step 1 against the all-plain path: "
              f"{r['step1_tendency_gap_of_max_y']:.3e} of max|y| (printed: "
              "a class may flip at a near tie, phase 6a)", flush=True)
        res["two_stage_v5"] = r

        # -- 5. offline scores of the U-Net v5 ----------------------------
        x, y = synthetic_split(spec5, SCORE_STEPS * 384, grid,
                               seed=seed + 90)
        xn = T.make_input_transform(spec5, stats5, v5_transform(T), "cuda")(
            torch.from_numpy(x).cuda())
        preds = {"fused": unet_apply_fused(unet, xn).cpu().numpy(),
                 "plain": unet_apply_fused(unet, xn,
                                           fused=False).cpu().numpy()}
        xn = xn.cpu().numpy()
    yn = y * stats5.out_scale
    t0 = time.perf_counter()
    tables, _ = offline_score(spec5, grid, stats5, xn, yn, preds)
    score_s = time.perf_counter() - t0
    sc = StreamingScorer(spec5, grid, stats5)
    for i in range(0, xn.shape[0], 384):
        sc.update(xn[i:i + 384], yn[i:i + 384],
                  {k: v[i:i + 384] for k, v in preds.items()})
    stream = sc.tables()
    worst = 0.0
    for m, tab in tables.items():
        for v, row in tab.items():
            for k, val in row.items():
                got = stream[m][v][k]
                require(bool(np.isclose(got, val, rtol=SCORE_TOL, atol=0)),
                        f"streaming {m}/{v}/{k} {got!r} against in-memory "
                        f"{val!r} (rtol {SCORE_TOL})")
                worst = max(worst, abs(got - val) / abs(val))
    print(f"offline scores (W/m^2) of the U-Net v5 on {SCORE_STEPS} x 384 "
          f"synthetic v5 columns, in-memory and streaming within "
          f"{worst:.2e} (tolerance {SCORE_TOL}); scored in {score_s:.2f} s "
          "on the host:", flush=True)
    for v in SCORED:
        print(f"  {v:15s} " + "; ".join(
            f"{m} " + ", ".join(f"{k} {tables[m][v][k]:.4g}"
                                for k in ("MAE", "RMSE", "R2", "bias"))
            for m in tables), flush=True)
    res["offline_scores"] = {
        "columns": SCORE_STEPS * 384, "streaming_vs_in_memory": worst,
        "host_s": score_s,
        "tables": {m: {v: tables[m][v] for v in SCORED} for m in tables}}

    # -- 6. online diagnostics of the U-Net v5 rollout --------------------
    tr = {k: v.cpu().numpy() for k, v in traj5.items()}
    diags = {"t_drift_K": D.drift(tr["t"], grid),
             "q1_drift": D.drift(tr["q1"], grid),
             "precip": D.precip_stats(tr["precc"], grid),
             "microphysics": D.microphysics_checks(tr["qn"], tr["t"],
                                                   tr["precc"]),
             "t_error_growth_vs_initial_K": D.error_growth(
                 tr["t"], np.broadcast_to(x0[:, :60], tr["t"].shape),
                 grid).tolist(),
             "water_res_abs_mean": np.abs(tr["water_res"]).mean(
                 axis=1).tolist()}
    flat = [diags["t_drift_K"], diags["q1_drift"],
            *diags["precip"].values(), *diags["microphysics"].values(),
            *diags["t_error_growth_vs_initial_K"],
            *diags["water_res_abs_mean"]]
    require(all(np.isfinite(flat)), "a non-finite online diagnostic")
    print(f"online diagnostics of the U-Net v5 rollout ({ROLL_STEPS} steps, "
          f"random weights: drift is expected): T drift "
          f"{diags['t_drift_K']:.3f} K, q1 drift {diags['q1_drift']:.3e}; "
          f"precip {diags['precip']}; microphysics "
          f"{diags['microphysics']}; T RMSE against the initial state at "
          f"steps 1, {ROLL_SEG}, {ROLL_STEPS}: "
          + ", ".join(f"{diags['t_error_growth_vs_initial_K'][i - 1]:.3f}"
                      for i in (1, ROLL_SEG, ROLL_STEPS))
          + f" K; |water residual| mean at steps 1, {ROLL_SEG}, "
          f"{ROLL_STEPS}: "
          + ", ".join(f"{diags['water_res_abs_mean'][i - 1]:.3e}"
                      for i in (1, ROLL_SEG, ROLL_STEPS)), flush=True)
    res["online_diagnostics"] = diags

    if profile:
        with torch.inference_mode():
            res["unet_v5"]["profile"] = trace_rollout(
                torch, "U-Net v5", lambda: drv5.rollout(s0, ROLL_PROFILED),
                ROLL_PROFILED)
            drv_mlp = PD.V2RHDriver(make_fast_mlp_wrapper(
                model, stats, spec, torch.bfloat16, device="cuda"), grid,
                dyn_forcing=forcing)
            res["mlp_v2rh_bf16"]["profile"] = trace_rollout(
                torch, "MLP_v2rh bf16", lambda: drv_mlp.rollout(
                    s0, ROLL_PROFILED), ROLL_PROFILED)
    return res, all_launches


def io_entry(name, source, replaces, launched, r, at):
    """The JSON entry of kernel 1 or 4: "ms" and "plain_ms" device times
    (CUDA-graph replays), "host_ms" the wrapper's host cost a call, and the
    bound, at the shape ``at``; every timed shape's under "by_shape"."""
    t = r["times"][at]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": r["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "host_ms": t["host_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "ms_is": f"device time at {at} (CUDA-graph replays)",
            "bit_equal": r["bit_equal"], "by_shape": r["times"]}


def kernel_bounds():
    """name -> (bound ms, bound_by) at the shapes each kernel's "ms" is
    timed at; kernels 1 and 4 carry theirs at every timed shape
    (io_times)."""
    b = 384
    out = {}
    nbytes, ops, _, n_b = mlp_work(V2RH_WIDTHS, b, 2)
    out["fused_mlp_forward"] = bound(nbytes, ops, "bf16")
    nbytes, ops, _, n_b = mlp_work(V2RH_WIDTHS, b, 1)
    out["fused_mlp_forward_int8"] = bound(nbytes + 4 * n_b, ops, "bf16")

    def chains(bsz, vjp):
        nbytes = ops = 0.0
        for (l, c, cout), n in UNET_CHAINS.items():
            act = 4 * bsz * l * (c + cout)          # x in, y out
            par = 2 * 4 * c + 4 * cout              # gamma, beta, b
            w = 3 * c * cout
            conv = 2 * bsz * l * w
            if vjp:   # + g in, dx out; w and dw float32; the 3 products
                nbytes += n * (2 * act + 2 * par + 2 * 4 * w)
                ops += n * 3 * conv
            else:
                nbytes += n * (act + par + 2 * w)
                ops += n * conv
        return bound(nbytes, ops, "bf16")

    out["fused_gn_silu_conv3"] = chains(b, False)
    out["make_trainable_fused_block"] = chains(UNET_BATCH, True)
    # kernel 6's forward and backward carry theirs (kernel6_checks); the
    # pack: float32 weights and biases in, the padded bf16 weights and
    # float32 biases out
    _, _, n_w, n_b = mlp_work(V1_WIDTHS, 1, 4)
    kp = [-(-w // 64) * 64 for w in V1_WIDTHS]
    out["fused_mlp_train_pack"] = bound(
        4 * (n_w + n_b) + 2 * sum(kp[:-1]) * max(kp[1:]) + 4 * sum(kp[1:]),
        0, "bf16")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="then print the fused MLPs' plans and trace both "
                    "served paths with torch.profiler")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 1

    from climsim_tpu_torch import (get_varspec, load_asset_norms,
                                   load_default_grid)
    from climsim_tpu_torch.data import transforms as T
    from climsim_tpu_torch.data.synthetic import synthetic_inputs
    from climsim_tpu_torch import physics
    from climsim_tpu_torch.models import OnlineMLP, build_model
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.online.server import (CouplingClient,
                                                 CouplingServer)
    from climsim_tpu_torch.online.wrapper import make_fast_mlp_wrapper
    from climsim_tpu_torch.ops import _build
    from climsim_tpu_torch.ops import fused_mlp_train as FT
    from climsim_tpu_torch.ops import kernels as K
    from climsim_tpu_torch.ops import unet_fused as PU
    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
    from climsim_tpu_torch.config import PRESETS
    from climsim_tpu_torch.utils.migrate import (port_flax_online_mlp,
                                                 port_flax_unet)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    require(not torch.backends.cuda.matmul.allow_tf32,
            "float32 products must not run in TF32")
    require(not torch.backends.cudnn.allow_tf32,
            "float32 convolutions must not run in TF32")

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().parent.name})", flush=True)
    log = _build.build_log().splitlines()
    for line in log:
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
    # kernel 5's instantiations by name: (ROWS, NT), registers, spills
    for i, line in enumerate(log):
        if ("Function properties for" in line
                and "gn_silu_conv3_kernel" in line):
            tiles = line.split("kernelILi")[1].split("EE")[0].replace(
                "ELi", ",")
            print(f"  ptxas: fused_gn_silu_conv3 <ROWS, NT> = <{tiles}>: "
                  f"{log[i + 1].strip()}; "
                  f"{log[i + 2].split('ptxas info    :')[-1].strip()}")
            require(" 0 bytes spill stores" in log[i + 1],
                    f"fused_gn_silu_conv3 <{tiles}> spills")
        # kernels 2, 3 and 6's: (int8, rows / 64, chunks a CTA, kernel 6's
        # float32 sums and saves)
        if "Function properties for" in line and "mlp_wgmma_kernel" in line:
            tmpl = line.split("kernelILb")[1].split("EE")[0].replace(
                "ELi", ",").replace("ELb", ",")
            print(f"  ptxas: fused MLP <int8, NWG, NB, f32> = "
                  f"<{tmpl}>: {log[i + 1].strip()}; "
                  f"{log[i + 2].split('ptxas info    :')[-1].strip()}")
            require(" 0 bytes spill stores" in log[i + 1],
                    f"the fused MLP <{tmpl}> spills")
        # kernel 6's backward GEMM <form (0 dW, 1 dh), BN> and its passes
        if "Function properties for" in line and any(
                k in line for k in ("gemm_kernel", "pack_kernel",
                                    "prep_kernel", "reduce_kernel")):
            kname = next(k for k in ("gemm_kernel", "pack_kernel",
                                     "prep_kernel", "reduce_kernel")
                         if k in line)
            if kname == "gemm_kernel":
                kname += "<" + line.split("gemm_kernelILi")[1].split(
                    "EE")[0].replace("ELi", ",") + ">"
            print(f"  ptxas: {kname}: {log[i + 1].strip()}; "
                  f"{log[i + 2].split('ptxas info    :')[-1].strip()}")
            require(" 0 bytes spill stores" in log[i + 1],
                    f"{kname} spills")
        # kernels 1 and 4 (kernel 1 a columns-a-thread instantiation)
        if "Function properties for" in line and (
                "transform_kernel" in line
                or "constraint_head_kernel" in line):
            kname = ("constraint_head_kernel" if "constraint_head" in line
                     else "transform_kernel<" + line.split(
                         "transform_kernelILi")[1].split("E")[0] + ">")
            print(f"  ptxas: {kname}: {log[i + 1].strip()}; "
                  f"{log[i + 2].split('ptxas info    :')[-1].strip()}")
            require(" 0 bytes spill stores" in log[i + 1],
                    f"{kname} spills")
        if "C75" in line:   # wgmma serialized by ptxas
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    specs = {v: (get_varspec(v), load_asset_norms(v))
             for v in ("v2_rh", "v5", "v1")}
    (spec, stats), (spec5, stats5) = specs["v2_rh"], specs["v5"]
    grid = load_default_grid()
    columns = {"v2_rh": synthetic_inputs(spec, max(KERNEL_ROWS), grid,
                                         seed=args.seed),
               "v5": synthetic_inputs(spec5, max(KERNEL_ROWS), grid,
                                      seed=args.seed + 1),
               "v1": synthetic_inputs(specs["v1"][0], max(V1_TRANSFORM_ROWS),
                                      grid, seed=args.seed + 2),
               "v2_rh_6145": synthetic_inputs(spec, 6145, grid,
                                              seed=args.seed + 3)}
    model = OnlineMLP(spec, hidden=FULL_HIDDEN)
    model.load_state_dict(port_flax_online_mlp(
        flax_tree(spec, FULL_HIDDEN, args.seed)))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"MLP_v2rh {spec.input_len} -> {'x'.join(map(str, FULL_HIDDEN))} "
          f"-> {spec.output_len}: {n_params} parameters", flush=True)

    seconds: dict = {}
    mark = [time.perf_counter()]

    def lap(name):
        """Print and keep the seconds since the last phase ended."""
        now = time.perf_counter()
        seconds[name] = now - mark[0]
        mark[0] = now
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)

    print("kernel vs plain on the card:", flush=True)
    res = kernel_checks(torch, K, T, specs, model, columns)
    lap("3 (kernels 1-3)")

    # -- the slice: the port's sidecar serving the full-width MLP --------
    chunks = [synthetic_inputs(spec, 384, grid, seed=args.seed + 10 + i)
              for i in range(3)]
    ragged = synthetic_inputs(spec, 50, grid, seed=args.seed + 20)
    servers, plain = {}, {}
    for w, dt in (("bf16", torch.bfloat16), ("int8", "int8")):
        wrap = make_fast_mlp_wrapper(model, stats, spec, dt, device="cuda")
        servers[w] = (wrap, CouplingServer(
            wrap, spec.input_len, base_chunk=384, max_batch=6144,
            device="cuda").start())
        plain[w] = make_fast_mlp_wrapper(model, stats, spec, dt,
                                         device="cpu")
    try:
        K.reset_launches()
        driven = {w: drive(CouplingClient, srv, chunks, ragged, N_LOOP)
                  for w, (_, srv) in servers.items()}
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        summaries = {w: srv.stats.summary() for w, (_, srv) in servers.items()}
    finally:
        for _, srv in servers.values():
            srv.stop()
    print(f"launches in the served run: {launches}", flush=True)
    for name in SOURCES:
        require(launches[name] > 0,
                f"{name} was not launched by the served path")

    # Replies are compared in normalized units (times out_scale): raw
    # tendencies span 1e-8 (water) to 1e2 (fluxes), beyond any one atol.
    # The int8 replies are held to the plain path link by link (int8_chain)
    # on their own normalized columns, and to the kernel's output there.
    scale = torch.as_tensor(stats.out_scale, dtype=torch.float32)
    consts = T.input_transform_consts(spec, stats, T.TransformConfig(
        input_clip=True, input_clip_rhonly=True), "cuda")
    int8_mlp = K.pack_mlp(*K.mlp_params_to_matrices(model.state_dict()),
                          "int8", "cuda")
    for w, (replies, lat) in driven.items():
        wrap, served_outside = servers[w][0], 0.0
        for x, y in zip(chunks + [ragged], replies):
            require(y.shape == (x.shape[0], spec.output_len),
                    f"reply shape {y.shape}")
            require(bool(np.isfinite(y).all()), "non-finite reply")
            with torch.inference_mode():
                direct = wrap(torch.from_numpy(x).cuda()).cpu().numpy()
                ref = plain[w](torch.from_numpy(x)) * scale
            require(np.array_equal(y, direct),
                    f"{w}: served reply differs from the direct call")
            y = torch.from_numpy(y.copy()) * scale
            if w == "bf16":
                check_close(torch, "served[bf16] vs plain", y, ref,
                            *TOL["fused_mlp_forward"])
            else:
                xn = K.fused_input_transform_plain(
                    torch.from_numpy(x).cuda(), consts)
                check_int8(torch, K, "served[int8] columns", xn, int8_mlp)
                check_close(torch, "served[int8] vs kernel", y,
                            K.fused_mlp_forward_int8(xn, int8_mlp, 8).cpu(),
                            *TOL["fused_mlp_forward"])
            served_outside = max(served_outside, outside(
                y, ref, *TOL["fused_mlp_forward"]))
        s = summaries[w]
        lat = np.asarray(lat)
        print(f"served {w}: {s['requests']} requests, {s['batches']} "
              f"device calls, device call p50 {s['latency_ms_p50']:.3f} ms "
              f"p99 {s['latency_ms_p99']:.3f} ms; 384-column round trip "
              f"p50 {np.percentile(lat, 50):.3f} ms "
              f"p99 {np.percentile(lat, 99):.3f} ms; replies against the "
              f"plain path: {served_outside:.4%} of the elements outside",
              flush=True)
    lap("4 (served MLP_v2rh)")

    # -- the U-Net v5 coupling path ----------------------------------------
    print("U-Net kernels vs plain on the card:", flush=True)
    gn = gn_checks(torch, PU, args.seed)
    head = head_checks(torch, K, stats5, args.seed)
    lap("5 (kernels 4-5)")
    spec4 = get_varspec("v4")
    unet = build_model("unet", spec5, **PRESETS["unet_v5"].model_kw)
    unet.load_state_dict(port_flax_unet(unet_flax_tree(unet, args.seed),
                                        unet))
    unet = unet.to("cuda").eval()
    print(f"U-Net v5 (unet_v5 preset): "
          f"{sum(p.numel() for p in unet.parameters())} parameters",
          flush=True)
    wrap5 = PW.make_wrapper(partial(unet_apply_fused, unet), stats5,
                            PW.WrapperConfig(input_version="v4"),
                            device="cuda")
    plain5 = plain_v5_path(torch, K, T, PW, physics,
                           partial(unet_apply_fused, unet, fused=False),
                           spec5, stats5)
    chunks5 = [synthetic_inputs(spec4, 384, grid, seed=args.seed + 30 + i)
               for i in range(3)]
    ragged5 = synthetic_inputs(spec4, 50, grid, seed=args.seed + 40)
    replies5, lat5, launches5, summary5 = serve_run(
        torch, K, CouplingClient, CouplingServer, wrap5, spec4.input_len,
        chunks5, ragged5, N_LOOP,
        "served U-Net v5" if args.profile else None)
    print(f"launches in the served U-Net run: {launches5}", flush=True)
    require_per_call(launches5, summary5, {
        "fused_input_transform": 1, "fused_gn_silu_conv3": 82,
        "fused_constraint_head": 1}, "the served U-Net path")
    s368 = scale368(torch, stats5)
    cmp5 = compare_served(torch, "served U-Net", chunks5 + [ragged5],
                          replies5, wrap5, plain5, s368)
    report_served(card, "served U-Net v5", summary5, lat5, cmp5)
    with torch.inference_mode():
        xn = K.fused_input_transform_plain(
            PW.convert_v4_to_v5(torch.from_numpy(chunks5[0]).cuda()),
            T.input_transform_consts(spec5, stats5, v5_transform(T), "cuda"))
        batch_invariance(torch, F, PU, unet_apply_fused, unet, xn)
    lap("6 (served U-Net v5)")

    # -- (a) two-stage v5, (b) v4, (c) train -> bundle -> serve -----------
    cls, wrap2, served2 = two_stage_phase(torch, card, unet, stats5, grid,
                                          args.seed, args.profile)
    lap("6a (two-stage U-Net v5)")
    served4 = v4_phase(torch, card, grid, args.seed, args.profile)
    lap("6b (U-Net v4)")
    with tempfile.TemporaryDirectory() as tmp:
        bundles, programs = bundle_phase(torch, card, kind, unet, cls, wrap2,
                                         grid, args.seed, tmp)
    lap("6c (fit, bundle, serve)")

    # -- (d) rollouts and scores ------------------------------------------
    rollouts, roll_launches = rollout_phase(
        torch, card, unet, wrap5, plain5, cls, wrap2, model, stats, spec,
        stats5, grid, args.seed, args.profile)
    lap("6d (rollouts, scores)")

    # -- (e) bench_server on the served paths -------------------------------
    server = server_phase(torch, card, grid, args.seed, {
        "mlp_bf16": (servers["bf16"][0], spec, *programs["mlp_v2rh"]),
        "mlp_int8": (servers["int8"][0], spec, None, None),
        "unet_v5": (wrap5, spec4, None, None),
        "two_stage_v5": (wrap2, spec4, programs["unet_v5"][0], None)})
    lap("6e (bench_server)")
    del cls, wrap2, programs
    slice_launches = [served2["launches"], served4["launches"],
                      bundles["fit"]["launches"],
                      bundles["mlp_v2rh"]["launches"],
                      bundles["unet_v5"]["launches"], *roll_launches]

    # -- kernel 6 and the v1 trainer ---------------------------------------
    print("fused MLP-training kernel vs plain on the card:", flush=True)
    k6 = kernel6_checks(torch, FT, args.seed)
    lap("7 (kernel 6)")
    k6_launches, k6_gaps = kernel6_training(torch, FT, K, args.seed)
    lap("8 (training through kernel 6)")
    train = train_v1(torch, K, args.seed)
    print(f"{card}: v1 MLP training {train['samples_per_s']:.1f} "
          "samples/s", flush=True)
    lap("9 (v1 MLP training)")

    # -- 9a: the v1 MLP trained from a split past the card's memory --------
    print("streaming the v1 split through the host loaders:", flush=True)
    stream = streaming_phase(torch, K, card, args.seed)
    slice_launches.append(stream["launches"])
    print(f"{card}: streamed v1 MLP training, samples/s " + ", ".join(
        f"{n} {v['samples_per_s']:.1f}" for n, v in stream["fits"].items()),
        flush=True)
    lap("9a (streaming)")

    # -- 5' and the slice's main path: U-Net v5 training ------------------
    print("5' (kernel 5 under its custom VJP) on the card:", flush=True)
    k5t = trainable_checks(torch, K, PU, args.seed)
    lap("10 (5')")
    unet_train = train_unet(torch, K, PU, unet_flax_tree, args.seed)
    print(f"{card}: U-Net v5 training at B={UNET_BATCH}: fused "
          f"{unet_train['samples_per_s']['fused']:.1f} samples/s, plain "
          f"{unet_train['samples_per_s']['plain']:.1f} samples/s", flush=True)
    lap("11 (U-Net v5 training)")

    if args.profile:
        profile(torch, K, model, stats, spec, chunks[0])
    require("jax" not in sys.modules, "the port must not load jax")
    require(not any(m.split(".")[0] == "climsim_tpu" for m in sys.modules),
            "the port must not load the JAX package")
    bounds = kernel_bounds()
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = res[name]
        launched = (launches[name] + launches5[name]
                    + train["launches"][name] + unet_train["launches"][name]
                    + sum(n[name] for n in slice_launches))
        if name == "fused_input_transform":
            kernels.append(io_entry(name, source, replaces, launched, r,
                                    "v2_rh B=384"))
            continue
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in ("whole_network_max_abs_err",) if k in r},
            "ms": r["ms"][384], "plain_ms": r["plain_ms"][384],
            "ms_b6144": r["ms"][6144], "plain_ms_b6144": r["plain_ms"][6144],
            **{k: r[k] for k in (
                "cublas_chain_ms", "plans", "batch_invariant",
                "one_pass_fault_outside", "two_pass_outside",
                "two_pass_max_abs_err", "int8_vs_f32_mean_err") if k in r},
        })
    kernels.append({
        "name": "fused_gn_silu_conv3", "route": "cuda",
        "source": UNET_SOURCES["fused_gn_silu_conv3"][0],
        "replaces": UNET_SOURCES["fused_gn_silu_conv3"][1],
        "launches": launches5["fused_gn_silu_conv3"]
        + unet_train["launches"]["fused_gn_silu_conv3"]
        + sum(n["fused_gn_silu_conv3"] for n in slice_launches),
        "max_abs_err": gn["max_abs_err"], "max_err_of_max_y": gn["max_err_rel"],
        "control_min_err_of_max_y": gn["control_min_rel"],
        "offset_1e3_err_of_max_y": gn["offset_err_rel"],
        "ms": gn["ms"], "plain_ms": gn["plain_ms"],
        "ms_is": "sum over the 82 chains of one B=384 forward",
        "ms_b1024": gn["ms_b1024"], "plain_ms_b1024": gn["plain_ms_b1024"],
        "bound_ms_b1024": gn["bound_ms_b1024"],
        "per_shape_ms": gn["per_shape_ms"],
        "per_shape_plain_ms": gn["per_shape_plain_ms"],
        "per_shape_bound_ms": gn["per_shape_bound_ms"],
        "tiles": gn["plans"], "stepped_plan": gn["stepped"]})
    kernels.append(io_entry(
        "fused_constraint_head", *UNET_SOURCES["fused_constraint_head"],
        launches5["fused_constraint_head"]
        + sum(n["fused_constraint_head"] for n in slice_launches), head,
        "B=384"))
    main_k6 = "v1_B32768"
    for name, (source, replaces) in K6_SOURCES.items():
        d = name.rsplit("_", 1)[1]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": k6_launches[name]}
        if d == "pack":
            entry.update({"max_abs_err": 0.0,
                          "bit_equal": "to its plain version, v1 widths",
                          "ms": k6["pack_ms"], "plain_ms": k6["pack_plain_ms"],
                          "ms_is": "v1 widths"})
            kernels.append(entry)
            continue
        entry.update({
            "max_abs_err": k6[f"{d}_max_abs_err"],
            "ms": k6["ms"][main_k6][d], "plain_ms": k6["plain_ms"][main_k6][d],
            "ms_is": "v1 widths, B=32768 (CUDA events, back-to-back calls)",
            "bound_ms": k6["bounds"][main_k6][d]["bound_ms"],
            "bound_by": k6["bounds"][main_k6][d]["bound_by"],
            "three_pass_floor_ms":
                k6["bounds"][main_k6][d]["three_pass_floor_ms"],
            "cublas_chain_ms": k6["cublas_chain_ms"][main_k6][d],
            "by_shape": {k: {"ms": v[d], "plain_ms": k6["plain_ms"][k][d],
                             "cublas_chain_ms": k6["cublas_chain_ms"][k][d],
                             **k6["bounds"][k][d]}
                         for k, v in k6["ms"].items()},
            **({"one_pass_fault_outside": k6["one_pass_fault_outside"]}
               if d == "fwd" else {}),
            **({"max_rel_l2": k6["bwd_max_rel_l2"],
                "min_cosine": k6["bwd_min_cos"],
                "control_min_rel_l2": k6["control_min_rel_l2"],
                "tile_b_max_abs_err": k6["tile_b_max_abs_err"],
                "fwd_bwd_ms": k6["ms"][main_k6]["fwd_bwd"],
                "fwd_bwd_autograd_plain_ms":
                    k6["plain_ms"][main_k6]["fwd_bwd_autograd"],
                "fwd_bwd_by_shape": {
                    k: {"ms": v["fwd_bwd"],
                        "autograd_plain_ms":
                            k6["plain_ms"][k]["fwd_bwd_autograd"]}
                    for k, v in k6["ms"].items()},
                "training_curve_gaps": k6_gaps,
                "mask_edge": k6["mask_edge"]} if d == "bwd" else {})})
        kernels.append(entry)
    kernels.append({
        "name": "make_trainable_fused_block", "route": "cuda",
        "source": TRAINABLE_SOURCE[0], "replaces": TRAINABLE_SOURCE[1],
        "launches": unet_train["launches"]["fused_gn_silu_conv3"],
        "max_abs_err": k5t["max_abs_err"],
        "max_err_of_max_y": k5t["max_err_rel"],
        "control_min_err_of_max_y": k5t["control_min_rel"],
        "gradients": "bit-equal to autograd of the plain chain",
        "ms": k5t["ms"], "plain_ms": k5t["plain_ms"],
        "ms_is": f"forward + backward, the 82 chains of a B={UNET_BATCH} "
                 "step"})
    for k in kernels:
        if "bound_ms" not in k:
            k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k["library_ms"] = None     # no one PyTorch call computes any of them
    print(json.dumps({"kernels": kernels, "card": card,
                      "training": {
                          "samples_per_s": train["samples_per_s"],
                          "call_s": train["call_s"],
                          "first_loss_gap": train["first_gap"],
                          "step_ms": train["split_ms"],
                          "busy": train["busy"],
                          "launches": train["launches"]},
                      "unet_training": unet_train,
                      "served": {"two_stage_v5": served2, "v4": served4},
                      "bundles": bundles, "rollouts": rollouts,
                      "bench_server": server, "streaming": stream,
                      "phase_seconds": seconds}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
