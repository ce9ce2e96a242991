#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (climsim_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]
(--zoo-first-seeds 0,1,2,3 builds the kernels, then only reads the
zoo's first-loss gaps of phase 12 at those seeds, and exits;
--data-parallel-only builds them and runs phase 13 alone;
--dp-gap-seeds 0,1,2,3 builds them, then only runs 13b at those seeds
with no bound on its float32 gaps, prints them, and exits;
--distribution-only runs phase 14 alone; --model-axis-seeds and
--shrink-gap-seeds read 14a's and 14b (iii)'s gaps at several seeds;
--ft-gap-seeds reads 6f's K = 2 gaps at several seeds, the gates held
and not, with no bound; --scripts-only runs phase 15 alone.)

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
6f. Fine-tuning through the rollout (train/rollout_ft.py): kernels 1 and
   4 under autograd at v5 B = 7 and 384 -- the forward bit-equal to the
   plain version (kernel 4 within HEAD_TOL, bit-equality printed), the
   input gradients bit-equal to autograd of the plain chain, and the bare
   launch (F4, planted: no grad_fn) failing that check; the no-grad
   path's host cost a call (phases 3 and 5) printed beside the reading
   taken when kernels 1 and 4 were redesigned (PERF.md section 6).  Then
   the full-width U-Net v5 (the unet_v5 preset with fused_gn_conv=True,
   the porter's weights from --seed as in 6) through make_wrapper at 384
   columns, against online_eval's oracle under its balanced Newtonian
   forcing: at K = 2, with cuDNN off and deterministic algorithms,
   remat=True and remat=False bit-equal (loss and every gradient, peak
   memory of each printed); at --seed and the FT_CHECK_SEEDS - 1 seeds
   after it (weights and IC), the kernel path's gradients bit-equal to
   those with kernels 1 and 4 as their plain versions (kernel 5 and 5''s
   backward kernel kept), which F4 planted in kernel 1 alone must fail,
   and within FT_GRAD_TOL (rel-L2 over all parameters) of the all-plain
   path's (kernel 5 plain too, 5''s backward autograd of the plain chain)
   with the rollout's gates held to the kernel path's and out_conv.bias's
   gradient taken before its bf16 rounding, which F4 planted in both
   kernels must fail; then FT_UPDATES
   make_finetune_step updates at K = FT_K through HybridDriver(remat=True):
   ms an update (CUDA events), peak memory, 5''s backward's share of the
   update (CUDA events around each of its calls), the losses, the
   gradient's global norm (finite, nonzero; every leaf but one nonzero),
   and the launches an update of kernels 1, 4 and 5 and of 5''s backward
   kernel each equal to the code's count (2 K, 2 K, 82 x 2 K: the forward
   and the recompute, and 82 K).  Then the
   entry itself: python -m climsim_tpu_torch.online_eval's main at its
   default width (64 channels, batch 1024, 384 columns) with the cuts of
   ENTRY_ARGS (printed as a list against the defaults): it must reach its
   report, launch kernels 1 and 4 once a step of the hybrid rollout (phase
   6 of the entry) and 2 K times a fine-tune update; each of its phases'
   seconds and launches is printed.
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
   make_trainable_fused_block, its backward the kernel
   fused_gn_silu_conv3_bwd) at every fused chain shape of the unet_v5
   training step, GN_RAGGED and GN_STEPPED, B = 16 and 1024: the forward
   within GN_TOL of the plain forward (the float32 control must fail),
   every gradient within GN_BWD_TOL (rel-L2 and cosine) of autograd of the
   plain chain (cuDNN off in that check only: its convolutions are not
   reproducible), the control without the bf16 roundings of g, dxn and dw
   failing on dx and dw, dw with its taps swapped (planted) failing, two
   runs of the backward kernel bit-equal, one launch of each kernel a
   call; then, at B = 1024 and each chain shape, the backward kernel timed
   beside its bound, its plain version, autograd of the plain chain with
   cuDNN on (the recompute it replaced) and aten.convolution_backward on
   bf16 operands (a cuDNN yardstick of the conv part alone), and forward
   + backward beside autograd of the plain chain.
11. This slice's main path: trains the full-width U-Net v5 (the unet_v5
   preset with fused_gn_conv=True, flax-layout weights from --seed moved
   across by port_flax_unet) through unet_trainer and
   DeviceResidentLoader at B = 1024 for UNET_EPOCHS epochs
   (bench_unet_train's core).  The first loss on 16 rows must match the
   CPU's within UNET_FIRST_LOSS_TOL, the loss be finite and fall, and kernels
   1 and 5 and 5''s backward kernel have been launched once a step and
   once a fused chain a step (kernel 5 twice under remat_blocks); then the
   plain arm is timed beside it, a step of each is split by torch.profiler
   (5''s backward, under its range, apart), peak memory is read, and 30
   steps through the kernels (at UNET_CURVE_BATCH rows) follow the same
   trainer with the plain chain, forward and backward (autograd of it, no
   kernel launched): the losses within
   UNET_CURVE_TOL, the parameters' moves within UNET_MOVE_TOL, which a
   planted fault (dw dropped in 5''s backward) must fail.
12. The NeurIPS'23 zoo through python -m climsim_tpu_torch.run's
   run_experiment on the card: mlp_v1, mlp_v2, cnn_v1, ed_v1, hsr_v1,
   rpn_v1 and cvae_v1, each at its published widths and batch, and a
   3-seed hsr_v1 (train.seeds), each on ZOO_STEPS synthetic training
   batches and one validation batch an epoch, ZOO_EPOCHS epochs (HSR 6:
   2 of its MSE stage, 4 of its NLL stage).  A flax-layout parameter
   tree drawn from --seed is moved across by the model's porter; the
   first loss on ZOO_FIRST_ROWS rows from it must match the CPU's within
   ZOO_FIRST_LOSS_TOL (cnn_v1: ZOO_CNN_FIRST_LOSS_TOL, and its float32
   path within ZOO_CNN_FLOAT32_TOL; the readings they rest on:
   --zoo-first-seeds).
   Kernel 1 must be bit-equal to its plain version, under the preset's
   own TransformConfig, on the run's first training batch as its loader
   draws it (the RPN's 32 x 3072 bootstrap rows as one (E * B, D)
   block), its first validation batch, the first-loss rows and the
   sample rows.  The single models' runs start from the porter's tree by
   the warm restart (train.restart_path); the RPN ensemble and the
   replicas from their recipes' initialization, drawn from --seed
   (replica k from --seed + k).  Every epoch's losses must be finite,
   the last training loss below the first (HSR: in each stage), and
   kernel 1 have been launched exactly once a training step and once a
   validation batch of each replica (no other kernel).  HSR's and the
   cVAE's samples and the RPN's posterior on ZOO_SAMPLE_ROWS rows must
   be finite (B, D_out, S), scored by eval.metrics.crps.  Prints each
   preset's ms a step and samples/s (fit's median epoch), its peak
   memory and seconds; then bench_cnn's table (406 channels against
   384 and 512, dropout off, float32 convolutions; CUDA events).
13. Data-parallel training, the HPO sweep and the profiling helpers
   (parallel.mesh, train.step's rules, train.step_shardmap,
   DistributedCheckpointer, run_hpo_sweep, utils.profiling):
   a. a 1-rank NCCL group: mlp_v1 at its published widths and batch
      (3072) for DP_STEPS steps through the DDP step and the explicit
      all-reduce step, and unet_v5 (fused_gn_conv, B = 1024, cuDNN off)
      for DP_UNET_STEPS through the DDP step, each bit-equal to the step
      without rules (losses, every parameter); kernel 1 once a step,
      kernel 5 82 times a U-Net step.
   b. DP_RANKS processes sharing the card over gloo (NCCL refuses two
      ranks on one GPU), each python -m climsim_tpu_torch.run's
      run_experiment for mlp_v1 (published widths, DP_STEPS steps, one
      validation batch) at train.num_data_shards = DP_RANKS, at the
      preset's bf16 compute and then at float32: the ranks' losses and
      weights equal; at bf16 every step's loss, the validation loss and
      the weights bit-equal to 1 process taking each step as DP_RANKS
      micro-batches (the ranks' sums, in their order); at float32 the
      first step's loss within DP_RTOL and every step's and the
      validation loss within DP_RUN_RTOL of the plain 1-process run's
      (DP_RTOL says why they grow); the checkpoint the ranks wrote at
      bf16 (DistributedCheckpointer) restored here at world size 1,
      bit-equal to rank 0's live state; kernel 1 once a step and
      validation batch on each rank and run; ms a step at 1 process in
      micro-batches and at DP_RANKS ranks (two ranks on one card: not a
      scaling figure).
   c. run_hpo_sweep on the card: HPO_TRIALS trials, HPO_WORKERS worker
      processes, the victim SIGKILLed holding a claim, a stale timeout of
      HPO_STALE_S s: every trial has a result, a claim_N.retryK takeover
      completed, Hyperband and retrain_best finite, each trial's kernel 1
      launches (steps + 1) summed into the tally; its seconds.
   d. cost_analysis of the mlp_v1 step (StepInfo, on a copy of the
      state) within FLOP_TOL of 6 B sum(in out) - 2 B in_0 out_0; the
      unet_v5 forward (B = 384) through kernel 5's registered formula,
      its share equal to the 82 chains' 2 B L C Cout 3, the total within
      FLOP_TOL of the plain model's count, printed beside the count
      without the formula; trace writes a file; time_fn's median.
14. The rest of distribution (parallel.mesh's model axis, train.elastic,
   CouplingServer(rules=...)); P14_RANKS processes of this script share
   the card over gloo (--p14-rank), started once for all their parts:
   a. rpn_v1 (32 members, published widths, B = 3072) over a (1, 2)
      mesh, P14_EPOCHS epochs of P14_STEPS steps: 16 members and half the
      parameter bytes a rank; every rank's gathered (E,) step losses,
      eval_losses and a posterior, and the members' parameters, against
      the 1-process run within MODEL_AXIS_TOL (gaps printed); a 2-seed
      mlp_v1 multiseed over (1, 2) bit-equal to 1 process; kernel 1 once
      a step on every rank.
   b. elastic: (i) elastic_fit of mlp_v1 in this process, a DeviceFailure
      at epoch 1, step 1, bit-equal to the uninterrupted run; (ii)
      torch.distributed.run --standalone --nproc-per-node 1
      --max-restarts 1 over NCCL, the worker (--elastic-worker) failing
      on attempt 0 only, restarted and resumed from its DCP checkpoint,
      bit-equal to (i)'s uninterrupted run, the failure-to-first-step
      seconds printed; (iii) the ranks' run failing after epoch 0's
      checkpoint, relaunched here at world 1, bit-equal to the composed
      run (the clean ranks' epoch-0 checkpoint resumed here), its epoch
      losses within SHRINK_RTOL of the uninterrupted 2-rank run; (iv)
      elastic_rpn_fit over (1, 2), failing after epoch 0, resumed here on
      (1, 1) against 14a's 1-process run.
   c. CouplingServer(rules=...) of the full MLP_v2rh bf16 and int8 on a
      1-rank NCCL group here and on the 2 gloo ranks (rank 0 serves,
      rank 1 follows): 3 concurrent 384-column chunks, a ragged 50-row
      request, P14_SERVED sequential ones; every reply bit-equal to the
      direct wrapper call, buckets divisible by the world size, kernels
      1-3 launched on every rank; round trips at p50 and p99 beside the
      unsharded server's.
15. The last five JAX scripts as port entries, on the card at the
   scripts' widths and batches, cut in rows and epochs only:
   a. python -m climsim_tpu_torch.run_all_baselines's main (SCRIPTS_
      TRAIN_ROWS training rows, SCRIPTS_EPOCHS epochs): every loss finite,
      MLP's, HSR's (over its NLL stage) and the RPN's falling, every table
      entry finite, the resident loader's epoch runner taken by MLP, ED,
      CNN and cVAE, kernel 1 launched exactly once a training step and a
      prediction or sample batch (no other kernel);
   b. make_offline_figures (FIGURES_DAYS day of scoring rows): its arrays
      finite, kernel 1 as in a (the figures drawn where matplotlib is);
   c. run_real_baselines on a REAL_PAIRS-pair synthetic netCDF tree of
      384 columns (data.synthnc): the report with BASELINE.md's columns,
      kernel 1 as in a;
   d. bench_ingest --pairs INGEST_PAIRS (host only, no launch);
   e. bench_all's rows: MLP, ED, HSR and cVAE at one resident epoch of
      their pools, the RPN (32 x 3072) at one epoch of its pool, CNN and
      U-Net v5 at their batch of 4096 from a pool of two batches; each
      row's JSON, the MLP's FLOPs within FLOP_TOL of its Dense layers' count,
      every MFU in (0, 1], kernel 1 once a step (warm-up, timed and the
      counted step).
16. With --profile, prints the fused MLPs' plans and traces the served
   paths (MLP bf16 and int8, U-Net v5, two-stage v5, v4) with
   torch.profiler (device time per kernel and copy, the card's busy
   share, kernel 5's share of it, the costliest host ops).
17. Prints one JSON line of the kernels' results (each with its bound:
   the larger of its bytes over the memory rate and its operations over
   the peak, at the timed shape; the launches include 6d's rollouts,
   6f's updates and entry, 12's zoo and 13's, 14's and 15's runs, the
   ranks', the agent's worker's and the HPO workers' among them) and the
   paths' results (6d's under "rollouts", 6f's under "finetune" and
   "online_eval", 12's under "zoo", 13's under "data_parallel", 14's
   under "distribution", 15's under "scripts"), then, last,
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
import math
import os
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
# the plain Conv1d calls of that forward (8 k = 3, 33 1x1), on bf16
# tensor cores on the card (models.unet.CONV_CALLS)
UNET_PLAIN_CONVS = 41
GN_ROWS = (1, 7, 50, 384, 1024)
GN_TIMED_ROWS = (384, 1024)
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
# 5': its forward is kernel 5, its backward the backward kernel
TRAINABLE_SOURCE = ("climsim_tpu_torch/ops/unet_fused.py:614",
                    "climsim_tpu/ops/unet_fused.py:160")
BWD_SOURCE = ("climsim_tpu_torch/ops/csrc/fused_gn_silu_conv3_bwd.cu",
              "climsim_tpu/ops/unet_fused.py:194")
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
GRADS5 = ("dx", "dgamma", "dbeta", "dw", "db")
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
# 30 steps through kernel 5 and 5''s backward kernel against the same
# trainer with the plain chain, forward and autograd of it (no kernel), at
# UNET_CURVE_BATCH rows a step (a plain step at B = 1024 takes 1.6 s on an
# H100).  The losses, relative, a step at a time: UNET_CURVE_TOL[0] over
# the first UNET_CURVE_EARLY steps, UNET_CURVE_TOL[1] after.  The loss
# hardly depends on the fused chains' parameters in 30 steps: on an H100
# the kernels' curve was 1.3e-5 / 1.0e-5 from the plain chain's (1.0e-5 /
# 2.3e-5 with kernel 5 alone), and with the chains' weight gradients
# dropped only 1.5e-4 / 1.0e-4.  So the parameters' moves over the 30
# steps are compared too, rel-L2 over all of them, within UNET_MOVE_TOL:
# the kernels' were 3.7e-3 from the plain chain's (3.6e-3 with kernel 5
# alone), and the planted fault's, dw dropped in 5''s backward (the 82
# chains' conv kernels do not learn), 0.83.  2e-2 also catches a fault as
# small as the norms' scales frozen, about (20k / 21M) ** 0.5 of the
# moves.
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
    from climsim_tpu_torch.bench_gn_conv3 import (GN_RAGGED, GN_STEPPED,
                                                  chain_args,
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
    unet_v5 step, GN_RAGGED and GN_STEPPED, B in TRAINABLE_ROWS: the
    forward against the plain forward on the bf16-rounded weight within
    GN_TOL (the float32 control must fail); every gradient of its
    backward kernel against autograd of the plain chain (cuDNN off here
    only) within GN_BWD_TOL, the control without the bf16 roundings of g,
    dxn and dw failing on dx and dw, dw's taps swapped (a planted fault)
    failing, two runs of the kernel bit-equal; one launch of each kernel a
    call.  Then, at B = 1024 and each chain shape, the backward timed
    beside its bound, its plain version, autograd of the plain chain with
    cuDNN on (the path the kernel replaced) and aten.convolution_backward
    on bf16 operands (cuDNN: a yardstick of the conv part alone, not the
    same function), and forward + backward beside autograd of the plain
    chain, weighted by each shape's count in a step."""
    from climsim_tpu_torch.bench_gn_conv3 import (GN_BWD_TOL, GN_RAGGED,
                                                  GN_STEPPED, autograd_plain,
                                                  chain_args,
                                                  chain_bwd_bound_ms,
                                                  conv_yardstick)

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    res = {"max_abs_err": 0.0, "max_err_rel": 0.0, "control_min_rel": 1e9,
           "bwd_max_abs_err": 0.0,
           "bwd_max_rel_l2": dict.fromkeys(GRADS5, 0.0),
           "bwd_min_cos": dict.fromkeys(GRADS5, 1.0),
           "control_min_rel_l2": {"dx": 1e9, "dw": 1e9},
           "fault_min_rel_l2": 1e9}
    bf16 = torch.bfloat16
    # Reproducible convolutions for the reference: cuDNN's were not on an
    # H100, even with deterministic set (two runs of the plain chain's
    # autograd gave different weight gradients at L=64 C=256 Cout=128
    # B=1024), so this check sets deterministic and turns cuDNN off, and
    # the convolutions run as PyTorch's own im2col and cuBLAS products.
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.enabled
    cudnn.deterministic, cudnn.enabled = True, False
    try:
        K.reset_launches()
        calls = bwd_calls = 0
        for (l, c, cout) in (*UNET_CHAINS, *GN_RAGGED, GN_STEPPED):
            f = PU.make_trainable_fused_block(PU._num_groups(c))
            for b in TRAINABLE_ROWS:
                at = f"5' L={l} C={c} Cout={cout} B={b}"
                a = chain_args(torch, g, b, l, c, cout, wdtype=torch.float32)
                cot = torch.randn(b, l, cout, device="cuda", generator=g)
                ins = [t.clone().requires_grad_() for t in a]
                y = f(*ins)
                got = torch.autograd.grad(y, ins, cot)
                calls += 1
                bwd_calls += 1
                ref_ins = [t.clone().requires_grad_() for t in a]
                want = torch.autograd.grad(PU.xla_gn_silu_conv3_plain(
                    *ref_ins, bf16, f32_accum=False), ref_ins, cot)
                for name, x, w in zip(GRADS5, got, want):
                    require(x.dtype == torch.float32 and x.shape == w.shape
                            and x.is_contiguous(),
                            f"{at} {name}: {x.dtype} {tuple(x.shape)} "
                            f"{x.stride()}")
                    r, cs = rel_l2(x, w), cosine(x, w)
                    res["bwd_max_rel_l2"][name] = max(
                        res["bwd_max_rel_l2"][name], r)
                    res["bwd_min_cos"][name] = min(res["bwd_min_cos"][name],
                                                   cs)
                    res["bwd_max_abs_err"] = max(
                        res["bwd_max_abs_err"], float((x - w).abs().max()))
                    require(r <= GN_BWD_TOL[0] and cs >= GN_BWD_TOL[1],
                            f"{at}: {name} rel-L2 {r:.3e} cosine {cs:.9f} "
                            f"from autograd of the plain chain (bound "
                            f"{GN_BWD_TOL})")
                wb = a[3].to(bf16)
                again = PU.fused_gn_silu_conv3_bwd(*a[:3], wb, a[4], cot)
                bwd_calls += 1
                require(all(torch.equal(x, z) for x, z in zip(got, again)),
                        f"{at}: two runs of the backward kernel differ")
                ctl = PU.fused_gn_silu_conv3_bwd_plain(*a[:3], wb, a[4], cot,
                                                       rounded=False)
                for i, name in ((0, "dx"), (3, "dw")):
                    r = rel_l2(ctl[i], want[i])
                    res["control_min_rel_l2"][name] = min(
                        res["control_min_rel_l2"][name], r)
                    require(r > GN_BWD_TOL[0], f"{at}: the control without "
                            f"the bf16 roundings passes on {name} ({r:.3e})")
                r = rel_l2(got[3].flip(0), want[3])
                res["fault_min_rel_l2"] = min(res["fault_min_rel_l2"], r)
                require(r > GN_BWD_TOL[0], f"{at}: dw with its taps swapped "
                        f"passes ({r:.3e})")
                plain = PU.xla_gn_silu_conv3_plain(*a[:3], wb, a[4])
                scale = float(plain.abs().max())
                err = float((y.detach() - plain).abs().max())
                ctl = float((PU.xla_gn_silu_conv3_plain(*a) - plain).abs()
                            .max())
                require(err <= GN_TOL * scale, f"{at}: forward "
                        f"{err / scale:.3e} of max|y|")
                require(ctl > GN_TOL * scale, f"{at}: the float32 control "
                        "passes")
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["max_err_rel"] = max(res["max_err_rel"], err / scale)
                res["control_min_rel"] = min(res["control_min_rel"],
                                             ctl / scale)
        torch.cuda.synchronize()
        res["launches"] = K.LAUNCHES["fused_gn_silu_conv3"]
        res["bwd_launches"] = K.LAUNCHES["fused_gn_silu_conv3_bwd"]
        require(res["launches"] == calls, f"5': {res['launches']} launches "
                f"in {calls} calls")
        require(res["bwd_launches"] == bwd_calls, f"5' backward: "
                f"{res['bwd_launches']} launches in {bwd_calls} calls")
    finally:
        cudnn.deterministic, cudnn.enabled = saved
    n_shapes = len(UNET_CHAINS) + len(GN_RAGGED) + 1
    print(f"  5' at {n_shapes} shapes x B={TRAINABLE_ROWS}: forward max "
          f"{res['max_err_rel']:.3e} of max|y| (control min "
          f"{res['control_min_rel']:.3e}); backward kernel against autograd "
          f"of the plain chain (bound {GN_BWD_TOL}): rel-L2 " + ", ".join(
              f"{n} {v:.3e}" for n, v in res["bwd_max_rel_l2"].items())
          + "; cosine " + ", ".join(
              f"{n} {v:.9f}" for n, v in res["bwd_min_cos"].items())
          + f"; the control without the roundings at least "
          f"{res['control_min_rel_l2']['dx']:.3e} (dx) "
          f"{res['control_min_rel_l2']['dw']:.3e} (dw); dw's taps swapped "
          f"at least {res['fault_min_rel_l2']:.3e}; two runs bit-equal; "
          f"{calls} forward and {bwd_calls} backward launches", flush=True)

    keys = ("bwd", "bwd_plain", "bwd_autograd", "yardstick", "bound",
            "fwd_bwd", "fwd_bwd_autograd")
    tot, per_shape = dict.fromkeys(keys, 0.0), {}
    for (l, c, cout), n in UNET_CHAINS.items():
        a = chain_args(torch, g, UNET_BATCH, l, c, cout)
        cot = torch.randn(UNET_BATCH, l, cout, device="cuda", generator=g)
        af = [t.detach().clone().requires_grad_()
              for t in (*a[:3], a[3].float(), a[4])]
        f = PU.make_trainable_fused_block(PU._num_groups(c))
        t = {"bwd_plain": time_ms(
                 torch, lambda: PU.fused_gn_silu_conv3_bwd_plain(*a, cot),
                 3),
             "bwd": time_ms(torch, lambda: PU.fused_gn_silu_conv3_bwd(
                 *a, cot), 10),
             "bwd_autograd": time_ms(
                 torch, lambda: autograd_plain(torch, PU, *a, cot), 2),
             "yardstick": time_ms(torch, conv_yardstick(
                 torch, PU, *a[:4], cot), 10),
             "bound": chain_bwd_bound_ms(UNET_BATCH, l, c, cout)[0]}
        t["fwd_bwd"], t["fwd_bwd_autograd"] = compare_timed(
            torch, lambda: torch.autograd.grad(f(*af), af, cot),
            lambda: torch.autograd.grad(PU.xla_gn_silu_conv3_plain(
                *af, bf16, f32_accum=False), af, cot), 2)
        per_shape[f"L={l} C={c} Cout={cout}"] = {"calls": n, **t}
        for k in keys:
            tot[k] += n * t[k]
        del a, af, cot
    ops = sum(n * 2 * 2 * UNET_BATCH * l * 3 * c * cout
              for (l, c, cout), n in UNET_CHAINS.items())
    res.update({"bwd_ms": tot["bwd"], "bwd_plain_ms": tot["bwd_plain"],
                "bwd_autograd_plain_ms": tot["bwd_autograd"],
                "cudnn_bf16_yardstick_ms": tot["yardstick"],
                "bwd_bound_ms": tot["bound"],
                "bwd_bound_by": "bytes" if tot["bound"] > 1e3 * ops / (
                    PEAK_OPS_S["bf16"]) else "operations",
                "ms": tot["fwd_bwd"], "plain_ms": tot["fwd_bwd_autograd"],
                "bwd_per_shape": per_shape})
    print(f"  5' backward, the 82 chains of a B={UNET_BATCH} step: kernel "
          f"{tot['bwd']:.3f} ms (bound {tot['bound']:.3f} ms, "
          f"{res['bwd_bound_by']}; kernel at {tot['bound'] / tot['bwd']:.1%}"
          f"); plain version {tot['bwd_plain']:.3f} ms; autograd of the "
          f"plain chain, cuDNN on {tot['bwd_autograd']:.3f} ms; "
          f"aten.convolution_backward on bf16 (yardstick) "
          f"{tot['yardstick']:.3f} ms; forward + backward {tot['fwd_bwd']:.3f}"
          f" ms against autograd of the plain chain "
          f"{tot['fwd_bwd_autograd']:.3f} ms", flush=True)
    for k, v in per_shape.items():
        print(f"    {k} x{v['calls']}: " + " ".join(
            f"{n} {v[n]:.4f}" for n in keys) + " ms", flush=True)
    return res


def unet_split(torch, PU, tr, batches, steps=2):
    """torch.profiler over ``steps`` train steps: device time a step by
    part -- kernel 5, the 5' backward (everything under its range: the
    backward kernel on the fused arm), convs and GEMMs outside it, Adam,
    kernel 1, the rest -- and the busy share."""
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
        if "gn_bwd_" in key:
            return "5' backward"
        if "transform_kernel" in key:
            return "kernel 1"
        if "adam" in key or "multi_tensor" in key:
            return "Adam"
        if any(s in key for s in ("gemm", "conv", "cutlass", "xmma", "cudnn",
                                  "fft", "region_transform", "sm90",
                                  "implicit", "grad", "nvjet")):
            return "convs and GEMMs"
        return "other"

    # every kernel and copy from the device's own events (kernels 1 and 5
    # are launched through ctypes, under no torch op), not the ranges that
    # mirror record_function on the device's timeline; 5''s backward is
    # what ran under its range, taken out of the other parts
    parts = dict.fromkeys(("kernel 5", "5' backward",
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
                parts["5' backward"] += t
    busy = sum(parts.values())
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device {t / steps:9.3f} ms/step {name[:100]}")
    # one stream: the device's work cannot outlast the wall clock
    require(busy <= 1.02 * wall_ms, f"the split counts {busy:.1f} ms of "
            f"device time in {wall_ms:.1f} ms")
    return {k: v / steps for k, v in parts.items()}, busy / wall_ms


def plain_chain_bwd(torch, PU):
    """A stand-in for ``PU.fused_gn_silu_conv3_bwd`` that launches no
    kernel: 5''s backward as autograd of the plain chain
    (``bench_gn_conv3.autograd_plain``), the reference of an all-plain
    run."""
    from climsim_tpu_torch.bench_gn_conv3 import autograd_plain

    def bwd(x, gamma, beta, w, b, g):
        with torch.enable_grad():
            return autograd_plain(torch, PU, x, gamma, beta, w, b, g)
    return bwd


def train_unet(torch, K, PU, unet_flax_tree_fn, seed):
    """The slice's main path: the full-width U-Net v5 (unet_v5 preset,
    fused_gn_conv=True) through unet_trainer and DeviceResidentLoader at
    B = 1024 (bench_unet_train's core), its first loss on 16 rows against
    the CPU's, UNET_CURVE_STEPS steps against the plain chain (forward
    and backward) and a planted fault, the plain arm timed beside it, a profile of a step,
    and peak memory."""
    from climsim_tpu_torch import bench_unet_train as BU
    from climsim_tpu_torch.models import unet
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
    unet.reset_conv_calls()
    res = throughput(tr, loader, 1, UNET_EPOCHS - 1)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    convs = dict(unet.CONV_CALLS)
    steps = UNET_EPOCHS * loader.steps_per_epoch
    losses = res["epoch_loss"]
    peak = {"fused": torch.cuda.max_memory_allocated()}
    print(f"  launches in the training run ({steps} steps): {launches}; "
          f"Conv1d calls by path: {convs}", flush=True)
    require(convs == {"tensor_core": UNET_PLAIN_CONVS * steps, "float32": 0},
            f"Conv1d calls by path in {steps} steps: {convs}, want "
            f"{UNET_PLAIN_CONVS} a step on tensor cores")
    require(launches["fused_gn_silu_conv3"] == n_chains * steps,
            f"kernel 5 launched {launches['fused_gn_silu_conv3']} times in "
            f"{steps} steps of {n_chains} fused chains")
    require(launches["fused_gn_silu_conv3_bwd"] == n_chains * steps,
            f"5''s backward kernel launched "
            f"{launches['fused_gn_silu_conv3_bwd']} times in {steps} steps "
            f"of {n_chains} fused chains")
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
    require(K.LAUNCHES["fused_gn_silu_conv3_bwd"] == n_chains,
            f"remat step: the backward kernel launched "
            f"{K.LAUNCHES['fused_gn_silu_conv3_bwd']} times, want {n_chains}")

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
    # the kernels, the plain chain (its forward and autograd of it, no
    # kernel 5 and no backward kernel), and the planted fault (dw dropped
    # in 5''s backward), which must fail the curve bound
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
    require(K.LAUNCHES["fused_gn_silu_conv3"] == n_chains * UNET_CURVE_STEPS
            and K.LAUNCHES["fused_gn_silu_conv3_bwd"]
            == n_chains * UNET_CURVE_STEPS,
            "the kernel curve did not launch kernel 5 and the backward "
            "kernel in every chain")
    backward = PU._TrainableBlock.backward
    real_bwd = PU.fused_gn_silu_conv3_bwd
    try:
        PU.fused_gn_silu_conv3 = PU.xla_gn_silu_conv3_plain
        PU.fused_gn_silu_conv3_bwd = plain_chain_bwd(torch, PU)
        K.reset_launches()
        want, move_p = curve()
        require(K.LAUNCHES["fused_gn_silu_conv3"] == 0
                and K.LAUNCHES["fused_gn_silu_conv3_bwd"] == 0,
                "the plain curve launched kernel 5 or the backward kernel")
        PU.fused_gn_silu_conv3 = kernel_fn
        PU.fused_gn_silu_conv3_bwd = real_bwd

        def no_dw(ctx, g):
            dx, dgamma, dbeta, _, *rest = backward(ctx, g)
            return (dx, dgamma, dbeta, None, *rest)

        PU._TrainableBlock.backward = staticmethod(no_dw)
        fault, move_f = curve()
    finally:
        PU.fused_gn_silu_conv3 = kernel_fn
        PU.fused_gn_silu_conv3_bwd = real_bwd
        PU._TrainableBlock.backward = backward

    def gaps(c):
        d = [abs(a - b) / abs(b) for a, b in zip(c, want)]
        return max(d[:UNET_CURVE_EARLY]), max(d[UNET_CURVE_EARLY:])

    gap_k, gap_f = gaps(got), gaps(fault)
    upd_k, upd_f = rel_l2(move_k, move_p), rel_l2(move_f, move_p)
    print(f"U-Net v5 curve, {UNET_CURVE_STEPS} Adam steps at "
          f"B={UNET_CURVE_BATCH}: kernel {got[0]:.6f} -> {got[-1]:.6f}, plain "
          f"chain {want[0]:.6f} -> {want[-1]:.6f}; largest gap to the "
          f"plain curve in the first {UNET_CURVE_EARLY} steps and after "
          f"(tolerance {UNET_CURVE_TOL}): kernel {gap_k[0]:.3e} "
          f"{gap_k[1]:.3e}, dw dropped {gap_f[0]:.3e} {gap_f[1]:.3e}; the "
          f"parameters' moves against the plain chain's, rel-L2 "
          f"(tolerance {UNET_MOVE_TOL}): kernel {upd_k:.3e}, dw dropped "
          f"{upd_f:.3e}", flush=True)
    print("  curves: " + json.dumps({"kernel": got, "plain": want,
                                     "fault": fault}), flush=True)
    require(all(np.isfinite(got)) and got[-1] < got[0],
            f"the kernel curve did not fall: {got}")
    require(gap_k[0] <= UNET_CURVE_TOL[0] and gap_k[1] <= UNET_CURVE_TOL[1],
            f"the kernel's curve is {gap_k} from the plain chain's")
    require(upd_k <= UNET_MOVE_TOL, f"the kernel's parameters moved "
            f"{upd_k:.3e} (rel-L2) from the plain chain's")
    require(upd_f > UNET_MOVE_TOL, f"with dw dropped the parameters moved "
            f"within {UNET_MOVE_TOL} of the plain chain's ({upd_f:.3e})")
    return {"samples_per_s": sps, "step_ms": step_ms, "epoch_walls": walls,
            "main_path_epoch_s": res["call_s"], "epoch_loss": losses,
            "first_loss_gaps": first_gaps, "peak_mem_bytes": peak,
            "launches": launches, "conv_calls": convs, "steps": steps,
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

# phase 6f: fine-tuning through the rollout
FT_GRAD_ROWS = (7, 384)   # kernels 1 and 4 under autograd, v5
FT_COLS = 384
FT_K = 16                 # online_eval's --ft-k default
FT_UPDATES = 2
FT_SPIN = 24              # oracle steps from the synthetic columns to the IC
FT_CHECK_K = 2            # the remat and all-plain checks' horizon
FT_CHECK_SEEDS = 4        # the K = 2 checks at --seed and the 3 after it
# the kernel path's gradients against the all-plain path's, rel-L2 over
# all parameters at K = FT_CHECK_K: kernel 5's forward rounds to bf16 as
# the plain chain does, but its float32 statistics differ in the last
# bits, so a rounding flips now and then and moves the gradients.  Two
# such flips are discrete, and the measure takes them out: a gate of the
# rollout (a species' floor at 0, the liquid fraction's ramp) that passes
# the gradient in one path and not the other, so the all-plain path runs
# with the kernel path's gates held (RolloutGates); and the bf16 rounding
# of out_conv.bias's gradient, which carries 23-45% of the squared
# gradient, so one rounding step of one of its 13 elements alone reads
# ~1.8e-3, so out_conv.bias's gradient is taken before that rounding (its
# float64 sum of the gradient at out_conv's output, which autograd's
# rounded one equals bit for bit).  On an H100 (cuDNN off, deterministic:
# the same bits every run) seeds 0-7 read 2.7e-4-7.0e-4 so (7.0e-4 at
# seed 0); as autograd gives them 2.5e-4-1.8e-3, the 1.8e-3 (seed 0) one
# rounding step of out_conv.bias's and the 1.3e-3 (seed 4) three floors
# flipped.  F4 planted in both kernels reads 1.0.  F4 planted in kernel 1
# alone reads 8.0e-4-2.6e-3 (the gradient through the state's features
# is a small share at K = 2), too near to be told apart here: the check
# against kernels 1 and 4's plain versions with kernel 5 kept, bit-equal,
# is the one it fails.
FT_GRAD_TOL = 1.2e-3
# the wrappers' host cost a call at B = 384 read when kernels 1 and 4 were
# redesigned for Hopper (PERF.md section 6): the no-grad path must keep it
REDESIGN_HOST_MS = {"fused_input_transform": 0.0162,
                    "fused_constraint_head": 0.0188}
# python -m climsim_tpu_torch.online_eval on the card: the script's own
# smoke geometry (scripts/online_eval.py:61), a hundred train steps,
# one DAgger round, two fine-tune updates at K = 16, a one-day spin-up
ENTRY_ARGS = ["--steps", "216", "--window", "72", "--train-steps", "100",
              "--chunk", "20", "--dagger-rounds", "1", "--dagger-steps",
              "20", "--dagger-collect", "144", "--ft-steps", "2", "--ft-k",
              "16", "--spinup-days", "1"]


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


def kernel_grad_checks(torch, K, T, PW, stats5, grid, seed, io, head):
    """Kernels 1 and 4 under autograd (ops.kernels._InputTransformGrad,
    _ConstraintHeadGrad) at v5 B in FT_GRAD_ROWS: the forward bit-equal to
    the plain version (kernel 4 within HEAD_TOL, bit-equality printed),
    the input gradients bit-equal to autograd of the plain chain, and the
    bare launch (F4: its output handed back with no grad_fn) failing that
    check.  Prints the no-grad path's host cost a call (``io``, ``head``:
    phases 3 and 5) beside the redesign's (REDESIGN_HOST_MS)."""
    from climsim_tpu_torch import get_varspec
    from climsim_tpu_torch.data.synthetic import synthetic_inputs

    spec4, spec5 = get_varspec("v4"), get_varspec("v5")
    consts = T.input_transform_consts(spec5, stats5, v5_transform(T), "cuda")
    hconsts = K.constraint_head_consts(stats5.out_scale, 15, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 95)

    def transform_run(fn, x, cot):
        xr = x.detach().clone().requires_grad_()
        y = fn(xr, consts)
        if y.grad_fn is None:
            return y.detach(), None
        return y.detach(), torch.autograd.grad(y, xr, cot)

    def head_run(fn, raw, yn, cot):
        xr = raw.detach().clone().requires_grad_()
        yr = yn.detach().clone().requires_grad_()
        out = fn(yr, xr[:, 0:60], xr[:, 120:180], xr[:, 180:240], hconsts,
                 1200.0)
        if out.grad_fn is None:
            return out.detach(), None
        return out.detach(), torch.autograd.grad(out, (yr, xr), cot)

    def grads_equal(got, want):
        return got is not None and all(
            torch.equal(a, b) for a, b in zip(got, want))

    res = {"bit_equal_forward": {}, "planted_caught": True}
    real = (K._InputTransformGrad.apply, K._ConstraintHeadGrad.apply)
    for b in FT_GRAD_ROWS:
        raw = torch.from_numpy(synthetic_inputs(
            spec4, b, grid, seed=seed + 96 + b)).cuda()
        x5 = PW.convert_v4_to_v5(raw).contiguous()
        yn = torch.randn(b, 308, device="cuda", generator=g)
        c1 = torch.randn(x5.shape, device="cuda", generator=g)
        c4 = torch.randn(b, 368, device="cuda", generator=g)
        y1, g1 = transform_run(K.fused_input_transform, x5, c1)
        p1, w1 = transform_run(K.fused_input_transform_plain, x5, c1)
        require_equal(torch, f"kernel 1 under autograd B={b}", y1, p1)
        require(grads_equal(g1, w1), f"kernel 1 under autograd B={b}: the "
                "input gradient differs from autograd of the plain chain")
        y4, g4 = head_run(K.fused_constraint_head, raw, yn, c4)
        p4, w4 = head_run(K.fused_constraint_head_plain, raw, yn, c4)
        check_close(torch, "kernel 4 under autograd", y4, p4, *HEAD_TOL)
        res["bit_equal_forward"][b] = torch.equal(y4, p4)
        require(grads_equal(g4, w4), f"kernel 4 under autograd B={b}: the "
                "input gradients differ from autograd of the plain chain")
        # F4 planted: the launch handed back as it is
        try:
            K._InputTransformGrad.apply = (
                lambda x, c: K._transform_launch(x, c, c.device))
            K._ConstraintHeadGrad.apply = (
                lambda y, t, qc, qi, c, dt, lds: K._head_launch(
                    y, t, qc, qi, c, dt, lds, c.device))
            caught = (not grads_equal(transform_run(
                K.fused_input_transform, x5, c1)[1], w1)
                and not grads_equal(head_run(
                    K.fused_constraint_head, raw, yn, c4)[1], w4))
        finally:
            K._InputTransformGrad.apply, K._ConstraintHeadGrad.apply = real
        require(caught, f"F4 planted at B={b} passes the gradient check")
        print(f"  kernels 1 and 4 under autograd, v5 B={b}: kernel 1's "
              "forward and input gradient bit-equal to the plain chain's; "
              f"kernel 4's forward within HEAD_TOL (bit-equal: "
              f"{res['bit_equal_forward'][b]}), its input gradients "
              "bit-equal; F4 planted (bare launches) fails", flush=True)
    res["host_ms"] = {
        "fused_input_transform": io["times"]["v2_rh B=384"]["host_ms"],
        "fused_constraint_head": head["times"]["B=384"]["host_ms"]}
    for name, ms in res["host_ms"].items():
        print(f"  {name}: the no-grad path's host cost a call at B = 384 "
              f"{ms:.4f} ms (phase 3 / 5), at the redesign "
              f"{REDESIGN_HOST_MS[name]:.4f}",
              flush=True)
    return res


class RolloutGates:
    """The rollout's gates: every ``physics.maximum`` and ``physics.clip``
    call outside the model's forward (the species' floors in
    ``HybridDriver._advance``, the liquid fraction's ramp in the
    constraint head and in RH, the input transform's clip, the oracle's).
    While ``on``, each call's gradient mask (1 where x passes, 0.5 at a
    tie, 0 where the bound holds; the product of both ends for a clip) is
    appended to ``masks`` with the caller's name; with ``held`` set to
    another run's masks, each call keeps its value and takes the gradient
    of the held mask, call by call.  Installed by ``install``, taken out
    by ``remove``; the model's own calls (GroupNorm's variance floor) pass
    through while ``in_model``."""

    def __init__(self, torch, physics):
        self.torch, self.physics = torch, physics
        self.real = (physics.maximum, physics.clip)
        self.on = self.in_model = False
        self.masks, self.sites, self.held = [], [], None

        class Held(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, out, g):
                ctx.save_for_backward(g)
                return out.clone()

            @staticmethod
            def backward(ctx, dy):
                g, = ctx.saved_tensors
                return dy * g, None, None

        self.Held = Held

    def _gate(self, x, out, g, site):
        if not self.on or self.in_model:
            return out
        self.sites.append(site)
        self.masks.append(g.detach())
        if self.held is None:
            return out
        i = len(self.masks) - 1
        require(i < len(self.held) and self.held[i].shape == g.shape,
                f"gate {i} ({site}): the held run has no such gate")
        return self.Held.apply(x, out.detach(), self.held[i])

    def _pass(self, x, b):
        return (x > b).to(x.dtype) + 0.5 * (x == b).to(x.dtype)

    def maximum(self, x, v):
        b = self.physics._bound(x, v)
        out = self.torch.maximum(x, b)
        if not self.on or self.in_model:
            return out
        return self._gate(x, out, self._pass(x, b),
                          sys._getframe(1).f_code.co_name)

    def clip(self, x, lo, hi):
        t, bound = self.torch, self.physics._bound
        m = t.maximum(x, bound(x, lo))
        out = t.minimum(m, bound(x, hi))
        if not self.on or self.in_model:
            return out
        return self._gate(x, out, self._pass(x, bound(x, lo))
                          * self._pass(-m, -bound(x, hi)),
                          sys._getframe(1).f_code.co_name)

    def install(self):
        self.physics.maximum, self.physics.clip = self.maximum, self.clip

    def remove(self):
        self.physics.maximum, self.physics.clip = self.real

    def model(self, model, xn):
        self.in_model = True
        try:
            return model(xn)
        finally:
            self.in_model = False

    def run(self, fn, held=None):
        """fn() with the gates recorded (and held to ``held``); returns
        (fn's result, the masks, their callers)."""
        self.masks, self.sites, self.held, self.on = [], [], held, True
        try:
            out = fn()
        finally:
            self.on, self.held = False, None
        return out, self.masks, self.sites


def gate_flips(torch, got, want, sites):
    """{caller: elements whose gradient mask differs} between two runs'
    gates, call by call (the callers of ``want``'s run)."""
    require(len(got) == len(want), f"{len(got)} gates against {len(want)}")
    out = {}
    for a, b, site in zip(got, want, sites):
        n = int((a != b).sum())
        if n:
            out[site] = out.get(site, 0) + n
    return out


def finetune_phase(torch, card, K, PU, T, PW, physics, stats5, grid, seed,
                   check_seeds=None, check_only=False):
    """6f: the full-width U-Net v5 (unet_v5, fused_gn_conv=True) fine-tuned
    through HybridDriver(remat=True) against online_eval's oracle: the
    K = FT_CHECK_K checks at ``check_seeds`` (remat on / off bit-equal,
    the kernel path against the all-plain path with the rollout's gates
    held, F4 planted), then, unless ``check_only``, FT_UPDATES
    make_finetune_step updates at K = FT_K, counted and timed."""
    from climsim_tpu_torch import get_varspec
    from climsim_tpu_torch import online_eval as OE
    from climsim_tpu_torch.bench_unet_train import model_kw
    from climsim_tpu_torch.data.synthetic import synthetic_inputs
    from climsim_tpu_torch.models.unet import ClimSimUNet
    from climsim_tpu_torch.online import driver as PD
    from climsim_tpu_torch.train.rollout_ft import (make_finetune_step,
                                                    make_rollout_loss,
                                                    trajectory_stds)
    from climsim_tpu_torch.utils.migrate import port_flax_unet

    spec4, spec5 = get_varspec("v4"), get_varspec("v5")
    model = ClimSimUNet(spec5, **model_kw("fused"))
    model.load_state_dict(port_flax_unet(unet_flax_tree(model, seed), model))
    model = model.cuda().eval()
    n_params = sum(p.numel() for p in model.parameters())
    n_chains = sum(model.fused_chains(FT_COLS).values())
    require(n_chains == 82, f"{n_chains} fused chains at B={FT_COLS}")
    params = list(model.parameters())
    bias_i = [n for n, _ in model.named_parameters()].index("out_conv.bias")
    gates = RolloutGates(torch, physics)
    wrap = PW.make_wrapper(lambda xn: model(xn), stats5,
                           PW.WrapperConfig(input_version="v4"),
                           device="cuda")
    plain = plain_v5_path(torch, K, T, PW, physics,
                          lambda xn: gates.model(model, xn), spec5, stats5)
    oracle_wrap, _, fit_std, mean_prof = OE.make_oracle_wrapper(
        spec5, spec4, tend_scale=0.1, gain=64.0, mean_gain=3.0,
        device="cuda")
    x_std = synthetic_inputs(spec5, 4 * FT_COLS, grid, seed=0)
    x_std[:, spec5.input_slices["icol"]] = (
        np.arange(x_std.shape[0]) % FT_COLS + 1)[:, None]
    fit_std(x_std)

    def at_seed(sd):
        """The weights from ``sd``, and the IC: the oracle's state after
        FT_SPIN steps from ``sd``'s synthetic columns, with its forcing,
        its driver and the trajectory's stds."""
        model.load_state_dict(port_flax_unet(unet_flax_tree(model, sd),
                                             model))
        x0 = synthetic_inputs(spec4, FT_COLS, grid, seed=sd + 90)
        s_clim = PD.initial_state(x0, grid, device="cuda")
        forcing = OE.build_balanced_forcing(s_clim, mean_prof, TAU_DAYS,
                                            DIURNAL, grid, "cuda")
        oracle = PD.HybridDriver(oracle_wrap, grid, dyn_forcing=forcing)
        with torch.no_grad():
            s0, traj = oracle.rollout(s_clim, FT_SPIN)
        return forcing, oracle, s0, trajectory_stds(traj)

    print(f"6f: U-Net v5 (unet_v5, fused_gn_conv=True): {n_params} "
          f"parameters, {n_chains} fused chains a step of {FT_COLS} columns; "
          f"the reference: online_eval's oracle, after {FT_SPIN} steps",
          flush=True)

    def grads_at(wrapper, remat):
        """(loss, gradients, peak bytes) of the K = FT_CHECK_K loss."""
        hyb = PD.HybridDriver(wrapper, grid, dyn_forcing=forcing,
                              remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = make_rollout_loss(hyb, oracle, FT_CHECK_K, stds)(s0, FT_SPIN)
        if loss.requires_grad:
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        else:    # F4 planted everywhere: nothing reaches a parameter
            grads = [torch.zeros_like(p) for p in params]
        torch.cuda.synchronize()
        return loss.detach(), grads, torch.cuda.max_memory_allocated()

    def gated(wrapper, held=None):
        """(loss, gradients, the gradients at out_conv's output a step),
        the gates' masks and their callers, of the K = FT_CHECK_K loss
        without remat (a recomputed step would meet the gates again), the
        gates recorded, or held to ``held``."""
        outs = []
        hook = model.out_conv.register_forward_hook(
            lambda m, a, out: outs.append(out) if out.requires_grad else None)
        hyb = PD.HybridDriver(wrapper, grid, dyn_forcing=forcing,
                              remat=False)
        try:
            loss, masks, sites = gates.run(lambda: make_rollout_loss(
                hyb, oracle, FT_CHECK_K, stds)(s0, FT_SPIN), held)
        finally:
            hook.remove()
        got = torch.autograd.grad(loss, params + outs, allow_unused=True,
                                  materialize_grads=True)
        return (loss.detach(), got[:len(params)], got[len(params):]), \
            masks, sites

    def bias_f64(dh, rounded=True):
        """out_conv.bias's gradient summed in float64 from the gradients
        at out_conv's output: a step's sum of them rounded to bf16 (the
        output's rounding), rounded to bf16 (the bias's; not where
        ``rounded`` is False), then the steps' sum."""
        def one(g):
            s = g.bfloat16().double().sum((0, 1))
            return s.float().bfloat16().double() if rounded else s
        return sum(one(g) for g in dh)

    def unrounded_bias(grads, dh):
        """The gradients with out_conv.bias's taken before its rounding
        to bf16 (``bias_f64(dh, rounded=False)``)."""
        return [bias_f64(dh, False) if i == bias_i else g
                for i, g in enumerate(grads)]

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    def rel_all(got, want):
        num = sum(float(((a - b).double() ** 2).sum())
                  for a, b in zip(got, want))
        den = sum(float((b.double() ** 2).sum()) for b in want)
        return (num / den) ** 0.5

    def bias_share(got, want):
        """out_conv.bias's share of rel_all(got, want) ** 2."""
        num = sum(float(((a - b).double() ** 2).sum())
                  for a, b in zip(got, want))
        d = float(((got[bias_i] - want[bias_i]).double() ** 2).sum())
        return d / num if num else 0.0

    # -- K = FT_CHECK_K: reproducible convolutions and index sums --------
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.enabled,
             torch.are_deterministic_algorithms_enabled())
    cudnn.deterministic, cudnn.enabled = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    real_k5, real_bwd = PU.fused_gn_silu_conv3, PU.fused_gn_silu_conv3_bwd
    real_fns = (K._InputTransformGrad.apply, K._ConstraintHeadGrad.apply)
    plain_bwd = plain_chain_bwd(torch, PU)
    res, by_seed = {}, {}

    def all_plain(fn):
        """fn() on the all-plain path: kernel 5 as its plain version
        too, and 5''s backward autograd of the plain chain."""
        PU.fused_gn_silu_conv3 = (
            lambda x, gm, bt, w, b: PU.xla_gn_silu_conv3_plain(
                x, gm, bt, w, b))
        PU.fused_gn_silu_conv3_bwd = plain_bwd
        try:
            return fn()
        finally:
            PU.fused_gn_silu_conv3 = real_k5
            PU.fused_gn_silu_conv3_bwd = real_bwd

    if check_seeds is None:
        # --seed last: the updates below start from its weights and IC
        check_seeds = [seed + i for i in range(1, FT_CHECK_SEEDS)] + [seed]
    gates.install()
    try:
        for sd in check_seeds:
            forcing, oracle, s0, stds = at_seed(sd)
            l1, g1, peak1 = grads_at(wrap, True)
            if sd == seed:
                l0, g0, peak0 = grads_at(wrap, False)
                require(torch.equal(l1, l0) and all(
                    torch.equal(a, b) for a, b in zip(g1, g0)),
                    f"K={FT_CHECK_K}: remat=True and remat=False differ "
                    f"(gradient rel-L2 {rel_all(g1, g0):.3e})")
                del g0
            # kernels 1 and 4 as plain versions, kernel 5 and 5''s
            # backward kernel kept: their forwards are bit-equal and their
            # backward is the plain chain's, so the gradients must be too
            lk, gk, _ = grads_at(plain, True)
            lp, gp, _ = all_plain(lambda: grads_at(plain, True))
            # the rollout's gates: those of the kernel path (kernels 1 and
            # 4 as plain versions, as lk) and of the all-plain path, each
            # recorded without remat; then the all-plain path with the
            # kernel path's gates held, the check's measure
            (lk0, gk0, dhk), mk, sites = gated(plain)
            (lp0, gp0, dhp), mp, _ = all_plain(lambda: gated(plain))
            (_, gh, dhh), _, _ = all_plain(lambda: gated(plain, mk))
            wk, wp, wh = bias_f64(dhk), bias_f64(dhp), bias_f64(dhh)
            uk, up, uh = (unrounded_bias(g, dh) for g, dh in (
                (gk0, dhk), (gp0, dhp), (gh, dhh)))
            try:    # F4 planted: kernels 1 and 4 as bare launches
                K._InputTransformGrad.apply = (
                    lambda x, c: K._transform_launch(x, c, c.device))
                K._ConstraintHeadGrad.apply = (
                    lambda y, t, qc, qi, c, dt, lds: K._head_launch(
                        y, t, qc, qi, c, dt, lds, c.device))
                _, gf, _ = grads_at(wrap, True)
                K._ConstraintHeadGrad.apply = real_fns[1]  # kernel 1's alone
                _, gf1, _ = grads_at(wrap, True)
            finally:
                K._InputTransformGrad.apply, K._ConstraintHeadGrad.apply = \
                    real_fns
            by_seed[sd] = r = {
                "loss": float(l1), "plain_loss": float(lp),
                "k14_plain_rel_l2": rel_all(g1, gk),
                "grad_rel_l2_to_plain": rel_all(g1, gp),
                "grad_rel_l2_held": rel_all(uk, uh),
                "grad_rel_l2_gates_held": rel_all(gk0, gh),
                "grad_rel_l2_bias_unrounded": rel_all(uk, up),
                "gates": len(mk), "gate_flips": gate_flips(torch, mp, mk,
                                                           sites),
                "kernel_remat_bit_equal": bool(torch.equal(lk0, lk) and all(
                    torch.equal(a, b) for a, b in zip(gk0, gk))),
                "plain_remat_bit_equal": bool(torch.equal(lp0, lp) and all(
                    torch.equal(a, b) for a, b in zip(gp0, gp))),
                "bias_share": bias_share(g1, gp),
                "bias_share_gates_held": bias_share(gk0, gh),
                "bias_f64_of_autograd": [rel(gk0[bias_i], wk),
                                         rel(gp0[bias_i], wp),
                                         rel(gh[bias_i], wh)],
                "bias_f64_to_plain": rel(wk, wp),
                "bias_f64_gates_held": rel(wk, wh),
                "bias_unrounded_to_plain": rel(uk[bias_i], up[bias_i]),
                "bias_unrounded_gates_held": rel(uk[bias_i], uh[bias_i]),
                "bias_norm_share": float((gk0[bias_i].double() ** 2).sum())
                / sum(float((g.double() ** 2).sum()) for g in gk0),
                "f4_planted_rel_l2": rel_all(gf, gp),
                "f4_planted_k14_rel_l2": rel_all(gf, gk),
                "f4_kernel1_only_k14_rel_l2": rel_all(gf1, gk)}
            print(f"  K={FT_CHECK_K} (cuDNN off), seed {sd}: gradients "
                  f"{r['k14_plain_rel_l2']:.3e} (rel-L2) from kernels 1 and "
                  f"4's plain versions', from the all-plain path's "
                  f"{r['grad_rel_l2_held']:.3e} with the {r['gates']} gates "
                  f"held and out_conv.bias's unrounded (bound "
                  f"{FT_GRAD_TOL:g}); as autograd gives them "
                  f"{r['grad_rel_l2_to_plain']:.3e}, the gates held "
                  f"{r['grad_rel_l2_gates_held']:.3e}, out_conv.bias's "
                  f"unrounded {r['grad_rel_l2_bias_unrounded']:.3e} "
                  f"(gradient masks flipped by caller: {r['gate_flips']}; "
                  f"out_conv.bias {r['bias_norm_share']:.1%} of the "
                  f"squared gradient, {r['bias_share']:.1%} of the squared "
                  f"gap, {r['bias_share_gates_held']:.1%} with the gates "
                  f"held); out_conv.bias in float64 from the gradient at "
                  f"its output: autograd's within "
                  + " / ".join(f"{v:.2e}" for v in r['bias_f64_of_autograd'])
                  + f" (kernel, all-plain, held), kernel against all-plain "
                  f"{r['bias_f64_to_plain']:.3e} rounded (held "
                  f"{r['bias_f64_gates_held']:.3e}), "
                  f"{r['bias_unrounded_to_plain']:.3e} unrounded (held "
                  f"{r['bias_unrounded_gates_held']:.3e}); F4 "
                  f"planted {r['f4_planted_rel_l2']:.3e} from the all-plain "
                  f"path's, {r['f4_planted_k14_rel_l2']:.3e} from kernels 1 "
                  f"and 4's plain versions', kernel 1's alone "
                  f"{r['f4_kernel1_only_k14_rel_l2']:.3e}", flush=True)
            require(torch.equal(l1, lk) and all(
                torch.equal(a, b) for a, b in zip(g1, gk)),
                f"K={FT_CHECK_K}, seed {sd}: kernels 1 and 4's gradients "
                "are not those of their plain versions")
            require(not all(torch.equal(a, b) for a, b in zip(gf1, gk)),
                    f"K={FT_CHECK_K}, seed {sd}: F4 planted in kernel 1 "
                    "alone passes")
            del g1, gk, gp, gf, gf1, gk0, gp0, gh, dhk, dhp, dhh, mk, mp, \
                uk, up, uh
    finally:
        gates.remove()
        cudnn.deterministic, cudnn.enabled = saved[:2]
        torch.use_deterministic_algorithms(saved[2])
    if check_only:
        return {"by_seed": by_seed}, {}
    require(all(r["kernel_remat_bit_equal"] for r in by_seed.values()),
            f"K={FT_CHECK_K}: remat=False differs from remat=True with "
            "kernels 1 and 4 as plain versions (the gates' run)")
    gap = max(r["grad_rel_l2_held"] for r in by_seed.values())
    gap_f4 = min(r["f4_planted_rel_l2"] for r in by_seed.values())
    require(gap <= FT_GRAD_TOL, f"K={FT_CHECK_K}: the kernel path's "
            f"gradients {gap:.3e} (rel-L2) from the all-plain path's with "
            "the rollout's gates held and out_conv.bias's unrounded")
    require(gap_f4 > FT_GRAD_TOL, f"F4 planted passes: {gap_f4:.3e}")
    res["check_k"] = {
        "k": FT_CHECK_K, **by_seed[seed], "remat_bit_equal": True,
        "k14_plain_bit_equal": True,
        "peak_gb_remat": peak1 / 1e9, "peak_gb_no_remat": peak0 / 1e9,
        "by_seed": by_seed}
    print(f"  K={FT_CHECK_K} (cuDNN off), seed {seed}: remat on / off "
          f"bit-equal (loss {float(l1):.6e}), peak {peak1 / 1e9:.2f} / "
          f"{peak0 / 1e9:.2f} GB; over {FT_CHECK_SEEDS} seeds bit-equal to "
          f"kernels 1 and 4's plain versions, at most {gap:.3e} from the "
          f"all-plain path's with the gates held and out_conv.bias's "
          f"unrounded, F4 planted at least "
          f"{gap_f4:.3e} (bound {FT_GRAD_TOL:g})", flush=True)

    # -- FT_UPDATES updates at K = FT_K ------------------------------------
    ft = PD.HybridDriver(wrap, grid, dyn_forcing=forcing, remat=True)
    step_fn, _ = make_finetune_step(ft, oracle, FT_K, stds, params,
                                    learning_rate=1e-4,
                                    total_steps=FT_UPDATES)
    per_update = {"fused_input_transform": 2 * FT_K,
                  "fused_constraint_head": 2 * FT_K,
                  "fused_gn_silu_conv3": 82 * 2 * FT_K,
                  "fused_gn_silu_conv3_bwd": 82 * FT_K}
    ups, launches_all = [], dict.fromkeys(K.LAUNCHES, 0)
    # 5''s backward timed inside the updates: CUDA events around each call
    # of the kernel on the one stream, added up after the update
    bwd_events = []

    def timed_bwd(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_bwd(*a)
        ev[1].record()
        bwd_events.append(ev)
        return out

    for i in range(FT_UPDATES):
        before = [p.detach().clone() for p in params]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        K.reset_launches()
        bwd_events.clear()
        PU.fused_gn_silu_conv3_bwd = timed_bwd
        try:
            start.record()
            loss = step_fn(s0, FT_SPIN + 8 * i)
            end.record()
            end.synchronize()
        finally:
            PU.fused_gn_silu_conv3_bwd = real_bwd
        bwd_ms = sum(a.elapsed_time(b) for a, b in bwd_events)
        launches = dict(K.LAUNCHES)
        for k, v in launches.items():
            launches_all[k] += v
        for name in (*KERNEL_NAMES, "fused_gn_silu_conv3_bwd"):
            want = per_update.get(name, 0)
            require(launches[name] == want, f"fine-tune update {i}: {name} "
                    f"launched {launches[name]} times, want {want}")
        norm = float(step_fn.grad_norm)
        leaf = [float(p.grad.abs().max()) for p in params]
        require(np.isfinite(float(loss)) and np.isfinite(norm) and norm > 0,
                f"fine-tune update {i}: loss {float(loss)}, norm {norm}")
        require(all(np.isfinite(leaf)) and sum(v > 0 for v in leaf)
                >= len(leaf) - 1, f"fine-tune update {i}: "
                f"{sum(v == 0 for v in leaf)} leaves with no gradient")
        moved = sum(not torch.equal(p, q) for p, q in zip(params, before))
        ups.append({"loss": float(loss), "grad_norm": norm,
                    "ms": start.elapsed_time(end), "bwd_5p_ms": bwd_ms,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "leaves_moved": moved, "launches": {
                        k: v for k, v in launches.items() if v}})
        print(f"{card}: fine-tune update {i} (K={FT_K}, {FT_COLS} columns, "
              f"remat): {ups[-1]['ms']:.1f} ms, peak "
              f"{ups[-1]['peak_gb']:.2f} GB, 5' backward {bwd_ms:.1f} ms "
              f"({bwd_ms / ups[-1]['ms']:.1%} of the update), loss "
              f"{float(loss):.6e}, "
              f"gradient norm {norm:.4e}, {moved} of {len(params)} leaves "
              f"moved; launches {ups[-1]['launches']}", flush=True)
    res.update({"k": FT_K, "columns": FT_COLS, "parameters": n_params,
                "updates": ups,
                "ms_an_update": float(np.median([u["ms"] for u in ups])),
                "bwd_5p_share": float(np.median([u["bwd_5p_ms"] / u["ms"]
                                                 for u in ups])),
                "peak_gb": max(u["peak_gb"] for u in ups),
                "launches_an_update": per_update})
    return res, launches_all


def entry_phase(torch, card, K, tmp):
    """6f: python -m climsim_tpu_torch.online_eval's main on the card with
    ENTRY_ARGS: it reaches its report, kernels 1 and 4 launched once a
    hybrid rollout step and 2 K times a fine-tune update."""
    from climsim_tpu_torch import online_eval as OE

    argv = ENTRY_ARGS + ["--device", "cuda", "--out", tmp]
    got, default = vars(OE.parse_args(argv)), vars(OE.parse_args([]))
    cuts = [f"--{k.replace('_', '-')} {default[k]} -> {v}"
            for k, v in got.items() if v != default[k]
            and k not in ("device", "out")]
    print(f"6f: online_eval at its default width, cut from the defaults: "
          f"{cuts}", flush=True)
    K.reset_launches()
    t0 = time.perf_counter()
    out = OE.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    args = OE.parse_args(argv)
    steps = OE.geometry(args)[2]
    pl = out["phase_launches"]
    for name in ("fused_input_transform", "fused_constraint_head"):
        hybrid = pl["6 (hybrid)"].get(name, 0)
        require(hybrid == steps, f"online_eval's hybrid rollout: {name} "
                f"launched {hybrid} times in {steps} steps")
        ft = pl["4b (rollout fine-tune)"].get(name, 0)
        want = 2 * args.ft_k * args.ft_steps
        require(ft == want, f"online_eval's fine-tune: {name} launched "
                f"{ft} times, want {want}")
    require(sum(launches.values()) == sum(
        sum(v.values()) for v in pl.values()),
        "online_eval's phases miss launches")
    require(os.path.exists(out["report"]), "online_eval wrote no report")
    first, last = out["ft_loss"]
    require(np.isfinite(first) and np.isfinite(last),
            f"online_eval's fine-tune losses {out['ft_loss']}")
    require(np.isfinite(out["floor"]) and all(
        np.isfinite(r) for r in out["win_rmse"]), "online_eval: non-finite "
        "floor or RMSE")
    print(f"{card}: online_eval reached its report in {wall:.1f} s "
          f"(verdict {out['verdict']}, T ratios "
          f"{[round(float(r), 3) for r in out['ratios']]}, figures drawn: "
          f"{out['figures']}); kernels 1 and 4 once a step of its "
          f"{steps}-step hybrid rollout; phases (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      out["phase_seconds"].items()), flush=True)
    return {"argv": ENTRY_ARGS, "cuts": cuts, "seconds": wall,
            "phase_seconds": out["phase_seconds"],
            "phase_launches": pl, "verdict": out["verdict"],
            "floor": out["floor"], "win_rmse": out["win_rmse"],
            "ratios_by_var": out["ratios_by_var"], "micro": out["micro"],
            "ft_loss": out["ft_loss"], "figures": out["figures"]}, launches


# --------------------------------------------------------------------------
# phase 12: the NeurIPS'23 zoo through the run entry
# --------------------------------------------------------------------------
# (preset, overrides, replicas): each at its published widths and batch,
# cut in epochs and rows only: ZOO_STEPS training batches and one
# validation batch an epoch.  mlp_v2's norms are computed from its split
# (the v2 asset norms turn the synthetic v2 rows' unfilled features into
# NaN, in the JAX runner as in the port).  HSR runs 6 epochs: 2 of its MSE
# stage, then 4 of its NLL stage (epochs // 3).  replicas > 0: that many
# seeds in train.seeds (the multi-seed branch).
ZOO_STEPS = 4
ZOO_RUNS = (("mlp_v1", (), 0), ("mlp_v2", ("data.norms=compute",), 0),
            ("cnn_v1", (), 0), ("ed_v1", (), 0),
            ("hsr_v1", ("train.epochs=6",), 0), ("rpn_v1", (), 0),
            ("cvae_v1", (), 0), ("hsr_v1", ("train.epochs=6",), 3))
ZOO_EPOCHS = 3
ZOO_SAMPLES = 32          # stochastic samples a column (the recipes' 32)
ZOO_SAMPLE_ROWS = 1024
ZOO_FIRST_ROWS = 16
# The first loss on ZOO_FIRST_ROWS rows, card against CPU, relative: the
# same bf16 roundings of the operands, float32 sums in other orders
# (cuBLAS and cuDNN against the CPU's), whose bf16-rounded activations flip
# now and then.  Read by ``--zoo-first-seeds 0,1,2,3,4,5,6,7`` on an H100
# 80GB HBM3 (700 W), the largest of the eight seeds: mlp_v1 2.0e-4 (seed
# 4; 2.8e-5 at most at the other seven), hsr_v1 8.0e-5, ed_v1 2.2e-5,
# cvae_v1 1.6e-5, rpn_v1 1.5e-5, mlp_v2 1.2e-6.  cnn_v1 reads up to
# 1.17e-3 (seed 1; 2.4e-5 at seed 0): its 39 convolutions, each rounded
# to bf16, flip the most; bf16 against float32 on one device differs by
# 2.5e-4 to 3.8e-3 on the CPU, so its bound is the looser one, and its
# float32 path (compute_dtype=float32, nothing to flip) is held to the
# tight ZOO_CNN_FLOAT32_TOL instead: 1.1e-6 at most at the eight seeds.
ZOO_FIRST_LOSS_TOL = 1e-3
ZOO_CNN_FIRST_LOSS_TOL = 5e-3
ZOO_CNN_FLOAT32_TOL = 1e-5
ZOO_BENCH_STEPS = 5       # bench_cnn's timed steps an arm


def _np_dense(rng, din, dout, lead=()):
    return {"kernel": (rng.standard_normal((*lead, din, dout))
                       / np.sqrt(din)).astype(np.float32),
            "bias": (0.01 * rng.standard_normal((*lead, dout))).astype(
                np.float32)}


def _np_trunk(rng, din, hidden, layernorm=False, lead=()):
    tree = {}
    for i, h in enumerate(hidden):
        tree[f"Dense_{i}"] = _np_dense(rng, din, h, lead)
        if layernorm:
            tree[f"LayerNorm_{i}"] = {
                "scale": (1 + 0.05 * rng.standard_normal(h)).astype(
                    np.float32),
                "bias": (0.05 * rng.standard_normal(h)).astype(np.float32)}
        din = h
    return tree


def _np_conv(rng, k, cin, cout, bias=0.0):
    return {"Conv_0": {
        "kernel": (rng.standard_normal((k, cin, cout))
                   / np.sqrt(k * cin)).astype(np.float32),
        "bias": (bias + 0.01 * rng.standard_normal(cout)).astype(
            np.float32)}}


def zoo_state(cfg, spec, seed):
    """The flax-layout parameter tree of ``cfg``'s model (numpy, drawn from
    ``seed``: kernels of variance 1 / fan-in, small biases, LayerNorm
    scales near 1) carried over by the model's porter: the port's
    state_dict."""
    from climsim_tpu_torch.data import transforms as T
    from climsim_tpu_torch.utils import migrate as PM

    rng = np.random.default_rng(seed)
    kw = cfg.model_kw
    din, dout = spec.input_len, spec.output_len
    if cfg.model in ("mlp", "mlp_v2"):
        hidden = tuple(kw["hidden"])
        if cfg.model == "mlp_v2":
            din = len(T.utls_feature_indices(spec))
        lin = dout - len(spec.output_scalar_vars)
        return PM.port_flax_mlp({
            "MLPTrunk_0": _np_trunk(rng, din, hidden),
            "prehead": _np_dense(rng, hidden[-1], dout),
            "LinReluHead_0": {"out_linear": _np_dense(rng, dout, lin),
                              "out_relu": _np_dense(rng, dout, dout - lin)}})
    if cfg.model == "ed":   # the recipe's published widths
        m, lat = 463, 5
        enc = (m, m, m // 2, m // 4, m // 8, m // 16, lat)
        dec = (m // 16, m // 8, m // 4, m // 2, m, m)
        return PM.port_flax_ed({"encoder": _np_trunk(rng, din, enc),
                                "decoder": _np_trunk(rng, lat, dec),
                                "out": _np_dense(rng, m, dout)})
    if cfg.model == "hsr":
        h = (kw["hidden"],) * kw["layers"]
        return PM.port_flax_hsr({
            "mean_trunk": _np_trunk(rng, din, h, True),
            "mean_out": _np_dense(rng, h[-1], dout),
            "logprec_trunk": _np_trunk(rng, din, h, True),
            "logprec_out": _np_dense(rng, h[-1], dout)})
    if cfg.model == "cvae":
        h, lat = (kw["hidden"],) * kw["layers"], kw["latent"]
        return PM.port_flax_cvae({
            "enc_trunk": _np_trunk(rng, dout + din, h, True),
            "enc_mean": _np_dense(rng, h[-1], lat),
            "enc_logstd": _np_dense(rng, h[-1], lat),
            "dec_trunk": _np_trunk(rng, lat + din, h, True),
            "dec_mean": _np_dense(rng, h[-1], dout),
            "dec_logstd": _np_dense(rng, h[-1], dout)})
    if cfg.model == "cnn":
        c, cin = kw["channels"], len(spec.inputs)
        n_p, n_s = len(spec.output_profile_vars), len(spec.output_scalar_vars)
        tree = {f"ResBlock_{i}": {
            "Conv1d_0": _np_conv(rng, 3, cin if i == 0 else c, c),
            "Conv1d_1": _np_conv(rng, 3, c, c),
            "Conv1d_2": _np_conv(rng, 1, cin if i == 0 else c, c)}
            for i in range(kw["depth"])}
        tree.update(Conv1d_0=_np_conv(rng, 1, c, n_p + n_s),
                    Conv1d_1=_np_conv(rng, 1, n_p + n_s, n_p),
                    Conv1d_2=_np_conv(rng, 1, n_p + n_s, n_s, 0.5))
        return PM.port_flax_cnn(tree)
    if cfg.model == "rpn":
        e, hidden = kw["ensemble_size"], tuple(kw["hidden"])

        def stacked():
            return {"MLPTrunk_0": _np_trunk(rng, din, hidden, lead=(e,)),
                    "out": _np_dense(rng, hidden[-1], dout, (e,))}

        return PM.port_flax_rpn(stacked(), stacked())
    raise ValueError(cfg.model)


def zoo_config(preset, extra, replicas, seed):
    """``preset`` cut to ZOO_STEPS training batches and one validation
    batch an epoch, its models drawn from ``seed`` (the replicas' from
    seed, seed + 1, ...)."""
    from climsim_tpu_torch.config import PRESETS

    base = PRESETS[preset]
    return base.override(
        f"data.num_synthetic={(ZOO_STEPS + 1) * base.data.batch_size}",
        f"train.epochs={ZOO_EPOCHS}", f"seed={seed}", *extra,
        *([f"train.seeds={[seed + k for k in range(replicas)]}"]
          if replicas else []))


def zoo_first_tol(cfg):
    return ZOO_CNN_FIRST_LOSS_TOL if cfg.model == "cnn" else \
        ZOO_FIRST_LOSS_TOL


def zoo_first_loss(torch, PRUN, cfg, spec, stats, x, y, grid, state,
                   device):
    """The first loss on ZOO_FIRST_ROWS rows from the porter's ``state``:
    ({device: loss, "cpu": loss}, the relative gap)."""
    xf, yf = (torch.from_numpy(np.asarray(a[:ZOO_FIRST_ROWS]))
              for a in (x, y))
    first = {}
    for dev in (device, "cpu"):
        if cfg.model == "rpn":
            tr = PRUN.rpn_trainer(spec, stats, x, cfg.seed, cfg=cfg.transform,
                                  device=dev, **cfg.model_kw)
            tr.ensemble.load_state_dict(state)
            first[dev] = float(tr.eval_losses(xf, yf).mean())
        else:
            tr = PRUN.build_trainer(cfg, spec, stats, (x[:4], y[:4]),
                                    cfg.seed, None, ZOO_STEPS, grid, False,
                                    dev)
            tr.model.load_state_dict(state)
            first[dev] = float(tr.eval_step(tr.model, xf, yf)["loss"])
        del tr
    return first, abs(first[device] - first["cpu"]) / abs(first["cpu"])


def cnn_float32_first(torch, cfg, spec, stats, x, y, state, device):
    """cnn_v1's first loss on ZOO_FIRST_ROWS rows from ``state`` at
    compute_dtype=float32 (no bf16 rounding): {device: loss, "cpu":
    loss}."""
    from climsim_tpu_torch.train import recipes

    xf, yf = (torch.from_numpy(np.asarray(a[:ZOO_FIRST_ROWS]))
              for a in (x, y))
    loss = {}
    for dev in (device, "cpu"):
        tr = recipes.cnn_trainer(spec, stats, None, cfg.seed,
                                 steps_per_epoch=ZOO_STEPS, cfg=cfg.transform,
                                 compute_dtype=torch.float32, device=dev,
                                 **cfg.model_kw)
        tr.model.load_state_dict(state)
        loss[dev] = float(tr.eval_step(tr.model, xf, yf)["loss"])
    return loss


def zoo_first_batch(cfg, x, y, n_rows, device):
    """The raw rows of the run's first training step, as its branch's
    loader draws them: the RPN's (E, B, D) bootstrap stacks as the (E * B,
    D) rows kernel 1 takes, else (B, D)."""
    from climsim_tpu_torch.data.pipeline import (BatchLoader,
                                                 BootstrapLoader,
                                                 DeviceResidentLoader)

    b = cfg.data.batch_size
    xt, yt = np.asarray(x[:n_rows]), np.asarray(y[:n_rows])
    if cfg.model == "rpn":
        loader = BootstrapLoader(xt, yt, b,
                                 cfg.model_kw.get("ensemble_size", 32),
                                 steps_per_epoch=ZOO_STEPS,
                                 seed=cfg.data.seed, device=device)
    elif cfg.train.seeds:
        loader = BatchLoader(xt, yt, b, seed=cfg.data.seed, device=device)
    else:
        loader = DeviceResidentLoader(
            xt, yt, b, seed=cfg.data.seed,
            block_shuffle=cfg.data.block_shuffle or None, device=device)
    it = iter(loader)
    xb = next(it)[0].clone()
    it.close()
    return xb.reshape(-1, xb.shape[-1])


def zoo_kernel1(torch, K, cfg, spec, stats, blocks, label, device):
    """Kernel 1 bit-equal to its plain version on each of ``blocks`` (name
    -> raw rows), under the preset's own TransformConfig as its recipe
    builds it; returns name -> (rows, the plan's path)."""
    from climsim_tpu_torch.data import transforms as T

    consts = T.input_transform_consts(spec, stats, cfg.transform, device)
    seen = {}
    for what, rows in blocks.items():
        xb = torch.as_tensor(rows).to(device=device,
                                      dtype=torch.float32).contiguous()
        require_equal(torch, f"{label}: kernel 1 on the {what} "
                      f"({xb.shape[0]} x {xb.shape[1]})",
                      K.fused_input_transform(xb, consts),
                      K.fused_input_transform_plain(xb, consts))
        plan = K.plan_input_transform(xb.shape[0], xb.shape[1],
                                      *K._device_limits(0))
        seen[what] = (xb.shape[0], "direct" if plan.direct else "pipelined")
    return seen


def zoo_run(torch, K, PRUN, preset, extra, replicas, seed, tmp, device):
    """One preset through run_experiment on ``device``: its first loss
    against the CPU's, kernel 1 against its plain version at the run's
    shapes, the launches of the run, its losses, its samples."""
    from climsim_tpu_torch.eval.metrics import crps
    from climsim_tpu_torch.train.checkpoints import save_state

    cfg = zoo_config(preset, extra, replicas, seed)
    b = cfg.data.batch_size
    seeds = list(cfg.train.seeds) or [cfg.seed]
    grid = PRUN.load_default_grid()
    spec, x, y, stats = PRUN.load_data(cfg, grid)
    state = zoo_state(cfg, spec, seed)
    label = preset + (f" x{len(seeds)} seeds" if cfg.train.seeds else "")
    n_rows = x.shape[0] - b

    # the first loss on ZOO_FIRST_ROWS rows: the card's trainer against the
    # CPU's, from the porter's weights
    first, gap = zoo_first_loss(torch, PRUN, cfg, spec, stats, x, y, grid,
                                state, device)
    require(gap <= zoo_first_tol(cfg), f"{label}: first loss "
            f"{first[device]} on the card, {first['cpu']} on the CPU")
    f32_gap = None
    if cfg.model == "cnn":
        f32 = cnn_float32_first(torch, cfg, spec, stats, x, y, state, device)
        f32_gap = abs(f32[device] - f32["cpu"]) / abs(f32["cpu"])
        require(f32_gap <= ZOO_CNN_FLOAT32_TOL, f"{label}: first loss at "
                f"float32 {f32[device]} on the card, {f32['cpu']} on the CPU")
    # kernel 1 at every shape the path hands it
    sampled = cfg.model in ("hsr", "cvae", "rpn")
    k1 = zoo_kernel1(torch, K, cfg, spec, stats, {
        "first training batch": zoo_first_batch(cfg, x, y, n_rows, device),
        "first validation batch": np.asarray(x[n_rows:n_rows + b]),
        "first-loss rows": np.asarray(x[:ZOO_FIRST_ROWS]),
        **({"sample rows": np.asarray(x[:ZOO_SAMPLE_ROWS])}
           if sampled else {})}, label, device)

    # the run: a single model starts from the porter's weights by the warm
    # restart (train.restart_path); the RPN ensemble and the replicas from
    # their recipes' initialization, drawn from cfg.seed / train.seeds
    if cfg.model != "rpn" and not cfg.train.seeds:
        path = os.path.join(tmp, f"{preset}.pt")
        save_state(path, state)
        cfg = cfg.override(f"train.restart_path={json.dumps(path)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches, _ = counted(torch, K, lambda: PRUN.run_experiment(
        cfg, verbose=False, device=device))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows = out["history"].rows
    losses = [r["train_loss"] for r in rows]
    vals = [r["val_loss"] for r in rows]
    require(all(np.isfinite(losses + vals)), f"{label}: a non-finite "
            f"loss: train {losses}, val {vals}")
    # HSR: the MSE stage's epochs and the NLL's each fall (their losses
    # are of two kinds)
    stage = cfg.train.epochs // 3 if cfg.model == "hsr" else len(losses)
    spans = [(0, stage)] + ([(stage, len(losses))] if stage < len(losses)
                            else [])
    for lo, hi in spans:
        require(losses[hi - 1] < losses[lo], f"{label}: the train loss did "
                f"not fall over epochs {lo}..{hi - 1}: {losses[lo:hi]}")
    # kernel 1 once a step and once an evaluation batch (each replica's)
    steps = cfg.train.epochs * ZOO_STEPS * len(seeds)
    evals = cfg.train.epochs * len(seeds)
    require_per_step(launches, 1, {"fused_input_transform": steps + evals},
                     label)

    samples = None
    tr = out["trainer"]
    # the fit path's and the RPN loop's rate (the multi-seed loop keeps none)
    sps = (float(np.median([r["samples_per_sec"] for r in rows]))
           if "samples_per_sec" in rows[0] else None)
    ms_step = None if sps is None else b / sps * 1e3
    if sampled:
        xs = torch.from_numpy(np.asarray(x[:ZOO_SAMPLE_ROWS]))
        with torch.no_grad():
            if cfg.model == "rpn":
                s, slaunch, _ = counted(torch, K, lambda: tr.posterior(xs))
                yt = tr.target_transform(torch.from_numpy(np.asarray(
                    y[:ZOO_SAMPLE_ROWS])))
            else:
                t1 = tr.trainers[0] if cfg.train.seeds else tr
                s, slaunch, _ = counted(torch, K, lambda: t1.sample(
                    t1.model, xs, seed, ZOO_SAMPLES))
                yt = None
        if yt is None:
            from climsim_tpu_torch.data import transforms as T

            yt = T.make_target_transform(spec, stats, cfg.transform,
                                         device)(torch.from_numpy(
                                             np.asarray(y[:ZOO_SAMPLE_ROWS])))
        require(tuple(s.shape[:2]) == (ZOO_SAMPLE_ROWS, spec.output_len),
                f"{label}: samples of shape {tuple(s.shape)}")
        require(bool(torch.isfinite(s).all()), f"{label}: non-finite samples")
        require_per_step(slaunch, 1, {"fused_input_transform": 1},
                         f"{label} samples")
        for k, v in slaunch.items():
            launches[k] += v
        score = float(crps(s.double().cpu().numpy(),
                           yt.double().cpu().numpy()))
        require(np.isfinite(score), f"{label}: CRPS {score}")
        samples = {"shape": list(s.shape), "crps": score}
    print(f"zoo {label}: first loss card {first[device]:.8f} CPU "
          f"{first['cpu']:.8f} (gap {gap:.3e}"
          + ("" if f32_gap is None else f"; at float32 {f32_gap:.3e}")
          + "); kernel 1 bit-equal to "
          "plain on " + ", ".join(f"{r} rows {p} ({w})"
                                  for w, (r, p) in k1.items())
          + "; train " + " ".join(f"{v:.5f}" for v in losses) + "; val "
          + " ".join(f"{v:.5f}" for v in vals)
          + f"; kernel 1 launched {launches['fused_input_transform']}; "
          + (f"{ms_step:.3f} ms a step, {sps:.1f} samples/s (median epoch)"
             if sps else "no rate kept") + f"; peak {peak:.2f} GB; "
          f"{wall:.1f} s" + (f"; samples {samples['shape']} CRPS "
                             f"{samples['crps']:.5f}" if samples else ""),
          flush=True)
    return label, {"first_loss": first[device], "first_loss_cpu": first["cpu"],
                   "first_gap": gap, "first_gap_float32": f32_gap,
                   "kernel1_bit_equal": k1,
                   "train_loss": losses, "val_loss": vals,
                   "ms_per_step": ms_step, "samples_per_s": sps,
                   "batch": b, "train_rows": n_rows, "peak_gb": peak,
                   "seconds": wall, "samples": samples,
                   "launches": launches}


def zoo_first_gaps(torch, card, seeds, device="cuda"):
    """--zoo-first-seeds: each single preset's first-loss gap, card
    against CPU, at each of ``seeds`` (the readings its tolerance rests
    on; the replicas' run reads its single model's).  For cnn_v1 also the
    control: the same weights at compute_dtype=float32 (no bf16 rounding
    to flip), card against CPU, and bf16 against float32 on each."""
    from climsim_tpu_torch import run as PRUN

    out = {}
    for preset, extra, replicas in ZOO_RUNS:
        if replicas:
            continue
        gaps, f32 = {}, {}
        for seed in seeds:
            cfg = zoo_config(preset, extra, 0, seed)
            grid = PRUN.load_default_grid()
            spec, x, y, stats = PRUN.load_data(cfg, grid)
            state = zoo_state(cfg, spec, seed)
            first, gaps[seed] = zoo_first_loss(
                torch, PRUN, cfg, spec, stats, x, y, grid, state, device)
            if cfg.model != "cnn":
                continue
            loss = cnn_float32_first(torch, cfg, spec, stats, x, y, state,
                                     device)
            f32[seed] = {
                "float32_card_vs_cpu":
                    abs(loss[device] - loss["cpu"]) / abs(loss["cpu"]),
                "cpu_bf16_vs_float32":
                    abs(first["cpu"] - loss["cpu"]) / abs(loss["cpu"]),
                "card_bf16_vs_float32":
                    abs(first[device] - loss[device]) / abs(loss[device])}
        out[preset] = {"gaps": gaps, "tolerance": zoo_first_tol(cfg),
                       **({"float32_control": f32} if f32 else {})}
        print(f"{card}: {preset} first-loss gap by seed: " + ", ".join(
            f"{s} {g:.3e}" for s, g in gaps.items())
            + f" (largest {max(gaps.values()):.3e}, tolerance "
            f"{zoo_first_tol(cfg):g})", flush=True)
        for s, r in f32.items():
            print(f"  seed {s}: compute_dtype=float32 card against CPU "
                  f"{r['float32_card_vs_cpu']:.3e}; bf16 against float32 "
                  f"on the CPU {r['cpu_bf16_vs_float32']:.3e}, on the card "
                  f"{r['card_bf16_vs_float32']:.3e}",
                  flush=True)
    return out


def zoo_phase(torch, K, card, seed, device="cuda"):
    """Phase 12: every offline preset and a 3-seed HSR through the run
    entry, then bench_cnn's table.  Returns (results, the launches)."""
    from climsim_tpu_torch import bench_cnn
    from climsim_tpu_torch import run as PRUN

    results, total = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for preset, extra, replicas in ZOO_RUNS:
            label, r = zoo_run(torch, K, PRUN, preset, extra, replicas, seed,
                               tmp, device)
            results[label] = r
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
    bench = bench_cnn.bench(steps=ZOO_BENCH_STEPS, seed=seed)
    print(f"{card}: bench_cnn (cnn_v1, B = {bench_cnn.BATCH}, depth 12, "
          f"{ZOO_BENCH_STEPS} steps an arm, CUDA events)\n"
          + bench_cnn.table(bench), flush=True)
    results["bench_cnn"] = bench
    return results, total


# --------------------------------------------------------------------------
# phase 13: data-parallel training, the HPO sweep, the profiling helpers
# --------------------------------------------------------------------------
DP_STEPS = 4              # steps of each data-parallel run
DP_UNET_STEPS = 2
DP_RANKS = 2              # ranks sharing the one card over gloo in 13b
# 13b runs mlp_v1 twice on its ranks.  At the preset's own bf16 compute
# the whole run is held, bit for bit, to 1 process taking each step as
# DP_RANKS micro-batches whose gradients and losses it averages: the
# ranks' shapes and sums, in their order.  At float32 compute the run is
# held to the plain 1-process run: the first step's loss, before any
# update, within DP_RTOL (the same sums in another order,
# tests/test_multihost.py:168), and every step's and the validation
# loss within DP_RUN_RTOL.  After the first update the two differ in the
# order of their gradient sums (two half-batch sums added, against one
# sum), and Adam's first updates move every weight by about the learning
# rate in its gradient's sign, so a near-zero gradient whose sign the
# order flips moves a weight the other way: on an H100 at seed 0 the
# steps drifted 1.8e-7, 2.4e-5, 3.3e-4 and the validation 1.1e-4.
# At bf16 a product's roundings flip between a batch and its halves
# before any update, which is why this comparison runs at float32.
DP_RTOL = 1e-6
# The readings it rests on (--dp-gap-seeds 0,...,7, NVIDIA H100 80GB
# HBM3 at 700 W), steps 2-4 and validation: the largest
# 1.41e-2, seed 2's validation loss; its steps 1.8e-4, 1.5e-4, 1.2e-3;
# seed 0 (the default) 1.8e-7, 2.4e-5, 3.3e-4, validation 1.1e-4; seeds
# 4-6 at most 1.0e-4.  The bound is about twice the largest.
DP_RUN_RTOL = 3e-2
# the sweep of 13c: about a dozen trials, three workers on the one card.
# A trial of 100 steps takes about a second there (PR 14, call 2: 200
# steps, 12 trials on 2 survivors in 42.7 s with a 20 s stale timeout),
# so 10 s is a wide margin against taking over a live claim.
HPO_TRIALS, HPO_WORKERS, HPO_STEPS = 12, 3, 100
HPO_STALE_S, HPO_KILL_AFTER_S = 10.0, 3.0
FLOP_TOL = 0.01           # the profiler's count against the analytic one


def dp_config(seed):
    """mlp_v1 at its published widths and batch, DP_STEPS training
    batches and one validation batch, one epoch."""
    from climsim_tpu_torch.config import PRESETS

    base = PRESETS["mlp_v1"]
    return base.override(
        f"data.num_synthetic={(DP_STEPS + 1) * base.data.batch_size}",
        "train.epochs=1", f"seed={seed}")


def recording_mlp(torch, parts=1, f32=False):
    """The mlp recipe patched for 13b: each step's loss kept in
    ``record``; with ``f32`` float32 compute (DP_RTOL says why), else the
    preset's own; with ``parts`` > 1 a step and an evaluation run as that
    many micro-batches whose gradients and losses are averaged (divided
    by ``parts``, a power of 2: exact), the sums ``parts`` ranks make.
    Returns (undo, record)."""
    from climsim_tpu_torch.train import recipes
    from climsim_tpu_torch.train.step import (_apply_update,
                                              _fill_missing_grads,
                                              _step_seed)

    real = recipes.mlp_trainer
    record = []

    def trainer(*a, **kw):
        tr = real(*a, **(dict(kw, compute_dtype=torch.float32) if f32
                         else kw))
        step = tr.train_step
        evaluate = base_eval = tr.eval_step
        if parts > 1:
            def step(state, xb, yb):
                model = state.params
                state.opt_state.zero_grad(set_to_none=True)
                seed = _step_seed(state, None)
                losses = []
                for xh, yh in zip(xb.chunk(parts), yb.chunk(parts)):
                    loss, _ = tr.loss_fn(model, seed, xh, yh)
                    loss.backward()
                    losses.append(loss.detach())
                _fill_missing_grads(model)
                for prm in model.parameters():
                    prm.grad.div_(parts)
                _apply_update(tr.optimizer, state)
                return state, {"loss": torch.stack(losses).sum() / parts}

            def evaluate(model, xb, yb):
                ls = [base_eval(model, xh, yh)["loss"]
                      for xh, yh in zip(xb.chunk(parts), yb.chunk(parts))]
                return {"loss": torch.stack(ls).sum() / parts}

        def recorded(state, xb, yb):
            state, m = step(state, xb, yb)
            record.append(m["loss"])
            return state, m

        tr.train_step, tr.eval_step = recorded, evaluate
        return tr

    recipes.mlp_trainer = trainer
    return (lambda: setattr(recipes, "mlp_trainer", real)), record


def same_params(torch, label, got, want):
    for k, v in want.items():
        require(torch.equal(got[k].cpu(), v.cpu()),
                f"{label}: {k} differs (max |d| "
                f"{float((got[k].cpu() - v.cpu()).abs().max()):.3e})")


def dp_steps(torch, K, tr, step, xs, ys):
    """The losses of ``step`` over the batches, its launches, and ms a
    step after the first (which sets up DDP and warms the libraries)."""
    t1 = []

    def run():
        state, losses = tr.state, []
        for i, (xb, yb) in enumerate(zip(xs, ys)):
            if i == 1:
                torch.cuda.synchronize()
                t1.append(time.perf_counter())
            state, m = step(state, xb, yb)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        t1.append(time.perf_counter())
        return [float(v) for v in losses]

    losses, launches, _ = counted(torch, K, run)
    return losses, launches, (t1[1] - t1[0]) * 1e3 / (len(xs) - 1)


def dp_one_rank(torch, K, card, seed, tmp):
    """13a: a 1-rank NCCL group.  mlp_v1 (published widths, B = 3072,
    DP_STEPS steps) through the DDP step and the explicit all-reduce step,
    and unet_v5 (fused_gn_conv, B = 1024, DP_UNET_STEPS steps) through the
    DDP step, each bit-equal to the step without rules: losses and every
    parameter.  Kernel 1 once a step, kernel 5 82 times a U-Net step."""
    import torch.distributed as dist

    from climsim_tpu_torch import bench_unet_train as BU
    from climsim_tpu_torch import (get_varspec, load_asset_norms,
                                   load_default_grid)
    from climsim_tpu_torch.data.synthetic import synthetic_split
    from climsim_tpu_torch.parallel.mesh import ShardingRules, make_mesh
    from climsim_tpu_torch.train import recipes
    from climsim_tpu_torch.train.step_shardmap import (
        make_shardmap_train_step)

    out, total = {}, {}

    def tally(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store_a"), 1), rank=0, world_size=1)
    try:
        rules = ShardingRules(make_mesh(num_data=1, device="cuda"))
        require(dist.get_backend() == "nccl", "13a: not NCCL")
        spec, stats = get_varspec("v1"), load_asset_norms("v1")
        b = dp_config(seed).data.batch_size
        x, y = synthetic_split(spec, DP_STEPS * b, load_default_grid(),
                               seed=seed)
        xs = torch.from_numpy(x).cuda().split(b)
        ys = torch.from_numpy(y).cuda().split(b)
        w = recipes.mlp_trainer(spec, stats, None, seed,
                                device="cuda").model.state_dict()
        runs = {}
        for arm in ("plain", "ddp", "explicit"):
            tr = recipes.mlp_trainer(spec, stats, None, seed,
                                     rules=None if arm == "plain" else rules,
                                     device="cuda")
            tr.model.load_state_dict(w)
            step = (make_shardmap_train_step(tr.loss_fn, tr.optimizer, rules)
                    if arm == "explicit" else tr.train_step)
            losses, launches, ms = dp_steps(torch, K, tr, step, xs, ys)
            tally(launches)
            require_per_step(launches, DP_STEPS,
                             {"fused_input_transform": 1}, f"13a mlp {arm}")
            runs[arm] = (losses, tr.model.state_dict(), ms)
        for arm in ("ddp", "explicit"):
            require(runs[arm][0] == runs["plain"][0], f"13a mlp {arm}: "
                    f"losses {runs[arm][0]} against {runs['plain'][0]}")
            same_params(torch, f"13a mlp {arm}", runs[arm][1],
                        runs["plain"][1])
        out["mlp_v1"] = {"batch": b, "losses": runs["plain"][0],
                         "ms_a_step": {a: r[2] for a, r in runs.items()}}

        # the U-Net: reproducible convolutions (cuDNN off, deterministic,
        # as phase 10), so that two runs can be bit-equal at all
        cudnn = torch.backends.cudnn
        saved = (cudnn.deterministic, cudnn.enabled,
                 torch.are_deterministic_algorithms_enabled())
        cudnn.deterministic, cudnn.enabled = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            ub = UNET_BATCH
            ux, uy = BU.pool(DP_UNET_STEPS * ub, seed)
            uxs = torch.from_numpy(ux).cuda().split(ub)
            uys = torch.from_numpy(uy).cuda().split(ub)
            uruns = {}
            for arm in ("plain", "ddp"):
                tr = recipes.unet_trainer(
                    get_varspec("v5"), load_asset_norms("v5"),
                    (ux[:ub], uy[:ub]), seed, steps_per_epoch=DP_UNET_STEPS,
                    model_kw=BU.model_kw("fused"),
                    rules=None if arm == "plain" else rules, device="cuda")
                losses, launches, ms = dp_steps(torch, K, tr, tr.train_step,
                                                uxs, uys)
                tally(launches)
                require_per_step(launches, DP_UNET_STEPS, {
                    "fused_input_transform": 1, "fused_gn_silu_conv3": 82},
                    f"13a unet_v5 {arm}")
                uruns[arm] = (losses, tr.model.state_dict(), ms)
            require(uruns["ddp"][0] == uruns["plain"][0], "13a unet_v5: "
                    f"losses {uruns['ddp'][0]} against {uruns['plain'][0]}")
            same_params(torch, "13a unet_v5", uruns["ddp"][1],
                        uruns["plain"][1])
        finally:
            cudnn.deterministic, cudnn.enabled = saved[:2]
            torch.use_deterministic_algorithms(saved[2])
        out["unet_v5"] = {"batch": ub, "losses": uruns["plain"][0],
                          "ms_a_step": {a: r[2] for a, r in uruns.items()}}
    finally:
        dist.destroy_process_group()
    print(f"{card}: 13a, 1-rank NCCL: mlp_v1 B={b} {DP_STEPS} steps, DDP "
          "and explicit all-reduce steps bit-equal to the step without "
          "rules (losses, every parameter), ms a step after the first "
          "(host clock, synchronized) " + ", ".join(
              f"{a} {v:.3f}" for a, v in out["mlp_v1"]["ms_a_step"].items())
          + f"; unet_v5 B={ub} {DP_UNET_STEPS} steps (cuDNN off) DDP "
          "bit-equal, ms a step " + ", ".join(
              f"{a} {v:.1f}" for a, v in out["unet_v5"]["ms_a_step"].items())
          + "; kernel 1 once a step, kernel 5 82 times a U-Net step",
          flush=True)
    return out, total


def dp_rank_main(torch, rank, world, tmp, seed) -> int:
    """One of 13b's ranks (``--dp-rank``): a gloo group through a
    FileStore in ``tmp``, run_experiment at train.num_data_shards=world
    on cuda:0 (LOCAL_RANK 0: the ranks share the card), at the preset's
    compute and then at float32.  The first run's trained state is saved
    by DistributedCheckpointer; both runs' results are written for the
    parent."""
    import torch.distributed as dist

    from climsim_tpu_torch import run as PRUN
    from climsim_tpu_torch.ops import kernels as K
    from climsim_tpu_torch.train.checkpoints import DistributedCheckpointer

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store_b"), world), rank=rank, world_size=world)
    cfg = dp_config(seed).override(f"train.num_data_shards={world}")
    try:
        runs = {}
        for f32 in (False, True):
            undo, record = recording_mlp(torch, f32=f32)
            try:
                out, launches, _ = counted(torch, K, lambda: (
                    PRUN.run_experiment(cfg, verbose=False, device="cuda")))
            finally:
                undo()
            runs[f32] = (out, [float(v) for v in record], launches)
        out, steps, launches = runs[False]
        st = out["state"]
        ck = DistributedCheckpointer(os.path.join(tmp, "dcp"))
        ck.save(st.step, st)
        ck.wait()
        out32, steps32, launches32 = runs[True]
        torch.save({
            "steps": steps,
            "history": [(r["train_loss"], r["val_loss"])
                        for r in out["history"].rows],
            "steps_f32": steps32,
            "history_f32": [(r["train_loss"], r["val_loss"])
                            for r in out32["history"].rows],
            "samples_per_sec": out["history"].rows[0]["samples_per_sec"],
            "launches": launches, "launches_f32": launches32,
            "step": st.step,
            "params": {k: v.cpu() for k, v in st.params.state_dict().items()},
            "opt": [{n: t.cpu() for n, t in s.items()}
                    for s in st.opt_state.state.values()],
            "rng": st.rng.get_state()}, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def dp_reference(torch, K, cfg, parts, f32):
    """run_experiment for ``cfg`` in this process, through
    ``recording_mlp(parts, f32)``: (result, per-step losses, launches)."""
    from climsim_tpu_torch import run as PRUN

    undo, record = recording_mlp(torch, parts, f32)
    try:
        out, launches, _ = counted(torch, K, lambda: PRUN.run_experiment(
            cfg, verbose=False, device="cuda"))
    finally:
        undo()
    return out, [float(v) for v in record], launches


def dp_two_ranks(torch, K, card, seed, tmp, run_rtol=DP_RUN_RTOL):
    """13b: DP_RANKS processes on the one card over gloo (NCCL refuses two
    ranks on one GPU), run_experiment for mlp_v1 at train.num_data_shards
    = DP_RANKS, at the preset's bf16 compute and at float32.  The ranks
    equal each other; at bf16 bit-equal to 1 process taking each step as
    DP_RANKS micro-batches; at float32 the first step's loss within
    DP_RTOL and every step's and the validation loss within ``run_rtol``
    of the plain 1-process run's; the checkpoint the ranks wrote at bf16
    restored here, at world size 1."""
    from climsim_tpu_torch import run as PRUN
    from climsim_tpu_torch.train.checkpoints import DistributedCheckpointer

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["LOCAL_RANK"] = "0"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--dp-rank", str(r), "--dp-world", str(DP_RANKS), "--dp-dir", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(DP_RANKS)]
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=600)
            require(p.returncode == 0,
                    f"13b rank {r} exited {p.returncode}:\n{log[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_RANKS)]
    cfg = dp_config(seed)
    b = cfg.data.batch_size
    micro, micro_steps, launches_m = dp_reference(torch, K, cfg, DP_RANKS,
                                                  False)
    one, plain_steps, launches1 = dp_reference(torch, K, cfg, 1, True)
    r0 = ranks[0]
    for r, rk in enumerate(ranks[1:], 1):
        for run in ("", "_f32"):
            require(rk["steps" + run] == r0["steps" + run]
                    and rk["history" + run] == r0["history" + run],
                    f"13b{run}: rank {r}'s losses {rk['steps' + run]} "
                    f"against rank 0's {r0['steps' + run]}")
        same_params(torch, f"13b rank {r} against rank 0", rk["params"],
                    r0["params"])
    micro_hist = [(h["train_loss"], h["val_loss"])
                  for h in micro["history"].rows]
    require(r0["steps"] == micro_steps and r0["history"] == micro_hist,
            f"13b: {DP_RANKS} ranks {r0['steps']} {r0['history']} against "
            f"1 process in micro-batches {micro_steps} {micro_hist}")
    same_params(torch, "13b ranks against 1 process in micro-batches",
                micro["state"].params.state_dict(), r0["params"])
    one_val = one["history"].rows[0]["val_loss"]
    first_gap = abs(r0["steps_f32"][0] - plain_steps[0]) / abs(
        plain_steps[0])
    step_gaps = [abs(a - w) / abs(w) for a, w in zip(r0["steps_f32"],
                                                      plain_steps)]
    val_gap = abs(r0["history_f32"][0][1] - one_val) / abs(one_val)
    require(len(r0["steps_f32"]) == len(plain_steps) == DP_STEPS,
            f"13b: {len(r0['steps_f32'])} steps on the ranks, "
            f"{len(plain_steps)} in 1 process")
    require(first_gap <= DP_RTOL, f"13b: the first step's loss at float32 "
            f"{r0['steps_f32'][0]} on {DP_RANKS} ranks, {plain_steps[0]} on "
            f"1 process: {first_gap:.3e} relative")
    require(max(step_gaps + [val_gap]) <= run_rtol, "13b: the float32 "
            f"losses on {DP_RANKS} ranks {r0['steps_f32']}, validation "
            f"{r0['history_f32'][0][1]}, against 1 process {plain_steps}, "
            f"{one_val}: relative gaps {step_gaps}, {val_gap:.3e} "
            f"(bound {run_rtol:g})")
    for r, rk in enumerate(ranks):
        for run in ("launches", "launches_f32"):
            require(rk[run]["fused_input_transform"] == DP_STEPS + 1,
                    f"13b rank {r}: kernel 1 launched "
                    f"{rk[run]['fused_input_transform']} times in "
                    f"{DP_STEPS} steps and 1 validation batch ({run})")
    require(launches1["fused_input_transform"] == DP_STEPS + 1
            and launches_m["fused_input_transform"]
            == DP_RANKS * (DP_STEPS + 1), "13b, 1 process: kernel 1 "
            f"launched {launches1['fused_input_transform']} and "
            f"{launches_m['fused_input_transform']} times")
    tmpl = PRUN.build_trainer(cfg, one["spec"], one["stats"], None,
                              seed + 1, None, DP_STEPS, one["grid"], False,
                              "cuda").state
    ck = DistributedCheckpointer(os.path.join(tmp, "dcp"))
    require(ck.steps() == [r0["step"]], f"13b: steps {ck.steps()}")
    got_state = ck.restore(tmpl)
    same_params(torch, "13b restored", got_state.params.state_dict(),
                r0["params"])
    for a, w in zip(got_state.opt_state.state.values(), r0["opt"]):
        for n in ("exp_avg", "exp_avg_sq", "step"):
            require(torch.equal(a[n].cpu(), w[n]), f"13b restored Adam {n}")
    require(got_state.step == r0["step"]
            and torch.equal(got_state.rng.get_state(), r0["rng"]),
            "13b restored step or generator")
    # ms a step from fit's rate (global rows over the epoch's wall time:
    # DP_STEPS steps with the epoch's permutation, and on the ranks the
    # first step's DDP set-up), the preset's compute on both sides
    ms1 = b / micro["history"].rows[0]["samples_per_sec"] * 1e3
    ms2 = [b / rk["samples_per_sec"] * 1e3 for rk in ranks]
    print(f"{card}: 13b, {DP_RANKS} ranks on ONE card over gloo (not a "
          f"scaling figure: the ranks share the card and the all-reduce "
          f"goes through the host): mlp_v1 B={b}, {DP_STEPS} steps and 1 "
          f"validation batch: the ranks equal; at bf16 compute bit-equal to "
          f"1 process in {DP_RANKS} micro-batches; at float32 against the "
          f"plain 1-process run the first step's loss {first_gap:.3e} "
          f"(bound {DP_RTOL:g}), the steps' " + ", ".join(
              f"{g:.3e}" for g in step_gaps) + f", validation {val_gap:.3e}"
          f" (bound {run_rtol:g}); ms a step (bf16) 1 process in "
          f"{DP_RANKS} micro-batches {ms1:.3f}, {DP_RANKS} ranks "
          + ", ".join(f"{v:.3f}" for v in ms2)
          + f"; the ranks' checkpoint restored at world size 1 bit-equal; "
          f"kernel 1 {DP_STEPS + 1} times a rank and run; ranks' wall "
          f"{spawn_s:.1f} s", flush=True)
    total = {}
    for launches in (launches1, launches_m, *(rk[run] for rk in ranks
                                              for run in ("launches",
                                                          "launches_f32"))):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return {"batch": b, "step_losses_ranks": r0["steps"],
            "step_losses_ranks_f32": r0["steps_f32"],
            "step_losses_1_process_f32": plain_steps,
            "first_step_rel_gap": first_gap, "step_rel_gaps": step_gaps,
            "val_rel_gap": val_gap, "ms_a_step_1_process_micro": ms1,
            "ms_a_step_ranks": ms2, "ranks_wall_s": spawn_s,
            "launches_a_rank": [rk["launches"]["fused_input_transform"]
                                for rk in ranks]}, total


def dp_gap_seeds(torch, K, card, seeds):
    """--dp-gap-seeds: 13b at each of ``seeds`` with no bound on the float32
    run's gaps; its other checks hold.  Returns each seed's gaps (the
    readings DP_RUN_RTOL rests on)."""
    out = {}
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            r, _ = dp_two_ranks(torch, K, card, seed, tmp, math.inf)
        out[seed] = {"first": r["first_step_rel_gap"],
                     "steps": r["step_rel_gaps"], "val": r["val_rel_gap"]}
    worst = max(max(g["steps"] + [g["val"]]) for g in out.values())
    print(f"{card}: 13b float32 gaps by seed, largest {worst:.3e} (bound "
          f"{DP_RUN_RTOL:g})", flush=True)
    return out


def hpo_phase(torch, K, card, seed, tmp):
    """13c: run_hpo_sweep on the card: HPO_TRIALS trials, HPO_WORKERS
    worker processes, the victim SIGKILLed holding a claim, a stale
    timeout of HPO_STALE_S; every trial has a result, a takeover
    happened, Hyperband and retrain_best gave finite scores, and the
    workers' kernel 1 launches add up."""
    from climsim_tpu_torch import run_hpo_sweep as HS

    t0 = time.perf_counter()
    res, launches, _ = counted(torch, K, lambda: HS.main([
        "--device", "cuda", "--trials", str(HPO_TRIALS),
        "--workers", str(HPO_WORKERS), "--steps", str(HPO_STEPS),
        "--stale-timeout", str(HPO_STALE_S),
        "--kill-after", str(HPO_KILL_AFTER_S), "--dir",
        os.path.join(tmp, "hpo")]))
    secs = time.perf_counter() - t0
    require(len(res["results"]) == HPO_TRIALS and res["takeovers"],
            f"13c: {len(res['results'])} results, takeovers "
            f"{res['takeovers']}")
    require(np.isfinite(res["hyperband_score"])
            and np.isfinite(res["final_score"]), "13c: scores")
    per_trial = [r["kernel1_launches"] for r in res["results"].values()]
    require(per_trial == [HPO_STEPS + 1] * HPO_TRIALS,
            f"13c: kernel 1 a trial {per_trial}, want {HPO_STEPS} steps "
            "and 1 evaluation")
    own = launches["fused_input_transform"]
    require(res["kernel1_launches"] == sum(per_trial) + own,
            "13c: the tally of kernel 1's launches")
    print(f"{card}: 13c, run_hpo_sweep: {HPO_TRIALS} trials, {HPO_WORKERS} "
          f"workers on the card, the victim killed holding a claim, "
          f"trial(s) {res['takeovers']} taken over and completed; "
          f"Hyperband {res['hyperband_score']:.5f}, retrain_best "
          f"{res['final_score']:.5f}; kernel 1 {sum(per_trial)} in the "
          f"workers + {own} here; {secs:.1f} s (sweep "
          f"{res['seconds']['sweep']:.1f}, Hyperband "
          f"{res['seconds']['hyperband']:.1f}, retrain "
          f"{res['seconds']['retrain']:.1f})", flush=True)
    launches["fused_input_transform"] += sum(per_trial)
    return {"seconds": res["seconds"], "takeovers": res["takeovers"],
            "hyperband_score": res["hyperband_score"],
            "final_score": res["final_score"],
            "kernel1_launches": res["kernel1_launches"]}, launches


def profiling_phase(torch, K, card, seed, tmp):
    """13d: cost_analysis of the mlp_v1 step (B = 3072) against the
    analytic count, StepInfo on a copy, the unet_v5 forward's count with
    kernel 5's formula beside the count without it, trace and time_fn."""
    from climsim_tpu_torch import bench_unet_train as BU
    from climsim_tpu_torch import (get_varspec, load_asset_norms,
                                   load_default_grid)
    from climsim_tpu_torch.config import PRESETS
    from climsim_tpu_torch.data import transforms as T
    from climsim_tpu_torch.data.synthetic import synthetic_inputs
    from climsim_tpu_torch.models.common import Dense
    from climsim_tpu_torch.models.unet import ClimSimUNet
    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
    from climsim_tpu_torch.train import recipes
    from climsim_tpu_torch.train.step import StepInfo
    from climsim_tpu_torch.utils import profiling as PF

    total = {}
    spec, stats = get_varspec("v1"), load_asset_norms("v1")
    b = dp_config(seed).data.batch_size
    tr = recipes.mlp_trainer(spec, stats, None, seed, device="cuda")
    xb = torch.from_numpy(synthetic_inputs(spec, b, load_default_grid(),
                                           seed=seed)).cuda()
    yb = torch.randn(b, spec.output_len, device="cuda")
    layers = [m.weight.shape for m in tr.model.modules()
              if isinstance(m, Dense)]
    w0 = tr.model.trunk.layers[0].weight.shape
    # a Dense layer: 2 B in out forward, as much for dW, and for dx but at
    # the first layer, whose input needs no gradient
    analytic = 6 * b * sum(o * i for o, i in layers) - 2 * b * w0[0] * w0[1]
    before = tr.state.step
    (info, launches, _) = counted(torch, K, lambda: StepInfo.from_step(
        tr.train_step, tr.state, xb, yb))
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    require(tr.state.step == before, "13d: StepInfo advanced the state")
    mlp_gap = abs(info.flops_per_step - analytic) / analytic
    require(mlp_gap <= FLOP_TOL, f"13d: mlp_v1 step {info.flops_per_step} "
            f"FLOPs against the analytic {analytic}")

    unet = ClimSimUNet(get_varspec("v5"),
                       **PRESETS["unet_v5"].model_kw).cuda().eval()
    ub = 384
    x5 = torch.from_numpy(synthetic_inputs(get_varspec("v5"), ub,
                                           load_default_grid(), seed=seed))
    xn = T.make_input_transform(get_varspec("v5"), load_asset_norms("v5"),
                                T.v5_online_config(), "cuda")(x5.cuda())
    with torch.no_grad():
        c, launches, _ = counted(torch, K, lambda: PF.cost_analysis(
            unet_apply_fused, unet, xn))
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    require(launches["fused_gn_silu_conv3"] == 82,
            f"13d: kernel 5 launched {launches['fused_gn_silu_conv3']} "
            "times in the counted forward")
    share = sum(v for k, v in c["flops_by_op"].items()
                if "fused_gn_silu_conv3" in k)
    want_share = sum(n * 2 * ub * l * ci * co * 3
                     for (l, ci, co), n in UNET_CHAINS.items())
    require(share == want_share, f"13d: kernel 5's formula gave {share}, "
            f"its chains {want_share}")
    plain = ub * BU.forward_flops_per_sample()["total"]   # a sample's
    unet_gap = abs(c["flops"] - plain) / plain
    require(unet_gap <= FLOP_TOL, f"13d: unet_v5 forward {c['flops']} "
            f"FLOPs against the plain model's {plain}")

    trace_dir = os.path.join(tmp, "trace")
    with PF.trace(trace_dir):
        for _ in range(2):
            tr.train_step(tr.state, xb, yb)
        torch.cuda.synchronize()
    traces = os.listdir(trace_dir)
    require(len(traces) == 1, f"13d: trace files {traces}")
    trace_mb = os.path.getsize(os.path.join(trace_dir, traces[0])) / 1e6
    step_ms = PF.time_fn(tr.train_step, tr.state, xb, yb, iters=10,
                         warmup=2) * 1e3
    require(step_ms > 0, "13d: time_fn")
    print(f"{card}: 13d, profiling: mlp_v1 step B={b} {info.flops_per_step:.6g}"
          f" FLOPs (analytic {analytic:.6g}, {mlp_gap:.2e}), peak "
          f"{info.peak_memory_bytes / 1e9:.3f} GB; unet_v5 forward B={ub} "
          f"{c['flops']:.6g} FLOPs with kernel 5's formula, "
          f"{c['flops'] - share:.6g} without (the plain model: {plain:.6g}),"
          f" peak {c['peak_memory_bytes'] / 1e9:.3f} GB; trace "
          f"{trace_mb:.2f} MB; time_fn: mlp_v1 step median {step_ms:.3f} "
          "ms (host clock, synchronized)", flush=True)
    return {"mlp_v1_step_flops": info.flops_per_step,
            "mlp_v1_analytic_flops": analytic,
            "mlp_v1_peak_bytes": info.peak_memory_bytes,
            "unet_v5_forward_flops": c["flops"],
            "unet_v5_forward_flops_without_formula": c["flops"] - share,
            "unet_v5_plain_model_flops": plain,
            "trace_mb": trace_mb, "time_fn_step_ms": step_ms}, total


def dp_phase(torch, K, card, seed):
    """Phase 13: 13a-13d.  Returns (results, the launches)."""
    results, total = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("13a", dp_one_rank), ("13b", dp_two_ranks),
                         ("13c", hpo_phase), ("13d", profiling_phase)):
            t0 = time.perf_counter()
            r, launches = fn(torch, K, card, seed, tmp)
            r["phase_s"] = time.perf_counter() - t0
            print(f"  {name}: {r['phase_s']:.1f} s", flush=True)
            results[name] = r
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
    return results, total


# --------------------------------------------------------------------------
# phase 14: the rest of distribution -- the model axis, elastic recovery,
# the sharded coupling server
# --------------------------------------------------------------------------
P14_RANKS = 2            # ranks sharing the card over gloo (as 13b)
P14_STEPS = 4            # steps an epoch in 14a and 14b
P14_EPOCHS = 2           # 14a's RPN, 14b (i), (ii) and (iv)
P14_SHRINK_EPOCHS = 3    # 14b (iii): epoch 0 on 2 ranks, 1-2 on 1
P14_POSTERIOR_ROWS = 384
P14_SERVED = 100         # sequential requests a weight type in 14c
# 14a holds the RPN over (1, 2) to the 1-process run.  Each member's
# operations are the same, but the run is not bit-equal on the card:
# the first step's losses, before any update, already differ (7.5e-8 at
# seed 0), so the card computes a member's forward in another order at
# 16 members than at 32 (the batched products or the loss's reduction);
# the bf16 roundings then flip and Adam carries the flips on.  The readings
# (--model-axis-seeds 0,...,7, NVIDIA H100 80GB HBM3 at 700 W), the
# largest over the ranks of each seed, 8 steps: the step losses' relative
# gap 7.5e-8 to 1.71e-6 (seed 4), eval_losses' 1.0e-7 to 1.11e-4 (seed
# 4), the posterior's (bf16 outputs, relative to its largest) 0 to
# 1.60e-2 (seed 6), the parameters' absolute gap 1.9e-9 to 1.84e-5 (seed
# 4).  Each bound is about twice the largest reading.
MODEL_AXIS_TOL = {"losses": 3.5e-6, "eval": 2.3e-4, "posterior": 3.2e-2,
                  "params_abs": 3.7e-5}
# 14b (iii): the run that shrank from 2 ranks to 1 after epoch 0 against
# the uninterrupted 2-rank run, the epoch losses' largest relative gap.
# At the preset's bf16 the two runs' batch halves round apart and Adam
# amplifies it over the 8 steps on 1 rank (mlp_v1's cyclic learning rate
# at its peak): the readings (--shrink-gap-seeds 0,...,7, the same card),
# epoch 1 5.7e-5 to 2.9e-3, epoch 2 1.6e-3 to 0.330 (seed 2).  The bound
# is about twice the largest: it catches a resume from the wrong epoch
# or from scratch, not the roundings; the composed run's bit-equality
# decides the resume.
SHRINK_RTOL = 0.7
P14_PARTS = ("rpn", "ms", "shrink", "rpnel", "serve")


def p14_split(seed):
    """mlp_v1 / rpn_v1's v1 columns: P14_STEPS training batches and one
    validation batch of the presets' 3072, from ``seed``."""
    from climsim_tpu_torch import get_varspec, load_default_grid
    from climsim_tpu_torch.data.synthetic import synthetic_split

    return synthetic_split(get_varspec("v1"), (P14_STEPS + 1) * 3072,
                           load_default_grid(), seed=seed)


def p14_rpn_factories(seed, data):
    """rpn_v1 at its published widths (32 members, hidden (768, 640, 512,
    640, 640), B = 3072) and its BootstrapLoader, P14_STEPS steps an
    epoch: (rules -> trainer, rules -> loader)."""
    from climsim_tpu_torch import get_varspec, load_asset_norms
    from climsim_tpu_torch.config import PRESETS
    from climsim_tpu_torch.data.pipeline import BootstrapLoader
    from climsim_tpu_torch.train.rpn_recipe import rpn_trainer

    cfg = PRESETS["rpn_v1"]
    spec, stats = get_varspec("v1"), load_asset_norms("v1")
    b, e = cfg.data.batch_size, cfg.model_kw["ensemble_size"]
    x, y = (a[:-b] for a in data)
    return (lambda rules: rpn_trainer(
        spec, stats, None, seed, cfg=cfg.transform, rules=rules,
        device="cuda", **cfg.model_kw),
        lambda rules: BootstrapLoader(x, y, b, e, rules=rules, seed=seed,
                                      steps_per_epoch=P14_STEPS,
                                      device="cuda"))


def p14_mlp_factories(seed, data, seeds=None):
    """mlp_v1 at its published widths and batch (or, with ``seeds``, its
    multiseed) over BatchLoader: (rules -> trainer, rules -> (loader,
    None))."""
    from climsim_tpu_torch import get_varspec, load_asset_norms
    from climsim_tpu_torch.config import PRESETS
    from climsim_tpu_torch.data.pipeline import BatchLoader
    from climsim_tpu_torch.train import recipes
    from climsim_tpu_torch.train.multiseed import multiseed

    cfg = PRESETS["mlp_v1"]
    spec, stats = get_varspec("v1"), load_asset_norms("v1")
    b = cfg.data.batch_size
    x, y = (a[:-b] for a in data)
    kw = dict(cfg=cfg.transform, steps_per_epoch=P14_STEPS, device="cuda",
              **cfg.model_kw)

    def tf(rules):
        if seeds is None:
            return recipes.mlp_trainer(spec, stats, None, seed, rules=rules,
                                       **kw)
        return multiseed(recipes.mlp_trainer, spec, stats, None, seeds,
                         rules=rules, **kw)

    return tf, lambda rules: (BatchLoader(x, y, b, rules, seed=seed,
                                          device="cuda"), None)


def host_params(module):
    return {k: v.detach().cpu().clone() for k, v in
            module.state_dict().items()}


def p14_rpn(torch, K, rules, seed, data):
    """14a's RPN run: P14_EPOCHS epochs of P14_STEPS steps, then
    eval_losses on the validation batch and a posterior on
    P14_POSTERIOR_ROWS of its rows.  Returns the (E,) losses a step, both
    results, this rank's members on the host, their count and bytes,
    kernel 1's launches in training and ms a step."""
    tf, lf = p14_rpn_factories(seed, data)
    tr, ld = tf(rules), lf(rules)

    def train():
        out = []
        for epoch in range(P14_EPOCHS):
            ld.set_epoch(epoch)
            out += [tr.train_step(xb, yb) for xb, yb in ld]
        return out

    losses, launches, ms = counted(torch, K, train)
    b = 3072
    xv, yv = (torch.from_numpy(a[-b:]).cuda() for a in data)
    with torch.no_grad():
        ev = tr.eval_losses(xv, yv)
        post = tr.posterior(xv[:P14_POSTERIOR_ROWS])
    torch.cuda.synchronize()
    net = tr.ensemble
    return {"losses": torch.stack(losses).cpu(), "eval": ev.cpu(),
            "posterior": post.cpu(), "params": host_params(net),
            "first": tr.first, "members": net.ensemble_size,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in net.parameters()),
            "train_launches": launches,
            "ms_a_step": ms / (P14_EPOCHS * P14_STEPS)}


def p14_multiseed(torch, K, rules, seed, data):
    """14a's multiseed: mlp_v1 at seeds (seed, seed + 1) for P14_STEPS
    steps; the (K,) losses a step and this rank's replicas."""
    tf, lf = p14_mlp_factories(seed, data, [seed, seed + 1])
    ms, (ld, _) = tf(rules), lf(rules)

    def train():
        state, out = ms.state, []
        for xb, yb in ld:
            state, m = ms.train_step(state, xb, yb)
            out.append(m["loss"])
        return out

    losses, launches, _ = counted(torch, K, train)
    return {"losses": torch.stack(losses).cpu(), "first": ms.state.first,
            "params": {ms.state.first + j: host_params(p)
                       for j, p in enumerate(ms.state.params)},
            "train_launches": launches}


def p14_elastic_run(torch, K, fit, ck, fail):
    """An elastic run under the ranks' group, failing at ``fail`` (epoch,
    step): (result, launches)."""
    from dataclasses import asdict

    from climsim_tpu_torch.train.elastic import DeviceFailure

    def inject(epoch, step):
        if (epoch, step) == fail:
            raise DeviceFailure("planted")

    K.reset_launches()
    try:
        state, rep = fit(ck, inject)
    except DeviceFailure:
        torch.cuda.synchronize()
        return {"failed": True}, dict(K.LAUNCHES)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    module = state.ensemble if hasattr(state, "ensemble") else state.params
    return {"failed": False, "report": asdict(rep),
            "params": host_params(module)}, launches


def p14_serve_rank(torch, K, rules, seed):
    """14c over the ranks: rank 0 hosts CouplingServer(rules=...) of the
    full-width MLP_v2rh bf16 and then int8 and drives it (3 concurrent
    384-column chunks, a ragged 50-row request, P14_SERVED sequential
    ones); the other ranks follow.  Each returns its launches."""
    from climsim_tpu_torch import (get_varspec, load_asset_norms,
                                   load_default_grid)
    from climsim_tpu_torch.data.synthetic import synthetic_inputs
    from climsim_tpu_torch.models import OnlineMLP
    from climsim_tpu_torch.online.server import (CouplingClient,
                                                 CouplingServer,
                                                 serve_follower)
    from climsim_tpu_torch.online.wrapper import make_fast_mlp_wrapper
    from climsim_tpu_torch.utils.migrate import port_flax_online_mlp

    spec, stats = get_varspec("v2_rh"), load_asset_norms("v2_rh")
    model = OnlineMLP(spec, hidden=FULL_HIDDEN)
    model.load_state_dict(port_flax_online_mlp(
        flax_tree(spec, FULL_HIDDEN, seed)))
    grid = load_default_grid()
    chunks = [synthetic_inputs(spec, 384, grid, seed=seed + 10 + i)
              for i in range(3)]
    ragged = synthetic_inputs(spec, 50, grid, seed=seed + 20)
    out = {}
    for w, dt in (("bf16", torch.bfloat16), ("int8", "int8")):
        wrap = make_fast_mlp_wrapper(model, stats, spec, dt, device="cuda")
        K.reset_launches()
        if rules.rank:
            calls = serve_follower(wrap, spec.input_len, rules)
            torch.cuda.synchronize()
            out[w] = {"calls": calls, "launches": dict(K.LAUNCHES)}
            continue
        srv = CouplingServer(wrap, spec.input_len, base_chunk=384,
                             max_batch=6144, device="cuda",
                             rules=rules).start()
        try:
            replies, lat = drive(CouplingClient, srv, chunks, ragged,
                                 P14_SERVED)
        finally:
            srv.stop()
        torch.cuda.synchronize()
        out[w] = {"replies": replies, "lat": lat, "buckets": srv.buckets,
                  "calls": srv.stats.batches + len(srv.buckets),
                  "summary": srv.stats.summary(),
                  "launches": dict(K.LAUNCHES)}
    return out


def p14_rank_main(torch, rank, world, tmp, seed, parts) -> int:
    """One of phase 14's ranks (``--p14-rank``): a gloo group through a
    FileStore in ``tmp`` on cuda:0 (the ranks share the card), running
    ``parts`` in order; its results go to ``tmp/p14_rank<r>.pt``."""
    import torch.distributed as dist

    from climsim_tpu_torch.ops import kernels as K
    from climsim_tpu_torch.parallel.mesh import ShardingRules, make_mesh
    from climsim_tpu_torch.train.checkpoints import DistributedCheckpointer
    from climsim_tpu_torch.train.elastic import elastic_fit, elastic_rpn_fit

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store_14"), world), rank=rank, world_size=world)
    out = {}
    try:
        data = p14_split(seed)
        if "rpn" in parts or "ms" in parts:
            rules = ShardingRules(make_mesh(1, world, device="cuda"))
            if "rpn" in parts:
                out["rpn"] = p14_rpn(torch, K, rules, seed, data)
            if "ms" in parts:
                out["ms"] = p14_multiseed(torch, K, rules, seed, data)
        if "shrink" in parts:
            tf, lf = p14_mlp_factories(seed, data)
            for name, fail in (("clean", None), ("fail", (1, 1))):
                ck = DistributedCheckpointer(os.path.join(tmp, "shrink_"
                                                          + name))
                out["shrink_" + name] = p14_elastic_run(
                    torch, K, lambda c, inj: elastic_fit(
                        tf, lf, P14_SHRINK_EPOCHS, device="cuda",
                        checkpointer=c, fault_injector=inj), ck, fail)
        if "rpnel" in parts:
            rf, lf = p14_rpn_factories(seed, data)
            out["rpnel"] = p14_elastic_run(
                torch, K, lambda c, inj: elastic_rpn_fit(
                    rf, lf, P14_EPOCHS, 32, device="cuda", checkpointer=c,
                    fault_injector=inj),
                DistributedCheckpointer(os.path.join(tmp, "rpnel")), (1, 1))
        if "serve" in parts:
            rules = ShardingRules(make_mesh(world, 1, device="cuda"))
            out["serve"] = p14_serve_rank(torch, K, rules, seed)
        torch.save(out, os.path.join(tmp, f"p14_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def p14_spawn(tmp, seed, parts, timeout=600):
    """P14_RANKS processes of this script on the card (``--p14-rank``);
    returns their results and the wall seconds."""
    import torch

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["LOCAL_RANK"] = "0"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--p14-rank", str(r), "--p14-world", str(P14_RANKS), "--p14-dir",
         tmp, "--p14-parts", ",".join(parts)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(P14_RANKS)]
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=timeout)
            require(p.returncode == 0,
                    f"14 rank {r} exited {p.returncode}:\n{log[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ([torch.load(os.path.join(tmp, f"p14_rank{r}.pt"),
                        weights_only=False) for r in range(P14_RANKS)],
            time.perf_counter() - t0)


def gaps(torch, got, want):
    """(largest relative gap, largest absolute gap) of two tensors."""
    d = float((got.double() - want.double()).abs().max())
    return d / max(float(want.double().abs().max()), 1e-30), d


def p14_whole(torch, ranks, key):
    """The members of 14a's ranks (every rank is at data index 0 of the
    (1, M) mesh), concatenated in model order."""
    parts = sorted((r[key] for r in ranks), key=lambda r: r["first"])
    return {k: torch.cat([p["params"][k] for p in parts])
            for k in parts[0]["params"]}


def p14_rpn_check(torch, ranks, one, tol=MODEL_AXIS_TOL):
    """14a's RPN against the 1-process run: the members a rank holds and
    their bytes (a rank keeping all 32 fails), every rank's gathered
    losses, eval_losses and posterior, and the members' parameters; the
    gaps, each held to its bound in ``tol`` (None: read only).  The first
    step's losses' gap is read, not bounded."""
    e = 32
    for r, rk in enumerate(ranks):
        got = rk["rpn"]
        require(got["members"] == e // P14_RANKS
                and got["first"] == r * e // P14_RANKS
                and got["param_bytes"] * P14_RANKS == one["param_bytes"],
                f"14a rank {r}: {got['members']} members from "
                f"{got['first']}, {got['param_bytes']} parameter bytes of "
                f"the ensemble's {one['param_bytes']}")
        require(got["train_launches"]["fused_input_transform"]
                == P14_EPOCHS * P14_STEPS, f"14a rank {r}: kernel 1 "
                f"launched {got['train_launches']['fused_input_transform']}"
                f" times in {P14_EPOCHS * P14_STEPS} RPN steps")
    out = {}
    for k in ("losses", "eval", "posterior"):
        out[k] = max(gaps(torch, rk["rpn"][k], one[k])[0] for rk in ranks)
    whole = p14_whole(torch, ranks, "rpn")
    out["params_abs"] = max(gaps(torch, whole[k], v)[1]
                            for k, v in one["params"].items())
    for k, v in out.items():
        require(tol is None or v <= tol[k], f"14a: the RPN over (1, "
                f"{P14_RANKS}) against 1 process, {k} gap {v:.3e} (bound "
                f"{tol and tol[k]}); all gaps {out}")
    out["first_step_losses"] = max(gaps(torch, rk["rpn"]["losses"][0],
                                        one["losses"][0])[0] for rk in ranks)
    return out


def p14_shrink(torch, K, ranks, tmp, seed, data, rtol=SHRINK_RTOL):
    """14b (iii): the ranks' failing run relaunched here at world 1 from
    its checkpoint (epoch 0 on 2 ranks) against the composed run (the
    clean ranks' epoch-0 checkpoint, resumed here): bit-equal; and its
    epoch losses' gap to the uninterrupted 2-rank run, within ``rtol``."""
    import shutil

    from climsim_tpu_torch.train.checkpoints import DistributedCheckpointer
    from climsim_tpu_torch.train.elastic import elastic_fit

    tf, lf = p14_mlp_factories(seed, data)
    for r, rk in enumerate(ranks):
        require(rk["shrink_fail"][0] == {"failed": True},
                f"14b (iii) rank {r}: the planted failure did not end it")
        require(not rk["shrink_clean"][0]["failed"], "14b (iii): clean run")
    clean = ranks[0]["shrink_clean"][0]
    composed = os.path.join(tmp, "shrink_composed")
    os.makedirs(composed)
    shutil.copytree(os.path.join(tmp, "shrink_clean", "step_1"),
                    os.path.join(composed, "step_1"))
    shutil.copy(os.path.join(tmp, "shrink_clean", "elastic.json"), composed)
    runs = {}
    for name, d in (("relaunch", "shrink_fail"), ("composed", composed)):
        ck = DistributedCheckpointer(os.path.join(tmp, d))
        (state, rep), launches, _ = counted(torch, K, lambda: elastic_fit(
            tf, lf, P14_SHRINK_EPOCHS, device="cuda", checkpointer=ck))
        runs[name] = (host_params(state.params), rep, launches)
    got, rep, launches = runs["relaunch"]
    require(rep.mesh_history == [(P14_RANKS, 1), (1, 1)]
            and rep.epochs_completed == P14_SHRINK_EPOCHS
            and len(rep.epoch_losses) == P14_SHRINK_EPOCHS,
            f"14b (iii): report {rep}")
    require(launches["fused_input_transform"]
            == (P14_SHRINK_EPOCHS - 1) * P14_STEPS,
            f"14b (iii): kernel 1 launched {launches} in the relaunch")
    same_params(torch, "14b (iii) relaunch against the composed run",
                got, runs["composed"][0])
    require(rep.epoch_losses == runs["composed"][1].epoch_losses,
            "14b (iii): epoch losses against the composed run")
    want = clean["report"]["epoch_losses"]
    loss_gaps = [abs(a - w) / abs(w) for a, w in zip(rep.epoch_losses, want)]
    require(loss_gaps[0] == 0.0, "14b (iii): epoch 0's loss is the ranks'")
    require(max(loss_gaps) <= rtol, f"14b (iii): epoch losses "
            f"{rep.epoch_losses} against the uninterrupted 2-rank run's "
            f"{want}: gaps {loss_gaps} (bound {rtol:g})")
    param_gap = max(gaps(torch, got[k], v)[0]
                    for k, v in clean["params"].items())
    return {"loss_gaps": loss_gaps, "param_rel_gap": param_gap,
            "mesh_history": rep.mesh_history}, launches


def p14_agent(torch, card, tmp, seed, want_params):
    """14b (ii): torch.distributed.run --standalone --nproc-per-node 1
    --max-restarts 1 over NCCL; the worker (this script,
    ``--elastic-worker``) fails at epoch 1, step 1 on attempt 0 only, the
    agent restarts it, and it resumes from its DCP checkpoint: bit-equal
    to the uninterrupted run ``want_params``."""
    d = os.path.join(tmp, "agent")
    os.makedirs(d)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "--max-restarts", "1",
         os.path.abspath(__file__), "--seed", str(seed), "--elastic-worker",
         d], capture_output=True, text=True, env=env, timeout=600)
    wall = time.perf_counter() - t0
    require(p.returncode == 0, f"14b (ii): torchrun exited {p.returncode}:\n"
            + (p.stdout + p.stderr)[-4000:])
    attempts = sorted(f for f in os.listdir(d) if f.startswith("attempt"))
    require(attempts == ["attempt0.pt", "attempt1.pt"],
            f"14b (ii): attempts {attempts} (a worker the phase did not "
            "plant a failure in was restarted)")
    a0, a1 = (torch.load(os.path.join(d, f), weights_only=False)
              for f in attempts)
    require(a0["planted"] and not a1["planted"], "14b (ii): the failure was "
            "not the planted one")
    out = torch.load(os.path.join(d, "out.pt"), weights_only=False)
    rep = out["report"]
    require(rep["failures"] == 1 and rep["epochs_completed"] == P14_EPOCHS
            and [tuple(m) for m in rep["mesh_history"]] == [(1, 1), (1, 1)]
            and len(rep["recovery_seconds"]) == 1, f"14b (ii): report {rep}")
    same_params(torch, "14b (ii) restarted by the agent against the "
                "uninterrupted run", out["params"], want_params)
    k1 = [a["launches"]["fused_input_transform"] for a in (a0, a1)]
    require(k1 == [P14_STEPS + 1, P14_STEPS], f"14b (ii): kernel 1 "
            f"launched {k1} times in the attempts")
    restart_s = a1["first_step"] - a0["failed"]
    return {"restart_to_first_step_s": restart_s,
            "recovery_seconds": rep["recovery_seconds"][0],
            "attempt1_start_to_first_step_s":
                a1["first_step"] - a1["start"],
            "torchrun_wall_s": wall, "kernel1_by_attempt": k1}, {
        k: a0["launches"][k] + a1["launches"][k] for k in KERNEL_NAMES}


def elastic_worker_main(torch, directory, seed) -> int:
    """14b (ii)'s worker, started by torch.distributed.run: NCCL on the
    card, elastic_fit of mlp_v1 with a DistributedCheckpointer, a planted
    DeviceFailure at epoch 1, step 1 on attempt 0; each attempt writes its
    launches and times, the last one the trained state."""
    from dataclasses import asdict

    import torch.distributed as dist

    from climsim_tpu_torch.ops import kernels as K
    from climsim_tpu_torch.parallel.mesh import distributed_init_if_needed
    from climsim_tpu_torch.train.checkpoints import DistributedCheckpointer
    from climsim_tpu_torch.train.elastic import DeviceFailure, elastic_fit

    start = time.time()
    distributed_init_if_needed()
    require(dist.get_backend() == "nccl", "14b (ii): the worker is not NCCL")
    attempt = int(os.environ["TORCHELASTIC_RESTART_COUNT"])
    info = {"start": start, "first_step": None, "planted": False,
            "failed": None}

    def inject(epoch, step):
        if info["first_step"] is None:
            info["first_step"] = time.time()
        if attempt == 0 and (epoch, step) == (1, 1):
            info["planted"], info["failed"] = True, time.time()
            raise DeviceFailure("planted on attempt 0")

    tf, lf = p14_mlp_factories(seed, p14_split(seed))
    K.reset_launches()
    try:
        state, rep = elastic_fit(tf, lf, P14_EPOCHS, device="cuda",
                                 checkpointer=DistributedCheckpointer(
                                     os.path.join(directory, "ck")),
                                 fault_injector=inject)
        torch.save({"params": host_params(state.params),
                    "report": asdict(rep)}, os.path.join(directory,
                                                         "out.pt"))
    finally:
        torch.cuda.synchronize()
        torch.save(dict(info, launches=dict(K.LAUNCHES)),
                   os.path.join(directory, f"attempt{attempt}.pt"))
        dist.destroy_process_group()
    return 0


def p14_serve_check(torch, K, card, ranks, seed, direct):
    """14c: the sharded server's replies (2 gloo ranks, and a 1-rank NCCL
    group here) bit-equal to the direct wrapper calls, buckets divisible
    by the world size, kernels 1-3 launched on every rank, round trips
    beside the unsharded server's."""
    import torch.distributed as dist

    from climsim_tpu_torch import (get_varspec, load_default_grid)
    from climsim_tpu_torch.data.synthetic import synthetic_inputs
    from climsim_tpu_torch.online.server import (CouplingClient,
                                                 CouplingServer)
    from climsim_tpu_torch.parallel.mesh import ShardingRules, make_mesh

    spec, grid = get_varspec("v2_rh"), load_default_grid()
    chunks = [synthetic_inputs(spec, 384, grid, seed=seed + 10 + i)
              for i in range(3)]
    ragged = synthetic_inputs(spec, 50, grid, seed=seed + 20)
    kname = {"bf16": "fused_mlp_forward", "int8": "fused_mlp_forward_int8"}

    def same_replies(label, replies, wrap):
        for x, y in zip(chunks + [ragged], replies):
            with torch.inference_mode():
                want = wrap(torch.from_numpy(x).cuda()).cpu().numpy()
            require(np.array_equal(y, want), f"14c {label}: a reply "
                    "differs from the direct wrapper call")

    out, total = {}, {k: 0 for k in KERNEL_NAMES}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store_c"), 1), rank=0, world_size=1)
        try:
            rules = ShardingRules(make_mesh(1, 1, device="cuda"))
            for w, wrap in direct.items():
                for name, r in (("unsharded", None), ("nccl_1", rules)):
                    srv = CouplingServer(wrap, spec.input_len,
                                         base_chunk=384, max_batch=6144,
                                         device="cuda", rules=r).start()
                    try:
                        (replies, lat), launches, _ = counted(
                            torch, K, lambda: drive(
                                CouplingClient, srv, chunks, ragged,
                                P14_SERVED))
                    finally:
                        srv.stop()
                    same_replies(f"{w} {name}", replies, wrap)
                    runs[w, name] = lat
                    for k in KERNEL_NAMES:
                        total[k] += launches[k]
                    require(launches["fused_input_transform"] > 0
                            and launches[kname[w]] > 0,
                            f"14c {w} {name}: launches {launches}")
        finally:
            dist.destroy_process_group()
    for w, wrap in direct.items():
        lead = ranks[0]["serve"][w]
        same_replies(f"{w} {P14_RANKS} ranks", lead["replies"], wrap)
        require(all(b % P14_RANKS == 0 for b in lead["buckets"]),
                f"14c: buckets {lead['buckets']}")
        for r, rk in enumerate(ranks):
            got = rk["serve"][w]
            require(got["calls"] == lead["calls"] > 0
                    and got["launches"]["fused_input_transform"] > 0
                    and got["launches"][kname[w]] > 0,
                    f"14c {w} rank {r}: {got['calls']} calls, launches "
                    f"{got['launches']}")
            for k in KERNEL_NAMES:
                total[k] += got["launches"][k]
        runs[w, "gloo_2"] = lead["lat"]
        out[w] = {name: {"p50_ms": float(np.percentile(runs[w, name], 50)),
                         "p99_ms": float(np.percentile(runs[w, name], 99))}
                  for name in ("unsharded", "nccl_1", "gloo_2")}
        out[w]["buckets_2"] = lead["buckets"]
    print(f"{card}: 14c, CouplingServer(rules=...) of the full MLP_v2rh: "
          f"every reply bit-equal to the direct call, kernels 1-3 on every "
          f"rank; 384-column round trip p50 / p99 ms over {P14_SERVED} "
          "requests, unsharded, 1-rank NCCL group, 2 gloo ranks on one "
          "card: " + "; ".join(
              f"{w} " + ", ".join(f"{v['p50_ms']:.3f} / {v['p99_ms']:.3f}"
                                  for n, v in out[w].items()
                                  if n != "buckets_2")
              for w in direct), flush=True)
    return out, total


def distribution_phase(torch, K, card, seed, direct):
    """Phase 14: 14a-14c.  ``direct``: the MLP_v2rh bf16 and int8 wrappers
    (phase 4's).  Returns (results, the launches)."""
    from climsim_tpu_torch.train.checkpoints import DistributedCheckpointer
    from climsim_tpu_torch.train.elastic import (DeviceFailure, elastic_fit,
                                                 elastic_rpn_fit)

    results, total = {}, {k: 0 for k in KERNEL_NAMES}

    def tally(launches):
        for k in KERNEL_NAMES:
            total[k] += launches.get(k, 0)

    t0 = time.perf_counter()
    data = p14_split(seed)
    with tempfile.TemporaryDirectory() as tmp:
        ranks, spawn_s = p14_spawn(tmp, seed, P14_PARTS)
        for rk in ranks:
            for part in ("rpn", "ms"):
                tally(rk[part]["train_launches"])
            for part in ("shrink_clean", "shrink_fail", "rpnel"):
                tally(rk[part][1])
        # 14a: the model axis against 1 process
        one = p14_rpn(torch, K, None, seed, data)
        tally(one["train_launches"])
        require(one["train_launches"]["fused_input_transform"]
                == P14_EPOCHS * P14_STEPS, "14a: kernel 1 in 1 process")
        rpn_gaps = p14_rpn_check(torch, ranks, one)
        ms1 = p14_multiseed(torch, K, None, seed, data)
        tally(ms1["train_launches"])
        for r, rk in enumerate(ranks):
            got = rk["ms"]
            require(torch.equal(got["losses"], ms1["losses"]),
                    f"14a multiseed rank {r}: losses {got['losses']} "
                    f"against 1 process {ms1['losses']}")
            require(len(got["params"]) == 1 and got["train_launches"][
                "fused_input_transform"] == P14_STEPS,
                    f"14a multiseed rank {r}: replicas or launches")
            for k, p in got["params"].items():
                same_params(torch, f"14a multiseed replica {k}", p,
                            ms1["params"][k])
        results["14a"] = {
            "rpn_gaps": rpn_gaps, "rpn_ms_a_step_1_process":
                one["ms_a_step"],
            "rpn_ms_a_step_ranks": [rk["rpn"]["ms_a_step"] for rk in ranks],
            "rpn_param_bytes_a_rank": ranks[0]["rpn"]["param_bytes"],
            "multiseed": "bit-equal"}
        print(f"{card}: 14a, the model axis over (1, {P14_RANKS}) (2 gloo "
              "ranks on one card: not a scaling figure): rpn_v1 (32 "
              f"members, B=3072, {P14_EPOCHS} epochs of {P14_STEPS} steps), "
              f"16 members and {ranks[0]['rpn']['param_bytes']} parameter "
              f"bytes a rank, gaps to 1 process {rpn_gaps}; ms a step 1 "
              f"process {one['ms_a_step']:.3f}, ranks " + ", ".join(
                  f"{rk['rpn']['ms_a_step']:.3f}" for rk in ranks)
              + f"; multiseed mlp_v1 2 seeds bit-equal; kernel 1 once a "
              f"step on every rank; ranks' wall {spawn_s:.1f} s", flush=True)

        # 14b (i): one process, recovery in the process
        tf, lf = p14_mlp_factories(seed, data)
        fired = []

        def inject(epoch, step):
            if (epoch, step) == (1, 1) and not fired:
                fired.append(1)
                raise DeviceFailure("planted")

        (clean, rep_c), l_clean, _ = counted(torch, K, lambda: elastic_fit(
            tf, lf, P14_EPOCHS, device="cuda"))
        (state, rep), l_fail, _ = counted(torch, K, lambda: elastic_fit(
            tf, lf, P14_EPOCHS, device="cuda", fault_injector=inject))
        tally(l_clean)
        tally(l_fail)
        want = host_params(clean.params)
        require(fired and rep.failures == 1 and rep.epoch_losses
                == rep_c.epoch_losses, f"14b (i): {rep} against {rep_c}")
        same_params(torch, "14b (i) recovered against uninterrupted",
                    host_params(state.params), want)
        require(l_clean["fused_input_transform"] == P14_EPOCHS * P14_STEPS
                and l_fail["fused_input_transform"]
                == P14_EPOCHS * P14_STEPS + 1,
                f"14b (i): kernel 1 {l_clean} and {l_fail}")
        del clean, state
        # (ii) torchrun's agent restarts a worker over NCCL
        agent, l_agent = p14_agent(torch, card, tmp, seed, want)
        tally(l_agent)
        # (iii) a shrink from 2 ranks to 1
        shrink, l_shrink = p14_shrink(torch, K, ranks, tmp, seed, data)
        tally(l_shrink)
        # (iv) the RPN's members from (1, 2) to (1, 1)
        for r, rk in enumerate(ranks):
            require(rk["rpnel"][0] == {"failed": True},
                    f"14b (iv) rank {r}: the planted failure did not end it")
        rf, rlf = p14_rpn_factories(seed, data)
        (tr, rep4), l_rpn, _ = counted(torch, K, lambda: elastic_rpn_fit(
            rf, rlf, P14_EPOCHS, 32, device="cuda",
            checkpointer=DistributedCheckpointer(os.path.join(tmp,
                                                              "rpnel"))))
        tally(l_rpn)
        require(rep4.mesh_history == [(1, P14_RANKS), (1, 1)]
                and l_rpn["fused_input_transform"] == P14_STEPS,
                f"14b (iv): {rep4}, launches {l_rpn}")
        got = host_params(tr.ensemble)
        del tr
        rpn_gap = max(gaps(torch, got[k], v)[1]
                      for k, v in one["params"].items())
        tol = MODEL_AXIS_TOL["params_abs"]
        require(rpn_gap <= tol, f"14b (iv): the members resumed on 1 "
                f"process against the 1-process run: {rpn_gap:.3e} (bound "
                f"{tol:g})")
        results["14b"] = {"agent": agent, "shrink": shrink,
                          "rpn_resumed_param_gap": rpn_gap,
                          "one_process_recovery_s": rep.recovery_seconds}
        print(f"{card}: 14b, elastic: (i) 1 process, a DeviceFailure at "
              "epoch 1 step 1 recovered in the process, bit-equal to the "
              f"uninterrupted run, recovery {rep.recovery_seconds[0]:.3f} s; "
              "(ii) torchrun --max-restarts 1 over NCCL, the worker failing "
              "on attempt 0, restarted and resumed from DCP, bit-equal; "
              f"failure to the resumed first step {agent['restart_to_first_step_s']:.1f} s "
              f"(the restored state ready {agent['recovery_seconds']:.1f} s "
              "after the failure); (iii) 2 ranks -> 1 bit-equal to the "
              f"composed run, epoch-loss gaps to the 2-rank run "
              f"{shrink['loss_gaps']}; (iv) rpn_v1 (1, 2) -> (1, 1) gap "
              f"{rpn_gap:.3e}", flush=True)
        # 14c: the sharded server
        results["14c"], l_serve = p14_serve_check(torch, K, card, ranks,
                                                   seed, direct)
        tally(l_serve)
    results["seconds"] = time.perf_counter() - t0
    return results, total


def model_axis_seeds(torch, K, card, seeds):
    """--model-axis-seeds: 14a's RPN at each of ``seeds``, its gaps to 1
    process read with no bound (the readings MODEL_AXIS_TOL rests on)."""
    out = {}
    for seed in seeds:
        data = p14_split(seed)
        with tempfile.TemporaryDirectory() as tmp:
            ranks, _ = p14_spawn(tmp, seed, ("rpn",))
        out[seed] = p14_rpn_check(torch, ranks, p14_rpn(torch, K, None, seed,
                                                        data), None)
        print(f"{card}: 14a seed {seed}: {out[seed]}", flush=True)
    return out


def shrink_gap_seeds(torch, K, card, seeds):
    """--shrink-gap-seeds: 14b (iii) at each of ``seeds``, the epoch-loss
    gaps to the uninterrupted 2-rank run read with no bound (the readings
    SHRINK_RTOL rests on); its other checks hold."""
    out = {}
    for seed in seeds:
        data = p14_split(seed)
        with tempfile.TemporaryDirectory() as tmp:
            ranks, _ = p14_spawn(tmp, seed, ("shrink",))
            out[seed], _ = p14_shrink(torch, K, ranks, tmp, seed, data,
                                      math.inf)
        print(f"{card}: 14b (iii) seed {seed}: {out[seed]}", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 15: the last five scripts as port entries
# --------------------------------------------------------------------------
# run_all_baselines at the script's widths and batches, cut in rows and
# epochs: 8 x 384 training rows (3 batches of 1024), the script's 12 x 384
# scoring rows, 6 epochs (HSR: 2 of its MSE stage, 4 of its NLL stage;
# the CNN max(6 // 2, 3) = 3)
SCRIPTS_TRAIN_ROWS = 8 * 384
SCRIPTS_SCORE_ROWS = 12 * 384
SCRIPTS_EPOCHS = 6
# make_offline_figures: one day of scoring rows, its epochs and rows as
# run_all_baselines' above
FIGURES_DAYS = 1
# run_real_baselines on a synthetic netCDF tree of 384-column pairs: 24,
# so that the canonical train stride of 7 leaves 4 files (1536 rows, the
# least over the RPN's 1280) and the scoring split's fallback 2 (768)
REAL_PAIRS = 24
REAL_EPOCHS = 1
INGEST_PAIRS = 8
# serial only: a spawned pool's start costs ~7 s here, and the pools are
# timed by python -m climsim_tpu_torch.bench_ingest at --pairs 400
INGEST_WORKERS = "0"
# bench_all: the fast rows at one resident epoch of their pool; CNN and
# U-Net at their batch (4096: both fit, 28.05 and 46.60 GB on an H100)
# from a pool of this many batches, one epoch
BENCH_SLOW_POOL_BATCHES = 2


def scripts_kernel1(info, launches, label):
    """Kernel 1 launched once a training step and once a batch that ran a
    model's input transform outside training (prediction, sampling) of
    train_and_score's ``info``; no other kernel."""
    want = sum(i["steps"] + i["transform_calls"] for i in info.values())
    per_model = {m: (i["steps"], i["transform_calls"])
                 for m, i in info.items()}
    require(launches["fused_input_transform"] == want,
            f"{label}: kernel 1 launched "
            f"{launches['fused_input_transform']} times, want {want} "
            f"(steps, other calls: {per_model})")
    require(sum(launches.values()) == want,
            f"{label}: other kernels launched: {launches}")


def tables_finite(tables, label):
    for m, t in tables.items():
        for v, row in t.items():
            require(all(np.isfinite(x) for x in row.values()),
                    f"{label}: {m} {v} {row}")


def scripts_phase(torch, K, card, seed, tmp):
    """Phase 15: run_all_baselines, make_offline_figures,
    run_real_baselines, bench_ingest and bench_all's rows on the card.
    Returns (results, the launches)."""
    from pathlib import Path

    from climsim_tpu_torch import bench_all as BA
    from climsim_tpu_torch import bench_ingest as BI
    from climsim_tpu_torch import make_offline_figures as MOF
    from climsim_tpu_torch import run_all_baselines as RAB
    from climsim_tpu_torch import run_real_baselines as RRB
    from climsim_tpu_torch import get_varspec, load_asset_norms
    from climsim_tpu_torch.data.synthnc import make_tree
    from climsim_tpu_torch.grid import load_default_grid
    from climsim_tpu_torch.models.common import Dense
    from climsim_tpu_torch.train import recipes

    del seed   # every entry draws from its own fixed seeds, as the scripts
    out, total = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # 15a: run_all_baselines
    t0 = time.perf_counter()
    res, launches, _ = counted(torch, K, lambda: RAB.main([
        "--epochs", str(SCRIPTS_EPOCHS), "--n-train", str(SCRIPTS_TRAIN_ROWS),
        "--n-score", str(SCRIPTS_SCORE_ROWS),
        "--out", os.path.join(tmp, "SYNTHETIC_RESULTS.torch.md"),
        "--device", "cuda"]))
    add(launches)
    info = res["train_info"]
    require(list(info) == ["MLP", "ED", "CNN", "HSR", "cVAE", "RPN"],
            f"15a: models {list(info)}")
    scripts_kernel1(info, launches, "15a run_all_baselines")
    for m, i in info.items():
        require(np.isfinite(i["loss"]) and np.isfinite(i["first_loss"]),
                f"15a: {m} losses {i['first_loss']} -> {i['loss']}")
        require(i["fused"] == (m in ("MLP", "ED", "CNN", "cVAE")),
                f"15a: {m} fused {i['fused']}")
    for m in ("MLP", "HSR", "RPN"):
        require(info[m]["loss"] < info[m]["first_loss"],
                f"15a: {m}'s loss did not fall: {info[m]['first_loss']} -> "
                f"{info[m]['loss']}")
    tables_finite(res["tables"], "15a")
    require(os.path.exists(res["out"]), "15a wrote no report")
    out["run_all_baselines"] = {
        "seconds": time.perf_counter() - t0,
        "launches": launches["fused_input_transform"],
        "train_info": info}
    print(f"{card}: 15a run_all_baselines ({SCRIPTS_TRAIN_ROWS} rows, "
          f"{SCRIPTS_EPOCHS} epochs): " + "; ".join(
              f"{m} {i['first_loss']:.4f} -> {i['loss']:.4f}, "
              f"{i['sps']:,.0f} samples/s" for m, i in info.items())
          + f"; kernel 1 {launches['fused_input_transform']} launches "
          f"({out['run_all_baselines']['seconds']:.1f} s)", flush=True)

    # 15b: make_offline_figures
    t0 = time.perf_counter()
    res, launches, _ = counted(torch, K, lambda: MOF.main([
        "--epochs", "1", "--days", str(FIGURES_DAYS),
        "--n-train", str(SCRIPTS_TRAIN_ROWS),
        "--outdir", os.path.join(tmp, "figures"), "--device", "cuda"]))
    add(launches)
    scripts_kernel1(res["train_info"], launches, "15b make_offline_figures")
    tables_finite(res["tables"], "15b")
    for v, maps in res["r2maps"].items():
        for m, a in maps.items():
            require(bool(np.isfinite(a).all()), f"15b: R2 map {v} {m}")
    require(bool(np.isfinite(res["pressure_lat"]).all()), "15b: pressure")
    out["make_offline_figures"] = {"seconds": time.perf_counter() - t0,
                                   "figures": res["figures"]}
    print(f"{card}: 15b make_offline_figures: arrays finite, figures "
          f"{res['figures'] or 'not drawn (no matplotlib)'} "
          f"({out['make_offline_figures']['seconds']:.1f} s)", flush=True)

    # 15c: run_real_baselines on a synthetic netCDF tree
    t0 = time.perf_counter()
    tree = Path(tmp) / "tree"
    make_tree(tree / "0001-02", load_default_grid(), nsteps=REAL_PAIRS,
              ncol=384)
    res, launches, _ = counted(torch, K, lambda: RRB.main([
        "--data-dir", str(tree), "--shard-dir", os.path.join(tmp, "shards"),
        "--epochs", str(REAL_EPOCHS), "--workers", "0",
        "--out", os.path.join(tmp, "REAL_RESULTS.torch.md"),
        "--device", "cuda"]))
    add(launches)
    scripts_kernel1(res["train_info"], launches, "15c run_real_baselines")
    tables_finite(res["tables"], "15c")
    with open(res["out"]) as f:
        require("| ref MLP |" in f.read(), "15c: no reference columns")
    out["run_real_baselines"] = {"seconds": time.perf_counter() - t0,
                                 "pairs": REAL_PAIRS}
    print(f"{card}: 15c run_real_baselines on {REAL_PAIRS} pairs "
          f"({out['run_real_baselines']['seconds']:.1f} s)", flush=True)

    # 15d: bench_ingest (host only)
    rows, launches, ms = counted(torch, K, lambda: BI.main(
        ["--pairs", str(INGEST_PAIRS), "--workers", INGEST_WORKERS]))
    require(sum(launches.values()) == 0, f"15d launched {launches}")
    require(all(r["pairs_per_s"] > 0 for r in rows), f"15d: {rows}")
    out["bench_ingest"] = {"pairs": INGEST_PAIRS, "rows": rows,
                           "seconds": ms / 1e3}

    # 15e: bench_all's rows
    spec = get_varspec("v1")
    mlp = recipes.mlp_trainer(spec, load_asset_norms("v1"), None, 0,
                              hidden=(768, 640, 512, 640, 640),
                              device="cpu")
    layers = [m.weight.shape for m in mlp.model.modules()
              if isinstance(m, Dense)]
    del mlp
    rows = {}
    for name, (fac, spec_name, batch, pool, label) in BA.CONFIGS.items():
        if name in ("CNN", "UNet"):
            pool = BENCH_SLOW_POOL_BATCHES * batch
        results = []
        row, launches, _ = counted(torch, K, lambda: BA.bench_generic(
            label, fac, spec_name, batch, pool, results, epoch_rows=pool,
            device="cuda"))
        add(launches)
        rows[label] = row
        require(launches["fused_input_transform"] == row["steps"]
                + row["warmup_steps"] + 1 == sum(launches.values()),
                f"15e {label}: launches {launches}, {row['steps']} steps "
                f"after {row['warmup_steps']}, and the counted step")
        if name == "MLP":
            analytic = (6 * batch * sum(o * i for o, i in layers)
                        - 2 * batch * layers[0][0] * layers[0][1])
            gap = abs(row["step_flops"] - analytic) / analytic
            require(gap <= FLOP_TOL, f"15e: MLP step {row['step_flops']} "
                    f"FLOPs against the analytic {analytic}")
            row["analytic_flops_gap"] = gap
    members, batch, pool = BA.RPN_CONFIG
    results = []
    row, launches, _ = counted(torch, K, lambda: BA.bench_rpn(
        results, members, batch, pool, epoch_rows=pool, device="cuda"))
    add(launches)
    rows[row["model"]] = row
    require(launches["fused_input_transform"] == row["steps"]
            + row["warmup_steps"] + 1 == sum(launches.values()),
            f"15e RPN: launches {launches}")
    for label, row in rows.items():
        require(0 < row["mfu"] <= 1 and np.isfinite(row["loss"]),
                f"15e {label}: MFU {row['mfu']}, loss {row['loss']}")
    out["bench_all"] = rows
    print(f"{card}: 15e bench_all: " + "; ".join(
        f"{m} {r['samples_per_s']:,.0f} samples/s, {r['tflops']:.2f} "
        f"TFLOP/s, MFU {100 * r['mfu']:.2f}% of {r['peak_tflops']:.1f}, "
        f"peak {r['peak_memory_gb'] or 0:.2f} GB over {r['rows']} rows"
        for m, r in rows.items()), flush=True)
    return out, total


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
    ap.add_argument("--zoo-first-seeds", metavar="S,S,...",
                    help="only read the zoo's first-loss gaps, card against "
                    "CPU, at these seeds (the readings their tolerances "
                    "rest on), print them and exit")
    ap.add_argument("--dp-gap-seeds", metavar="S,S,...",
                    help="only run 13b at these seeds, read its float32 "
                    "gaps to 1 process (the readings DP_RUN_RTOL rests on), "
                    "print them and exit")
    ap.add_argument("--ft-gap-seeds", metavar="S,S,...",
                    help="only run 6f's K = 2 check at these seeds, read "
                    "the kernel path's gradients against the all-plain "
                    "path's with the rollout's gates held and not (the "
                    "readings FT_GRAD_TOL rests on), print them and exit")
    ap.add_argument("--data-parallel-only", action="store_true",
                    help="build the kernels, run phase 13 alone, exit")
    ap.add_argument("--distribution-only", action="store_true",
                    help="build the kernels, run phase 14 alone, exit")
    ap.add_argument("--scripts-only", action="store_true",
                    help="build the kernels, run phase 15 alone, exit")
    ap.add_argument("--model-axis-seeds", metavar="S,S,...",
                    help="only run 14a's RPN at these seeds, read its gaps "
                    "to 1 process (the readings MODEL_AXIS_TOL rests on), "
                    "print them and exit")
    ap.add_argument("--shrink-gap-seeds", metavar="S,S,...",
                    help="only run 14b (iii) at these seeds, read its gaps "
                    "to the uninterrupted 2-rank run (the readings "
                    "SHRINK_RTOL rests on), print them and exit")
    # one rank of phase 13b, started by the script itself
    ap.add_argument("--dp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-dir", help=argparse.SUPPRESS)
    # one rank of phase 14, and 14b (ii)'s worker under torchrun
    ap.add_argument("--p14-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--p14-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--p14-dir", help=argparse.SUPPRESS)
    ap.add_argument("--p14-parts", help=argparse.SUPPRESS)
    ap.add_argument("--elastic-worker", metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 1
    if args.dp_rank is not None:
        return dp_rank_main(torch, args.dp_rank, args.dp_world, args.dp_dir,
                            args.seed)
    if args.p14_rank is not None:
        return p14_rank_main(torch, args.p14_rank, args.p14_world,
                             args.p14_dir, args.seed,
                             args.p14_parts.split(","))
    if args.elastic_worker:
        return elastic_worker_main(torch, args.elastic_worker, args.seed)

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
    if args.zoo_first_seeds:
        gaps = zoo_first_gaps(torch, card, [int(v) for v in
                                            args.zoo_first_seeds.split(",")])
        print(json.dumps({"card": card, "zoo_first_gaps": gaps}))
        return 0
    if args.dp_gap_seeds:
        gaps = dp_gap_seeds(torch, K, card, [int(v) for v in
                                             args.dp_gap_seeds.split(",")])
        print(json.dumps({"card": card, "dp_gaps": gaps}))
        return 0
    if args.ft_gap_seeds:
        finetune, _ = finetune_phase(
            torch, card, K, PU, T, PW, physics, load_asset_norms("v5"),
            load_default_grid(),
            args.seed, [int(v) for v in args.ft_gap_seeds.split(",")],
            check_only=True)
        print(json.dumps({"card": card, "ft_gaps": finetune["by_seed"]}))
        return 0
    if args.data_parallel_only:
        t0 = time.perf_counter()
        dp, dp_launches = dp_phase(torch, K, card, args.seed)
        print(json.dumps({"card": card, "data_parallel": dp,
                          "launches": dp_launches,
                          "seconds": time.perf_counter() - t0}))
        return 0
    if args.model_axis_seeds:
        gaps = model_axis_seeds(torch, K, card, [
            int(v) for v in args.model_axis_seeds.split(",")])
        print(json.dumps({"card": card, "model_axis_gaps": gaps}))
        return 0
    if args.shrink_gap_seeds:
        gaps = shrink_gap_seeds(torch, K, card, [
            int(v) for v in args.shrink_gap_seeds.split(",")])
        print(json.dumps({"card": card, "shrink_gaps": gaps}))
        return 0
    if args.distribution_only:
        spec, stats = get_varspec("v2_rh"), load_asset_norms("v2_rh")
        model = OnlineMLP(spec, hidden=FULL_HIDDEN)
        model.load_state_dict(port_flax_online_mlp(
            flax_tree(spec, FULL_HIDDEN, args.seed)))
        direct = {w: make_fast_mlp_wrapper(model, stats, spec, dt,
                                           device="cuda")
                  for w, dt in (("bf16", torch.bfloat16), ("int8", "int8"))}
        dist14, launches14 = distribution_phase(torch, K, card, args.seed,
                                                direct)
        print(json.dumps({"card": card, "distribution": dist14,
                          "launches": launches14}))
        return 0
    if args.scripts_only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            scripts, launches15 = scripts_phase(torch, K, card, args.seed, tmp)
        print(json.dumps({"card": card, "scripts": scripts,
                          "launches": launches15,
                          "seconds": time.perf_counter() - t0}))
        return 0
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
        # 5''s backward: dgrad <NB, Cout % 64 == 0, blocks an SM>, wgrad
        # <Cout boxes>
        if "Function properties for" in line and "gn_bwd_" in line:
            kname = "gn_bwd_" + line.split("gn_bwd_")[1].split("EEv")[0]
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

    # -- (f) fine-tuning through the rollout, and the online_eval entry ----
    print("6f: kernels 1 and 4 under autograd on the card:", flush=True)
    kgrad = kernel_grad_checks(torch, K, T, PW, stats5, grid, args.seed,
                               res["fused_input_transform"], head)
    finetune, ft_launches = finetune_phase(
        torch, card, K, PU, T, PW, physics, stats5, grid, args.seed)
    finetune["kernel_grad"] = kgrad
    slice_launches.append(ft_launches)
    lap("6f (fine-tuning through the rollout)")
    with tempfile.TemporaryDirectory() as tmp:
        online_eval, oe_launches = entry_phase(torch, card, K, tmp)
    slice_launches.append(oe_launches)
    lap("6f (the online_eval entry)")

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

    # -- 12: the NeurIPS'23 zoo through the run entry ----------------------
    print("12: the NeurIPS'23 zoo through python -m climsim_tpu_torch.run "
          "on the card:", flush=True)
    zoo, zoo_launches = zoo_phase(torch, K, card, args.seed)
    slice_launches.append(zoo_launches)
    lap("12 (the zoo)")

    # -- 13: data-parallel training, the HPO sweep, profiling --------------
    print("13: data-parallel training (1-rank NCCL, 2 ranks on the card), "
          "the HPO sweep and the profiling helpers on the card:", flush=True)
    data_parallel, dp_launches = dp_phase(torch, K, card, args.seed)
    slice_launches.append(dp_launches)
    lap("13 (data parallel, HPO, profiling)")

    # -- 14: the model axis, elastic recovery, the sharded server ----------
    print("14: the model axis (rpn_v1 members and seed replicas over 2 "
          "ranks), elastic recovery (in the process, under torchrun's "
          "agent, a shrink, the RPN's members) and the sharded coupling "
          "server on the card:", flush=True)
    distribution, dist_launches = distribution_phase(
        torch, K, card, args.seed, {w: srv[0] for w, srv in servers.items()})
    slice_launches.append(dist_launches)
    lap("14 (model axis, elastic, sharded server)")

    # -- 15: the last five scripts as port entries -------------------------
    print("15: run_all_baselines, make_offline_figures, run_real_baselines, "
          "bench_ingest and bench_all's rows on the card:", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        scripts, scripts_launches = scripts_phase(torch, K, card, args.seed,
                                                  tmp)
    slice_launches.append(scripts_launches)
    lap("15 (the scripts)")

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
        "launches": unet_train["launches"]["fused_gn_silu_conv3"]
        + ft_launches["fused_gn_silu_conv3"],
        "max_abs_err": k5t["max_abs_err"],
        "max_err_of_max_y": k5t["max_err_rel"],
        "control_min_err_of_max_y": k5t["control_min_rel"],
        "gradients": "fused_gn_silu_conv3_bwd's, within GN_BWD_TOL of "
                     "autograd of the plain chain",
        "ms": k5t["ms"], "plain_ms": k5t["plain_ms"],
        "ms_is": f"forward + backward, the 82 chains of a B={UNET_BATCH} "
                 "step, against autograd of the plain chain (cuDNN on)"})
    kernels.append({
        "name": "fused_gn_silu_conv3_bwd", "route": "cuda",
        "source": BWD_SOURCE[0], "replaces": BWD_SOURCE[1],
        "launches": unet_train["launches"]["fused_gn_silu_conv3_bwd"]
        + sum(n.get("fused_gn_silu_conv3_bwd", 0) for n in slice_launches),
        "max_abs_err": k5t["bwd_max_abs_err"],
        "max_rel_l2": k5t["bwd_max_rel_l2"],
        "min_cosine": k5t["bwd_min_cos"],
        "control_min_rel_l2": k5t["control_min_rel_l2"],
        "dw_taps_swapped_min_rel_l2": k5t["fault_min_rel_l2"],
        "two_runs_bit_equal": True,
        "ms": k5t["bwd_ms"], "plain_ms": k5t["bwd_plain_ms"],
        "autograd_plain_ms": k5t["bwd_autograd_plain_ms"],
        "cudnn_bf16_yardstick_ms": k5t["cudnn_bf16_yardstick_ms"],
        "bound_ms": k5t["bwd_bound_ms"], "bound_by": k5t["bwd_bound_by"],
        "ms_is": f"the 82 chains of a B={UNET_BATCH} step's backward (CUDA "
                 "events, back-to-back calls); plain_ms its plain version, "
                 "autograd_plain_ms the recompute it replaced (cuDNN on)",
        "per_shape": k5t["bwd_per_shape"]})
    for k in kernels:
        if "bound_ms" not in k:
            k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        # no one PyTorch call computes any of them (the backward's cuDNN
        # yardstick is the conv's part alone)
        k["library_ms"] = None
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
                      "finetune": finetune, "online_eval": online_eval,
                      "bench_server": server, "streaming": stream,
                      "zoo": zoo, "data_parallel": data_parallel,
                      "distribution": distribution, "scripts": scripts,
                      "phase_seconds": seconds}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
