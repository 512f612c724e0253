#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and embedding paths on one
NVIDIA GPU and check them.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports nothing of JAX or of the JAX package.  Phases, in order; any
failure exits non-zero:

 1. Card and settings: the card's name and power limit (nvidia-smi),
    PyTorch's own TF32 flags (left as they are), the CUDA kernels built from
    trackmpnn_tpu_torch/csrc/ (one nvcc per source, run concurrently;
    set-up time).
 2. Kernels: each kernel against its plain PyTorch version on the card, on
    the GraphView of the largest window of a 30-track sequence (capacity
    16384, H = 64, f32) and a random h: gather_diff exact,
    signed_segment_sum over the view's incidence (one call of the build
    kernels under torch.cuda.set_sync_debug_mode("error"), bitwise equal to
    its plain version and a numpy build, on a second launch too; its device
    and host time printed beside theirs) within atol 1e-5, rtol 1e-5 of its
    plain version and of
    the plain pull over that incidence (f64 sums in another order, rounded
    to f32 once) and bitwise on a second launch, fused_edge_gru (with
    seeded GRU weights) within atol 1e-5 and bitwise on a second launch.
    Each is
    timed with CUDA events beside its plain version, its memory/compute
    bound, for the scatter torch's index_add_ and for fused_edge_gru the
    route it replaces (gather_diff, then the GRU cell's two matmuls).
    fused_edge_gru is held and timed once more at H = 128 (the gates'
    columns over 4 CTAs, 192 KiB of split weights each), outside the kernels
    line; both rows carry bound_tf32_ms (its products run in 3xTF32 on the
    tensor cores).
 3. Serving: the Tracker on cuda with random weights from a fixed seed (BN
    in eval mode) serves three 30-track x 100-frame sequences (features
    2d).  A served forward records no gradient, so it launches
    fused_edge_gru and signed_segment_sum once a forward and gather_diff
    never; its view builds one incidence (counted).  The same sequences
    rerun on the CPU, where the plain versions run, must decode identical
    tracks with per-step scores within 1e-4.
 4. CLI: the default features (2d+temp+vis, espv2 at 384 x 1280): a
    tracker and a vis-net snapshot the port writes in the JAX format and a
    small synthetic KITTI test tree of real PNGs (2 sequences of 12 frames)
    go through `python -m trackmpnn_tpu_torch.cli.infer` on the card, which
    must write one result file per sequence, identical to the CLI's CPU
    run.
 5. Training: the block train step (f32, nhidden 64, Adam 1e-4 with L2
    5e-4, tp_classifier off) on bench.py's workload: 8 windows of
    make_sequence(16 tracks, 16 frames, miss 0.05, fp 0.1, seeds 100+),
    weights from torch.Generator seed 0.  A first step records the
    block-kernel inputs of its widest step (P = 120 blocks); 3 warm-up
    steps, then 20 timed steps with the launch counters set to 0 before
    and read after (15 / 15 / 30 launches a step expected, and no incidence
    build: the BlockBatch built its own once, in numpy; its host time
    printed); one profiled
    step.  The first step rerun on the CPU must agree: loss, loss_ce,
    loss_f within rtol 1e-4, tp/fp/fn equal, grads within rtol 1e-3 with
    an atol of 1e-4 x the largest |grad|.
 6. Block kernels: block_round_fwd (atol 1e-5), block_round_bwd (rtol
    1e-4, atol 1e-5 x each output's scale) and window_scatter (atol 1e-5;
    the es sum at F = 64 and the gate gather's backward, both cotangents
    at F = 192 in one launch, each over the batch's incidence, also held
    against the plain pull over it and the call without an incidence)
    against their plain versions on the recorded inputs, each bitwise the
    same on a second launch, timed beside its plain version, its bound
    (the round kernels also at the TF32 rate their 3xTF32 products run at:
    3 x the f32 operations over 495 TFLOP/s) and, for the scatter, one
    index_add_ over the same values.  Then the two round kernels once more
    at P 16, na = nt = 64, H 128 on seeded inputs (a width the first design
    refused), against their plain versions evaluated in f64 (at H 128 two
    f32 evaluations differ by ~1e-5 in lg) with the same tolerances, and
    one block step at nhidden 128 (phase 5's workload, first step only)
    against its CPU rerun to phase 5's tolerances.
 7. GAT training: the block train step of phase 5 with one attention head
    (weights from torch.Generator seed 0) and real attention dropout.  The
    first step takes keep masks drawn on the card (att_keep) and records
    the attention kernels' widest inputs; 3 warm-up steps and 20 timed
    steps draw their masks from a cuda generator, with the launch counters
    set to 0 before and read after (T of each attention kernel, T / T / 3T
    of the block kernels a step); one profiled step.  The first step rerun
    on the CPU with the same masks must agree to phase 5's tolerances.
 8. GAT kernels: gat_scores_fwd / gat_aggregate_fwd (rtol and atol 1e-5) and
    gat_scores_bwd / gat_aggregate_bwd (rtol 1e-4, atol 1e-5 x each
    output's scale) against their plain versions at the widest round of
    phase 7 (1 head) and at the same shape with 3 heads on seeded inputs;
    each bitwise the same on a second launch, timed beside its plain
    version and its bound.  Then once more with 3 heads at P 4, na = nt =
    128, H 64 on seeded inputs (GAT_WIDE: a width the first design refused
    in both backwards), against the plain versions evaluated in f64.
 9. GAT serving: one 30-track x 100-frame sequence served by a random
    one-head model on the card (fused_edge_gru once a forward; the
    attention replaces signed_segment_sum) and on the CPU: identical
    tracks, scores within 1e-4.
10. Row-layout training, batch 1: train/step.py's make_train_step on the
    first window of phase 5's workload (seed 100; packed at bench.py's
    capacity, the largest window's rows rounded up to 1024), H 64, f32, Adam
    1e-4 with L2 5e-4, tp_classifier off, weights from torch.Generator seed
    0.  3 warm-up and 20 timed steps with the launch counters set to 0
    before and read after: gather_diff and signed_segment_sum twice a valid
    step each (a forward, and the other's backward) and no incidence build
    (the step batch built one when it was moved to the card: counted, its
    device time printed); one profiled step.
    The first step rerun on the CPU must agree to phase 5's tolerances.
    The first step records both kernels' widest inputs as forwards and as
    each other's backward (on a cotangent); each of the four is held
    against its plain version at phase 2's tolerances and timed as there.
11. Packed training with the fused round: all 8 windows packed
    (train/packed.py::pack_schedules); a step is packed_window_forward(
    fused_round=True), loss.backward() and the optimizer, as
    tests/test_pallas_round.py:75-79 drives the JAX function.  The first
    step records the round kernels' inputs at their widest round; its
    forward equals the unfused packed forward on the card (loss rtol 1e-4,
    final hidden state rtol 1e-3 / atol 1e-4) and its CPU rerun agrees to
    phase 5's tolerances.  3 warm-up and 20 timed steps: each of the four
    round kernels once a valid step; one profiled step.  Then
    one fused first step at nhidden WIDE_HIDDEN (a width the round
    kernels' first design refused) against its CPU rerun, each round kernel
    once a valid step.  Then make_packed_train_step (the unfused path,
    kernels 1 and 2 under autograd) timed on the same batch, its first step
    recording and then checking both mp kernels' widest inputs as in phase
    10.
12. Round kernels: round_fwd (atol 1e-5) and round_bwd_gru, round_bwd_dw,
    round_bwd_dh (rtol 1e-4, atol 1e-5 x each output's scale) against their
    plain versions on phase 11's widest round, each bitwise the same on a
    second launch, timed beside its plain version and its bounds at the f32
    and the TF32 rate (live rows only; the products run as 3xTF32); no
    single PyTorch call computes the round (library: none).  Then the four
    at H WIDE_HIDDEN and NARROW_ROUND_HIDDEN on seeded rounds of the same
    shape against their plain versions in f64 (--json's round_wide).
13. The block step's two other compositions, at phase 5's workload and
    weights: (a) es_kernel=True (the es round, kernel #7, in place of the
    gather, block_round_fwd/bwd and the window scatter), (b) es_kernel and
    fused_loss (the edge losses, kernel #13, inside the loop).  Each first
    step records the new kernels' widest inputs and must agree with phase
    5's first step on the card and with its own CPU rerun to phase 5's
    tolerances; 3 warm-up and 20 timed steps with the counters set to 0
    before and read after (T of block_round_es_fwd and _bwd a step, none of
    block_round_fwd/bwd or window_scatter, in (b) T of each loss kernel);
    one profiled step.
14. The es round's and the edge losses' kernels: block_round_es_fwd,
    edge_loss_l1 and edge_loss_l2 within atol 1e-5 (L2's counts exact),
    block_round_es_bwd and edge_loss_bwd within rtol 1e-4 and atol 1e-5 x
    each output's scale, against their plain versions on phase 13's widest
    inputs (one branch, head width K = 64), the three loss kernels also on
    phase 18's fused_loss step's (three branches side by side, K = 192; it
    runs after phase 18); each bitwise the same on a second launch, timed
    beside its plain version and its bound (live cells only); no single
    PyTorch call computes them (library: none).  Then the es round's two
    kernels at B 4, T 4, capD 128, na = nt = 64, H 128 on seeded inputs
    (tests/torch_port_util.py::es_inputs) against their plain versions in
    f64, as phase 6's wide rows; and the three loss kernels at P 4, na = nt
    = 128, K 192 on seeded inputs (tests/torch_port_util.py::
    edge_loss_inputs; a block the first design held whole in shared memory)
    against their plain versions, the logits and the backward evaluated in
    f64, L1's row statistics from its own logits (--json's
    edge_losses_wide).
15. The embedding path (train/embed.py's EmbedTrainer, whose step and infer
    take packed arrays) at KITTI's input, 384 x 1280, for espv2, dla34 with
    dcn_max_offset 2.0 (every deform block through the DCN kernels) and
    dla34 on the exact gather: a chunk of 8 seeded frames (the training
    CLI's: cur_win_size 5 plus the skip pair, cycled to 8) with 8-16
    detections each (about one in six a false positive), feature-map
    centres; seeded weights, DLA-34's offset / mask convs calibrated
    (tests/torch_port_util.py: fractional offsets, about half beyond the
    bound, clear of the bilinear derivative's kinks).  A first step (the
    bounded route records the DCN kernels' widest inputs), 2 warm-up steps,
    10 steps timed by CUDA events with the DCN launch counters set to 0
    before and read after (16 of each kernel a step on the bounded route;
    none elsewhere), one profiled step (on the bounded route also the device
    ms inside DeformConvShift's forward and backward over the 16 blocks, and
    of the dcn_* kernels); ms/step, frames/s, busy share and peak memory.  The first step must see TF32 off (the trainer pins full
    f32 whatever the process's flags) and leave the flags as they were.
    Then infer on a 32-frame sequence (the chunk four times; eval runs whole
    sequences), timed, with its peak memory: every slice's features equal
    the 8-frame infer's (rtol 1e-4), 4 x 16 dcn_fwd launches on the bounded
    route.  Each first step again
    at 96 x 320 (reduced) on the card and on the CPU from the same weights:
    loss rtol 1e-4, features rtol 1e-4 with atol 1e-4 x the largest, grads
    rtol 1e-3 with atol 1e-4 x the largest |grad|, BN buffers unchanged
    (frozen BN).
16. The DCN kernels: dcn_fwd (atol 1e-5 x the output's scale),
    dcn_bwd_sample (d weight, d offset, d mask) and dcn_bwd_dx (rtol 1e-4,
    atol 1e-5 x each output's scale) against their plain versions evaluated
    in f64 on phase 15's widest deform block (8 x 96 x 320, 64 channels)
    and on seeded inputs of that shape with fractional, integer and
    beyond-bound offsets; each bitwise the same on a second launch, timed
    beside its plain version and its bounds at the f32 and the TF32 rate
    (dcn_fwd and dcn_bwd_sample run their products as 3xTF32); no PyTorch
    call computes a deformable convolution (library: none).  Then
    dcn_bwd_dx at max_offset MAX_REACH (8) on seeded mixed offsets of the
    widest block, against its plain version in f64 (--json's
    dcn_bwd_dx_max_reach).
17. The default configuration served at full width: features 2d+temp+vis,
    nhidden 64, 128 vis features from ESPNetv2 at 384 x 1280, random
    weights from fixed seeds, on phase 3's three sequences.  Each
    sequence's embeddings come from EmbedTrainer.infer on 100 seeded noise
    frames at the boxes' centres (timed by CUDA events), its temp columns
    from the frame ids.  Exactly 3 fused_edge_gru and 3 signed_segment_sum
    launches a forward, no gather_diff; the same feature matrices served
    on the CPU decode identical tracks with per-step scores within 1e-4.
    Frames/s and forwards/s, ms a forward, the embedding's ms and frames/s
    a sequence, the busy share, peak memory.
18. The default features trained (they run right after phase 13): phase
    5's windows, step and weights with features 2d+temp+vis (three
    branches, nhidden 64 each): the temp columns of the frames and 128 vis
    columns from ESPNetv2 at 384 x 1280 over 16 seeded noise frames a
    window at the boxes' centres, as phase 17 makes them (set-up, once).
    The default composition: a first step, 3 warm-up steps and 20 timed
    by CUDA events and host wall, the launch counters set to 0 before and
    read after (T x 3 of each block kernel and 2T x 3 window_scatter a
    step), a profiled step, the first step rerun on the CPU.  es_kernel and
    fused_loss (the edge losses over the three branches' edge hiddens side
    by side, K = 192): a first step each, its launches counted, against
    its CPU rerun and against the default composition's first step on the
    card, to phase 5's tolerances.
19. The same step with 3 attention heads a branch and real dropout, on
    the stacked route and on the per-head route (gat_fused=False, the
    single-head kernels #9 and #10): both first steps take the same keep
    masks drawn on the card and must agree with each other and each with
    its CPU rerun to phase 5's tolerances; each route timed as in phase 18
    (a step: T x 3 of each stacked attention kernel and no single-head one,
    or T x 3 x 3 of each single-head kernel and no stacked one).
20. The single-head kernels (gat1_scores_fwd / _bwd, gat1_aggregate_fwd /
    _bwd) on phase 19's per-head widest inputs against their plain
    versions (forwards rtol and atol 1e-5, backwards rtol 1e-4 with atol
    1e-5 x each output's scale) and against the stacked kernels at nh = 1
    on the same inputs, bitwise on a second launch, each timed beside its
    plain version, that stacked kernel and its bound.  Then once more at P
    2, na = nt = 112, H 64 (GAT1_WIDE, refused by the first design's score
    backward), against the plain versions in f64, bitwise equal to the
    stacked kernels at nh = 1.

21. Kernel #8 (gat0_scores_fwd / _bwd, the raw masked scores of
    pallas_gat.py::gat_scores, which no path calls) on phase 19's per-head
    widest inputs: against its plain versions (forward rtol and atol 1e-5,
    backward rtol 1e-4 with atol 1e-5 x each output's scale), bitwise the
    same on a second launch and bitwise equal to gat1_scores_fwd's scores
    and to gat1_scores_bwd with zero statistic cotangents; timed beside its
    plain version, gat1_* and its bound; once more at GAT1_WIDE against the
    plain versions in f64, bitwise equal to gat1_*.  Every block training
    phase holds its launches at 0.
22. The batched validation tracker (decode/batch_tracker.py, pipeline=True)
    on phase 17's three sequences, model and weights: exactly 3
    fused_edge_gru and 3 signed_segment_sum launches and one incidence
    build a cohort forward and no gather_diff; tracks identical to phase 17's card and CPU runs,
    per-step scores within 1e-4; frames/s beside phase 17's, the busy
    share, peak memory.
23. The training CLI in process (cli.train.main(argv)) on a synthetic
    KITTI tree of real PNGs (21 sequences x 8 frames, 10 tracks: KITTI's
    sequences have 78-1059 frames): (a) the defaults (2d+temp+vis, espv2
    at 384 x 1280, nhidden 64, the batch-1 route), 2 epochs: every train
    step's gather_diff / signed_segment_sum launches exact, fused_edge_gru
    only in validation, one incidence build a step batch and a validation
    forward, the losses, val F1, MOTA, mAP logged, best
    checkpoints and vis-nets written; epoch wall, chunks/s, ms a step
    (events and host), the embedding's ms a chunk, validation wall and
    frames/s, peak memory, the busy share over one profiled chunk; (b)
    resumed from (a)'s epoch-1 checkpoint: starts at epoch 2, its first
    step holds the saved parameters, Adam state and vis-net bitwise; (c)
    --feats 2d+temp, 1 epoch from one --snapshot on the card and the CPU:
    the first 10 losses within rtol 1e-4, and one checkpoint validated on
    both gives identical tracks, MOTA and mAP; (d) --batch-windows 8
    --no-bf16, 1 epoch: the block route logged, T x 3 block_round_fwd and
    _bwd and 2T x 3 window_scatter launches every step, one BlockBatch
    incidence a step; (e) the same with --num-att-heads 3, 1 epoch: T x 3
    launches of each stacked attention kernel (gat_scores_fwd / _bwd,
    gat_aggregate_fwd / _bwd) and 3T x 3 window_scatter every step, no
    single-head attention kernel, its ms a step.
24. Msg concat (the edge GRU's input [h[past] | h[fut]], w_ih [2H, 3H]):
    (b) phase 3's first sequence served with a concat model (features 2d,
    nhidden 64, seeded weights): one gather_concat (#1's concat mode) and
    one signed_segment_sum launch a branch and forward, no fused_edge_gru
    or gather_diff, tracks identical to the CPU's, scores within 1e-4;
    (c) phase 10's batch-1 step with concat: the first step card against
    CPU to phase 5's tolerances, 20 timed steps after 3, each valid round
    exactly one gather_concat, one signed_segment_sum, one
    segment_sum_halves (#2's halves mode, gather_concat's backward) and one
    gather_diff (signed_segment_sum's backward); (a) gather_concat bitwise
    equal to its plain version and segment_sum_halves within atol / rtol
    1e-5 of its plain version, each bitwise on a relaunch and timed beside
    its plain version and bound (the halves also beside one index_add_), at
    (c)'s widest round and at phase 2's window; (d) phase 18's block step at
    the default features with concat (sign +1, ga and gb the two halves of
    w_ih): the default composition timed with 45 / 45 / 90 block launches a
    step, es_kernel and fused_loss a first step each, all three card
    against CPU; (e) the training CLI with --msg-type concat, one epoch on
    phase 23's tree (launches held on every step, validation through
    gather_concat), then the infer CLI on its best checkpoint over phase 4's
    test tree (two result files, gather_concat launched, no fused_edge_gru).
25. The native planner and bf16 rectangles: (a) phase 3's three sequences
    (Tracker) and phase 22's batched run (BatchedTracker over phase 17's
    sequences) served with the native planner (graph/native.py) and with
    TM_NATIVE=0 in this process: tracks identical to each other and to the
    phases' CPU runs; frames/s and the engine's host ms a frame for both.
    (c) The bf16 block step (compute_dtype=torch.bfloat16) on phase 5's
    workload, phase 18's default features and phase 19's three stacked
    heads (phase 19's keep masks): 20 timed steps, launches 15 / 15 / 30 a
    branch (block_round_fwd_bf16 / _bwd_bf16 / window_scatter) plus T of
    each attention kernel with heads (the aggregate's bf16 pair), none of
    the f32 round's; each first step against its CPU rerun (loss rtol 1e-3,
    grads rtol 1e-2 with atol 1e-3 x the largest |grad|) and against the
    f32 step's on the card (loss rtol 1e-2, gradient cosine > 0.99 a leaf);
    ms a step beside f32's.  (b) block_round_fwd_bf16 / _bwd_bf16 on that
    step's widest round and at P 16, na = nt = 64, H 128 (seeded), and
    gat_aggregate_fwd_bf16 / _bwd_bf16 on phase 8's 3-head row, against
    their plain versions (bf16 outputs within one bf16 ulp, two for the
    aggregate's d h_e, plus one flipped d gh operand where a product reads
    it; f32 outputs rtol 1e-4), bitwise on a relaunch, timed beside the f32
    kernels.  (d) The training CLI with --batch-windows 8 and its default
    --bf16, one epoch on phase 23's tree: "(bf16)" logged, the bf16 round's
    launches held on every step.

The kernels line gives each serving kernel the launches of the path it
runs on: gather_diff phase 10's, signed_segment_sum phase 3's,
fused_edge_gru phase 17's, gather_concat and segment_sum_halves (rows at
phase 2's window) phase 24 (c)'s; the single-head attention kernels phase
19's per-head route; kernel #8's rows say 0 with a note; the bf16 kernels
phase 25 (c)'s (the round's on phase 5's workload, the aggregate's with
heads).  A line gives the
incidence builds (device or host time, counts a path).  The line before
the last is {"kernels": [...]}; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")  # build/ is git-ignored

# NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor cores,
# dense TF32 on the tensor cores (the block round kernels' products, three
# TF32 products for each f32 one: 3xTF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12

SERVE_TRACKS, SERVE_FRAMES, SERVE_SEEDS, WIN = 30, 100, (0, 1, 2), 5
HIDDEN = 64
SCATTER_RTOL = SCATTER_ATOL = 1e-5
EDGE_GRU_ATOL = 1e-5  # fused_edge_gru: 64-term f32 sums in another order, then sigmoid/tanh
EDGE_GRU_WIDE = 128  # fused_edge_gru's second check: the gates' columns over 4 CTAs
# the CLIs' default features (trackmpnn_tpu/utils/config.py:37), with espv2.
# The machine with the card has PIL, so phase 4 reads real PNGs through the
# embedding net; its frames are cut (not the input size) to keep the CLI's
# CPU rerun short.
DEFAULT_FEATS, CLI_FRAMES = "2d+temp+vis", 12
STEP_SCORE_ATOL = 1e-4

# training: bench.py's workload and hyper-parameters
TRAIN_B, TRAIN_TRACKS, TRAIN_FRAMES, TRAIN_SEED0 = 8, 16, 16, 100
TRAIN_LR, TRAIN_WD = 1e-4, 5e-4
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
ROUND_FWD_ATOL = WSCATTER_ATOL = 1e-5
ROUND_BWD_RTOL, ROUND_BWD_ATOL_SCALE = 1e-4, 1e-5
# the block round kernels held once more at a width the first design
# refused (its shared memory grew with H and na + nt), on seeded inputs, and
# one block step at that hidden width card against CPU
WIDE_HIDDEN = 128
NARROW_ROUND_HIDDEN = 48  # phase 12: a width the fused round's first design refused
WIDE_ROUND = dict(P=16, na=64, nt=64, H=WIDE_HIDDEN)
WIDE_ES = dict(B=4, T=4, capD=128, na=64, nt=64, H=WIDE_HIDDEN)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-3, 1e-4
# f32 operations a live cell of the round takes beyond its products: the
# gate arithmetic per hidden unit (adds, sigmoid x2, tanh, the output mix)
GATE_FLOPS_PER_UNIT = 30
# attention: one head ("GAT1", the TPU log logs/bench_r5_gat_final.log) on
# the training path, three more for the kernels' check at the same shape
GAT_HEADS, GAT_HEADS_WIDE = 1, 3
# a score sums H products and an exp-sum up to nt terms: the rounding of
# another summation order grows with the value, so forwards hold rtol too
GAT_FWD_RTOL = GAT_FWD_ATOL = 1e-5
# f32 operations a live cell and head takes in the softmax terms (leaky
# relu, masked max, two exps, divisions, dropout scaling)
GAT_CELL_OPS = 20
GAT_REPLACES = {"gat_scores_fwd": "trackmpnn_tpu/ops/pallas_gat.py:505",
                "gat_scores_bwd": "trackmpnn_tpu/ops/pallas_gat.py:531",
                "gat_aggregate_fwd": "trackmpnn_tpu/ops/pallas_gat.py:644",
                "gat_aggregate_bwd": "trackmpnn_tpu/ops/pallas_gat.py:664"}
# the plain versions launch tens of small ops a call: fewer timed calls, so
# that their launches fit the device's queue behind the timer's sleep
PLAIN_ITERS = 12


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 64, warmup: int = 20, queue_ahead: bool = True) -> float:
    """Mean ms per call between CUDA events around `iters` calls.

    queue_ahead: the stream first spins in a device-side sleep long enough
    for the host to enqueue every call, so the events time the device
    running the calls back to back (device time).  `iters` stays small
    enough that the calls' launches fit the device's launch queue (about a
    thousand entries), or the host would wait for the sleep to end.
    Without it the host's per-call cost shows wherever it exceeds the
    device's (call time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    sleep_cycles = 50_000_000  # ~25 ms at the H100's 1.98 GHz
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_was_ahead = not start.query()
        end.synchronize()
        if not queue_ahead or host_was_ahead:
            return start.elapsed_time(end) / iters
        sleep_cycles *= 4  # the device woke before the host had enqueued all calls
    fail("the host could not enqueue the timed calls within the device-side sleep "
         "(too slow, or more launches than the device's queue holds)")


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound_tf32_ms(nbytes: float, flops: float):
    """The bound at the rate the block round kernels and fused_edge_gru run
    their products: 3 x the f32 operations (3xTF32) over the dense TF32
    rate, or the bytes."""
    return max(nbytes / PEAK_BYTES_PER_S, 3 * flops / PEAK_TF32_PER_S) * 1e3


def peak_window(seed: int):
    """The engine's largest window over a serving sequence, with the scores
    random weights give (detections ~0.99, edges ~0.01: nothing associates)."""
    import numpy as np

    from trackmpnn_tpu_torch.data.synthetic import make_sequence
    from trackmpnn_tpu_torch.graph import engine

    X, bbox_pred, _ = make_sequence(num_tracks=SERVE_TRACKS, num_frames=SERVE_FRAMES,
                                    ncategories=3, seed=seed)
    y = bbox_pred[:, :2].astype(np.int64)
    y_out = y.copy()
    y_out[:, 1] = -1
    g = engine.initialize(y, 0, "test")
    best = (g.n, g.n, copy.deepcopy(g))
    trivial = lambda g: np.stack([np.where(g.ts != -1, 0.01, 0.99),
                                  np.where(g.ts != -1, 0.99, 0.01)], 1).astype(np.float32)
    for t in range(g.t_next, g.t_end):
        n_new = engine.update(g, y, t, trivial(g), "test", use_hungarian=True)
        if g.n > best[0]:
            best = (g.n, n_new, copy.deepcopy(g))
        t_upto = g.t_end if t == g.t_end - 1 else t - WIN + 2
        engine.decode_tracks(g, trivial(g), y_out, t_upto, 0, use_hungarian=True)
        if g.n == 0:
            break
    return X, best[2], best[1]


MP_REPLACES = {"gather_diff": "trackmpnn_tpu/ops/pallas_mp.py:184",
               "signed_segment_sum": "trackmpnn_tpu/ops/pallas_mp.py:128"}


def mp_kernel_row(torch, mp, name, h, past, fut, em, n, where, inc=None, build=None):
    """One message-passing kernel on these inputs against its plain version
    (gather_diff exact; signed_segment_sum within SCATTER_RTOL / ATOL, both
    f64 rounded to f32 once in another order, and bitwise the same on a
    second launch), timed beside its plain version, its memory/compute bound
    and, for the scatter, torch's index_add_.  signed_segment_sum pulls
    through `inc`, the incidence its path built (segment_incidence), and is
    also held against the plain pull over it; `build`, that incidence's
    build (incidence_build), is printed beside the row and kept in it,
    outside the bound.  Prints and returns the kernel's row."""
    N, H = h.shape
    n_edges = int(em.sum())
    if name == "gather_diff":
        kernel = lambda: mp.gather_diff(h, past, fut, em)
        plain = lambda: mp.gather_diff_reference(h, past, fut, em)
    else:
        if inc is None:
            fail(f"signed_segment_sum ({where}): the path handed the kernel no incidence")
        kernel = lambda: mp.signed_segment_sum(h, past, fut, em, n, inc)
        plain = lambda: mp.signed_segment_sum_reference(h, past, fut, em, n)
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    library_ms = None
    if name == "gather_diff":
        if err != 0.0:
            fail(f"gather_diff ({where}) differs from its plain version by {err}")
        endpoints = int(torch.unique(torch.cat([past[em], fut[em]])).numel())
        b, by = bound_ms(9 * N + endpoints * H * 4 + N * H * 4, n_edges * H)
    else:
        pull = mp.signed_segment_sum_pull_reference(h, em, inc, n)
        for label, ref in (("plain version", want), ("plain pull over its incidence", pull)):
            if not torch.allclose(got, ref, rtol=SCATTER_RTOL, atol=SCATTER_ATOL):
                fail(f"signed_segment_sum ({where}) differs from its {label} by "
                     f"{float((got - ref).abs().max())} (atol {SCATTER_ATOL}, rtol {SCATTER_RTOL})")
        if not torch.equal(got, again):
            fail(f"signed_segment_sum ({where}) is not bitwise the same on a second launch")
        # yardstick: one f32 index_add_ over the doubled incidence [past; fut] <- [h; -h].
        # It sums in f32 in its atomics' order, whose rounding at these sizes
        # (~135 terms a row) reaches 1e-5 by itself: checked at 1e-4 only, to
        # show it computes the same function.
        idx2 = torch.cat([torch.where(em, past, n), torch.where(em, fut, n)]).long()
        vals2 = torch.cat([h, -h])
        library = lambda: torch.zeros(n + 1, H, device="cuda").index_add_(0, idx2, vals2)
        if not torch.allclose(library()[:n], want, rtol=1e-4, atol=1e-4):
            fail(f"index_add_ yardstick ({where}) does not compute the same function")
        library_ms = cuda_time_ms(library)
        # the function's own bytes: h's edge rows, 9 B of index and mask a
        # row read once, out written once (the incidence repeats past/fut;
        # its build is timed beside the row)
        b, by = bound_ms(9 * N + n_edges * H * 4 + n * H * 4, 2 * n_edges * H)
    r = {"name": name, "route": "cuda", "source": "trackmpnn_tpu_torch/csrc/mp_kernels.cu",
         "replaces": MP_REPLACES[name], "max_abs_err": err,
         "ms": cuda_time_ms(kernel), "call_ms": cuda_time_ms(kernel, queue_ahead=False),
         "plain_ms": cuda_time_ms(plain), "bound_ms": b, "bound_by": by,
         "library_ms": library_ms, "where": where,
         "shape": f"N {N}, n {n}, H {H}, edge rows {n_edges}"}
    if build is not None:
        r["incidence_build"] = build
    print(f"kernel {name} ({where}; {r['shape']}): device {r['ms'] * 1e3:.2f} us, per call "
          f"with the host's launch cost {r['call_ms'] * 1e3:.2f} us (plain "
          f"{r['plain_ms'] * 1e3:.2f} us, bound {b * 1e3:.2f} us by {by}, library "
          f"{'-' if library_ms is None else '%.2f us' % (library_ms * 1e3)}), "
          f"max abs err {err:.3g}"
          + ("" if build is None else f"; its incidence's build {build['ms'] * 1e3:.2f} us "
             "on the card, once a view or step batch"))
    return r


def edge_gru_row(torch, mp, h, past, fut, em, live, where):
    """Kernel #3, fused_edge_gru, on these inputs and seeded GRU weights
    against its plain version (atol EDGE_GRU_ATOL: H-term f32 sums in
    another order, then sigmoid / tanh), bitwise on a second launch; timed
    beside its plain version, its bound and the route it replaces in the
    served forward (the gather_diff kernel, then models/nn.gru_cell's two
    torch.matmuls and gate ops).  No single PyTorch call gathers and runs
    the GRU cell (library: none).  The bound counts the `live` rows."""
    from trackmpnn_tpu_torch.models import nn

    N, H = h.shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = [torch.randn(H, 3 * H, device="cuda", generator=gen) * H ** -0.5 for _ in range(2)]
    b = [torch.randn(3 * H, device="cuda", generator=gen) * 0.3 for _ in range(2)]
    args = (h, past, fut, em, *w, *b)
    eg = {"w_ih": w[0], "w_hh": w[1], "b_ih": b[0], "b_hh": b[1]}
    with torch.inference_mode():
        kernel = lambda: mp.fused_edge_gru(*args)
        plain = lambda: mp.edge_gru_reference(*args)
        replaced = lambda: nn.gru_cell(eg, mp.gather_diff(h, past, fut, em), h)
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or err > EDGE_GRU_ATOL:
            fail(f"fused_edge_gru ({where}) differs from its plain version by {err} "
                 f"(atol {EDGE_GRU_ATOL})")
        if not torch.equal(got, again):
            fail(f"fused_edge_gru ({where}) is not bitwise the same on a second launch")
        if float((replaced() - want).abs().max()) > EDGE_GRU_ATOL:
            fail(f"the replaced route ({where}) does not compute the same function")
        # each input read once (live rows of h, 9 B of index a row, the
        # weights), each output row written once; the products and gates
        cost = (live * (2 * H * 4 + 9) + 2 * (H + 1) * 3 * H * 4,
                live * (2 * 2 * H * 3 * H + GATE_FLOPS_PER_UNIT * H))
        b_ms, by = bound_ms(*cost)
        r = {"name": "fused_edge_gru", "route": "cuda",
             "source": "trackmpnn_tpu_torch/csrc/mp_kernels.cu",
             "replaces": "trackmpnn_tpu/ops/pallas_mp.py:84", "max_abs_err": err,
             "ms": cuda_time_ms(kernel), "call_ms": cuda_time_ms(kernel, queue_ahead=False),
             "plain_ms": cuda_time_ms(plain, iters=PLAIN_ITERS), "bound_ms": b_ms,
             "bound_by": by, "bound_tf32_ms": bound_tf32_ms(*cost), "library_ms": None,
             "replaced_route_ms": cuda_time_ms(replaced, iters=PLAIN_ITERS), "where": where,
             "shape": f"N {N}, H {H}, live rows {live}, edge rows {int(em.sum())}"}
    print(f"kernel fused_edge_gru ({where}; {r['shape']}): device {r['ms'] * 1e3:.2f} us, per "
          f"call with the host's launch cost {r['call_ms'] * 1e3:.2f} us (plain "
          f"{r['plain_ms'] * 1e3:.2f} us, the replaced gather_diff + gru_cell "
          f"{r['replaced_route_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us by {by}, at the TF32 "
          f"rate {r['bound_tf32_ms'] * 1e3:.2f} us, library none), max abs err {err:.3g}, "
          "bitwise on a second launch")
    return r


# each incidence build the paths made: device (or, for the BlockBatch's
# numpy build, host) µs and counts, printed and written to --json
INCIDENCE = {}


def host_call_us(torch, fn, calls=50):
    """Mean host µs a call of `fn` takes to return (its enqueue), the device
    idle before: what a path's host loop pays for it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def numpy_incidence(np, past, fut, n):
    """segment_incidence built on the host in numpy (a stable argsort and a
    search), as graph/view.py::pack_slots could build it beside the slots."""
    rows = np.arange(len(past))
    ends = np.concatenate([past, fut])
    listed = np.tile((past != rows) | (fut != rows), 2) & (ends >= 0) & (ends < n)
    key = np.where(listed, ends, n)
    order = np.argsort(key, kind="stable")
    return np.searchsorted(key[order], np.arange(n + 1)).astype(np.int32), order.astype(np.int32)


def incidence_build(torch, np, mp, past, fut, n, where, key):
    """The path's incidence build on its endpoints (mp.segment_incidence:
    one call of the build kernels), with no host synchronisation, held
    bitwise against its plain version (segment_incidence_reference: a
    stable sort and a search in tensor ops on the card) and a numpy build
    on the host, also on a second launch.  Timed: device µs of the kernel
    and of the plain version (CUDA events, few calls), and the host µs a
    call of each takes, beside the numpy build's host µs (the choice a
    serving forward faces: the host is its bottleneck).  Printed and kept
    under INCIDENCE[key]."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [mp.segment_incidence(past, fut, n) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = mp.segment_incidence_reference(past, fut, n)
    p_np, f_np = past.cpu().numpy(), fut.cpu().numpy()
    host = numpy_incidence(np, p_np, f_np, n)
    listed = int(want[0][-1])
    for ptr, ent in got + [tuple(torch.from_numpy(a).cuda() for a in host)]:
        if not (torch.equal(ptr, want[0]) and torch.equal(ent[:listed], want[1][:listed])):
            fail(f"incidence build ({where}) differs from its plain version")
    build = lambda: mp.segment_incidence(past, fut, n)
    plain = lambda: mp.segment_incidence_reference(past, fut, n)
    r = {"ms": cuda_time_ms(build, iters=PLAIN_ITERS),
         "plain_ms": cuda_time_ms(plain, iters=PLAIN_ITERS),
         "host_us": host_call_us(torch, build), "plain_host_us": host_call_us(torch, plain),
         "numpy_host_us": host_call_us(torch, lambda: numpy_incidence(np, p_np, f_np, n),
                                       calls=10),
         "rows": int(past.shape[0]), "destinations": n, "entries": listed}
    INCIDENCE.setdefault(key, {})["build"] = r
    print(f"incidence build ({where}; {r['rows']} rows, {listed} entries): one call, "
          f"{r['ms'] * 1e3:.2f} us on the card, {r['host_us']:.1f} us of host a call; the plain "
          f"sort and search {r['plain_ms'] * 1e3:.2f} us on the card, {r['plain_host_us']:.1f} us "
          f"of host; numpy on the host {r['numpy_host_us']:.1f} us (before its copy to the card); "
          "bitwise equal, on a second call too")
    return r


def kernel_phase(torch, np, mp, tracker_mod, view_mod):
    X, g, n_new = peak_window(SERVE_SEEDS[0])
    cap = tracker_mod._bucketed(g.n, tracker_mod.TrackerConfig().bucket)
    view = view_mod.make_view(g, X, n_new, cap, "cuda")
    h = torch.randn(cap, HIDDEN, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    past, fut, em = view.past, view.fut, view.edge_mask()
    print(f"kernel inputs: live rows {g.n}, edge rows {int(em.sum())}, capacity {cap}, "
          f"H {HIDDEN}")
    # the serving incidence is built on the card with no host synchronisation
    build = incidence_build(torch, np, mp, past, fut, cap, f"serving, capacity {cap}", "serving")
    want = mp.segment_incidence_reference(past, fut, cap)
    if not (torch.equal(view.inc[0], want[0])
            and torch.equal(view.inc[1][:int(want[0][-1])], want[1][:int(want[0][-1])])):
        fail("the serving view's incidence differs from its plain version")
    rows = [mp_kernel_row(torch, mp, name, h, past, fut, em, cap, "serving", view.inc,
                          build if name == "signed_segment_sum" else None)
            for name in MP_REPLACES] + [edge_gru_row(torch, mp, h, past, fut, em, g.n,
                                                     "serving")]
    # a width whose gate columns split over 4 CTAs
    h_wide = torch.randn(cap, EDGE_GRU_WIDE, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    wide = edge_gru_row(torch, mp, h_wide, past, fut, em, g.n, f"serving, H {EDGE_GRU_WIDE}")
    return rows, wide, (h, past, fut, em, cap, view.inc)


@contextlib.contextmanager
def record_mp_widest(mp, keep: dict):
    """While active, the widest inputs (most edge rows) of each message-passing
    kernel's calls go into keep[(name, role)]: role "forward" where h requires
    grad, "backward" for a cotangent, which the other op's autograd backward
    passes in (GatherDiff / SignedSegmentSum)."""
    role = lambda a: "forward" if a[0].requires_grad else "backward"
    with contextlib.ExitStack() as rec:
        for name in MP_REPLACES:
            rec.enter_context(record_widest(mp, f"{name}_raw", keep,
                                            lambda a, n=name: (n, role(a)),
                                            blocks=lambda a: int(a[3].sum())))
        yield


def mp_path_rows(torch, mp, inputs, where, build):
    """gather_diff and signed_segment_sum at the widest inputs a training
    path gave them, as forwards and as each other's backward; `build`, the
    path's incidence build, beside signed_segment_sum's rows."""
    rows = []
    for name in MP_REPLACES:
        for role in ("forward", "backward"):
            if (name, role) not in inputs:
                fail(f"{where}: no {role} call of {name} was recorded")
            h, past, fut, em, *rest = inputs[(name, role)]
            rows.append(mp_kernel_row(torch, mp, name, h, past, fut, em,
                                      rest[0] if rest else h.shape[0], f"{where}, {role}",
                                      rest[1] if len(rest) > 1 else None,
                                      build if name == "signed_segment_sum" else None))
    return rows


def serve(tracker, seqs, np):
    """Run every sequence; per-step (n, scores2), y_out, forward times."""
    fwd_ms, runs = [], []
    run_forward = tracker._run_forward

    def timed(*args):
        t0 = time.perf_counter()
        out = run_forward(*args)  # ends in a device-to-host copy of the scores
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tracker._run_forward = timed
    walls = []
    for X, y in seqs:
        steps = []
        t0 = time.perf_counter()
        y_out = tracker.run(X, y, on_step=lambda g, s: steps.append((g.n, s.copy())))
        walls.append(time.perf_counter() - t0)
        runs.append((steps, y_out))
    tracker._run_forward = run_forward
    return runs, fwd_ms, walls


def device_profile(torch, run, wall_s, ranges=(), match=None):
    """Device time by kernel over one profiled call of `run`, and the busy
    share of `wall_s`, the same work's wall time without the profiler: the
    union of the device-side intervals (kernels, copies, memsets; not the
    user annotations such as Optimizer.step, whose device span covers
    kernels counted already) over the wall.  ranges: user ranges (names)
    whose device spans are summed (ranges_ms); match: a substring of the
    kernel names whose device time is summed (matched_ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    on_device = lambda e: (e.device_type == torch.autograd.DeviceType.CUDA
                           and not getattr(e, "is_user_annotation", False))
    # the host ops that launched the device events carry the same time again
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if on_device(e) and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if on_device(e) and e.time_range.end > e.time_range.start)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms, kernel_ms = busy_us / 1e3, sum(r[1] for r in rows)
    if busy_ms == 0:
        print("profile: the profiler recorded no device time (busy share not measured)")
        return None
    share = busy_ms / (wall_s * 1e3)
    print(f"profile: device busy {busy_ms:.1f} ms (device events summed {kernel_ms:.1f} ms) of "
          f"{wall_s * 1e3:.1f} ms wall (busy share {share:.4f}); top device time:")
    for key, ms, count in rows[:10]:
        print(f"  {ms:9.3f} ms {count:6d}x  {key[:90]}")
    out = {"device_busy_ms": busy_ms, "device_events_ms": kernel_ms, "busy_share": share,
           "top": [{"name": k, "ms": ms, "count": c} for k, ms, c in rows[:10]]}
    if ranges:
        out["ranges_ms"] = dict.fromkeys(ranges, 0.0)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name in out["ranges_ms"]:
                out["ranges_ms"][e.name] += (e.time_range.end - e.time_range.start) / 1e3
    if match is not None:
        out["matched_ms"] = sum(ms for key, ms, _ in rows if match in key)
    return out


def served_edge_gru(cfg):
    """The kernel a served forward's edge GRU launches once a branch:
    fused_edge_gru with msg 'diff', gather_concat (beside gru_cell's
    products) with 'concat'."""
    return "gather_concat" if cfg.msg_type == "concat" else "fused_edge_gru"


def serve_and_check(torch, np, mp, cfg, params, stats, seqs, warm, what, keep=None):
    """Serve `seqs` with the Tracker on the card, the launch counters set to
    0 just before and read just after: each feature branch launches
    fused_edge_gru (gather_concat with msg 'concat') and signed_segment_sum
    once a forward (no gradient is recorded), and gather_diff never, and
    each forward's view builds one incidence, which its branches share.  Profile the first sequence, then rerun
    all on the CPU, where the plain versions run: identical tracks and
    per-step scores within STEP_SCORE_ATOL.  `warm` (X, y) runs first
    (cuBLAS handles, the allocator).  Returns the summary; `keep`, a dict,
    receives the card's and the CPU's (per-step (n, scores2), y_out) runs."""
    from trackmpnn_tpu_torch.decode.tracker import Tracker, TrackerConfig, _bucketed

    tcfg = TrackerConfig(cur_win_size=WIN, hungarian=True)
    gpu = Tracker(params, stats, cfg, tcfg, device="cuda")
    gpu.run(*warm)
    torch.cuda.synchronize()

    zero_counters((mp.LAUNCHES, mp.BUILDS))
    runs, fwd_ms, walls = serve(gpu, seqs, np)
    launches = {**mp.LAUNCHES, **mp.BUILDS}
    forwards = sum(len(steps) for steps, _ in runs)
    nb = len(cfg.branches)
    expected = {**dict.fromkeys(mp.LAUNCHES, 0), "signed_segment_sum": nb * forwards,
                served_edge_gru(cfg): nb * forwards, "segment_incidence": forwards}
    if launches != expected:
        fail(f"{what}: launches and incidence builds {launches} in {forwards} forwards of {nb} "
             f"branches, expected {expected}")
    INCIDENCE.setdefault("serving", {})[what] = {"builds": launches["segment_incidence"],
                                                 "forwards": forwards}
    print(f"{what}: launches and incidence builds {launches} over {forwards} forwards of {nb} "
          "branches")
    wall = sum(walls)
    profile = device_profile(torch, lambda: gpu.run(*seqs[0]), walls[0])

    cpu_runs, _, cpu_walls = serve(Tracker(params, stats, cfg, tcfg, device="cpu"), seqs, np)
    cpu_wall = sum(cpu_walls)
    worst = 0.0
    for si, ((steps, y_out), (c_steps, c_y_out)) in enumerate(zip(runs, cpu_runs)):
        if len(steps) != len(c_steps):
            fail(f"{what}, sequence {si}: {len(steps)} steps on the card, {len(c_steps)} on "
                 "the CPU")
        for k, ((n, s), (cn, cs)) in enumerate(zip(steps, c_steps)):
            if n != cn:
                fail(f"{what}, sequence {si} step {k}: {n} rows on the card, {cn} on the CPU")
            worst = max(worst, float(np.abs(s - cs).max()))
        if not np.array_equal(y_out, c_y_out):
            margin = min(float(np.abs(s[:, 1] - 0.5).min()) for _, s in steps)
            fail(f"{what}, sequence {si}: decoded tracks differ between card and CPU "
                 f"(smallest |score - 0.5| on the card: {margin:.3g})")
    if worst > STEP_SCORE_ATOL:
        fail(f"{what}: per-step scores differ between card and CPU by {worst:.3g} > "
             f"{STEP_SCORE_ATOL}")
    if keep is not None:
        keep.update(card=runs, cpu=cpu_runs)

    peak_n = max(n for steps, _ in runs for n, _ in steps)
    frames = sum(len(np.unique(y[:, 0])) for _, y in seqs)
    f = np.array(fwd_ms)
    summary = {
        "features": cfg.features, "sequences": len(seqs), "frames": frames,
        "forwards": forwards, "wall_s": wall, "cpu_rerun_wall_s": cpu_wall,
        "forwards_per_s": forwards / wall, "frames_per_s": frames / wall,
        "forward_ms_mean": float(f.mean()), "forward_ms_p50": float(np.percentile(f, 50)),
        "forward_ms_p99": float(np.percentile(f, 99)),
        "forward_share_of_wall": float(f.sum() / 1e3 / wall),
        "peak_rows": peak_n, "peak_capacity": _bucketed(peak_n, tcfg.bucket),
        "max_step_score_err_vs_cpu": worst, "launches": launches,
        "device_busy_share_seq0": None if profile is None else profile["busy_share"],
    }
    print(f"{what}: " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in summary.items() if k != "launches"))
    summary["profile_seq0"] = profile
    return summary


def serving_phase(torch, np, mp):
    from trackmpnn_tpu_torch.data.synthetic import make_sequence
    from trackmpnn_tpu_torch.models import mpnn

    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN, msg_type="diff")
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    stats = mpnn.init_batch_stats(cfg)
    seqs = []
    for s in SERVE_SEEDS:
        X, bbox_pred, _ = make_sequence(num_tracks=SERVE_TRACKS, num_frames=SERVE_FRAMES,
                                        ncategories=3, seed=s)
        seqs.append((X, bbox_pred[:, :2].astype(np.int64)))
    X, bbox_pred, _ = make_sequence(num_tracks=SERVE_TRACKS, num_frames=12, seed=99)
    warm, runs = (X, bbox_pred[:, :2].astype(np.int64)), {}
    summary = serve_and_check(torch, np, mp, cfg, params, stats, seqs, warm, "serving", keep=runs)
    return summary, (cfg, params, stats, seqs, warm, runs)


def cli_phase(torch, np):
    """Phase 4: the infer CLI with the default features (espv2 at KITTI's
    input) on a small tree of real PNGs, from a tracker and a
    vis-net snapshot the port writes in the JAX format: on the card as a
    user runs it, then in this process on the CPU; the result files must be
    identical."""
    from trackmpnn_tpu_torch.cli import infer
    from trackmpnn_tpu_torch.data.synthetic import write_kitti_tree
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import checkpoint
    from trackmpnn_tpu_torch.train.embed import EmbedTrainer

    cfg = mpnn.ModelConfig(features=DEFAULT_FEATS, ncategories=3, nhidden=HIDDEN)
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    shutil.rmtree(WORK, ignore_errors=True)
    root = os.path.join(WORK, "kitti")
    write_kitti_tree(root, num_seqs=2, num_frames=CLI_FRAMES, num_tracks=10,
                     split_dir="testing", seed=3, real_images=True)
    snapshot = os.path.join(WORK, "snap", "track-mpnn_best.npz")
    checkpoint.save_model(snapshot, params, mpnn.init_batch_stats(cfg), cfg)
    checkpoint.save_embed(os.path.join(WORK, "snap", "vis-net_best.npz"),
                          EmbedTrainer(arch="espv2", input_hw=EMBED_HW, seed=5, device="cpu"))
    with open(os.path.join(WORK, "snap", "config.json"), "w") as f:
        json.dump({"dataset": "kitti", "category": "All", "detections": "rrc",
                   "feats": DEFAULT_FEATS, "embed_arch": "espv2", "cur_win_size": WIN,
                   "ret_win_size": 0, "no_tp_classifier": False, "num_hidden_feats": cfg.nhidden,
                   "num_att_heads": 0, "msg_type": "diff"}, f)
    out_gpu, out_cpu = os.path.join(WORK, "out_cuda"), os.path.join(WORK, "out_cpu")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "trackmpnn_tpu_torch.cli.infer", "--snapshot", snapshot,
         "--dataset-root-path", root, "--output-dir", out_gpu, "--hungarian"],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True, text=True,
        timeout=600)
    if res.returncode != 0:
        fail(f"infer CLI exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        infer.main(["--snapshot", snapshot, "--dataset-root-path", root,
                    "--output-dir", out_cpu, "--hungarian", "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    files = sorted(f for f in os.listdir(out_gpu) if f.endswith(".txt"))
    if files != ["0000.txt", "0001.txt"]:
        fail(f"infer CLI wrote {files}, expected one result file per sequence")
    lines = 0
    for name in files:
        with open(os.path.join(out_gpu, name)) as a, open(os.path.join(out_cpu, name)) as b:
            text = a.read()
            if text != b.read():
                fail(f"infer CLI result {name} differs between cuda and cpu")
            lines += len(text.splitlines())
    if lines == 0:
        fail("infer CLI wrote empty result files")
    print(f"cli ({DEFAULT_FEATS}, espv2 at {EMBED_HW[0]} x {EMBED_HW[1]}, 2 sequences of "
          f"{CLI_FRAMES} real PNG frames): {len(files)} result files ({lines} lines) on cuda in "
          f"{cli_s:.2f} s, identical to the CPU run ({cpu_s:.2f} s)")
    return {"features": DEFAULT_FEATS, "frames": 2 * CLI_FRAMES, "result_files": len(files),
            "result_lines": lines, "cli_s": cli_s, "cpu_s": cpu_s}


def training_sequences(np):
    """bench.py's sequences: the first B of make_sequence(16 tracks, 16
    frames, miss 0.05, fp 0.1) from seeds 100, 101, ... that seed a graph,
    as (2d features, labels, boxes)."""
    from trackmpnn_tpu_torch.data.synthetic import make_sequence
    from trackmpnn_tpu_torch.graph.schedule import build_window_schedule

    seqs, s = [], 0
    while len(seqs) < TRAIN_B:
        X, bp, _ = make_sequence(num_tracks=TRAIN_TRACKS, num_frames=TRAIN_FRAMES,
                                 seed=TRAIN_SEED0 + s, miss_rate=0.05, fp_rate=0.1)
        y = bp[:, :2].astype(np.int64)
        if build_window_schedule(X, y) is not None:
            seqs.append((X, y, bp))
        s += 1
    return seqs


def training_chunks(np):
    """bench.py's chunks: training_sequences' (features, labels)."""
    return [(X, y) for X, y, _ in training_sequences(np)]


def training_workload(np, chunks=None):
    """bench.py's workload: the chunks' schedules (training_chunks' by
    default), every one padded to the longest's step count."""
    from trackmpnn_tpu_torch.graph.schedule import build_window_schedule

    chunks = training_chunks(np) if chunks is None else chunks
    raw = [build_window_schedule(X, y) for X, y in chunks]
    t_cap = max(ws.n_steps for ws in raw)
    schedules = [build_window_schedule(X, y, t_cap=t_cap) for X, y in chunks]
    return schedules, t_cap, sum(live_edges(np, ws) for ws in schedules)


def default_training_workload(torch, np):
    """Phases 18-19's workload: bench.py's windows (training_sequences) with
    the default features: their 2d columns, the temp columns of their frames
    (data/common.py::temporal_features) and 128 vis columns that
    EmbedTrainer.infer (espv2, seeded weights) computes at the boxes'
    centres over seeded noise frames of 384 x 1280, as phase 17 makes them.
    Set-up, done once."""
    from trackmpnn_tpu_torch.data import common
    from trackmpnn_tpu_torch.train.embed import EmbedTrainer, normalized_vis_features

    t0 = time.perf_counter()
    embed = EmbedTrainer(arch="espv2", input_hw=EMBED_HW, seed=5, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(18)
    chunks = []
    for X, y, bp in training_sequences(np):
        frames = torch.randn(TRAIN_FRAMES, *EMBED_HW, 3, device="cuda", generator=gen)
        cy, cx = common.center_indices(bp[:, 4:8], FULL_IM_HW, EMBED_HW, embed.down_ratio)
        raw = embed.infer(frames, bp[:, 0].astype(np.int64), cy, cx).cpu().numpy()
        if raw.shape != (len(bp), embed.num_vis_feats) or not np.all(np.isfinite(raw)):
            fail(f"default-feature training: embeddings of shape {raw.shape}, expected "
                 f"({len(bp)}, {embed.num_vis_feats}) finite")
        chunks.append((np.concatenate([X, common.temporal_features(bp[:, :1]),
                                       normalized_vis_features(raw)], 1).astype(np.float32), y))
        del frames
    del embed
    torch.cuda.empty_cache()
    print(f"default-feature training set-up: {TRAIN_B} windows of {chunks[0][0].shape[1]} "
          f"feature columns ({DEFAULT_FEATS}; vis from espv2 at {EMBED_HW[0]} x {EMBED_HW[1]} "
          f"over {TRAIN_FRAMES} frames a window) in {time.perf_counter() - t0:.2f} s")
    return training_workload(np, chunks)


def live_edges(np, ws):
    """A window's live edge rows summed over its steps: what one train
    step's message passing touches."""
    edge_pos = np.where(~ws.is_det[: ws.n_rows])[0]
    return sum(int(np.sum(edge_pos < ws.n_after[s])) for s in range(ws.n_steps))


@contextlib.contextmanager
def record_widest(module, name, keep: dict, key, blocks=lambda args: args[0].shape[0]):
    """While active, calls of module.name also store a clone of their
    arguments in keep[key(args)], for the call with the most blocks."""
    import torch

    orig = getattr(module, name)

    def rec(*args):
        k = key(args)
        if k not in keep or blocks(args) > blocks(keep[k]):
            keep[k] = tuple(a.detach().clone() if torch.is_tensor(a) else
                            {n: v.detach().clone() for n, v in a.items()} if isinstance(a, dict)
                            else a for a in args)
        return orig(*args)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


def tree_max_abs(tensors):
    return max(float(t.abs().max()) for t in tensors)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def steps_agree(torch, first, other, what, names=("card", "CPU"),
                tol=(LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_SCALE)):
    """Two first steps, each (loss, aux, grads): loss terms within rtol
    LOSS_RTOL, tp/fp/fn equal, grads within GRAD_RTOL with an atol of
    GRAD_ATOL_SCALE x the largest |grad| of `other` (or tol's three).
    Returns (worst grad diff, scale)."""
    (loss1, aux1, grads1), (loss2, aux2, grads2) = first, other
    loss_rtol, grad_rtol, grad_atol_scale = tol
    for name, a, b in (("loss", loss1, loss2), ("loss_ce", aux1["loss_ce"], aux2["loss_ce"]),
                       ("loss_f", aux1["loss_f"], aux2["loss_f"])):
        a, b = float(a), float(b)
        if not abs(a - b) <= loss_rtol * abs(b):
            fail(f"{what} first step {name}: {names[0]} {a!r}, {names[1]} {b!r} "
                 f"(rtol {loss_rtol})")
    for k in ("tp", "fp", "fn"):
        if int(aux1[k]) != int(aux2[k]):
            fail(f"{what} first step {k}: {names[0]} {int(aux1[k])}, {names[1]} {int(aux2[k])}")
    grads2 = [g.cpu() for g in grads2]
    gscale = tree_max_abs(grads2)
    worst = 0.0
    for i, (a, b) in enumerate(zip(grads1, grads2)):
        a = a.cpu()
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=grad_rtol, atol=grad_atol_scale * gscale):
            fail(f"{what} first step grad of leaf {i} differs between {names[0]} and "
                 f"{names[1]} by {float((a - b).abs().max()):.3g} (rtol {grad_rtol}, "
                 f"atol {grad_atol_scale * gscale:.3g})")
    return worst, gscale


def first_step_agrees(torch, train_block, loss1, aux1, grads1, loss_c, aux_c, params_c, what,
                      tol=(LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_SCALE)):
    """The card's first step against the CPU's rerun (steps_agree)."""
    grads_c = [p.grad for p in train_block.param_leaves(params_c)]
    return steps_agree(torch, (loss1, aux1, grads1), (loss_c, aux_c, grads_c), what, tol=tol)


def draw_keep_masks(train_block, gen, heads, nb, bb):
    """One step's attention keep masks drawn on the card: for each round s,
    one (rows, columns) pair a branch of [heads, (s+1)*B, na_cap, nt_cap]."""
    return [[train_block.draw_att_keep(gen, heads, ((s + 1) * bb.n_windows, bb.na_cap,
                                                    bb.nt_cap), "cuda") for _ in range(nb)]
            for s in range(bb.t_cap)]


def zero_counters(counters):
    for c in counters:
        for k in c:
            c[k] = 0


def block_incidence_host(np, block_ops, bb, what):
    """The BlockBatch's incidence is built once a batch, in numpy on the
    host (ops/block.py::block_incidence): time that build again on the
    batch's own arrays (host clock, 5 builds) under INCIDENCE["block"]."""
    B, T = bb.n_windows, bb.t_cap
    perm = np.arange(B * T).reshape(B, T).T.reshape(-1)
    arrays = [t.cpu().numpy()[perm] for t in (bb.active_idx, bb.newdet_idx, bb.blk_na, bb.blk_nt)]
    t0 = time.perf_counter()
    for _ in range(5):
        ptr, slot = block_ops.block_incidence(*arrays, B * bb.capD)
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    if not (np.array_equal(ptr, bb.det_inc_ptr.cpu().numpy())
            and np.array_equal(slot, bb.det_inc_slot.cpu().numpy())):
        fail(f"{what}: the BlockBatch's incidence differs from a rebuild of it")
    INCIDENCE.setdefault("block", {})[what] = {"host_ms": host_ms, "entries": int(slot.size),
                                               "builds_per_batch": 1}
    print(f"incidence build ({what}, BlockBatch, numpy): {host_ms * 1e3:.1f} us on the host, "
          f"{slot.size} entries, once a batch")


def training_phase(torch, np, block_ops, gat_ops, loss_ops, heads, es_kernel=False,
                   fused_loss=False, features="2d", workload=None, gat_fused=True, timed=True,
                   keep1=None, hidden=HIDDEN, msg_type="diff", compute_dtype=None):
    """Phase 5 (heads = 0), 7, 13 (es_kernel, with or without fused_loss),
    18 (features 2d+temp+vis on `workload`: the default composition timed,
    es_kernel and fused_loss a first step), 19 (the same with 3 heads on
    either attention route), 24 (d) (phase 18 with msg_type 'concat') or
    25 (c) (compute_dtype=torch.bfloat16: the bf16 kernels in the f32
    round's and stacked aggregate's place, the card against the CPU to
    BF16_*'s tolerances): the block train step on bench.py's workload.
    The first step's launches are counted (the counters set to 0 just
    before, read just after) and must be one step's expected launches; with
    `timed`, 3 warm-up steps, 20 timed steps counted the same way and a
    profiled step.  keep1: the first step's keep masks (drawn here when
    None).  Returns (summary, the widest inputs of the path's kernels, the
    first step's (loss, aux, grads))."""
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import optim

    what = "training"
    if heads:
        what = f"GAT training ({heads} head{'s' if heads > 1 else ''}, dropout {mpnn.ATT_DROPOUT})"
    if features != "2d":
        what = f"{what}, {features}"
    if hidden != HIDDEN:
        what = f"{what}, nhidden {hidden}"
    if msg_type != "diff":
        what = f"{what}, msg {msg_type}"
    if compute_dtype is not None:
        what = f"bf16 {what}"
    flags = [k for k, on in (("es_kernel", es_kernel), ("fused_loss", fused_loss),
                             ("per-head route", heads and not gat_fused)) if on]
    if flags:
        what += " (" + ", ".join(flags) + ")"
    schedules, t_cap, edges = workload or training_workload(np)
    built = block_ops.BUILDS["block_incidence"]
    bb = train_block.build_block_batch(schedules, t_cap, device="cuda")
    if block_ops.BUILDS["block_incidence"] != built + 1:
        fail(f"{what}: the BlockBatch built its incidence "
             f"{block_ops.BUILDS['block_incidence'] - built} times, expected once")
    block_incidence_host(np, block_ops, bb, what)
    live_cells = int((bb.blk_na * bb.blk_nt).sum())
    cfg = mpnn.ModelConfig(features=features, ncategories=3, nhidden=hidden, msg_type=msg_type,
                           nattheads=heads)
    nb = len(cfg.branches)
    print(f"{what} inputs: B {bb.n_windows}, T {t_cap}, capD {bb.capD}, na_cap {bb.na_cap}, "
          f"nt_cap {bb.nt_cap}, H {hidden}, branches {nb}, feature columns "
          f"{bb.det_feat.shape[1]}, P at the last step {bb.n_windows * t_cap}, "
          f"live edge rows a step {edges}, live cells in all blocks {live_cells}")
    params0 = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    stats0 = mpnn.init_batch_stats(cfg)
    step = train_block.make_block_train_step(cfg, tp_classifier=False, es_kernel=es_kernel,
                                             fused_loss=fused_loss, gat_fused=gat_fused,
                                             compute_dtype=compute_dtype)
    params = train_block.trainable(to_device(params0, "cuda"))
    stats = to_device(stats0, "cuda")
    opt = optim.make_optimizer(train_block.param_leaves(params), TRAIN_LR, TRAIN_WD)
    gen = None
    if heads:
        # attention dropout: the first step's keep masks are drawn on the
        # card (or given) and shared with its CPU rerun, later steps draw
        # from gen
        gen = torch.Generator(device="cuda").manual_seed(1)
        if keep1 is None:
            keep1 = draw_keep_masks(train_block, gen, heads, nb, bb)

    # one step's launches: the block kernels T a branch (the es round in
    # their place with es_kernel); window_scatter the es sum and one launch
    # for both cotangents of the gate gather, with stacked heads one more
    # for the attention projections' gather, on the per-head route two a
    # head (its projection's gather, its own es sum); the stacked attention
    # kernels T a branch, the single-head ones T a branch and head; the loss
    # kernels T with fused_loss.  No incidence is built in a step: the
    # BlockBatch's serves every round.
    per_head = bool(heads) and not gat_fused
    rounds = t_cap * nb
    default = 0 if es_kernel else rounds
    scatters = 0 if es_kernel else (1 + 2 * heads if per_head else 3 if heads else 2)
    expected = {"block_round_fwd": default, "block_round_bwd": default,
                "window_scatter": scatters * rounds,
                "block_round_es_fwd": rounds - default, "block_round_es_bwd": rounds - default,
                **{k: 0 for k in gat_ops.LAUNCHES},
                **{k: t_cap if fused_loss else 0 for k in loss_ops.LAUNCHES},
                "block_incidence": 0, "window_incidence": 0}
    if heads:
        # the stacked kernels (gat_*) or the single-head ones (gat1_*); never
        # #8's (gat0_*), which no path launches
        route = "gat1_" if per_head else "gat_"
        expected.update({k: rounds * heads if per_head else rounds for k in gat_ops.LAUNCHES
                         if k.startswith(route) and not k.endswith("_bf16")})
    if compute_dtype is not None:
        # the bf16 round and, with heads, the bf16 aggregate in their f32
        # kernels' place; the scores kernels read f32 projections still
        for k in ("block_round_fwd", "block_round_bwd") + (
                ("gat_aggregate_fwd", "gat_aggregate_bwd") if heads else ()):
            expected[k + "_bf16"], expected[k] = expected[k], 0
    counters = (block_ops.LAUNCHES, gat_ops.LAUNCHES, loss_ops.LAUNCHES, block_ops.BUILDS)

    def check_launches(launches, steps):
        for k, v in expected.items():
            if launches[k] != v * steps:
                fail(f"{what}: {k} launched {launches[k]} times in {steps} steps, "
                     f"expected {v} a step")

    # first step, recording the widest inputs of every kernel of the path
    inputs = {}
    zero_counters(counters)
    with contextlib.ExitStack() as rec:
        if heads:
            prefix = "gat1" if per_head else "gat"
            for name in (f"{prefix}_scores_fwd", f"{prefix}_scores_bwd"):
                rec.enter_context(record_widest(gat_ops, f"_{name}_cuda", inputs,
                                                lambda a, n=name: n))
            for name in (f"{prefix}_aggregate_fwd", f"{prefix}_aggregate_bwd"):
                rec.enter_context(record_widest(gat_ops, f"_{name}_cuda", inputs,
                                                lambda a, n=name: n,
                                                blocks=lambda a: a[5].shape[0]))
        elif es_kernel:
            for name in ("block_round_es_fwd", "block_round_es_bwd"):
                rec.enter_context(record_widest(block_ops, f"_{name}_cuda", inputs,
                                                lambda a, n=name: n))
        else:
            rec.enter_context(record_widest(block_ops, "_block_round_fwd_cuda", inputs,
                                            lambda a: "fwd"))
            rec.enter_context(record_widest(block_ops, "_block_round_bwd_cuda", inputs,
                                            lambda a: "bwd"))
            rec.enter_context(record_widest(block_ops, "_window_scatter_cuda", inputs,
                                            lambda a: f"scatter_F{a[0].shape[2]}"))
            rec.enter_context(record_widest(block_ops, "_window_gather2_bwd_cuda", inputs,
                                            lambda a: f"gather2_F{a[0].shape[2]}"))
        if fused_loss:
            for name in ("l1", "l2", "bwd"):
                rec.enter_context(record_widest(loss_ops, f"_{name}_cuda", inputs,
                                                lambda a, n=name: f"edge_loss_{n}"))
        params, stats, loss1, aux1 = step(params, stats, opt, bb, att_keep=keep1)
    grads1 = [p.grad.detach().clone() for p in train_block.param_leaves(params)]
    torch.cuda.synchronize()
    first_launches = {k: v for c in counters for k, v in c.items()}
    check_launches(first_launches, 1)
    if not np.isfinite(float(loss1)):
        fail(f"{what} first step loss not finite: {float(loss1)}")
    summary = {
        "features": features, "branches": nb, "heads": heads, "gat_fused": gat_fused,
        "compute_dtype": None if compute_dtype is None else str(compute_dtype),
        "es_kernel": es_kernel, "fused_loss": fused_loss,
        "windows": bb.n_windows, "t_cap": t_cap, "capD": bb.capD,
        "na_cap": bb.na_cap, "nt_cap": bb.nt_cap, "hidden": hidden, "edges_per_step": edges,
        "live_cells": live_cells, "loss_first": float(loss1),
        "launches_first_step": first_launches,
    }
    if timed:
        for _ in range(TRAIN_WARMUP):
            params, stats, _, _ = step(params, stats, opt, bb, generator=gen)
        torch.cuda.synchronize()
        zero_counters(counters)
        losses = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(TRAIN_STEPS):
            params, stats, loss, _ = step(params, stats, opt, bb, generator=gen)
            losses.append(loss)
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.items()}
        events_ms = start.elapsed_time(end) / TRAIN_STEPS
        wall_ms = wall_s * 1e3 / TRAIN_STEPS
        check_launches(launches, TRAIN_STEPS)
        losses = torch.stack(losses).cpu().numpy()
        if not np.all(np.isfinite(losses)):
            fail(f"{what} loss not finite: {losses}")
        print(f"{what}: {TRAIN_STEPS} steps, {events_ms:.3f} ms/step (CUDA events), "
              f"{wall_ms:.3f} ms/step (host wall), {edges / (wall_ms / 1e3):.4g} edges/s; "
              f"launches a step { {k: v / TRAIN_STEPS for k, v in launches.items() if v} }; "
              f"loss {float(loss1):.6g} -> {losses[-1]:.6g}")
        profile = device_profile(torch, lambda: step(params, stats, opt, bb, generator=gen),
                                 wall_ms / 1e3)
        summary.update({
            "steps": TRAIN_STEPS, "ms_per_step_events": events_ms, "ms_per_step_wall": wall_ms,
            "edges_per_s": edges / (wall_ms / 1e3), "launches": launches,
            "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
            "loss_last": float(losses[-1]),
            "device_busy_share_step": None if profile is None else profile["busy_share"],
            "profile_step": profile})
    else:
        print(f"{what}: first step, loss {float(loss1):.6g}; launches "
              f"{ {k: v for k, v in first_launches.items() if v} }")

    # the first step again on the CPU, from the same weights, batch and masks
    bb_cpu = type(bb)(*(t.cpu() for t in bb))
    params_c = train_block.trainable(params0)
    opt_c = optim.make_optimizer(train_block.param_leaves(params_c), TRAIN_LR, TRAIN_WD)
    keep_c = None if keep1 is None else [[tuple(k.cpu() for k in pair) for pair in ks]
                                         for ks in keep1]
    t0 = time.perf_counter()
    params_c, _, loss_c, aux_c = step(params_c, stats0, opt_c, bb_cpu, att_keep=keep_c)
    cpu_step_s = time.perf_counter() - t0
    tol = ((LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_SCALE) if compute_dtype is None else
           (BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_GRAD_ATOL_SCALE))
    worst_grad, gscale = first_step_agrees(torch, train_block, loss1, aux1, grads1, loss_c,
                                           aux_c, params_c, what, tol)
    print(f"{what} vs CPU: loss {float(loss1)!r} / {float(loss_c)!r}, tp/fp/fn "
          f"{[int(aux1[k]) for k in ('tp', 'fp', 'fn')]} equal, worst grad diff "
          f"{worst_grad:.3g} (largest |grad| {gscale:.3g}); CPU step {cpu_step_s:.2f} s")
    summary.update({"cpu_loss_first": float(loss_c), "max_grad_err_vs_cpu": worst_grad,
                    "grad_scale": gscale, "cpu_step_s": cpu_step_s})
    return summary, inputs, (loss1, aux1, grads1)


def round_pair_rows(torch, block_ops, fwd_args, bwd_args, launches, exact=False):
    """block_round_fwd (atol 1e-5) and block_round_bwd (rtol 1e-4, atol
    1e-5 x each output's scale) against their plain versions (evaluated in
    f64 with `exact`), each bitwise the same on a second launch, padded cells
    exactly 0; timed beside the plain versions in f32, the f32 bound and the
    bound at the TF32 rate the products run at."""
    he, ga, gb, whh, bhh, web, mask, sign = fwd_args
    P, na, nt, H = he.shape
    live = mask != 0
    cells = int(live.sum())
    rows_a = int(live.any(2).sum())
    cols_b = int(live.any(1).sum())
    if exact:
        if os.path.join(HERE, "tests") not in sys.path:
            sys.path.insert(0, os.path.join(HERE, "tests"))
        from torch_port_util import in_f64
    plain = in_f64 if exact else (lambda f, *a: f(*a))
    shape = f"P {P}, na {na}, nt {nt}, H {H}, live cells {cells}"
    results = []

    got = block_ops._block_round_fwd_cuda(*fwd_args)
    again = block_ops._block_round_fwd_cuda(*fwd_args)
    want = plain(block_ops.block_round_reference, *fwd_args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if err > ROUND_FWD_ATOL:
        fail(f"block_round_fwd ({shape}) differs from its plain version by {err} "
             f"(atol {ROUND_FWD_ATOL})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"block_round_fwd ({shape}) is not bitwise the same on a second launch")
    if not (torch.all(got[0][~live] == 0) and torch.all(got[3][~live] == 0)):
        fail(f"block_round_fwd ({shape}) wrote a nonzero edge_out or lg at a padded cell")
    fwd_flops = cells * (2 * H * 3 * H + 2 * H + 2 * H + GATE_FLOPS_PER_UNIT * H)
    fwd_bytes = 4 * (cells * H + P * na * nt + (rows_a + cols_b) * 3 * H + H * 3 * H + 4 * H
                     + P * na * nt * (H + 1) + P * (na + nt) * H)
    b, by = bound_ms(fwd_bytes, fwd_flops)
    results.append({
        "name": "block_round_fwd", "route": "cuda",
        "source": "trackmpnn_tpu_torch/csrc/block_kernels.cu",
        "replaces": "trackmpnn_tpu/ops/pallas_block.py:123",
        "launches": launches["block_round_fwd"], "max_abs_err": err,
        "ms": cuda_time_ms(lambda: block_ops._block_round_fwd_cuda(*fwd_args)),
        "call_ms": cuda_time_ms(lambda: block_ops._block_round_fwd_cuda(*fwd_args),
                                queue_ahead=False),
        "plain_ms": cuda_time_ms(lambda: block_ops.block_round_reference(*fwd_args),
                                 iters=PLAIN_ITERS),
        "bound_ms": b, "bound_by": by, "bound_tf32_ms": bound_tf32_ms(fwd_bytes, fwd_flops),
        "library_ms": None, "shape": shape,
    })

    got = block_ops._block_round_bwd_cuda(*bwd_args)
    again = block_ops._block_round_bwd_cuda(*bwd_args)
    want = plain(block_ops.block_round_backward_reference, *bwd_args)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, w in zip(["dhe", "dga", "dgb", "dwhh", "dbhh", "dweb"], got, want):
        atol = ROUND_BWD_ATOL_SCALE * max(float(w.abs().max()), 1e-30)
        err = max(err, float((a - w).abs().max()))
        if not torch.allclose(a, w, rtol=ROUND_BWD_RTOL, atol=atol):
            fail(f"block_round_bwd ({shape}) {name} differs from its plain version by "
                 f"{float((a - w).abs().max()):.3g} (rtol {ROUND_BWD_RTOL}, atol {atol:.3g})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"block_round_bwd ({shape}) is not bitwise the same on a second launch")
    if not torch.all(got[0][~live] == 0):
        fail(f"block_round_bwd ({shape}) wrote a nonzero d h_e at a padded cell")
    bwd_flops = cells * (3 * 2 * H * 3 * H + 2 * GATE_FLOPS_PER_UNIT * H)
    bwd_bytes = 4 * (2 * cells * H + 2 * P * na * nt + (rows_a + cols_b) * (3 * H + H)
                     + H * 3 * H + 4 * H + P * na * nt * H + P * (na + nt) * 3 * H
                     + H * 3 * H + 4 * H)
    b, by = bound_ms(bwd_bytes, bwd_flops)
    results.append({
        "name": "block_round_bwd", "route": "cuda",
        "source": "trackmpnn_tpu_torch/csrc/block_kernels.cu",
        "replaces": "trackmpnn_tpu/ops/pallas_block.py:140",
        "launches": launches["block_round_bwd"], "max_abs_err": err,
        "ms": cuda_time_ms(lambda: block_ops._block_round_bwd_cuda(*bwd_args)),
        "call_ms": cuda_time_ms(lambda: block_ops._block_round_bwd_cuda(*bwd_args),
                                queue_ahead=False),
        "plain_ms": cuda_time_ms(lambda: block_ops.block_round_backward_reference(*bwd_args),
                                 iters=PLAIN_ITERS),
        "bound_ms": b, "bound_by": by, "bound_tf32_ms": bound_tf32_ms(bwd_bytes, bwd_flops),
        "library_ms": None, "shape": shape,
    })
    return results


def print_kernel_row(r, suffix=""):
    tf32 = "" if "bound_tf32_ms" not in r else f", at the TF32 rate {r['bound_tf32_ms'] * 1e3:.2f} us"
    print(f"kernel {r['name']} ({r['shape']}): device {r['ms'] * 1e3:.2f} us, per call "
          f"{r['call_ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f} us, bound "
          f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}{tf32}, library "
          f"{'-' if r['library_ms'] is None else '%.2f us' % (r['library_ms'] * 1e3)}), "
          f"max abs err {r['max_abs_err']:.3g}" + suffix)


def round_problem(np, torch, seed, P, na, nt, H):
    """Seeded inputs of the block round on the card: a rectangular live part
    a block (padded cells of h_e 0, as the step makes them), the step's
    scales, and cotangents."""
    rng = np.random.default_rng(seed)
    blk_na, blk_nt = rng.integers(0, na + 1, size=P), rng.integers(0, nt + 1, size=P)
    m = ((np.arange(na)[None, :, None] < blk_na[:, None, None])
         & (np.arange(nt)[None, None, :] < blk_nt[:, None, None])).astype(np.float32)
    arrays = [rng.normal(size=(P, na, nt, H)) * m[..., None], rng.normal(size=(P, na, 3 * H)),
              rng.normal(size=(P, nt, 3 * H)), rng.normal(size=(H, 3 * H)) * 0.3,
              rng.normal(size=(3 * H,)) * 0.1, rng.normal(size=(H, 1)) * 0.4, m]
    cots = [rng.normal(size=(P, na, nt, H)), rng.normal(size=(P, na, H)),
            rng.normal(size=(P, nt, H)), rng.normal(size=(P, na, nt))]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda")
    return [put(a) for a in arrays], [put(c) for c in cots]


def wide_round_rows(torch, np, block_ops):
    """The block round kernels at P 16, na = nt = 64, H = WIDE_HIDDEN on
    seeded inputs (a width the first design refused), held against the plain
    versions in f64 and timed; outside the kernels line."""
    args, cots = round_problem(np, torch, 11, **WIDE_ROUND)
    no_launches = {"block_round_fwd": None, "block_round_bwd": None}
    rows = round_pair_rows(torch, block_ops, args + [-1.0], args + [-1.0] + cots, no_launches,
                           exact=True)
    for r in rows:
        print_kernel_row(r, " (vs the plain version in f64)")
    return rows


def block_kernel_phase(torch, block_ops, inputs, launches):
    """Each block kernel on the recorded widest inputs of the training step
    against its plain version, twice (bitwise), and timed."""
    H = HIDDEN
    results = round_pair_rows(torch, block_ops, inputs["fwd"], inputs["bwd"], launches)

    extra = {}
    for key in sorted(k for k in inputs if k.startswith(("scatter_F", "gather2_F"))):
        extra[key] = window_scatter_row(torch, block_ops, key, inputs[key],
                                        launches["window_scatter"])
    # the kernels line carries the gate gather's backward (both cotangents
    # at F = 3H in one launch, half the launches a step); the es sum (F = H)
    # goes to the JSON file.  Beside each: the batch incidence's build
    # (phase 5's, in numpy on the host, once a batch)
    build = INCIDENCE["block"]["training"]
    results.append(extra[f"gather2_F{3 * H}"])
    for r in extra.values():
        r["incidence_build"] = build
    for r in results + [extra[f"scatter_F{H}"]]:
        print_kernel_row(r, "" if r["name"] != "window_scatter" else
                         f"; its incidence's build {build['host_ms'] * 1e3:.1f} us on the host, "
                         "once a batch")
    return results, extra[f"scatter_F{H}"]


def window_scatter_row(torch, block_ops, key, args, launches):
    """The window_scatter kernel on a recorded call of the training step:
    the es sum (scatter_F*: vals [P, na + nt, F]) or the gate gather's
    backward (gather2_F*: d ga [P, na, F] and d gb [P, nt, F] in one
    launch), each over the batch's incidence the path handed it.  Held
    against its plain version (window_scatter_reference, atol
    WSCATTER_ATOL) and the plain pull over that incidence, bitwise on a
    second launch; timed beside its plain version, its bound (the sources
    and ids read once, the outputs written once) and one index_add_ over the
    same values; also the call without an incidence (the full one built on
    the card for the call: not the main path)."""
    if key.startswith("scatter_F"):
        vals, idx, B, capD, inc = args
        srcs, ids = (vals,), (idx,)
        kernel = lambda: (block_ops._window_scatter_cuda(vals, idx, B, capD, inc),)
        no_inc = lambda: (block_ops._window_scatter_cuda(vals, idx, B, capD),)
        pull = lambda: (block_ops.incidence_sum_reference(vals, vals[:, :0], *inc, B * capD)[0],)
    else:
        dga, dgb, act, new, B, capD, inc = args
        srcs, ids = (dga, dgb), (act, new)
        kernel = lambda: block_ops._window_gather2_bwd_cuda(dga, dgb, act, new, B, capD, inc)
        no_inc = lambda: block_ops._window_gather2_bwd_cuda(dga, dgb, act, new, B, capD)
        pull = lambda: block_ops.incidence_sum_reference(dga, dgb, *inc, B * capD)
    if inc is None:
        fail(f"window_scatter ({key}): the training path handed the kernel no incidence")
    plain = lambda: tuple(block_ops.window_scatter_reference(v, i, B, capD)
                          for v, i in zip(srcs, ids))
    got, again, want, pulled, built = kernel(), kernel(), plain(), pull(), no_inc()
    torch.cuda.synchronize()
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    for label, refs in (("plain version", want), ("plain pull over its incidence", pulled),
                        ("call without an incidence", built)):
        worst = max(float((a - w.float()).abs().max()) for a, w in zip(got, refs))
        if worst > WSCATTER_ATOL:
            fail(f"window_scatter ({key}) differs from its {label} by {worst} "
                 f"(atol {WSCATTER_ATOL})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"window_scatter ({key}) is not bitwise the same on a second launch")
    P, F = srcs[0].shape[0], srcs[0].shape[2]
    # yardstick: one index_add_ over every position of every source
    gid = torch.cat([k * B * capD + block_ops.global_idx(i, B, capD).reshape(-1)
                     for k, i in enumerate(ids)])
    flat = torch.cat([v.reshape(-1, F) for v in srcs])
    library = lambda: torch.zeros(len(srcs) * B * capD, F, device="cuda").index_add_(0, gid, flat)
    if not torch.allclose(library(), torch.cat(want), rtol=1e-4, atol=1e-4):
        fail("index_add_ yardstick does not compute the same function as window_scatter")
    positions = sum(v.shape[0] * v.shape[1] for v in srcs)
    # the function's own bytes: every source value and id read once, every
    # output written once (the incidence repeats the ids; it is built once
    # a batch on the host, timed beside the row)
    b, by = bound_ms(4 * (positions * F + positions + len(srcs) * B * capD * F), positions * F)
    r = {"name": "window_scatter", "route": "cuda",
         "source": "trackmpnn_tpu_torch/csrc/block_kernels.cu",
         "replaces": "trackmpnn_tpu/ops/pallas_block.py:616",
         "launches": launches, "max_abs_err": err,
         "ms": cuda_time_ms(kernel), "call_ms": cuda_time_ms(kernel, queue_ahead=False),
         "plain_ms": cuda_time_ms(plain, iters=PLAIN_ITERS), "bound_ms": b, "bound_by": by,
         "library_ms": cuda_time_ms(library),
         "no_incidence_ms": cuda_time_ms(no_inc, iters=PLAIN_ITERS),
         "shape": (f"{'es sum' if len(srcs) == 1 else 'd ga and d gb'}: P {P}, n "
                   f"{'+'.join(str(v.shape[1]) for v in srcs)}, F {F}, B {B}, capD {capD}, "
                   f"incidence entries {inc[1].numel()}")}
    print(f"  window_scatter ({key}) without an incidence (built for the call on the card): "
          f"{r['no_incidence_ms'] * 1e3:.2f} us")
    return r


def gat_bounds(args, name, nh):
    """(bytes, f32 operations) each attention kernel needs on these inputs:
    every input read once (h_e at the live cells only) and every output
    written once; per live cell and head, |diff| . a costs 4 operations a
    hidden unit (subtract, absolute value, multiply-add) and the softmax
    terms ~GAT_CELL_OPS."""
    f = lambda *ts: 4 * sum(t.numel() for t in ts)
    if name.startswith("gat_scores"):
        ha, hn, a, m3 = args[:4]
        H = ha.shape[2] // nh
        cells = int((m3 != 0).sum())
        if name == "gat_scores_fwd":
            P, na, nt = m3.shape
            out = 4 * nh * P * (na * nt + 2 * (na + nt))
            return f(ha, hn, a, m3) + out, cells * nh * (4 * H + GAT_CELL_OPS)
        # backward: the forward again, then d ha, d hn (3 each) and d a (2) a unit
        return (f(ha, hn, a, m3, *args[6:9]) + f(ha, hn, a),
                cells * nh * (12 * H + 2 * GAT_CELL_OPS))
    e, mr, mc, zr, zc, he, m3, ka, kn, keep = args[:10]
    H, esz = he.shape[3], he.element_size()  # bf16 h_e and d h_e: 2 bytes a value
    cells = int((m3 != 0).sum())
    masks = f(ka, kn) if keep < 1.0 else 0
    small = f(e, mr, mc, zr, zc, m3) + masks + esz * cells * H
    if name == "gat_aggregate_fwd":
        # rs and cs written; a multiply-add a cell and unit for each
        P, na, nt = m3.shape
        return small + 4 * P * (na + nt) * H, cells * (nh * GAT_CELL_OPS + 4 * H)
    g_rs, g_cs = args[10:12]
    # datt: two dot products a cell; d h_e: two multiply-adds a cell, head and unit
    out = f(e, mr, mc, zr, zc) + esz * he.numel()
    return small + f(g_rs, g_cs) + out, cells * (4 * H + nh * (4 * H + GAT_CELL_OPS))


def gat_kernel_phase(torch, gat_ops, inputs, launches):
    """Phase 8: the four attention kernels at the widest round of phase 7,
    and at the same shape with 3 heads on seeded inputs.  Returns (rows,
    the 3-head rows, the 3-head aggregate inputs (forward, backward))."""
    fwd_s, bwd_s = inputs["gat_scores_fwd"], inputs["gat_scores_bwd"]
    fwd_a, bwd_a = inputs["gat_aggregate_fwd"], inputs["gat_aggregate_bwd"]
    ha, hn, a, m3, alpha, _ = fwd_s
    P, na, nt = m3.shape
    H = ha.shape[2] // GAT_HEADS
    he = fwd_a[5]
    # the same shape with GAT_HEADS_WIDE heads: seeded inputs, the widest
    # round's mask and edge hiddens, row/column-local softmax statistics
    nh3 = GAT_HEADS_WIDE
    g = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, device="cuda", generator=g)
    s3 = (rnd(P, na, nh3 * H), rnd(P, nt, nh3 * H), 0.3 * rnd(nh3 * H, 1), m3, alpha, nh3)
    e3, rmax3, cmax3, sal3, sbl3 = gat_ops.gat_scores_stats_reference(*s3)
    safe = lambda x: torch.where(x > gat_ops.NEG_SCORE / 2, x, 0.0)
    keep3 = lambda: (torch.rand((nh3, P, na, nt), device="cuda", generator=g) < 0.5).float()
    a3 = (e3, safe(rmax3), safe(cmax3), sal3, sbl3, he, m3, keep3(), keep3(), 0.5)
    cases = {
        "gat_scores_fwd": [(GAT_HEADS, fwd_s), (nh3, s3)],
        "gat_scores_bwd": [(GAT_HEADS, bwd_s),
                           (nh3, s3 + (rnd(nh3, P, na, nt), rnd(nh3, P, na), rnd(nh3, P, nt)))],
        "gat_aggregate_fwd": [(GAT_HEADS, fwd_a), (nh3, a3)],
        "gat_aggregate_bwd": [(GAT_HEADS, bwd_a), (nh3, a3 + (rnd(P, na, H), rnd(P, nt, H)))],
    }
    plain = {"gat_scores_fwd": gat_ops.gat_scores_stats_reference,
             "gat_scores_bwd": gat_ops.gat_scores_stats_backward_reference,
             "gat_aggregate_fwd": gat_ops.gat_aggregate_reference,
             "gat_aggregate_bwd": gat_ops.gat_aggregate_backward_reference}
    rows, wide = [], {}
    three = (cases["gat_aggregate_fwd"][1][1], cases["gat_aggregate_bwd"][1][1])
    for name, runs in cases.items():
        kernel = getattr(gat_ops, f"_{name}_cuda")
        forward = name.endswith("fwd")
        for nh, args in runs:
            got, again, want = kernel(*args), kernel(*args), plain[name](*args)
            torch.cuda.synchronize()
            err = 0.0
            for k, (x, w) in enumerate(zip(got, want)):
                err = max(err, float((x - w).abs().max()))
                if forward:
                    ok = torch.allclose(x, w, rtol=GAT_FWD_RTOL, atol=GAT_FWD_ATOL)
                else:
                    ok = torch.allclose(x, w, rtol=ROUND_BWD_RTOL,
                                        atol=ROUND_BWD_ATOL_SCALE * max(float(w.abs().max()),
                                                                        1e-30))
                if not ok:
                    fail(f"{name} (nh {nh}) output {k} differs from its plain version by "
                         f"{float((x - w).abs().max()):.3g}")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"{name} (nh {nh}) is not bitwise the same on a second launch")
            b, by = bound_ms(*gat_bounds(args, name, nh))
            r = {
                "name": name, "route": "cuda",
                "source": "trackmpnn_tpu_torch/csrc/gat_kernels.cu",
                "replaces": GAT_REPLACES[name], "launches": launches[name],
                "max_abs_err": err,
                "ms": cuda_time_ms(lambda: kernel(*args)),
                "call_ms": cuda_time_ms(lambda: kernel(*args), queue_ahead=False),
                "plain_ms": cuda_time_ms(lambda: plain[name](*args), iters=PLAIN_ITERS),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "shape": f"nh {nh}, P {P}, na {na}, nt {nt}, H {H}, "
                         f"live cells {int((m3 != 0).sum())}",
            }
            print(f"kernel {name} ({r['shape']}): device {r['ms'] * 1e3:.2f} us, per call "
                  f"{r['call_ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f} us, bound "
                  f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}), max abs err {err:.3g}")
            if nh == GAT_HEADS:
                rows.append(r)
            else:
                wide[name] = r
    return rows, wide, three


# the attention kernels held once more at widths the first design refused
# (its shared memory grew with na, nt and nh), on seeded inputs
# (tests/torch_port_util.py::gat_inputs), against their plain versions in f64
GAT_WIDE = dict(P=4, na=128, nt=128, H=HIDDEN)   # GAT_HEADS_WIDE heads: both backwards refused it
GAT1_WIDE = dict(P=2, na=112, nt=112, H=HIDDEN)  # one head: the score backward refused it


def gat_wide_inputs(torch, seed, nh, P, na, nt, H):
    """gat_inputs on the card, keep masks at 0.5."""
    if os.path.join(HERE, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_util import gat_inputs

    x = gat_inputs(seed, nh, 0.5, P=P, na=na, nt=nt, H=H)
    return {k: [torch.from_numpy(a).to("cuda") for a in v] for k, v in x.items()}


def gat_wide_rows(torch, gat_ops, which):
    """Phases 8 ("stacked": the four stacked kernels at GAT_HEADS_WIDE heads,
    GAT_WIDE), 20 ("gat1": the four single-head kernels at GAT1_WIDE, also
    bitwise equal to the stacked ones at nh = 1) and 21 ("gat0": kernel #8 at
    GAT1_WIDE, bitwise equal to gat1_*): each against its plain version
    evaluated in f64 (forwards rtol and atol GAT_FWD_*, backwards rtol 1e-4
    with atol 1e-5 x each output's scale), bitwise the same on a second
    launch, timed beside the plain version in f32 and its bound; outside the
    kernels line."""
    from torch_port_util import in_f64

    nh = GAT_HEADS_WIDE if which == "stacked" else 1
    dims = GAT_WIDE if which == "stacked" else GAT1_WIDE
    x = gat_wide_inputs(torch, 13 if which == "stacked" else 14, nh, **dims)
    s_args, a_args = tuple(x["scores"]), tuple(x["agg"])
    ge, gsal, gsbl = x["scores_cot"]
    g_rs, g_cs = x["agg_cot"]
    if which == "stacked":
        cases = {"gat_scores_fwd": ((*s_args, 0.2, nh), gat_ops.gat_scores_stats_reference, None),
                 "gat_scores_bwd": ((*s_args, 0.2, nh, ge, gsal, gsbl),
                                    gat_ops.gat_scores_stats_backward_reference, None),
                 "gat_aggregate_fwd": ((*a_args, 0.5), gat_ops.gat_aggregate_reference, None),
                 "gat_aggregate_bwd": ((*a_args, 0.5, g_rs, g_cs),
                                       gat_ops.gat_aggregate_backward_reference, None)}
    else:
        one = tuple(t[0] for t in a_args[:5]) + a_args[5:7] + (a_args[7][0], a_args[8][0])
        s1 = (*s_args, 0.2)
        zeros = (torch.zeros_like(gsal[0]), torch.zeros_like(gsbl[0]))
        if which == "gat1":
            cases = {"gat1_scores_fwd": (s1, gat_ops.gat_scores_stats_1h_reference,
                                         lambda: gat_ops._gat_scores_fwd_cuda(*s_args, 0.2, 1)),
                     "gat1_scores_bwd": ((*s1, ge[0], gsal[0], gsbl[0]),
                                         gat_ops.gat_scores_stats_1h_backward_reference,
                                         lambda: gat_ops._gat_scores_bwd_cuda(*s_args, 0.2, 1, ge,
                                                                              gsal, gsbl)),
                     "gat1_aggregate_fwd": ((*one, 0.5), gat_ops.gat_aggregate_1h_reference,
                                            lambda: gat_ops._gat_aggregate_fwd_cuda(*a_args, 0.5)),
                     "gat1_aggregate_bwd": ((*one, 0.5, g_rs, g_cs),
                                            gat_ops.gat_aggregate_1h_backward_reference,
                                            lambda: gat_ops._gat_aggregate_bwd_cuda(
                                                *a_args, 0.5, g_rs, g_cs))}
        else:
            cases = {"gat0_scores_fwd": (s1, gat_ops.gat_scores_reference,
                                         lambda: gat_ops._gat1_scores_fwd_cuda(*s1)[:1]),
                     "gat0_scores_bwd": ((*s1, ge[0]), gat_ops.gat_scores_backward_reference,
                                         lambda: gat_ops._gat1_scores_bwd_cuda(*s1, ge[0], *zeros))}
    P, na, nt, H = dims["P"], dims["na"], dims["nt"], dims["H"]
    live = int((s_args[3] != 0).sum())
    rows = []
    for name, (args, ref, same) in cases.items():
        cuda = getattr(gat_ops, f"_{name}_cuda")
        kernel = (lambda: (cuda(*args),)) if name == "gat0_scores_fwd" else (lambda: cuda(*args))
        got, again = kernel(), kernel()
        want = in_f64(ref, *args)
        torch.cuda.synchronize()
        forward = name.endswith("fwd")
        err = 0.0
        for k, (a, w) in enumerate(zip(got, want)):
            err = max(err, float((a - w).abs().max()))
            ok = (torch.allclose(a, w, rtol=GAT_FWD_RTOL, atol=GAT_FWD_ATOL) if forward else
                  torch.allclose(a, w, rtol=ROUND_BWD_RTOL,
                                 atol=ROUND_BWD_ATOL_SCALE * max(float(w.abs().max()), 1e-30)))
            if not ok:
                fail(f"{name} (nh {nh}, P {P}, na {na}, nt {nt}, H {H}) output {k} differs from "
                     f"its plain version in f64 by {float((a - w).abs().max()):.3g}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name} (na {na}, nt {nt}) is not bitwise the same on a second launch")
        if same is not None and not all(torch.equal(a, b.reshape(a.shape))
                                        for a, b in zip(got, same())):
            fail(f"{name} (na {na}, nt {nt}) is not bitwise equal to "
                 f"{'the stacked kernel at nh 1' if which == 'gat1' else 'gat1_*'}")
        if which == "gat0":
            b, by = bound_ms(*gat0_bounds(name, args))
        else:
            st_name = name.replace("gat1_", "gat_")
            st_args = args if which == "stacked" else (
                (*s_args, 0.2, 1, ge, gsal, gsbl)[:len(args) + 1] if "scores" in name
                else (*a_args, *args[9:]))
            b, by = bound_ms(*gat_bounds(st_args, st_name, nh))
        r = {"name": name, "max_abs_err_vs_f64": err, "ms": cuda_time_ms(kernel),
             "plain_ms": cuda_time_ms(lambda: ref(*args), iters=PLAIN_ITERS),
             "bound_ms": b, "bound_by": by,
             "shape": f"nh {nh}, P {P}, na {na}, nt {nt}, H {H}, live cells {live}"}
        print(f"kernel {name} at a width the first design refused ({r['shape']}): device "
              f"{r['ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{b * 1e3:.2f} us by {by}), max abs err vs f64 {err:.3g}, bitwise on a relaunch"
              + ("" if same is None else ", bitwise equal to the kernel it shares a body with"))
        rows.append(r)
    return rows


def gat_serving_phase(torch, np, mp):
    """Phase 9: one sequence served by a random GAT model, card against CPU."""
    from trackmpnn_tpu_torch.data.synthetic import make_sequence
    from trackmpnn_tpu_torch.decode.tracker import Tracker, TrackerConfig
    from trackmpnn_tpu_torch.models import mpnn

    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN, msg_type="diff",
                           nattheads=GAT_HEADS)
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    stats = mpnn.init_batch_stats(cfg)
    tcfg = TrackerConfig(cur_win_size=WIN, hungarian=True)
    X, bbox_pred, _ = make_sequence(num_tracks=SERVE_TRACKS, num_frames=SERVE_FRAMES,
                                    ncategories=3, seed=SERVE_SEEDS[0])
    seq = [(X, bbox_pred[:, :2].astype(np.int64))]
    gpu = Tracker(params, stats, cfg, tcfg, device="cuda")
    gpu.run(X[:200], seq[0][1][:200])  # warm-up
    torch.cuda.synchronize()
    for k in mp.LAUNCHES:
        mp.LAUNCHES[k] = 0
    runs, fwd_ms, walls = serve(gpu, seq, np)
    launches = dict(mp.LAUNCHES)
    forwards = len(runs[0][0])
    if launches != {**dict.fromkeys(mp.LAUNCHES, 0), "fused_edge_gru": forwards}:
        fail(f"GAT serving: launches {launches} over {forwards} forwards, expected "
             "fused_edge_gru once a forward, no gather_diff and no signed_segment_sum")
    cpu_runs, _, _ = serve(Tracker(params, stats, cfg, tcfg, device="cpu"), seq, np)
    (steps, y_out), (c_steps, c_y_out) = runs[0], cpu_runs[0]
    if [n for n, _ in steps] != [n for n, _ in c_steps]:
        fail("GAT serving: the card's and the CPU's windows differ")
    worst = max(float(np.abs(s - cs).max()) for (_, s), (_, cs) in zip(steps, c_steps))
    if not np.array_equal(y_out, c_y_out):
        fail("GAT serving: decoded tracks differ between card and CPU")
    if worst > STEP_SCORE_ATOL:
        fail(f"GAT serving: per-step scores differ by {worst:.3g} > {STEP_SCORE_ATOL}")
    frames = len(np.unique(seq[0][1][:, 0]))
    f = np.array(fwd_ms)
    summary = {"heads": GAT_HEADS, "frames": frames, "forwards": forwards, "wall_s": walls[0],
               "frames_per_s": frames / walls[0], "forward_ms_mean": float(f.mean()),
               "forward_ms_p99": float(np.percentile(f, 99)),
               "max_step_score_err_vs_cpu": worst, "launches": launches}
    print("GAT serving: " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                                      for k, v in summary.items()) + "; tracks equal the CPU's")
    return summary


# ------------------------------------------- es round and fused edge losses ----
ES_LOSS_REPLACES = {"block_round_es_fwd": "trackmpnn_tpu/ops/pallas_block.py:333",
                    "block_round_es_bwd": "trackmpnn_tpu/ops/pallas_block.py:382",
                    "edge_loss_l1": "trackmpnn_tpu/ops/pallas_loss.py:88",
                    "edge_loss_l2": "trackmpnn_tpu/ops/pallas_loss.py:126",
                    "edge_loss_bwd": "trackmpnn_tpu/ops/pallas_loss.py:167"}
EDGE_LOSS_COUNTS = [3, 4, 5, 6]  # bce_count, tp, fp, fn: exact
# f32 operations a live cell takes in the loss terms (exps, logs, sigmoid,
# divisions, compares) beyond the head's K-wide product
LOSS_CELL_OPS = 20


def es_loss_bounds(name, args):
    """(bytes, f32 operations) the es round's and the edge losses' kernels
    need on these inputs: each input read once (edge-sized inputs at the live
    cells, the detection-layout rows at the live rows and columns), each
    output written once; the round's products as rows 4-5 count them."""
    f = lambda *ts: 4 * sum(t.numel() for t in ts)
    if name.startswith("block_round_es"):
        he, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, m3, _, B, capD, ip, islot = args[:15]
        H = he.shape[3]
        live = m3 != 0
        cells = int(live.sum())
        lines = int(live.any(2).sum()) + int(live.any(1).sum())  # live rows + columns
        weights = f(b_ih, w_hh, b_hh, w_eb)
        small = f(m3, act_l, new_l, ip, islot) + weights + 4 * lines * 3 * H
        if name == "block_round_es_fwd":  # edge_out, lg, es written
            return (small + 4 * cells * H + f(he, m3) + 4 * B * capD * H,
                    cells * (2 * H * 3 * H + 4 * H + GATE_FLOPS_PER_UNIT * H) + lines * H)
        g_eo, g_lg, _ = args[15:18]  # g_es read at the live rows and columns
        return (small + 8 * cells * H + f(g_lg) + 4 * lines * H + f(he) + 8 * B * capD * 3 * H
                + weights, cells * (3 * 2 * H * 3 * H + 2 * GATE_FLOPS_PER_UNIT * H)
                + lines * 3 * H)
    if name == "edge_loss_l2":
        cells = int((args[2] != 0).sum())
        return f(*args) + 4 * args[0].shape[0] * 8, cells * LOSS_CELL_OPS
    h_eo = args[0]
    P, na, nt, K = h_eo.shape
    cells = int((args[4] != 0).sum())
    if name == "edge_loss_l1":  # logits, r_min, m_r, s_r written
        return (4 * cells * K + f(*args[1:]) + 4 * P * na * (nt + 3),
                cells * (2 * K + LOSS_CELL_OPS))
    # edge_loss_bwd: d h_eo and d w_e, d b_e written
    return (4 * cells * K + f(*args[1:]) + f(h_eo) + 4 * (K + 1),
            cells * (3 * K + LOSS_CELL_OPS))


def es_loss_kernel_phase(torch, block_ops, loss_ops, inputs, launches, wide):
    """Phase 14: the es round's and the edge losses' kernels on phase 13's
    widest inputs (one branch: K = 64) and the edge losses' also on phase
    18's (three branches side by side: K = 192) against their plain
    versions, twice (bitwise), and timed.  Returns the kernels line's rows
    (the losses at K = 192) and the K = 64 loss rows."""
    kernels = {
        "block_round_es_fwd": (block_ops._block_round_es_fwd_cuda,
                               block_ops.block_round_es_reference),
        "block_round_es_bwd": (block_ops._block_round_es_bwd_cuda,
                               block_ops.block_round_es_backward_reference),
        "edge_loss_l1": (loss_ops._l1_cuda, loss_ops.edge_loss_l1_reference),
        "edge_loss_l2": (loss_ops._l2_cuda, loss_ops.edge_loss_l2_reference),
        "edge_loss_bwd": (loss_ops._bwd_cuda, loss_ops.edge_loss_bwd_reference),
    }
    as_list = lambda out: list(out) if isinstance(out, (tuple, list)) else [out]
    rows, narrow = [], {}
    runs = [(name, inputs[name]) for name in kernels]
    runs += [(name, wide[name]) for name in kernels if name.startswith("edge_loss")]
    for name, args in runs:
        kernel, plain = kernels[name]
        got, again, want = (as_list(fn(*args)) for fn in (kernel, kernel, plain))
        torch.cuda.synchronize()
        err = 0.0
        for k, (a, w) in enumerate(zip(got, want)):
            diff = float((a - w).abs().max())
            err = max(err, diff)
            if name.endswith("bwd"):
                ok = torch.allclose(a, w, rtol=ROUND_BWD_RTOL,
                                    atol=ROUND_BWD_ATOL_SCALE * max(float(w.abs().max()), 1e-30))
            else:
                ok = diff <= ROUND_FWD_ATOL
            if not ok:
                fail(f"{name} output {k} differs from its plain version by {diff:.3g}")
        if name == "edge_loss_l2" and not torch.equal(got[0][:, EDGE_LOSS_COUNTS],
                                                      want[0][:, EDGE_LOSS_COUNTS]):
            fail("edge_loss_l2's counts (bce_count, tp, fp, fn) differ from its plain version's")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name} is not bitwise the same on a second launch")
        m3 = args[{"block_round_es_fwd": 9, "block_round_es_bwd": 9, "edge_loss_l2": 2}.get(
            name, 4)]
        if name == "block_round_es_fwd" and not (torch.all(got[0][m3 == 0] == 0)
                                                 and torch.all(got[1][m3 == 0] == 0)):
            fail("block_round_es_fwd wrote a nonzero edge_out or lg at a padded cell")
        cost = es_loss_bounds(name, args)
        b, by = bound_ms(*cost)
        r = {"name": name, "route": "cuda",
             "source": ("trackmpnn_tpu_torch/csrc/block_kernels.cu" if name.startswith("block")
                        else "trackmpnn_tpu_torch/csrc/loss_kernels.cu"),
             "replaces": ES_LOSS_REPLACES[name], "launches": launches[name],
             "max_abs_err": err,
             "ms": cuda_time_ms(lambda: kernel(*args)),
             "call_ms": cuda_time_ms(lambda: kernel(*args), queue_ahead=False),
             # the es round's plain backward launches ~100 ops a call: fewer
             # calls, so that they fit the device's queue behind the sleep
             "plain_ms": cuda_time_ms(lambda: plain(*args), iters=(
                 PLAIN_ITERS // 3 if name == "block_round_es_bwd" else PLAIN_ITERS)),
             "bound_ms": b, "bound_by": by, "library_ms": None,
             "shape": f"P {m3.shape[0]}, na {m3.shape[1]}, nt {m3.shape[2]}, "
                      f"live cells {int((m3 != 0).sum())}"}
        if name.startswith("block_round_es"):
            r["bound_tf32_ms"] = bound_tf32_ms(*cost)
        if name.startswith("edge_loss"):
            r["shape"] += f", K {args[0].shape[-1] if name != 'edge_loss_l2' else '-'}"
        print_kernel_row(r)
        if name.startswith("edge_loss") and name not in narrow:
            narrow[name] = r  # the one-branch width; the kernels line takes K = 192
        else:
            rows.append(r)
    return rows, narrow


def wide_es_rows(torch, np, block_ops):
    """block_round_es_fwd (atol 1e-5) and _bwd (rtol 1e-4, atol 1e-5 x each
    output's scale) at WIDE_ES on seeded inputs (tests/torch_port_util.py::
    es_inputs, numpy and the port only) against their plain versions in
    f64, bitwise on a second launch, padded cells exactly 0, timed beside
    the plain versions in f32 and both bounds; outside the kernels line."""
    if os.path.join(HERE, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_util import es_inputs, in_f64

    sign, B, capD = -1.0, WIDE_ES["B"], WIDE_ES["capD"]
    act, new, blk_na, blk_nt, w, cot = es_inputs(7, sign, **WIDE_ES)
    ip, islot = block_ops.block_incidence(act, new, blk_na, blk_nt, B * capD)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
    ga_d = put(w["ga_d"])  # 'diff': one tensor as both ga_d and gb_d
    args = (put(w["h_e"] * w["mask3"][..., None]), put((act % capD).astype(np.int32)),
            put((new % capD).astype(np.int32)), ga_d, ga_d, put(w["b_ih"]), put(w["w_hh"]),
            put(w["b_hh"]), put(w["w_eb"]), put(w["mask3"]), sign, B, capD, put(ip), put(islot))
    cots = (put(cot["g_eo"]), put(cot["g_lg"]), put(cot["g_es"]))
    m3 = args[9]
    rows = []
    for name, kernel, plain, a in (
            ("block_round_es_fwd", block_ops._block_round_es_fwd_cuda,
             block_ops.block_round_es_reference, args),
            ("block_round_es_bwd", block_ops._block_round_es_bwd_cuda,
             block_ops.block_round_es_backward_reference, args + cots)):
        got, again = kernel(*a), kernel(*a)
        want = in_f64(plain, *a)
        torch.cuda.synchronize()
        err = 0.0
        for k, (x, y) in enumerate(zip(got, want)):
            diff = float((x - y).abs().max())
            err = max(err, diff)
            ok = (diff <= ROUND_FWD_ATOL if name.endswith("fwd") else
                  torch.allclose(x, y, rtol=ROUND_BWD_RTOL,
                                 atol=ROUND_BWD_ATOL_SCALE * max(float(y.abs().max()), 1e-30)))
            if not ok:
                fail(f"{name} (H {WIDE_HIDDEN}) output {k} differs from its plain version in "
                     f"f64 by {diff:.3g}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"{name} (H {WIDE_HIDDEN}) is not bitwise the same on a second launch")
        if not torch.all(got[0][m3 == 0] == 0):
            fail(f"{name} (H {WIDE_HIDDEN}) wrote a nonzero value at a padded cell")
        cost = es_loss_bounds(name, a)
        b, by = bound_ms(*cost)
        r = {"name": name, "route": "cuda", "source": "trackmpnn_tpu_torch/csrc/block_kernels.cu",
             "replaces": ES_LOSS_REPLACES[name], "launches": None, "max_abs_err": err,
             "ms": cuda_time_ms(lambda: kernel(*a)),
             "call_ms": cuda_time_ms(lambda: kernel(*a), queue_ahead=False),
             "plain_ms": cuda_time_ms(lambda: plain(*a), iters=PLAIN_ITERS // 3),
             "bound_ms": b, "bound_by": by, "bound_tf32_ms": bound_tf32_ms(*cost),
             "library_ms": None,
             "shape": f"P {m3.shape[0]}, na {m3.shape[1]}, nt {m3.shape[2]}, H {WIDE_HIDDEN}, "
                      f"live cells {int((m3 != 0).sum())}"}
        print_kernel_row(r, " (vs the plain version in f64)")
        rows.append(r)
    return rows


WIDE_LOSS = dict(P=4, na=128, nt=128, K=3 * HIDDEN, nD=2048)
WIDE_LOSS_SEED = 4  # a seed whose blocks hold detections with live rows and no positive edge


def wide_loss_rows(torch, np, loss_ops):
    """edge_loss_l1, _l2 (atol 1e-5, the counts exact) and _bwd (rtol 1e-4,
    atol 1e-5 x each output's scale) at WIDE_LOSS on seeded inputs
    (tests/torch_port_util.py::edge_loss_inputs; the glue and the spread
    weight from the plain versions) against their plain versions (the logits
    and the backward in f64, L1's row statistics those of its own logits in
    f64), bitwise on a second launch, timed beside the plain versions in f32
    and their bound; outside the kernels line."""
    if os.path.join(HERE, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_util import EDGE_LOSS_KEYS, edge_loss_inputs, in_f64

    x, d_part = edge_loss_inputs(WIDE_LOSS_SEED, **WIDE_LOSS)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
    h_eo, w_e, b_e, lbl, m3, ebnt, bna, act, act_m = (put(x[k]) for k in EDGE_LOSS_KEYS[:9])
    d_part, nD = put(d_part), WIDE_LOSS["nD"]
    logits, r_min, m_r, s_r = loss_ops.edge_loss_l1_reference(h_eo, w_e, b_e, lbl, m3, ebnt)
    glue = loss_ops.edge_loss_glue(r_min, m_r, s_r, m3, ebnt, act, act_m, nD)
    wg = loss_ops.edge_loss_spread(r_min, glue[0], glue[2], d_part, act, act_m, nD).contiguous()
    as_list = lambda out: list(out) if isinstance(out, (tuple, list)) else [out]
    cases = {"edge_loss_l1": (loss_ops._l1_cuda, loss_ops.edge_loss_l1_reference,
                              (h_eo, w_e, b_e, lbl, m3, ebnt)),
             "edge_loss_l2": (loss_ops._l2_cuda, loss_ops.edge_loss_l2_reference,
                              (logits, lbl, m3, ebnt, bna, *glue)),
             "edge_loss_bwd": (loss_ops._bwd_cuda, loss_ops.edge_loss_bwd_reference,
                               (h_eo, w_e, logits, lbl, m3, ebnt, bna, *glue, wg, d_part))}
    rows = []
    for name, (kernel, plain, args) in cases.items():
        got, again = as_list(kernel(*args)), as_list(kernel(*args))
        # L2 sums in f64 the f32 terms its plain version forms too (in f64
        # the terms would move a block's BCE sum of ~10^4 by ulps of its
        # f32); L1's row statistics from its own logits (at nt 128 an f32
        # logit's rounding alone moves s_r by ~1e-5)
        if name == "edge_loss_l2":
            want = as_list(plain(*args))
        elif name == "edge_loss_l1":
            want = in_f64(plain, *args)[:1] + in_f64(loss_ops.edge_loss_row_stats, got[0],
                                                     *args[3:])
        else:
            want = in_f64(plain, *args)
        torch.cuda.synchronize()
        err = 0.0
        for k, (a, w) in enumerate(zip(got, want)):
            diff = float((a - w).abs().max())
            err = max(err, diff)
            ok = (diff <= ROUND_FWD_ATOL if name != "edge_loss_bwd" else
                  torch.allclose(a, w, rtol=ROUND_BWD_RTOL,
                                 atol=ROUND_BWD_ATOL_SCALE * max(float(w.abs().max()), 1e-30)))
            if not ok:
                fail(f"{name} (na = nt = {WIDE_LOSS['na']}) output {k} differs from its plain "
                     f"version in f64 by {diff:.3g}")
        if name == "edge_loss_l2" and not torch.equal(got[0][:, EDGE_LOSS_COUNTS],
                                                      want[0][:, EDGE_LOSS_COUNTS]):
            fail("edge_loss_l2's counts (bce_count, tp, fp, fn) differ from its plain version's "
                 f"(na = nt = {WIDE_LOSS['na']})")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name} (na = nt = {WIDE_LOSS['na']}) is not bitwise the same on a second "
                 f"launch")
        b, by = bound_ms(*es_loss_bounds(name, args))
        r = {"name": name, "route": "cuda", "source": "trackmpnn_tpu_torch/csrc/loss_kernels.cu",
             "replaces": ES_LOSS_REPLACES[name], "launches": None, "max_abs_err": err,
             "ms": cuda_time_ms(lambda: kernel(*args)),
             "call_ms": cuda_time_ms(lambda: kernel(*args), queue_ahead=False),
             "plain_ms": cuda_time_ms(lambda: plain(*args), iters=PLAIN_ITERS),
             "bound_ms": b, "bound_by": by, "library_ms": None,
             "shape": f"P {WIDE_LOSS['P']}, na {WIDE_LOSS['na']}, nt {WIDE_LOSS['nt']}, "
                      f"K {WIDE_LOSS['K'] if name != 'edge_loss_l2' else '-'}, live cells "
                      f"{int((m3 != 0).sum())} (seeded)"}
        print_kernel_row(r, "" if name == "edge_loss_l2" else " (vs the plain version in f64)")
        rows.append(r)
    return rows


# ------------------------------------------------------ row-layout training ----
ROUND_REPLACES = {"round_fwd": "trackmpnn_tpu/ops/pallas_round.py:79",
                  "round_bwd_gru": "trackmpnn_tpu/ops/pallas_round.py:225",
                  "round_bwd_dw": "trackmpnn_tpu/ops/pallas_round.py:258",
                  "round_bwd_dh": "trackmpnn_tpu/ops/pallas_round.py:268"}
PACKED_HIDDEN_RTOL, PACKED_HIDDEN_ATOL = 1e-3, 1e-4  # tests/test_pallas_round.py:78


def packed_workload(np):
    """Phase 5's windows rebuilt at bench.py's packing capacity (the largest
    window's rows rounded up to 1024, bench.py:118-122), with their live
    edge rows summed over steps per window."""
    from trackmpnn_tpu_torch.graph.schedule import build_window_schedule

    chunks = training_chunks(np)
    raw = [build_window_schedule(X, y) for X, y in chunks]
    cap = ((max(ws.n_rows for ws in raw) + 1023) // 1024) * 1024
    t_cap = max(ws.n_steps for ws in raw)
    packed = [build_window_schedule(X, y, cap=cap, t_cap=t_cap) for X, y in chunks]
    return packed, cap, t_cap, [live_edges(np, ws) for ws in packed]


def row_model(torch, hidden=HIDDEN):
    from trackmpnn_tpu_torch.models import mpnn

    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=hidden, msg_type="diff")
    return cfg, mpnn.init_params(torch.Generator().manual_seed(0), cfg), mpnn.init_batch_stats(cfg)


def timed_steps(torch, run, counters):
    """3 warm-up steps, then TRAIN_STEPS timed ones with every counter set
    to 0 before and read after.  Returns (losses, ms/step by CUDA events,
    ms/step host wall, launches)."""
    for _ in range(TRAIN_WARMUP):
        run()
    torch.cuda.synchronize()
    for c in counters:
        for k in c:
            c[k] = 0
    losses = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_STEPS):
        losses.append(run())
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = {k: v for c in counters for k, v in c.items()}
    return (torch.stack(losses).cpu().numpy(), start.elapsed_time(end) / TRAIN_STEPS, wall_ms,
            launches)


def check_launches(what, launches, expected):
    for k, v in expected.items():
        if launches[k] != v * TRAIN_STEPS:
            fail(f"{what}: {k} launched {launches[k]} times in {TRAIN_STEPS} steps, "
                 f"expected {v} a step")


def batch1_phase(torch, np, mp, round_ops, packed_wl):
    """Phase 10: train/step.py's batch-1 step on the first window."""
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import optim
    from trackmpnn_tpu_torch.train import step as train_step

    what = "row-layout training, batch 1"
    schedules, cap, t_cap, edges = packed_wl
    ws, edges = schedules[0], edges[0]
    valid = int(ws.step_valid.sum())
    cfg, params0, stats0 = row_model(torch)
    step = train_step.make_train_step(cfg, tp_classifier=False)
    built = mp.BUILDS["segment_incidence"]
    sb = train_step.schedule_to_device(ws, device="cuda")
    if mp.BUILDS["segment_incidence"] != built + 1:
        fail(f"{what}: the step batch built its incidence "
             f"{mp.BUILDS['segment_incidence'] - built} times, expected once")
    build = incidence_build(torch, np, mp, sb.past, sb.fut, cap, f"batch 1, capacity {cap}",
                            "batch 1")
    INCIDENCE["batch 1"]["builds_per_step_batch"] = 1
    print(f"{what} inputs: one window, cap {cap}, rows {ws.n_rows}, T {t_cap} ({valid} valid), "
          f"H {HIDDEN}, live edge rows summed over steps {edges}")
    params = train_block.trainable(to_device(params0, "cuda"))
    stats = to_device(stats0, "cuda")
    opt = optim.make_optimizer(train_block.param_leaves(params), TRAIN_LR, TRAIN_WD)
    mp_inputs = {}
    with record_mp_widest(mp, mp_inputs):
        params, stats, loss1, aux1 = step(params, stats, opt, sb)
    grads1 = [p.grad.detach().clone() for p in train_block.param_leaves(params)]
    torch.cuda.synchronize()

    def run():
        nonlocal params, stats
        params, stats, loss, _ = step(params, stats, opt, sb)
        return loss

    losses, events_ms, wall_ms, launches = timed_steps(torch, run, (mp.LAUNCHES, mp.BUILDS,
                                                                    round_ops.LAUNCHES))
    check_launches(what, launches, {**row_step_launches("diff", valid), "segment_incidence": 0,
                                    **dict.fromkeys(round_ops.LAUNCHES, 0)})
    if not np.all(np.isfinite(losses)):
        fail(f"{what} loss not finite: {losses}")
    print(f"{what}: {TRAIN_STEPS} steps, {events_ms:.3f} ms/step (CUDA events), {wall_ms:.3f} "
          f"ms/step (host wall), {edges / (wall_ms / 1e3):.4g} edges/s; launches a step "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items() if v} }; loss "
          f"{float(loss1):.6g} -> {losses[-1]:.6g}")
    profile = device_profile(torch, run, wall_ms / 1e3)

    params_c = train_block.trainable(params0)
    opt_c = optim.make_optimizer(train_block.param_leaves(params_c), TRAIN_LR, TRAIN_WD)
    t0 = time.perf_counter()
    params_c, _, loss_c, aux_c = step(params_c, stats0, opt_c,
                                      train_step.schedule_to_device(ws, device="cpu"))
    cpu_step_s = time.perf_counter() - t0
    total = lambda aux: {**aux, **{k: aux[k].sum() for k in ("tp", "fp", "fn")}}
    worst_grad, gscale = first_step_agrees(torch, train_block, loss1, total(aux1), grads1,
                                           loss_c, total(aux_c), params_c, what)
    print(f"{what} vs CPU: loss {float(loss1)!r} / {float(loss_c)!r}, tp/fp/fn equal, worst "
          f"grad diff {worst_grad:.3g} (largest |grad| {gscale:.3g}); CPU step {cpu_step_s:.2f} s")
    mp_rows = mp_path_rows(torch, mp, mp_inputs, "row layout, batch 1", build)
    return {"cap": cap, "rows": ws.n_rows, "t_cap": t_cap, "valid_steps": valid,
            "mp_kernels": mp_rows,
            "hidden": HIDDEN, "edges_per_step": edges, "steps": TRAIN_STEPS,
            "ms_per_step_events": events_ms, "ms_per_step_wall": wall_ms,
            "edges_per_s": edges / (wall_ms / 1e3), "launches": launches,
            "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
            "loss_first": float(loss1), "loss_last": float(losses[-1]),
            "cpu_loss_first": float(loss_c), "max_grad_err_vs_cpu": worst_grad,
            "grad_scale": gscale, "cpu_step_s": cpu_step_s,
            "device_busy_share_step": None if profile is None else profile["busy_share"],
            "profile_step": profile}


def live_rows(idxw):
    return int((idxw[..., 2:] != 0).any(-1).sum())


def packed_phase(torch, np, mp, round_ops, packed_wl):
    """Phase 11: packed training with the fused round, then the unfused
    packed step on the same batch.  Returns (summary, the round kernels'
    inputs at their widest round)."""
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import optim
    from trackmpnn_tpu_torch.train import packed

    what = "packed training (fused round)"
    schedules, cap, t_cap, edges = packed_wl
    edges = sum(edges)
    cfg, params0, stats0 = row_model(torch)
    built = mp.BUILDS["segment_incidence"]
    pb = packed.pack_schedules(schedules, cap, t_cap, device="cuda")
    if mp.BUILDS["segment_incidence"] != built + 1:
        fail(f"{what}: the packed batch built its incidence "
             f"{mp.BUILDS['segment_incidence'] - built} times, expected once")
    build = incidence_build(torch, np, mp, pb.past, pb.fut, pb.past.shape[0],
                            f"packed, {pb.past.shape[0]} slots", "packed")
    INCIDENCE["packed"]["builds_per_step_batch"] = 1
    valid = int(pb.valid_host.any(1).sum())
    print(f"{what} inputs: B {pb.n_windows}, cap {cap}, T {t_cap} ({valid} valid), H {HIDDEN}, "
          f"rows {[ws.n_rows for ws in schedules]}, incidence entries {pb.inc_idx.numel()}, "
          f"live edge rows summed over steps {edges}")

    def fused_step(params, stats, opt, batch):
        opt.zero_grad(set_to_none=True)
        loss, aux = packed.packed_window_forward(params, stats, cfg, batch, False,
                                                 fused_round=True)
        loss.backward()
        opt.step()
        return params, aux["batch_stats"], loss.detach(), aux

    params = train_block.trainable(to_device(params0, "cuda"))
    stats = to_device(stats0, "cuda")
    opt = optim.make_optimizer(train_block.param_leaves(params), TRAIN_LR, TRAIN_WD)
    inputs = {}
    widest = lambda i: (lambda a: live_rows(a[i]))
    with contextlib.ExitStack() as rec:
        for name, i in (("round_fwd", 1), ("round_bwd_gru", 1), ("round_bwd_dw", 1),
                        ("round_bwd_dh", 0)):
            rec.enter_context(record_widest(round_ops, f"_{name}_cuda", inputs,
                                            lambda a, n=name: n, blocks=widest(i)))
        params, stats, loss1, aux1 = fused_step(params, stats, opt, pb)
    grads1 = [p.grad.detach().clone() for p in train_block.param_leaves(params)]
    torch.cuda.synchronize()

    # the first step's forward against the unfused packed forward on the card
    with torch.no_grad():
        loss_u, aux_u = packed.packed_window_forward(to_device(params0, "cuda"),
                                                     to_device(stats0, "cuda"), cfg, pb, False)
    if not abs(float(loss1) - float(loss_u)) <= LOSS_RTOL * abs(float(loss_u)):
        fail(f"{what}: loss {float(loss1)!r}, unfused forward {float(loss_u)!r}")
    if not torch.allclose(aux1["hidden"], aux_u["hidden"], rtol=PACKED_HIDDEN_RTOL,
                          atol=PACKED_HIDDEN_ATOL):
        fail(f"{what}: final hidden state differs from the unfused forward's by "
             f"{float((aux1['hidden'] - aux_u['hidden']).abs().max()):.3g}")
    hidden_err = float((aux1["hidden"] - aux_u["hidden"]).abs().max())

    def run():
        nonlocal params, stats
        params, stats, loss, _ = fused_step(params, stats, opt, pb)
        return loss

    counters = (mp.LAUNCHES, mp.BUILDS, round_ops.LAUNCHES)
    losses, events_ms, wall_ms, launches = timed_steps(torch, run, counters)
    check_launches(what, launches, {**dict.fromkeys(round_ops.LAUNCHES, valid),
                                    **dict.fromkeys(mp.LAUNCHES, 0), "segment_incidence": 0})
    if not np.all(np.isfinite(losses)):
        fail(f"{what} loss not finite: {losses}")
    print(f"{what}: {TRAIN_STEPS} steps, {events_ms:.3f} ms/step (CUDA events), {wall_ms:.3f} "
          f"ms/step (host wall), {edges / (wall_ms / 1e3):.4g} edges/s; launches a step "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items() if v} }; loss "
          f"{float(loss1):.6g} -> {losses[-1]:.6g}; unfused forward loss {float(loss_u):.6g}, "
          f"hidden max diff {hidden_err:.3g}")
    profile = device_profile(torch, run, wall_ms / 1e3)

    # the first step again on the CPU (plain round), same weights and batch
    pb_c = packed.pack_schedules(schedules, cap, t_cap, device="cpu")
    params_c = train_block.trainable(params0)
    opt_c = optim.make_optimizer(train_block.param_leaves(params_c), TRAIN_LR, TRAIN_WD)
    t0 = time.perf_counter()
    params_c, _, loss_c, aux_c = fused_step(params_c, stats0, opt_c, pb_c)
    cpu_step_s = time.perf_counter() - t0
    worst_grad, gscale = first_step_agrees(torch, train_block, loss1, aux1, grads1, loss_c,
                                           aux_c, params_c, what)
    print(f"{what} vs CPU: loss {float(loss1)!r} / {float(loss_c)!r}, tp/fp/fn "
          f"{[int(aux1[k]) for k in ('tp', 'fp', 'fn')]} equal, worst grad diff "
          f"{worst_grad:.3g} (largest |grad| {gscale:.3g}); CPU step {cpu_step_s:.2f} s")

    # the first step at WIDE_HIDDEN (a width the first design refused), card
    # against its CPU rerun, each round kernel once a valid step
    cfg_w, params_w0, stats_w0 = row_model(torch, WIDE_HIDDEN)
    params_w = train_block.trainable(to_device(params_w0, "cuda"))
    opt_w = optim.make_optimizer(train_block.param_leaves(params_w), TRAIN_LR, TRAIN_WD)
    zero_counters((round_ops.LAUNCHES,))
    opt_w.zero_grad(set_to_none=True)
    loss_w, aux_w = packed.packed_window_forward(params_w, to_device(stats_w0, "cuda"), cfg_w, pb,
                                                 False, fused_round=True)
    loss_w.backward()
    torch.cuda.synchronize()
    launched_w = dict(round_ops.LAUNCHES)
    if launched_w != dict.fromkeys(round_ops.LAUNCHES, valid):
        fail(f"{what} at nhidden {WIDE_HIDDEN}: round kernels launched {launched_w} in one "
             f"step, expected {valid} each")
    grads_w = [p.grad.detach().clone() for p in train_block.param_leaves(params_w)]
    params_wc = train_block.trainable(params_w0)
    t0 = time.perf_counter()
    loss_wc, aux_wc = packed.packed_window_forward(params_wc, stats_w0, cfg_w, pb_c, False,
                                                   fused_round=True)
    loss_wc.backward()
    cpu_wide_s = time.perf_counter() - t0
    worst_w, gscale_w = first_step_agrees(torch, train_block, loss_w, aux_w, grads_w, loss_wc,
                                          aux_wc, params_wc, f"{what} at nhidden {WIDE_HIDDEN}")
    print(f"{what} at nhidden {WIDE_HIDDEN} vs CPU: loss {float(loss_w)!r} / {float(loss_wc)!r}, "
          f"tp/fp/fn equal, worst grad diff {worst_w:.3g} (largest |grad| {gscale_w:.3g}); "
          f"launches {launched_w}; CPU step {cpu_wide_s:.2f} s")
    wide_first = {"hidden": WIDE_HIDDEN, "loss": float(loss_w), "cpu_loss": float(loss_wc),
                  "max_grad_err_vs_cpu": worst_w, "grad_scale": gscale_w,
                  "launches": launched_w, "cpu_step_s": cpu_wide_s}
    del params_w, opt_w, grads_w, params_wc

    # the TM_PACKED path: make_packed_train_step, unfused, on the same batch
    step_u = packed.make_packed_train_step(cfg, tp_classifier=False)
    params_u = train_block.trainable(to_device(params0, "cuda"))
    stats_u = to_device(stats0, "cuda")
    opt_u = optim.make_optimizer(train_block.param_leaves(params_u), TRAIN_LR, TRAIN_WD)

    def run_u():
        nonlocal params_u, stats_u
        params_u, stats_u, loss, _ = step_u(params_u, stats_u, opt_u, pb)
        return loss

    mp_inputs = {}
    with record_mp_widest(mp, mp_inputs):
        run_u()
    losses_u, events_u, wall_u, launches_u = timed_steps(torch, run_u, counters)
    check_launches("packed training (unfused)", launches_u,
                   {**dict.fromkeys(round_ops.LAUNCHES, 0),
                    **row_step_launches("diff", valid), "segment_incidence": 0})
    if not np.all(np.isfinite(losses_u)):
        fail(f"packed training (unfused) loss not finite: {losses_u}")
    print(f"packed training (unfused, make_packed_train_step): {events_u:.3f} ms/step (CUDA "
          f"events), {wall_u:.3f} ms/step (host wall), {edges / (wall_u / 1e3):.4g} edges/s; "
          f"launches a step { {k: v / TRAIN_STEPS for k, v in launches_u.items() if v} }")
    profile_u = device_profile(torch, run_u, wall_u / 1e3)
    mp_rows = mp_path_rows(torch, mp, mp_inputs, "row layout, packed unfused", build)
    summary = {
        "windows": pb.n_windows, "cap": cap, "t_cap": t_cap, "valid_steps": valid,
        "hidden": HIDDEN, "edges_per_step": edges, "incidence_entries": pb.inc_idx.numel(),
        "steps": TRAIN_STEPS, "ms_per_step_events": events_ms, "ms_per_step_wall": wall_ms,
        "edges_per_s": edges / (wall_ms / 1e3), "launches": launches,
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
        "loss_first": float(loss1), "loss_last": float(losses[-1]),
        "unfused_forward_loss": float(loss_u), "hidden_max_diff_vs_unfused": hidden_err,
        "cpu_loss_first": float(loss_c), "max_grad_err_vs_cpu": worst_grad, "grad_scale": gscale,
        "cpu_step_s": cpu_step_s, "wide_first_step": wide_first,
        "device_busy_share_step": None if profile is None else profile["busy_share"],
        "profile_step": profile,
        "unfused": {"mp_kernels": mp_rows,
                    "ms_per_step_events": events_u, "ms_per_step_wall": wall_u,
                    "edges_per_s": edges / (wall_u / 1e3), "launches": launches_u,
                    "loss_last": float(losses_u[-1]),
                    "device_busy_share_step": None if profile_u is None
                    else profile_u["busy_share"], "profile_step": profile_u},
    }
    return summary, inputs


def round_bounds(name, args, H):
    """(bytes, f32 operations) a round kernel needs on these inputs, live
    rows only: each input read once, each output written once.  A live row's
    GRU is two [H, 3H] products (4*H*3H operations) and the gate arithmetic
    (GATE_FLOPS_PER_UNIT a unit); its backward twice that: the two products
    that recompute the gates, the two transposed ones (d gi w_ih^T, d gh
    w_hh^T) and the gates' arithmetic and its derivative.  Each edge's two
    endpoint entries in the incidence add a row of H."""
    idxw = args[1] if name != "round_bwd_dh" else args[0]
    edge = int(((idxw[..., 2] != 0) & (idxw[..., 3] == 0)).sum())
    det = int((idxw[..., 3] != 0).sum())
    rows = edge + det
    row, w = 4 * H, 4 * (2 * H * 3 * H + 2 * 3 * H)  # a row of H floats; one GRU's tensors
    gru = 4 * H * 3 * H + GATE_FLOPS_PER_UNIT * H
    if name == "round_fwd":  # h, idxw, the live dets' incidence in; out, xin out
        return (rows * (row + 16) + det * 4 + 2 * edge * 4 + 2 * w + 2 * rows * row,
                rows * gru + edge * H + 2 * edge * H)
    if name == "round_bwd_gru":  # h, xin, g, idxw, weights in; d4, dxin, ddir out
        return rows * (3 * row + 16) + 2 * w + rows * (4 * row + 2 * row), rows * 2 * gru
    if name == "round_bwd_dw":  # h, xin, d4, idxw in; both GRUs' gradients out
        return rows * (6 * row + 16) + 2 * w, rows * (2 * 2 * H * 3 * H + 2 * 3 * H)
    # round_bwd_dh: idxw, dxin, ddir, incidence in; dh out
    return rows * (2 * row + 16) + det * 4 + 2 * edge * 4 + rows * row, 4 * edge * H


def round_kernel_phase(torch, round_ops, inputs, launches):
    """Phase 12: the four round kernels on phase 11's widest round against
    their plain versions, twice (bitwise), and timed."""
    flat = lambda out: [v for part in out for v in (part.values() if isinstance(part, dict)
                                                    else [part])]
    kernels = {
        "round_fwd": (round_ops._round_fwd_cuda,
                      lambda h, idxw, ip, ii, we, wn: round_ops.round_fwd_reference(h, idxw, we,
                                                                                    wn)),
        "round_bwd_gru": (round_ops._round_bwd_gru_cuda, round_ops.round_bwd_gru_reference),
        "round_bwd_dw": (round_ops._round_bwd_dw_cuda, round_ops.round_bwd_dw_reference),
        "round_bwd_dh": (round_ops._round_bwd_dh_cuda,
                         lambda idxw, ip, ii, dxin, ddir: (
                             round_ops.round_bwd_dh_reference(idxw, dxin, ddir),)),
    }
    rows = []
    for name, (kernel, plain) in kernels.items():
        args = inputs[name]
        as_list = lambda out: flat(out) if isinstance(out, (tuple, list)) else [out]
        got, again, want = as_list(kernel(*args)), as_list(kernel(*args)), as_list(plain(*args))
        torch.cuda.synchronize()
        err = 0.0
        for k, (a, w) in enumerate(zip(got, want)):
            err = max(err, float((a - w).abs().max()))
            if name == "round_fwd":
                ok = float((a - w).abs().max()) <= ROUND_FWD_ATOL
            else:
                ok = torch.allclose(a, w, rtol=ROUND_BWD_RTOL,
                                    atol=ROUND_BWD_ATOL_SCALE * max(float(w.abs().max()), 1e-30))
            if not ok:
                fail(f"{name} output {k} differs from its plain version by "
                     f"{float((a - w).abs().max()):.3g}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name} is not bitwise the same on a second launch")
        idxw = args[1] if name != "round_bwd_dh" else args[0]
        B, cap, _ = idxw.shape
        H = HIDDEN
        if name == "round_fwd":
            dead = (idxw[..., 2] == 0) & (idxw[..., 3] == 0)
            if not (torch.all(got[0][dead] == 0) and torch.all(got[1][dead] == 0)):
                fail("round_fwd wrote a nonzero out or xin at a dead row")
        cost = round_bounds(name, args, H)
        b, by = bound_ms(*cost)
        r = {"name": name, "route": "cuda",
             "source": "trackmpnn_tpu_torch/csrc/round_kernels.cu",
             "replaces": ROUND_REPLACES[name], "launches": launches[name], "max_abs_err": err,
             "ms": cuda_time_ms(lambda: kernel(*args)),
             "call_ms": cuda_time_ms(lambda: kernel(*args), queue_ahead=False),
             "plain_ms": cuda_time_ms(lambda: plain(*args), iters=PLAIN_ITERS),
             "bound_ms": b, "bound_by": by, "bound_tf32_ms": bound_tf32_ms(*cost),
             "library_ms": None, "shape": f"B {B}, cap {cap}, H {H}, live rows {live_rows(idxw)}"}
        print_kernel_row(r)
        rows.append(r)
    return rows


def wide_round_kernel_rows(torch, round_ops, B, cap):
    """Phase 12 at the widths the first design refused (H WIDE_HIDDEN and
    NARROW_ROUND_HIDDEN), on seeded rounds of phase 11's widest shape: each
    kernel against its plain version evaluated in f64, twice (bitwise), and
    timed; outside the kernels line."""
    import numpy as np
    from torch_port_util import round_inputs

    rows = []
    for H in (WIDE_HIDDEN, NARROW_ROUND_HIDDEN):
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
        h, idxw, we, wn, g = round_inputs(H, B, cap, H)
        ip, ii = (put(a) for a in round_ops.round_incidence(idxw))
        h, idxw, g = put(h), put(idxw), put(g)
        we, wn = ({k: put(v) for k, v in w.items()} for w in (we, wn))
        w64 = lambda w: {k: v.double() for k, v in w.items()}
        xin = round_ops.round_fwd_reference(h, idxw, we, wn)[1]
        d4, dxin, ddir = round_ops.round_bwd_gru_reference(h, idxw, xin, g, we, wn)
        flat = lambda out: [v for part in out for v in (part.values() if isinstance(part, dict)
                                                        else [part])]
        cases = {
            "round_fwd": (lambda: round_ops._round_fwd_cuda(h, idxw, ip, ii, we, wn),
                          lambda: round_ops.round_fwd_reference(h, idxw, we, wn),
                          lambda: round_ops.round_fwd_reference(h.double(), idxw, w64(we),
                                                                w64(wn)), [h, idxw, ip, ii]),
            "round_bwd_gru": (lambda: round_ops._round_bwd_gru_cuda(h, idxw, xin, g, we, wn),
                              lambda: round_ops.round_bwd_gru_reference(h, idxw, xin, g, we, wn),
                              lambda: round_ops.round_bwd_gru_reference(
                                  h.double(), idxw, xin.double(), g.double(), w64(we), w64(wn)),
                              [h, idxw]),
            "round_bwd_dw": (lambda: flat(round_ops._round_bwd_dw_cuda(h, idxw, xin, d4)),
                             lambda: flat(round_ops.round_bwd_dw_reference(h, idxw, xin, d4)),
                             lambda: flat(round_ops.round_bwd_dw_reference(
                                 h.double(), idxw, xin.double(), d4.double())), [h, idxw]),
            "round_bwd_dh": (lambda: [round_ops._round_bwd_dh_cuda(idxw, ip, ii, dxin, ddir)],
                             lambda: round_ops.round_bwd_dh_reference(idxw, dxin, ddir),
                             lambda: [round_ops.round_bwd_dh_reference(idxw, dxin.double(),
                                                                       ddir.double())],
                             [idxw]),
        }
        for name, (kernel, plain, exact, cost_args) in cases.items():
            as_list = lambda out: list(out) if isinstance(out, (tuple, list)) else [out]
            got, again = as_list(kernel()), as_list(kernel())
            want = [w.float() for w in as_list(exact())]
            torch.cuda.synchronize()
            err = 0.0
            for k, (a, w) in enumerate(zip(got, want)):
                diff = float((a - w).abs().max())
                err = max(err, diff)
                ok = (diff <= ROUND_FWD_ATOL if name == "round_fwd" else
                      torch.allclose(a, w, rtol=ROUND_BWD_RTOL,
                                     atol=ROUND_BWD_ATOL_SCALE * max(float(w.abs().max()), 1e-30)))
                if not ok:
                    fail(f"{name} at H {H} output {k} differs from its plain version (f64) by "
                         f"{diff:.3g}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{name} at H {H} is not bitwise the same on a second launch")
            cost = round_bounds(name, [None, idxw] if name != "round_bwd_dh" else [idxw], H)
            b, by = bound_ms(*cost)
            r = {"name": name, "route": "cuda",
                 "source": "trackmpnn_tpu_torch/csrc/round_kernels.cu",
                 "replaces": ROUND_REPLACES[name], "launches": None, "max_abs_err": err,
                 "ms": cuda_time_ms(kernel), "call_ms": cuda_time_ms(kernel, queue_ahead=False),
                 "plain_ms": cuda_time_ms(plain, iters=PLAIN_ITERS // 3),
                 "bound_ms": b, "bound_by": by, "bound_tf32_ms": bound_tf32_ms(*cost),
                 "library_ms": None,
                 "shape": f"B {B}, cap {cap}, H {H}, live rows {live_rows(idxw)} (seeded)"}
            print_kernel_row(r, " (vs the plain version in f64)")
            rows.append(r)
        del h, idxw, g, we, wn, xin, d4, dxin, ddir
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------ the embedding path ----
EMBED_HW = (384, 1280)      # KITTI's embedding input (trackmpnn_tpu/cli/train.py:38)
EMBED_HW_CHECK = (96, 320)  # the card-vs-CPU first step, reduced
# the training CLI's chunk: cur_win_size 5 (utils/config.py:40) plus the
# skip pair (data/common.py:136-139), cycled to a multiple of 4 by _pack
EMBED_T, EMBED_DETS = 8, (8, 16)
EMBED_INFER_REPEATS = 4  # infer's sequence: the chunk's frames four times
EMBED_WARMUP, EMBED_STEPS = 2, 10
EMBED_MAX_OFFSET = 2.0
EMBED_CONFIGS = {"espv2": dict(arch="espv2"),
                 "dla34_bounded": dict(arch="dla34", dcn_max_offset=EMBED_MAX_OFFSET),
                 "dla34_exact": dict(arch="dla34")}
DCN_BLOCKS = 16  # deform blocks of DLA-34: 12 in DLAUp, 4 in the final IDAUp
FEAT_RTOL, FEAT_ATOL_SCALE = 1e-4, 1e-4
DCN_REPLACES = {"dcn_fwd": "trackmpnn_tpu/ops/pallas_dcn.py:45",
                "dcn_bwd_sample": "trackmpnn_tpu/backbones/deform_conv.py:208",
                "dcn_bwd_dx": "trackmpnn_tpu/backbones/deform_conv.py:208"}


def embed_chunk(np, hw, down_ratio, seed, max_dets=256):
    """A chunk packed as EmbedTrainer._pack packs one: EMBED_T frames of
    seeded normalised-image noise [T, H, W, 3], 8-16 detections a frame at
    seeded feature-map centres, about one in six a false positive (track id
    -1), padded to the trainer's max_dets.  (images, fr_of, cy, cx,
    track_ids, valid)."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(EMBED_T, *hw, 3)).astype(np.float32)
    counts = rng.integers(EMBED_DETS[0], EMBED_DETS[1] + 1, EMBED_T)
    n = int(counts.sum())
    pad = lambda a: np.concatenate([a, np.zeros(max_dets - n, a.dtype)])
    fr_of = np.repeat(np.arange(EMBED_T), counts).astype(np.int32)
    cy = rng.integers(0, hw[0] // down_ratio, n).astype(np.int32)
    cx = rng.integers(0, hw[1] // down_ratio, n).astype(np.int32)
    tids = rng.integers(0, 40, n).astype(np.int32)
    tids[rng.random(n) < 1 / 6] = -1
    return (images, pad(fr_of), pad(cy), pad(cx),
            np.concatenate([tids, -np.ones(max_dets - n, np.int32)]), np.arange(max_dets) < n)


def infer_sequence(torch, tr, chunk, what, dcn_ops, blocks):
    """EmbedTrainer.infer on a sequence of EMBED_INFER_REPEATS copies of the
    chunk's frames, detections in every copy: each copy's features must
    equal the chunk's own infer (rtol FEAT_RTOL), and the bounded route
    launch dcn_fwd `blocks` times a backbone call of INFER_FRAMES frames."""
    from trackmpnn_tpu_torch.train.embed import INFER_FRAMES

    images, fr_of, cy, cx = chunk[:4]
    want = tr.infer(images, fr_of, cy, cx)
    reps = EMBED_INFER_REPEATS
    seq = (images.repeat(reps, 1, 1, 1),
           torch.cat([fr_of + EMBED_T * r for r in range(reps)]), cy.repeat(reps), cx.repeat(reps))
    frames = EMBED_T * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in dcn_ops.LAUNCHES:
        dcn_ops.LAUNCHES[k] = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    got = tr.infer(*seq)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    calls = -(-frames // INFER_FRAMES)
    if dcn_ops.LAUNCHES["dcn_fwd"] != blocks * calls or dcn_ops.LAUNCHES["dcn_bwd_dx"]:
        fail(f"{what} infer: DCN launches {dict(dcn_ops.LAUNCHES)} over {frames} frames, "
             f"expected {blocks} dcn_fwd a backbone call of {INFER_FRAMES} frames")
    got = got.reshape(reps, *want.shape)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not (bool(torch.isfinite(got).all()) and torch.allclose(
            got, want.expand_as(got), rtol=FEAT_RTOL, atol=FEAT_ATOL_SCALE * scale)):
        fail(f"{what} infer: the {frames}-frame sequence's features differ from the "
             f"chunk's by {err:.3g} (largest {scale:.3g})")
    return {"frames": frames, "ms_events": ms, "frames_per_s": frames / (ms / 1e3),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "dcn_fwd_launches": dcn_ops.LAUNCHES["dcn_fwd"], "max_err": err}


def offset_stats(off, bound):
    """(share beyond the bound, share at an integer) of DCN offsets."""
    return float((off.abs() > bound).double().mean()), float((off == off.round()).double().mean())


def embedding_phase(torch, np, dcn_ops):
    """Phase 15: EmbedTrainer's step and infer on the card for the three
    configurations, then each first step at EMBED_HW_CHECK on the card and
    on the CPU.  Returns (summaries, the DCN kernels' widest inputs)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_util import calibrate_dcn_offsets
    from trackmpnn_tpu_torch.tools.ab_dcn import dcn_ranges
    from trackmpnn_tpu_torch.train.embed import RECIPES, EmbedTrainer

    summaries, inputs = {}, {}
    for name, cfg in EMBED_CONFIGS.items():
        what = f"embedding ({name})"
        down = RECIPES[cfg["arch"]][0]
        small = embed_chunk(np, EMBED_HW_CHECK, down, seed=1)
        cpu = EmbedTrainer(input_hw=EMBED_HW_CHECK, device="cpu", **cfg)
        if cfg["arch"] == "dla34":
            # fractional offsets, about half beyond the bound, clear of the
            # bilinear derivative's kinks (integers and the bound)
            calibrate_dcn_offsets(cpu.net, torch.from_numpy(small[0]).permute(0, 3, 1, 2), 0)
        state = copy.deepcopy(cpu.net.state_dict())

        # the step at KITTI's input on the card; the first one records the
        # DCN kernels' widest inputs
        tr = EmbedTrainer(input_hw=EMBED_HW, device="cuda", **cfg)
        tr.net.load_state_dict(state)
        chunk = embed_chunk(np, EMBED_HW, down, seed=0)
        n = int(chunk[5].sum())
        chunk = [torch.from_numpy(a).cuda() for a in chunk]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as rec:
            if cfg.get("dcn_max_offset") is not None:
                # widest: the most input elements (8 x 96 x 320 x 64 at KITTI's size)
                rec.enter_context(record_widest(dcn_ops, "_fwd_cuda", inputs, lambda a: "dcn_fwd",
                                                blocks=lambda a: a[0].numel()))
                rec.enter_context(record_widest(dcn_ops, "_sample_cuda", inputs,
                                                lambda a: "dcn_bwd_sample",
                                                blocks=lambda a: a[3].numel()))
                rec.enter_context(record_widest(dcn_ops, "_dx_cuda", inputs,
                                                lambda a: "dcn_bwd_dx",
                                                blocks=lambda a: a[2].numel()))
            flags = lambda: (torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32)
            before, seen = flags(), []
            rec.callback(tr.net.register_forward_hook(
                lambda mod, a, out: seen.append(flags())).remove)
            loss1, feats1 = tr.step(*chunk)
        torch.cuda.synchronize()
        if seen != [(False, False)] or flags() != before:
            fail(f"{what}: the step ran with TF32 flags {seen} (cuDNN, matmul), "
                 f"then left {flags()} where the caller had {before}")
        if not (torch.isfinite(loss1) and bool(torch.isfinite(feats1).all())
                and tuple(feats1.shape) == (256, tr.num_vis_feats)):
            fail(f"{what}: first step gave loss {float(loss1)}, features {tuple(feats1.shape)}")
        for _ in range(EMBED_WARMUP):
            tr.step(*chunk)
        torch.cuda.synchronize()
        for k in dcn_ops.LAUNCHES:
            dcn_ops.LAUNCHES[k] = 0
        losses = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(EMBED_STEPS):
            losses.append(tr.step(*chunk)[0])
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / EMBED_STEPS
        events_ms = start.elapsed_time(end) / EMBED_STEPS
        launches = dict(dcn_ops.LAUNCHES)
        per_step = DCN_BLOCKS if cfg.get("dcn_max_offset") is not None else 0
        for k, v in launches.items():
            if v != per_step * EMBED_STEPS:
                fail(f"{what}: {k} launched {v} times in {EMBED_STEPS} steps, expected "
                     f"{per_step} a step ({DCN_BLOCKS} deform blocks)")
        peak_bytes = torch.cuda.max_memory_allocated()
        losses = torch.stack(losses).cpu().numpy()
        if not np.all(np.isfinite(losses)):
            fail(f"{what}: loss not finite: {losses}")
        # the bounded route's DCN share: device spans inside DeformConvShift's
        # forward and backward (the kernels and the dcols product), and the
        # dcn_* kernels alone
        with dcn_ranges(dcn_ops) if per_step else contextlib.nullcontext():
            profile = device_profile(torch, lambda: tr.step(*chunk), wall_ms / 1e3,
                                     ranges=("dcn_forward", "dcn_backward") if per_step else (),
                                     match="dcn_" if per_step else None)
        dcn_ms = None
        if per_step and profile is not None:
            dcn_ms = {"ranges_ms": profile["ranges_ms"],
                      "total_ms": sum(profile["ranges_ms"].values()),
                      "dcn_kernels_ms": profile["matched_ms"]}
            print(f"{what}: DCN device ms in the profiled step {dcn_ms['total_ms']:.3f} "
                  f"(forward {profile['ranges_ms']['dcn_forward']:.3f}, backward "
                  f"{profile['ranges_ms']['dcn_backward']:.3f}; the dcn_* kernels "
                  f"{dcn_ms['dcn_kernels_ms']:.3f}) over the {DCN_BLOCKS} deform blocks")
        infer = infer_sequence(torch, tr, chunk, what, dcn_ops, per_step)
        print(f"{what}: {EMBED_T} x {EMBED_HW[0]} x {EMBED_HW[1]} frames, {n} detections, "
              f"{EMBED_STEPS} steps, {events_ms:.3f} ms/step (CUDA events), {wall_ms:.3f} "
              f"ms/step (host wall), {EMBED_T / (wall_ms / 1e3):.4g} frames/s, peak memory "
              f"{peak_bytes / 2**30:.3f} GiB; DCN launches a step "
              f"{ {k: v / EMBED_STEPS for k, v in launches.items()} }; loss "
              f"{float(loss1):.6g} -> {losses[-1]:.6g}; the step saw TF32 off (process "
              f"flags {before})")
        print(f"{what} infer: {infer['frames']} frames in {infer['ms_events']:.3f} ms (CUDA "
              f"events), {infer['frames_per_s']:.4g} frames/s, peak memory "
              f"{infer['peak_memory_bytes'] / 2**30:.3f} GiB, dcn_fwd launches "
              f"{infer['dcn_fwd_launches']}, slices agree to {infer['max_err']:.3g}")
        del tr, chunk

        # the first step at EMBED_HW_CHECK on the card and on the CPU, same weights
        card = EmbedTrainer(input_hw=EMBED_HW_CHECK, device="cuda", **cfg)
        card.net.load_state_dict(state)
        loss_g, feats_g = card.step(*small)
        t0 = time.perf_counter()
        loss_c, feats_c = cpu.step(*small)
        cpu_step_s = time.perf_counter() - t0
        if not abs(float(loss_g) - float(loss_c)) <= LOSS_RTOL * abs(float(loss_c)):
            fail(f"{what} first step loss: card {float(loss_g)!r}, CPU {float(loss_c)!r}")
        feats_g = feats_g.cpu()
        feat_scale = float(feats_c.abs().max())
        if not torch.allclose(feats_g, feats_c, rtol=FEAT_RTOL, atol=FEAT_ATOL_SCALE * feat_scale):
            fail(f"{what} first step features differ between card and CPU by "
                 f"{float((feats_g - feats_c).abs().max()):.3g}")
        grads_g = [q.grad.cpu() for q in card.net.parameters()]
        grads_c = [q.grad for q in cpu.net.parameters()]
        gscale = tree_max_abs(grads_c)
        worst = 0.0
        for (pname, _), a, b in zip(cpu.net.named_parameters(), grads_g, grads_c):
            worst = max(worst, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * gscale):
                fail(f"{what} first step grad of {pname} differs between card and CPU by "
                     f"{float((a - b).abs().max()):.3g} (rtol {GRAD_RTOL}, atol "
                     f"{GRAD_ATOL_SCALE * gscale:.3g})")
        for net in (card.net, cpu.net):
            for bname, buf in net.named_buffers():
                if ".running_" in bname and not torch.equal(buf.cpu(), state[bname]):
                    fail(f"{what}: frozen BN changed its buffer {bname}")
        print(f"{what} at {EMBED_HW_CHECK[0]} x {EMBED_HW_CHECK[1]} (reduced), card vs CPU: "
              f"loss {float(loss_g)!r} / {float(loss_c)!r}, worst feature diff "
              f"{float((feats_g - feats_c).abs().max()):.3g} (largest {feat_scale:.3g}), worst "
              f"grad diff {worst:.3g} (largest |grad| {gscale:.3g}), BN buffers unchanged; "
              f"CPU step {cpu_step_s:.2f} s")
        summaries[name] = {
            "input_hw": list(EMBED_HW), "frames": EMBED_T, "detections": n,
            "steps": EMBED_STEPS, "ms_per_step_events": events_ms, "ms_per_step_wall": wall_ms,
            "frames_per_s": EMBED_T / (wall_ms / 1e3), "peak_memory_bytes": peak_bytes,
            "launches": launches, "loss_first": float(loss1), "loss_last": float(losses[-1]),
            "check_input_hw": list(EMBED_HW_CHECK), "check_loss_card": float(loss_g),
            "check_loss_cpu": float(loss_c), "max_grad_err_vs_cpu": worst, "grad_scale": gscale,
            "cpu_step_s": cpu_step_s, "tf32_flags_before": list(before), "infer": infer,
            "device_busy_share_step": None if profile is None else profile["busy_share"],
            "profile_step": profile, "dcn_device_ms_step": dcn_ms}
        del card, cpu
        torch.cuda.empty_cache()
    off = inputs["dcn_fwd"][3]
    beyond, integer = offset_stats(off, EMBED_MAX_OFFSET)
    if not (beyond > 0 and integer == 0):
        fail(f"the widest deform block's offsets: {beyond:.3f} beyond the bound, {integer:.3f} "
             "at an integer; the kernels' checks need fractional offsets, some beyond it")
    return summaries, inputs


def dcn_bounds(torch, name, args):
    """(bytes, product operations, other f32 operations) a DCN kernel needs
    on these inputs: each input read once and each output written once; the
    products (2 x 9 x C x O a pixel: dcn_fwd's contraction, dcn_bwd_sample's
    d weight = columns^T g), which both kernels run on the tensor cores as
    3xTF32; the sampling on the CUDA cores: dcn_fwd 8 x 9 x C a pixel (four
    neighbours' multiply-adds), dcn_bwd_sample 17 x 9 x C (the sample, the
    mask and four dot products), dcn_bwd_dx one multiply-add a channel for
    each non-zero (pixel, tap, neighbour) weight that lands in the image."""
    f = lambda *ts: 4 * sum(t.numel() for t in ts if t is not None)
    if name == "dcn_fwd":
        x, w, b, off, m, _ = args
        P, C, O = x.numel() // x.shape[3], x.shape[3], w.shape[1]
        return f(x, w, b, off, m) + 4 * P * O, P * 2 * 9 * C * O, P * 8 * 9 * C
    if name == "dcn_bwd_sample":
        x, off, m, dcols, g, _ = args
        P, C, O = x.numel() // x.shape[3], x.shape[3], g.shape[3]
        return (f(x, off, m, dcols, g) + f(off, m) + 4 * 9 * C * O, P * 2 * 9 * C * O,
                P * 17 * 9 * C)
    off, m, dcols, bound = args
    N, H, W, C9 = dcols.shape
    d = off.reshape(N, H, W, 9, 2).clamp(-bound, bound)
    base = torch.floor(d)
    frac = d - base
    k = torch.arange(9, device=off.device)
    ys = torch.arange(H, device=off.device)[None, :, None, None] - 1 + (k // 3) + base[..., 0]
    xs = torch.arange(W, device=off.device)[None, None, :, None] - 1 + (k % 3) + base[..., 1]
    hits = 0
    for a in (0, 1):
        for b in (0, 1):
            wy = 1 - frac[..., 0] if a == 0 else frac[..., 0]
            wx = 1 - frac[..., 1] if b == 0 else frac[..., 1]
            inside = ((ys + a >= 0) & (ys + a < H) & (xs + b >= 0) & (xs + b < W)
                      & (wy * wx * m != 0))
            hits += int(inside.sum())
    return f(off, m, dcols) + 4 * N * H * W * (C9 // 9), 0, 2 * (C9 // 9) * hits


def dcn_kernel_phase(torch, dcn_ops, inputs, launches):
    """Phase 16: the three DCN kernels on phase 15's widest deform block and
    on seeded inputs of the same shape with mixed fractional, integer and
    beyond-bound offsets, against their plain versions evaluated in f64,
    twice (bitwise), and timed on the recorded inputs."""
    from torch_port_util import DCN_KEYS, dcn_inputs, in_f64

    x, w, b, off, m, bound = inputs["dcn_fwd"]
    N, H, W, C = x.shape
    seeded = dict(zip(DCN_KEYS, (torch.from_numpy(a).cuda() for a in dcn_inputs(
        0, N=N, H=H, W=W, C=C, O=w.shape[1], kind="mixed", max_offset=bound).values())))
    dcols = (seeded["g"].reshape(-1, w.shape[1]) @ seeded["weight"].t()).reshape(N, H, W, 9 * C)
    cases = {
        "dcn_fwd": (dcn_ops._fwd_cuda, dcn_ops.dcn_forward_reference,
                    [seeded[k] for k in DCN_KEYS[:5]] + [bound]),
        "dcn_bwd_sample": (dcn_ops._sample_cuda, dcn_ops.dcn_sample_backward_reference,
                           [seeded["x"], seeded["offset"], seeded["mask"], dcols, seeded["g"],
                            bound]),
        "dcn_bwd_dx": (dcn_ops._dx_cuda, dcn_ops.dcn_dx_reference,
                       [seeded["offset"], seeded["mask"], dcols, bound]),
    }
    as_list = lambda out: list(out) if isinstance(out, (tuple, list)) else [out]
    beyond, integer = offset_stats(seeded["offset"], bound)
    print(f"DCN kernel inputs: the widest deform block of the bounded DLA-34 step (N {N}, "
          f"{H} x {W}, C {C}, O {w.shape[1]}, max_offset {bound}), offsets "
          f"{offset_stats(off, bound)[0]:.3f} beyond the bound; seeded: {beyond:.3f} "
          f"beyond, {integer:.3f} at an integer")
    rows = []
    for name, (kernel, plain, seeded_args) in cases.items():
        err = 0.0
        for which, args in (("recorded", inputs[name]), ("seeded", seeded_args)):
            got, again = (as_list(kernel(*args)) for _ in range(2))
            want = in_f64(plain, *args)
            torch.cuda.synchronize()
            for k, (a, v) in enumerate(zip(got, want)):
                diff = float((a - v).abs().max())
                scale = max(float(v.abs().max()), 1e-30)
                err = max(err, diff)
                ok = (diff <= ROUND_FWD_ATOL * scale if name == "dcn_fwd" else
                      torch.allclose(a, v, rtol=ROUND_BWD_RTOL, atol=ROUND_BWD_ATOL_SCALE * scale))
                if not ok:
                    fail(f"{name} ({which} inputs) output {k} differs from its plain version "
                         f"(f64) by {diff:.3g} (scale {scale:.3g})")
            if not all(torch.equal(a, v) for a, v in zip(got, again)):
                fail(f"{name} ({which} inputs) is not bitwise the same on a second launch")
            del got, again, want
        args = inputs[name]
        nbytes, product, other = dcn_bounds(torch, name, args)
        bnd, by = bound_ms(nbytes, product + other)
        bnd_tf32 = max(nbytes / PEAK_BYTES_PER_S, 3 * product / PEAK_TF32_PER_S,
                       other / PEAK_F32_PER_S) * 1e3
        r = {"name": name, "route": "cuda", "source": "trackmpnn_tpu_torch/csrc/dcn_kernels.cu",
             "replaces": DCN_REPLACES[name], "launches": launches[name], "max_abs_err": err,
             "ms": cuda_time_ms(lambda: kernel(*args), iters=32, warmup=5),
             "call_ms": cuda_time_ms(lambda: kernel(*args), iters=32, warmup=5,
                                     queue_ahead=False),
             # the plain versions launch 60-1,300 ops a call: timed a few calls at a
             # time without the queued sleep (each op moves ~30 MB, so the device,
             # not the host, sets their pace)
             "plain_ms": cuda_time_ms(lambda: plain(*args), iters=3, warmup=1,
                                      queue_ahead=False),
             "bound_ms": bnd, "bound_by": by, "bound_tf32_ms": bnd_tf32, "library_ms": None,
             "shape": f"N {N}, H {H}, W {W}, C {C}, O {w.shape[1]}"}
        print(f"kernel {name} ({r['shape']}): device {r['ms'] * 1e3:.2f} us, per call "
              f"{r['call_ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, at the TF32 rate "
              f"{bnd_tf32 * 1e3:.2f} us, library none), max abs err {err:.3g}")
        rows.append(r)
    return rows


def dcn_dx_reach_row(torch, dcn_ops, shape):
    """dcn_bwd_dx at the widest reach the kernels take (max_offset MAX_REACH)
    on seeded mixed offsets of phase 16's widest block: against its plain
    version in f64, twice (bitwise), and timed; outside the kernels line."""
    from torch_port_util import DCN_KEYS, dcn_inputs, in_f64

    N, H, W, C, O = shape
    bound = float(dcn_ops.MAX_REACH)
    x = dict(zip(DCN_KEYS, (torch.from_numpy(a).cuda() for a in dcn_inputs(
        1, N=N, H=H, W=W, C=C, O=O, kind="mixed", max_offset=bound).values())))
    dcols = (x["g"].reshape(-1, O) @ x["weight"].t()).reshape(N, H, W, 9 * C)
    args = [x["offset"], x["mask"], dcols, bound]
    got, again = dcn_ops._dx_cuda(*args), dcn_ops._dx_cuda(*args)
    want = in_f64(dcn_ops.dcn_dx_reference, *args)[0]
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), max(float(want.abs().max()), 1e-30)
    if not torch.allclose(got, want, rtol=ROUND_BWD_RTOL, atol=ROUND_BWD_ATOL_SCALE * scale):
        fail(f"dcn_bwd_dx at reach {int(bound)} differs from its plain version (f64) by {err:.3g}")
    if not torch.equal(got, again):
        fail(f"dcn_bwd_dx at reach {int(bound)} is not bitwise the same on a second launch")
    nbytes, _, other = dcn_bounds(torch, "dcn_bwd_dx", args)
    bnd, by = bound_ms(nbytes, other)
    r = {"name": "dcn_bwd_dx", "route": "cuda",
         "source": "trackmpnn_tpu_torch/csrc/dcn_kernels.cu",
         "replaces": DCN_REPLACES["dcn_bwd_dx"], "launches": None, "max_abs_err": err,
         "ms": cuda_time_ms(lambda: dcn_ops._dx_cuda(*args), iters=32, warmup=5),
         "call_ms": cuda_time_ms(lambda: dcn_ops._dx_cuda(*args), iters=32, warmup=5,
                                 queue_ahead=False),
         "plain_ms": cuda_time_ms(lambda: dcn_ops.dcn_dx_reference(*args), iters=3, warmup=1,
                                  queue_ahead=False),
         "bound_ms": bnd, "bound_by": by, "library_ms": None,
         "shape": f"N {N}, H {H}, W {W}, C {C}, max_offset {bound} (seeded mixed)"}
    print_kernel_row(r, " (vs the plain version in f64)")
    return r


# ----------------------------------------- the default configuration, served ----
FULL_IM_HW = (375, 1242)    # a KITTI frame's (h, w): the boxes' pixel space


def full_serving_phase(torch, np, mp):
    """Phase 17: the default configuration served at full width: features
    2d+temp+vis, nhidden 64, 128 vis features from ESPNetv2 at 384 x 1280
    (random weights from fixed seeds, BN on its running statistics), on
    phase 3's three sequences (model, sequences and both runs returned for
    phase 22).  Per sequence, EmbedTrainer.infer runs on its
    100 seeded noise frames (made on the card) at the detections' centres
    (data/common.center_indices from the boxes in a 375 x 1242 frame),
    timed by CUDA events; normalized_vis_features gives the vis columns,
    data/common.assemble_features the 2d and temp ones (the rrc detector's
    constants).  Then serve_and_check: three launches each of
    fused_edge_gru and signed_segment_sum a forward, none of gather_diff,
    the CPU rerun of the same feature matrices within phase 3's limits."""
    from trackmpnn_tpu_torch.data import common
    from trackmpnn_tpu_torch.data.kitti import NORM_2D
    from trackmpnn_tpu_torch.data.synthetic import make_sequence
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train.embed import EmbedTrainer, normalized_vis_features

    cfg = mpnn.ModelConfig(features=DEFAULT_FEATS, ncategories=3, nhidden=HIDDEN)
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    stats = mpnn.init_batch_stats(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    embed = EmbedTrainer(arch="espv2", input_hw=EMBED_HW, seed=5, device="cuda")
    no_vis = DEFAULT_FEATS.replace("vis", "")  # the trainer standardises the vis block
    mean, std = common.feature_norm_table(no_vis, 3, *NORM_2D["rrc"])
    gen = torch.Generator(device="cuda").manual_seed(17)
    warm = torch.randn(EMBED_T, *EMBED_HW, 3, device="cuda", generator=gen)
    embed.infer(warm, np.arange(EMBED_T), np.zeros(EMBED_T), np.zeros(EMBED_T))  # cuDNN set-up
    del warm
    seqs, embeds = [], []
    for s in SERVE_SEEDS:
        _, bp, _ = make_sequence(num_tracks=SERVE_TRACKS, num_frames=SERVE_FRAMES,
                                 ncategories=3, seed=s)
        frames = torch.randn(SERVE_FRAMES, *EMBED_HW, 3, device="cuda", generator=gen)
        cy, cx = common.center_indices(bp[:, 4:8], FULL_IM_HW, EMBED_HW, embed.down_ratio)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        raw = embed.infer(frames, bp[:, 0].astype(np.int64), cy, cx)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        raw = raw.cpu().numpy()
        if raw.shape != (len(bp), embed.num_vis_feats) or not np.all(np.isfinite(raw)):
            fail(f"full-width serving: embeddings of shape {raw.shape}, finite "
                 f"{bool(np.all(np.isfinite(raw)))}; expected ({len(bp)}, "
                 f"{embed.num_vis_feats}) finite")
        X = np.concatenate([common.assemble_features(bp, no_vis, 3, mean, std),
                            normalized_vis_features(raw)], 1)
        if X.shape[1] != cfg.nfeatures:
            fail(f"full-width serving: {X.shape[1]} feature columns, the model takes "
                 f"{cfg.nfeatures}")
        seqs.append((X, bp[:, :2].astype(np.int64)))
        embeds.append({"frames": SERVE_FRAMES, "detections": len(bp), "ms_events": ms,
                       "frames_per_s": SERVE_FRAMES / (ms / 1e3)})
        print(f"full-width serving, sequence {s}: embeddings of {len(bp)} detections over "
              f"{SERVE_FRAMES} frames of {EMBED_HW[0]} x {EMBED_HW[1]} in {ms:.3f} ms "
              f"({SERVE_FRAMES / (ms / 1e3):.2f} frames/s)")
        del frames
    runs = {}
    summary = serve_and_check(torch, np, mp, cfg, params, stats, seqs,
                              (seqs[0][0][:200], seqs[0][1][:200]), "full-width serving",
                              keep=runs)
    summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    summary["embedding"] = embeds
    embed_s = sum(e["ms_events"] for e in embeds) / 1e3
    summary["frames_per_s_with_embedding"] = summary["frames"] / (summary["wall_s"] + embed_s)
    print(f"full-width serving: peak memory {summary['peak_memory_bytes'] / 2**30:.3f} GiB, "
          f"frames/s with the embedding {summary['frames_per_s_with_embedding']:.4g}")
    return summary, (cfg, params, stats, seqs, runs)


# ---------------------------------------- the default features, trained ----
GAT1_REPLACES = {"gat1_scores_fwd": "trackmpnn_tpu/ops/pallas_gat.py:167",
                 "gat1_scores_bwd": "trackmpnn_tpu/ops/pallas_gat.py:187",
                 "gat1_aggregate_fwd": "trackmpnn_tpu/ops/pallas_gat.py:306",
                 "gat1_aggregate_bwd": "trackmpnn_tpu/ops/pallas_gat.py:317"}


def default_training_phase(torch, np, block_ops, gat_ops, loss_ops, workload):
    """Phase 18: the block train step with the default features
    (2d+temp+vis, three branches) on phase 5's windows: the default
    composition timed (launches T x 3 of each block kernel a step), then
    es_kernel and fused_loss a first step each, each against its CPU rerun
    and against the default composition's first step on the card.  Returns
    (summaries, the fused_loss step's edge-loss inputs at K = 3H)."""
    runs, firsts, wide = {}, {}, {}
    for key, flags in (("default", {}), ("es_kernel", dict(es_kernel=True)),
                       ("fused_loss", dict(fused_loss=True))):
        summary, inputs, first = training_phase(torch, np, block_ops, gat_ops, loss_ops, heads=0,
                                                features=DEFAULT_FEATS, workload=workload,
                                                timed=key == "default", **flags)
        if key != "default":
            worst, scale = steps_agree(torch, first, firsts["default"],
                                       f"training ({DEFAULT_FEATS}, {key})",
                                       names=(key, "the default composition"))
            summary["max_grad_err_vs_default"] = worst
            print(f"training ({DEFAULT_FEATS}, {key}) vs the default composition on the card: "
                  f"loss {float(first[0])!r} / {float(firsts['default'][0])!r}, tp/fp/fn equal, "
                  f"worst grad diff {worst:.3g} (largest |grad| {scale:.3g})")
        if key == "fused_loss":
            wide = {k: v for k, v in inputs.items() if k.startswith("edge_loss")}
            if wide["edge_loss_l1"][0].shape[-1] != 3 * HIDDEN:
                fail(f"default-feature fused_loss: the edge losses saw K = "
                     f"{wide['edge_loss_l1'][0].shape[-1]}, expected {3 * HIDDEN}")
        runs[key], firsts[key] = summary, first
    return runs, wide, firsts["default"]


def default_heads_phase(torch, np, block_ops, gat_ops, loss_ops, workload):
    """Phase 19: phase 18's step with GAT_HEADS_WIDE heads a branch and real
    dropout, on the stacked route and on the per-head route (gat_fused=False,
    the single-head kernels #9 and #10), both first steps on the same keep
    masks drawn on the card.  Each route timed (T x 3 launches of each
    stacked attention kernel and none of the single-head ones a step, or T x
    3 x 3 of each single-head kernel and no stacked one), each first step
    against its CPU rerun, and the two routes' first steps against each
    other.  Returns (summaries, the per-head route's widest single-head
    kernel inputs, the stacked route's first step and its keep masks)."""
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import block as train_block

    schedules, t_cap, _ = workload
    bb = train_block.build_block_batch(schedules, t_cap, device="cuda")
    nb = len(mpnn.ModelConfig(features=DEFAULT_FEATS).branches)
    gen = torch.Generator(device="cuda").manual_seed(19)
    keep1 = draw_keep_masks(train_block, gen, GAT_HEADS_WIDE, nb, bb)
    runs, firsts, inputs = {}, {}, {}
    for key, gat_fused in (("stacked", True), ("per_head", False)):
        summary, rec, first = training_phase(torch, np, block_ops, gat_ops, loss_ops,
                                             heads=GAT_HEADS_WIDE, features=DEFAULT_FEATS,
                                             workload=workload, gat_fused=gat_fused, keep1=keep1)
        runs[key], firsts[key] = summary, first
        if not gat_fused:
            inputs = rec
    worst, scale = steps_agree(torch, firsts["per_head"], firsts["stacked"],
                               f"GAT training ({DEFAULT_FEATS}, {GAT_HEADS_WIDE} heads)",
                               names=("the per-head route", "the stacked route"))
    runs["per_head"]["max_grad_err_vs_stacked"] = worst
    print(f"GAT training ({DEFAULT_FEATS}, {GAT_HEADS_WIDE} heads): the per-head route vs the "
          f"stacked route on the card, same masks: loss {float(firsts['per_head'][0])!r} / "
          f"{float(firsts['stacked'][0])!r}, tp/fp/fn equal, worst grad diff {worst:.3g} "
          f"(largest |grad| {scale:.3g})")
    return runs, inputs, firsts["stacked"], keep1


def gat1_kernel_phase(torch, gat_ops, inputs, launches):
    """Phase 20: the four single-head kernels (#9, #10) on the per-head
    route's widest inputs of phase 19 against their plain versions (forwards
    rtol and atol GAT_FWD_*, backwards rtol 1e-4 with atol 1e-5 x each
    output's scale), twice (bitwise), and against the stacked kernel at nh =
    1 on the same inputs (the same function); each timed beside its plain
    version, that stacked kernel and its bound."""
    plain = {"gat1_scores_fwd": gat_ops.gat_scores_stats_1h_reference,
             "gat1_scores_bwd": gat_ops.gat_scores_stats_1h_backward_reference,
             "gat1_aggregate_fwd": gat_ops.gat_aggregate_1h_reference,
             "gat1_aggregate_bwd": gat_ops.gat_aggregate_1h_backward_reference}

    def stacked_form(name, args):
        """The same call's arguments for the stacked kernel at nh = 1."""
        if name.startswith("gat1_scores"):
            return args[:5] + (1,) + tuple(t[None] for t in args[5:])
        head = tuple(t[None] for t in args[:5])
        return head + args[5:7] + (args[7][None], args[8][None]) + args[9:]

    rows = []
    for name, ref in plain.items():
        args = inputs[name]
        kernel = getattr(gat_ops, f"_{name}_cuda")
        stacked = getattr(gat_ops, f"_{name.replace('gat1_', 'gat_')}_cuda")
        st_args = stacked_form(name, args)
        got, again, want, st = kernel(*args), kernel(*args), ref(*args), stacked(*st_args)
        torch.cuda.synchronize()
        forward = name.endswith("fwd")
        err = 0.0
        for k, (x, w, y) in enumerate(zip(got, want, st)):
            err = max(err, float((x - w).abs().max()))
            y = y.reshape(x.shape)
            if forward:
                ok = (torch.allclose(x, w, rtol=GAT_FWD_RTOL, atol=GAT_FWD_ATOL)
                      and torch.allclose(x, y, rtol=GAT_FWD_RTOL, atol=GAT_FWD_ATOL))
            else:
                atol = ROUND_BWD_ATOL_SCALE * max(float(w.abs().max()), 1e-30)
                ok = (torch.allclose(x, w, rtol=ROUND_BWD_RTOL, atol=atol)
                      and torch.allclose(x, y, rtol=ROUND_BWD_RTOL, atol=atol))
            if not ok:
                fail(f"{name} output {k} differs from its plain version by "
                     f"{float((x - w).abs().max()):.3g}, from the stacked kernel at nh 1 by "
                     f"{float((x - y).abs().max()):.3g}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"{name} is not bitwise the same on a second launch")
        same_as_stacked = all(torch.equal(x, y.reshape(x.shape)) for x, y in zip(got, st))
        m3 = args[3] if name.startswith("gat1_scores") else args[6]
        P, na, nt = m3.shape
        b, by = bound_ms(*gat_bounds(st_args, name.replace("gat1_", "gat_"), 1))
        r = {"name": name, "route": "cuda", "source": "trackmpnn_tpu_torch/csrc/gat_kernels.cu",
             "replaces": GAT1_REPLACES[name], "launches": launches[name], "max_abs_err": err,
             "ms": cuda_time_ms(lambda: kernel(*args)),
             "call_ms": cuda_time_ms(lambda: kernel(*args), queue_ahead=False),
             "plain_ms": cuda_time_ms(lambda: ref(*args), iters=PLAIN_ITERS),
             "stacked_nh1_ms": cuda_time_ms(lambda: stacked(*st_args)),
             "bitwise_equal_to_stacked": same_as_stacked,
             "bound_ms": b, "bound_by": by, "library_ms": None,
             "shape": f"P {P}, na {na}, nt {nt}, H {HIDDEN}, live cells {int((m3 != 0).sum())}"}
        print(f"kernel {name} ({r['shape']}): device {r['ms'] * 1e3:.2f} us, per call "
              f"{r['call_ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f} us, the stacked "
              f"kernel at nh 1 {r['stacked_nh1_ms'] * 1e3:.2f} us, bitwise equal to it "
              f"{same_as_stacked}, bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}), "
              f"max abs err {err:.3g}")
        rows.append(r)
    return rows


# ------------------------------------------------ kernel #8, the raw scores ----
GAT0_REPLACES = {"gat0_scores_fwd": "trackmpnn_tpu/ops/pallas_gat.py:40",
                 "gat0_scores_bwd": "trackmpnn_tpu/ops/pallas_gat.py:50"}
GAT0_NOTE = ("no path of the JAX package or of the port calls gat_scores (pallas_gat.py:78): "
             "0 launches on every path; launched by phase 21's checks only")


def gat0_bounds(name, args):
    """(bytes, f32 operations) of kernel #8 on these inputs: every input
    read once and every output written once; per live cell, |diff| . a
    costs 4 operations a hidden unit, the backward that again and 8 more
    (d ha, d hn: 3 each; d a: 2)."""
    f = lambda *ts: 4 * sum(t.numel() for t in ts)
    ha, hn, a, m3 = args[:4]
    cells, H = int((m3 != 0).sum()), ha.shape[2]
    if name == "gat0_scores_fwd":
        return f(ha, hn, a, m3) + f(m3), cells * 4 * H
    return f(ha, hn, a, m3, args[5]) + f(ha, hn, a), cells * 12 * H


def gat0_kernel_phase(torch, gat_ops, inputs, launches):
    """Phase 21: kernel #8 (gat0_scores_fwd / _bwd) on phase 19's per-head
    widest inputs (one head) against its plain versions (forward rtol and
    atol GAT_FWD_*, backward rtol 1e-4 with atol 1e-5 x each output's
    scale), bitwise the same on a second launch and bitwise equal to #9's
    gat1_* on the same inputs (the scores; the backward with zero statistic
    cotangents); each timed beside its plain version, gat1_* and its bound."""
    ha, hn, a, m3, alpha = inputs["gat1_scores_fwd"]
    ge = inputs["gat1_scores_bwd"][5]
    P, na, nt = m3.shape
    zeros = (torch.zeros(P, na, device="cuda"), torch.zeros(P, nt, device="cuda"))
    cases = {
        "gat0_scores_fwd": ((ha, hn, a, m3, alpha), lambda *x: (gat_ops.gat_scores_reference(*x),),
                            lambda: gat_ops._gat1_scores_fwd_cuda(ha, hn, a, m3, alpha)[:1]),
        "gat0_scores_bwd": ((ha, hn, a, m3, alpha, ge), gat_ops.gat_scores_backward_reference,
                            lambda: gat_ops._gat1_scores_bwd_cuda(ha, hn, a, m3, alpha, ge,
                                                                  *zeros)),
    }
    rows = []
    for name, (args, ref, gat1) in cases.items():
        cuda = getattr(gat_ops, f"_{name}_cuda")
        kernel = (lambda: (cuda(*args),)) if name.endswith("fwd") else (lambda: cuda(*args))
        got, again, want, via9 = kernel(), kernel(), ref(*args), gat1()
        torch.cuda.synchronize()
        err = 0.0
        for k, (x, w) in enumerate(zip(got, want)):
            err = max(err, float((x - w).abs().max()))
            if name.endswith("fwd"):
                ok = torch.allclose(x, w, rtol=GAT_FWD_RTOL, atol=GAT_FWD_ATOL)
            else:
                ok = torch.allclose(x, w, rtol=ROUND_BWD_RTOL,
                                    atol=ROUND_BWD_ATOL_SCALE * max(float(w.abs().max()), 1e-30))
            if not ok:
                fail(f"{name} output {k} differs from its plain version by "
                     f"{float((x - w).abs().max()):.3g}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"{name} is not bitwise the same on a second launch")
        if not all(torch.equal(x, y) for x, y in zip(got, via9)):
            fail(f"{name} is not bitwise equal to #9's {name.replace('gat0', 'gat1')} "
                 "on the same inputs")
        b, by = bound_ms(*gat0_bounds(name, args))
        r = {"name": name, "route": "cuda", "source": "trackmpnn_tpu_torch/csrc/gat_kernels.cu",
             "replaces": GAT0_REPLACES[name], "launches": launches[name], "note": GAT0_NOTE,
             "max_abs_err": err, "ms": cuda_time_ms(kernel),
             "call_ms": cuda_time_ms(kernel, queue_ahead=False),
             "plain_ms": cuda_time_ms(lambda: ref(*args), iters=PLAIN_ITERS),
             "gat1_ms": cuda_time_ms(gat1), "bitwise_equal_to_gat1": True,
             "bound_ms": b, "bound_by": by, "library_ms": None,
             "shape": f"P {P}, na {na}, nt {nt}, H {ha.shape[2]}, live cells "
                      f"{int((m3 != 0).sum())}"}
        print(f"kernel {name} ({r['shape']}): device {r['ms'] * 1e3:.2f} us, per call "
              f"{r['call_ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f} us, "
              f"{name.replace('gat0', 'gat1')} {r['gat1_ms'] * 1e3:.2f} us, bitwise equal to it, "
              f"bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}), max abs err {err:.3g}; "
              f"launches on the paths {r['launches']}")
        rows.append(r)
    return rows


# ----------------------------------------------- the batched validation tracker ----
def batch_tracker_phase(torch, np, mp, served, full):
    """Phase 22: BatchedTracker (pipeline=True, two cohorts) on the card over
    phase 17's three default-feature sequences with its model: exactly one
    fused_edge_gru and one signed_segment_sum launch a branch and forward
    for the whole cohort, one incidence build a forward and no gather_diff;
    decoded tracks identical to
    phase 17's Tracker on the card and on the CPU, per-step scores within
    STEP_SCORE_ATOL of the card's.  Frames/s beside phase 17's (one
    sequence at a time), the busy share, peak memory."""
    from trackmpnn_tpu_torch.decode import BatchedTracker, TrackerConfig

    what = "batched tracker"
    cfg, params, stats, seqs, runs = served
    tracker = BatchedTracker(params, stats, cfg, TrackerConfig(cur_win_size=WIN, hungarian=True),
                             device="cuda")
    tracker.run([(X[:200], y[:200]) for X, y in seqs[:2]])  # cuBLAS handles, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters((mp.LAUNCHES, mp.BUILDS))
    tracker.n_forwards = 0
    steps = {}
    t0 = time.perf_counter()
    y_outs = tracker.run(seqs, pipeline=True, profile=True,
                         on_step=lambda i, g, sc: steps.setdefault(i, []).append((g.n, sc.copy())))
    wall = time.perf_counter() - t0  # run returns after the last scores came back
    phase_s = dict(tracker.phase_s)
    launches, forwards, nb = {**mp.LAUNCHES, **mp.BUILDS}, tracker.n_forwards, len(cfg.branches)
    expected = {**dict.fromkeys(mp.LAUNCHES, 0), "signed_segment_sum": nb * forwards,
                "fused_edge_gru": nb * forwards, "segment_incidence": forwards}
    if launches != expected:
        fail(f"{what}: launches and incidence builds {launches} in {forwards} cohort forwards "
             f"of {nb} branches, expected {expected}")
    INCIDENCE.setdefault("serving", {})[what] = {"builds": launches["segment_incidence"],
                                                 "forwards": forwards}
    worst = 0.0
    for i, y_out in enumerate(y_outs):
        for name, (want_steps, want) in (("phase 17's card run", runs["card"][i]),
                                         ("phase 17's CPU run", runs["cpu"][i])):
            if not np.array_equal(y_out, want):
                fail(f"{what}, sequence {i}: decoded tracks differ from {name}")
        if [n for n, _ in steps[i]] != [n for n, _ in runs["card"][i][0]]:
            fail(f"{what}, sequence {i}: the steps' row counts differ from phase 17's")
        worst = max([worst] + [float(np.abs(s - w).max())
                               for (_, s), (_, w) in zip(steps[i], runs["card"][i][0])])
    if worst > STEP_SCORE_ATOL:
        fail(f"{what}: per-step scores differ from phase 17's by {worst:.3g}")
    peak = torch.cuda.max_memory_allocated()
    frames = sum(len(np.unique(y[:, 0])) for _, y in seqs)
    profile = device_profile(torch, lambda: tracker.run(seqs, pipeline=True), wall)
    summary = {"sequences": len(seqs), "frames": frames, "cohort_forwards": forwards,
               "sequence_steps": sum(len(v) for v in steps.values()), "wall_s": wall,
               "frames_per_s": frames / wall,
               "tracker_frames_per_s_phase17": full["frames_per_s"],
               "max_step_score_err_vs_tracker": worst, "launches": launches,
               "peak_memory_bytes": peak,
               "device_busy_share": None if profile is None else profile["busy_share"],
               "host_phase_s": phase_s}
    print(f"{what}: {len(seqs)} sequences, {frames} frames in {wall:.3f} s = "
          f"{frames / wall:.4g} frames/s (phase 17's Tracker, one sequence at a time: "
          f"{full['frames_per_s']:.4g}); {forwards} cohort forwards for "
          f"{summary['sequence_steps']} sequence steps; launches {launches}; tracks identical to "
          f"phase 17's card and CPU runs, worst per-step score diff {worst:.3g}; peak memory "
          f"{peak / 2**30:.3f} GiB; busy share {summary['device_busy_share']}; host wall by "
          f"phase {', '.join(f'{k} {v:.3f} s' for k, v in phase_s.items())}")
    summary["profile"] = profile
    return summary


# --------------------------------------------------------- the training CLI ----
# the CLI's tree: 21 sequences (the split takes them by index) of real PNGs;
# KITTI's sequences have 78-1059 frames and its frames more cars
CLI_TRAIN_FRAMES, CLI_TRAIN_TRACKS = 8, 10
CLI_LOSS_RTOL, CLI_LOSS_STEPS = 1e-4, 10


@contextlib.contextmanager
def patched(obj, name, wrap):
    """obj.name replaced by wrap(obj.name) while active."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


class StepRecorder:
    """Wraps a train-step factory so that every step the CLI takes records
    its loss, its CUDA-event and host-wall time (the host waits for the
    card after each step; the CLI reads the loss right after anyway) and
    the launches of `counters` it made against expect(batch).  on_first(
    params, optimizer) runs before the first step."""

    def __init__(self, torch, counters, expect, device="cuda", on_first=None):
        self.torch, self.counters, self.expect = torch, counters, expect
        self.device, self.on_first, self.steps = device, on_first, []

    def wrap(self, factory):
        torch = self.torch

        def make(*a, **kw):
            step = factory(*a, **kw)

            def timed(params, stats, opt, batch, **kw2):
                if self.on_first is not None and not self.steps:
                    self.on_first(params, opt)
                before = {k: v for c in self.counters for k, v in c.items()}
                cuda = self.device == "cuda"
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
                if cuda:
                    ev[0].record()
                t0 = time.perf_counter()
                out = step(params, stats, opt, batch, **kw2)
                if cuda:
                    ev[1].record()
                    torch.cuda.synchronize()
                host = time.perf_counter() - t0
                launched = {k: v - before[k] for c in self.counters for k, v in c.items()}
                self.steps.append({"loss": float(out[2]), "host_s": host, "events": ev,
                                   "launched": launched, "expect": self.expect(batch)})
                return out

            return timed

        return make

    def check(self, what):
        import numpy as np

        for i, s in enumerate(self.steps):
            for k, v in s["expect"].items():
                if s["launched"][k] != v:
                    fail(f"{what}: step {i} launched {k} {s['launched'][k]} times, expected {v}")
        losses = np.array([s["loss"] for s in self.steps])
        if not len(losses) or not np.all(np.isfinite(losses)):
            fail(f"{what}: step losses {losses}")
        return losses

    def ms(self):
        """(ms a step by CUDA events, ms a step host wall), means."""
        import numpy as np

        ev = [s["events"][0].elapsed_time(s["events"][1]) for s in self.steps]
        return float(np.mean(ev)), float(np.mean([s["host_s"] for s in self.steps])) * 1e3


class ChunkRecorder:
    """Wraps EmbedTrainer.train_chunk: CUDA-event and host-wall time of each
    chunk's embedding step; on_first(trainer) runs before the first."""

    def __init__(self, torch, on_first=None):
        self.torch, self.on_first, self.calls = torch, on_first, []

    def wrap(self, orig):
        torch = self.torch

        def timed(trainer, vis_meta, track_ids):
            if self.on_first is not None and not self.calls:
                self.on_first(trainer)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            t0 = time.perf_counter()
            out = orig(trainer, vis_meta, track_ids)  # ends in a copy to the host
            ev[1].record()
            torch.cuda.synchronize()
            self.calls.append((ev, time.perf_counter() - t0))
            return out

        return timed

    def ms(self):
        import numpy as np

        return (float(np.mean([e[0].elapsed_time(e[1]) for e, _ in self.calls])),
                float(np.mean([h for _, h in self.calls])) * 1e3)


def batch1_expect(nb, msg_type="diff"):
    """The batch-1 step's launches: gather_diff and signed_segment_sum once a
    branch and valid step forward and once as each other's backward; with
    msg 'concat' gather_concat in gather_diff's place, its backward
    segment_sum_halves, and gather_diff only as signed_segment_sum's
    backward; no incidence build (the step batch's serves every round)."""
    def expect(sb):
        v = nb * int(sb.step_valid.sum())
        return {**row_step_launches(msg_type, v), "segment_incidence": 0}
    return expect


def row_step_launches(msg_type, v):
    """mp's launches in a row-layout step of v valid branch rounds."""
    if msg_type == "concat":
        return {"gather_diff": v, "signed_segment_sum": v, "fused_edge_gru": 0,
                "gather_concat": v, "segment_sum_halves": v}
    return {"gather_diff": 2 * v, "signed_segment_sum": 2 * v, "fused_edge_gru": 0,
            "gather_concat": 0, "segment_sum_halves": 0}


def block_expect(nb):
    """The block step's default composition: T rounds a branch, each one
    block_round_fwd, one block_round_bwd and two window_scatter (the es sum,
    the gate gather's backward); no incidence build in the step."""
    def expect(bb):
        r = bb.t_cap * nb
        return {"block_round_fwd": r, "block_round_bwd": r, "window_scatter": 2 * r,
                "block_round_es_fwd": 0, "block_round_es_bwd": 0, "block_incidence": 0,
                "window_incidence": 0}
    return expect


def block_heads_expect(nb):
    """block_expect with stacked attention heads: a round also launches each
    of the four stacked attention kernels once and a third window_scatter
    (the attention gather's backward); no single-head attention kernel."""
    plain = block_expect(nb)

    def expect(bb):
        r = bb.t_cap * nb
        want = {**plain(bb), "window_scatter": 3 * r}
        for k in ("gat_scores_fwd", "gat_scores_bwd", "gat_aggregate_fwd", "gat_aggregate_bwd"):
            want[k] = r
        for k in ("gat1_scores_fwd", "gat1_scores_bwd", "gat1_aggregate_fwd",
                  "gat1_aggregate_bwd", "gat0_scores_fwd", "gat0_scores_bwd"):
            want[k] = 0
        return want
    return expect


def read_log(out_dir):
    with open(os.path.join(out_dir, "logs.txt")) as f:
        return f.read()


def tensors_equal(torch, xs, ys):
    return all(torch.equal(x.detach().cpu(), y.detach().cpu()) for x, y in zip(xs, ys))


def adam_equal(torch, opt_a, leaves_a, opt_b, leaves_b):
    for p, q in zip(leaves_a, leaves_b):
        a, b = opt_a.state.get(p, {}), opt_b.state.get(q, {})
        if set(a) != set(b) or any(not torch.equal(a[k].cpu(), b[k].cpu()) for k in a):
            return False
    return True


def cli_chunk_profile(torch, np, argv, snapshot):
    """The busy share over one chunk of the CLI's batch-1 route with vis: the
    embedding's train step on the chunk, its schedule, the tracker's step,
    from the run's checkpoint, as cli/train.py::main does them; timed once
    unprofiled, then profiled."""
    from trackmpnn_tpu_torch.cli import train as cli
    from trackmpnn_tpu_torch.graph.schedule import build_window_schedule
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import checkpoint, optim
    from trackmpnn_tpu_torch.train import step as train_step
    from trackmpnn_tpu_torch.utils.config import build_train_parser

    args = build_train_parser().parse_args(argv)
    args.tp_classifier = not args.no_tp_classifier
    ds, embed = cli.make_dataset(args, "train"), cli.make_embed_trainer(args)
    cfg = mpnn.ModelConfig(features=args.feats, ncategories=len(ds.class_dict),
                           nhidden=args.num_hidden_feats)
    params, stats, _, _ = checkpoint.load_state(snapshot, cfg, "cuda")
    params = train_block.trainable(params)
    opt = optim.make_optimizer(train_block.param_leaves(params), args.learning_rate,
                               args.weight_decay)
    step = train_step.make_train_step(cfg, args.tp_classifier)
    feats, bp, _, vis_meta = ds[0]

    def run():
        f, _ = cli.attach_vis(feats, vis_meta, embed, bp[:, 1].astype(np.int32), train=True)
        y = bp[:, :2].astype(np.int64)
        ws = build_window_schedule(f, y, bucket=256)
        ws = build_window_schedule(f, y, cap=cli._bucket(ws.n_rows), t_cap=cli._t_bucket(
            ws.n_steps))
        float(step(params, stats, opt, train_step.schedule_to_device(ws, "cuda"))[2])

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    return wall, device_profile(torch, run, wall)


def train_cli_phase(torch, np, mp, block_ops, gat_ops):
    """Phase 23: the training CLI on the card, in process
    (cli.train.main(argv)), on the port's synthetic KITTI tree of real PNGs.
    (a) the defaults (2d+temp+vis, espv2 at 384 x 1280, nhidden 64, the
    batch-1 route), 2 epochs; (b) resumed from (a)'s epoch-1 checkpoint;
    (c) --feats 2d+temp, 1 epoch, on the card and on the CPU from one
    --snapshot, and one checkpoint validated on both; (d) --batch-windows 8
    --no-bf16, 1 epoch; (e) the same with --num-att-heads 3 (the stacked
    attention kernels), 1 epoch."""
    from trackmpnn_tpu_torch.backbones.weights import state_dict_from_jax
    from trackmpnn_tpu_torch.cli import train as cli
    from trackmpnn_tpu_torch.data.synthetic import write_kitti_tree
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import checkpoint, optim
    from trackmpnn_tpu_torch.train import step as train_step
    from trackmpnn_tpu_torch.train.embed import EmbedTrainer
    from trackmpnn_tpu_torch.utils.config import build_train_parser

    base = os.path.join(WORK, "train_cli")
    shutil.rmtree(base, ignore_errors=True)
    root = os.path.join(base, "kitti")
    t0 = time.perf_counter()
    write_kitti_tree(root, num_seqs=21, num_frames=CLI_TRAIN_FRAMES,
                     num_tracks=CLI_TRAIN_TRACKS, seed=0, real_images=True)
    print(f"train CLI: tree of 21 sequences x {CLI_TRAIN_FRAMES} frames, {CLI_TRAIN_TRACKS} "
          f"tracks, real PNGs, written in {time.perf_counter() - t0:.2f} s (set-up)")
    common = ["--dataset-root-path", root, "--detections", "rrc", "--log-schedule", "50"]
    out = {}
    nb3 = len(mpnn.ModelConfig(features=DEFAULT_FEATS).branches)

    # (a) the defaults, 2 epochs
    what = f"train CLI (a) ({DEFAULT_FEATS}, batch 1)"
    dir_a = os.path.join(base, "a")
    argv_a = common + ["--output-dir", dir_a, "--epochs", "2"]
    steps = StepRecorder(torch, (mp.LAUNCHES, mp.BUILDS), batch1_expect(nb3))
    chunks = ChunkRecorder(torch)
    zero_counters((mp.LAUNCHES, mp.BUILDS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(train_step, "make_train_step", steps.wrap), \
            patched(EmbedTrainer, "train_chunk", chunks.wrap):
        hist = cli.main(argv_a)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {**mp.LAUNCHES, **mp.BUILDS}
    losses = steps.check(what)
    log = read_log(dir_a)
    for line in ("Average loss for epoch", "Average embedding loss for epoch",
                 "Validation F1 score", "Validation MOTA =", "Validation mAP"):
        if log.count(line) != 2:
            fail(f"{what}: logs.txt has {log.count(line)} lines '{line}', expected 2")
    for name in ("track-mpnn_best.npz", "vis-net_best.npz", "track-mpnn_0001.npz",
                 "vis-net_0001.npz"):
        if not os.path.exists(os.path.join(dir_a, name)):
            fail(f"{what}: {name} was not written")
    val_fwd = sum(hist["val_forwards"])
    trained = {k: sum(s["launched"][k] for s in steps.steps) for k in launches}
    # one incidence a step batch (built before its step) and a validation forward
    want = {**dict.fromkeys(mp.LAUNCHES, 0), "gather_diff": trained["gather_diff"],
            "signed_segment_sum": trained["signed_segment_sum"] + nb3 * val_fwd,
            "fused_edge_gru": nb3 * val_fwd, "segment_incidence": len(steps.steps) + val_fwd}
    if launches != want or val_fwd == 0:
        fail(f"{what}: launches and incidence builds {launches}, expected {want} "
             f"({len(steps.steps)} train steps, {val_fwd} validation forwards of {nb3} branches)")
    INCIDENCE["train CLI (a)"] = {"builds": launches["segment_incidence"],
                                  "step_batches": len(steps.steps), "val_forwards": val_fwd}
    step_ev, step_wall = steps.ms()
    emb_ev, emb_wall = chunks.ms()
    chunk_wall, prof = cli_chunk_profile(torch, np, common,
                                         os.path.join(dir_a, "track-mpnn_best.npz"))
    out["a"] = {
        "features": DEFAULT_FEATS, "epochs": 2, "wall_s": wall, "history": hist,
        "chunks_per_s": [n / w for n, w in zip(hist["steps"], hist["epoch_wall_s"])],
        "ms_per_step_events": step_ev, "ms_per_step_wall": step_wall,
        "embedding_ms_per_chunk_events": emb_ev, "embedding_ms_per_chunk_wall": emb_wall,
        "val_frames_per_s": [f / w for f, w in zip(hist["val_frames"], hist["val_wall_s"])],
        "peak_memory_bytes": peak, "launches": launches, "train_steps": len(steps.steps),
        "chunk_wall_s": chunk_wall,
        "device_busy_share_chunk": None if prof is None else prof["busy_share"],
        "profile_chunk": prof}
    print(f"{what}: {len(steps.steps)} steps in 2 epochs, wall {wall:.1f} s; epoch wall "
          f"{[round(w, 2) for w in hist['epoch_wall_s']]} s, chunks/s "
          f"{[round(c, 3) for c in out['a']['chunks_per_s']]}; train step {step_ev:.3f} ms "
          f"(CUDA events) / {step_wall:.3f} ms (host wall); embedding {emb_ev:.3f} ms (events) / "
          f"{emb_wall:.3f} ms (host) a chunk; validation {hist['val_wall_s']} s, frames/s "
          f"{[round(v, 2) for v in out['a']['val_frames_per_s']]}; peak memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}; losses {losses[0]:.5g} -> "
          f"{losses[-1]:.5g}; val F1 {hist['val_f1']}, MOTA {hist['val_mota']}, mAP "
          f"{hist['val_map']}; busy share over one chunk "
          f"{out['a']['device_busy_share_chunk']} ({chunk_wall * 1e3:.1f} ms a chunk)")

    # (b) resumed from (a)'s epoch-1 checkpoint
    what = "train CLI (b) (resume)"
    dir_b = os.path.join(base, "b")
    snap = os.path.join(dir_a, "track-mpnn_0001.npz")
    cfg3 = mpnn.ModelConfig(features=DEFAULT_FEATS, nhidden=HIDDEN)
    held = {}

    def first_step(params, opt):
        p0, _, _, _ = checkpoint.load_state(snap, cfg3, "cuda")
        p0 = train_block.trainable(p0)
        opt0 = optim.make_optimizer(train_block.param_leaves(p0), 1.0, 0.0)
        checkpoint.load_optimizer_state(snap, opt0, p0, cfg3)
        leaves = train_block.param_leaves(params)
        held["params"] = tensors_equal(torch, leaves, train_block.param_leaves(p0))
        held["adam"] = adam_equal(torch, opt, leaves, opt0, train_block.param_leaves(p0))
        held["adam_step"] = int(opt.state[leaves[0]]["step"])

    def first_chunk(trainer):
        fresh = EmbedTrainer(arch="espv2", input_hw=EMBED_HW, seed=99, device="cuda")
        checkpoint.load_embed(snap.replace("track-mpnn", "vis-net"), fresh)
        ps = [p for _, p in trainer.net.named_parameters()]
        qs = [q for _, q in fresh.net.named_parameters()]
        held["vis_net"] = tensors_equal(torch, ps, qs) and tensors_equal(
            torch, trainer.net.state_dict().values(), fresh.net.state_dict().values())
        held["vis_adam"] = adam_equal(torch, trainer.opt, ps, fresh.opt, qs)

    steps_b = StepRecorder(torch, (mp.LAUNCHES, mp.BUILDS), batch1_expect(nb3),
                           on_first=first_step)
    chunks_b = ChunkRecorder(torch, on_first=first_chunk)
    with patched(train_step, "make_train_step", steps_b.wrap), \
            patched(EmbedTrainer, "train_chunk", chunks_b.wrap):
        hist_b = cli.main(common + ["--output-dir", dir_b, "--epochs", "2", "--snapshot", snap])
    steps_b.check(what)
    if f"resumed from {snap} at epoch 2" not in read_log(dir_b) or len(hist_b["loss"]) != 1:
        fail(f"{what}: did not resume at epoch 2 (history of {len(hist_b['loss'])} epochs)")
    if not all(held.get(k) for k in ("params", "adam", "vis_net", "vis_adam")):
        fail(f"{what}: the first step did not hold the saved state: {held}")
    out["b"] = {"history": hist_b, "held": held}
    print(f"{what}: started at epoch 2 from {os.path.basename(snap)}; the first step held the "
          f"saved parameters and Adam state (step {held['adam_step']}), the embedding net and "
          f"its Adam state bitwise; epoch 2 loss {hist_b['loss'][0]:.5g} (run (a): "
          f"{hist['loss'][1]:.5g})")

    # (c) 2d+temp on the card and on the CPU from one snapshot
    what = "train CLI (c) (2d+temp, card vs CPU)"
    cfg2 = mpnn.ModelConfig(features="2d+temp", nhidden=HIDDEN)
    p2 = train_block.trainable(mpnn.init_params(torch.Generator().manual_seed(23), cfg2))
    snap_c = os.path.join(base, "snap_c", "track-mpnn_0000.npz")
    checkpoint.save_state(snap_c, p2, mpnn.init_batch_stats(cfg2),
                          optim.make_optimizer(train_block.param_leaves(p2)), cfg2, 0, -1000.0)
    argv_c = common + ["--feats", "2d+temp", "--epochs", "1", "--snapshot", snap_c]
    nb2 = len(cfg2.branches)
    runs_c = {}
    for dev in ("cuda", "cpu"):
        rec = StepRecorder(torch, (mp.LAUNCHES, mp.BUILDS),
                           batch1_expect(nb2) if dev == "cuda" else (lambda sb: {}), device=dev)
        t0 = time.perf_counter()
        with patched(train_step, "make_train_step", rec.wrap):
            h = cli.main(argv_c + ["--output-dir", os.path.join(base, f"c_{dev}"),
                                   "--device", dev])
        runs_c[dev] = (h, rec.check(f"{what}, {dev}"), time.perf_counter() - t0)
    (hc, lc, wc), (hp, lp, wp) = runs_c["cuda"], runs_c["cpu"]
    if len(lc) != len(lp):
        fail(f"{what}: {len(lc)} steps on the card, {len(lp)} on the CPU")
    rel = np.abs(lc - lp) / np.maximum(np.abs(lp), 1e-30)
    if rel[:CLI_LOSS_STEPS].max() > CLI_LOSS_RTOL:
        fail(f"{what}: the first {CLI_LOSS_STEPS} losses differ by rtol "
             f"{rel[:CLI_LOSS_STEPS].max():.3g} > {CLI_LOSS_RTOL}")
    best_c = os.path.join(base, "c_cuda", "track-mpnn_best.npz")
    vals = {}
    for dev in ("cuda", "cpu"):
        args = build_train_parser().parse_args(argv_c + ["--device", dev])
        args.tp_classifier = not args.no_tp_classifier
        params, stats = checkpoint.load(best_c, cfg2, dev)
        got = {}
        metrics = cli.run_validation(args, cfg2, params, stats, cli.make_dataset(args, "val"),
                                     lambda m: None, stats_out=got)
        vals[dev] = (metrics, got["tracks"])
    if vals["cuda"][0] != vals["cpu"][0] or not all(
            np.array_equal(a, b) for a, b in zip(vals["cuda"][1], vals["cpu"][1])):
        fail(f"{what}: validating {os.path.basename(best_c)} gives {vals['cuda'][0]} and other "
             f"tracks on the card, {vals['cpu'][0]} on the CPU")
    out["c"] = {"steps": len(lc), "max_rel_loss_diff_first10": float(rel[:CLI_LOSS_STEPS].max()),
                "max_rel_loss_diff_epoch": float(rel.max()), "card_wall_s": wc, "cpu_wall_s": wp,
                "history_card": hc, "history_cpu": hp,
                "validation_same_checkpoint": list(vals["cuda"][0])}
    print(f"{what}: {len(lc)} steps; first {CLI_LOSS_STEPS} losses within rtol "
          f"{rel[:CLI_LOSS_STEPS].max():.3g}, the epoch's largest relative difference "
          f"{rel.max():.3g}; epoch loss {hc['loss'][0]:.6g} / {hp['loss'][0]:.6g}; wall "
          f"{wc:.1f} s card, {wp:.1f} s CPU; one checkpoint validated on both: identical tracks, "
          f"F1/MOTA/mAP {vals['cuda'][0]}")

    # (d) the block route
    what = "train CLI (d) (--batch-windows 8 --no-bf16)"
    dir_d = os.path.join(base, "d")
    rec = StepRecorder(torch, (block_ops.LAUNCHES, block_ops.BUILDS), block_expect(nb3))
    built = block_ops.BUILDS["block_incidence"]
    t0 = time.perf_counter()
    with patched(train_block, "make_block_train_step", rec.wrap):
        hist_d = cli.main(common + ["--output-dir", dir_d, "--epochs", "1", "--batch-windows", "8",
                                    "--no-bf16"])
    wall_d = time.perf_counter() - t0
    losses_d = rec.check(what)
    if block_ops.BUILDS["block_incidence"] - built != len(rec.steps):
        fail(f"{what}: {block_ops.BUILDS['block_incidence'] - built} BlockBatch incidences for "
             f"{len(rec.steps)} steps, expected one a batch")
    INCIDENCE["train CLI (d)"] = {"builds": block_ops.BUILDS["block_incidence"] - built,
                                  "block_batches": len(rec.steps)}
    if "block-structured batched training: 8 windows/step" not in read_log(dir_d):
        fail(f"{what}: the log does not say the block route ran")
    ev_d, host_d = rec.ms()
    out["d"] = {"steps": len(rec.steps), "wall_s": wall_d, "history": hist_d,
                "ms_per_step_events": ev_d, "ms_per_step_wall": host_d,
                "launches_per_step": [s["launched"] for s in rec.steps[:3]]}
    print(f"{what}: {len(rec.steps)} block steps (launches a step = T x {nb3} round fwd/bwd, "
          f"2T x {nb3} window_scatter, held on every step), {ev_d:.3f} ms (events) / "
          f"{host_d:.3f} ms (host) a step, wall {wall_d:.1f} s, losses {losses_d[0]:.5g} -> "
          f"{losses_d[-1]:.5g}, val MOTA {hist_d['val_mota']}")

    # (e) the block route with three stacked attention heads a branch
    heads = 3
    what = f"train CLI (e) (--batch-windows 8 --no-bf16 --num-att-heads {heads})"
    dir_e = os.path.join(base, "e")
    rec = StepRecorder(torch, (block_ops.LAUNCHES, block_ops.BUILDS, gat_ops.LAUNCHES),
                       block_heads_expect(nb3))
    built = block_ops.BUILDS["block_incidence"]
    t0 = time.perf_counter()
    with patched(train_block, "make_block_train_step", rec.wrap):
        hist_e = cli.main(common + ["--output-dir", dir_e, "--epochs", "1", "--batch-windows", "8",
                                    "--no-bf16", "--num-att-heads", str(heads)])
    wall_e = time.perf_counter() - t0
    losses_e = rec.check(what)
    if block_ops.BUILDS["block_incidence"] - built != len(rec.steps):
        fail(f"{what}: {block_ops.BUILDS['block_incidence'] - built} BlockBatch incidences for "
             f"{len(rec.steps)} steps, expected one a batch")
    if "block-structured batched training: 8 windows/step" not in read_log(dir_e):
        fail(f"{what}: the log does not say the block route ran")
    ev_e, host_e = rec.ms()
    out["e"] = {"steps": len(rec.steps), "heads": heads, "wall_s": wall_e, "history": hist_e,
                "ms_per_step_events": ev_e, "ms_per_step_wall": host_e,
                "launches_per_step": [s["launched"] for s in rec.steps[:3]]}
    print(f"{what}: {len(rec.steps)} block steps (launches a step = T x {nb3} of each stacked "
          f"attention kernel and round fwd/bwd, 3T x {nb3} window_scatter, no single-head "
          f"kernel, held on every step), {ev_e:.3f} ms (events) / {host_e:.3f} ms (host) a step, "
          f"wall {wall_e:.1f} s, losses {losses_e[0]:.5g} -> {losses_e[-1]:.5g}, val MOTA "
          f"{hist_e['val_mota']}")
    return out


# msg concat's two kernels compute what the JAX package leaves to XLA: the
# node support's concatenation and its VJP (trackmpnn_tpu/models/mpnn.py)
CONCAT_REPLACES = "trackmpnn_tpu/models/mpnn.py:125"
CONCAT_NOTES = {
    "gather_concat": "kernel #1's concat mode (gather_rows_kernel<true>): msg concat's node "
                     "support, which the JAX package computes in XLA",
    "segment_sum_halves": "kernel #2's halves mode (signed_pull_kernel<true>): gather_concat's "
                          "VJP, which the JAX package takes by XLA's autodiff"}


def concat_kernel_rows(torch, mp, concat_args, halves_args, where):
    """Phase 24 (a): gather_concat on concat_args (h, past, fut, mask)
    bitwise equal to its plain version, segment_sum_halves on halves_args
    (g, past, fut, mask, n, inc) within SCATTER_RTOL / ATOL of its plain
    version (f64 sums in another order, rounded once), each bitwise the same
    on a second launch; timed beside its plain version, its bytes bound and,
    for the halves, one index_add_ over the doubled incidence.  Returns the
    two rows."""
    rows = []
    h, past, fut, em = concat_args
    N, H = h.shape
    kernel = lambda: mp.gather_concat_raw(h, past, fut, em)
    plain = lambda: mp.gather_concat_reference(h, past, fut, em)
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(got, again):
        fail(f"gather_concat ({where}) is not bitwise its plain version "
             f"({float((got - want).abs().max())}) or a second launch")
    endpoints = int(torch.unique(torch.cat([past[em], fut[em]])).numel())
    # the endpoints' rows of h and 9 B of index and mask a row read, out written
    b, by = bound_ms(9 * N + endpoints * H * 4 + N * 2 * H * 4, 0)
    rows.append({"name": "gather_concat", "shape": f"N {N}, H {H}, edge rows {int(em.sum())}",
                 "max_abs_err": 0.0, "ms": cuda_time_ms(kernel),
                 "call_ms": cuda_time_ms(kernel, queue_ahead=False),
                 "plain_ms": cuda_time_ms(plain), "bound_ms": b, "bound_by": by,
                 "library_ms": None})
    g, past, fut, em, n, inc = halves_args
    N, H = g.shape[0], g.shape[1] // 2
    n_edges = int(em.sum())
    kernel = lambda: mp.segment_sum_halves_raw(g, past, fut, em, n, inc)
    plain = lambda: mp.segment_sum_halves_reference(g, past, fut, em, n)
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=SCATTER_RTOL, atol=SCATTER_ATOL):
        fail(f"segment_sum_halves ({where}) differs from its plain version by {err} (atol "
             f"{SCATTER_ATOL}, rtol {SCATTER_RTOL})")
    if not torch.equal(got, again):
        fail(f"segment_sum_halves ({where}) is not bitwise the same on a second launch")
    # yardstick: one f32 index_add_ of [g[:, :H]; g[:, H:]] at [past; fut]
    # (its atomics' f32 order: held at 1e-4, as signed_segment_sum's)
    idx2 = torch.cat([torch.where(em, past, n), torch.where(em, fut, n)]).long()
    vals2 = torch.cat([g[:, :H], g[:, H:]])
    library = lambda: torch.zeros(n + 1, H, device="cuda").index_add_(0, idx2, vals2)
    if not torch.allclose(library()[:n], want, rtol=1e-4, atol=1e-4):
        fail(f"index_add_ yardstick ({where}) does not compute the same function")
    # g's edge rows and 9 B of index and mask a row read once, out written once
    b, by = bound_ms(9 * N + n_edges * 2 * H * 4 + n * H * 4, 2 * n_edges * H)
    rows.append({"name": "segment_sum_halves", "shape": f"N {N}, n {n}, H {H}, edge rows "
                 f"{n_edges}", "max_abs_err": err, "ms": cuda_time_ms(kernel),
                 "call_ms": cuda_time_ms(kernel, queue_ahead=False),
                 "plain_ms": cuda_time_ms(plain), "bound_ms": b, "bound_by": by,
                 "library_ms": cuda_time_ms(library)})
    for r in rows:
        r.update(route="cuda", source="trackmpnn_tpu_torch/csrc/mp_kernels.cu",
                 replaces=CONCAT_REPLACES, note=CONCAT_NOTES[r["name"]], where=where)
        lib = r["library_ms"]
        print(f"kernel {r['name']} ({where}; {r['shape']}): device {r['ms'] * 1e3:.2f} us, per "
              f"call with the host's launch cost {r['call_ms'] * 1e3:.2f} us (plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us by "
              f"{r['bound_by']}, library {'-' if lib is None else '%.2f us' % (lib * 1e3)}), "
              f"max abs err {r['max_abs_err']:.3g}, bitwise on a second launch")
    return rows


def concat_phase(torch, np, mp, block_ops, gat_ops, loss_ops, packed_wl, default_wl,
                 serving_in):
    """Phase 24, msg concat: (b) one phase-3 sequence served (features 2d),
    card against CPU; (c) phase 10's batch-1 step, the first step card
    against CPU, then timed; (a) the two concat kernels at (c)'s widest
    round and at phase 2's window (serving_in); (d) phase 18's block step
    in its three compositions, card against CPU; (e) the training CLI, one
    epoch on phase 23's tree, then the infer CLI on its checkpoint over
    phase 4's test tree.  Returns (summary, the kernels line's two rows)."""
    from trackmpnn_tpu_torch.cli import infer
    from trackmpnn_tpu_torch.cli import train as cli
    from trackmpnn_tpu_torch.data.synthetic import make_sequence
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import optim
    from trackmpnn_tpu_torch.train import step as train_step

    out = {}
    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN, msg_type="concat")
    params0 = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    stats0 = mpnn.init_batch_stats(cfg)

    # (b) serving
    X, bp, _ = make_sequence(num_tracks=SERVE_TRACKS, num_frames=SERVE_FRAMES, ncategories=3,
                             seed=SERVE_SEEDS[0])
    Xw, bpw, _ = make_sequence(num_tracks=SERVE_TRACKS, num_frames=12, seed=99)
    out["serving"] = serve_and_check(torch, np, mp, cfg, params0, stats0,
                                     [(X, bp[:, :2].astype(np.int64))],
                                     (Xw, bpw[:, :2].astype(np.int64)), "serving (msg concat)")

    # (c) the batch-1 step
    what = "row-layout training, batch 1 (msg concat)"
    schedules, cap, t_cap, edges = packed_wl
    ws, edges = schedules[0], edges[0]
    valid = int(ws.step_valid.sum())
    step = train_step.make_train_step(cfg, tp_classifier=False)
    sb = train_step.schedule_to_device(ws, device="cuda")
    params = train_block.trainable(to_device(params0, "cuda"))
    stats = to_device(stats0, "cuda")
    opt = optim.make_optimizer(train_block.param_leaves(params), TRAIN_LR, TRAIN_WD)
    widest = {}
    edge_rows = lambda a: int(a[3].sum())
    with record_widest(mp, "gather_concat_raw", widest, lambda a: "concat", edge_rows), \
            record_widest(mp, "segment_sum_halves_raw", widest, lambda a: "halves", edge_rows):
        params, stats, loss1, aux1 = step(params, stats, opt, sb)
    grads1 = [p.grad.detach().clone() for p in train_block.param_leaves(params)]
    torch.cuda.synchronize()

    def run():
        nonlocal params, stats
        params, stats, loss, _ = step(params, stats, opt, sb)
        return loss

    losses, events_ms, wall_ms, launches = timed_steps(torch, run, (mp.LAUNCHES, mp.BUILDS))
    check_launches(what, launches, {**row_step_launches("concat", valid), "segment_incidence": 0})
    if not np.all(np.isfinite(losses)):
        fail(f"{what} loss not finite: {losses}")
    profile = device_profile(torch, run, wall_ms / 1e3)
    params_c = train_block.trainable(params0)
    opt_c = optim.make_optimizer(train_block.param_leaves(params_c), TRAIN_LR, TRAIN_WD)
    params_c, _, loss_c, aux_c = step(params_c, stats0, opt_c,
                                      train_step.schedule_to_device(ws, device="cpu"))
    total = lambda aux: {**aux, **{k: aux[k].sum() for k in ("tp", "fp", "fn")}}
    worst, gscale = first_step_agrees(torch, train_block, loss1, total(aux1), grads1, loss_c,
                                      total(aux_c), params_c, what)
    out["batch1"] = {"valid_steps": valid, "steps": TRAIN_STEPS, "ms_per_step_events": events_ms,
                     "ms_per_step_wall": wall_ms, "edges_per_s": edges / (wall_ms / 1e3),
                     "launches": launches, "loss_first": float(loss1),
                     "cpu_loss_first": float(loss_c), "max_grad_err_vs_cpu": worst,
                     "grad_scale": gscale, "profile_step": profile}
    print(f"{what}: {TRAIN_STEPS} steps, {events_ms:.3f} ms/step (CUDA events), {wall_ms:.3f} "
          f"ms/step (host wall); launches a step "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items() if v} }; vs CPU: loss "
          f"{float(loss1)!r} / {float(loss_c)!r}, tp/fp/fn equal, worst grad diff {worst:.3g} "
          f"(largest |grad| {gscale:.3g})")

    # (a) the kernels at (c)'s widest round and at phase 2's window
    out["kernels_batch1"] = concat_kernel_rows(torch, mp, widest["concat"], widest["halves"],
                                               "row layout, batch 1, msg concat")
    h, past, fut, em, n, inc = serving_in
    g = torch.randn(n, 2 * HIDDEN, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(24))
    rows = concat_kernel_rows(torch, mp, (h, past, fut, em), (g, past, fut, em, n, inc),
                              "serving")
    for r in rows:
        r["launches"] = launches[r["name"]]

    # (d) the block step at the default features, three compositions
    out["block"] = {}
    for key, flags in (("default", {}), ("es_kernel", dict(es_kernel=True)),
                       ("fused_loss", dict(fused_loss=True))):
        summary, _, _ = training_phase(torch, np, block_ops, gat_ops, loss_ops, heads=0,
                                       features=DEFAULT_FEATS, workload=default_wl,
                                       timed=key == "default", msg_type="concat", **flags)
        out["block"][key] = summary

    # (e) the training CLI, one epoch, then the infer CLI on its checkpoint
    what = "train CLI (msg concat)"
    root = os.path.join(WORK, "train_cli", "kitti")  # phase 23's tree
    dir_e = os.path.join(WORK, "train_cli", "concat")
    nb3 = len(mpnn.ModelConfig(features=DEFAULT_FEATS).branches)
    rec = StepRecorder(torch, (mp.LAUNCHES, mp.BUILDS), batch1_expect(nb3, "concat"))
    zero_counters((mp.LAUNCHES, mp.BUILDS))
    t0 = time.perf_counter()
    with patched(train_step, "make_train_step", rec.wrap):
        hist = cli.main(["--dataset-root-path", root, "--detections", "rrc", "--log-schedule",
                         "50", "--output-dir", dir_e, "--epochs", "1", "--msg-type", "concat"])
    wall = time.perf_counter() - t0
    losses = rec.check(what)
    trained = {k: sum(s["launched"][k] for s in rec.steps) for k in mp.LAUNCHES}
    val_fwd = sum(hist["val_forwards"])
    want = {**trained, "gather_concat": trained["gather_concat"] + nb3 * val_fwd,
            "signed_segment_sum": trained["signed_segment_sum"] + nb3 * val_fwd}
    if dict(mp.LAUNCHES) != want or val_fwd == 0 or want["fused_edge_gru"] != 0:
        fail(f"{what}: launches {dict(mp.LAUNCHES)}, expected {want} ({len(rec.steps)} train "
             f"steps, {val_fwd} validation forwards of {nb3} branches)")
    ev, host = rec.ms()
    zero_counters((mp.LAUNCHES, mp.BUILDS))
    infer_dir = os.path.join(WORK, "concat_infer")
    t1 = time.perf_counter()
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        infer.main(["--snapshot", os.path.join(dir_e, "track-mpnn_best.npz"),
                    "--dataset-root-path", os.path.join(WORK, "kitti"), "--output-dir",
                    infer_dir, "--hungarian"])
    infer_s = time.perf_counter() - t1
    files = sorted(f for f in os.listdir(infer_dir) if f.endswith(".txt"))
    lines = sum(len(open(os.path.join(infer_dir, f)).read().splitlines()) for f in files)
    inferred = dict(mp.LAUNCHES)
    if files != ["0000.txt", "0001.txt"] or lines == 0:
        fail(f"{what}: the infer CLI wrote {files} ({lines} lines)")
    if inferred["gather_concat"] == 0 or inferred["fused_edge_gru"] or inferred["gather_diff"]:
        fail(f"{what}: the infer CLI launched {inferred}, expected gather_concat and no "
             "fused_edge_gru or gather_diff")
    out["cli"] = {"steps": len(rec.steps), "wall_s": wall, "history": hist,
                  "ms_per_step_events": ev, "ms_per_step_wall": host,
                  "infer_s": infer_s, "infer_lines": lines, "infer_launches": inferred}
    print(f"{what}: {len(rec.steps)} batch-1 steps (launches held on every step), {ev:.3f} ms "
          f"(events) / {host:.3f} ms (host) a step, wall {wall:.1f} s, losses {losses[0]:.5g} "
          f"-> {losses[-1]:.5g}, val MOTA {hist['val_mota']}; the infer CLI on its checkpoint: "
          f"{len(files)} result files ({lines} lines) in {infer_s:.1f} s, launches {inferred}")
    return out, rows


# ------------------------------------------------ the planner and bf16 rectangles ----
# dense bf16 on the H100's tensor cores (NVIDIA's data sheet): the bf16 block
# round's products
PEAK_BF16_PER_S = 989e12
BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_GRAD_ATOL_SCALE = 1e-3, 1e-2, 1e-3
BF16_VS_F32_LOSS_RTOL, BF16_VS_F32_COSINE = 1e-2, 0.99
BF16_FLIP = 2.0 ** -8  # one bf16 operand rounded to its other neighbour, relative
BF16_REPLACES = {"block_round_fwd_bf16": "trackmpnn_tpu/ops/pallas_block.py:123",
                 "block_round_bwd_bf16": "trackmpnn_tpu/ops/pallas_block.py:140",
                 "gat_aggregate_fwd_bf16": "trackmpnn_tpu/ops/pallas_gat.py:644",
                 "gat_aggregate_bwd_bf16": "trackmpnn_tpu/ops/pallas_gat.py:664"}


@contextlib.contextmanager
def engine_timer():
    """While active, the host seconds spent in the graph engine's calls that
    the trackers make (initialize, update, decode_tracks, prune: association
    and decode planning, appending frames, renumbering) are summed into
    the yielded list's one entry."""
    from trackmpnn_tpu_torch.graph import engine

    spent = [0.0]

    def timing(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return run

    with contextlib.ExitStack() as stack:
        for name in ("initialize", "update", "decode_tracks", "prune"):
            stack.enter_context(patched(engine, name, timing))
        yield spent


@contextlib.contextmanager
def native_planner(on: bool):
    """TM_NATIVE set for the engine's calls: the C++ planner (on) or its
    numpy paths (TM_NATIVE=0)."""
    old = os.environ.get("TM_NATIVE")
    os.environ["TM_NATIVE"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TM_NATIVE")
        else:
            os.environ["TM_NATIVE"] = old


def planner_phase(torch, np, mp, serving3, served17):
    """Phase 25 (a): phase 3's three sequences (Tracker) and phase 22's
    batched run (BatchedTracker over phase 17's sequences and model), each
    served with the native planner and with TM_NATIVE=0 in this process:
    decoded tracks identical between the two and to the phases' CPU runs;
    frames/s and the host ms a frame spent in the graph engine for both."""
    from trackmpnn_tpu_torch.decode import BatchedTracker, Tracker, TrackerConfig
    from trackmpnn_tpu_torch.graph import native

    t0 = time.perf_counter()
    built = native.build()
    print(f"planner: {native.library_path()} {'built' if built else 'up to date'} in "
          f"{time.perf_counter() - t0:.2f} s (set-up)")
    out = {}
    tcfg = TrackerConfig(cur_win_size=WIN, hungarian=True)
    cfg, params, stats, seqs, warm, runs3 = serving3
    frames = sum(len(np.unique(y[:, 0])) for _, y in seqs)
    for on in (True, False):
        key = "planner" if on else "numpy"
        with native_planner(on):
            gpu = Tracker(params, stats, cfg, tcfg, device="cuda")
            gpu.run(*warm)
            torch.cuda.synchronize()
            with engine_timer() as spent:
                t1 = time.perf_counter()
                y_outs = [gpu.run(X, y) for X, y in seqs]
                wall = time.perf_counter() - t1
        for i, y_out in enumerate(y_outs):
            if not np.array_equal(y_out, runs3["cpu"][i][1]):
                fail(f"planner ({key}), phase 3's sequence {i}: tracks differ from phase 3's "
                     "CPU run")
        out[f"serving_{key}"] = {"frames": frames, "wall_s": wall, "frames_per_s": frames / wall,
                                 "engine_s": spent[0], "engine_ms_per_frame": spent[0] * 1e3 / frames,
                                 "engine_share_of_wall": spent[0] / wall}
        print(f"planner, phase 3's sequences ({key}): {frames} frames in {wall:.3f} s = "
              f"{frames / wall:.4g} frames/s; engine {spent[0] * 1e3 / frames:.3f} host ms a "
              f"frame ({spent[0] / wall:.3f} of the wall); tracks identical to phase 3's CPU run")

    cfg, params, stats, seqs, runs17 = served17
    frames = sum(len(np.unique(y[:, 0])) for _, y in seqs)
    for on in (True, False):
        key = "planner" if on else "numpy"
        with native_planner(on):
            tracker = BatchedTracker(params, stats, cfg, tcfg, device="cuda")
            tracker.run([(X[:200], y[:200]) for X, y in seqs[:2]])
            torch.cuda.synchronize()
            with engine_timer() as spent:
                t1 = time.perf_counter()
                y_outs = tracker.run(seqs, pipeline=True)
                wall = time.perf_counter() - t1
        for i, y_out in enumerate(y_outs):
            if not np.array_equal(y_out, runs17["cpu"][i][1]):
                fail(f"planner ({key}), phase 22's sequence {i}: tracks differ from phase 17's "
                     "CPU run")
        out[f"batched_{key}"] = {"frames": frames, "wall_s": wall, "frames_per_s": frames / wall,
                                 "engine_s": spent[0], "engine_ms_per_frame": spent[0] * 1e3 / frames,
                                 "engine_share_of_wall": spent[0] / wall}
        print(f"planner, phase 22's batched run ({key}): {frames} frames in {wall:.3f} s = "
              f"{frames / wall:.4g} frames/s; engine {spent[0] * 1e3 / frames:.3f} host ms a "
              f"frame ({spent[0] / wall:.3f} of the wall); tracks identical to phase 17's CPU run")
    for what in ("serving", "batched"):
        out[f"{what}_speedup"] = out[f"{what}_planner"]["frames_per_s"] / \
            out[f"{what}_numpy"]["frames_per_s"]
    print(f"planner: frames/s with the planner over TM_NATIVE=0: serving "
          f"{out['serving_speedup']:.3f}x, batched {out['batched_speedup']:.3f}x")
    return out


def bf16_close(torch, what, name, got, want, ulps=1, flip=0.0):
    """A bf16 output within `ulps` bf16 ulps of the larger magnitude plus
    `flip` plus 1e-5 of its scale (tests/test_torch_cuda.py::
    assert_bf16_close); returns the largest difference."""
    if os.path.join(HERE, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_util import bf16_ulp

    a, b = got.float(), want.float()
    lim = ulps * bf16_ulp(torch.maximum(a.abs(), b.abs())) + flip + 1e-5 * max(
        float(b.abs().max()), 1.0)
    err = (a - b).abs()
    if got.dtype != torch.bfloat16 or bool((err > lim).any()):
        fail(f"{what} {name}: {int((err > lim).sum())} values beyond {ulps} bf16 ulp(s) + "
             f"{flip:.3g} of the plain version (largest excess "
             f"{float((err - lim).max()):.3g}), dtype {got.dtype}")
    return float(err.max())


def f32_close(torch, what, name, got, want, extra=0.0):
    """An f32 output within rtol 1e-4, atol 1e-5 of its scale (+ extra)."""
    atol = ROUND_BWD_ATOL_SCALE * max(float(want.abs().max()), 1.0) + extra
    if not torch.allclose(got, want, rtol=ROUND_BWD_RTOL, atol=atol):
        fail(f"{what} {name} differs from its plain version by "
             f"{float((got - want).abs().max()):.3g} (rtol {ROUND_BWD_RTOL}, atol {atol:.3g})")
    return float((got - want).abs().max())


def bound_bf16_ms(nbytes: float, product_flops: float, other_flops: float):
    """The bf16 round's bound: its products at the dense bf16 tensor rate
    plus its gate arithmetic at the f32 rate, or its bytes."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = product_flops / PEAK_BF16_PER_S + other_flops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bf16_round_rows(torch, block_ops, fwd_args, cots, f32_fwd, f32_bwd, launches, where):
    """block_round_fwd_bf16 and block_round_bwd_bf16 on fwd_args (bf16
    h_e, ga, gb) and cots (bf16 g_eo) against their plain versions on the
    card: edge_out, d h_e, d ga, d gb within one bf16 ulp (d h_e also one
    flipped d gh operand), the f32 outputs within rtol 1e-4 (d w_hh also one
    flipped operand); bitwise the same on a second launch; timed beside
    their plain versions and the f32 kernels on f32_fwd / f32_bwd (the same
    shape in f32)."""
    if os.path.join(HERE, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_util import bf16_dgh_scale

    he, ga, gb, whh, bhh, web, mask, sign = fwd_args
    P, na, nt, H = he.shape
    live = mask != 0
    cells, rows_a, cols_b = int(live.sum()), int(live.any(2).sum()), int(live.any(1).sum())
    shape = f"P {P}, na {na}, nt {nt}, H {H}, live cells {cells}, {where}"
    what = f"block_round_fwd_bf16 ({shape})"
    got = block_ops._block_round_fwd_cuda(*fwd_args)
    again = block_ops._block_round_fwd_cuda(*fwd_args)
    want = block_ops.block_round_reference(*fwd_args)
    torch.cuda.synchronize()
    err = bf16_close(torch, what, "edge_out", got[0], want[0])
    for name, a, b in zip(("rs", "cs", "lg"), got[1:], want[1:]):
        err = max(err, f32_close(torch, what, name, a, b))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{what} is not bitwise the same on a second launch")
    if not (torch.all(got[0][~live] == 0) and torch.all(got[3][~live] == 0)):
        fail(f"{what} wrote a nonzero edge_out or lg at a padded cell")
    prod = cells * 2 * H * 3 * H
    other = cells * (2 * H + 2 * H + GATE_FLOPS_PER_UNIT * H)
    fwd_bytes = (2 * cells * H + 4 * P * na * nt + 2 * (rows_a + cols_b) * 3 * H
                 + 4 * (H * 3 * H + 4 * H) + P * na * nt * (2 * H + 4) + 4 * P * (na + nt) * H)
    b, by = bound_bf16_ms(fwd_bytes, prod, other)
    rows = [{
        "name": "block_round_fwd_bf16", "route": "cuda",
        "source": "trackmpnn_tpu_torch/csrc/block_kernels.cu",
        "replaces": BF16_REPLACES["block_round_fwd_bf16"],
        "launches": launches["block_round_fwd_bf16"], "max_abs_err": err,
        "ms": cuda_time_ms(lambda: block_ops._block_round_fwd_cuda(*fwd_args)),
        "call_ms": cuda_time_ms(lambda: block_ops._block_round_fwd_cuda(*fwd_args),
                                queue_ahead=False),
        "plain_ms": cuda_time_ms(lambda: block_ops.block_round_reference(*fwd_args),
                                 iters=PLAIN_ITERS),
        "f32_kernel_ms": cuda_time_ms(lambda: block_ops._block_round_fwd_cuda(*f32_fwd)),
        "bound_ms": b, "bound_by": by, "library_ms": None, "shape": shape}]

    bwd_args = tuple(fwd_args) + tuple(cots)
    what = f"block_round_bwd_bf16 ({shape})"
    got = block_ops._block_round_bwd_cuda(*bwd_args)
    again = block_ops._block_round_bwd_cuda(*bwd_args)
    want = block_ops.block_round_backward_reference(*bwd_args)
    torch.cuda.synchronize()
    dgh = BF16_FLIP * bf16_dgh_scale(fwd_args[:7], cots, sign)
    err = bf16_close(torch, what, "dhe", got[0], want[0], flip=dgh * float(whh.abs().max()))
    for name, a, w in zip(("dga", "dgb"), got[1:3], want[1:3]):
        err = max(err, bf16_close(torch, what, name, a, w))
    err = max(err, f32_close(torch, what, "dwhh", got[3], want[3],
                             extra=dgh * float(he.float().abs().max())))
    for name, a, w in zip(("dbhh", "dweb"), got[4:], want[4:]):
        err = max(err, f32_close(torch, what, name, a, w))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{what} is not bitwise the same on a second launch")
    bwd_bytes = (2 * 2 * cells * H + 4 * 2 * P * na * nt + 2 * (rows_a + cols_b) * 3 * H
                 + 4 * (rows_a + cols_b) * H + 4 * (H * 3 * H + 4 * H) + 2 * P * na * nt * H
                 + 2 * P * (na + nt) * 3 * H + 4 * (H * 3 * H + 4 * H))
    b, by = bound_bf16_ms(bwd_bytes, 3 * prod, cells * 2 * GATE_FLOPS_PER_UNIT * H)
    rows.append({
        "name": "block_round_bwd_bf16", "route": "cuda",
        "source": "trackmpnn_tpu_torch/csrc/block_kernels.cu",
        "replaces": BF16_REPLACES["block_round_bwd_bf16"],
        "launches": launches["block_round_bwd_bf16"], "max_abs_err": err,
        "ms": cuda_time_ms(lambda: block_ops._block_round_bwd_cuda(*bwd_args)),
        "call_ms": cuda_time_ms(lambda: block_ops._block_round_bwd_cuda(*bwd_args),
                                queue_ahead=False),
        "plain_ms": cuda_time_ms(lambda: block_ops.block_round_backward_reference(*bwd_args),
                                 iters=PLAIN_ITERS),
        "f32_kernel_ms": cuda_time_ms(lambda: block_ops._block_round_bwd_cuda(*f32_bwd)),
        "bound_ms": b, "bound_by": by, "library_ms": None, "shape": shape})
    for r in rows:
        print_kernel_row(r, f"; the f32 kernel on the same shape {r['f32_kernel_ms'] * 1e3:.2f} us")
    return rows


def bf16_gat_rows(torch, gat_ops, fwd_args, bwd_args, launches):
    """gat_aggregate_fwd_bf16 / _bwd_bf16 on phase 8's 3-head row with its
    h_e in bf16 against their plain versions: rs, cs within GAT_FWD_*; the
    backward's f32 outputs within rtol 1e-4 and 1e-5 of their scale; d h_e
    (bf16, each head's term rounded and added in bf16 in head order) within
    two bf16 ulps; bitwise on a relaunch; timed beside the f32 kernels on
    the f32 row."""
    bf = lambda args: tuple(a.bfloat16() if i == 5 else a for i, a in enumerate(args))
    rows = []
    for name, args32 in (("gat_aggregate_fwd_bf16", fwd_args),
                         ("gat_aggregate_bwd_bf16", bwd_args)):
        args = bf(args32)
        base = name[:-len("_bf16")]
        kernel = getattr(gat_ops, f"_{base}_cuda")
        plain = (gat_ops.gat_aggregate_reference if base.endswith("fwd")
                 else gat_ops.gat_aggregate_backward_reference)
        e, m3 = args[0], args[6]
        nh, (P, na, nt), H = e.shape[0], m3.shape, args[5].shape[3]
        shape = f"nh {nh}, P {P}, na {na}, nt {nt}, H {H}, live cells {int((m3 != 0).sum())}"
        got, again, want = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = 0.0
        if base.endswith("fwd"):
            for x, w in zip(got, want):
                err = max(err, float((x - w).abs().max()))
                if not torch.allclose(x, w, rtol=GAT_FWD_RTOL, atol=GAT_FWD_ATOL):
                    fail(f"{name} ({shape}) differs from its plain version by "
                         f"{float((x - w).abs().max()):.3g}")
        else:
            for k, (x, w) in enumerate(zip(got[:5], want[:5])):
                err = max(err, f32_close(torch, f"{name} ({shape})", f"output {k}", x, w))
            err = max(err, bf16_close(torch, f"{name} ({shape})", "dhe", got[5], want[5], ulps=2))
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"{name} ({shape}) is not bitwise the same on a second launch")
        b, by = bound_ms(*gat_bounds(args, base, nh))
        r = {"name": name, "route": "cuda", "source": "trackmpnn_tpu_torch/csrc/gat_kernels.cu",
             "replaces": BF16_REPLACES[name], "launches": launches[name], "max_abs_err": err,
             "ms": cuda_time_ms(lambda: kernel(*args)),
             "call_ms": cuda_time_ms(lambda: kernel(*args), queue_ahead=False),
             "plain_ms": cuda_time_ms(lambda: plain(*args), iters=PLAIN_ITERS),
             "f32_kernel_ms": cuda_time_ms(lambda: kernel(*args32)),
             "bound_ms": b, "bound_by": by, "library_ms": None, "shape": shape}
        print_kernel_row(r, f"; the f32 kernel on the f32 row {r['f32_kernel_ms'] * 1e3:.2f} us")
        rows.append(r)
    return rows


def bf16_tracks_f32(torch, first_bf16, first_f32, what):
    """The bf16 step's first step against the f32 step's on the card (as
    tests/test_block_step.py holds JAX's): loss within rtol
    BF16_VS_F32_LOSS_RTOL, and each gradient's direction, cosine >
    BF16_VS_F32_COSINE, for every leaf whose f32 gradient norm is at least
    1e-3 of the largest (lin1's bias, which BN makes invariant, has only
    rounding noise for a gradient).  Returns (loss rel diff, worst cosine)."""
    (l16, _, g16), (l32, _, g32) = first_bf16, first_f32
    rel = abs(float(l16) - float(l32)) / abs(float(l32))
    if rel > BF16_VS_F32_LOSS_RTOL:
        fail(f"{what}: the bf16 step's loss {float(l16)!r} against the f32 step's "
             f"{float(l32)!r} (rel {rel:.3g} > {BF16_VS_F32_LOSS_RTOL})")
    norms = [float(g.norm()) for g in g32]
    worst = 1.0
    for i, (a, b) in enumerate(zip(g16, g32)):
        if norms[i] < 1e-3 * max(norms):
            continue
        cos = float((a.double() * b.double()).sum() / (a.double().norm() * b.double().norm()))
        worst = min(worst, cos)
        if not cos > BF16_VS_F32_COSINE:
            fail(f"{what}: gradient of leaf {i} at cosine {cos:.5f} to the f32 step's")
    return rel, worst


def bf16_phase(torch, np, block_ops, gat_ops, loss_ops, f32_runs, f32_inputs, gat3_args,
               default_wl, keep19):
    """Phase 25 (b) and (c): the bf16 block step (compute_dtype=bf16) on
    phase 5's workload, phase 18's default features and phase 19's stacked
    heads (timed, launches exact, each first step against its CPU rerun
    and against the f32 step's on the card), then the bf16 kernels at the
    phase-5 workload's widest round, at P 16, na = nt = 64, H 128 and on
    phase 8's 3-head row."""
    bf16 = torch.bfloat16
    runs, firsts, inputs = {}, {}, {}
    for key, kw in (("phase5", dict(heads=0)),
                    ("default", dict(heads=0, features=DEFAULT_FEATS, workload=default_wl)),
                    ("heads", dict(heads=GAT_HEADS_WIDE, features=DEFAULT_FEATS,
                                   workload=default_wl, keep1=keep19))):
        summary, rec, first = training_phase(torch, np, block_ops, gat_ops, loss_ops,
                                             compute_dtype=bf16, **kw)
        f32_summary, f32_first = f32_runs[key]
        rel, cos = bf16_tracks_f32(torch, first, f32_first, f"bf16 training ({key})")
        summary.update({"loss_rel_vs_f32": rel, "worst_grad_cosine_vs_f32": cos,
                        "f32_ms_per_step_events": f32_summary["ms_per_step_events"],
                        "f32_ms_per_step_wall": f32_summary["ms_per_step_wall"]})
        print(f"bf16 training ({key}) vs the f32 step on the card: loss {float(first[0])!r} / "
              f"{float(f32_first[0])!r} (rel {rel:.3g}), worst gradient cosine {cos:.6f}; "
              f"{summary['ms_per_step_events']:.3f} / {summary['ms_per_step_wall']:.3f} ms a "
              f"step (events / host) against f32's {f32_summary['ms_per_step_events']:.3f} / "
              f"{f32_summary['ms_per_step_wall']:.3f}")
        runs[key], firsts[key] = summary, first
        if key == "phase5":
            inputs = rec
    launches = {k: runs["phase5"]["launches"][k] for k in ("block_round_fwd_bf16",
                                                           "block_round_bwd_bf16")}
    launches.update({k: runs["heads"]["launches"][k] for k in ("gat_aggregate_fwd_bf16",
                                                              "gat_aggregate_bwd_bf16")})
    fwd, bwd = inputs["fwd"], inputs["bwd"]
    rows = bf16_round_rows(torch, block_ops, fwd, bwd[8:], f32_inputs["fwd"], f32_inputs["bwd"],
                           launches, "the bf16 step's widest round")
    args, cots = round_problem(np, torch, 11, **WIDE_ROUND)
    wide_rows = bf16_round_rows(
        torch, block_ops, [a.bfloat16() if i < 3 else a for i, a in enumerate(args)] + [-1.0],
        [cots[0].bfloat16()] + cots[1:], args + [-1.0], args + [-1.0] + cots,
        {"block_round_fwd_bf16": None, "block_round_bwd_bf16": None}, "seeded")
    rows += bf16_gat_rows(torch, gat_ops, *gat3_args, launches)
    return runs, rows, wide_rows


def bf16_cli_phase(torch, block_ops):
    """Phase 25 (d): the training CLI with --batch-windows 8 and its default
    --bf16, one epoch on phase 23's tree: the bf16 route logged, T x 3
    launches of block_round_fwd_bf16 and _bwd_bf16 and 2T x 3 window_scatter
    every step, none of the f32 round's, one BlockBatch incidence a step."""
    from trackmpnn_tpu_torch.cli import train as cli
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import block as train_block

    what = "train CLI (--batch-windows 8, bf16 by default)"
    root = os.path.join(WORK, "train_cli", "kitti")  # phase 23's tree
    out_dir = os.path.join(WORK, "train_cli", "bf16")
    nb3 = len(mpnn.ModelConfig(features=DEFAULT_FEATS).branches)
    plain = block_expect(nb3)

    def expect(bb):
        r = bb.t_cap * nb3
        return {**plain(bb), "block_round_fwd": 0, "block_round_bwd": 0,
                "block_round_fwd_bf16": r, "block_round_bwd_bf16": r}

    rec = StepRecorder(torch, (block_ops.LAUNCHES, block_ops.BUILDS), expect)
    built = block_ops.BUILDS["block_incidence"]
    t0 = time.perf_counter()
    with patched(train_block, "make_block_train_step", rec.wrap):
        hist = cli.main(["--dataset-root-path", root, "--detections", "rrc", "--log-schedule",
                         "50", "--output-dir", out_dir, "--epochs", "1", "--batch-windows", "8"])
    wall = time.perf_counter() - t0
    losses = rec.check(what)
    if block_ops.BUILDS["block_incidence"] - built != len(rec.steps):
        fail(f"{what}: {block_ops.BUILDS['block_incidence'] - built} BlockBatch incidences for "
             f"{len(rec.steps)} steps, expected one a batch")
    if "block-structured batched training: 8 windows/step (bf16)" not in read_log(out_dir):
        fail(f"{what}: the log does not say the bf16 block route ran")
    ev, host = rec.ms()
    out = {"steps": len(rec.steps), "wall_s": wall, "history": hist,
           "ms_per_step_events": ev, "ms_per_step_wall": host,
           "launches_per_step": [s["launched"] for s in rec.steps[:3]]}
    print(f"{what}: {len(rec.steps)} block steps (T x {nb3} block_round_fwd_bf16 / _bwd_bf16 "
          f"and 2T x {nb3} window_scatter, held on every step), {ev:.3f} ms (events) / "
          f"{host:.3f} ms (host) a step, wall {wall:.1f} s, losses {losses[0]:.5g} -> "
          f"{losses[-1]:.5g}, val MOTA {hist['val_mota']}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="also write every number to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check runs on a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from trackmpnn_tpu_torch.decode import tracker as tracker_mod
        from trackmpnn_tpu_torch.graph import view as view_mod
        from trackmpnn_tpu_torch.ops import _build, mp
        from trackmpnn_tpu_torch.ops import block as block_ops
        from trackmpnn_tpu_torch.ops import dcn as dcn_ops
        from trackmpnn_tpu_torch.ops import gat as gat_ops
        from trackmpnn_tpu_torch.ops import loss as loss_ops
        from trackmpnn_tpu_torch.ops import round as round_ops
    except ImportError as e:
        fail(f"the trackmpnn_tpu_torch package is not beside this script ({e})")

    # 1. card and settings
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print(f"settings: PyTorch's own flags, TF32 for cuDNN "
          f"{torch.backends.cudnn.allow_tf32}, for matmuls "
          f"{torch.backends.cuda.matmul.allow_tf32}; EmbedTrainer pins full f32 in its calls")
    t0 = time.perf_counter()
    build = _build.build()
    for name in _build.LIBRARIES:
        _build.load(name)
    each = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in build.items())
    print(f"setup: kernels built in {time.perf_counter() - t0:.2f} s, one nvcc per source "
          f"at once ({each})")
    for name, b in build.items():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 2. kernels, 3. serving, 4. CLI: the serving path
    kernels, edge_gru_wide, serving_in = kernel_phase(torch, np, mp, tracker_mod, view_mod)
    serving, serving3 = serving_phase(torch, np, mp)
    cli = cli_phase(torch, np)
    # 5. training, 6. block kernels: the training path
    training, inputs, first5 = training_phase(torch, np, block_ops, gat_ops, loss_ops, heads=0)
    block_kernels, scatter_es = block_kernel_phase(torch, block_ops, inputs,
                                                   training["launches"])
    kernels += block_kernels
    # the round kernels and one block step at a width the first design refused
    block_wide = wide_round_rows(torch, np, block_ops)
    training_wide, _, _ = training_phase(torch, np, block_ops, gat_ops, loss_ops, heads=0,
                                         hidden=WIDE_HIDDEN, timed=False)
    # 7. GAT training, 8. GAT kernels, 9. GAT serving: the attention path
    gat_training, gat_inputs, _ = training_phase(torch, np, block_ops, gat_ops, loss_ops,
                                                 heads=GAT_HEADS)
    gat_kernels, gat_wide, gat3_args = gat_kernel_phase(torch, gat_ops, gat_inputs,
                                                        gat_training["launches"])
    kernels += gat_kernels
    gat_refused = gat_wide_rows(torch, gat_ops, "stacked")
    gat_serving = gat_serving_phase(torch, np, mp)
    # 10. batch-1 training, 11. packed training, 12. round kernels: the row layout
    packed_wl = packed_workload(np)
    batch1 = batch1_phase(torch, np, mp, round_ops, packed_wl)
    packed_training, round_inputs = packed_phase(torch, np, mp, round_ops, packed_wl)
    kernels += round_kernel_phase(torch, round_ops, round_inputs, packed_training["launches"])
    round_wide = wide_round_kernel_rows(torch, round_ops, *round_inputs["round_fwd"][1].shape[:2])
    # 13. the block step's other compositions, 14. their kernels (after 18)
    compositions = {}
    for key, flags in (("es_kernel", dict(es_kernel=True)),
                       ("es_kernel_fused_loss", dict(es_kernel=True, fused_loss=True))):
        summary, es_inputs, first = training_phase(torch, np, block_ops, gat_ops, loss_ops,
                                                   heads=0, **flags)
        worst, scale = steps_agree(torch, first, first5, f"training ({key})",
                                   names=(key, "the default composition"))
        summary["max_grad_err_vs_default"] = worst
        print(f"training ({key}) vs the default composition on the card: loss "
              f"{float(first[0])!r} / {float(first5[0])!r}, tp/fp/fn equal, worst grad diff "
              f"{worst:.3g} (largest |grad| {scale:.3g})")
        compositions[key] = summary
    # 18. the default features trained, 14. the es and loss kernels (the
    # losses also at phase 18's width), 19. with three heads on both
    # attention routes, 20. the single-head kernels
    default_wl = default_training_workload(torch, np)
    default_training, loss_wide, default_first = default_training_phase(
        torch, np, block_ops, gat_ops, loss_ops, default_wl)
    es_loss_rows, loss_narrow = es_loss_kernel_phase(
        torch, block_ops, loss_ops, es_inputs, compositions["es_kernel_fused_loss"]["launches"],
        loss_wide)
    kernels += es_loss_rows
    es_wide = wide_es_rows(torch, np, block_ops)
    loss_wide_rows = wide_loss_rows(torch, np, loss_ops)
    default_heads, gat1_inputs, heads_first, keep19 = default_heads_phase(
        torch, np, block_ops, gat_ops, loss_ops, default_wl)
    kernels += gat1_kernel_phase(torch, gat_ops, gat1_inputs,
                                 default_heads["per_head"]["launches"])
    gat_refused += gat_wide_rows(torch, gat_ops, "gat1")
    # 21. kernel #8 on the same inputs (every block training phase above held
    # its launches at 0: no path calls it)
    kernels += gat0_kernel_phase(torch, gat_ops, gat1_inputs,
                                 default_heads["per_head"]["launches"])
    gat_refused += gat_wide_rows(torch, gat_ops, "gat0")
    # 15. the embedding path, 16. its DCN kernels
    embedding, dcn_inputs = embedding_phase(torch, np, dcn_ops)
    kernels += dcn_kernel_phase(torch, dcn_ops, dcn_inputs,
                                embedding["dla34_bounded"]["launches"])
    x_dcn, w_dcn = dcn_inputs["dcn_fwd"][0], dcn_inputs["dcn_fwd"][1]
    dx_reach = dcn_dx_reach_row(torch, dcn_ops, (*x_dcn.shape, w_dcn.shape[1]))
    # 17. the default configuration served at full width
    full, served = full_serving_phase(torch, np, mp)
    # 22. the batched validation tracker on phase 17's sequences
    batch_tracking = batch_tracker_phase(torch, np, mp, served, full)
    # 25 (a) the native planner against TM_NATIVE=0 on phases 3 and 22
    planner = planner_phase(torch, np, mp, serving3, served)
    del served
    # 23. the training CLI
    train_cli = train_cli_phase(torch, np, mp, block_ops, gat_ops)
    # 24. msg concat: serving, the batch-1 step, its kernels, the block step, the CLIs
    concat, concat_rows = concat_phase(torch, np, mp, block_ops, gat_ops, loss_ops, packed_wl,
                                       default_wl, serving_in)
    kernels += concat_rows
    # 25 (b), (c) the bf16 block step and its kernels, (d) the CLI's default --bf16
    bf16_runs, bf16_rows, bf16_wide = bf16_phase(
        torch, np, block_ops, gat_ops, loss_ops,
        {"phase5": (training, first5), "default": (default_training["default"], default_first),
         "heads": (default_heads["stacked"], heads_first)}, inputs, gat3_args, default_wl, keep19)
    kernels += bf16_rows
    bf16_cli = bf16_cli_phase(torch, block_ops)
    # each serving kernel's launches on the path it runs on: gather_diff in
    # row-layout training (phase 10; a served forward takes fused_edge_gru),
    # signed_segment_sum serving (phase 3), fused_edge_gru the default
    # configuration's serving (phase 17)
    mp_launches = {"gather_diff": batch1["launches"]["gather_diff"],
                   "signed_segment_sum": serving["launches"]["signed_segment_sum"],
                   "fused_edge_gru": full["launches"]["fused_edge_gru"]}
    for k in kernels:
        if k["name"] in mp_launches:
            k["launches"] = mp_launches[k["name"]]

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "kernels": kernels, "fused_edge_gru_wide": edge_gru_wide,
                       "window_scatter_es": scatter_es, "block_round_wide": block_wide,
                       "es_round_wide": es_wide, "training_wide": training_wide,
                       "round_wide": round_wide, "dcn_bwd_dx_max_reach": dx_reach,
                       "gat_kernels_3_heads": gat_wide, "gat_refused_widths": gat_refused,
                       "serving": serving, "cli": cli,
                       "training": training, "gat_training": gat_training,
                       "gat_serving": gat_serving, "row_batch1": batch1,
                       "row_packed": packed_training, "block_compositions": compositions,
                       "edge_losses_one_branch": loss_narrow,
                       "edge_losses_wide": loss_wide_rows,
                       "default_training": default_training, "default_heads": default_heads,
                       "embedding": embedding, "full_serving": full,
                       "batch_tracker": batch_tracking, "train_cli": train_cli,
                       "msg_concat": concat, "planner": planner,
                       "bf16_training": bf16_runs, "bf16_round_wide": bf16_wide,
                       "bf16_train_cli": bf16_cli,
                       "incidence": INCIDENCE},
                      f, indent=1)
    print(f"incidence builds: {json.dumps(INCIDENCE)}")
    print(f"card: {card}")
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "call_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys + ["bound_tf32_ms", "note"] if k in r}
                                  for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
