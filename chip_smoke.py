"""Smoke test of the PyTorch / CUDA port on one GPU: the pose-serving path,
the pose-training path, the two-stage (detector -> pose) serving path, the
semi-supervised path, detector training, the input path's device half,
int8 serving, the device mesh and the runner utilities.

    python3 chip_smoke.py

Twelve phases, each printing what it found; any failure exits non-zero
before the result line.

1. device: requires CUDA (there is no CPU fallback), prints the card, its
   power limit, the torch and CUDA versions and the TF32 switches (both set
   off, so float32 matmuls and convs run in full float32);
2. build: compiles the CUDA kernels from `csrc/` (one nvcc per source, all
   at once) and prints the seconds, then counts the tensor-core product
   instructions (HMMA / HGMMA) in the SASS of the fused head's bf16
   kernels (kernels 3 and 4), of their float32-feature route (3f and 4f)
   and of the kernels both routes take past 256 features, and fails if any
   has none;
3. kernels: each of the five pose kernels against its plain PyTorch
   version on the card, at the shapes of the two paths and at small ragged
   shapes; kernel 1 also at batch 1 with its planned chunks and with more
   chunks than rows, on `hm[1:]` and on a base off 16 bytes (its generic
   path), and twice at the serving shape for the same bits; kernels 3 and
   4 with bf16 features and float32 ones (all on the tensor cores, each
   feature dtype counted on its own entry points), and also at the
   two-stage path's pose batch of 4, kernel 3 on float32 features also at
   the teacher sweep's 168 crops, both twice at the serving shape on both
   routes (3f also at 168 crops) for the same bits; kernels 3/3f and 4/4f
   at every kind of width and depth the JAX head takes (F = 7, 38, 259,
   260 and 512, D = 160), each twice for the same bits, and kernels 1 and 2 at D =
   160; kernel 5 bitwise against
   its plain version with float32 and uint8 frames, with and without its
   normalising epilogue, and on degenerate maps (singular, an exact
   90-degree turn, a horizon inside the output, positions at +-inf);
4. serving: the flagship model (ModelConfig(): ResNet-50, 224x224, bf16,
   21 joints x 56 depth x 56x56) with seeded random weights sweeps 80
   synthetic samples through `Tester.run` at batch 32 (three batches, the
   last padded) on both head arms, eagerly and as CUDA-graph replays
   (the first batch eager, then one replay a batch), then
   `evaluate_test_split`; it checks the launch counts (on the replayed
   sweep: the graph's kernel nodes, read through libcuda, times its
   replays), the replayed coords and Batch fields bitwise against the
   eager ones, the finite metrics and the coords against the plain head,
   times the slice and profiles it (device busy, host issue time), eager
   against the bare replay and against the whole captured call; then the
   wide heads' sweeps: the fused arm of a float32 pose net whose deconv
   stack is 260 wide and of a bf16 one 512 wide
   (ModelConfig(deconv_channels=512)), eager, their launches counted, the
   device kernels they ran read from a profiler's trace (the kernels that
   walk F in slices, none of the resident ones) and their coords held to
   the plain head;
5. training: `Trainer.fit` at ModelConfig() and batch 32 on
   SyntheticFreiHand(render_joints=True) takes a few eager steps on each
   head arm; it checks the launch counts per step (the warp on both arms,
   the fused head's forward and backward or the soft-argmax's), the
   finite losses, the snapshot it writes, and on one batch the
   kernel-backed step's gradients against a plain-backed step's from the
   same state, at bf16 and at float32 compute; the fused arm at float32
   compute also takes a few counted steps of `Trainer.fit` (kernels 3 and
   4 on float32 features), and so does ModelConfig(deconv_channels=512)
   in bf16 and at float32 compute, each after its own gradient check and
   with its device kernels read from a profiler's trace, as in phase 4;
   then `Trainer.fit` with scan_steps=4 as graph
   replays (one
   eager warm-up chunk, then one replay a chunk) against the same Trainer
   run eagerly under cuDNN's deterministic algorithms: launch counts from
   the graph's nodes and the training state bitwise equal; then it times
   and profiles the train step on both arms, eager against graph;
6. timing: each kernel against its plain version with CUDA events, in
   turns (plain, kernel, kernel, plain), at the paths' shapes; kernel 1
   also with a float32 heatmap and at batch 4, each beside its own byte
   bound, with its chunk plan, its two launches' device time and its
   wrapper's host issue time; kernel 2's device kernels per call (the
   kernel nodes of a captured CUDA graph; it fails unless 1); kernels 3
   and 4 with both feature dtypes, kernel 3 also at batch 4, 3f also at
   the teacher sweep's 168 crops, all four also at F = 260 and 512, each
   beside its bound and its share of it, with the backward call's device
   time by step from a trace ((s), `channel_constants`, (a), (b), (c)),
   and 4 and 4f at F = 1024 (two passes of 512 features); kernel 5 on
   the training path's call (uint8 frames to the normalised patch) against
   its plain chain, both beside their byte bounds, with the wrapper's host
   issue time and its device kernels per call (it fails unless 1);
7. detection: the NMS and ROIAlign kernels against their plain versions
   (keep sets bitwise equal; the suppression chain, clustered boxes at the
   RPN and class-NMS shapes, both early-exit settings; ROIAlign at the
   detector's shape and ragged ones), then the reference's detector at full
   width (DetectorConfig(): ResNet-101 C4, caffe-style blocks as its
   checkpoints need, 600-pixel blobs, 6000 -> 300 proposals, 100
   detections, float32) with seeded random weights on four synthetic 600^2
   scenes: launch counts per `detect`, `detect_split` against `detect`,
   and the kernel-backed `detect` against the same call on the plain
   versions; then `TwoStagePipeline` (detector -> crop -> R50 pose net with
   the fused head) sweeps 8 synthetic 224^2 frames at batch 4 with its
   launch counts, `cli.evaluate --synthetic --use-detector` writes a
   pred.json, and the kernels, `detect`, `detect_split`, the detector's
   stages and the pipeline are timed: NMS at both of `detect`'s shapes,
   its device time split into the mask and sweep launches (profile) with
   the sweep's time per 64-box block, ROIAlign beside the bytes of feature
   taps it reads;
8. semi-supervised: (a) PANet at DEFAULT_DICT_SIZES (seeded) trained 200
   steps at batch 500 on `cli.panet_data --synthetic` clouds (the loss
   falls and stays finite; ms per step), then its forward and parameter
   gradients at batch 500 against the same module on the CPU at float64,
   its cameras rotations; (b) the rotation-variance filter of
   `distill.generate_filtered_labels` with a frozen R50 teacher (seeded,
   head scaled as in phase 4) on 8 images x 21 rotations (168 crops, the
   CLI's batch), factored mode: the crops from kernel 5 bitwise against
   the plain two-pass chain, the kernel-backed filter (kernels 5 and 3,
   one launch each) against the plain-backed one, keep sets at a
   threshold between the middle variances, `CascadeRunner`'s keep set
   against the single pass's, ms per batch; then a pseudo-label db over
   the student's split, and `cli.generate_teacher_labels --teacher-dtype
   float32` over 16 images (kernel 3f, one launch a batch of 168 crops);
   (c) the student at ModelConfig() and batch 32,
   fused arm, with the live teacher and the PANet term (lam 0.1), then
   with the db (and the PANet term): `Trainer.fit` eagerly, then
   scan_steps=4 replays against the same Trainer run eagerly under
   cuDNN's deterministic algorithms (bitwise), launch counts (kernel 3
   twice a step with the teacher, kernels 4 and 5 once), eager against
   graph timing; the teacher and PANet unchanged;
9. detector training: (a) the ROIAlign backward kernel against the plain
   VJP at the training shape (4 x 38x38x1024, 4 x 128 RoIs in the sampled
   layout: foreground first with the gt box, zero padding slots), at
   ragged ones (RoIs partly off the map, under one cell, R = 1, C = 6) and
   at a 1 000-pixel image's 63 x 38 map, whose 32-channel strip the kernel
   cuts into bands of rows, with an image whose RoIs all lie off the map;
   two launches bitwise equal, timed beside its bound; (b) kernel 7 at the
   training proposal shape, 4 x 12 000 -> 2 000 at IoU 0.7, keep sets
   bitwise equal with and without early exit; (c) the train step of the
   detector of phase 7 (R101 caffe C4, 600^2, float32, frozen BN) at batch
   4 on synthetic scenes, heads scaled: one step kernel-backed against
   plain-backed from one state and one set of draws under cuDNN's
   deterministic algorithms (sampled RoIs equal, losses, every parameter's
   gradient), the kernel-backed step twice bitwise equal, then, with the
   frozen BatchNorm statistics set from one forward pass over the scenes
   (each layer's own input statistics, so the untrained R101's
   activations stay near unit size) and the heads scaled again, twenty
   steps of the detector's SGD at `DET_LR` (3e-7: at its own 1e-3 the
   random-weight net's curvature lets rounding part the runs) with the
   same draws each step and the first step's proposals fed back each step
   (one fixed objective, `frozen_proposals`) under cuDNN's deterministic
   algorithms, whose loss must fall (the last below the first, the mean
   of the last three below that of the first three; by a margin 131 times
   the spread of 16 runs that differ only in rounding, in
   `scripts/detector_descent_study.py`),
   each step's backward kernel held to the plain VJP on its own
   cotangent and RoIs, with their launches per step (kernel 7, kernel 6
   and its backward once each), timed back to back and profiled; (d)
   `cli.train_detector --synthetic` for three steps, its .pth restored by
   `build_detector` with the same `detect`; (e) `cli.semi_supervised_study`,
   `cli.filter_cascade_study` and `cli.analyze_correlation` at a few steps;
10. the input path and int8 serving: (a) `yuv420_to_rgb` on the card
   bitwise against the CPU at 32 x 224^2 and ragged even sizes, timed
   beside its byte bound, and the pinned host-to-device copy of one batch
   of packed planes against one RGB batch; the JPEG half needs the
   libjpeg headers to build, so `Trainer.fit` (fused arm, scan_steps=4
   replays) runs over
   the synthetic split with its frames replaced by seeded 4:2:0 planes and
   the decode inside the captured chunk, against the same steps fed the
   planes decoded outside (cuDNN deterministic): training state bitwise
   equal; (b) int8 layers (`quantize`: im2col views and `torch._int_mm`)
   at the stem, a 3x3 stride-2 conv, 1x1 convs (N 64 and the RPN's 18),
   the 4x4 stride-2 deconv and a Linear with N = 2: with unit scales the
   int32 sums bitwise a float64 product of the same int8 values, with
   calibrated scales the epilogue bitwise; (c) `TwoStagePipeline(
   int8_calib=...)` at phase 7's width (every conv and Linear quantized but
   `head.final_layer`), launches per batch, the bundles saved, reloaded
   (bitwise) and refused when swapped, `cli.evaluate --int8 --int8-db`
   twice (pred.json bitwise equal), int8 against float per batch; (d)
   `quantized_teacher_apply` over the 8 x 21 sweep (keep set and variances
   against the float teacher, ms per batch) and `cli.generate_teacher_labels
   --teacher-dtype int8`;
11. the device mesh (`parallel/`): kernels 3 and 4 at the model split's
   joint counts (7 and 3: 392 and 168 channels) against their plain
   versions, kernel 4 on bf16 and float32 features (bitwise twice);
   (a) `Trainer(mesh=make_mesh())` on one NCCL rank at ModelConfig() and
   batch 32, scan_steps=4 (the second chunk captured
   with its all-reduces: the graph's NCCL kernel nodes are counted)
   against the same Trainer without a mesh over 8 steps, losses and
   parameters, and the replay timed against the meshless one; (b) two
   processes on the card over gloo (eager: a gloo collective cannot be
   captured), 4 steps at a global batch of 32 (16 a rank) against one
   process on the union of the two ranks' draws, then `Tester(mesh)` on
   40 samples against one rank; (c) data=1 x model=2 at 21 joints runs
   the head on the gathered weight (`head_model_split` false), and three
   processes over model=3 (7 joints a rank, kernels 3 and 4 at J = 7)
   hold eval coords and one step's gradients to the data-only run; (d)
   `TwoStagePipeline(mesh)` over two ranks at phase 7's width, float and
   int8, against one rank. The ranks are `parallel/_smoke_worker.py`;
   a rank that fails fails the phase. Times of (b) and (d) are
   time-shared on one card, not a scaling figure;
12. the utilities: (a) `entry()` (R50, 8 x 224^2, its projection scaled
   to a peaked softmax on seeded images) within COORD_TOL of the plain
   head on the same features, kernel 3 launched once; (b) a torchvision-
   shaped R50 ImageNet state dict from a seed, then `Trainer(
   imagenet_init=..., log_dir=..., scan_steps=2)` at batch 32 through one
   epoch of three chunks (the eager warm-up, the capture, a replay) with
   `profile_dir` and without (cuDNN deterministic): after the init the
   backbone is the file's bitwise and the rest a fresh Trainer's; losses
   and training state bitwise equal; the trace names kernels 3, 4 and 5 in
   every step (replays included); train_logs.txt holds the epoch lines with
   `h/epoch`; each chunk's time on the Trainer's timer, profiled and not;
   (c) `cli.find_mean_std --synthetic --device cuda` within 1e-12 of
   numpy's exact float64 statistics (integer sums) of the same samples;
   (e) `dryrun_multichip(2)` on the card (two processes sharing it over
   gloo, R18 at 32^2): both arms' losses and PA-MPJPE finite, and rank 0's
   launches name the fused head's float32 forward and backward and the
   warp.

Each path's launch counts start from 0 just before the path runs and are
read just after it; the launches in the kernels line are their sum. The
kernels line gives each kernel's time beside its plain version's and its
bound: the larger of the bytes it must move over 3.35 TB/s and the
operations it must do over the card's peak for their type, from the H100
SXM data sheet: 67 TFLOP/s for float32 on CUDA cores, and for the fused
head's 1x1 projections (bf16 features times float32 weights or gradients)
989/3 TFLOP/s, the bf16 tensor-core rate over the three bf16 products
that carry a float32 operand split into bf16 parts to float32 accuracy;
with float32 features (both operands float32) 989/6 TFLOP/s, six such
products (495/3 for 3xTF32). The kernels line has the fused head's
float32-feature entry points as their own rows (`*_f32`), and the
kernels both routes take past 256 features (`*_slices`, timed at F =
512, their launches those of the main paths' runs at F > 256, which the
other rows leave out). No single PyTorch call computes any
of the fourteen functions (there is no torchvision
here for NMS or ROIAlign and its backward), so `library_ms` is null. The
line before the last is the card's name and power limit; the last line is
the JSON result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 32
N_SAMPLES = 80
SEED = 0
# training steps per arm in the counted run, and steps per timing reading;
# (f) kept small so that the whole script, builds included, stays far
# inside its time limit (about 80 s of command time on an H100)
TRAIN_STEPS = 3
TIME_STEPS = 12
# Trainer.fit steps at float32 compute (the fused head's float32 route)
F32_TRAIN_STEPS = 2
# Trainer(scan_steps=k) on the card, k = 1 and GRAPH_CHUNK: one eager
# warm-up chunk, then GRAPH_STEPS / k - 1 replays of one captured chunk
GRAPH_CHUNK = 4
GRAPH_STEPS = 12
# Coords are means of positions in [-0.5, 0.5] weighted by softmax terms
# that kernel and plain version compute from the same float32 logits; only
# the summation order differs (~1e-6 relative over 175k terms), so 1e-4 is
# far from both the noise and any indexing or scaling fault.
COORD_TOL = 1e-4
S_REL_TOL = 1e-4
# The backward kernels fold the per-channel constants where the plain
# versions form p * sum cot (g - c), and the fused one recomputes the
# logits with float32 FMAs where the plain version runs cuBLAS: float32
# numbers combined in another order. Held to 1e-5 (soft-argmax) and 1e-4
# (fused head, sums over 1176 channels or 100k rows) of the largest entry,
# plus one bf16 ulp (2^-8 relative) where the result is bf16.
GRAD_ABS_SCALE = {"softmax_integral_bwd": 1e-5,
                  "head_projection_integral_bwd": 1e-4}
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
# The warp kernel forms the plain version's coefficients, positions,
# weights, sums and normalised values with the same rounded operations in
# the same order: bitwise equal, nan in the same places.
# The unfused arm decodes the bf16 heatmap of the bf16 final conv, where
# the fused arm forms float32 logits from float32 weights. bf16 keeps 8
# bits: at logit magnitudes up to ~30 the rounding moves a logit by up to
# ~0.1, which reweights near-tied peaks by ~10%; a joint whose mass sits on
# peaks far apart can move by that share of their distance.
ARMS_MEAN_TOL = 1e-2
ARMS_MAX_TOL = 0.1
# Train-step gradients, kernel-backed vs plain-backed decode, as
# ||g_kernel - g_plain|| / ||g_plain|| per parameter leaf and for the whole
# gradient. The two decodes' gradients agree to float32 rounding. At
# float32 compute (same widths, TF32 off) that difference propagates as
# such: 1e-4 whole; a leaf whose gradient is a sum that cancels (the stem
# BatchNorm's bias sums over 32 x 112^2 positions) amplifies it up to
# ~1000x: 1e-3 per leaf. Under bf16 autocast every conv rounds the
# incoming gradient to 8 bits, so a difference in the last float32 bits
# flips roundings layer after layer down the 50 layers: 5e-2 whole and
# 0.25 per leaf. Beside it the script prints the same distance for a plain
# decode run in float64, which differs from the float32 one only by
# rounding.
GRAD_LEAF_REL_F32 = 1e-3
GRAD_TOTAL_REL_F32 = 1e-4
GRAD_LEAF_REL_BF16 = 0.25
GRAD_TOTAL_REL_BF16 = 5e-2
# logit spread the head is scaled to, so each joint's softmax is peaked
LOGIT_STD = 6.0
# The NMS kernel forms the plain version's float32 IoU with the same
# rounded operations: keep sets, boxes and scores are bitwise equal.
# ROIAlign weights the same float32 taps and sums a bin's 16 products in
# another order: a few ulps of the largest feature.
ROI_TOL = 1e-5
# Kernel-backed vs plain-backed detect: the pooled features differ by that
# summation order, which moves the head's deltas, and so the boxes, by a
# float32 ulp or two; at 600-1050 pixels an ulp is 6e-5 - 1.2e-4 pixel.
# Two ulps of the largest coordinate (2^-22 relative) on top of 1e-4 px.
BOX_TOL_ABS, BOX_TOL_REL = 1e-4, 2.0 ** -22
# The two-stage path's detector: 4 scenes of 600^2, as the JAX package's
# config-4 benchmark draws them (bench.py:213-225), and pipeline frames
DET_BATCH = 4
DET_SIZE = 600
PIPE_FRAMES = 8
# The semi-supervised phase: PANet at DEFAULT_DICT_SIZES trained on
# cli.panet_data --synthetic clouds, the teacher sweep at the CLI's batch
# of 8 images x 21 rotations, the student's PANet weight.
PANET_CLOUDS = 5000
PANET_BATCH = 500
PANET_STEPS = 200
SWEEP_BATCH = 8
# the sweep's crops a batch: SWEEP_BATCH images x the teacher's 21
# rotations (TrainConfig.teacher_num_rotations), kernel 3's batch there
SWEEP_CROPS = SWEEP_BATCH * 21
# fused-head widths past the kernels that keep a block's weight planes at
# the whole F (F <= 256): one slice past them and two passes of the N = F
# products; the wide sweeps' (float32 at 260, bf16 at 512), the wide
# training run's (512, both dtypes) and phase 6's; and a depth past 128
WIDE_FEATS = (260, 512)
WIDE_DEPTH = 160
# phase 6 also times the backward at two passes of 512 features
PASS_FEATS_TIMED = 1024
WIDE_TRAIN_STEPS = 2
# the kernels line's rows of the kernels both routes take past 256
# features: kernel 3, 4, 3f and 4f there
WIDE_ROWS = ("head_projection_integral_fwd_slices",
             "head_projection_integral_bwd_slices",
             "head_projection_integral_fwd_f32_slices",
             "head_projection_integral_bwd_f32_slices")
LAM = 0.1
# PANet on the card takes float32 inputs and weights where the CPU copy
# runs float64; the cameras are formed in float64 from the float32
# estimator output on both. Float32 rounding (~6e-8) through seven
# layers and the closest rotation: 1e-4 of the largest output; gradients
# sum over 500 samples and pass the rotation's 1 / (s_i + s_j): 1e-3.
PANET_TOL = 1e-4
PANET_GRAD_TOL = 1e-3
# rows whose variance lies this close to the threshold may flip between
# the kernel-backed and the plain-backed sweep; the run counts them
KEEP_MARGIN = 1e-3
# The ROIAlign backward kernel and its plain VJP (autograd of the separable
# einsums) weight the same float32 cotangents with the same float32 tap
# weights and sum them in another order: 1e-5 of the largest gradient.
ROI_BWD_TOL = 1e-5
# Kernel-backed vs plain-backed detector train step from one state and one
# set of draws: the sampled RoIs are equal (proposals from bitwise-equal
# NMS); the pooled features differ by ROIAlign's summation order (~1e-7
# relative), which the float32 tail carries on: the losses to 1e-5
# relative. The tail's ReLU masks flip where an activation is within that
# noise of zero, and a weight gradient summed over 4 x 128 x 49 positions
# moves by such flips: each parameter's gradient to 1e-3 of its largest
# entry (the pose train step's float32 leaf bound), the whole gradient to
# 1e-4 relative in norm. The backward kernel alone, isolated by running
# the step with kernel 6 forward and the plain VJP backward (the same
# forward, so the tail's gradients are bitwise equal): every parameter's
# gradient to 1e-4 of its largest entry.
DET_LOSS_REL = 1e-5
DET_GRAD_LEAF = 1e-3
DET_GRAD_TOTAL = 1e-4
DET_GRAD_BWD = 1e-4
# SGD steps on one objective, whose loss must fall: the last below the
# first, the mean of the last three below that of the first three. The
# same draws each step and the first step's proposals fed back each step
# (`frozen_proposals`) hold the sampled RoIs and targets fixed. Left to
# move with the weights, the proposals let float32 rounding alone turn a
# trajectory: of 16 runs from one state that differ only in the rounding
# of the ROIAlign backward (the kernel, its plain VJP in float32 and in
# float64, every detector op plain, and either times 1 + 1e-7 or 1e-6
# N(0, 1)), 4 fell over ten steps at the detector's rate of 1e-3 on an
# H100 and 16 over twenty, 15 over twenty-five
# (scripts/detector_descent_study.py).
DET_TRAIN_STEPS = 20
# The SGD steps' rate (make_detector_optimizer's SGD, momentum 0.9, clip
# 10). With unit frozen BatchNorm statistics the untrained R101's
# activations grow by orders of magnitude through its 33 blocks (5.4e5
# mean |x| at the base's output), and steps at 1e-3 and even 1e-7 raised
# the loss from 3 to ~50-1e4 on an H100; so the statistics are first set
# from the scenes themselves (`calibrate_frozen_batchnorm`). Even then,
# and on the fixed objective, the detector's own rate of 1e-3 is past
# what this random-weight net's curvature allows: the 16 runs' losses
# parted by 4e-4 after one step and 0.63 over twenty, their smallest drop
# a third of that spread. Down to 3e-7 the spread shrank faster than the
# drop: at 3e-7 the loss falls smoothly in all 16 (by 0.0926 to 0.0932 over
# twenty steps), the smallest drop 131 times their spread (7.1e-4); at
# 1e-6 44 times, at 1e-5 10 times (the study, on an H100).
DET_LR = 3e-7
# the card's published peaks (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# a bf16 x float32 product to float32 accuracy on tensor cores: the float32
# operand split into three bf16 parts, three bf16 products
BF16X3_FLOPS = 989e12 / 3
# a float32 x float32 product to float32 accuracy on tensor cores: six bf16
# products of the parts (the rate of 3xTF32 on the TF32 units, 495/3)
BF16X6_FLOPS = 989e12 / 6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, kernel_fn, plain_fn):
    """Run the kernel, synchronise, run the plain version; max abs error of
    coords and m, max relative error of s."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    e_c = float((got[0] - want[0]).abs().max())
    e_m = float((got[1] - want[1]).abs().max())
    e_s = float(((got[2] - want[2]) / want[2]).abs().max())
    ok = e_c <= COORD_TOL and e_m <= COORD_TOL and e_s <= S_REL_TOL
    print(f"[kernels] {name}: max|d coords| {e_c:.3e} (tol {COORD_TOL:g}: "
          f"{e_c / COORD_TOL:.3f} of it), max|d m| {e_m:.3e} "
          f"({e_m / COORD_TOL:.3f}), max rel d s {e_s:.3e} (tol "
          f"{S_REL_TOL:g}: {e_s / S_REL_TOL:.3f}) {'ok' if ok else 'FAILED'}",
          flush=True)
    check(ok, f"{name} disagrees with its plain version")
    return e_c


def compare_grads(name, kernel_fn, plain_fn, abs_scale):
    """Run a backward kernel, synchronise, run its plain version; every
    output is held to GRAD_REL of its dtype plus abs_scale of its largest
    plain entry. Returns the max abs error over the outputs."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    worst = 0.0
    for i, (gk, wk) in enumerate(zip(got, want)):
        atol = abs_scale * float(wk.float().abs().max())
        diff = (gk.float() - wk.float()).abs()
        excess = float((diff - atol - GRAD_REL[gk.dtype]
                        * wk.float().abs()).max())
        e = float(diff.max())
        worst = max(worst, e)
        ok = gk.dtype == wk.dtype and gk.shape == wk.shape and excess <= 0
        print(f"[kernels] {name} output {i} {tuple(gk.shape)} {gk.dtype}: "
              f"max|d| {e:.3e} (atol {atol:.3e} + rtol "
              f"{GRAD_REL[gk.dtype]:g}) {'ok' if ok else 'FAILED'}",
              flush=True)
        check(ok, f"{name} output {i} disagrees with its plain version")
    return worst


def time_pair(kernel_fn, plain_fn, iters=10):
    """Kernel vs plain version in turns (plain, kernel, kernel, plain)."""
    for fn in (kernel_fn, plain_fn):
        fn()
    torch.cuda.synchronize()
    p1 = event_ms(plain_fn, iters)
    k1 = event_ms(kernel_fn, iters)
    k2 = event_ms(kernel_fn, iters)
    p2 = event_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def softmax_integral_with_chunks(hm, J, D, chunks):
    """Kernel 1's C entry with a chunk count of the caller's choosing (its
    planner never leaves a chunk empty): (coords, m, s)."""
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    B, H, W, C = hm.shape
    f32 = dict(dtype=torch.float32, device=hm.device)
    coords, m, s = (torch.empty(B, J, 3, **f32), torch.empty(B, J, **f32),
                    torch.empty(B, J, **f32))
    ws = torch.empty(B * chunks * C * 4, **f32)
    kernels.SOFTMAX_INTEGRAL_FWD(
        hm.data_ptr(), int(hm.dtype == torch.bfloat16), coords.data_ptr(),
        m.data_ptr(), s.data_ptr(), ws.data_ptr(), B, H, W, J, D, chunks,
        torch.cuda.current_stream().cuda_stream)
    return coords, m, s


def compare_warp(name, images, Hm, out_hw, normalise=None, inverse=False,
                 want_nan=None):
    """Kernel 5 (one launch, counted) against its plain version: bitwise,
    nan in the same places. `want_nan`: "all", "some" or "none" of the
    plain version's pixels must be nan (default: none). Returns the max
    abs difference over the pixels (0 when bitwise)."""
    from hand_integral_pose_estimation_tpu_torch.ops import kernels, warp
    before = kernels.WARP_TWOPASS.launches
    if normalise is None:
        got = warp.warp_perspective_cuda(images, Hm, out_hw, inverse)
    else:
        got = warp.warp_normalise_batch(images, Hm, out_hw, *normalise,
                                        inverse=inverse)
    torch.cuda.synchronize()
    launched = kernels.WARP_TWOPASS.launches - before
    if normalise is None:
        want = warp.warp_perspective_twopass(images, Hm, out_hw, inverse)
    else:
        want = warp.warp_normalise_twopass(images, Hm, out_hw, *normalise,
                                           inverse=inverse)
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = (got.shape == want.shape and got.dtype == want.dtype
            and bool(torch.equal(nan_g, nan_w))
            and bool(torch.equal(got[~nan_w], want[~nan_w])))
    e = float((got - want)[~nan_w].abs().max()) if same and bool(
        (~nan_w).any()) else (0.0 if same else math.inf)
    frac = float(nan_w.float().mean())
    nan_ok = {"all": frac == 1.0, "some": 0.0 < frac < 1.0,
              None: frac == 0.0}[want_nan]
    ok = same and launched == 1 and nan_ok and (
        frac == 1.0 or float(want[~nan_w].abs().sum()) > 0)
    print(f"[kernels] warp_twopass {name}: bitwise equal to the plain "
          f"version {same} (nan share {frac:.4f}), {launched} launch "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    check(ok, f"the warp kernel disagrees with its plain version ({name})")
    return e


def degenerate_maps(dev):
    """16 x 16 -> 16 x 16 maps (batch of 2) whose warp is all nan (a
    singular map, an exact 90-degree turn: e = h = 0 in pass A's divisor),
    partly nan (a horizon inside the output) or 0 on a column (a dst ->
    src map whose denominator is 0 there: positions at +-inf), as
    {name: (maps, inverse, nan share)}."""
    def two(H):
        return torch.tensor([H, H], device=dev)
    return {
        "singular": (two([[1.0, 2, 3], [2, 4, 6], [0, 0, 1]]), False, "all"),
        "90-degree": (two([[0.0, -1, 15], [1, 0, 0], [0, 0, 1]]), False,
                      "all"),
        "horizon": (two([[1.0, 0, 0], [0, 1, 0], [0.2, 0, 1]]), False,
                    "some"),
        "+-inf": (two([[1.0, 0.05, 0.5], [0.1, 1, 0.3], [-0.125, 0, 1]]),
                  True, None),
    }


def homographies(B, g, dev):
    """Rotation, anisotropic scale, translation and a little perspective,
    as the augmentation's crop-after-rotation maps are."""
    a = (torch.rand(B, generator=g, device=dev) - 0.5) * 1.0
    sc = 0.7 + 0.6 * torch.rand(B, 2, generator=g, device=dev)
    H = torch.zeros(B, 3, 3, device=dev)
    H[:, 0, 0] = sc[:, 0] * torch.cos(a)
    H[:, 0, 1] = -sc[:, 1] * torch.sin(a)
    H[:, 1, 0] = sc[:, 0] * torch.sin(a)
    H[:, 1, 1] = sc[:, 1] * torch.cos(a)
    H[:, :2, 2] = 6 * torch.randn(B, 2, generator=g, device=dev)
    H[:, 2, :2] = 2e-4 * torch.randn(B, 2, generator=g, device=dev)
    H[:, 2, 2] = 1.0
    return H


def scale_projection(model, images) -> None:
    """The reference init N(0, 0.001) leaves every joint's softmax flat and
    every decode near 0, where a broken kernel would still pass: scale the
    projection to a LOGIT_STD logit spread on these images instead, with
    the model in the mode it will run in."""
    with torch.no_grad():
        feats = model(images, return_features=True).float()
        rms = float(feats.pow(2).sum(-1).mean().sqrt())
    with torch.no_grad():
        final = model.head.final_layer
        final.weight.normal_(0.0, LOGIT_STD / rms,
                             generator=torch.Generator(
                                 images.device).manual_seed(SEED))
        final.bias.zero_()


def plain_decode(fuse: bool, dtype=None):
    """model, images -> coords through the plain decode: autograd
    differentiates its torch operations, no custom backward runs. With
    `dtype` the decode runs in that dtype (its gradient rounds back to the
    model's)."""
    from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
        head_projection_integral_reference,
    )
    from hand_integral_pose_estimation_tpu_torch.ops.integral import (
        softmax_integral_reference,
    )

    def cast(x):
        return x if dtype is None else x.to(dtype)

    def decode(model, images):
        J, D = model.cfg.num_joints, model.cfg.depth_dim
        if fuse:
            feats = model(images, return_features=True)
            w, b = model.final_projection()
            return head_projection_integral_reference(
                cast(feats), cast(w), cast(b), J, D)[0]
        return softmax_integral_reference(cast(model(images)), J, D)[0]

    return decode


def gradient_check(name, trainer, batch, fuse, leaf_tol, total_tol):
    """From the trainer's current state and one batch: the gradients of a
    plain-backed step (plain decode, then the same combined loss), of one
    whose plain decode runs in float64 (the same math rounded otherwise:
    the noise floor), and of the kernel-backed train step. Checks the loss,
    and the kernel-backed gradient against the plain one per leaf
    (leaf_tol) and whole (total_tol)."""
    from hand_integral_pose_estimation_tpu_torch import losses

    model, cfg = trainer.model, trainer.cfg
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    ph, pw = cfg.model.input_shape

    def plain(decode):
        model.train()
        out = losses.combined_loss(
            decode(model, batch.image), batch.label_teacher, batch.label,
            batch.label_weight, batch.labelled, batch.trans_inv,
            batch.tprime, batch.K, lam=cfg.train.lam, patch_width=pw,
            patch_height=ph)
        return out.loss.detach(), torch.autograd.grad(out.loss, params)

    def distance(ga, gb):
        worst, worst_name = 0.0, ""
        for n, a, b in zip(names, ga, gb):
            ref = float(b.norm())
            r = float((a - b).norm()) / ref if ref else float(a.norm())
            if r > worst:
                worst, worst_name = r, n
        total = float(torch.cat([(a - b).flatten() for a, b in zip(ga, gb)])
                      .norm()) / float(torch.cat([b.flatten() for b in gb])
                                       .norm())
        return total, worst, worst_name

    loss_p, gp = plain(plain_decode(fuse))
    _, g64 = plain(plain_decode(fuse, torch.float64))
    loss_k = float(trainer.train_step(batch)["loss"])
    gk = [p.grad for p in params]
    total, worst, worst_name = distance(gk, gp)
    f_total, f_worst, f_name = distance(g64, gp)
    d_loss = abs(loss_k - float(loss_p))
    print(f"[training] {name} arm, one batch from one state: loss "
          f"{loss_k:.6f} kernel-backed vs {float(loss_p):.6f} plain (|d| "
          f"{d_loss:.2e}); ||g_kernel - g_plain|| / ||g_plain|| whole "
          f"{total:.3e} (tol {total_tol:g}), worst leaf {worst:.3e} "
          f"({worst_name}, tol {leaf_tol:g}); float64-decode floor: whole "
          f"{f_total:.3e}, worst leaf {f_worst:.3e} ({f_name})", flush=True)
    check(d_loss <= 1e-4 * abs(float(loss_p)) + 1e-6,
          f"{name}: kernel-backed loss disagrees with the plain one")
    check(worst <= leaf_tol and total <= total_tol,
          f"{name}: kernel-backed gradients disagree with the plain ones "
          f"at {worst_name}")


def training_state(trainer) -> dict:
    """Parameters, buffers and Adam's state of a Trainer, by name."""
    out = dict(trainer.model.state_dict())
    for i, p in enumerate(trainer.model.parameters()):
        for k, v in trainer.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return out


def device_profile(fn, n: int):
    """`fn` called n times under torch.profiler: the device busy time per
    call (sum of kernel time) and the kernel rows (name, ms per call,
    launches per call), longest first. Kernel rows only: an operator's row
    repeats its kernels' device time, and a user annotation's device row
    (Adam's `Optimizer.step#Adam.step`) spans its kernels."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, getattr(e, "self_device_time_total", getattr(
        e, "self_cuda_time_total", 0.0)) / n / 1e3, e.count / n)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)),
        key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def device_kernels_per_call(fn) -> int:
    """Kernel nodes of one call of `fn` captured in a CUDA graph, read
    through libcuda (`kernels.graph_kernel_names`: `cuGraphGetNodes`
    and the nodes' function names): every device kernel the call issues,
    none dropped, as a profiler's event buffers may drop them."""
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return len(kernels.graph_kernel_names(graph))


def print_profile(title: str, fn, n: int, card: str, top: int = 12) -> None:
    busy, rows = device_profile(fn, n)
    print(f"[profile] {title}, {n} calls: device busy {busy:.3f} ms per "
          f"call (sum of kernel time), {sum(r[2] for r in rows):g} kernel "
          f"launches per call, on {card}; top kernels:", flush=True)
    for key, ms, count in rows[:top]:
        print(f"[profile]   {ms:8.3f} ms/call x{count:<6g} {key[:90]}",
              flush=True)


def issue_ms(fn, n: int = 5) -> float:
    """Median host time to issue one call of `fn`, the device idle at its
    start (host clock, a synchronize before each call)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def path_launches(*steps) -> dict[str, int]:
    """Kernel launches of a path since the counters were set to 0: the
    wrappers' counts (eager calls) plus, for each captured step, each
    graph's kernel nodes times its replays (read through libcuda)."""
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    out = {k.symbol: k.launches for k in kernels.KERNELS}
    for step in steps:
        for symbol, n in step.kernel_launches().items():
            out[symbol] += n
    return out


def compare_graph_timing(title, unit, eager_fn, replay, call, eager_per,
                         per_replay, card, n=20):
    """Eager against CUDA graph on one path, per `unit` (a replay runs
    `per_replay` of them): back to back on the host clock (the eager
    figure `eager_per` measured by the caller), the host time to issue one
    call with the device idle, device busy (profile: the sum of kernel
    time) and the CUDA-event time of one call; for the bare replay (inputs
    already in its static buffers, as the eager step's are on the card)
    and for the whole captured call (host batch packed and copied, replay,
    outputs copied)."""
    for _ in range(2):
        replay()
    torch.cuda.synchronize()
    rates = {}
    for name, fn in (("replay", replay), ("call", call)):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        rates[name] = (time.perf_counter() - t0) / n * 1e3 / per_replay
    issue_eager = issue_ms(eager_fn)
    issue_replay = issue_ms(replay) / per_replay
    issue_call = issue_ms(call) / per_replay
    busy_eager, _ = device_profile(eager_fn, 5)
    busy_graph, rows = device_profile(replay, 5)
    busy_graph /= per_replay
    kernels_graph = sum(r[2] for r in rows) / per_replay
    ev_graph = statistics.median(event_ms(replay, 1) for _ in range(10)) \
        / per_replay
    print(f"[graphs] {title}, eager against graph, per {unit}: back to "
          f"back {eager_per:.3f} ms eager, {rates['replay']:.3f} ms replay, "
          f"{rates['call']:.3f} ms whole call; host issue "
          f"{issue_eager:.3f} ms eager, {issue_replay:.3f} ms replay, "
          f"{issue_call:.3f} ms whole call; device busy {busy_eager:.3f} ms "
          f"eager, {busy_graph:.3f} ms graph ({kernels_graph:g} kernels "
          f"traced per {unit}); replay event time {ev_graph:.3f} ms; on "
          f"{card}", flush=True)


def backward_steps_ms(fn) -> dict[str, float]:
    """One call of the fused head's backward under torch.profiler: its
    device time by step, ms: the operands' split into bf16 planes (s),
    `channel_constants`' kernels, dfeat (a), the dW and db partials (b)
    and their sum (c)."""
    fn()
    torch.cuda.synchronize()
    _, rows = device_profile(fn, 1)
    out = {"(s)": 0.0, "channel_constants": 0.0, "(a)": 0.0, "(b)": 0.0,
           "(c)": 0.0}
    for key, ms, _ in rows:
        step = ("(s)" if "hp_split" in key else "(a)" if "hp_bwd_dfeat" in
                key else "(b)" if "hp_bwd_dweight" in key else "(c)" if
                "hp_bwd_reduce" in key else "channel_constants")
        out[step] += ms
    return out


def bound(bytes_moved: float, flops: float, flops_per_s: float = F32_FLOPS):
    """The least time for the work, ms, and what bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clustered_boxes(g, B, N, dev):
    """(B, N, 4) proposal-like boxes, clusters of 60 near-duplicates over a
    600-pixel image, and (B, N) scores."""
    k = max(N // 60, 1)
    centres = torch.rand(B, k, 2, generator=g, device=dev) * 500
    ctr = (centres.repeat_interleave(-(-N // k), dim=1)[:, :N]
           + torch.rand(B, N, 2, generator=g, device=dev) * 60)
    wh = torch.rand(B, N, 2, generator=g, device=dev) * 60 + 40
    return (torch.cat([ctr - wh / 2, ctr + wh / 2], -1),
            torch.rand(B, N, generator=g, device=dev))


def roi_tap_reads(rois, height, width, pooled, sr, scale):
    """Tap vectors (one per map position, all C channels) that kernel 6
    reads for these RoIs (per group of kBands = 7 pooled rows: the group's
    distinct tap rows times each bin column's distinct tap columns, taps of
    weight zero left out), and that a kernel reading every sample's taps
    would read (one CTA per bin: one to four per sample). Counted on the
    host from the kernel's sample rules."""
    bands = 7
    r = rois.reshape(-1, 4).cpu().numpy().astype(np.float32)
    s = np.arange(pooled * sr)

    def taps(lo, hi, size):
        lo = (lo * np.float32(scale)).astype(np.float32)
        bsz = (np.maximum((hi * np.float32(scale)).astype(np.float32) - lo,
                          1) / np.float32(pooled)).astype(np.float32)
        c = (lo[:, None] + (s // sr) * bsz[:, None] + (s % sr + 0.5)
             * (bsz / sr)[:, None]).astype(np.float32)
        inside = (c >= -1) & (c <= size)
        cc = np.clip(c, 0, size - 1)
        i0 = np.floor(cc)
        has1 = inside & (i0 + 1 <= size - 1)
        return (inside, i0.astype(np.int64), has1,
                has1 & (1 - (i0 + 1 - cc) != 0))

    def distinct(inside, i0, nz1, lo, hi):
        return len(set(i0[lo:hi][inside[lo:hi]])
                   | set(i0[lo:hi][nz1[lo:hi]] + 1))

    xin, x0, xh1, xnz1 = taps(r[:, 0], r[:, 2], width)
    yin, y0, yh1, ynz1 = taps(r[:, 1], r[:, 3], height)
    grouped = 0
    for k in range(r.shape[0]):
        cols = sum(distinct(xin[k], x0[k], xnz1[k], q * sr, (q + 1) * sr)
                   for q in range(pooled))
        grouped += cols * sum(
            distinct(yin[k], y0[k], ynz1[k], p * sr,
                     min(p + bands, pooled) * sr)
            for p in range(0, pooled, bands))
    per_sample = int(((1 + yh1).sum(1) * (1 + xh1).sum(1)).sum())
    return grouped, per_sample


@contextlib.contextmanager
def plain_detector_ops():
    """Route NMS and ROIAlign on the card through their plain versions (the
    kernel wrappers are swapped out for the duration)."""
    from hand_integral_pose_estimation_tpu_torch.ops import nms as nms_mod
    from hand_integral_pose_estimation_tpu_torch.ops import (
        roi_align as ra_mod,
    )
    saved = nms_mod._alive_cuda, ra_mod.roi_align_cuda
    nms_mod._alive_cuda = nms_mod._alive_plain
    ra_mod.roi_align_cuda = lambda f, r, p, sc, sr: ra_mod.roi_align_batched(
        f, r, p, sc, sr, impl="plain")
    try:
        yield
    finally:
        nms_mod._alive_cuda, ra_mod.roi_align_cuda = saved


@contextlib.contextmanager
def frozen_proposals():
    """Feed every training forward of the detector the proposals of the
    first one inside the block: the proposal layer still runs each step
    (kernel 7 launches as before) but its output is replaced by the first
    call's, detached. With the same draws each step the sampled RoIs, the
    anchor targets and so the objective stay fixed, and SGD descends one
    function of the weights."""
    from hand_integral_pose_estimation_tpu_torch.detect import (
        faster_rcnn as frcnn,
    )
    real = frcnn.proposal_layer
    first = []

    def fixed(*args, **kwargs):
        props = real(*args, **kwargs)
        if not first:
            first.append(type(props)(*(t.detach().clone() for t in props)))
        return first[0]

    frcnn.proposal_layer = fixed
    try:
        yield
    finally:
        frcnn.proposal_layer = real


def descent_margin(losses) -> float:
    """How far a loss trajectory falls, on phase 9c's two conditions: the
    smaller of first - last and the mean of the first three less that of
    the last three (> 0: it falls)."""
    return min(losses[0] - losses[-1],
               (sum(losses[:3]) - sum(losses[-3:])) / 3)


@contextlib.contextmanager
def plain_roi_align_backward():
    """Run kernel 6's backward through the plain VJP instead of its
    backward kernel (the forward kernel stays)."""
    from hand_integral_pose_estimation_tpu_torch.ops import (
        roi_align as ra_mod,
    )
    saved = ra_mod.roi_align_bwd_cuda
    ra_mod.roi_align_bwd_cuda = ra_mod.roi_align_bwd_plain
    try:
        yield
    finally:
        ra_mod.roi_align_bwd_cuda = saved


@contextlib.contextmanager
def roi_align_backward_held():
    """Hold every launch of kernel 6's backward kernel to the plain VJP on
    the same cotangent and RoIs; yields the list of max|d| / max|plain|,
    one entry a launch. The kernel's result is what the caller gets."""
    from hand_integral_pose_estimation_tpu_torch.ops import (
        roi_align as ra_mod,
    )
    saved = ra_mod.roi_align_bwd_cuda
    errors = []

    def held(g, rois, feature_hw, *args):
        got = saved(g, rois, feature_hw, *args)
        want = ra_mod.roi_align_bwd_plain(g, rois, feature_hw, *args)
        errors.append(float((got - want).abs().max())
                      / max(float(want.abs().max()), 1e-30))
        return got

    ra_mod.roi_align_bwd_cuda = held
    try:
        yield errors
    finally:
        ra_mod.roi_align_bwd_cuda = saved


def calibrate_frozen_batchnorm(model, blob) -> None:
    """Set each BatchNorm's running statistics to those of its own input
    on `blob`, in one eval forward: a hook sets them just before the layer
    normalises, so every later layer sees the normalised activations of
    the layers before it. The frozen statistics of a trained detector play
    this part; random weights with unit statistics have none."""
    def hook(m, args):
        x = args[0].float()
        m.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        m.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        model.eval()
        with torch.no_grad():
            model(blob)
    finally:
        for h in handles:
            h.remove()


def scale_detector_heads(model, blob) -> None:
    """Random weights saturate both class softmaxes on these scenes (every
    score 0 or 1, so NMS would order ties only) and give box deltas so
    large that every proposal is clipped to a sliver and filtered: scale
    the RPN's and the detection head's class and box layers, in place, to
    unit-spread logits and deltas of a trained detector's spread (0.2 for
    the RPN; 1, before the 0.1 / 0.2 normalisation stds, for the head)."""
    from hand_integral_pose_estimation_tpu_torch.ops.roi_align import (
        roi_align_batched,
    )

    c = model.cfg
    rpn = model.RCNN_rpn
    with torch.inference_mode():
        t = torch.relu(rpn.RPN_Conv(model.RCNN_base(blob.permute(0, 3, 1,
                                                                  2))))
        spread = [(rpn.RPN_cls_score, float(rpn.RPN_cls_score(t).std()), 1.0),
                  (rpn.RPN_bbox_pred, float(rpn.RPN_bbox_pred(t).std()), 0.2)]
    for m, std, want in spread:
        with torch.no_grad():
            m.weight.mul_(want / std)
            m.bias.mul_(want / std)
    with torch.inference_mode():
        feats, rois, _ = model.upstream(blob)
        B, R = rois.shape[:2]
        pooled = roi_align_batched(feats.float().contiguous(), rois,
                                   c.pooling_size, c.spatial_scale,
                                   c.sampling_ratio)
        h = model.RCNN_top(pooled.reshape(
            B * R, c.pooling_size, c.pooling_size, -1).permute(
                0, 3, 1, 2)).mean(dim=(2, 3))
        spread = [(model.RCNN_cls_score,
                   float(model.RCNN_cls_score(h).std()), 1.0),
                  (model.RCNN_bbox_pred,
                   float(model.RCNN_bbox_pred(h).std()), 1.0)]
    for m, std, want in spread:
        with torch.no_grad():
            m.weight.mul_(want / std)
            m.bias.mul_(want / std)


def detection_phase(dev, g, card, cfg):
    """Phase 7. Returns the launches of the counted runs by kernel symbol,
    and for "roi_align" and "nms" (max_abs_err, (ms, plain_ms),
    (bound_ms, bound_by))."""
    from hand_integral_pose_estimation_tpu_torch.cli import evaluate as cli
    from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
    from hand_integral_pose_estimation_tpu_torch.data import (
        SyntheticFreiHand,
        apply_filtered_labels,
    )
    from hand_integral_pose_estimation_tpu_torch.data.detector_db import (
        _record_names,
    )
    from hand_integral_pose_estimation_tpu_torch.detect import (
        build_detector,
        detect,
        detect_split,
        hand_detector,
        make_synthetic_box_dataset,
        prepare_blob,
        proposal_layer,
    )
    from hand_integral_pose_estimation_tpu_torch.inference import (
        TwoStagePipeline,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.ops import nms as nms_mod
    from hand_integral_pose_estimation_tpu_torch.ops.roi_align import (
        roi_align_batched,
    )

    # ---- a. kernel 7 against its plain version
    worst_nms = 0
    i = torch.arange(1100, device=dev, dtype=torch.float32)
    chain = torch.stack([4 * i, 0 * i, 4 * i + 10, 0 * i + 10], -1)[None]
    cases = [("chain", chain, torch.linspace(1.0, 0.5, 1100, device=dev)[
        None], 0.3, 1100, -math.inf)]
    for B, N, thr, top_k, st in ((DET_BATCH, 6000, 0.7, 300, 0.0),
                                 (DET_BATCH, 300, 0.3, 100, 0.001)):
        b, sc = clustered_boxes(g, B, N, dev)
        cases.append((f"clustered {(B, N)}", b, sc, thr, top_k, st))
    for name, b, sc, thr, top_k, st in cases:
        for ee in (False, True):
            got = nms_mod.nms(b, sc, thr, top_k, st, impl="cuda",
                              early_exit=ee)
            torch.cuda.synchronize()
            want = nms_mod.nms(b, sc, thr, top_k, st, impl="plain",
                               early_exit=ee)
            bad = (int((got[2] != want[2]).sum())
                   + int((got[0] != want[0]).any(-1).sum())
                   + int((got[1] != want[1]).sum()))
            kept = int(got[2].sum())
            print(f"[detection] nms {name} -> {top_k} at IoU {thr}, score "
                  f"threshold {st}, early_exit={ee}: {kept} kept, "
                  f"{bad} mismatching slots (tol 0) "
                  f"{'ok' if bad == 0 else 'FAILED'}", flush=True)
            check(bad == 0, f"NMS kernel disagrees with its plain version "
                  f"({name}, early_exit={ee})")
            if name == "chain":
                check(kept == 550 and bool(torch.equal(
                    got[0][0, :550], chain[0, ::2])),
                    "NMS kernel misses the chain's known answer")
            worst_nms = max(worst_nms, bad)

    # ---- b. kernel 6 against its plain version
    worst_roi = 0.0
    path_roi = None
    for (B, H, W, C, R) in ((DET_BATCH, 38, 38, 1024, 300),
                            (2, 21, 19, 256, 13), (3, 9, 11, 6, 7)):
        feats = torch.randn(B, H, W, C, device=dev, generator=g)
        lo = torch.rand(B, R, 2, device=dev, generator=g) * torch.tensor(
            [16.0 * W, 16.0 * H], device=dev) - 40
        rois = torch.cat([lo, lo + torch.rand(B, R, 2, device=dev,
                                               generator=g) * 300 + 4], -1)
        got = roi_align_batched(feats, rois, 7, 1 / 16.0, 2, impl="cuda")
        torch.cuda.synchronize()
        want = roi_align_batched(feats, rois, 7, 1 / 16.0, 2, impl="plain")
        e = float((got - want).abs().max())
        tol = ROI_TOL * max(1.0, float(feats.abs().max()))
        print(f"[detection] roi_align {(B, H, W, C)} x {R} RoIs: max|d| "
              f"{e:.3e} (tol {tol:.3e}) {'ok' if e <= tol else 'FAILED'}",
              flush=True)
        check(e <= tol and float(want.abs().sum()) > 0,
              "ROIAlign kernel disagrees with its plain version")
        worst_roi = max(worst_roi, e)
        if path_roi is None:
            path_roi = (feats, rois)
        del got, want

    # ---- c. the detector at full width on four 600^2 scenes
    det_cfg = dataclasses.replace(DetectorConfig(), resnet_style="caffe")
    t0 = time.perf_counter()
    model = build_detector(det_cfg, generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    scenes = make_synthetic_box_dataset(
        DET_BATCH, hw=(DET_SIZE, DET_SIZE), min_size=int(DET_SIZE * 0.25),
        max_size=int(DET_SIZE * 0.62), seed=SEED)
    images = torch.from_numpy(scenes.images).to(dev)
    blob, scale = prepare_blob(images, det_cfg)
    scale_detector_heads(model, blob)
    torch.cuda.synchronize()
    print(f"[detection] built R{det_cfg.resnet_type} {det_cfg.resnet_style} "
          f"detector, {sum(p.numel() for p in model.parameters())} params, "
          f"and {DET_BATCH} scenes of {DET_SIZE}^2 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    with torch.inference_mode():
        props_valid = model.upstream(blob)[2].sum(1).tolist()
    print(f"[detection] valid proposals per scene {props_valid} of "
          f"{det_cfg.rpn_post_nms_top_n_test}", flush=True)

    for k in kernels.KERNELS:
        k.launches = 0
    det = detect(model, images)
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels.KERNELS}
    want_counts = {k.symbol: {kernels.ROI_ALIGN_FWD: 1, kernels.NMS: 2}.get(
        k, 0) for k in kernels.KERNELS}
    print(f"[detection] one detect: launches {counts}", flush=True)
    check(counts == want_counts, f"detect launches {counts}, expected "
          f"{want_counts}")
    split = detect_split(model, images)
    same_split = all(torch.equal(a, b) for a, b in zip(det, split))
    for k in kernels.KERNELS:
        k.launches = 0
    with plain_detector_ops():
        plain = detect(model, images)
        torch.cuda.synchronize()
    plain_launches = sum(k.launches for k in kernels.KERNELS)
    crop = hand_detector._crop_from_detections(det, (DET_SIZE, DET_SIZE),
                                               1.75)
    crop_plain = hand_detector._crop_from_detections(
        plain, (DET_SIZE, DET_SIZE), 1.75)
    keep_same = bool(torch.equal(det.valid, plain.valid))
    d_crop = float((crop - crop_plain).abs().max())
    d_box = float((det.boxes - plain.boxes).abs().max())
    tol_crop = BOX_TOL_ABS + BOX_TOL_REL * float(crop_plain.abs().max())
    tol_box = BOX_TOL_ABS + BOX_TOL_REL * float(plain.boxes.abs().max())
    print(f"[detection] {int(det.valid.sum())} detections over "
          f"{DET_BATCH} scenes (per scene {det.valid.sum(1).tolist()}), "
          f"best scores {[round(v, 4) for v in det.scores[:, 0].tolist()]}; "
          f"detect_split equal to detect: {same_split}; kernel-backed vs "
          f"plain-backed detect ({plain_launches} kernel launches in the "
          f"plain run): keep sets equal {keep_same}, max|d boxes| "
          f"{d_box:.3e} (tol {tol_box:.3e}), max|d crop| {d_crop:.3e} (tol "
          f"{tol_crop:.3e})", flush=True)
    check(same_split, "detect_split disagrees with detect")
    check(plain_launches == 0, "the plain-backed detect launched a kernel")
    check(keep_same and d_crop <= tol_crop and d_box <= tol_box,
          "the kernel-backed detect disagrees with the plain-backed one")
    check(int(det.valid.sum()) > 0 and bool(torch.isfinite(crop).all()),
          "the detector found nothing")
    gt = np.stack([b[0] for b in scenes.gt_boxes])
    print(f"[detection] crop boxes (cx, cy, w, h) {crop.tolist()}; scene "
          f"GT boxes {gt.tolist()} (random weights: no accuracy expected)",
          flush=True)

    # ---- d. the two-stage pipeline and the challenge CLI
    pose = get_pose_net(cfg.model,
                        generator=torch.Generator().manual_seed(SEED))
    pcfg = cfg.replace(detector=det_cfg)
    pipe = TwoStagePipeline(pcfg, pose, model, device=dev)
    frames = SyntheticFreiHand(n=PIPE_FRAMES, render_joints=True, seed=SEED)
    n_batches = PIPE_FRAMES // DET_BATCH
    for k in kernels.KERNELS:
        k.launches = 0
    outs = []
    for b in range(n_batches):
        host = frames.host_batch(np.arange(b * DET_BATCH,
                                           (b + 1) * DET_BATCH))
        outs.append(pipe(host["image"], host["K"], host["ref_bone_len"]))
    torch.cuda.synchronize()
    pipe_counts = {k.symbol: k.launches for k in kernels.KERNELS}
    want_counts = {k.symbol: {kernels.ROI_ALIGN_FWD: n_batches,
                              kernels.NMS: 2 * n_batches,
                              kernels.HEAD_PROJECTION_INTEGRAL_FWD: n_batches
                              }.get(k, 0) for k in kernels.KERNELS}
    joints = torch.cat([o.joints_cam for o in outs])
    print(f"[detection] TwoStagePipeline swept {PIPE_FRAMES} frames of 224^2 "
          f"in {n_batches} batches of {DET_BATCH}: joints_cam "
          f"{tuple(joints.shape)} finite {bool(torch.isfinite(joints).all())}"
          f", crop boxes {torch.cat([o.crop_bbox for o in outs]).tolist()}; "
          f"launches {pipe_counts}", flush=True)
    check(pipe_counts == want_counts, f"pipeline launches {pipe_counts}, "
          f"expected {want_counts}")
    check(joints.shape == (PIPE_FRAMES, 21, 3)
          and bool(torch.isfinite(joints).all()), "pipeline joints")
    with tempfile.TemporaryDirectory() as d:
        for k in kernels.KERNELS:
            k.launches = 0
        preds = cli.main(["--synthetic", "--synthetic-size", str(PIPE_FRAMES),
                          "--batch-size", str(DET_BATCH), "--use-detector",
                          "--model-dir", os.path.join(d, "none"),
                          "--result-dir", d, "--bbox-db",
                          os.path.join(d, "bbox.npz"), "--device", "cuda"])
        torch.cuda.synchronize()
        cli_counts = {k.symbol: k.launches for k in kernels.KERNELS}
        with open(os.path.join(d, "pred.json")) as f:
            xyz = np.asarray(json.load(f)[0])
    print(f"[detection] cli.evaluate --synthetic --use-detector --device "
          f"cuda wrote pred.json with {xyz.shape} joints, finite "
          f"{bool(np.isfinite(xyz).all())}; launches {cli_counts}",
          flush=True)
    check(xyz.shape == (PIPE_FRAMES, 21, 3) and np.isfinite(xyz).all()
          and np.allclose(xyz, preds), "cli.evaluate's pred.json")
    check(cli_counts == want_counts, f"cli launches {cli_counts}")

    # ---- e. timing
    # kernel 7 at both of detect's shapes (the RPN's and the class NMS's),
    # its device time split into the mask and sweep launches from a
    # profile. Bound from this run's inputs: the greedy result needs the
    # IoU of each kept box with every later box (~17 float32 operations
    # each); its bytes (boxes and flags in, keep flags out) are negligible.
    # The sweep's serial chain of one resolve per 64-box block is outside
    # any throughput bound.
    nms_timing = {}
    for label, (_, b, sc, thr, top_k, st) in (("RPN", cases[1]),
                                              ("class NMS", cases[2])):
        order = torch.sort(sc, dim=1, descending=True, stable=True).indices
        b_sorted = torch.gather(b, 1, order[..., None].expand_as(b))
        alive0 = torch.gather(sc, 1, order) > st
        t = time_pair(
            lambda: nms_mod._alive_cuda(b_sorted, alive0, thr, True),
            lambda: nms_mod._alive_plain(b_sorted, alive0, thr, True))
        t_call = time_pair(
            lambda: nms_mod.nms(b, sc, thr, top_k, st, impl="cuda"),
            lambda: nms_mod.nms(b, sc, thr, top_k, st, impl="plain"))
        _, rows = device_profile(
            lambda: nms_mod._alive_cuda(b_sorted, alive0, thr, True), 20)
        mask_ms = sum(ms for key, ms, _ in rows if "nms_mask_kernel" in key)
        sweep_ms = sum(ms for key, ms, _ in rows if "nms_sweep_kernel" in key)
        B, N = sc.shape
        blocks = math.ceil(N / 64)
        keep = nms_mod._alive_plain(b_sorted, alive0, thr, True)
        pos = torch.arange(N, device=dev)
        pairs = float(((N - 1 - pos) * keep).sum())
        nms_b = bound(b.numel() * 4 + alive0.numel() * 2, 17 * pairs)
        nms_timing[label] = (t, nms_b)
        print(f"[timing] nms kernel (mask + sweep) at the {label} shape "
              f"{tuple(b.shape)} IoU {thr}, {int(keep.sum())} kept: "
              f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, bound {nms_b[0]:.4f} ms "
              f"({nms_b[1]}); device time (profile, 20 calls) mask "
              f"{mask_ms:.4f} ms + sweep {sweep_ms:.4f} ms, the sweep "
              f"{sweep_ms / blocks * 1e3:.3f} us per 64-box block visited "
              f"({blocks} per image, {B} images at once); whole nms() with "
              f"sort and compaction {t_call[0]:.4f} ms, plain "
              f"{t_call[1]:.4f} ms on {card}", flush=True)
    t_nms, nms_bound = nms_timing["RPN"]

    feats, rois = path_roi
    t_roi = time_pair(
        lambda: roi_align_batched(feats, rois, 7, 1 / 16.0, 2, impl="cuda"),
        lambda: roi_align_batched(feats, rois, 7, 1 / 16.0, 2, impl="plain"))
    H, W, C = feats.shape[1:]
    taps, taps_per_sample = roi_tap_reads(rois, H, W, 7, 2, 1 / 16.0)
    out_elems = rois.shape[0] * rois.shape[1] * 49 * C
    print(f"[timing] roi_align at {tuple(feats.shape)} x {rois.shape[1]} "
          f"RoIs: kernel {t_roi[0]:.4f} ms, plain {t_roi[1]:.4f} ms on "
          f"{card}; tap reads {taps * C * 4 / 1e9:.4f} GB "
          f"({taps * C / out_elems:.3f} per output element; reading every "
          f"sample's taps: {taps_per_sample * C * 4 / 1e9:.4f} GB, "
          f"{taps_per_sample * C / out_elems:.3f} per element)", flush=True)
    roi_bound = bound(feats.numel() * 4 + rois.numel() * 4 + out_elems * 4,
                      out_elems * 4 * 10)

    def one_call_ms(fn, n=10):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        return statistics.median(event_ms(fn, 1) for _ in range(n))

    t_detect = one_call_ms(lambda: detect(model, images))
    t_split = one_call_ms(lambda: detect_split(model, images))
    t_split2 = one_call_ms(lambda: detect_split(model, images))
    t_detect2 = one_call_ms(lambda: detect(model, images))
    print(f"[timing] detect, R{det_cfg.resnet_type} float32 at batch "
          f"{DET_BATCH} x {DET_SIZE}^2, one call at a time (CUDA events, "
          f"median of 10): {t_detect:.3f} / {t_detect2:.3f} ms; "
          f"detect_split {t_split:.3f} / {t_split2:.3f} ms (turns: detect, "
          f"split, split, detect); {DET_BATCH / t_detect * 1e3:.1f} img/s "
          f"on {card}", flush=True)

    # the detector's stages, one at a time between CUDA events
    c = det_cfg
    with torch.inference_mode():
        blob, scale = prepare_blob(images, c)
        x = blob.permute(0, 3, 1, 2)
        f = model.RCNN_base(x)
        cls, reg = model.RCNN_rpn(f)
        feats_d = f.permute(0, 2, 3, 1)
        anchors = model.anchors(feats_d.shape[1:3], dev)
        props = proposal_layer(cls.permute(0, 2, 3, 1),
                               reg.permute(0, 2, 3, 1), anchors,
                               blob.shape[1:3], c.rpn_pre_nms_top_n_test,
                               c.rpn_post_nms_top_n_test, c.rpn_nms_thresh,
                               c.rpn_min_size)
        B, R = props.rois.shape[:2]
        pooled = roi_align_batched(feats_d.float().contiguous(), props.rois,
                                   7, c.spatial_scale, c.sampling_ratio)
        xt = pooled.reshape(B * R, 7, 7, -1).permute(0, 3, 1, 2)
        out = model.downstream(feats_d, props.rois, props.valid)
        stages = {
            "blob (BGR, means, 2 matmuls)": lambda: prepare_blob(images, c),
            "base conv1..layer3": lambda: model.RCNN_base(x),
            "RPN convs": lambda: model.RCNN_rpn(f),
            "proposal layer (softmax, decode, sort, NMS)": lambda:
                proposal_layer(cls.permute(0, 2, 3, 1),
                               reg.permute(0, 2, 3, 1), anchors,
                               blob.shape[1:3], c.rpn_pre_nms_top_n_test,
                               c.rpn_post_nms_top_n_test, c.rpn_nms_thresh,
                               c.rpn_min_size),
            "ROIAlign": lambda: roi_align_batched(
                feats_d.float().contiguous(), props.rois, 7,
                c.spatial_scale, c.sampling_ratio),
            "tail layer4 + heads": lambda: model.RCNN_cls_score(
                model.RCNN_top(xt).mean(dim=(2, 3))),
            "postprocess (decode, class NMS)": lambda:
                hand_detector._postprocess(out, c, blob.shape[1:3], scale),
        }
        stage_ms = {name: one_call_ms(fn, 5) for name, fn in stages.items()}
        host = frames.host_batch(np.arange(DET_BATCH))
        d_img = torch.from_numpy(host["image"]).to(dev)
        d_K = torch.from_numpy(host["K"]).to(dev)
        d_ref = torch.from_numpy(host["ref_bone_len"]).to(dev)
        bbox = hand_detector.detect_hand_crop_bbox(model, d_img, c)
        stage_ms["pose stage (crop, R50, fused head, back-projection)"] = \
            one_call_ms(lambda: pipe._pose_stage(d_img, bbox, d_K, d_ref), 5)
    print("[timing] detector stages at batch {} x {}^2, one at a time "
          "(CUDA events, median of 5): {} on {}".format(
              DET_BATCH, DET_SIZE, ", ".join(
                  f"{k} {v:.3f} ms" for k, v in stage_ms.items()), card),
          flush=True)

    print_profile(f"TwoStagePipeline at batch {DET_BATCH}",
                  lambda: pipe(host["image"], host["K"], host["ref_bone_len"]),
                  3, card)

    for _ in range(2):
        pipe(host["image"], host["K"], host["ref_bone_len"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        pipe(host["image"], host["K"], host["ref_bone_len"])
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / 10 * 1e3
    print(f"[timing] TwoStagePipeline back to back (host batches of "
          f"{DET_BATCH} frames 224^2 -> 600^2 blobs -> R101 detector -> R50 "
          f"pose): {per:.3f} ms/batch over 10 batches (host clock), "
          f"{DET_BATCH / per * 1e3:.1f} img/s on {card}", flush=True)

    launches = {k: pipe_counts[k] + cli_counts[k] + counts[k]
                for k in pipe_counts}
    return launches, {
        "roi_align": (worst_roi, t_roi, roi_bound),
        "nms": (float(worst_nms), t_nms, nms_bound),
    }


def semi_supervised_phase(dev, g, card, cfg):
    """Phase 8: PANet on the card against the CPU and trained; the teacher
    sweep kernel-backed against plain-backed, and its cascade; the student
    with a live teacher and the PANet term, then with a pseudo-label db,
    eager and as graph replays. Returns the launches of the phase's main
    runs (the PANet training, the kernel-backed sweeps, the student's
    counted and replayed steps)."""
    from hand_integral_pose_estimation_tpu_torch.cli import panet_data
    from hand_integral_pose_estimation_tpu_torch.data import (
        SyntheticFreiHand,
        apply_filtered_labels,
    )
    from hand_integral_pose_estimation_tpu_torch.data.detector_db import (
        _record_names,
    )
    from hand_integral_pose_estimation_tpu_torch.distill import (
        CascadeRunner,
        generate_filtered_labels,
        sweep_patches,
    )
    from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels \
        import camera_project
    from hand_integral_pose_estimation_tpu_torch.geometry import bbox as bb
    from hand_integral_pose_estimation_tpu_torch.models import (
        get_pose_net,
        panet,
    )
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
        head_projection_integral_reference,
    )
    from hand_integral_pose_estimation_tpu_torch.training import Trainer
    from hand_integral_pose_estimation_tpu_torch.training.panet_trainer \
        import train_panet
    from hand_integral_pose_estimation_tpu_torch.training.teacher import (
        frozen_teacher,
    )

    launches = {k.symbol: 0 for k in kernels.KERNELS}
    J, D = cfg.model.num_joints, cfg.model.depth_dim
    IH, IW = cfg.model.input_shape
    fwd, bwd, warp = (kernels.HEAD_PROJECTION_INTEGRAL_FWD,
                      kernels.HEAD_PROJECTION_INTEGRAL_BWD,
                      kernels.WARP_TWOPASS)

    def reset():
        for k in kernels.KERNELS:
            k.launches = 0

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) PANet at DEFAULT_DICT_SIZES: clouds from cli.panet_data
    # --synthetic, trained on the card, then its forward and gradient at
    # batch 500 against the same module on the CPU at float64
    with tempfile.TemporaryDirectory() as tmp:
        train_pts, test_pts = panet_data.main([
            "--synthetic", "--synthetic-size", str(PANET_CLOUDS),
            "--out-dir", tmp, "--device", "cuda"])
    train_pts = train_pts - train_pts.mean(1, keepdims=True)
    test_pts = test_pts - test_pts.mean(1, keepdims=True)
    prior = panet.PANet(generator=torch.Generator().manual_seed(SEED)).to(dev)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_panet(prior, train_pts, test_pts, num_steps=PANET_STEPS,
                      batch_size=PANET_BATCH, eval_every=PANET_STEPS // 4,
                      seed=SEED)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / PANET_STEPS * 1e3
    add({k.symbol: k.launches for k in kernels.KERNELS})
    losses_ = [round(float(v), 6) for v in res.train_losses]
    print(f"[semi] PANet {panet.DEFAULT_DICT_SIZES} trained {PANET_STEPS} "
          f"steps at batch {PANET_BATCH} on {len(train_pts)} cli.panet_data "
          f"--synthetic clouds: mean train loss per {PANET_STEPS // 4} "
          f"steps {losses_}, val {[round(float(v), 6) for v in res.val_losses]}"
          f"; {per_step:.3f} ms/step (host clock, eager) on {card}",
          flush=True)
    check(bool(np.isfinite(res.train_losses).all())
          and res.train_losses[-1] < res.train_losses[0],
          f"PANet training did not lower its loss: {losses_}")
    cpu = panet.PANet()
    cpu.load_state_dict({k: v.cpu() for k, v in prior.state_dict().items()})
    cpu = cpu.double()
    pts = torch.from_numpy(test_pts[:PANET_BATCH]).double()
    with torch.no_grad():
        want = cpu(pts)
        got = prior(pts.float().to(dev))
    err_fwd = max(float((x.double().cpu() - w).abs().max())
                  / float(w.abs().max()) for x, w in zip(got, want))
    panet.panet_loss(cpu, pts)[0].backward()
    prior.zero_grad()
    panet.panet_loss(prior, pts.float().to(dev))[0].backward()
    err_grad = max(float((pg.grad.double().cpu() - pc.grad).abs().max())
                   / max(float(pc.grad.abs().max()), 1e-30)
                   for pc, pg in zip(cpu.parameters(), prior.parameters()))
    cam = got[2].detach().double()
    orth = float((cam @ cam.mT - torch.eye(3, device=dev,
                                           dtype=cam.dtype)).abs().max())
    det = float((torch.linalg.det(cam) - 1).abs().max())
    print(f"[semi] PANet on the card (float32) vs the CPU (float64) at batch "
          f"{PANET_BATCH}: outputs max|d| / max {err_fwd:.3e} (tol "
          f"{PANET_TOL:g}), parameter gradients {err_grad:.3e} (tol "
          f"{PANET_GRAD_TOL:g}); cameras |R R^T - I| {orth:.2e}, |det - 1| "
          f"{det:.2e}", flush=True)
    check(err_fwd <= PANET_TOL and err_grad <= PANET_GRAD_TOL,
          "PANet on the card disagrees with the CPU")
    check(orth <= 1e-5 and det <= 1e-5, "PANet cameras are not rotations")
    prior.zero_grad(set_to_none=True)
    prior.requires_grad_(False)
    recon = panet.panet_reconstruction_fn(prior)

    # (b) the teacher sweep: a frozen R50 teacher (seeded, head scaled as in
    # phase 4) over 8 images x 21 rotations (168 crops), factored mode
    train_data = SyntheticFreiHand(n=2 * BATCH, render_joints=True,
                                   seed=SEED)
    teacher_net = get_pose_net(
        cfg.model, generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    teacher = frozen_teacher(teacher_net, cfg)

    def sweep_inputs(idx, data=train_data):
        host = data.host_batch(idx)
        images, K, joints, labelled = (
            torch.from_numpy(np.ascontiguousarray(host[k])).to(dev)
            for k in ("image", "K", "joint_cam", "labelled"))
        uv, _, _ = camera_project(joints, K)
        box = bb.bbox_from_keypoints(uv, torch.ones_like(uv[..., 0]),
                                     pad_factor=cfg.augment.pad_factor)
        return images, K, box, labelled, joints

    args = sweep_inputs(np.arange(SWEEP_BATCH))
    thetas = np.linspace(-cfg.train.teacher_rotation_range,
                         cfg.train.teacher_rotation_range,
                         cfg.train.teacher_num_rotations)
    patch_args = (args[0], args[1], args[2], cfg.augment, thetas,
                  cfg.train.teacher_rotation_range, (IH, IW))
    with torch.no_grad():
        scale_projection(teacher_net, sweep_patches(*patch_args)[:BATCH])
    fast = sweep_patches(*patch_args)
    plain = sweep_patches(*patch_args, method="twopass")
    same = torch.equal(fast, plain)
    print(f"[semi] sweep crops {tuple(fast.shape)} (float32 320^2 bases -> "
          f"224^2, kernel 5 with its epilogue) bitwise equal to the plain "
          f"two-pass chain: {same}", flush=True)
    check(same, "the sweep's crops differ from the plain chain's")
    del fast, plain

    def plain_teacher(patches):
        feats = teacher_net(patches, return_features=True)
        w, b = teacher_net.final_projection()
        return head_projection_integral_reference(feats, w, b, J, D)[0]

    unl = torch.zeros_like(args[3])
    with torch.no_grad():
        want = generate_filtered_labels(plain_teacher, args[0], args[1],
                                        args[2], unl, args[4],
                                        method="twopass")
    var = want.variance.sort().values
    mid = SWEEP_BATCH // 2
    threshold = float((var[mid - 1] * var[mid]).sqrt())
    reset()
    got = generate_filtered_labels(teacher, args[0], args[1], args[2], unl,
                                   args[4], variance_threshold=threshold)
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels.KERNELS}
    add(counts)
    err_sweep = float((got.per_rotation - want.per_rotation).abs().max())
    near = int((torch.abs(want.variance / threshold - 1) < KEEP_MARGIN).sum())
    keep_want = want.variance < threshold
    print(f"[semi] teacher sweep, {SWEEP_BATCH} x "
          f"{len(thetas)} crops, kernel-backed vs plain-backed: per-rotation "
          f"camera coords max|d| {err_sweep:.3e} (tol {COORD_TOL:g}); keep "
          f"set at a threshold {threshold:.3e} between the middle variances "
          f"{got.keep.int().tolist()} vs {keep_want.int().tolist()} ({near} "
          f"rows within {KEEP_MARGIN:g} of it); launches {counts}",
          flush=True)
    check(err_sweep <= COORD_TOL, "the kernel-backed sweep disagrees")
    check(counts == {k.symbol: int(k in (fwd, warp))
                     for k in kernels.KERNELS},
          f"sweep launches {counts}, expected one of kernels 3 and 5")
    check(near == 0 and torch.equal(got.keep, keep_want)
          and 0 < int(keep_want.sum()) < SWEEP_BATCH,
          "the kernel-backed keep set differs from the plain one")
    runner = CascadeRunner(teacher, cfg.augment, variance_threshold=threshold,
                           pass2_batch=SWEEP_BATCH, device=dev)
    runner.add_batch(args[0], args[1], args[2], unl, args[4],
                     rows=np.arange(SWEEP_BATCH))
    merged = runner.finalize(SWEEP_BATCH)
    print(f"[semi] CascadeRunner (5 rotations in pass 1): keep "
          f"{merged['keep'].astype(int).tolist()}, stats {runner.stats}",
          flush=True)
    check(np.array_equal(merged["keep"], got.keep.cpu().numpy()),
          "the cascade's keep set differs from the single pass's")

    def sweep():
        generate_filtered_labels(teacher, *args[:3], unl, args[4])

    sweep()
    times = [event_ms(sweep, 1) for _ in range(5)]
    busy, rows = device_profile(sweep, 3)
    warp_ms = sum(ms for key, ms, _ in rows if "warp_kernel" in key)
    print(f"[semi] teacher sweep per batch of {SWEEP_BATCH} x {len(thetas)} "
          f"crops: median {statistics.median(times):.3f} ms (events, min "
          f"{min(times):.3f}); device busy {busy:.3f} ms, of which kernel 5 "
          f"{warp_ms:.3f} ms; on {card}", flush=True)

    # the pseudo-label db over the student's split as records (the
    # synthetic samples' images in memory for the JPEGs), in the CLI's
    # schema, attached as `--filtered-db` attaches it
    filtered = train_data.as_records(cfg)
    out = {k: [] for k in ("joint_cam_normalized", "tprime", "variance",
                           "keep", "labelled")}
    reset()
    for start in range(0, len(filtered), SWEEP_BATCH):
        a = sweep_inputs(np.arange(start, start + SWEEP_BATCH), filtered)
        r = generate_filtered_labels(teacher, *a, variance_threshold=threshold)
        for k in ("joint_cam_normalized", "tprime", "variance", "keep"):
            out[k].append(getattr(r, k).cpu().numpy())
        out["labelled"].append(a[3].cpu().numpy())
    add({k.symbol: k.launches for k in kernels.KERNELS})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "filtered.npz")
        np.savez(path, name=_record_names(filtered),
                 **{k: np.concatenate(v) for k, v in out.items()})
        apply_filtered_labels(filtered, path)
    print(f"[semi] pseudo-label db over {len(train_data)} samples: "
          f"{len(filtered)} kept ({filtered.num_labelled} labelled)",
          flush=True)
    check(0 < len(filtered) < len(train_data), "the db keeps all or none")

    # the float32 teacher through its CLI (`--teacher-dtype float32`): each
    # batch's 8 x 21 crops on kernel 3's float32 route, one launch a batch
    from hand_integral_pose_estimation_tpu_torch.cli import (
        generate_teacher_labels as gen_cli,
    )
    n_cli = 2 * SWEEP_BATCH
    with tempfile.TemporaryDirectory() as d:
        reset()
        db = gen_cli.main(["--synthetic", "--synthetic-size", str(n_cli),
                           "--batch-size", str(SWEEP_BATCH),
                           "--teacher-dtype", "float32", "--model-dir",
                           os.path.join(d, "none"), "--out",
                           os.path.join(d, "db.npz"), "--device", "cuda"])
        torch.cuda.synchronize()
        counts = {k.symbol: k.launches for k in kernels.KERNELS}
        add(counts)
    print(f"[semi] cli.generate_teacher_labels --synthetic --teacher-dtype "
          f"float32 over {n_cli} images: {int(db['keep'].sum())} kept, "
          f"variances finite {bool(np.isfinite(db['variance']).all())}; "
          f"launches {counts}", flush=True)
    check(len(db["keep"]) == n_cli and np.isfinite(db["variance"]).all(),
          "cli.generate_teacher_labels --teacher-dtype float32")
    check(counts == {k.symbol: 2 * int(k in (
        kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32, kernels.WARP_TWOPASS))
        for k in kernels.KERNELS}, f"the float32 teacher's sweep launched "
        f"{counts}, expected one of kernels 3f and 5 a batch")

    # (c) the student at batch 32, fused arm: a live teacher and the PANet
    # term, then the pseudo-label db (with the PANet term); a few eager
    # steps, then scan_steps=4 replays against the same Trainer eagerly
    scfg = cfg.replace(train=dataclasses.replace(cfg.train, lam=LAM))
    frozen_before = {k: v.clone() for k, v in (
        *teacher_net.state_dict().items(), *prior.state_dict().items())}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    probe = None
    for arm, data, t_apply in (("live teacher", train_data, teacher),
                               ("pseudo-label db", filtered, None)):
        kw = dict(cfg=scfg, dataset=data, seed=SEED, device=dev,
                  teacher_apply=t_apply, panet_apply=recon)
        with tempfile.TemporaryDirectory() as model_dir:
            trainer = Trainer(model_dir=model_dir, **kw)
            trainer.graphs = None
            batch = trainer.preprocess(gen, data.host_batch(np.arange(BATCH)))
            if probe is None:
                probe = batch.image
            scale_projection(trainer.model, probe)
            step_losses = []
            inner = trainer.train_step

            def recording_step(b):
                out = inner(b)
                step_losses.append(out["loss"])
                return out

            trainer.train_step = recording_step
            reset()
            trainer.fit(end_epoch=1, steps_per_epoch=TRAIN_STEPS)
            torch.cuda.synchronize()
            trainer.train_step = inner
            counts = {k.symbol: k.launches for k in kernels.KERNELS}
            add(counts)
            n_fwd = 2 if t_apply is not None else 1
            want_counts = {k.symbol: TRAIN_STEPS * (
                n_fwd if k is fwd else int(k in (bwd, warp)))
                for k in kernels.KERNELS}
            losses_host = [float(v) for v in step_losses]
            print(f"[semi] student, {arm}, PANet term (lam {LAM}): "
                  f"Trainer.fit took {TRAIN_STEPS} eager steps at batch "
                  f"{BATCH}, losses {[round(v, 5) for v in losses_host]}, "
                  f"launches {counts}", flush=True)
            check(counts == want_counts, f"{arm}: launches {counts}, "
                  f"expected {want_counts}")
            check(all(math.isfinite(v) for v in losses_host),
                  f"{arm}: losses {losses_host}")

            torch.backends.cudnn.deterministic = True
            twins = {}
            for graphs in (False, True):
                twin = Trainer(model_dir=model_dir, scan_steps=GRAPH_CHUNK,
                               **kw)
                if not graphs:
                    twin.graphs = None
                scale_projection(twin.model, probe)
                twins[graphs] = twin
            reset()
            twins[True].fit(end_epoch=1, steps_per_epoch=GRAPH_STEPS)
            torch.cuda.synchronize()
            counts = path_launches(twins[True].graphs)
            add(counts)
            twins[False].run_epoch(0, num_steps=GRAPH_STEPS)
            torch.backends.cudnn.deterministic = False
            want_counts = {k.symbol: GRAPH_STEPS * (
                n_fwd if k is fwd else int(k in (bwd, warp)))
                for k in kernels.KERNELS}
            (graph,) = twins[True].graphs.graphs.values()
            nodes = kernels.graph_launches(graph)
            state_g = training_state(twins[True])
            state_e = training_state(twins[False])
            differ = [k for k in state_e
                      if not torch.equal(state_g[k], state_e[k])]
            print(f"[semi] student, {arm}: scan_steps={GRAPH_CHUNK}, "
                  f"{GRAPH_STEPS} steps, kernel nodes of the captured chunk "
                  f"{nodes}, launches {counts}; against the eager twin "
                  f"{len(state_e) - len(differ)} of {len(state_e)} tensors "
                  f"bitwise equal", flush=True)
            check(counts == want_counts, f"{arm}: graph launches {counts}, "
                  f"expected {want_counts}")
            check(not differ, f"{arm}: replayed steps differ at {differ[:5]}")
            del twins, twin

            # timing: the eager step, then a graph Trainer back to back,
            # against phase 5's fused arm
            host_batch = data.host_batch(np.arange(BATCH))

            def step():
                trainer.train_step(trainer.preprocess(gen, host_batch))

            for _ in range(2):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run_epoch(1, num_steps=TIME_STEPS)
            torch.cuda.synchronize()
            eager_b2b = (time.perf_counter() - t0) / TIME_STEPS * 1e3
            gtrainer = Trainer(model_dir=model_dir, scan_steps=GRAPH_CHUNK,
                               **kw)
            scale_projection(gtrainer.model, probe)
            gtrainer.run_epoch(0, num_steps=2 * GRAPH_CHUNK)
            t0 = time.perf_counter()
            gtrainer.run_epoch(1, num_steps=TIME_STEPS)
            torch.cuda.synchronize()
            per_g = (time.perf_counter() - t0) / TIME_STEPS * 1e3
            print(f"[semi] student, {arm}: Trainer.run_epoch back to back "
                  f"{eager_b2b:.3f} ms/step eager, {per_g:.3f} ms/step as "
                  f"scan_steps={GRAPH_CHUNK} replays, on {card}", flush=True)
            (graph,) = gtrainer.graphs.graphs.values()
            rng = np.random.RandomState(SEED)
            hosts = [data.host_batch(data.sample_indices(rng, BATCH))
                     for _ in range(GRAPH_CHUNK)]
            chunk = {k: None if hosts[0][k] is None
                     else np.stack([h[k] for h in hosts]) for k in hosts[0]}
            compare_graph_timing(
                f"semi-supervised train step, {arm}, batch {BATCH}", "step",
                step, graph.replay, lambda: gtrainer.graphs(chunk),
                eager_b2b, GRAPH_CHUNK, card, n=5)
            del trainer, gtrainer, graph, batch
            torch.cuda.empty_cache()
    after = {**teacher_net.state_dict(), **prior.state_dict()}
    moved = [k for k, v in frozen_before.items() if not torch.equal(after[k],
                                                                    v)]
    print(f"[semi] teacher and PANet weights and statistics unchanged by "
          f"the student's steps: {not moved}; teacher in eval mode: "
          f"{not teacher_net.training}", flush=True)
    check(not moved and not teacher_net.training,
          f"the frozen teacher or PANet moved: {moved[:5]}")
    return launches


def training_rois(B, R, H, W, g, dev):
    """(B, R, 4) RoIs in the training proposal targets' layout: a quarter
    foreground near the image's gt box (the gt box itself first), the rest
    background anywhere, the last eighth zero padding slots; among them a
    RoI under one feature cell and one partly off the map."""
    gt = torch.tensor([4.0 * W, 4.0 * H, 12.0 * W, 12.0 * H], device=dev)
    n_fg, n_pad = max(R // 4, 1), R // 8
    n_bg = R - n_fg - n_pad
    fg = gt + (torch.rand(B, n_fg, 4, device=dev, generator=g) - 0.5) * 40
    fg[:, 0] = gt
    lo = torch.rand(B, n_bg, 2, device=dev, generator=g) * torch.tensor(
        [16.0 * W, 16.0 * H], device=dev) - 40
    bg = torch.cat([lo, lo + torch.rand(B, n_bg, 2, device=dev, generator=g)
                    * 300 + 2], -1)
    rois = torch.cat([fg, bg, torch.zeros(B, n_pad, 4, device=dev)], 1)
    if n_bg >= 2:
        rois[:, n_fg] = torch.tensor([100.0, 100.0, 108.0, 104.0],
                                     device=dev)
        rois[:, n_fg + 1] = torch.tensor(
            [-60.0, 20.0, 40.0, 16.0 * H + 30.0], device=dev)
    return rois


def detector_training_phase(dev, g, card):
    """Phase 9. Returns the launches of the phase's main runs (the SGD
    steps and `cli.train_detector`) by kernel symbol, and for
    "roi_align_bwd" (max_abs_err, (ms, plain_ms), (bound_ms, bound_by))."""
    from hand_integral_pose_estimation_tpu_torch.cli import (
        analyze_correlation,
        filter_cascade_study,
        semi_supervised_study,
        train_detector,
    )
    from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.detect import (
        build_detector,
        detect,
        make_synthetic_box_dataset,
        prepare_blob,
    )
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.ops import nms as nms_mod
    from hand_integral_pose_estimation_tpu_torch.ops.roi_align import (
        roi_align_bwd_cuda,
        roi_align_bwd_plain,
    )
    from hand_integral_pose_estimation_tpu_torch.training.detector_trainer \
        import make_detector_optimizer, make_detector_train_step

    def reset():
        for k in kernels.KERNELS:
            k.launches = 0

    def counts():
        return {k.symbol: k.launches for k in kernels.KERNELS}

    # ---- a. the ROIAlign backward kernel against the plain VJP; the last
    # shape is a 1 000-pixel image's map (63 x 38), whose 32-channel strip
    # (306 KB) the kernel cuts into bands of rows, its second image's RoIs
    # all off the map
    worst = 0.0
    path = None
    for (B, H, W, C, R) in ((DET_BATCH, 38, 38, 1024, 128),
                            (2, 21, 19, 256, 13), (1, 9, 11, 64, 1),
                            (3, 9, 11, 6, 9), (2, 63, 38, 1024, 64)):
        rois = training_rois(B, R, H, W, g, dev)
        banded = H == 63
        if banded:
            rois[1] = torch.tensor([-900.0, -900.0, -500.0, -600.0],
                                   device=dev)
        cot = torch.randn(B, R, 7, 7, C, device=dev, generator=g)
        got = roi_align_bwd_cuda(cot, rois, (H, W))
        again = roi_align_bwd_cuda(cot, rois, (H, W))
        torch.cuda.synchronize()
        want = roi_align_bwd_plain(cot, rois, (H, W))
        e = float((got - want).abs().max())
        tol = ROI_BWD_TOL * float(want.abs().max())
        same = bool(torch.equal(got, again))
        ok = e <= tol and same and float(want.abs().max()) > 0
        note = ""
        if banded:
            empty = not bool(got[1].any())
            ok = ok and empty
            note = f", banded, the image without RoIs all zero {empty}"
        print(f"[detector training] roi_align_bwd {(B, H, W, C)} x {R} "
              f"RoIs: max|d| {e:.3e} (tol {tol:.3e}), two launches "
              f"bitwise equal {same}{note} {'ok' if ok else 'FAILED'}",
              flush=True)
        check(ok, "the ROIAlign backward kernel disagrees with the plain "
              "VJP or differs between launches")
        worst = max(worst, e)
        if path is None:
            path = (cot, rois, (H, W))
        del got, again, want
    cot, rois, hw = path
    t_bwd = time_pair(lambda: roi_align_bwd_cuda(cot, rois, hw),
                      lambda: roi_align_bwd_plain(cot, rois, hw))
    grad_elems = cot.shape[0] * hw[0] * hw[1] * cot.shape[-1]
    bwd_bound = bound(cot.numel() * 4 + rois.numel() * 4 + grad_elems * 4,
                      cot.numel() * 40)
    print(f"[timing] roi_align_bwd at {tuple(cot.shape)} -> "
          f"{(cot.shape[0], *hw, cot.shape[-1])}: kernel {t_bwd[0]:.4f} ms, "
          f"plain VJP {t_bwd[1]:.4f} ms, bound {bwd_bound[0]:.4f} ms "
          f"({bwd_bound[1]}) on {card}", flush=True)

    # ---- b. kernel 7 at the training proposal shape
    b, sc = clustered_boxes(g, DET_BATCH, 12000, dev)
    for ee in (False, True):
        got = nms_mod.nms(b, sc, 0.7, 2000, 0.0, impl="cuda", early_exit=ee)
        torch.cuda.synchronize()
        want = nms_mod.nms(b, sc, 0.7, 2000, 0.0, impl="plain",
                           early_exit=ee)
        bad = (int((got[2] != want[2]).sum())
               + int((got[0] != want[0]).any(-1).sum())
               + int((got[1] != want[1]).sum()))
        print(f"[detector training] nms {(DET_BATCH, 12000)} -> 2000 at IoU "
              f"0.7, early_exit={ee}: {int(got[2].sum())} kept, {bad} "
              f"mismatching slots (tol 0) {'ok' if bad == 0 else 'FAILED'}",
              flush=True)
        check(bad == 0, "NMS kernel disagrees with its plain version at the "
              "training shape")
    order = torch.sort(sc, dim=1, descending=True, stable=True).indices
    b_sorted = torch.gather(b, 1, order[..., None].expand_as(b))
    alive0 = torch.gather(sc, 1, order) > 0.0
    t_nms = time_pair(
        lambda: nms_mod._alive_cuda(b_sorted, alive0, 0.7, True),
        lambda: nms_mod._alive_plain(b_sorted, alive0, 0.7, True))
    t_call = time_pair(
        lambda: nms_mod.nms(b, sc, 0.7, 2000, 0.0, impl="cuda"),
        lambda: nms_mod.nms(b, sc, 0.7, 2000, 0.0, impl="plain"))
    keep = nms_mod._alive_plain(b_sorted, alive0, 0.7, True)
    pos = torch.arange(b.shape[1], device=dev)
    nms_b = bound(b.numel() * 4 + alive0.numel() * 2,
                  17 * float(((b.shape[1] - 1 - pos) * keep).sum()))
    print(f"[timing] nms kernel (mask + sweep) at the training shape "
          f"{tuple(b.shape)} IoU 0.7, {int(keep.sum())} kept: "
          f"{t_nms[0]:.4f} ms, plain {t_nms[1]:.4f} ms, bound "
          f"{nms_b[0]:.4f} ms ({nms_b[1]}); whole nms() -> 2000 with sort "
          f"and compaction {t_call[0]:.4f} ms, plain {t_call[1]:.4f} ms on "
          f"{card}", flush=True)

    # ---- c. the detector's train step at full width
    det_cfg = dataclasses.replace(DetectorConfig(), resnet_style="caffe")
    model = build_detector(det_cfg, generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    scenes = make_synthetic_box_dataset(
        DET_BATCH, hw=(DET_SIZE, DET_SIZE), min_size=int(DET_SIZE * 0.25),
        max_size=int(DET_SIZE * 0.62), seed=SEED + 1)
    images = torch.from_numpy(scenes.images).to(dev)
    blob, scale = prepare_blob(images, det_cfg)
    scale_detector_heads(model, blob)
    gt = torch.from_numpy(np.stack(scenes.gt_boxes) * np.float32(scale)).to(
        dev)
    gc = torch.ones(DET_BATCH, 1, dtype=torch.long, device=dev)
    gv = torch.ones(DET_BATCH, 1, dtype=torch.bool, device=dev)
    with torch.no_grad():
        feats = model._rpn(blob)[0]
        feat_hw = feats.shape[1:3]
        print(f"[detector training] base features (B, {tuple(feat_hw)}, C) "
              f"mean |x| {float(feats.abs().mean()):.4g} (random weights, "
              f"unit frozen BatchNorm)", flush=True)
        del feats
    pri = model.draw_priorities(torch.Generator(device=dev).manual_seed(SEED),
                                DET_BATCH, feat_hw, 1, dev)

    def one_pass(ops):
        model.train()
        model.zero_grad(set_to_none=True)
        with ops:
            out = model(blob, gt, gc, gv, priorities=pri)
            sum(out.losses.values()).backward()
        torch.cuda.synchronize()
        return (out.rois,
                {k: float(v.detach()) for k, v in out.losses.items()},
                {n: p.grad.clone() for n, p in model.named_parameters()})

    def leaf_errors(got, want):
        return {n: float((got[n] - want[n]).abs().max())
                / max(float(want[n].abs().max()), 1e-30) for n in want}

    def total_error(got, want):
        d = sum(float((got[n] - want[n]).double().square().sum())
                for n in want)
        w = sum(float(want[n].double().square().sum()) for n in want)
        return math.sqrt(d / w)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reset()
    rois_k, loss_k, grad_k = one_pass(contextlib.nullcontext())
    once = counts()
    rois_k2, loss_k2, grad_k2 = one_pass(contextlib.nullcontext())
    reset()
    rois_p, loss_p, grad_p = one_pass(plain_detector_ops())
    plain_launches = sum(counts().values())
    _, _, grad_b = one_pass(plain_roi_align_backward())
    torch.backends.cudnn.deterministic = deterministic
    loss_err = max(abs(loss_k[k] - loss_p[k]) / max(abs(loss_p[k]), 1e-30)
                   for k in loss_p)
    leaf_err = leaf_errors(grad_k, grad_p)
    worst_leaf = max(leaf_err, key=leaf_err.get)
    total = total_error(grad_k, grad_p)
    bwd_err = leaf_errors(grad_k, grad_b)
    worst_bwd = max(bwd_err, key=bwd_err.get)
    tail_same = all(torch.equal(grad_k[n], grad_b[n]) for n in grad_k
                    if not n.startswith("RCNN_base."))
    same_rois = bool(torch.equal(rois_k, rois_p))
    bitwise = (torch.equal(rois_k, rois_k2) and loss_k == loss_k2
               and all(torch.equal(grad_k[n], grad_k2[n]) for n in grad_k))
    print(f"[detector training] one step, R{det_cfg.resnet_type} "
          f"{det_cfg.resnet_style} at {DET_SIZE}^2 x {DET_BATCH}, "
          f"{det_cfg.rpn_pre_nms_top_n_train} -> "
          f"{det_cfg.rpn_post_nms_top_n_train} proposals, "
          f"{det_cfg.roi_batch_size} sampled RoIs an image: losses {loss_k}; "
          f"launches {once}; kernel-backed vs plain-backed ({plain_launches} "
          f"kernel launches in the plain run): sampled RoIs equal "
          f"{same_rois}, losses max rel d {loss_err:.3e} (tol "
          f"{DET_LOSS_REL:g}), gradients max |d| / leaf max "
          f"{leaf_err[worst_leaf]:.3e} at {worst_leaf} (tol "
          f"{DET_GRAD_LEAF:g}), whole gradient {total:.3e} (tol "
          f"{DET_GRAD_TOTAL:g}); the backward kernel alone (kernel 6 forward "
          f"both ways, its backward kernel vs the plain VJP): max |d| / leaf "
          f"max {bwd_err[worst_bwd]:.3e} at {worst_bwd} (tol "
          f"{DET_GRAD_BWD:g}), the tail's and heads' gradients bitwise "
          f"equal {tail_same}; kernel-backed twice bitwise equal {bitwise}",
          flush=True)
    check(once == {k.symbol: {kernels.NMS: 1, kernels.ROI_ALIGN_FWD: 1,
                              kernels.ROI_ALIGN_BWD: 1}.get(k, 0)
                   for k in kernels.KERNELS},
          f"one train step launched {once}")
    check(plain_launches == 0, "the plain-backed step launched a kernel")
    check(same_rois and loss_err <= DET_LOSS_REL
          and leaf_err[worst_leaf] <= DET_GRAD_LEAF
          and total <= DET_GRAD_TOTAL,
          "the kernel-backed train step disagrees with the plain-backed one")
    check(tail_same and bwd_err[worst_bwd] <= DET_GRAD_BWD,
          "the ROIAlign backward kernel's gradients disagree with the plain "
          "VJP's in the train step")
    check(bitwise, "two kernel-backed train steps differ")
    del grad_k, grad_k2, grad_p, grad_b

    calibrate_frozen_batchnorm(model, blob)
    scale_detector_heads(model, blob)
    with torch.no_grad():
        size = float(model._rpn(blob)[0].abs().mean())
    optimizer, scheduler = make_detector_optimizer(model.parameters(),
                                                   lr=DET_LR)
    step = make_detector_train_step(model, optimizer, scheduler)
    sampling = torch.Generator(device=dev)
    # cuDNN's deterministic algorithms: the same losses on every run; each
    # step's backward kernel held to the plain VJP on that step's own
    # cotangent and RoIs
    torch.backends.cudnn.deterministic = True
    reset()
    per_step, losses = [], []
    with roi_align_backward_held() as bwd_errors, frozen_proposals():
        for _ in range(DET_TRAIN_STEPS):
            before = counts()
            # the same anchor and RoI draws each step and the first
            # step's proposals: one objective, descended
            sampling.manual_seed(SEED + 2)
            metrics = step(blob, gt, gc, gv, generator=sampling)
            per_step.append({k: v - before[k] for k, v in counts().items()
                             if v - before[k]})
            losses.append(metrics["loss"])
    losses = torch.stack(losses).tolist()
    steps_launches = counts()
    torch.backends.cudnn.deterministic = deterministic
    margin = descent_margin(losses)
    falls = margin > 0
    steps_bwd_ok = (len(bwd_errors) == DET_TRAIN_STEPS
                    and max(bwd_errors) <= ROI_BWD_TOL)
    print(f"[detector training] {DET_TRAIN_STEPS} SGD steps at lr "
          f"{DET_LR:g} with the frozen statistics set from the scenes (base "
          f"features' mean |x| {size:.4g}) on the first step's proposals: "
          f"losses {[round(v, 4) for v in losses]}, falling {falls} (by "
          f"{margin:.4g}); the backward "
          f"kernel against the plain VJP at each step: max|d| / max "
          f"{max(bwd_errors):.3e} (tol {ROI_BWD_TOL:g}); launches per step "
          f"{per_step}", flush=True)
    check(all(math.isfinite(v) for v in losses), "non-finite detector loss")
    check(falls, f"the detector's loss did not fall over {DET_TRAIN_STEPS} "
          f"SGD steps on one batch")
    check(steps_bwd_ok, "the ROIAlign backward kernel disagrees with the "
          "plain VJP in a train step")
    check(all(p == {kernels.NMS.symbol: 1, kernels.ROI_ALIGN_FWD.symbol: 1,
                    kernels.ROI_ALIGN_BWD.symbol: 1} for p in per_step),
          f"detector train steps launched {per_step}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(blob, gt, gc, gv, generator=sampling)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / 5 * 1e3
    print(f"[timing] detector train step back to back: {per:.3f} ms per "
          f"step over 5 steps (host clock) at batch {DET_BATCH} x "
          f"{DET_SIZE}^2, {DET_BATCH / per * 1e3:.1f} img/s on {card}",
          flush=True)
    print_profile(f"detector train step at batch {DET_BATCH}",
                  lambda: step(blob, gt, gc, gv, generator=sampling), 3, card)
    del model, optimizer, step

    # ---- d. cli.train_detector on the card
    with tempfile.TemporaryDirectory() as d:
        flags = ["--synthetic", "--n", "16", "--steps", "3", "--batch", "2",
                 "--eval-every", "3", "--device", "cuda"]
        reset()
        result = train_detector.main(flags + ["--model-dir", d])
        torch.cuda.synchronize()
        cli_launches = counts()
        cfg = train_detector.detector_cfg_from_args(
            train_detector.build_argparser().parse_args(flags))
        restored = build_detector(cfg, os.path.join(
            d, "faster_rcnn_final.pth")).to(dev)
        frames = torch.from_numpy(SyntheticFreiHand(n=DET_BATCH,
                                                    seed=SEED).images).to(dev)
        a, b2 = detect(result["model"], frames, cfg), detect(restored, frames,
                                                             cfg)
        same = all(torch.equal(x, y) for x, y in zip(a, b2))
    print(f"[detector training] cli.train_detector --synthetic (R"
          f"{cfg.resnet_type} {cfg.norm} norm at {cfg.test_scale}^2, 3 "
          f"steps): history {result['history']}; launches {cli_launches}; "
          f"build_detector restored its .pth, detect equal {same}",
          flush=True)
    check(same and cli_launches[kernels.ROI_ALIGN_BWD.symbol] == 3,
          "cli.train_detector's snapshot or launches")

    # ---- e. the study CLIs on the card
    t0 = time.perf_counter()
    semi = semi_supervised_study.main(
        ["--n", "48", "--labelled", "8", "--test-n", "32", "--teacher-steps",
         "4", "--student-steps", "4", "--batch-size", "16", "--device",
         "cuda"])
    check(set(semi) == {"teacher", "baseline", "distilled"} and all(
        math.isfinite(r["mpjpe"]) for r in semi.values()),
        "semi_supervised_study")
    cascade = filter_cascade_study.main(
        ["--n", "32", "--pool", "32", "--teacher-steps", "4", "--batch-size",
         "8", "--device", "cuda"])
    check(cascade["keep_sets_equal"], "filter_cascade_study")
    with tempfile.TemporaryDirectory() as d:
        arr = analyze_correlation.main(
            ["--synthetic", "--max-samples", "64", "--batch-size", "16",
             "--model-dir", os.path.join(d, "none"), "--out",
             os.path.join(d, "corr.csv"), "--device", "cuda"])
    check(arr.shape == (64, 3) and np.isfinite(arr).all(),
          "analyze_correlation")
    print(f"[detector training] the three study CLIs ran on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    launches = {k: steps_launches[k] + cli_launches[k] for k in cli_launches}
    return launches, {"roi_align_bwd": (worst, t_bwd, bwd_bound)}


def input_int8_phase(dev, g, card, cfg):
    """Phase 10: the input path's device half and int8 serving. Returns the
    launches of the phase's main runs (the training from packed planes, the
    int8 pipeline and its CLI, the int8 teacher sweep and its CLI) by
    kernel symbol."""
    from hand_integral_pose_estimation_tpu_torch.cli import evaluate as cli
    from hand_integral_pose_estimation_tpu_torch.cli import (
        generate_teacher_labels as gen_cli,
    )
    from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.data.freihand import (
        FRAME_HW,
    )
    from hand_integral_pose_estimation_tpu_torch.detect import (
        build_detector,
        make_synthetic_box_dataset,
        prepare_blob,
    )
    from hand_integral_pose_estimation_tpu_torch.distill import (
        generate_filtered_labels,
        quantized_teacher_apply,
        sweep_patches,
    )
    from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels \
        import camera_project
    from hand_integral_pose_estimation_tpu_torch.geometry import bbox as bb
    from hand_integral_pose_estimation_tpu_torch.inference import (
        TwoStagePipeline,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.ops.yuv import (
        planar_sizes,
        yuv420_to_rgb,
    )
    from hand_integral_pose_estimation_tpu_torch.quantize import (
        Quantized,
        load_quantized,
        quantize_model,
        quantized_apply,
        save_quantized,
    )
    from hand_integral_pose_estimation_tpu_torch.training import Trainer
    from hand_integral_pose_estimation_tpu_torch.training.teacher import (
        frozen_teacher,
    )

    launches = {k.symbol: 0 for k in kernels.KERNELS}
    IH, IW = cfg.model.input_shape

    def reset():
        for k in kernels.KERNELS:
            k.launches = 0

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # ---- a. the YUV 4:2:0 decode on the card, bitwise the CPU's, at the
    # frames' size (FreiHAND's 224^2) and ragged even sizes
    FH, FW = FRAME_HW
    cpu_gen = torch.Generator().manual_seed(SEED)
    for B, H, W in ((BATCH, FH, FW), (3, 200, 200), (3, 226, 150),
                    (3, 120, 88), (3, 2, 2)):
        packed = torch.randint(0, 256, (B, sum(planar_sizes(H, W))),
                               generator=cpu_gen, dtype=torch.uint8)
        got = yuv420_to_rgb(packed.to(dev), H, W)
        same = torch.equal(got.cpu(), yuv420_to_rgb(packed, H, W))
        print(f"[yuv] yuv420_to_rgb {(B, H, W)} on the card bitwise equal to "
              f"the CPU's: {same}", flush=True)
        check(same, f"yuv420_to_rgb {(B, H, W)} differs on the card")
    planes = torch.randint(0, 256, (BATCH, sum(planar_sizes(FH, FW))),
                           generator=cpu_gen, dtype=torch.uint8)
    planes_d = planes.to(dev)
    t_yuv = statistics.median(event_ms(lambda: yuv420_to_rgb(
        planes_d, FH, FW), 10) for _ in range(5))
    px = BATCH * FH * FW
    yuv_bound = bound(1.5 * px + 3 * px, 0)
    _, rows = device_profile(lambda: yuv420_to_rgb(planes_d, FH, FW), 3)
    print(f"[yuv] yuv420_to_rgb at {BATCH} x {FH}x{FW}: {t_yuv:.4f} ms "
          f"(events, median of 5 x 10 calls), bound {yuv_bound[0]:.4f} ms "
          f"({yuv_bound[1]}: {1.5 * px / 1e6:.3f} MB read, {3 * px / 1e6:.3f} "
          f"MB written), {sum(r[2] for r in rows):g} kernels per call, on "
          f"{card}", flush=True)
    h2d = {}
    for name, shape in (("4:2:0 planes", tuple(planes.shape)),
                        ("RGB", (BATCH, FH, FW, 3))):
        src = torch.zeros(shape, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(shape, dtype=torch.uint8, device=dev)
        h2d[name] = statistics.median(event_ms(lambda: dst.copy_(
            src, non_blocking=True), 10) for _ in range(5))
        print(f"[yuv] pinned host-to-device copy of one {name} batch "
              f"{shape} ({src.numel() / 1e6:.3f} MB): {h2d[name]:.4f} ms, "
              f"{src.numel() / h2d[name] / 1e6:.2f} GB/s, on {card}",
              flush=True)

    # the fused train step replayed with packed planes (the decode inside
    # the graph) against the same steps fed those planes decoded outside.
    # The prefetcher needs native/libhipe_io.so, built against libjpeg, so
    # the script does without it: the Trainer runs over the synthetic
    # split with its frames replaced by seeded planes, told that its host
    # batches carry planes.
    n = 2 * BATCH
    plane_rows = torch.randint(0, 256, (n, sum(planar_sizes(FH, FW))),
                               generator=cpu_gen, dtype=torch.uint8)
    yuv_data = SyntheticFreiHand(n=n, render_joints=True, seed=SEED)
    rgb_data = SyntheticFreiHand(n=n, render_joints=True, seed=SEED)
    yuv_data.images = plane_rows.numpy()
    rgb_data.images = yuv420_to_rgb(plane_rows, FH, FW).numpy()
    torch.backends.cudnn.deterministic = True
    twins = {}
    with tempfile.TemporaryDirectory() as model_dir:
        for name, data in (("planes", yuv_data), ("rgb", rgb_data)):
            twin = Trainer(cfg, data, model_dir=model_dir, seed=SEED,
                           device=dev, scan_steps=GRAPH_CHUNK)
            twin.yuv_transport = name == "planes"
            reset()
            twin.fit(end_epoch=1, steps_per_epoch=GRAPH_STEPS)
            torch.cuda.synchronize()
            counts = path_launches(twin.graphs)
            if name == "planes":
                add(counts)
                plane_counts = counts
            twins[name] = twin
    torch.backends.cudnn.deterministic = False
    state_p, state_r = (training_state(twins[k]) for k in ("planes", "rgb"))
    differ = [k for k in state_r if not torch.equal(state_p[k], state_r[k])]
    want_counts = {k.symbol: (GRAPH_STEPS if k in (
        kernels.HEAD_PROJECTION_INTEGRAL_FWD,
        kernels.HEAD_PROJECTION_INTEGRAL_BWD, kernels.WARP_TWOPASS) else 0)
        for k in kernels.KERNELS}
    replay_ms = {}
    for name, twin in twins.items():
        (graph,) = twin.graphs.graphs.values()
        replay_ms[name] = statistics.median(
            event_ms(graph.replay, 1) for _ in range(5)) / GRAPH_CHUNK
    print(f"[yuv] fused train step, Trainer.fit with scan_steps="
          f"{GRAPH_CHUNK} ({GRAPH_STEPS} steps) from packed planes decoded "
          f"inside the captured chunk, against the same steps fed those "
          f"planes decoded outside (cudnn deterministic): "
          f"{len(state_r) - len(differ)} of {len(state_r)} tensors bitwise "
          f"equal; launches {plane_counts}; replay per step "
          f"{replay_ms['planes']:.3f} ms with the decode, "
          f"{replay_ms['rgb']:.3f} ms without, the decode alone "
          f"{t_yuv:.4f} ms per step of {BATCH}, on {card}", flush=True)
    check(not differ, f"training from planes differs at {differ[:5]}")
    check(plane_counts == want_counts, f"planes launches {plane_counts}")
    del twins, twin, graph, planes_d
    torch.cuda.empty_cache()

    # ---- b. int8 layers on the card against a float64 product of the
    # same int8 values: unit scales (the output is the int32 sums, exact in
    # float32 below 2^24), then calibrated scales with the epilogue
    layers = (
        ("stem 7x7 s2, K 147", torch.nn.Conv2d(3, 64, 7, 2, 3, bias=False),
         (DET_BATCH, 3, IH, IW)),
        ("3x3 s2", torch.nn.Conv2d(128, 128, 3, 2, 1, bias=False),
         (DET_BATCH, 128, 56, 56)),
        ("1x1", torch.nn.Conv2d(256, 64, 1, bias=False),
         (DET_BATCH, 256, 56, 56)),
        ("RPN class 1x1, N 18", torch.nn.Conv2d(512, 18, 1),
         (DET_BATCH, 512, 38, 38)),
        ("deconv 4x4 s2", torch.nn.ConvTranspose2d(256, 256, 4, 2, 1,
                                                   bias=False),
         (DET_BATCH, 256, 28, 28)),
        ("Linear, N 2", torch.nn.Linear(2048, 2), (DET_BATCH * 300, 2048)),
    )
    for name, mod, shape in layers:
        mod = mod.to(dev).to(memory_format=torch.channels_last) \
            if len(shape) == 4 else mod.to(dev)
        kq = torch.randint(-127, 128, mod.weight.shape, device=dev,
                           generator=g).to(torch.int8)
        nout = mod.weight.shape[1 if isinstance(
            mod, torch.nn.ConvTranspose2d) else 0]
        unit = Quantized({"": kq}, {"": torch.ones(nout, device=dev)},
                         {"": 1.0}, {})
        xi = torch.randint(-127, 128, shape, device=dev, generator=g).float()
        if xi.ndim == 4:
            xi = xi.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            sums = quantized_apply(mod, unit, xi).double()
        x64, w64 = xi.double(), kq.double()
        if isinstance(mod, torch.nn.Linear):
            want = x64 @ w64.T
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            want = torch.nn.functional.conv_transpose2d(x64, w64, None, 2, 1)
        else:
            want = torch.nn.functional.conv2d(x64, w64, None, mod.stride,
                                              mod.padding)
        exact = float(want.abs().max()) < 2 ** 24
        same = exact and torch.equal(sums, want)
        x = torch.randn(shape, device=dev, generator=g)
        if x.ndim == 4:
            x = x.contiguous(memory_format=torch.channels_last)
        q = quantize_model(mod, [x])
        with torch.no_grad():
            got = quantized_apply(mod, q, x)
            xq = torch.round(x * (1.0 / q.ascales[""])).clamp(-127, 127)
            w64 = q.kernels[""].double()
            view = (1, -1) if x.ndim == 2 else (1, -1, 1, 1)
            if isinstance(mod, torch.nn.Linear):
                y = xq.double() @ w64.T
            elif isinstance(mod, torch.nn.ConvTranspose2d):
                y = torch.nn.functional.conv_transpose2d(xq.double(), w64,
                                                         None, 2, 1)
            else:
                y = torch.nn.functional.conv2d(xq.double(), w64, None,
                                               mod.stride, mod.padding)
            oracle = y.float() * (q.kscales[""] * q.ascales[""]).view(view)
            if "" in q.biases:
                oracle = oracle + q.biases[""].view(view)
            same_epi = torch.equal(got, oracle)
            t_int8 = statistics.median(event_ms(lambda: quantized_apply(
                mod, q, x), 3) for _ in range(3))
            t_f32 = statistics.median(event_ms(lambda: mod(x), 3)
                                      for _ in range(3))
        print(f"[int8] {name} {tuple(shape)} -> {tuple(sums.shape)}: int32 "
              f"sums bitwise the float64 product of the same int8 values "
              f"(largest {float(want.abs().max()):.0f} < 2^24: {exact}): "
              f"{same}; with the epilogue bitwise: {same_epi}; {t_int8:.4f} "
              f"ms int8 (quantize, gather, _int_mm, epilogue) against "
              f"{t_f32:.4f} ms float32, on {card}", flush=True)
        check(same and same_epi, f"the int8 {name} disagrees with float64")

    # ---- c. the int8 two-stage pipeline at phase 7's width
    det_cfg = dataclasses.replace(DetectorConfig(), resnet_style="caffe")
    model = build_detector(det_cfg, generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    scenes = make_synthetic_box_dataset(
        DET_BATCH, hw=(DET_SIZE, DET_SIZE), min_size=int(DET_SIZE * 0.25),
        max_size=int(DET_SIZE * 0.62), seed=SEED)
    scale_detector_heads(model, prepare_blob(torch.from_numpy(
        scenes.images).to(dev), det_cfg)[0])
    pose = get_pose_net(cfg.model,
                        generator=torch.Generator().manual_seed(SEED)).to(dev)
    pcfg = cfg.replace(detector=det_cfg)
    frames = SyntheticFreiHand(n=PIPE_FRAMES, render_joints=True, seed=SEED)
    hosts = [frames.host_batch(np.arange(b, b + DET_BATCH))
             for b in range(0, PIPE_FRAMES, DET_BATCH)]
    calib = (hosts[0]["image"], hosts[0]["K"], hosts[0]["ref_bone_len"])
    t0 = time.perf_counter()
    pipe8 = TwoStagePipeline(pcfg, pose, model, device=dev,
                             int8_calib=calib)
    t_calib = time.perf_counter() - t0
    fp = TwoStagePipeline(pcfg, pose, model, device=dev)
    q_pose, q_det = pipe8.quantized
    want_pose = {n for n, m in pose.named_modules() if isinstance(
        m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))} - {
        "head.final_layer"}
    want_det = {n for n, m in model.named_modules()
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    print(f"[int8] TwoStagePipeline(int8_calib=first batch) calibrated in "
          f"{t_calib:.1f} s: {len(q_pose.paths)} pose modules (of "
          f"{len(want_pose)} convs but head.final_layer) and "
          f"{len(q_det.paths)} detector modules (of {len(want_det)} convs "
          f"and Linears) quantized, skipped {q_pose.skipped + q_det.skipped}",
          flush=True)
    check(set(q_pose.paths) == want_pose and set(q_det.paths) == want_det,
          "the int8 pipeline left a conv or Linear in float")
    reset()
    outs8 = [pipe8(h["image"], h["K"], h["ref_bone_len"]) for h in hosts]
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels.KERNELS}
    add(counts)
    nb = len(hosts)
    want_counts = {k.symbol: {kernels.ROI_ALIGN_FWD: nb, kernels.NMS: 2 * nb,
                              kernels.HEAD_PROJECTION_INTEGRAL_FWD: nb}.get(
        k, 0) for k in kernels.KERNELS}
    outs = [fp(h["image"], h["K"], h["ref_bone_len"]) for h in hosts]
    coords8 = torch.cat([o.coords_label for o in outs8])
    coords = torch.cat([o.coords_label for o in outs])
    joints8 = torch.cat([o.joints_cam for o in outs8])
    d_box = float((torch.cat([o.crop_bbox for o in outs8])
                   - torch.cat([o.crop_bbox for o in outs])).abs().max())
    print(f"[int8] int8 pipeline over {PIPE_FRAMES} frames in {nb} batches "
          f"of {DET_BATCH}: joints finite "
          f"{bool(torch.isfinite(joints8).all())}; against float: max|d coords| "
          f"{float((coords8 - coords).abs().max()):.4e}, mean "
          f"{float((coords8 - coords).abs().mean()):.4e}, max|d crop box| "
          f"{d_box:.3f} px (random weights: no accuracy gate); launches "
          f"{counts}", flush=True)
    check(counts == want_counts, f"int8 pipeline launches {counts}, "
          f"expected {want_counts}")
    check(bool(torch.isfinite(joints8).all()) and bool(torch.isfinite(
        coords8).all()), "the int8 pipeline's joints are not finite")
    with tempfile.TemporaryDirectory() as d:
        files = (os.path.join(d, "q.pose.npz"), os.path.join(d, "q.det.npz"))
        save_quantized(files[0], q_pose)
        save_quantized(files[1], q_det)
        loaded = (load_quantized(files[0], type(pose)),
                  load_quantized(files[1], type(model)))
        again = TwoStagePipeline(pcfg, pose, model, device=dev,
                                 int8_calib=loaded)(*calib)
        same = all(torch.equal(a, b) for a, b in zip(again, outs8[0]))
        try:
            TwoStagePipeline(pcfg, pose, model, device=dev,
                             int8_calib=loaded[::-1])
            refused = False
        except ValueError:
            refused = True
        print(f"[int8] bundles saved and reloaded: outputs bitwise equal "
              f"{same}; the swapped pair refused {refused}", flush=True)
        check(same and refused, "reloaded int8 bundles")
        preds = []
        for run in range(2):
            reset()
            cli.main(["--synthetic", "--synthetic-size", str(PIPE_FRAMES),
                      "--batch-size", str(DET_BATCH), "--use-detector",
                      "--int8", "--int8-db", os.path.join(d, "cli"),
                      "--model-dir", os.path.join(d, "none"), "--result-dir",
                      os.path.join(d, f"r{run}"), "--device", "cuda"])
            torch.cuda.synchronize()
            add({k.symbol: k.launches for k in kernels.KERNELS})
            with open(os.path.join(d, f"r{run}", "pred.json")) as f:
                preds.append(f.read())
        print(f"[int8] cli.evaluate --synthetic --use-detector --int8 "
              f"--int8-db twice (writing, then reading the bundles): "
              f"pred.json bitwise equal {preds[0] == preds[1]}", flush=True)
        check(preds[0] == preds[1], "cli.evaluate --int8-db's second run "
              "differs from its first")

    def per_batch(p, h, n=10):
        for _ in range(2):
            p(h["image"], h["K"], h["ref_bone_len"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            p(h["image"], h["K"], h["ref_bone_len"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    h = hosts[0]
    t_fp, t_8, t_8b, t_fpb = (per_batch(fp, h), per_batch(pipe8, h),
                              per_batch(pipe8, h), per_batch(fp, h))
    busy_fp, rows_fp = device_profile(lambda: fp(h["image"], h["K"],
                                                 h["ref_bone_len"]), 3)
    busy_8, rows_8 = device_profile(lambda: pipe8(h["image"], h["K"],
                                                  h["ref_bone_len"]), 3)
    print(f"[int8] TwoStagePipeline at batch {DET_BATCH} back to back "
          f"(host clock, turns fp, int8, int8, fp): int8 {t_8:.3f} / "
          f"{t_8b:.3f} ms/batch, float {t_fp:.3f} / {t_fpb:.3f}; device busy "
          f"int8 {busy_8:.3f} ms over {sum(r[2] for r in rows_8):g} kernels "
          f"per batch, float {busy_fp:.3f} ms over "
          f"{sum(r[2] for r in rows_fp):g}; on {card}", flush=True)
    print_profile(f"int8 TwoStagePipeline at batch {DET_BATCH}",
                  lambda: pipe8(h["image"], h["K"], h["ref_bone_len"]), 3,
                  card, top=10)
    del pipe8, fp, model, outs, outs8, again
    torch.cuda.empty_cache()

    # ---- d. the int8 teacher over 8 images x 21 rotations
    teacher_net = get_pose_net(
        cfg.model, generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    sweep_data = SyntheticFreiHand(n=SWEEP_BATCH, render_joints=True,
                                   seed=SEED)
    host = sweep_data.host_batch(np.arange(SWEEP_BATCH))
    images, K, joints = (torch.from_numpy(host[k]).to(dev)
                         for k in ("image", "K", "joint_cam"))
    uv, _, _ = camera_project(joints, K)
    box = bb.bbox_from_keypoints(uv, torch.ones_like(uv[..., 0]),
                                 pad_factor=cfg.augment.pad_factor)
    unl = torch.zeros(SWEEP_BATCH, dtype=torch.bool, device=dev)
    teacher = frozen_teacher(teacher_net, cfg)
    t = cfg.train
    sweep_kw = dict(num_rotations=t.teacher_num_rotations,
                    rotation_range=t.teacher_rotation_range,
                    patch_hw=(IH, IW))
    # the head scaled on the sweep's own crops, as in phase 8
    thetas = np.linspace(-t.teacher_rotation_range, t.teacher_rotation_range,
                         t.teacher_num_rotations)
    with torch.no_grad():
        scale_projection(teacher_net, sweep_patches(
            images, K, box, cfg.augment, thetas, t.teacher_rotation_range,
            (IH, IW))[:BATCH])
    teacher8, q8 = quantized_teacher_apply(
        teacher_net, images, K, box, cfg.augment, cfg.model.num_joints,
        cfg.model.depth_dim, **sweep_kw)
    with torch.no_grad():
        want = generate_filtered_labels(teacher, images, K, box, unl, joints,
                                        **sweep_kw)
        reset()
        got = generate_filtered_labels(teacher8, images, K, box, unl, joints,
                                       **sweep_kw)
        torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels.KERNELS}
    add(counts)
    var = want.variance.sort().values
    mid = SWEEP_BATCH // 2
    thr = float((var[mid - 1] * var[mid]).sqrt())
    print(f"[int8] int8 teacher ({len(q8.paths)} modules, head.final_layer "
          f"in float) over {SWEEP_BATCH} x {t.teacher_num_rotations} crops: "
          f"variances {[f'{v:.3e}' for v in got.variance.tolist()]} against "
          f"float {[f'{v:.3e}' for v in want.variance.tolist()]}; keep at a "
          f"threshold {thr:.3e} between the float middle variances "
          f"{(got.variance < thr).int().tolist()} against "
          f"{(want.variance < thr).int().tolist()}; launches {counts}",
          flush=True)
    check(bool(torch.isfinite(got.per_rotation).all()),
          "the int8 teacher's predictions are not finite")
    check(counts == {k.symbol: int(k in (kernels.HEAD_PROJECTION_INTEGRAL_FWD,
                                         kernels.WARP_TWOPASS))
                     for k in kernels.KERNELS},
          f"int8 sweep launches {counts}")

    def sweep(apply):
        with torch.no_grad():
            generate_filtered_labels(apply, images, K, box, unl, joints,
                                     **sweep_kw)

    ms = {}
    for name, apply in (("float", teacher), ("int8", teacher8),
                        ("int8 again", teacher8), ("float again", teacher)):
        sweep(apply)
        ms[name] = statistics.median(event_ms(lambda: sweep(apply), 1)
                                     for _ in range(5))
    print(f"[int8] teacher sweep per batch of {SWEEP_BATCH} x "
          f"{t.teacher_num_rotations} crops (events, median of 5, turns): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; on {card}", flush=True)
    with tempfile.TemporaryDirectory() as d:
        reset()
        db = gen_cli.main(["--synthetic", "--synthetic-size", "16",
                           "--teacher-dtype", "int8", "--model-dir",
                           os.path.join(d, "none"), "--out",
                           os.path.join(d, "db.npz"), "--device", "cuda"])
        torch.cuda.synchronize()
        add({k.symbol: k.launches for k in kernels.KERNELS})
    print(f"[int8] cli.generate_teacher_labels --synthetic --teacher-dtype "
          f"int8: {int(db['keep'].sum())} of {len(db['keep'])} kept, "
          f"variances finite {bool(np.isfinite(db['variance']).all())}",
          flush=True)
    check(len(db["keep"]) == 16 and np.isfinite(db["variance"]).all(),
          "cli.generate_teacher_labels --teacher-dtype int8")
    return launches


# The mesh phase (11). a: one NCCL rank against no mesh over 8 steps (two
# chunks of GRAPH_CHUNK, the second captured); b, d: two processes on the
# card over gloo, 4 eager steps at a global batch of BATCH (16 a rank)
# against one process on the union batch, the Tester over the mesh on
# MESH_TEST_N samples (the tail padded), the pipeline on phase 7's frames;
# c: three processes over model=3 at batch MESH_MODEL_BATCH.
MESH_PAIR_STEPS = 4
MESH_TEST_N = 40
MESH_MODEL_BATCH = 8
# Sync-BN's two-pass statistics and cuDNN's differ in float32 rounding;
# under bf16 autocast such a difference flips 8-bit roundings layer after
# layer (phase 5 holds the bf16 step's whole gradient to 5e-2 for one such
# change). The loss, a mean of 32 x 63 terms, after a few steps: 2e-2.
# Each parameter: Adam moves an element at most ~lr a step whatever its
# gradient, so two runs whose small gradients differ in sign part by at
# most 2.5 lr a step (the CPU tests' bound, tests/test_multihost.py's).
MESH_LOSS_REL = 2e-2
MESH_PARAM_STEP = 2.5
# One step from one state against cuDNN's BatchNorm runs at float32
# compute: under bf16 autocast a float32 rounding of BatchNorm's output
# flips bf16 roundings, and the scaled (peaked) soft-argmax turns such a
# perturbation of the features into another gradient (1.17 whole at bf16
# on an H100). The loss at float32 differs by rounding only: 1e-4.
MESH_STEP_LOSS_REL = 1e-4


def run_mesh_job(job: str, world: int, case: dict, out_dir: str,
                 timeout: float = 600) -> list[dict]:
    """`world` processes of the mesh phase's worker on this card
    (`parallel.spawn_ranks`: torchrun's environment on a free localhost
    port); fails the run (after stopping every rank) if any rank fails or
    the group outlives `timeout`. Returns each rank's results."""
    from hand_integral_pose_estimation_tpu_torch.parallel import spawn_ranks

    case_path = os.path.join(out_dir, f"{job}_case.pt")
    torch.save(case, case_path)
    try:
        spawn_ranks(
            [sys.executable, "-m",
             "hand_integral_pose_estimation_tpu_torch.parallel._smoke_worker",
             job, case_path, out_dir], world,
            cwd=os.path.dirname(os.path.abspath(__file__)), timeout=timeout)
    except RuntimeError as e:
        print(e, flush=True)
        fail(f"mesh phase: the {job!r} group failed")
    return [torch.load(os.path.join(out_dir, f"{job}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def set_projection(model, weight) -> None:
    """The phase's scaled projection (whole) into a model laid out whole."""
    with torch.no_grad():
        model.head.final_layer.weight.copy_(weight)
        model.head.final_layer.bias.zero_()


def grad_distance(got: dict, want: dict):
    """||got - want|| / ||want|| over all gradients, and the worst leaf's
    (phase 5's measure); returns (whole, worst, its name)."""
    worst, worst_name = 0.0, ""
    for n, b in want.items():
        a = got[n].to(b.device)
        ref = float(b.norm())
        r = float((a - b).norm()) / ref if ref else float(a.norm())
        if r > worst:
            worst, worst_name = r, n
    total = math.sqrt(
        sum(float((got[n].to(b.device) - b).double().square().sum())
            for n, b in want.items())
        / sum(float(b.double().square().sum()) for b in want.values()))
    return total, worst, worst_name


def param_distance(got: dict, want: dict) -> float:
    """max |got - want| over the parameters of a state dict."""
    return max(float((got[k].float().cpu() - v.float().cpu()).abs().max())
               for k, v in want.items())


def mesh_phase(dev, g, card, cfg):
    """Phase 11. Returns the launches of the phase's main runs (the mesh
    runs of a, b, c and d, in this process and in the ranks) and the
    largest errors of kernels 3 and 4 at the model split's joint counts."""
    import torch.distributed as dist

    from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
    from hand_integral_pose_estimation_tpu_torch.data import (
        SyntheticFreiHand,
        make_eval_batch,
    )
    from hand_integral_pose_estimation_tpu_torch.detect import (
        build_detector,
        prepare_blob,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
        head_projection_integral_bwd_cuda,
        head_projection_integral_bwd_reference,
        head_projection_integral_cuda,
        head_projection_integral_reference,
    )
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        convert_sync_batchnorm,
        init_distributed,
        make_mesh,
        place_state,
    )
    from hand_integral_pose_estimation_tpu_torch.training import (
        Tester,
        Trainer,
        make_eval_fn,
        make_optimizer,
        make_train_step,
        multistep_schedule,
    )

    J, D = cfg.model.num_joints, cfg.model.depth_dim
    Ho, Wo = cfg.model.output_shape
    F = cfg.model.deconv_channels
    lr = cfg.train.lr
    launches = {k.symbol: 0 for k in kernels.KERNELS}
    err = {name: 0.0 for name in (
        "head_projection_integral_fwd", "head_projection_integral_bwd",
        "head_projection_integral_fwd_f32",
        "head_projection_integral_bwd_f32")}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # kernels 3 and 4 at the model split's channel counts: 7 joints (392
    # channels, model=3) and 3 joints (168, model=7), a ragged tail on
    # the 64-channel blocks, bf16 features as on the path and float32 ones
    # (compute_dtype="float32"), kernel 4 twice for the same bits
    for j, fdt in itertools.product((7, 3), (torch.bfloat16, torch.float32)):
        sfx, tag = (("_f32", "f32") if fdt == torch.float32
                    else ("", "bf16"))
        feats = torch.randn(BATCH, Ho, Wo, F, device=dev,
                            generator=g).to(fdt)
        w = 0.3 * torch.randn(j * D, F, device=dev, generator=g)
        b = torch.randn(j * D, device=dev, generator=g)
        err["head_projection_integral_fwd" + sfx] = max(
            err["head_projection_integral_fwd" + sfx], compare(
                f"head_projection_integral_fwd at the model split, "
                f"{(BATCH, Ho, Wo, F)}x{(j * D, F)} {tag}/f32",
                lambda: head_projection_integral_cuda(feats, w, b, j, D),
                lambda: head_projection_integral_reference(feats, w, b, j,
                                                           D)))
        coords, m, s = head_projection_integral_cuda(feats, w, b, j, D)
        cot = torch.randn(BATCH, j, 3, device=dev, generator=g)
        err["head_projection_integral_bwd" + sfx] = max(
            err["head_projection_integral_bwd" + sfx], compare_grads(
                f"head_projection_integral_bwd at the model split, "
                f"{(BATCH, Ho, Wo, F)}x{(j * D, F)} {tag}/f32",
                lambda: head_projection_integral_bwd_cuda(
                    feats, w, b, m, s, coords, cot, j, D),
                lambda: head_projection_integral_bwd_reference(
                    feats, w, b, m, s, coords, cot, j, D),
                GRAD_ABS_SCALE["head_projection_integral_bwd"]))
        first = head_projection_integral_bwd_cuda(feats, w, b, m, s, coords,
                                                  cot, j, D)
        again = head_projection_integral_bwd_cuda(feats, w, b, m, s, coords,
                                                  cot, j, D)
        same = all(torch.equal(x, y) for x, y in zip(first, again))
        print(f"[kernels] head_projection_integral_bwd at the model split, "
              f"{j * D} channels, {tag} features, run twice: bitwise equal "
              f"{same}", flush=True)
        check(same, "the fused-head backward is not deterministic at the "
              "model split")
        del feats, coords, m, s, first, again

    # the projection every run of the phase starts from: scaled on the
    # augmented batch of an unsplit model, then copied (or cut) into each
    train_data = SyntheticFreiHand(n=2 * BATCH, render_joints=True, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tmp = tempfile.mkdtemp()
    probe = Trainer(cfg, train_data, model_dir=tmp, seed=SEED, device=dev)
    probe.graphs = None
    train_batch = probe.preprocess(gen, train_data.host_batch(
        np.arange(BATCH)))
    scale_projection(probe.model, train_batch.image)
    weight = probe.model.head.final_layer.weight.detach().clone()
    del probe

    # ---- a. one NCCL rank, the chunk captured with its collectives
    init_distributed("cuda")
    nccl_version = torch.cuda.nccl.version()
    check(dist.get_backend() == "nccl" and nccl_version >= (2, 9, 6),
          f"phase 11a runs over {dist.get_backend()} with NCCL "
          f"{nccl_version}, expected nccl >= 2.9.6 (collectives in a CUDA "
          f"graph)")
    mesh = make_mesh()

    # sync-BN layer by layer at the stem's and layer4's shapes, float32 and
    # bf16 inputs (float32 statistics and parameters), against BatchNorm
    # in float64 on the same inputs and cotangents (its plain version),
    # rounded to the outputs' dtypes: y, dx, dw and db, as compare_grads
    # holds a backward kernel (GRAD_REL of the dtype plus 1e-4 of the
    # largest entry). cuDNN's BatchNorm is held to the same float64 values
    # beside it, for reference only: with bf16 inputs its weight and bias
    # gradients are a bf16 computation's
    for dt, (N, C, H, W) in itertools.product(
            (torch.float32, torch.bfloat16),
            ((BATCH, 64, 112, 112), (BATCH, 2048, 7, 7))):
        x = (3 * torch.randn(N, C, H, W, device=dev, generator=g) + 1).to(
            dt).contiguous(memory_format=torch.channels_last)
        # the cotangent as it reaches y: rounded to y's dtype
        cot = torch.randn(N, C, H, W, device=dev, generator=g).to(dt)
        bns = {}
        for kind in ("sync", "cudnn", "float64"):
            bn = torch.nn.BatchNorm2d(C).to(dev)
            with torch.no_grad():
                bn.weight.copy_(torch.linspace(0.5, 1.5, C))
                bn.bias.copy_(torch.linspace(-0.5, 0.5, C))
            if kind == "sync":
                bn = convert_sync_batchnorm(torch.nn.Sequential(bn),
                                            mesh)[0]
            bns[kind] = bn.double() if kind == "float64" else bn

        def run(kind):
            bn = bns[kind]
            bn.zero_grad(set_to_none=True)
            wide = kind == "float64"
            xi = (x.double() if wide else x).detach().requires_grad_(True)
            y = bn(xi)
            y.backward(cot.double() if wide else cot)
            out = (y.detach(), xi.grad, bn.weight.grad, bn.bias.grad)
            if wide:
                out = (out[0].to(dt), out[1].to(dt), out[2].float(),
                       out[3].float())
            return out
        name = f"sync-BN over one NCCL rank {(N, C, H, W)} {dt}"
        compare_grads(f"{name} (y, dx, dw, db) vs BatchNorm in float64",
                      lambda: run("sync"), lambda: run("float64"), 1e-4)
        want = run("float64")
        got = run("cudnn")
        rel = [float((a.float() - b.float()).abs().max())
               / float(b.float().abs().max()) for a, b in zip(got, want)]
        print(f"[kernels] {name}: cuDNN's BatchNorm against float64, max|d|"
              f" / max (y, dx, dw, db): "
              f"{', '.join(f'{r:.2e}' for r in rel)} (not held)",
              flush=True)
        del bns, x, cot

    # one float32 step from one state, the projection scaled: the loss
    # (the forward is well conditioned) against the step without a mesh;
    # the gradients' distance is printed, not held: this random-weight
    # R50's float32 gradient is itself ~1 % from its float64 value with
    # either BatchNorm (tests/test_torch_mesh_train.py holds the mesh's
    # step to the JAX step at float64)
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  compute_dtype="float32"))
    steps = {}
    for use in (True, False):
        model = get_pose_net(cfg32.model, generator=torch.Generator()
                             .manual_seed(SEED)).to(dev)
        set_projection(model, weight)
        if use:
            place_state(mesh, convert_sync_batchnorm(model, mesh))
        opt = make_optimizer(model.parameters(), cfg32.train)
        out = make_train_step(model, opt, multistep_schedule(
            opt, 1, cfg.train.lr_dec_epoch, cfg.train.lr_dec_factor), cfg32,
            mesh=mesh if use else None)(train_batch)
        steps[use] = (float(out["loss"]),
                      {n: p.grad for n, p in model.named_parameters()})
        del model, opt
    total, worst, worst_name = grad_distance(steps[True][1], steps[False][1])
    d_loss = abs(steps[True][0] - steps[False][0]) / abs(steps[False][0])
    print(f"[mesh] a. one train step on one NCCL rank (sync-BN, the "
          f"gradient all-reduce) against the step without a mesh, R50 at "
          f"float32 compute, batch {BATCH}, from one state: loss "
          f"{steps[True][0]:.6f} vs {steps[False][0]:.6f} (rel d "
          f"{d_loss:.3e}, tol {MESH_STEP_LOSS_REL:g}); gradients whole "
          f"{total:.3e}, worst leaf {worst:.3e} ({worst_name}), not held",
          flush=True)
    check(d_loss <= MESH_STEP_LOSS_REL,
          "phase 11a: the mesh's train step disagrees with the step without "
          "a mesh")
    del steps

    # Trainer.run_epoch over 8 steps, scan_steps=4 (the first chunk eager,
    # the second captured and replayed) from the Trainer's own init: the
    # mesh's replay against the same Trainer run eagerly (bitwise, cuDNN
    # deterministic), and against the Trainer without a mesh
    all_reduce = dist.all_reduce
    issued = collections.Counter()

    def counted(*args, **kwargs):
        # all-reduces issued while a stream captures: the chunk's own
        issued[torch.cuda.is_current_stream_capturing()] += 1
        return all_reduce(*args, **kwargs)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    for name, use, graphs in (("mesh", True, True), ("eager", True, False),
                              ("plain", False, True)):
        t = Trainer(cfg, train_data, model_dir=tmp, seed=SEED, device=dev,
                    scan_steps=GRAPH_CHUNK, mesh=mesh if use else None)
        if not graphs:
            t.graphs = None
        for k in kernels.KERNELS:
            k.launches = 0
        issued.clear()
        dist.all_reduce = counted
        try:
            m0 = t.run_epoch(0, num_steps=GRAPH_CHUNK)     # eager warm-up
            m1 = t.run_epoch(1, num_steps=GRAPH_CHUNK)     # capture, replay
        finally:
            dist.all_reduce = all_reduce
        torch.cuda.synchronize()
        run = {"losses": (m0["loss"], m1["loss"]),
               "state": {k: v.detach().clone()
                         for k, v in training_state(t).items()},
               "params": {k: v.detach().clone()
                          for k, v in t.model.named_parameters()},
               "issued": issued[True]}
        if graphs:
            run["launches"] = path_launches(t.graphs)
            (graph,) = t.graphs.graphs.values()
            names = kernels.graph_kernel_names(graph)
            run["nodes"] = (sum("nccl" in n.lower() for n in names),
                            len(names))
            run["replay_ms"] = event_ms(graph.replay, 3) / GRAPH_CHUNK
            del graph
        runs[name] = run
        del t
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    mesh_run, eager, plain = runs["mesh"], runs["eager"], runs["plain"]
    add(mesh_run["launches"])
    n_steps = 2 * GRAPH_CHUNK
    bitwise = all(torch.equal(v, eager["state"][k])
                  for k, v in mesh_run["state"].items())
    dparam = param_distance(mesh_run["params"], plain["params"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(mesh_run["losses"], plain["losses"]))
    want = {k.symbol: (n_steps if k in (
        kernels.HEAD_PROJECTION_INTEGRAL_FWD,
        kernels.HEAD_PROJECTION_INTEGRAL_BWD, kernels.WARP_TWOPASS) else 0)
        for k in kernels.KERNELS}
    print(f"[mesh] a. Trainer(mesh=make_mesh()) on one NCCL rank, "
          f"ModelConfig() at batch {BATCH}, scan_steps {GRAPH_CHUNK} (the "
          f"second chunk captured, cuDNN deterministic): NCCL "
          f"{nccl_version}, {mesh_run['issued']} all-reduces issued while "
          f"the chunk was captured (none without a mesh: "
          f"{plain['issued']}), {mesh_run['nodes'][0]} NCCL kernel nodes of "
          f"its {mesh_run['nodes'][1]} (a one-rank communicator sums in "
          f"place without a kernel); the replayed training state bitwise "
          f"equal to the same Trainer run eagerly {bitwise}; losses after "
          f"{GRAPH_CHUNK} and {n_steps} steps {mesh_run['losses']} against "
          f"{plain['losses']} without a mesh (max rel d {loss_rel:.3e}, tol "
          f"{MESH_LOSS_REL:g}), parameters max |d| {dparam:.3e} (tol "
          f"{MESH_PARAM_STEP * lr * n_steps:g}); launches "
          f"{mesh_run['launches']}", flush=True)
    print(f"[mesh] a. replay of the captured chunk: "
          f"{mesh_run['replay_ms']:.3f} ms a step with the mesh (sync-BN, "
          f"{mesh_run['issued'] // GRAPH_CHUNK} all-reduces a step), "
          f"{plain['replay_ms']:.3f} ms without (CUDA events) on {card}",
          flush=True)
    check(mesh_run["issued"] > 0 and plain["issued"] == 0 and bitwise,
          "phase 11a: the captured mesh chunk holds no collective or "
          "differs from its eager run")
    check(loss_rel <= MESH_LOSS_REL
          and dparam <= MESH_PARAM_STEP * lr * n_steps,
          "phase 11a: the one-rank mesh run disagrees with the run without "
          "a mesh")
    check(mesh_run["launches"] == want,
          f"phase 11a: launches {mesh_run['launches']}, expected {want}")

    # ---- b, c' and d: two processes on the card over gloo
    det_cfg = dataclasses.replace(DetectorConfig(), resnet_style="caffe")
    det = build_detector(det_cfg, generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    frames = SyntheticFreiHand(n=PIPE_FRAMES, render_joints=True, seed=SEED)
    host = frames.host_batch(np.arange(PIPE_FRAMES))
    blob, _ = prepare_blob(torch.from_numpy(host["image"][:DET_BATCH]).to(
        dev), det_cfg)
    scale_detector_heads(det, blob)
    pose = get_pose_net(cfg.model, generator=torch.Generator().manual_seed(
        SEED))
    set_projection(pose, weight.cpu())
    pcfg = cfg.replace(detector=det_cfg)
    out_dir = tempfile.mkdtemp()
    pair = run_mesh_job("pair", 2, {
        "cfg": cfg, "seed": SEED, "n_train": 2 * BATCH,
        "steps": MESH_PAIR_STEPS, "final_weight": weight.cpu(),
        "n_test": MESH_TEST_N, "test_batch": BATCH,
        "model_batch": MESH_MODEL_BATCH, "pipe_cfg": pcfg,
        "pose": pose.state_dict(),
        "det": {k: v.cpu() for k, v in det.state_dict().items()},
        "frames": {k: host[k] for k in ("image", "K", "ref_bone_len")},
        "pipe_batch": DET_BATCH}, out_dir)
    for r in pair:
        for key in ("train_launches", "test_launches", "model2_launches"):
            add(r[key])
        for counts in r["pipe_launches"].values():
            add(counts)

    # b. against one process on the union of the two ranks' draws
    union = np.concatenate([r["sampled"] for r in pair], axis=1)
    t = Trainer(cfg, train_data, model_dir=tmp, seed=SEED, device=dev,
                scan_steps=MESH_PAIR_STEPS)
    t.graphs = None
    t.host_batches = lambda rng, num_steps: map(train_data.host_batch,
                                                union[:num_steps])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = t.run_epoch(0, num_steps=MESH_PAIR_STEPS)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3 / MESH_PAIR_STEPS
    m0, m1 = (r["metrics"] for r in pair)
    loss_rel = abs(m0["loss"] - m["loss"]) / abs(m["loss"])
    dparam = param_distance(pair[0]["params"], dict(
        t.model.named_parameters()))
    print(f"[mesh] b. Trainer over data=2 on two processes (gloo, eager: "
          f"not captured), global batch {BATCH}, {MESH_PAIR_STEPS} steps: "
          f"the ranks sampled {pair[0]['sampled'][0][:4].tolist()}... and "
          f"{pair[1]['sampled'][0][:4].tolist()}...; loss {m0['loss']:.5f} "
          f"(both ranks {m0 == m1}) against {m['loss']:.5f} on the union "
          f"batch in one process (rel d {loss_rel:.3e}, tol "
          f"{MESH_LOSS_REL:g}); parameters max |d| {dparam:.3e} (tol "
          f"{MESH_PARAM_STEP * lr * MESH_PAIR_STEPS:g})", flush=True)
    print(f"[mesh] b. time-shared on one card, not a scaling figure: "
          f"{pair[0]['train_ms_per_step']:.1f} ms a step over two gloo "
          f"ranks (16 rows each) against {one_ms:.1f} ms for one eager "
          f"process at {BATCH} rows (host clock) on {card}", flush=True)
    check(m0 == m1 and not np.array_equal(pair[0]["sampled"],
                                          pair[1]["sampled"]),
          "phase 11b: the ranks disagree or sampled the same records")
    check(loss_rel <= MESH_LOSS_REL
          and dparam <= MESH_PARAM_STEP * lr * MESH_PAIR_STEPS,
          "phase 11b: the two-rank run disagrees with the union run")
    model = get_pose_net(cfg.model).to(dev)
    model.load_state_dict(pair[0]["params"])
    set_projection(model, weight)
    test_data = SyntheticFreiHand(n=MESH_TEST_N, render_joints=True,
                                  seed=SEED + 1)
    t0 = time.perf_counter()
    want_coords, _ = Tester(cfg, test_data, model, device=dev).run(
        batch_size=BATCH)
    one_ms = (time.perf_counter() - t0) * 1e3
    e = max(float(np.abs(r["tester_coords"] - want_coords).max())
            for r in pair)
    print(f"[mesh] b. Tester over data=2, {MESH_TEST_N} samples at batch "
          f"{BATCH} (the tail padded), the trained weights with the scaled "
          f"projection: coords max|d| {e:.3e} against one "
          f"rank (tol {COORD_TOL:g}); {pair[0]['test_ms']:.1f} ms for the "
          f"sweep time-shared over two ranks against {one_ms:.1f} ms on one "
          f"(host clock, first sweep of each, on {card})", flush=True)
    check(e <= COORD_TOL, "phase 11b: the Tester over the mesh disagrees "
          "with one rank")
    del t, model

    # c'. data=1 x model=2 at 21 joints: the gathered weight
    shapes = pair[0]["model2_split_shapes"]
    m2 = [r["model2_metrics"]["loss"] for r in pair]
    head = [(r["model2_launches"][kernels.HEAD_PROJECTION_INTEGRAL_FWD.symbol],
             r["model2_launches"][kernels.HEAD_PROJECTION_INTEGRAL_BWD.symbol])
            for r in pair]
    print(f"[mesh] c. data=1 x model=2 at {J} joints: head_model_split "
          f"{pair[0]['split_21_on_2']}, the final projection's blocks "
          f"{shapes}, one step's loss {m2} with kernels 3 and 4 launched "
          f"{head} a rank at all {J} joints on the gathered weight",
          flush=True)
    check(not pair[0]["split_21_on_2"]
          and shapes.get("head.final_layer.weight", (0,))[0] == J * D // 2
          and all(math.isfinite(v) for v in m2) and m2[0] == m2[1]
          and all(h == (1, 1) for h in head),
          "phase 11c: the model=2 path at 21 joints did not run as it should")

    # d. the two-stage pipeline over data=2
    for mode in ("float", "int8"):
        got, one = pair[0][f"{mode}_mesh"], pair[0][f"{mode}_one"]
        e_c = float((got["coords_label"] - one["coords_label"]).abs().max())
        box = one["crop_bbox"]
        e_b = float(((got["crop_bbox"] - box).abs() - BOX_TOL_ABS
                     - BOX_TOL_REL * box.abs()).max())
        same = all(torch.equal(pair[0][f"{mode}_mesh"][f],
                               pair[1][f"{mode}_mesh"][f]) for f in got)
        print(f"[mesh] d. TwoStagePipeline(mesh) {mode} over two gloo ranks, "
              f"{PIPE_FRAMES} frames at batch {DET_BATCH}: coords max|d| "
              f"{e_c:.3e} (tol {COORD_TOL:g}), crop boxes within tol "
              f"{e_b <= 0}, both ranks' outputs equal {same}; "
              f"{pair[0][f'{mode}_mesh_ms_per_batch']:.1f} ms a batch "
              f"time-shared over two ranks against "
              f"{pair[0][f'{mode}_one_ms_per_batch']:.1f} ms on one rank "
              f"(host clock) on {card}; launches "
              f"{pair[0]['pipe_launches'][mode]}",
              flush=True)
        check(e_c <= COORD_TOL and e_b <= 0 and same, f"phase 11d: the "
              f"{mode} pipeline over the mesh disagrees with one rank")
    del det, pose, pair

    # ---- c. three processes, data=1 x model=3: 7 joints a rank
    ccfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=MESH_MODEL_BATCH))
    rows = np.arange(MESH_MODEL_BATCH)
    tb = type(train_batch)(*[None if v is None else v[:MESH_MODEL_BATCH]
                             for v in train_batch])
    eh = test_data.host_batch(rows)
    eb = make_eval_batch(*(torch.from_numpy(eh[k]).to(dev) for k in
                           ("image", "joint_cam", "K")), None,
                         torch.from_numpy(eh["ref_bone_len"]).to(dev),
                         cfg.augment, cfg.model.input_shape)
    model3 = run_mesh_job("model3", 3, {
        "cfg": ccfg, "seed": SEED, "final_weight": weight.cpu(),
        "eval_batch": type(eb)(*[None if v is None else v.cpu() for v in eb]),
        "train_batch": type(tb)(*[None if v is None else v.cpu()
                                  for v in tb])}, out_dir)
    for r in model3:
        add(r["launches"])
    # the data-only run: the same sync-BN over this process's one rank,
    # the head whole, so the split is the one difference
    model = get_pose_net(cfg.model, generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    set_projection(model, weight)
    place_state(mesh, convert_sync_batchnorm(model, mesh))
    want_coords = make_eval_fn(model, ccfg, True, mesh)(eb)[0]
    e = max(float((r["coords"].to(dev) - want_coords).abs().max())
            for r in model3)
    opt = make_optimizer(model.parameters(), ccfg.train)
    step = make_train_step(model, opt, multistep_schedule(
        opt, 1, ccfg.train.lr_dec_epoch, ccfg.train.lr_dec_factor), ccfg,
        mesh=mesh)
    loss = float(step(tb)["loss"])
    want = {n: p.grad for n, p in model.named_parameters()}
    got = dict(model3[0]["grads"])
    for n in model3[0]["block_shapes"]:
        got[n] = torch.cat([r["grads"][n] for r in model3])
    total, worst_leaf, worst = grad_distance(got, want)
    fwd = kernels.HEAD_PROJECTION_INTEGRAL_FWD.symbol
    bwd = kernels.HEAD_PROJECTION_INTEGRAL_BWD.symbol
    print(f"[mesh] c. data=1 x model=3 on three processes (gloo): "
          f"head_model_split {model3[0]['split']}, blocks "
          f"{model3[0]['block_shapes']}; eval coords at batch "
          f"{MESH_MODEL_BATCH} max|d| {e:.3e} against the data-only run "
          f"(tol {COORD_TOL:g}); one step's loss "
          f"{[r['loss'] for r in model3]} against {loss:.5f}, gradients "
          f"worst leaf {worst_leaf:.3e} at {worst} (tol "
          f"{GRAD_LEAF_REL_BF16:g}), whole {total:.3e} (tol "
          f"{GRAD_TOTAL_REL_BF16:g}); kernels 3 and 4 launched "
          f"{[(r['launches'][fwd], r['launches'][bwd]) for r in model3]} "
          f"a rank at 7 joints", flush=True)
    check(model3[0]["split"]
          and model3[0]["block_shapes"]["head.final_layer.weight"][0]
          == J * D // 3 and e <= COORD_TOL
          and worst_leaf <= GRAD_LEAF_REL_BF16
          and total <= GRAD_TOTAL_REL_BF16
          and all((r["launches"][fwd], r["launches"][bwd]) == (2, 1)
                  for r in model3),
          "phase 11c: the model=3 split disagrees with the data-only run")
    del model, opt, step, want, got
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches, err


# The utilities phase (12): the ImageNet-initialised, profiled Trainer runs
# one epoch of UTIL_CHUNKS chunks of UTIL_SCAN steps at batch 32: the
# eager warm-up, the capture (and first replay) and a replay, the JAX
# Trainer's profiler window (itr >= 2 * scan_steps).
UTIL_SCAN = 2
UTIL_CHUNKS = 3
# the hand-written kernels a bf16 train step launches, by device function:
# kernel 3's, kernel 4's two and kernel 5's
UTIL_TRACE_KERNELS = ("hp_fwd_mma_kernel", "hp_bwd_dfeat_mma_kernel",
                      "hp_bwd_dweight_mma_kernel", "warp_kernel")


def imagenet_state_dict(resnet_type: int, seed: int) -> dict:
    """A torchvision-shaped ImageNet ResNet state dict drawn from `seed`:
    torchvision's names and shapes (the backbone's, which keeps them) with
    its fc head; convs He-scaled normal, BN scale U(0.5, 1.5), bias and
    running mean N(0, 0.1), running var U(0.5, 1.5), counters 0."""
    from hand_integral_pose_estimation_tpu_torch.models.resnet import (
        ResNetBackbone,
    )

    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in ResNetBackbone(resnet_type).state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros_like(v)
        elif v.dim() == 4:
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            out[k] = torch.randn(v.shape, generator=g) * (2.0 / fan_in) ** 0.5
        elif k.endswith(("weight", "running_var")):
            out[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            out[k] = torch.randn(v.shape, generator=g) * 0.1
    width = 512 * (4 if resnet_type >= 50 else 1)
    out["fc.weight"] = torch.randn(1000, width, generator=g) * 0.01
    out["fc.bias"] = torch.zeros(1000)
    return out


def trace_kernels(path: str) -> collections.Counter:
    """Device kernel events of a Chrome trace by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(e.get("name", "") for e in events
                               if e.get("cat") == "kernel")


def head_kernels_traced(fn):
    """`fn()` run under torch.profiler: its result and the launches of each
    of the fused head's device kernels (`kernels.MMA_KERNELS`,
    `F32_MMA_KERNELS`, `SLICE_MMA_KERNELS`; "name<k>" for a template's
    instantiation at k) among the trace's kernel events, by name. The
    entry points' counts say how often an entry was called; this says
    which of its device kernels ran."""
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    names = (kernels.MMA_KERNELS + kernels.F32_MMA_KERNELS
             + kernels.SLICE_MMA_KERNELS)
    # demangled ("name<3>(") or mangled ("20nameILi3E") kernel names
    pattern = re.compile("(" + "|".join(names) + r")(?:<(\d+)>|ILi(\d+)E)?")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    found = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = pattern.search(e.name)
        if m:
            arg = m.group(2) or m.group(3)
            found[m.group(1) + (f"<{arg}>" if arg else "")] += 1
    return out, found


def utilities_phase(dev, g, card, cfg):
    """Phase 12: the utilities on the card. Returns the launches of the
    phase's main runs (`entry()`, the ImageNet-initialised profiled
    `Trainer.fit`, `cli.find_mean_std`) by kernel symbol; the dry run's
    ranks are processes of their own, and their launches are checked
    from rank 0's lines, not added."""
    from hand_integral_pose_estimation_tpu_torch.cli import (
        find_mean_std as mean_std_cli,
    )
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.entry import (
        dryrun_multichip,
        entry,
    )
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
        head_projection_integral_reference,
    )
    from hand_integral_pose_estimation_tpu_torch.training import Trainer
    from hand_integral_pose_estimation_tpu_torch.utils import Timer

    t_phase = time.perf_counter()
    launches = {k.symbol: 0 for k in kernels.KERNELS}

    def reset():
        for k in kernels.KERNELS:
            k.launches = 0

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # ---- a. entry(): the R50 pose net at 8 x 224^2, decoded by kernel 3,
    # its projection scaled to a peaked softmax on seeded images
    fn, (model, example) = entry()
    check(example.device.type == "cuda" and next(
        model.parameters()).device.type == "cuda",
        "entry() did not place its model and images on the card")
    images = torch.rand(example.shape, generator=g, device=dev)
    scale_projection(model, images)
    reset()
    coords = fn(model, images)
    torch.cuda.synchronize()
    counts = path_launches()
    add(counts)
    with torch.no_grad():
        feats = model(images, return_features=True)
        w, b = model.final_projection()
        want = head_projection_integral_reference(
            feats, w, b, model.cfg.num_joints, model.cfg.depth_dim)[0]
    e_entry = float((coords - want).abs().max())
    n3 = counts[kernels.HEAD_PROJECTION_INTEGRAL_FWD.symbol]
    print(f"[utils] entry(): coords {tuple(coords.shape)} {coords.dtype}, "
          f"max|d| from the plain head on the same features {e_entry:.3e} "
          f"(tol {COORD_TOL:g}), kernel 3 launches {n3}, on {card}",
          flush=True)
    check(tuple(coords.shape) == (8, 21, 3) and bool(coords.isfinite().all())
          and e_entry <= COORD_TOL and n3 == 1,
          "phase 12a: entry() disagrees with the plain head or did not "
          "launch kernel 3 once")
    del fn, model, example, images, feats, coords, want

    # ---- b. an ImageNet-initialised Trainer, profiled and not, one epoch
    # of three chunks, in turns (cuDNN deterministic: the runs bitwise);
    # the first profiled run is the counted one
    steps = UTIL_SCAN * UTIL_CHUNKS
    data = SyntheticFreiHand(n=2 * BATCH, render_joints=True, seed=SEED)
    runs = {}
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50-imagenet.pth")
        sd = imagenet_state_dict(cfg.model.resnet_type, SEED)
        torch.save(sd, path)
        fresh = Trainer(cfg, data, model_dir=os.path.join(tmp, "fresh"),
                        seed=SEED, device=dev).model.state_dict()
        for name in ("plain", "profiled", "profiled again", "plain again"):
            run_dir = os.path.join(tmp, name.replace(" ", "_"))
            t = Trainer(cfg, data, model_dir=run_dir, seed=SEED, device=dev,
                        scan_steps=UTIL_SCAN, imagenet_init=path,
                        log_dir=os.path.join(run_dir, "log"),
                        metrics_dir=os.path.join(run_dir, "metrics"),
                        profile_dir=(os.path.join(run_dir, "profile")
                                     if name.startswith("profiled")
                                     else None))
            state = t.model.state_dict()
            own = [k for k in state if k.startswith("backbone.")
                   and not k.endswith("num_batches_tracked")]
            init_ok = (len(own) == len(sd) - 2 - sum(
                k.endswith("num_batches_tracked") for k in sd) and all(
                torch.equal(state[k].cpu(), sd[k[len("backbone."):]])
                for k in own) and all(
                torch.equal(state[k], fresh[k]) for k in state
                if k not in own))
            check(init_ok, f"phase 12b ({name}): after init the backbone "
                  f"is not the file's or the rest not a fresh Trainer's")
            chunk_s = []

            class Recording(Timer):
                def toc(self, average=True):
                    out = super().toc(average)
                    chunk_s.append(self.diff)
                    return out

            t.total_timer = Recording()
            reset()
            t0 = time.perf_counter()
            t.fit(end_epoch=1, steps_per_epoch=steps)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            counts = path_launches(t.graphs)
            with open(os.path.join(run_dir, "metrics", "events.jsonl")) as f:
                losses = [json.loads(line)["train/loss"] for line in f]
            with open(os.path.join(run_dir, "log", "train_logs.txt")) as f:
                log = f.read()
            runs[name] = dict(counts=counts, losses=losses, chunk_s=chunk_s,
                              fit_s=fit_s, log=log,
                              state=training_state(t))
            if name == "profiled":
                add(counts)
                trace_path = os.path.join(run_dir, "profile",
                                          "trace_rank0.json")
                check(os.path.exists(trace_path),
                      "phase 12b: the profiler wrote no trace_rank0.json")
                trace_mb = os.path.getsize(trace_path) / 1e6
                traced = trace_kernels(trace_path)
            del t
    torch.backends.cudnn.deterministic = False

    prof, plain = runs["profiled"], runs["plain"]
    others = [runs[k] for k in ("profiled again", "plain again")]
    want_counts = {k.symbol: (steps if k in (
        kernels.HEAD_PROJECTION_INTEGRAL_FWD,
        kernels.HEAD_PROJECTION_INTEGRAL_BWD, kernels.WARP_TWOPASS) else 0)
        for k in kernels.KERNELS}
    in_trace = {name: sum(n for key, n in traced.items() if name in key)
                for name in UTIL_TRACE_KERNELS}
    differ = [k for k in plain["state"] if not all(
        torch.equal(plain["state"][k], r["state"][k])
        for r in (prof, *others))]
    log_lines = [line for line in prof["log"].splitlines() if "itr " in line]
    print(f"[utils] ImageNet-initialised Trainer.fit, R50 at batch {BATCH}, "
          f"scan_steps={UTIL_SCAN}, {UTIL_CHUNKS} chunks (eager warm-up, "
          f"capture, replay) with profile_dir against without, twice in "
          f"turns: losses {prof['losses']} and {plain['losses']}, the four "
          f"runs' state: "
          f"{len(plain['state']) - len(differ)} of {len(plain['state'])} "
          f"tensors bitwise equal; launches {prof['counts']}; the trace "
          f"({trace_mb:.1f} MB) names {in_trace} (the graph's replays and "
          f"the eager chunk); {len(log_lines)} epoch lines in "
          f"train_logs.txt, the first: {log_lines[:1]}", flush=True)
    for name, r in runs.items():
        print(f"[utils] {name}: per-chunk time (the Trainer's total timer, "
              f"host clock) {['%.4f' % x for x in r['chunk_s']]} s, fit "
              f"{r['fit_s']:.3f} s (snapshot and any trace export "
              f"included), on {card}", flush=True)
    check(all(r["losses"] == plain["losses"] for r in (prof, *others))
          and not differ, f"phase 12b: a profiled run differs from the "
          f"unprofiled one ({len(differ)} tensors)")
    check(all(r["counts"] == want_counts for r in runs.values()),
          f"phase 12b: launches {prof['counts']}, expected {want_counts}")
    check(all(n >= steps for n in in_trace.values()),
          f"phase 12b: the trace does not name kernels 3, 4 and 5 in every "
          f"step: {in_trace}")
    check(len(log_lines) >= 1 and all("h/epoch" in line
                                      for line in log_lines)
          and "backbone initialised from ImageNet weights" in prof["log"]
          and "profiler trace written" in prof["log"],
          "phase 12b: train_logs.txt lacks the epoch's lines")

    # ---- c. cli.find_mean_std on the card, against numpy's exact float64
    # statistics of the same samples (integer sums)
    t0 = time.perf_counter()
    mean, std = mean_std_cli.main(["--synthetic", "--device", "cuda"])
    mean_s = time.perf_counter() - t0
    n = 256
    pixels = SyntheticFreiHand(n=n).host_batch(
        np.arange(n))["image"].reshape(-1, 3).astype(np.int64)
    ex_mean = pixels.sum(0) / (255.0 * pixels.shape[0])
    ex_std = np.sqrt((pixels ** 2).sum(0) / (255.0 ** 2 * pixels.shape[0])
                     - ex_mean ** 2)
    e_ms = max(float(np.abs(mean - ex_mean).max()),
               float(np.abs(std - ex_std).max()))
    print(f"[utils] cli.find_mean_std --synthetic --device cuda ({n} x "
          f"224^2): max|d| from numpy's exact float64 statistics {e_ms:.3e} "
          f"(tol 1e-12), {mean_s:.2f} s on {card}", flush=True)
    check(e_ms <= 1e-12, "phase 12c: find_mean_std disagrees with numpy")

    # ---- e. dryrun_multichip(2) on the card: two ranks share it over gloo
    # (eager chunks); each arm's line must be finite and name the fused
    # head's forward and backward and the warp among rank 0's launches
    t0 = time.perf_counter()
    lines = dryrun_multichip(2).splitlines()
    dry_s = time.perf_counter() - t0
    print(f"[utils] dryrun_multichip(2) on the card: {dry_s:.1f} s (two "
          f"processes started, the kernel library loaded in each), on "
          f"{card}", flush=True)
    need = {kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32.symbol,
            kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32.symbol,
            kernels.WARP_TWOPASS.symbol}
    dry_ok = len(lines) == 2
    for line in lines:
        fields = dict(f.split("=", 1) for f in line.split()
                      if f.startswith(("loss=", "eval_pa_mpjpe=",
                                       "launches=")))
        ran = {kv.split(":")[0] for kv in fields.get("launches",
                                                     "").split(",")}
        dry_ok &= (len(fields) == 3 and need <= ran and all(
            math.isfinite(float(fields[k]))
            for k in ("loss", "eval_pa_mpjpe")))
    check(dry_ok, f"phase 12e: dryrun_multichip(2) on the card: {lines}")
    print(f"[utils] phase 12 took {time.perf_counter() - t_phase:.1f} s on "
          f"{card}", flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA GPU")

    from hand_integral_pose_estimation_tpu_torch.config import Config
    from hand_integral_pose_estimation_tpu_torch.data import (
        SyntheticFreiHand,
        make_eval_batch,
    )
    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        evaluate_test_split,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
        head_projection_integral_bwd_cuda,
        head_projection_integral_bwd_reference,
        head_projection_integral_cuda,
        head_projection_integral_reference,
    )
    from hand_integral_pose_estimation_tpu_torch.ops.integral import (
        channel_constants,
        softmax_integral_bwd_cuda,
        softmax_integral_bwd_reference,
        softmax_integral_chunks,
        softmax_integral_cuda,
        softmax_integral_reference,
    )
    from hand_integral_pose_estimation_tpu_torch.ops.warp import (
        warp_normalise_batch,
        warp_normalise_twopass,
        warp_perspective_cuda,
        warp_perspective_twopass,
    )
    from hand_integral_pose_estimation_tpu_torch.training import (
        Tester,
        Trainer,
        compare_state_dicts,
        load_checkpoint,
    )
    from hand_integral_pose_estimation_tpu_torch.training.trainer import (
        EVAL_FIELDS,
    )

    # ---- 1. device
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"[build] {lib_path.name} from {kernels.CSRC.name}/ in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tensor_core = kernels.tensor_core_instructions()
    tensor_core32 = kernels.tensor_core_instructions(kernels.F32_MMA_KERNELS)
    tensor_core_wide = kernels.tensor_core_instructions(
        kernels.SLICE_MMA_KERNELS)
    print(f"[build] tensor-core product instructions (HMMA / HGMMA) in the "
          f"SASS of the fused head's bf16 kernels: {tensor_core}; of the "
          f"float32-feature route (3f and 4f): {tensor_core32}; of both "
          f"routes' kernels past 256 features: {tensor_core_wide}",
          flush=True)
    check(all(n > 0 for n in (*tensor_core.values(),
                              *tensor_core32.values(),
                              *tensor_core_wide.values())),
          f"a tensor-core fused-head kernel has no tensor-core product: "
          f"{tensor_core}, {tensor_core32}, {tensor_core_wide}")

    # ---- 3. kernels against their plain versions
    g = torch.Generator(device=dev).manual_seed(SEED)
    cfg = Config()
    J, D = cfg.model.num_joints, cfg.model.depth_dim
    Ho, Wo = cfg.model.output_shape
    F = cfg.model.deconv_channels
    IH, IW = cfg.model.input_shape
    err = {name: 0.0 for name in (
        "softmax_integral_fwd", "head_projection_integral_fwd",
        "softmax_integral_bwd", "head_projection_integral_bwd",
        "warp_twopass", "head_projection_integral_fwd_f32",
        "head_projection_integral_bwd_f32", *WIDE_ROWS)}
    shapes = ((BATCH, Ho, Wo, J, D, F), (1, 8, 8, 3, 4, 40),
              (3, 7, 5, 2, 100, 40), (2, 7, 5, 3, WIDE_DEPTH, 40))
    for (B, H, W, j, d, f) in shapes:
        for dt in (torch.float32, torch.bfloat16):
            hm = (3 * torch.randn(B, H, W, j * d, device=dev,
                                  generator=g)).to(dt)
            e = compare(f"softmax_integral_fwd {(B, H, W, j * d)} {dt}",
                        lambda: softmax_integral_cuda(hm, j, d),
                        lambda: softmax_integral_reference(hm, j, d))
            err["softmax_integral_fwd"] = max(err["softmax_integral_fwd"], e)
            coords, m, s = softmax_integral_reference(hm, j, d)
            cot = torch.randn(B, j, 3, device=dev, generator=g)
            e = compare_grads(
                f"softmax_integral_bwd {(B, H, W, j * d)} {dt}",
                lambda: (softmax_integral_bwd_cuda(hm, m, s, coords, cot, j,
                                                   d),),
                lambda: (softmax_integral_bwd_reference(hm, m, s, coords,
                                                        cot, j, d),),
                GRAD_ABS_SCALE["softmax_integral_bwd"])
            err["softmax_integral_bwd"] = max(err["softmax_integral_bwd"], e)
    # kernel 1's vectorised path at batch 1 (the planner's most chunks),
    # with more chunks than rows (empty chunks), on hm[1:] of an odd batch
    # and on a base off 16 bytes (the generic path); two calls at the
    # serving shape give the same bits
    for dt in (torch.float32, torch.bfloat16):
        hm = (3 * torch.randn(1, Ho, Wo, J * D, device=dev,
                              generator=g)).to(dt)
        for n, run in (
                (softmax_integral_chunks(hm),
                 lambda: softmax_integral_cuda(hm, J, D)),
                (Ho * Wo + 37,
                 lambda: softmax_integral_with_chunks(hm, J, D, Ho * Wo + 37))):
            e = compare(f"softmax_integral_fwd {tuple(hm.shape)} {dt}, "
                        f"{n} chunks", run,
                        lambda: softmax_integral_reference(hm, J, D))
            err["softmax_integral_fwd"] = max(err["softmax_integral_fwd"], e)
        hm = (3 * torch.randn(3, 7, 5, 2 * 100 + 1, device=dev,
                              generator=g)).to(dt)
        for name, view in (
                ("hm[1:]", hm[..., :200].contiguous()[1:]),
                ("a base off 16 bytes",
                 hm.reshape(-1)[1:1 + 3 * 7 * 5 * 200].view(3, 7, 5, 200))):
            e = compare(f"softmax_integral_fwd {tuple(view.shape)} {dt} on "
                        f"{name} ({softmax_integral_chunks(view)} chunks)",
                        lambda: softmax_integral_cuda(view, 2, 100),
                        lambda: softmax_integral_reference(view, 2, 100))
            err["softmax_integral_fwd"] = max(err["softmax_integral_fwd"], e)
    hm = (3 * torch.randn(BATCH, Ho, Wo, J * D, device=dev,
                          generator=g)).to(torch.bfloat16)
    first = softmax_integral_cuda(hm, J, D)
    again = softmax_integral_cuda(hm, J, D)
    same = all(torch.equal(x, y) for x, y in zip(first, again))
    print(f"[kernels] softmax_integral_fwd run twice at {tuple(hm.shape)}: "
          f"coords, m and s bitwise equal: {same}", flush=True)
    check(same, "the soft-argmax forward is not deterministic")
    del hm, first, again

    # kernels 3 and 4 also at the two-stage path's pose batch and the
    # teacher sweep's 168 crops (float32, forward only), with bf16
    # features and float32 ones (both on the tensor cores; their own err
    # keys), each forward and backward twice at the serving shape for the
    # same bits
    for (B, H, W, j, d, f), fdt in itertools.product(
            shapes + ((DET_BATCH, Ho, Wo, J, D, F),
                      (SWEEP_CROPS, Ho, Wo, J, D, F)),
            (torch.bfloat16, torch.float32)):
        if B == SWEEP_CROPS and fdt == torch.bfloat16:
            continue
        sfx = "_f32" if fdt == torch.float32 else ""
        feats = torch.randn(B, H, W, f, device=dev, generator=g).to(fdt)
        w = 0.3 * torch.randn(j * d, f, device=dev, generator=g)
        b = torch.randn(j * d, device=dev, generator=g)
        e = compare(f"head_projection_integral_fwd {(B, H, W, f)}x"
                    f"{(j * d, f)} {fdt}/f32",
                    lambda: head_projection_integral_cuda(feats, w, b, j, d),
                    lambda: head_projection_integral_reference(feats, w, b, j,
                                                               d))
        err["head_projection_integral_fwd" + sfx] = max(
            err["head_projection_integral_fwd" + sfx], e)
        if B in (BATCH, SWEEP_CROPS):
            first = head_projection_integral_cuda(feats, w, b, j, d)
            again = head_projection_integral_cuda(feats, w, b, j, d)
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            print(f"[kernels] head_projection_integral_fwd {fdt} features "
                  f"at batch {B} run twice: coords, m and s bitwise equal: "
                  f"{same}", flush=True)
            check(same, "the fused-head forward is not deterministic")
        if B == SWEEP_CROPS:
            del feats
            continue
        coords, m, s = head_projection_integral_cuda(feats, w, b, j, d)
        cot = torch.randn(B, j, 3, device=dev, generator=g)
        e = compare_grads(
            f"head_projection_integral_bwd {(B, H, W, f)}x{(j * d, f)} "
            f"{fdt}/f32",
            lambda: head_projection_integral_bwd_cuda(feats, w, b, m, s,
                                                      coords, cot, j, d),
            lambda: head_projection_integral_bwd_reference(feats, w, b, m, s,
                                                           coords, cot, j, d),
            GRAD_ABS_SCALE["head_projection_integral_bwd"])
        err["head_projection_integral_bwd" + sfx] = max(
            err["head_projection_integral_bwd" + sfx], e)
        if B == BATCH:
            again = head_projection_integral_bwd_cuda(feats, w, b, m, s,
                                                      coords, cot, j, d)
            first = head_projection_integral_bwd_cuda(feats, w, b, m, s,
                                                      coords, cot, j, d)
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            print(f"[kernels] head_projection_integral_bwd {fdt} features "
                  f"run twice: dW, db and dfeat bitwise equal: {same}",
                  flush=True)
            check(same, "the fused-head backward is not deterministic")
    # every kind of width and depth the JAX head takes, on the tensor cores
    # in both directions: F = 7 (odd: 2-byte copies, single stores), 38
    # (not a multiple of 8), 259 (odd, past 256), 260 (one slice past the
    # kernels that keep a block's weight planes at the whole F) and 512
    # (two passes of the N = F products) at the serving shape, D = 160 at F
    # = 256 and 512; each forward and backward twice for the same bits.
    # Their errors go to the `*_slices` rows past 256 features.
    for (B, H, W, j, d, f), fdt in itertools.product(
            ((BATCH, Ho, Wo, J, D, WIDE_FEATS[0]),
             (BATCH, Ho, Wo, J, D, WIDE_FEATS[1]), (2, 7, 5, 3, 12, 38),
             (2, 7, 5, 3, 12, 7), (2, 9, 7, 3, 24, 259),
             (2, 9, 7, 3, WIDE_DEPTH, 256),
             (2, 9, 7, 2, WIDE_DEPTH, WIDE_FEATS[1])),
            (torch.bfloat16, torch.float32)):
        sfx = ("_f32" if fdt == torch.float32 else "") + (
            "_slices" if f > 256 else "")
        feats = torch.randn(B, H, W, f, device=dev, generator=g).to(fdt)
        w = (0.3 * 16 / math.sqrt(f)) * torch.randn(j * d, f, device=dev,
                                                     generator=g)
        b = torch.randn(j * d, device=dev, generator=g)
        cot = torch.randn(B, j, 3, device=dev, generator=g)
        name = f"{(B, H, W, f)}x{(j * d, f)} {fdt}/f32"
        fwd_key = "head_projection_integral_fwd" + sfx
        err[fwd_key] = max(err[fwd_key], compare(
            f"head_projection_integral_fwd {name}",
            lambda: head_projection_integral_cuda(feats, w, b, j, d),
            lambda: head_projection_integral_reference(feats, w, b, j, d)))
        first = head_projection_integral_cuda(feats, w, b, j, d)
        again = head_projection_integral_cuda(feats, w, b, j, d)
        coords, m, s = first
        bwd_key = "head_projection_integral_bwd" + sfx
        err[bwd_key] = max(err[bwd_key], compare_grads(
            f"head_projection_integral_bwd {name}",
            lambda: head_projection_integral_bwd_cuda(feats, w, b, m, s,
                                                      coords, cot, j, d),
            lambda: head_projection_integral_bwd_reference(
                feats, w, b, m, s, coords, cot, j, d),
            GRAD_ABS_SCALE["head_projection_integral_bwd"]))
        grads = [head_projection_integral_bwd_cuda(
            feats, w, b, m, s, coords, cot, j, d) for _ in range(2)]
        same = all(torch.equal(x, y) for x, y in zip(first + grads[0],
                                                     again + grads[1]))
        print(f"[kernels] head_projection_integral {name} run twice: "
              f"coords, m, s, dfeat, dW and db bitwise equal: {same}",
              flush=True)
        check(same, f"the fused head at {name} is not deterministic")
        del feats, first, again, grads
    acfg = cfg.augment
    for (B, Hs, Ws, C, Ho2, Wo2) in ((BATCH, IH, IW, 3, IH, IW),
                                     (2, 37, 41, 3, 29, 33)):
        images = 255 * torch.rand(B, Hs, Ws, C, device=dev, generator=g)
        colour = 0.8 + 0.4 * torch.rand(B, C, device=dev, generator=g)
        Hm = homographies(B, g, dev)
        for frames, norm in itertools.product(("float32", "uint8"),
                                              (False, True)):
            e = compare_warp(
                f"{(B, Hs, Ws, C)} {frames} -> {(Ho2, Wo2)}"
                f"{', normalised' if norm else ''}",
                images.to(torch.uint8) if frames == "uint8" else images, Hm,
                (Ho2, Wo2), (colour, acfg.pixel_mean, acfg.pixel_std)
                if norm else None)
            err["warp_twopass"] = max(err["warp_twopass"], e)
    images = (255 * torch.rand(2, 16, 16, 3, device=dev, generator=g)).to(
        torch.uint8)
    colour = 0.8 + 0.4 * torch.rand(2, 3, device=dev, generator=g)
    for name, (Hm, inverse, want_nan) in degenerate_maps(dev).items():
        for norm in (False, True):
            compare_warp(f"(2, 16, 16, 3) uint8, {name} map"
                         f"{', normalised' if norm else ''}", images, Hm,
                         (16, 16), (colour, acfg.pixel_mean, acfg.pixel_std)
                         if norm else None, inverse, want_nan)

    # ---- 4. the serving slice
    model = get_pose_net(cfg.model,
                         generator=torch.Generator().manual_seed(SEED))
    dataset = SyntheticFreiHand(n=N_SAMPLES, render_joints=True, seed=SEED)
    # the eager sweeps: Testers whose graphs are set aside
    fused = Tester(cfg, dataset, model, device=dev, fuse_head=True)
    unfused = Tester(cfg, dataset, model, device=dev, fuse_head=False)
    fused.graphs = unfused.graphs = None
    probe = fused.preprocess(dataset.host_batch(np.arange(BATCH)))
    scale_projection(model, probe.image)

    for k in kernels.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    coords_f, batch_f = fused.run(batch_size=BATCH)
    coords_u, batch_u = unfused.run(batch_size=BATCH)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    serving_launches = {k.symbol: k.launches for k in kernels.KERNELS}
    n_batches = math.ceil(N_SAMPLES / BATCH)
    want_serving = {k.symbol: n_batches if k in (
        kernels.HEAD_PROJECTION_INTEGRAL_FWD, kernels.SOFTMAX_INTEGRAL_FWD)
        else 0 for k in kernels.KERNELS}
    print(f"[serving] eager: swept {N_SAMPLES} samples in {n_batches} "
          f"batches of {BATCH} per arm ({sweep_s:.2f} s host clock, first "
          f"calls included); launches {serving_launches}", flush=True)
    check(serving_launches == want_serving,
          f"serving launches {serving_launches}, expected {n_batches} of "
          f"each forward kernel and nothing else")

    # the same sweeps as CUDA-graph replays (the Tester's default on the
    # card): the first batch eager, then one replay a batch; launches are
    # the eager calls' plus each graph's kernel nodes times its replays
    fused_g = Tester(cfg, dataset, model, device=dev, fuse_head=True)
    unfused_g = Tester(cfg, dataset, model, device=dev, fuse_head=False)
    for k in kernels.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    coords_fg, batch_fg = fused_g.run(batch_size=BATCH)
    coords_ug, batch_ug = unfused_g.run(batch_size=BATCH)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    graph_launches = path_launches(fused_g.graphs, unfused_g.graphs)
    replays = [sum(t.graphs.replays.values()) for t in (fused_g, unfused_g)]
    print(f"[serving] graphs: swept {N_SAMPLES} samples per arm, "
          f"{replays} replays ({sweep_s:.2f} s host clock, captures "
          f"included); launches {graph_launches}", flush=True)
    check(graph_launches == want_serving and replays == [n_batches - 1] * 2,
          f"graph serving launches {graph_launches}, replays {replays}")
    for name, got, want in (("fused", (coords_fg, batch_fg),
                             (coords_f, batch_f)),
                            ("unfused", (coords_ug, batch_ug),
                             (coords_u, batch_u))):
        same = np.array_equal(got[0], want[0]) and all(
            (g is None and w is None) or np.array_equal(g, w)
            for g, w in zip(got[1], want[1]))
        print(f"[serving] {name} arm: graph sweep coords and Batch fields "
              f"bitwise equal to the eager sweep's: {same}", flush=True)
        check(same, f"{name}: the replayed sweep disagrees with the eager one")
    for k, v in graph_launches.items():
        serving_launches[k] += v

    for name, coords, batch in (("fused", coords_f, batch_f),
                                ("unfused", coords_u, batch_u)):
        check(coords.shape == (N_SAMPLES, J, 3), f"{name} coords shape "
              f"{coords.shape}")
        check(bool(np.isfinite(coords).all()), f"{name} coords not finite")
        check(bool((np.abs(coords) <= 0.5).all()),
              f"{name} coords outside [-0.5, 0.5]")
        summary = evaluate_test_split(coords, batch)
        print(f"[serving] {name} arm: PA-MPJPE {summary['pa_mpjpe']:.6f} m, "
              f"MPJPE {summary['mpjpe']:.6f} m, coords std "
              f"{coords.std():.4f}", flush=True)
        check(math.isfinite(summary["pa_mpjpe"])
              and math.isfinite(summary["mpjpe"]),
              f"{name} metrics not finite: {summary}")
    check(coords_f.std() > 0.02, f"decoded coords are degenerate (std "
          f"{coords_f.std():.4f}): the heads are not peaked")

    with torch.inference_mode():
        feats = model(probe.image, return_features=True)
        weight, bias = model.final_projection()
        got = head_projection_integral_cuda(feats, weight, bias, J, D)
        want = head_projection_integral_reference(feats, weight, bias, J, D)
        torch.cuda.synchronize()
    e_ref = float((got[0] - want[0]).abs().max())
    e_run = float(np.abs(got[0].cpu().numpy() - coords_f[:BATCH]).max())
    peak = float((1.0 / want[2]).median())
    print(f"[serving] model + fused kernel vs model + plain head on batch 0: "
          f"max|d coords| {e_ref:.3e} (tol {COORD_TOL:g}); vs the sweep "
          f"{e_run:.3e}; median peak softmax mass 1/s {peak:.3f}", flush=True)
    check(e_ref <= COORD_TOL and e_run <= COORD_TOL,
          "fused kernel disagrees with the plain head on the model")
    d_arms = np.abs(coords_f - coords_u)
    print(f"[serving] unfused (bf16 heatmap) vs fused arm: mean|d| "
          f"{d_arms.mean():.3e} (tol {ARMS_MEAN_TOL:g}), max|d| "
          f"{d_arms.max():.3e} (tol {ARMS_MAX_TOL:g})", flush=True)
    check(d_arms.mean() <= ARMS_MEAN_TOL and d_arms.max() <= ARMS_MAX_TOL,
          "unfused and fused arms disagree")

    # the wide heads' main-path runs: the same sweep (fused arm, eager) by
    # a pose net whose deconv stack is WIDE_FEATS[0] wide at float32
    # compute and by ModelConfig(deconv_channels=WIDE_FEATS[1]) in bf16,
    # both past 256 features: their launches go to the `*_slices` rows
    wide_launches = {k.symbol: 0 for k in kernels.KERNELS}
    for f, dtype_name, entry in (
            (WIDE_FEATS[0], "float32",
             kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32),
            (WIDE_FEATS[1], "bfloat16",
             kernels.HEAD_PROJECTION_INTEGRAL_FWD)):
        cfg_w = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, deconv_channels=f, compute_dtype=dtype_name))
        model_w = get_pose_net(cfg_w.model,
                               generator=torch.Generator().manual_seed(SEED))
        tester_w = Tester(cfg_w, dataset, model_w, device=dev,
                          fuse_head=True)
        tester_w.graphs = None
        scale_projection(model_w, probe.image)
        for k in kernels.KERNELS:
            k.launches = 0
        (coords_w, _), traced = head_kernels_traced(
            lambda: tester_w.run(batch_size=BATCH))
        counts = {k.symbol: k.launches for k in kernels.KERNELS}
        parts = 1 if dtype_name == "bfloat16" else 3
        print(f"[serving] fused arm at {dtype_name} compute, deconv_channels "
              f"{f}: swept {N_SAMPLES} samples in {n_batches} batches of "
              f"{BATCH}; launches {counts}; the head's device kernels in "
              f"the trace {dict(traced)}", flush=True)
        check(counts == {k.symbol: n_batches if k is entry else 0
                         for k in kernels.KERNELS},
              f"the width-{f} sweep launched {counts}")
        check(traced == {f"hp_fwd_slices_kernel<{parts}>": n_batches},
              f"the width-{f} sweep ran the head's device kernels "
              f"{dict(traced)}")
        check(coords_w.shape == (N_SAMPLES, J, 3)
              and bool(np.isfinite(coords_w).all()),
              f"width-{f} coords malformed or not finite")
        with torch.inference_mode():
            feats = model_w(probe.image, return_features=True)
            weight, bias = model_w.final_projection()
            want = head_projection_integral_reference(feats, weight, bias, J,
                                                      D)
            torch.cuda.synchronize()
        e_run = float(np.abs(want[0].cpu().numpy() - coords_w[:BATCH]).max())
        print(f"[serving] width-{f} {dtype_name} sweep vs model + plain head "
              f"on batch 0: max|d coords| {e_run:.3e} (tol {COORD_TOL:g}), "
              f"coords std {coords_w.std():.4f}", flush=True)
        check(e_run <= COORD_TOL, f"the width-{f} sweep disagrees with the "
              f"plain head on its model")
        for k, v in counts.items():
            wide_launches[k] += v
        del tester_w, model_w, feats, want
    torch.cuda.empty_cache()

    # timing. One batch at a time between CUDA events (the device waits
    # while the host issues the batch's ops), then 20 batches back to back
    # on the host clock, ending in a synchronize (host issue overlaps device
    # work). Host batches are already on the card.
    host_np = dataset.host_batch(np.arange(BATCH))
    host = {k: (None if v is None else torch.from_numpy(
        np.ascontiguousarray(v)).to(dev)) for k, v in host_np.items()}
    host_np = {k: host_np[k] for k in EVAL_FIELDS}
    for name, tester, graphs in (("fused", fused, fused_g.graphs),
                                 ("unfused", unfused, unfused_g.graphs)):
        def step():
            batch = make_eval_batch(host["image"], host["joint_cam"],
                                    host["K"], host["bbox_detector"],
                                    host["ref_bone_len"], cfg.augment,
                                    cfg.model.input_shape)
            tester.eval_step(batch)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        times = [event_ms(step, 1) for _ in range(20)]
        med = statistics.median(times)
        print(f"[serving] {name} arm, crop + R50 + head + decode at batch "
              f"{BATCH}: median {med:.3f} ms/batch over {len(times)} "
              f"batches (min {min(times):.3f}, max {max(times):.3f}), "
              f"{BATCH / med * 1e3:.1f} img/s on {card}", flush=True)
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / 20 * 1e3
        print(f"[serving] {name} arm back to back: {per:.3f} ms/batch over "
              f"20 batches (host clock), {BATCH / per * 1e3:.1f} img/s on "
              f"{card}; host issue of one batch {issue_ms(step):.3f} ms",
              flush=True)
        print_profile(f"serving, {name} arm, batch {BATCH}", step, 5, card)
        eager_b2b = per
        (graph,) = graphs.graphs.values()
        compare_graph_timing(
            f"serving, {name} arm, batch {BATCH}", "batch", step,
            graph.replay, lambda: graphs(host_np), eager_b2b, 1, card)
    del fused, unfused, fused_g, unfused_g, model

    # ---- 5. the training slice
    train_data = SyntheticFreiHand(n=2 * BATCH, render_joints=True, seed=SEED)
    train_launches = {k.symbol: 0 for k in kernels.KERNELS}
    for fuse in (True, False):
        arm = "fused" if fuse else "unfused"
        with tempfile.TemporaryDirectory() as model_dir:
            trainer = Trainer(cfg, train_data, model_dir=model_dir,
                              seed=SEED, device=dev, fuse_head=fuse)
            trainer.graphs = None   # eager steps
            gen = torch.Generator(device=dev).manual_seed(SEED)
            batch = trainer.preprocess(
                gen, train_data.host_batch(np.arange(BATCH)))
            check(batch.image.shape == (BATCH, IH, IW, 3)
                  and bool(torch.isfinite(batch.image).all()),
                  f"{arm}: the augmented batch is malformed")
            scale_projection(trainer.model, batch.image)
            probe_images = batch.image

            # one batch, same state: the kernel-backed train step against
            # a plain-backed one, on the bf16 path and at float32 compute
            gradient_check(arm, trainer, batch, fuse, GRAD_LEAF_REL_BF16,
                           GRAD_TOTAL_REL_BF16)
            cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, compute_dtype="float32"))
            dir32 = tempfile.mkdtemp(dir=model_dir)
            trainer32 = Trainer(cfg32, train_data, model_dir=dir32,
                                seed=SEED, device=dev, fuse_head=fuse)
            trainer32.graphs = None
            scale_projection(trainer32.model, batch.image)
            gradient_check(arm + " float32", trainer32, batch, fuse,
                           GRAD_LEAF_REL_F32, GRAD_TOTAL_REL_F32)
            if fuse:
                # the float32 route's counted run: Trainer.fit at float32
                # compute, its head on kernels 3 and 4 with float32 features
                for k in kernels.KERNELS:
                    k.launches = 0
                trainer32.fit(end_epoch=1, steps_per_epoch=F32_TRAIN_STEPS)
                torch.cuda.synchronize()
                counts = {k.symbol: k.launches for k in kernels.KERNELS}
                want_counts = {k.symbol: (F32_TRAIN_STEPS if k in (
                    kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32,
                    kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32,
                    kernels.WARP_TWOPASS) else 0) for k in kernels.KERNELS}
                print(f"[training] fused arm at float32 compute: "
                      f"Trainer.fit took {F32_TRAIN_STEPS} steps at batch "
                      f"{BATCH}, launches {counts}", flush=True)
                check(counts == want_counts, f"float32 fused arm: launches "
                      f"{counts}, expected {want_counts}")
                for k, v in counts.items():
                    train_launches[k] += v
            del trainer32
            torch.cuda.empty_cache()

            # the counted run: Trainer.fit, a few steps, one snapshot
            step_losses = []
            inner = trainer.train_step

            def recording_step(b):
                out = inner(b)
                step_losses.append(out["loss"])
                return out

            trainer.train_step = recording_step
            for k in kernels.KERNELS:
                k.launches = 0
            trainer.fit(end_epoch=1, steps_per_epoch=TRAIN_STEPS)
            torch.cuda.synchronize()
            counts = {k.symbol: k.launches for k in kernels.KERNELS}
            trainer.train_step = inner
            for k, v in counts.items():
                train_launches[k] += v
            fwd, bwd = ((kernels.HEAD_PROJECTION_INTEGRAL_FWD,
                         kernels.HEAD_PROJECTION_INTEGRAL_BWD) if fuse else
                        (kernels.SOFTMAX_INTEGRAL_FWD,
                         kernels.SOFTMAX_INTEGRAL_BWD))
            want_counts = {k.symbol: (TRAIN_STEPS if k in (
                fwd, bwd, kernels.WARP_TWOPASS) else 0)
                for k in kernels.KERNELS}
            losses_host = [float(v) for v in step_losses]
            print(f"[training] {arm} arm: Trainer.fit took {TRAIN_STEPS} "
                  f"steps at batch {BATCH}, losses "
                  f"{[round(v, 5) for v in losses_host]}, launches {counts}",
                  flush=True)
            check(counts == want_counts, f"{arm}: launches {counts}, "
                  f"expected {want_counts}")
            check(len(losses_host) == TRAIN_STEPS
                  and all(math.isfinite(v) for v in losses_host),
                  f"{arm}: losses {losses_host}")
            restored = get_pose_net(cfg.model)
            epoch = load_checkpoint(model_dir, restored)
            diff = compare_state_dicts(restored.state_dict(),
                                       trainer.model.state_dict())
            print(f"[training] {arm} arm: snapshot_{epoch} reloads with max "
                  f"|d| {diff:g} against the trained state", flush=True)
            check(epoch == 0 and diff == 0.0, f"{arm}: snapshot mismatch")

            # timing: a fixed host batch augmented and stepped, one at a
            # time between CUDA events; then the Trainer's own loop (host
            # sampling, pinned copies, one sync per step) on the host clock
            host_batch = train_data.host_batch(np.arange(BATCH))

            def step():
                trainer.train_step(trainer.preprocess(gen, host_batch))

            for _ in range(2):
                step()
            torch.cuda.synchronize()
            times = [event_ms(step, 1) for _ in range(TIME_STEPS)]
            med = statistics.median(times)
            print(f"[training] {arm} arm, augment + R50 fwd/bwd + decode + "
                  f"Adam at batch {BATCH}: median {med:.3f} ms/step over "
                  f"{TIME_STEPS} steps (min {min(times):.3f}, max "
                  f"{max(times):.3f}), {BATCH / med * 1e3:.1f} img/s on "
                  f"{card}", flush=True)
            t0 = time.perf_counter()
            trainer.run_epoch(1, num_steps=TIME_STEPS)
            torch.cuda.synchronize()
            per = (time.perf_counter() - t0) / TIME_STEPS * 1e3
            print(f"[training] {arm} arm, Trainer.run_epoch back to back: "
                  f"{per:.3f} ms/step over {TIME_STEPS} steps (host clock), "
                  f"{BATCH / per * 1e3:.1f} img/s on {card}; host issue of "
                  f"one step {issue_ms(step):.3f} ms", flush=True)
            print_profile(f"train step, {arm} arm, batch {BATCH}", step, 5,
                          card, top=14)
            eager_b2b = per

            # Trainer.fit with scan_steps=1 and 4 as CUDA-graph replays,
            # each against the same Trainer run eagerly (graphs set aside)
            # from the same seed, both under cuDNN's deterministic
            # algorithms: bitwise equal parameters, statistics and Adam
            # state. The counted launches are the eager warm-up chunk's
            # plus the graph's nodes times its replays.
            for chunk in (1, GRAPH_CHUNK):
                torch.backends.cudnn.deterministic = True
                twins = {}
                for graphs in (False, True):
                    twin = Trainer(cfg, train_data, model_dir=model_dir,
                                   seed=SEED, device=dev, fuse_head=fuse,
                                   scan_steps=chunk)
                    if not graphs:
                        twin.graphs = None
                    scale_projection(twin.model, probe_images)
                    twins[graphs] = twin
                for k in kernels.KERNELS:
                    k.launches = 0
                twins[True].fit(end_epoch=1, steps_per_epoch=GRAPH_STEPS)
                torch.cuda.synchronize()
                counts = path_launches(twins[True].graphs)
                for k, v in counts.items():
                    train_launches[k] += v
                twins[False].run_epoch(0, num_steps=GRAPH_STEPS)
                torch.backends.cudnn.deterministic = False
                want_counts = {k.symbol: (GRAPH_STEPS if k in (
                    fwd, bwd, kernels.WARP_TWOPASS) else 0)
                    for k in kernels.KERNELS}
                replays = sum(twins[True].graphs.replays.values())
                state_g = training_state(twins[True])
                state_e = training_state(twins[False])
                differ = [k for k in state_e
                          if not torch.equal(state_g[k], state_e[k])]
                print(f"[training] {arm} arm: Trainer.fit with scan_steps="
                      f"{chunk}: {GRAPH_STEPS} steps, {replays} replays of "
                      f"one captured chunk after the eager warm-up chunk, "
                      f"launches {counts}; against the eager twin: "
                      f"{len(state_e) - len(differ)} of {len(state_e)} "
                      f"tensors (parameters, statistics, Adam state) "
                      f"bitwise equal", flush=True)
                check(counts == want_counts, f"{arm}, scan_steps={chunk}: "
                      f"graph launches {counts}, expected {want_counts}")
                check(replays == GRAPH_STEPS // chunk - 1,
                      f"{arm}, scan_steps={chunk}: {replays} replays")
                check(not differ, f"{arm}, scan_steps={chunk}: the replayed "
                      f"steps differ from the eager ones at {differ[:5]}")
                del twins, twin
                torch.cuda.empty_cache()

            # timing, eager against graph, with the default algorithms: a
            # fresh graph Trainer whose first epoch warms up and captures
            gtrainer = Trainer(cfg, train_data, model_dir=model_dir,
                               seed=SEED, device=dev, fuse_head=fuse,
                               scan_steps=GRAPH_CHUNK)
            scale_projection(gtrainer.model, probe_images)
            gtrainer.run_epoch(0, num_steps=2 * GRAPH_CHUNK)
            t0 = time.perf_counter()
            gtrainer.run_epoch(1, num_steps=TIME_STEPS)
            torch.cuda.synchronize()
            per_g = (time.perf_counter() - t0) / TIME_STEPS * 1e3
            print(f"[training] {arm} arm, Trainer.run_epoch with scan_steps="
                  f"{GRAPH_CHUNK} as graph replays back to back: {per_g:.3f} "
                  f"ms/step over {TIME_STEPS} steps (host clock: sampling, "
                  f"stacking, one copy and one replay a chunk), "
                  f"{BATCH / per_g * 1e3:.1f} img/s, against {eager_b2b:.3f} "
                  f"ms/step eager, on {card}", flush=True)
            (graph,) = gtrainer.graphs.graphs.values()
            rng = np.random.RandomState(SEED)
            hosts = [train_data.host_batch(train_data.sample_indices(
                rng, BATCH)) for _ in range(GRAPH_CHUNK)]
            chunk = {k: None if hosts[0][k] is None
                     else np.stack([h[k] for h in hosts]) for k in hosts[0]}
            compare_graph_timing(
                f"train step, {arm} arm, batch {BATCH}", "step", step,
                graph.replay, lambda: gtrainer.graphs(chunk), eager_b2b,
                GRAPH_CHUNK, card, n=5)
            del trainer, gtrainer, graph, batch, probe_images
            torch.cuda.empty_cache()

    # the wide head's training runs: ModelConfig(deconv_channels=512) in
    # bf16 and at float32 compute, each with the gradient check against a
    # plain-backed step from the same state, then WIDE_TRAIN_STEPS counted
    # steps of Trainer.fit (kernels 3 and 4, or 3f and 4f, past 256
    # features: their launches go to the `*_slices` rows)
    for dtype_name, leaf_tol, total_tol, fwd, bwd in (
            ("bfloat16", GRAD_LEAF_REL_BF16, GRAD_TOTAL_REL_BF16,
             kernels.HEAD_PROJECTION_INTEGRAL_FWD,
             kernels.HEAD_PROJECTION_INTEGRAL_BWD),
            ("float32", GRAD_LEAF_REL_F32, GRAD_TOTAL_REL_F32,
             kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32,
             kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32)):
        arm = f"fused width-{WIDE_FEATS[1]} {dtype_name}"
        cfg_w = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, deconv_channels=WIDE_FEATS[1],
            compute_dtype=dtype_name))
        with tempfile.TemporaryDirectory() as model_dir:
            trainer = Trainer(cfg_w, train_data, model_dir=model_dir,
                              seed=SEED, device=dev, fuse_head=True)
            trainer.graphs = None   # eager steps
            gen = torch.Generator(device=dev).manual_seed(SEED)
            batch = trainer.preprocess(
                gen, train_data.host_batch(np.arange(BATCH)))
            scale_projection(trainer.model, batch.image)
            gradient_check(arm, trainer, batch, True, leaf_tol, total_tol)
            for k in kernels.KERNELS:
                k.launches = 0
            _, traced = head_kernels_traced(lambda: trainer.fit(
                end_epoch=1, steps_per_epoch=WIDE_TRAIN_STEPS))
            counts = {k.symbol: k.launches for k in kernels.KERNELS}
            want_counts = {k.symbol: (WIDE_TRAIN_STEPS if k in (
                fwd, bwd, kernels.WARP_TWOPASS) else 0)
                for k in kernels.KERNELS}
            parts = 1 if dtype_name == "bfloat16" else 3
            want_traced = {f"{name}<{parts}>": WIDE_TRAIN_STEPS
                           for name in kernels.SLICE_MMA_KERNELS}
            print(f"[training] {arm} arm: Trainer.fit took "
                  f"{WIDE_TRAIN_STEPS} steps at batch {BATCH}, launches "
                  f"{counts}; the head's device kernels in the trace "
                  f"{dict(traced)}", flush=True)
            check(counts == want_counts, f"{arm}: launches {counts}, "
                  f"expected {want_counts}")
            check(traced == want_traced, f"{arm}: the head's device kernels "
                  f"{dict(traced)}, expected {want_traced}")
            for k in kernels.KERNELS:
                head = k in (fwd, bwd)
                (wide_launches if head else train_launches)[k.symbol] += (
                    counts[k.symbol])
            del trainer, batch
            torch.cuda.empty_cache()

    # ---- 6. kernel timings at the paths' shapes
    hm = (3 * torch.randn(BATCH, Ho, Wo, J * D, device=dev,
                          generator=g)).to(torch.bfloat16)
    hm32 = hm.float()
    feats = torch.randn(BATCH, Ho, Wo, F, device=dev,
                        generator=g).to(torch.bfloat16)
    w = 0.1 * torch.randn(J * D, F, device=dev, generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    cot = torch.randn(BATCH, J, 3, device=dev, generator=g)
    c1, m1, s1 = softmax_integral_reference(hm, J, D)
    c3, m3, s3 = head_projection_integral_cuda(feats, w, b, J, D)
    images = 255 * torch.rand(BATCH, IH, IW, 3, device=dev, generator=g)
    Hm = homographies(BATCH, g, dev)
    times = {
        "softmax_integral_fwd": time_pair(
            lambda: softmax_integral_cuda(hm, J, D),
            lambda: softmax_integral_reference(hm, J, D)),
        "head_projection_integral_fwd": time_pair(
            lambda: head_projection_integral_cuda(feats, w, b, J, D),
            lambda: head_projection_integral_reference(feats, w, b, J, D)),
        "softmax_integral_bwd": time_pair(
            lambda: softmax_integral_bwd_cuda(hm, m1, s1, c1, cot, J, D),
            lambda: softmax_integral_bwd_reference(hm, m1, s1, c1, cot, J,
                                                   D)),
        "head_projection_integral_bwd": time_pair(
            lambda: head_projection_integral_bwd_cuda(feats, w, b, m3, s3,
                                                      c3, cot, J, D),
            lambda: head_projection_integral_bwd_reference(
                feats, w, b, m3, s3, c3, cot, J, D), iters=5),
        "warp_twopass": time_pair(
            lambda: warp_perspective_cuda(images, Hm, (IH, IW)),
            lambda: warp_perspective_twopass(images, Hm, (IH, IW))),
    }
    k32, p32 = time_pair(lambda: softmax_integral_cuda(hm32, J, D),
                         lambda: softmax_integral_reference(hm32, J, D))
    hm4 = hm[:DET_BATCH].contiguous()
    k4, p4 = time_pair(lambda: softmax_integral_cuda(hm4, J, D),
                       lambda: softmax_integral_reference(hm4, J, D))
    # kernels 3 and 4 with float32 features (compute_dtype="float32", on
    # the tensor cores), kernel 3 also at the two-stage path's pose batch
    # and at the teacher sweep's crops
    feats32, feats4 = feats.float(), feats[:DET_BATCH].contiguous()
    c32, m32, s32 = head_projection_integral_cuda(feats32, w, b, J, D)
    times["head_projection_integral_fwd_f32"] = time_pair(
        lambda: head_projection_integral_cuda(feats32, w, b, J, D),
        lambda: head_projection_integral_reference(feats32, w, b, J, D))
    feats168 = torch.randn(SWEEP_CROPS, Ho, Wo, F, device=dev, generator=g)
    t168 = time_pair(
        lambda: head_projection_integral_cuda(feats168, w, b, J, D),
        lambda: head_projection_integral_reference(feats168, w, b, J, D),
        iters=3)
    b168 = bound(feats168.numel() * 4 + w.numel() * 4,
                 2.0 * feats168.numel() * w.shape[0], BF16X6_FLOPS)
    del feats168
    print(f"[timing] head_projection_integral_fwd_f32 at the teacher "
          f"sweep's {SWEEP_CROPS} crops: kernel {t168[0]:.4f} ms, plain "
          f"{t168[1]:.4f} ms, bound {b168[0]:.4f} ms ({b168[1]}), "
          f"{100 * b168[0] / t168[0]:.1f} % of it, on {card}", flush=True)
    times["head_projection_integral_bwd_f32"] = time_pair(
        lambda: head_projection_integral_bwd_cuda(
            feats32, w, b, m32, s32, c32, cot, J, D),
        lambda: head_projection_integral_bwd_reference(
            feats32, w, b, m32, s32, c32, cot, J, D), iters=5)
    # kernels 3, 4, 3f and 4f past 256 features (the slice-walking
    # kernels) at the serving shape, F = 260 and 512, each beside its bound
    # (as F = 256's below: the projections' operations at the dtype's
    # tensor-core rate, or the bytes of features, weight and dfeat); the
    # `*_slices` rows take F = 512
    wide_times, wide_bounds = {}, {}
    for f in WIDE_FEATS:
        feats_w = torch.randn(BATCH, Ho, Wo, f, device=dev, generator=g)
        w_w = (0.1 * 16 / math.sqrt(f)) * torch.randn(J * D, f, device=dev,
                                                      generator=g)
        for fdt, sfx, rate in ((torch.bfloat16, "", BF16X3_FLOPS),
                               (torch.float32, "_f32", BF16X6_FLOPS)):
            x = feats_w.to(fdt)
            cw, mw, sw = head_projection_integral_cuda(x, w_w, b, J, D)
            flops = 2.0 * x.numel() * w_w.shape[0]
            fbytes = x.numel() * x.element_size() + w_w.numel() * 4
            for direction, t, bd in (
                    ("fwd", time_pair(
                        lambda: head_projection_integral_cuda(x, w_w, b, J,
                                                              D),
                        lambda: head_projection_integral_reference(
                            x, w_w, b, J, D)), bound(fbytes, flops, rate)),
                    ("bwd", time_pair(
                        lambda: head_projection_integral_bwd_cuda(
                            x, w_w, b, mw, sw, cw, cot, J, D),
                        lambda: head_projection_integral_bwd_reference(
                            x, w_w, b, mw, sw, cw, cot, J, D), iters=3),
                     bound(2 * fbytes, 3 * flops, rate))):
                name = f"head_projection_integral_{direction}{sfx}"
                print(f"[timing] {name} at F = {f}, {tuple(x.shape)}: kernel "
                      f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, bound "
                      f"{bd[0]:.4f} ms ({bd[1]}), "
                      f"{100 * bd[0] / t[0]:.1f} % of it, on {card}",
                      flush=True)
                if f == WIDE_FEATS[1]:
                    wide_times[name + "_slices"] = t
                    wide_bounds[name + "_slices"] = bd
            # the backward call's device time by step, from a trace
            steps = backward_steps_ms(lambda: head_projection_integral_bwd_cuda(
                x, w_w, b, mw, sw, cw, cot, J, D))
            print(f"[timing] head_projection_integral_bwd{sfx} at F = {f}: "
                  f"device ms by step: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in steps.items())
                  + f" on {card}", flush=True)
            del x, cw, mw, sw
        del feats_w, w_w
    # the backward past one pass of the N = F products (two passes of 512)
    feats_w = torch.randn(BATCH, Ho, Wo, PASS_FEATS_TIMED, device=dev,
                          generator=g)
    w_w = (0.1 * 16 / math.sqrt(PASS_FEATS_TIMED)) * torch.randn(
        J * D, PASS_FEATS_TIMED, device=dev, generator=g)
    for fdt, sfx, rate in ((torch.bfloat16, "", BF16X3_FLOPS),
                           (torch.float32, "_f32", BF16X6_FLOPS)):
        x = feats_w.to(fdt)
        cw, mw, sw = head_projection_integral_cuda(x, w_w, b, J, D)
        t = time_pair(
            lambda: head_projection_integral_bwd_cuda(
                x, w_w, b, mw, sw, cw, cot, J, D),
            lambda: head_projection_integral_bwd_reference(
                x, w_w, b, mw, sw, cw, cot, J, D), iters=2)
        bd = bound(2 * (x.numel() * x.element_size() + w_w.numel() * 4),
                   3 * 2.0 * x.numel() * w_w.shape[0], rate)
        print(f"[timing] head_projection_integral_bwd{sfx} at F = "
              f"{PASS_FEATS_TIMED}, {tuple(x.shape)}: kernel {t[0]:.4f} ms, "
              f"plain {t[1]:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), "
              f"{100 * bd[0] / t[0]:.1f} % of it, on {card}", flush=True)
        del x, cw, mw, sw
    del feats_w, w_w
    torch.cuda.empty_cache()
    more = {
        f"head_projection_integral_fwd at batch {DET_BATCH}": time_pair(
            lambda: head_projection_integral_cuda(feats4, w, b, J, D),
            lambda: head_projection_integral_reference(feats4, w, b, J, D)),
    }
    for name, (k, p) in times.items():
        print(f"[timing] {name} at the paths' shape: kernel {k:.4f} ms, "
              f"plain {p:.4f} ms on {card}", flush=True)
    # kernel 1: its plan, and float32 and batch-4 heatmaps beside their own
    # byte bounds; its two launches' device time (profile)
    for name, x, k, p in (("float32 heatmap", hm32, k32, p32),
                          (f"batch {DET_BATCH}", hm4, k4, p4)):
        bd = bound(x.numel() * x.element_size(), x.numel() * 8)
        print(f"[timing] softmax_integral_fwd with a {name}: kernel {k:.4f} "
              f"ms, plain {p:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}) on "
              f"{card}", flush=True)
    for x in (hm, hm32, hm4):
        n = softmax_integral_chunks(x)
        print(f"[timing] softmax_integral_fwd plan at {tuple(x.shape)} "
              f"{x.dtype}: {n} chunks per image, {x.shape[0] * n} CTAs on "
              f"{kernels.sm_count(x.device.index or 0)} SMs", flush=True)
    print_profile(f"softmax_integral_fwd at {tuple(hm.shape)} bf16",
                  lambda: softmax_integral_cuda(hm, J, D), 20, card, top=4)
    # kernel 1's wrapper: host time to issue one call at batch 4, and the
    # plan query's share of it
    call_ms = issue_ms(lambda: softmax_integral_cuda(hm4, J, D), 21)
    plan_ms = issue_ms(lambda: softmax_integral_chunks(hm4), 21)
    print(f"[timing] softmax_integral_fwd host issue of one call at batch "
          f"{DET_BATCH}: {call_ms:.4f} ms, of which the plan query "
          f"{plan_ms:.4f} ms on {card}", flush=True)
    # kernel 2: one device kernel per call, no torch glue around it; the
    # counter must first see the glue that kernel 2 no longer needs
    # (channel_constants)
    glue = device_kernels_per_call(
        lambda: channel_constants(m1, s1, c1, cot, Ho, Wo, D))
    per_call = device_kernels_per_call(
        lambda: softmax_integral_bwd_cuda(hm, m1, s1, c1, cot, J, D))
    print(f"[timing] softmax_integral_bwd device kernels per call: "
          f"{per_call} (channel_constants alone: {glue} kernels)",
          flush=True)
    check(glue > 1, f"the graph count saw {glue} kernels in "
          f"channel_constants, expected several")
    check(per_call == 1, f"softmax_integral_bwd_cuda issued {per_call} "
          f"device kernels per call, expected 1")
    b4_bound = bound(feats4.numel() * 2 + w.numel() * 4,
                     2.0 * feats4.numel() * w.shape[0], BF16X3_FLOPS)
    for name, (k, p) in more.items():
        print(f"[timing] {name}: kernel {k:.4f} ms, plain {p:.4f} ms on "
              f"{card}", flush=True)
    print(f"[timing] head_projection_integral_fwd at batch {DET_BATCH}: "
          f"bound {b4_bound[0]:.4f} ms ({b4_bound[1]})", flush=True)

    # kernel 5 on the training path's call: uint8 frames to the normalised
    # patch in one launch, against its plain chain (frames as float32, the
    # two-pass warp, `_normalise`'s formula); bounds from this run's
    # inputs; one device kernel per call, counted after the counter has
    # seen the plain chain's many
    frames8 = images.to(torch.uint8)
    colour = 0.8 + 0.4 * torch.rand(BATCH, 3, device=dev, generator=g)
    acfg = cfg.augment

    def fused_call():
        return warp_normalise_batch(frames8, Hm, (IH, IW), colour,
                                    acfg.pixel_mean, acfg.pixel_std)

    def plain_chain():
        return warp_normalise_twopass(frames8, Hm, (IH, IW), colour,
                                      acfg.pixel_mean, acfg.pixel_std)

    k8, p8 = time_pair(fused_call, plain_chain)
    b8 = bound(frames8.numel() + 4 * images.numel(), images.numel() * 30)
    b32 = bound(2 * images.numel() * 4, images.numel() * 30)
    k32w, p32w = times["warp_twopass"]
    print(f"[timing] warp_twopass at {tuple(images.shape)} -> {(IH, IW)}: "
          f"float32 frames, warp alone: kernel {k32w:.4f} ms, plain "
          f"{p32w:.4f} ms, bound {b32[0]:.4f} ms ({b32[1]}); uint8 frames "
          f"to the normalised patch (the training path's call): kernel "
          f"{k8:.4f} ms, plain chain {p8:.4f} ms, bound {b8[0]:.4f} ms "
          f"({b8[1]}) on {card}", flush=True)
    warp_issue = issue_ms(fused_call, 21)
    warp_issue32 = issue_ms(lambda: warp_perspective_cuda(images, Hm,
                                                          (IH, IW)), 21)
    _, rows = device_profile(fused_call, 20)
    dev8 = sum(ms for key, ms, _ in rows if "warp_kernel" in key)
    _, rows = device_profile(
        lambda: warp_perspective_cuda(images, Hm, (IH, IW)), 20)
    dev32 = sum(ms for key, ms, _ in rows if "warp_kernel" in key)
    print(f"[timing] warp_twopass device time (profile, 20 calls): "
          f"{dev8:.4f} ms (uint8 + epilogue), {dev32:.4f} ms (float32, warp "
          f"alone) on {card}", flush=True)
    glue = device_kernels_per_call(plain_chain)
    per_call8 = device_kernels_per_call(fused_call)
    per_call32 = device_kernels_per_call(
        lambda: warp_perspective_cuda(images, Hm, (IH, IW)))
    print(f"[timing] warp_twopass host issue of one call: {warp_issue:.4f} "
          f"ms (uint8 + epilogue), {warp_issue32:.4f} ms (float32, warp "
          f"alone); device kernels per call {per_call8} and {per_call32}; "
          f"the plain chain alone: {glue} kernels on {card}", flush=True)
    check(glue > 1, f"the graph count saw {glue} kernels in the warp's "
          f"plain chain, expected several")
    check(per_call8 == 1 and per_call32 == 1, f"the warp issued "
          f"{per_call8} and {per_call32} device kernels per call, expected 1")

    # the least time for each kernel's work at these shapes
    B, HW, JD = hm.shape[0], hm.shape[1] * hm.shape[2], hm.shape[3]
    proj_flops = 2.0 * B * HW * F * JD
    bounds = {
        # read the bf16 heatmap once; ~8 float32 operations per element
        "softmax_integral_fwd": bound(hm.numel() * 2, hm.numel() * 8),
        # read it and write its bf16 gradient
        "softmax_integral_bwd": bound(hm.numel() * 4, hm.numel() * 10),
        # the projection, bf16 features x float32 weights, on tensor cores
        "head_projection_integral_fwd": bound(
            feats.numel() * 2 + w.numel() * 4, proj_flops, BF16X3_FLOPS),
        # logits again, dfeat = g W and dW = feats^T g, likewise
        "head_projection_integral_bwd": bound(
            2 * feats.numel() * 2 + 2 * w.numel() * 4, 3 * proj_flops,
            BF16X3_FLOPS),
        # the same work on float32 features, both operands float32: read
        # them (and write dfeat) in float32, at float32 accuracy on the
        # tensor cores
        "head_projection_integral_fwd_f32": bound(
            feats32.numel() * 4 + w.numel() * 4, proj_flops, BF16X6_FLOPS),
        "head_projection_integral_bwd_f32": bound(
            2 * feats32.numel() * 4 + 2 * w.numel() * 4, 3 * proj_flops,
            BF16X6_FLOPS),
        # read the float32 images once and write the warped ones
        "warp_twopass": b32,
        # kernels 3, 4, 3f and 4f past 256 features, at F = 512
        **wide_bounds,
    }
    times.update(wide_times)

    # ---- 7. the two-stage (detector -> pose) serving path
    det_launches, det = detection_phase(dev, g, card, cfg)

    # ---- 8. the semi-supervised path
    semi_launches = semi_supervised_phase(dev, g, card, cfg)

    # ---- 9. detector training and the study CLIs
    dtrain_launches, dtrain = detector_training_phase(dev, g, card)

    # ---- 10. the input path's device half and int8 serving
    int8_launches = input_int8_phase(dev, g, card, cfg)

    # ---- 11. the device mesh
    mesh_launches, mesh_err = mesh_phase(dev, g, card, cfg)
    for name, e in mesh_err.items():
        err[name] = max(err[name], e)

    # ---- 12. the utilities: entry(), the ImageNet init, the profiler, the
    # log file, find_mean_std
    util_launches = utilities_phase(dev, g, card, cfg)

    pkg = "hand_integral_pose_estimation_tpu_torch/csrc/"
    ref = "hand_integral_pose_estimation_tpu/ops/"
    meta = {
        "softmax_integral_fwd": (kernels.SOFTMAX_INTEGRAL_FWD,
                                 "softmax_integral.cu", "integral.py:75"),
        "head_projection_integral_fwd": (
            kernels.HEAD_PROJECTION_INTEGRAL_FWD,
            "head_projection_integral_mma.cu", "fused_head.py:40"),
        "softmax_integral_bwd": (kernels.SOFTMAX_INTEGRAL_BWD,
                                 "softmax_integral_bwd.cu",
                                 "integral.py:230"),
        "head_projection_integral_bwd": (
            kernels.HEAD_PROJECTION_INTEGRAL_BWD,
            "head_projection_integral_bwd_mma.cu", "fused_head.py:106"),
        # float32 features on the tensor cores (the same C files as the
        # bf16 route, their own kernels)
        "head_projection_integral_fwd_f32": (
            kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32,
            "head_projection_integral_mma.cu", "fused_head.py:40"),
        "head_projection_integral_bwd_f32": (
            kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32,
            "head_projection_integral_bwd_mma.cu", "fused_head.py:106"),
        # past 256 features, both feature dtypes: the kernels that walk F
        # in slices (the same entry points; launched by the main paths'
        # runs at F > 256 alone)
        "head_projection_integral_fwd_slices": (
            kernels.HEAD_PROJECTION_INTEGRAL_FWD,
            "head_projection_integral_mma.cu", "fused_head.py:40"),
        "head_projection_integral_bwd_slices": (
            kernels.HEAD_PROJECTION_INTEGRAL_BWD,
            "head_projection_integral_bwd_mma.cu", "fused_head.py:106"),
        "head_projection_integral_fwd_f32_slices": (
            kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32,
            "head_projection_integral_mma.cu", "fused_head.py:40"),
        "head_projection_integral_bwd_f32_slices": (
            kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32,
            "head_projection_integral_bwd_mma.cu", "fused_head.py:106"),
        "warp_twopass": (kernels.WARP_TWOPASS, "warp_twopass.cu",
                         "warp.py:156"),
        "roi_align": (kernels.ROI_ALIGN_FWD, "roi_align.cu",
                      "roi_align.py:93"),
        "nms": (kernels.NMS, "nms.cu", "nms.py:231"),
        # no Pallas kernel: the JAX package trains through the XLA ROIAlign
        # (roi_align.py:57) and takes this gradient from XLA's autodiff
        "roi_align_bwd": (kernels.ROI_ALIGN_BWD, "roi_align_bwd.cu",
                          "roi_align.py:57"),
    }
    for name, (e, t, b) in {**det, **dtrain}.items():
        err[name] = e
        times[name] = t
        bounds[name] = b
    for name, (k, _, _) in meta.items():
        print(f"[timing] {name}: kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}), "
              f"{100 * bounds[name][0] / times[name][0]:.1f} % of it, on "
              f"{card}", flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": pkg + src,
         "replaces": ref + tpu,
         "launches": (wide_launches[k.symbol] if name in WIDE_ROWS else
                      serving_launches[k.symbol]
                      + train_launches[k.symbol]
                      + det_launches[k.symbol] + semi_launches[k.symbol]
                      + dtrain_launches[k.symbol]
                      + int8_launches[k.symbol] + mesh_launches[k.symbol]
                      + util_launches[k.symbol]),
         "max_abs_err": err[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, (k, src, tpu) in meta.items()]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
