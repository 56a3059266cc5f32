#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port, ``allrank_tpu_torch``.

Run from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and never prints its last line):

1. the card, torch and CUDA versions; builds the sixteen kernel sources of
   ``allrank_tpu_torch/csrc`` with nvcc (one process per source, in
   parallel) and prints the seconds it took and each kernel's registers;
   counts the ``HMMA`` instructions of B4's and B5's bf16 kernels (18
   each) and fp32 kernels (18 each, 3xTF32: TF32 ``HMMA``; the two sources
   hold no other kernel), of B1's (22) and of B2's (5) with the toolkit's
   ``cuobjdump -sass`` (each must hold some); turns TF32 off for PyTorch's
   own products;
2. the attention sublayer kernel (B1) against its plain PyTorch version at
   B=64, L=240 for (d, h) = (128, 4), (144, 2), (96, 1), with ragged
   lengths and one lengths=0 slate, in fp32 (its SIMT kernels) and bf16
   (its tensor-core kernels), plus edge shapes; and in bf16 at head widths
   8, 20, 32, 36, 48, 72, 100 and 128 x L in {1, 65, 240, 1024}, which
   runs each of its tensor-core forward instantiations;
3. the FFN sublayer kernel (B2) likewise, d_ff 512 and 384, in fp32 (its
   SIMT kernels) and bf16 (its tensor-core kernels); and in bf16 at d in
   {32, 96, 128, 144, 256} x d_ff in {384, 512, 1024} x L in {1, 65, 240,
   1024}, which runs each of its tensor-core instantiations;
4. the flagship ranker (136 features, FC [128], 4 blocks of d=128, h=4,
   d_ff=512, random weights from a seeded ``torch.Generator``) through
   ``make_scorer``/``make_ranker`` on the GPU against the same model's
   plain run with ``device="cpu"``; bf16 against fp32;
5. ``SlateScoringService`` with buckets (1, 8, 64) behind ``run_server``
   on a free localhost port, answering concurrent JSON and ``.npy``
   requests, checked against direct scorer calls; this is the main path
   whose kernel launches are counted (the counters are set to 0 just
   before the requests and read just after);
6. times (CUDA events after warm-up, medians; and as device time, 20
   calls in one CUDA graph): each kernel, its plain version and a PyTorch
   library yardstick at the flagship serving shape (B1 in fp32 on its SIMT
   kernels, in bf16 on its tensor cores: a row each),
   the scorer's slates/s with its device time by kernel and idle share
   (torch.profiler), the service's p50 request latency;
7. the B1 and B2 backward kernels against their plain versions (and the
   forwards at dropout 0.3), at the flagship widths and the edge shapes of
   phases 2-3, dropout 0 and 0.3, fp32 and bf16, with bit-identical masks;
   and at B=64, L=240, d=144, h=2 (head width 72, the ordinal recipe's) at
   dropout 0 and 0.4; B1 in bf16 at phase 2's head widths and lengths,
   dropout 0 and 0.3, and with its saved qkv 2 bytes off a 16-byte
   boundary, a second backward bit for bit the first: each of its 22
   tensor-core kernels; B2 in bf16 at phase 3's widths and lengths,
   dropout 0 and 0.3, with x and dy 2 bytes off a 16-byte boundary and at
   d < 16 and d_ff not a multiple of 64, a second backward bit for bit the
   first: each of its 5 tensor-core kernels. Every B2 backward is held
   under ROADMAP Queue C5's replay: the ReLU gates that its dx shows
   flipped (a pre-activation within rounding of 0) replayed in the plain
   version (``ffn_block.gate_flips``), at most ``GATE_FLIPS_MAX`` a case;
   and on C5's own inputs (a seed sweep at d=96, bf16, p=0.3 and one fp32
   case at d=144);
8. the lambdaLoss pair-chain kernels (B3, forward and backward) against
   their plain versions: every weighing scheme, k = all or 10,
   L in {1, 240, 384}, a dummy slate;
9. the train step, the second main path: the paper config
   (``reproducibility/configs/contextaware_web30k/ndcgloss2pp.json``:
   136 features, dropout 0.3, bf16, Adam at 1e-3, lambdaLoss with
   ndcgLoss2PP) for 20 steps through ``make_train_step`` on a fixed
   synthetic batch of B=64, L=240 with a 40-document padding tail; every
   loss finite, the last 5 below the first 5, and per step 4 + 4 launches
   of each sublayer kernel's forward and backward and 1 + 1 of B3, B1's and
   B2's all on their tensor-core routes (the counters are set to 0 just
   before the steps and read just after); at dropout 0 in fp32, step 1's
   loss and gradients on the GPU against the same model's plain run on the
   CPU, B1 and B2 on their SIMT routes;
10. times: the train step at ``bench.py``'s configuration (the flagship
    model, dropout 0, bf16; B1 4 + 4 launches on the tensor cores) and at
    the paper config, with its idle share
    and device time by kernel; each backward kernel, its plain version and
    a library yardstick (autograd; as device time the sum of its kernels in
    a torch.profiler trace, since autograd refuses CUDA-graph capture);
11. the fused soft-sort kernels (B8, forward and backward) against their
    plain versions at N=64, L=240 and at N=2048 (the stochastic fold), both
    ``transpose`` values, ragged lengths, one fully padded slate;
12. the Sinkhorn kernels (B7, forward and backward) against their plain
    versions at N=8, L=640;
13. the train CLI, the third main path: a dummy libsvm dataset of WEB30K's
    shape from a seed (136 features, 5 grades, 1,024 train and 256
    validation slates of 40-240 documents), then
    ``allrank_tpu_torch.main.run`` on
    ``reproducibility/configs/neuralndcg_web30k/neuralndcg_atmax.json`` with
    only ``data.path``, ``training.epochs`` (2) and ``expected_metrics``
    changed; every epoch's loss finite, ``model.npz``,
    ``experiment_result.json`` and ``used_config.json`` written, ndcg@5 on
    validation reported, and the launches counted: B8 forward and backward
    once per train step, B8 forward once per evaluation batch, B1/B2 twice
    per step and per evaluation batch (two blocks). Then one epoch of
    ``ndcgloss2pp.json`` the same way (B3 launched), a NeuralNDCG train step
    at B=8, L=640 that launches B7, and step 1 of the NeuralNDCG model at
    dropout 0 in fp32 on the GPU against the CPU's plain run;
14. times: B7 and B8, their plain versions and a PyTorch formulation of the
    same chain (forward, and backward by autograd); the NeuralNDCG train
    step with its idle share; an epoch's train, evaluation and feed seconds;
15. the approxNDCG rank-sum kernels (B9, forward and backward) against
    their plain versions: B=64, L=240 ragged with one empty slate, L in
    {1, 37, 1308, 4096}, alpha in {0.1, 1, 10}, scores of +-1e4 (where
    t < eps takes the clamp's branch), tied scores;
16. the row-tiled lambdaLoss kernels (B6, forward and backward) against
    their plain versions at (B, k) = (64, 512), (16, 1024), (8, 1308),
    (2, 4096): every weighing scheme, both log bases, k_eff < k, a slate
    with no valid document; and against B3 on the same inputs at k=384;
17. the train CLI on the five other paper recipes, each as written but for
    ``data.path``, one epoch and the gate, on phase 13's dataset:
    ``approxndcg.json`` (B9 1 + 1 per step and 1 per evaluation batch),
    ``ordinal.json`` (d=144, h=2, a 4-output sigmoid head),
    ``ordinal_mlp.json`` and ``ndcgloss2pp_mlp.json`` (an FC tower alone:
    no sublayer kernel launches) and ``lambdarank_atmax.json``; every
    launch count exact, every loss finite, the three output files written;
18. one train step of each other loss name (listNet, binary_listNet,
    listMLE, the three rankNets, pointwise_rmse, bce) on the flagship model
    at B=64, L=240: loss and every gradient finite in bf16 with dropout,
    and at dropout 0 in fp32 the loss and gradients on the GPU against the
    CPU's plain run;
19. the long-slate lambdaLoss step: the paper config at B=16, L=1024,
    bf16, 10 steps through ``make_train_step`` on a synthetic batch: B6
    1 + 1 launches per step and none of B3, every loss finite, the mean of
    the last 3 below the first 3; step 1 at dropout 0 in fp32 at B=4
    against the CPU's plain run;
20. times: B9 at B=64, L=240 and B6 at (64, 512) and (16, 1024), their
    plain versions and the torch-op chains (backward by autograd); the
    approxNDCG train step and the long-slate step with their idle share
    and device time by kernel;
21. the bare attention kernels B4 (exact softmax, two passes) and B5
    (K-streamed online softmax), forward and backward, against their plain
    versions: B4 at (B, h, L, d_k) = (4, 4, 1200, 32) and (2, 2, 1100, 72),
    B5 at (2, 4, 4096, 32) and (1, 4, 8192, 32), fp32 and bf16, dropout 0
    and 0.3, a fully padded slate; B5 in bf16 (its tensor-core kernels) at
    L in {1, 65, 4097} and d_k in {8, 20, 32, 36, 48, 72, 100, 128} (d_k
    32 with rows off a 16-byte boundary), which runs each of its 18
    kernels, dropout 0 and 0.3, a second backward bit for bit the first;
    B4 in bf16 (its 18 tensor-core kernels) likewise at L in {1, 65,
    1224}; both in fp32 (their 18 3xTF32 kernels each) at the same cases,
    rows one element off a 16-byte boundary at d_k 20, 32, 36 and 100;
    both in fp32 at (3, 2, 1, 128), one key, where dQ and dK are 0
    in exact arithmetic; and the split attention block
    (PyTorch ops around B4 or B5) against the B1 sublayer at (64, 240) and
    (16, 1024), dropout 0.3, the same seeds;
22. long-slate serving: the paper config's model (no positional encoding)
    through ``make_scorer`` at B=4, L=8192, fp32 and bf16, ragged lengths
    and an empty slate, against its plain forward on the card; 4 launches
    each of B5 and B2 forward per call, none of B1 or B4, B5's on the route
    of the dtype (fp32 "tf32x3", bf16 "mma"); one 7,000-document
    request through ``SlateScoringService`` at ``slate_length=8192``;
23. long-slate training, the paper config through ``make_train_step``:
    10 steps at (B, L) = (8, 4096) with a 400-document tail (B5 and B2
    4 + 4 launches per step, B6 1 + 1) and at (16, 1200) with a
    120-document tail (B4 4 + 4); losses finite and falling; step 1 at
    dropout 0 in fp32 at B=2, L=4096 and B=16, L=1200 against the CPU,
    B5 and B4 there on their fp32 route both ways;
24. times: B4 and B5 forward and backward at (8, 4, 1200, 32),
    (8, 4, 4096, 32) and (16, 4, 1024, 32), each with its bound, its plain
    version and ``scaled_dot_product_attention`` (backward by autograd); B4
    in fp32 and bf16 also at the int8 tower's (64, 4, 240, 32), and B4 and
    B5 in bf16 (B5 also at (4, 4, 8192, 32)) at dropout 0 and 0.3, with the
    exp floor (one exponential a pair forward, two backward, at 16 a clock
    on each of the device's SMs) beside each bound, and for B4 the floor of
    its own two exps a pair forward and three backward; B4 and B5 in fp32
    (the 3xTF32 kernels, bound at a third of the 495 TFLOP/s TF32 rate) and
    bf16 as device time (20 calls in a CUDA graph) beside the library
    forward's (the library backward's device time is
    ``tools/time_attention.py --library``'s) and, for fp32, the SIMT bound
    too; at
    (16, 1024) the B1 sublayer beside the split block with B4 and with B5;
    both long steps with their idle share and device time by kernel;
25. the int8 dense kernel (X1) against its plain version, bit for bit: the
    six dense sites of the flagship's int8 tower at M = B L = 15,360 and
    ragged shapes (M in {1, 17, 15361}, K in {1, 33}, N in {1, 7}), x in
    fp32 and bf16, the static mode with one multiplier and with [K] and the
    dynamic mode, inputs on exact .5 ties after scaling and a zero row;
26. int8 serving, the fourth main path: the flagship model calibrated on 8
    synthetic B=64, L=240 batches on the card; ``make_scorer`` in
    ``int8_static`` and ``int8`` at B=64, L=240 (ragged lengths, one empty
    slate), bf16 and fp32 flow: padded positions -inf, the bf16 flow within
    0.05 x max|score| of the CPU plain tower, against the card's fp32
    float tower a correlation above 0.999 and top-1 kept on at least 5/6
    of slates, exactly 18 X1 and 4 B4 launches a call (B1, B2, B5 none);
    at B=4, L=4096 18 X1 and 4 B5; ``SlateScoringService`` in
    ``int8_static`` with buckets (1, 8, 64) behind ``run_server``
    answering JSON and ``.npy`` requests as direct scorer calls (the
    counts set to 0 just before and read just after); ``evaluate.run`` on
    phase 13's dataset and NeuralNDCG ``model.npz``, float and
    ``--quantize int8_static``, and a service on its ``act_scales.json``;
27. times: X1 at each flagship site (device time, its bound, the plain
    version, the ``torch._int_mm`` chain and the float layer's bf16
    ``torch.matmul``); the scorer in fp32, bf16, int8 and int8_static with
    its device time by kernel and idle share; the int8_static service's
    p50;
28. the whole-encoder kernel pair (B10, forward and backward): its
    cooperative grid, then against the chained B1/B2 kernels of its own
    tile bodies (both on their SIMT routes in bf16 too; phases 2 and 7's
    tolerances) and against its plain version (no further from it than
    the chained kernels, plus those tolerances), output and all 15
    gradients, at the flagship (B=64, L=240, d=128, h=4, d_ff=512, N=4)
    and at N=1, L=1, (4, 1024), d=144 with d_ff=384, d=256 with
    d_ff=1024, fp32 and bf16, dropout 0 and 0.3; two backwards give the
    same bits; in bf16 also its distance from the chain that the encoder
    runs with the switch off (B1 and B2 on the tensor cores), recorded, and
    at ROADMAP C4's case (8, 240, 144, N=2) B10's, that chain's and the
    SIMT chain's distance from the fp32 plain chain on the same inputs;
29. the fifth main path, with ``MEGA_ENCODER_ENABLED`` set for the phase
    and restored after it: the flagship scorer in fp32 and bf16 against
    the switched-off scorer and the CPU plain run (one B10 launch a call,
    none of B1 or B2), ``SlateScoringService`` behind ``run_server``, and
    20 paper-config train steps (B10 1 + 1 launches a step, B1 and B2
    none, B3 1 + 1), step 1 at dropout 0 in fp32 against the CPU's
    plain run with ReLU gate flips held out (the counts set to 0 just
    before each run and read just after);
30. times: B10 forward and backward at the flagship (event-timed, device
    time, the bound, the plain version, the chained B1/B2 kernels and a
    library formulation); the A/B of the switch (off, on, on, off) on the
    train step at ``bench.py``'s configuration and the paper config and on
    the flagship scorer, with idle share and device time by kernel;
31. the boundary-shift kernels (X2, plain and shifted) against their plain
    versions at B=64, L=240, at a ragged B=3, L=37 and at B=1, L=1 (bf16,
    d=128, d3=384); then the probe ``allrank_tpu_torch.tools.
    exp_boundary_shift`` at its default shape, in-process (its launches are
    the kernels' count): the per-boundary tax in one CUDA graph and eager;
    each kernel's device time, bound, plain version and library formulation;
32. the attention variants (X3) in all six modes against their plain
    versions at B=64, L=240, d=128, h=4, bf16, ragged keys and one empty
    slate, and ``full`` equal to B1's SIMT forward bit for bit and within
    phase 2's bf16 tolerance of B1's tensor-core forward; then the probe
    ``exp_attn_decompose`` (three interleaved rounds of K=8 chains, the
    stage costs, the production B1 forward and backward K-swept); times;
33. the soft-sort with its records on chip (X4, forward and backward)
    against B8's kernels (bit for bit) and the plain version at N=2048,
    L=240 with a 40-document tail (the probe's case), at N=64 ragged in
    both ``transpose`` values and at one fully padded slate; its refusal
    past its shared-memory cap; then the probe ``exp_sinkhorn_layout``
    (B8 against X4, forward and forward + backward, 8 steps in one CUDA
    graph); times at N=64 beside B8's;
34. a ``{"kernels": [...]}`` JSON line (B1 and B2 a row per route), the card's
    name and power limit as
    nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from argparse import Namespace

import numpy as np
import torch

from allrank_tpu_torch.tools.time_attention import library_fns
from allrank_tpu_torch.tools.timing import (
    IncompleteTrace,
    busy_us,
    graph_ms,
    kernel_ms,
    trace_kernels,
)

B, L, N_FEATURES = 64, 240, 136  # the flagship serving shape
PAPER_WIDTHS = [(128, 4), (144, 2), (96, 1)]  # (d_model, h)
# B1's tensor-core kernels: 6 each of the attention + out-projection, dQ and
# dK/dV kernels (padded d_k 32, 64, 128 x rows aligned or not), and LN +
# QKV, the backward's rows, dn + LN backward and the weight gradients
B1_MMA_KERNELS = 22
# (d_model, h) of each head width the bf16 B1 kernels are held to: d_k 8,
# 20, 32 (padded to 32), 36, 48 (to 64), 72, 100, 128 (to 128); 20, 36 and
# 100 leave rows off a 16-byte boundary
B1_MMA_WIDTHS = [(32, 4), (80, 4), (128, 4), (144, 4), (96, 2), (144, 2),
                 (100, 1), (256, 2)]
# B4's and B5's fp32 kernels (3xTF32 on the tensor cores) in each source:
# the forward, dQ and dK/dV kernels at padded d_k 32, 64, 128, aligned or
# not
ATTN_F32_KERNELS = 18
# B2's tensor-core kernels: the forward and the backward's row kernel at
# d <= 128 and d > 128 (two warps a row group), and the split A^T B
B2_MMA_KERNELS = 5
# the widths B2's bf16 kernels are held to: d within one warp's 128
# output columns (32, 96, 128) or split over two warps (144, whose second
# warp takes 16 columns, and 256), d_ff whole 64-unit chunks; phase 7's
# edge cases take d and d_ff off those steps
B2_MMA_WIDTHS = [(d, d_ff) for d in (32, 96, 128, 144, 256)
                 for d_ff in (384, 512, 1024)]
# H100 SXM published peaks (dense): fp32 on the SIMT units, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.int8: 1979e12}
# fp32 work as 3xTF32 on the tensor cores (B4's and B5's fp32 kernels):
# three TF32 products at 495 TFLOP/s an fp32 product
TF32X3_FLOPS = 495e12 / 3
MEM_BYTES_PER_S = 3.35e12
# kernel vs plain version on the same inputs:
#  fp32: the same fp32 FMAs summed in another order;
#  bf16: the same rounding points, where an fp32 sum that lands on the
#        other side of a rounding edge moves y by one or two bf16 ulps
#        (2^-7 relative at most each)
KERNEL_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
              torch.bfloat16: dict(rtol=2 ** -6, atol=2 ** -6)}
# backward kernel vs plain version, per gradient tensor, relative to the
# tensor's largest value: fp32 sums taken in another order; bf16 at the
# same rounding points, where an fp32 sum on the other side of a rounding
# edge moves one bf16 intermediate by an ulp and a weight gradient summed
# over it a little
BWD_TOL = {torch.float32: (1e-4, 1e-6), torch.bfloat16: (2 ** -5, 1e-6)}
# B3 against its plain version: the JAX package's own tolerances for the
# loss sums; the gradient sum_j c_ij - sum_j c_ji is two fp32 sums of up
# to 2k terms whose difference may be far smaller than either, so its
# absolute part scales with the largest gradient
B3_VALUE_TOL = dict(rtol=2e-5, atol=1e-5)
B3_GRAD_RTOL, B3_GRAD_ATOL = 1e-4, 1e-5
# train step 1, GPU kernels vs the CPU plain run, fp32 through 4 blocks
# forward and backward: loss relative, each gradient relative to its own
# largest value plus 1e-5 of the largest gradient of all (a gradient that
# is zero in exact arithmetic, the output bias, is fp32 noise)
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-4, 1e-3

# the long-slate step 1: FFN hidden units per block whose ReLU gate may flip
# between GPU and CPU (1.6 % of the paper config's d_ff = 512); a unit
# flips where a pre-activation lies within fp32 rounding of 0, two or three
# in all four blocks at some 5,000-7,000 rows, more with more rows; a fault
# upstream of the FFN moves every pre-activation and flips far more
GATE_FLIPS_MAX = 8
# flagship scores, GPU kernels vs the CPU plain run, fp32 through 4 blocks
SCORE_TOL = 1e-3
# flagship scores, bf16 vs fp32 on the GPU: bf16 keeps 8 mantissa bits and
# rounds at every sublayer of 4 blocks; relative to the largest |score|
BF16_SCORE_TOL = 0.05


# B7 and B8 against their plain versions, fp32: the same FMAs summed in
# another order through 50 compounding iterations; the gradient cancels
# heavily, so it is held relative to its tensor's largest value
SOFT_TOL = dict(rtol=1e-4, atol=1e-4)
SOFT_GRAD_TOL = (1e-4, 1e-6)
SINKHORN_ITERS = 50
NEURAL_CONFIG = ("reproducibility/configs/neuralndcg_web30k/"
                 "neuralndcg_atmax.json")
CLI_TRAIN_SLATES, CLI_VAL_SLATES = 1024, 256
CONFIG_DIR = "reproducibility/configs/"
# the five other paper recipes: (config, encoder blocks, loss kernel)
OTHER_RECIPES = [
    ("neuralndcg_web30k/approxndcg.json", 2, "approx_pos"),
    ("contextaware_web30k/ordinal.json", 4, None),
    ("contextaware_web30k/ordinal_mlp.json", 0, None),
    ("contextaware_web30k/ndcgloss2pp_mlp.json", 0, "lambda_pairs"),
    ("neuralndcg_web30k/lambdarank_atmax.json", 2, "lambda_pairs")]
# B9 against its plain version: the JAX test's own forward tolerance (the
# sums reach L, so a relative part of the same size beside it); the
# gradient, two fp32 sums of up to L terms in another order, relative to
# its largest value
B9_VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
B9_GRAD_TOL = (1e-4, 1e-6)
# the losses that neither recipe nor earlier phase drives, with arguments
OTHER_LOSSES = [("listNet", {}), ("binary_listNet", {}), ("listMLE", {}),
                ("rankNet", {}), ("rankNet_weightByGTDiff", {}),
                ("rankNet_weightByGTDiff_pow", {}),
                ("pointwise_rmse", {"no_of_levels": 4}), ("bce", {})]
LONG_B, LONG_L = 16, 1024
# the flagship int8 tower's dense layers at the serving shape: (site, K, N,
# launches per scorer call); the head's input and output are fp32, every
# other site's bf16 in the serving flow
Q8_SITES = [("fc/0", N_FEATURES, 128, 1), ("qkv", 128, 384, 4),
            ("out", 128, 128, 4), ("ff1", 128, 512, 4), ("ff2", 512, 128, 4),
            ("output", 128, 1, 1)]
Q8_MODES = ("static", "static_channels", "dynamic")
# B10's cases (B, L, d, h, d_ff, N): the flagship first, then N = 1, L = 1,
# B1's longest slate, the ordinal recipe's widths (d_k = 72) and the
# envelope's widest
ENCODER_CASES = [(B, L, 128, 4, 512, 4), (8, L, 128, 4, 512, 1),
                 (3, 1, 128, 4, 512, 2), (4, 1024, 128, 4, 512, 2),
                 (8, L, 144, 2, 384, 2), (4, 70, 256, 1, 1024, 2)]
# ROADMAP Queue C4's case (B, L, d, N): B10 in bf16, the switch-off chain
# (B1 and B2 on the tensor cores) and the SIMT chain, each against the fp32
# plain chain on the same bf16 inputs and masks; C4 is no fault if B10 is
# no farther from that reference than the tensor-core chain (at most 1.5x)
C4_CASE, C4_RATIO = (8, L, 144, 2), 1.5
# the int8 tower against its float tower, JAX's own serving-quality gate
# (tests/test_quant.py): score correlation and top-1 agreement
Q8_MIN_CORR, Q8_MIN_TOP1 = 0.999, 5 / 6


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def sm_clock_mhz() -> float:
    """The card's largest SM clock, MHz, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return float(out.splitlines()[0])


def exp_floor_ms(exps: float, mhz: float, sms: int) -> float:
    """The least time the card's special-function units take for ``exps``
    exponentials: 16 a clock on each of its ``sms`` SMs."""
    return exps / (sms * 16 * mhz * 1e6) * 1e3


def hmma_counts(library: str, marker: str,
                pattern: str = r"\bH(G)?MMA\b") -> dict:
    """The instructions matching ``pattern`` (by default ``HMMA`` and
    ``HGMMA``; ``TF32_HMMA`` the TF32 ones) in each kernel of a built
    library whose name holds ``marker``, from the toolkit's
    ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"no cuobjdump at {tool}: the tensor-core check "
                           "needs the toolkit's cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1) if marker in found.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.search(pattern, line):
            counts[name] += 1
    return counts


# a TF32 tensor-core product in SASS, as HMMA.1688.F32.TF32
TF32_HMMA = r"\bHMMA\.\S*\.TF32\b"


def median_ms(fn, iters: int = 40, warmup: int = 5) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """(least ms, "operations" or "bytes"): ``dtype`` a torch dtype, or
    "tf32x3" for fp32 work as 3xTF32 split products."""
    rate = TF32X3_FLOPS if dtype == "tf32x3" else PEAK_FLOPS[dtype]
    t_ops = flops / rate * 1e3
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def attn_inputs(gen, b, l, d, dtype, dev):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = 0  # a fully padded slate
    mask = torch.arange(l)[None, :] >= lengths[:, None]
    params = [1 + r(d, scale=0.1), r(d, scale=0.1),
              r(d, 3 * d, scale=d ** -0.5), r(3 * d, scale=0.1),
              r(d, d, scale=d ** -0.5), r(d, scale=0.1)]
    return ([r(b, l, d).to(dtype).to(dev), mask.to(dev)]
            + [p.to(dev) for p in params])


def ffn_inputs(gen, b, l, d, d_ff, dtype, dev):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    params = [1 + r(d, scale=0.1), r(d, scale=0.1),
              r(d, d_ff, scale=d ** -0.5), r(d_ff, scale=0.1),
              r(d_ff, d, scale=d_ff ** -0.5), r(d, scale=0.1)]
    return [r(b, l, d).to(dtype).to(dev)] + [p.to(dev) for p in params]


def check_kernel(name, kernel, plain, args, kwargs, dtype) -> float:
    """One launch against the plain version on the same inputs; returns the
    max abs error."""
    before = kernel.launches
    y = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1, f"{name}: the kernel did not launch"
    ref = plain(*args, **kwargs)
    assert y.dtype == ref.dtype and y.shape == ref.shape
    assert torch.isfinite(y.float()).all(), f"{name}: non-finite output"
    torch.testing.assert_close(y.float(), ref.float(), **KERNEL_TOL[dtype])
    return (y.float() - ref.float()).abs().max().item()


def flagship_model(dev, dropout=0.0, output_activation=None):
    """``__graft_entry__._flagship_mdef`` (the model ``bench.py`` trains)
    rebuilt in the port, random weights from a seeded generator;
    ``output_activation`` puts an activation on its head (none there)."""
    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PositionalEncodingConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.models.factory import LTRModel, make_model

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[128], input_norm=True, activation="ReLU",
                          dropout=0.0),
        transformer=TransformerConfig(
            N=4, d_ff=512, h=4, dropout=dropout,
            positional_encoding=PositionalEncodingConfig(
                strategy="fixed", max_indices=256)),
        post_model=PostModelConfig(d_output=1,
                                   output_activation=output_activation)),
        N_FEATURES)
    return LTRModel(mdef, torch.Generator().manual_seed(0), device=dev)


PAPER_CONFIG = "reproducibility/configs/contextaware_web30k/ndcgloss2pp.json"


def paper_setup(dev, dropout=None, config=PAPER_CONFIG):
    """The paper config's model (random weights from a seeded generator),
    loss and optimizer settings; ``dropout`` overrides the config's own."""
    from allrank_tpu_torch.config import Config
    from allrank_tpu_torch.models.factory import LTRModel, make_model

    cfg = Config.from_json(config)
    if dropout is not None:
        cfg.model.transformer.dropout = dropout
    model = LTRModel(make_model(cfg.model, N_FEATURES),
                     torch.Generator().manual_seed(0), device=dev)
    return cfg, model


def train_batch(dev, seed=0, b=B, l=L, tail=40):
    """B=64 slates of L=240 WEB30K-shaped documents with a 40-document
    padding tail (``bench.py``'s batch), or another size; labels 0-4 follow
    two features plus noise, so a few steps can lower the loss."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, N_FEATURES).astype(np.float32)
    y = np.clip(np.round(2.0 + x[..., 0] + 0.5 * x[..., 1]
                         + 0.5 * rng.randn(b, l)), 0, 4).astype(np.float32)
    indices = np.tile(np.arange(l), (b, 1))
    y[:, -tail:] = -1.0
    indices[:, -tail:] = -1
    return (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            torch.as_tensor(indices, device=dev))


def make_step(cfg, model, dtype, optimizer_name=None, lr=None, loss=None):
    """The train step of ``cfg`` on ``model``; ``loss`` = (name, args)
    replaces the config's loss."""
    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.training import make_optimizer, make_train_step

    loss_name, loss_args = loss or (cfg.loss.name, cfg.loss.args)
    loss_fn, needs_rng = get_loss(loss_name)
    args = dict(cfg.optimizer.args)
    if lr is not None:
        args["lr"] = lr
    opt = make_optimizer(optimizer_name or cfg.optimizer.name, args,
                         model.parameters())
    return make_train_step(model, loss_fn, loss_args, needs_rng, opt,
                           cfg.training.gradient_clipping_norm, dtype,
                           generator=torch.Generator().manual_seed(1))


def ffn_gates(model, batch, run):
    """Runs ``run()`` with every FFN sublayer call of ``model``'s encoder
    recorded (with ``MEGA_ENCODER_ENABLED``, every B10 call, replayed:
    ``encoder_ffn_gates``): returns (run's result, per block the
    [rows, d_ff] bools of the hidden units' ReLU gates at the valid
    documents)."""
    import allrank_tpu_torch.models.transformer as transformer
    from allrank_tpu_torch.models.core import std_layer_norm

    valid = (batch[1] != -1.0).reshape(-1).cpu()
    gates, inner = [], transformer.ffn_sublayer
    inner_encoder = transformer.encoder_forward
    replay = encoder_ffn_gates(gates)

    def record(x, ln_scale, ln_bias, w1, b1, *rest):
        with torch.no_grad():
            pre = std_layer_norm(x.float(), ln_scale, ln_bias) @ w1 + b1
            gates.append(pre.reshape(-1, pre.shape[-1]) > 0)
        return inner(x, ln_scale, ln_bias, w1, b1, *rest)

    def record_encoder(*args, **kwargs):
        replay(*args, **kwargs)
        return inner_encoder(*args, **kwargs)

    transformer.ffn_sublayer = record
    transformer.encoder_forward = record_encoder
    try:
        out = run()
    finally:
        transformer.ffn_sublayer = inner
        transformer.encoder_forward = inner_encoder
    return out, [g.cpu()[valid] for g in gates]


def step_one_gpu_vs_cpu(cfg, gpu_model, batch, loss=None,
                        gate_flips=False) -> tuple:
    """Step 1 in fp32 with SGD at rate 0 on ``gpu_model`` and on its copy on
    the CPU (the plain versions): asserts the loss (relative
    ``STEP_LOSS_RTOL``) and every gradient (``STEP_GRAD_TOL`` of its
    tensor's largest value plus 1e-5 of the largest gradient of all);
    returns (GPU loss, CPU loss, the worst gradient error as a share of its
    tolerance).

    With ``gate_flips`` it also returns, per block, the number of FFN
    hidden units whose ReLU gate differs between the two runs at some valid
    document (pre-activations within fp32 rounding of 0), and holds the FFN
    weights of those units (columns of W1 and b1, rows of W2) out of the
    rule: a gradient is not continuous there. At most ``GATE_FLIPS_MAX``
    units of a block may flip; the rest of every gradient, and every other
    gradient whole, stays under the rule."""
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    results, gates = [], []
    for m, b in ((gpu_model, batch), (cpu_model, [t.cpu() for t in batch])):
        step = make_step(cfg, m, "float32", optimizer_name="SGD", lr=0.0,
                         loss=loss)
        if gate_flips:
            (value, _), g = ffn_gates(m, b, lambda: step(*b))
            gates.append(g)
        else:
            value, _ = step(*b)
        results.append((value.item(), {n: p.grad.float().cpu()
                                       for n, p in m.named_parameters()}))
    (gl, gg), (cl, cg) = results
    assert math.isfinite(gl) and abs(gl - cl) <= STEP_LOSS_RTOL * abs(cl), (
        loss, gl, cl)
    keep = {}
    if gate_flips:
        for i, (a, c) in enumerate(zip(*gates)):
            same = ~(a != c).any(dim=0)
            pre = f"transformer.layers.{i}."
            keep[pre + "ff1.w"] = same[None, :].expand_as(cg[pre + "ff1.w"])
            keep[pre + "ff1.b"] = same
            keep[pre + "ff2.w"] = same[:, None].expand_as(cg[pre + "ff2.w"])
    top = max(v.abs().max().item() for v in cg.values())
    worst = 0.0
    for name, ref in cg.items():
        assert torch.isfinite(gg[name]).all(), (loss, name)
        got = gg[name]
        if name in keep:
            got, ref = got[keep[name]], ref[keep[name]]
        err, scale = rel_err(got, ref)
        allowed = STEP_GRAD_TOL * scale + 1e-5 * top
        assert err <= allowed, (loss, name, err, scale)
        worst = max(worst, err / allowed)
    if gate_flips:
        flips = [int((~keep[f"transformer.layers.{i}.ff1.b"]).sum().item())
                 for i in range(len(gates[0]))]
        assert max(flips) <= GATE_FLIPS_MAX, (
            f"FFN units with a ReLU gate flipped between GPU and CPU, per "
            f"block: {flips} (at most {GATE_FLIPS_MAX})")
        return gl, cl, worst, flips
    return gl, cl, worst


def rel_err(got, ref) -> tuple:
    """(max abs error, max abs of the reference)."""
    return ((got.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def b2_replay(got, args, dy, p, seeds) -> tuple:
    """ROADMAP Queue C5: holds a B2 backward ``got`` (dx and six gradients,
    on ``args`` = x and the six parameters, ``dy``, rate ``p`` on both
    streams) against its plain version with the ReLU gates that its dx
    shows flipped replayed (``ffn_block.gate_flips``): a hidden unit whose
    pre-activation lies within rounding of 0 gates either way in two sums
    of the same terms, and its row of dx then differs by the unit's whole
    term. At most ``GATE_FLIPS_MAX`` units (a fault upstream moves every
    pre-activation and flips far more), every gradient within ``BWD_TOL``.
    Returns (worst max abs error, worst relative to its tensor's max
    |ref|, worst share of the tolerance, flipped gates)."""
    from allrank_tpu_torch.ops.ffn_block import (
        ffn_sublayer_bwd_plain,
        gate_flips,
    )

    dtype = args[0].dtype
    rtol, atol = BWD_TOL[dtype]
    flip = gate_flips(got[0], *args, dy, p, p, seeds, rtol=rtol)
    flips = int(flip.sum().item())
    shape = tuple(args[0].shape) + (args[3].shape[-1],)
    assert flips <= GATE_FLIPS_MAX, (
        f"B2 backward {shape} {dtype} p={p}: {flips} ReLU gates flipped "
        f"(at most {GATE_FLIPS_MAX})")
    ref = ffn_sublayer_bwd_plain(*args, dy, p, p, seeds, flip=flip)
    worst = worst_rel = share = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.isfinite(g.float()).all(), (shape, dtype, p, i)
        err, scale = rel_err(g, r)
        assert err <= rtol * scale + atol, (
            f"ffn_sublayer_bwd grad {i} {shape} {dtype} p={p}, {flips} "
            f"gates flipped replayed: {err} > {rtol} x {scale} + {atol}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / (scale + atol))
        share = max(share, err / (rtol * scale + atol))
    return worst, worst_rel, share, flips


def b2_gate_flip_case(seed, d, d_ff, dtype, p, dev) -> tuple:
    """ROADMAP Queue C5: B2's backward at (B, L) with inputs drawn from a
    generator of ``seed`` (``ffn_inputs``, then dy), against its plain
    version without the replay, and with it (``b2_replay``). Returns (worst
    error share of the tolerance without the replay, flipped gates, worst
    share with them replayed)."""
    from allrank_tpu_torch.ops.ffn_block import (
        ffn_sublayer_bwd,
        ffn_sublayer_bwd_plain,
    )

    gen = torch.Generator().manual_seed(seed)
    args = ffn_inputs(gen, B, L, d, d_ff, dtype, dev)
    dy = torch.randn(B, L, d, generator=gen).to(dtype).to(dev)
    seeds = (101, 202)
    got = ffn_sublayer_bwd(*args, dy, p, p, seeds)
    rtol, atol = BWD_TOL[dtype]
    ref = ffn_sublayer_bwd_plain(*args, dy, p, p, seeds)
    unreplayed = max(err / (rtol * scale + atol) for err, scale in
                     (rel_err(g, r) for g, r in zip(got, ref)))
    _, _, replayed, flips = b2_replay(got, args, dy, p, seeds)
    return unreplayed, flips, replayed


def b2_mma_case(gen, b, l, d, d_ff, p, dev, offset: int = 0) -> tuple:
    """B2's bf16 tensor-core route against its plain version at one shape:
    the forward (dropout ``p`` on both streams), the backward with the C5
    replay (``b2_replay``) and a second backward that must give the same
    bits; x and dy moved ``offset`` elements off the allocator's alignment.
    Phases 3 and 7's tolerances. Returns (the forward's max abs error, the
    backward's worst share of its tolerance, flipped gates)."""
    from allrank_tpu_torch.ops.ffn_block import (
        ffn_sublayer_bwd,
        ffn_sublayer_fwd,
        ffn_sublayer_fwd_plain,
    )

    bf16 = torch.bfloat16
    seeds = (101, 202)
    args = ffn_inputs(gen, b, l, d, d_ff, bf16, dev)
    dy = torch.randn(b, l, d, generator=gen).to(bf16).to(dev)
    if offset:
        args[0], dy = off_boundary(args[0], offset), off_boundary(dy, offset)
    fwd_n = ffn_sublayer_fwd.route_launches["mma"]
    bwd_n = ffn_sublayer_bwd.route_launches["mma"]
    y = ffn_sublayer_fwd(*args, p, p, seeds)
    got = ffn_sublayer_bwd(*args, dy, p, p, seeds)
    again = ffn_sublayer_bwd(*args, dy, p, p, seeds)
    torch.cuda.synchronize()
    assert (ffn_sublayer_fwd.route_launches["mma"] == fwd_n + 1
            and ffn_sublayer_bwd.route_launches["mma"] == bwd_n + 2), (
        "B2 did not take its tensor-core route")
    ref_y = ffn_sublayer_fwd_plain(*args, p, p, seeds)
    assert torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), ref_y.float(), **KERNEL_TOL[bf16])
    for i, (g, g2) in enumerate(zip(got, again)):
        assert torch.equal(g, g2), (
            f"B2 mma backward grad {i} differs between two runs B={b} L={l} "
            f"d={d} d_ff={d_ff} p={p}")
    _, _, share, flips = b2_replay(got, args, dy, p, seeds)
    return rel_err(y, ref_y)[0], share, flips


def b1_library_bwd(args, dy, h):
    """The backward of ``b1_library`` by autograd (SDPA's and matmul's own
    backward kernels): returns a function that runs it once."""
    from allrank_tpu_torch.tools.time_sublayers import b1_library

    xx, mask, g, bb, wqkv, bqkv, wout, bout = args
    dtype = xx.dtype
    leaves = [t.detach().to(dtype).requires_grad_()
              for t in (xx, g, bb, wqkv, bqkv, wout, bout)]
    mask_add = torch.zeros(xx.shape[0], 1, 1, xx.shape[1], dtype=dtype,
                           device=xx.device).masked_fill(
        mask[:, None, None, :], -1e9)
    out = b1_library(leaves[0], mask_add, *leaves[1:], h)
    return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)


def b2_library_bwd(args, dy):
    from allrank_tpu_torch.tools.time_sublayers import b2_library

    dtype = args[0].dtype
    leaves = [t.detach().to(dtype).requires_grad_() for t in args]
    out = b2_library(*leaves)
    return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)


def chain_library(pair_args, kw):
    """The lambdaLoss pair chain in the JAX package's XLA-path formulation
    (``losses/lambdaloss._plain_chain``), a yardstick only: returns
    (forward, backward by autograd) as functions that run it once."""
    import allrank_tpu_torch.losses.lambdaloss as ll

    yp, ts, g, valid = pair_args
    ok = valid > 0.5
    raw = torch.where(ok, ts, float("-inf"))
    d_row = ll.position_tables(yp.shape[1], yp.device)[0]

    def forward(leaf):
        return ll._plain_chain(leaf, raw, ts, ok, g, d_row, None,
                               kw["scheme"], kw["k_eff"], kw["sigma"],
                               kw["mu"], kw["log_base"], kw["eps"])[0]

    leaf = yp.detach().requires_grad_()
    total = forward(leaf)
    return (lambda: forward(yp),
            lambda: torch.autograd.grad(total, leaf, retain_graph=True))


def approx_library(s, valid_f, alpha, eps):
    """The approxNDCG rank sum as the JAX package's XLA-path chain of torch
    ops (``losses/approxndcg._plain_pos``), a yardstick only: returns
    (forward, backward by autograd) as functions that run it once."""
    from allrank_tpu_torch.losses.approxndcg import _plain_pos

    ok = valid_f > 0.5
    leaf = s.detach().requires_grad_()
    out = _plain_pos(leaf, ok, alpha, eps)
    u = torch.ones_like(out)
    return (lambda: _plain_pos(s, ok, alpha, eps),
            lambda: torch.autograd.grad(out, leaf, u, retain_graph=True))


def qkv_inputs(gen, b, h, l, dk, dtype, dev, empty=True):
    """q, k, v and an output cotangent [B, h, L, d_k], and the padding mask:
    slate 0 full, the others ragged, the last fully padded if ``empty``."""
    q, k, v, do = (torch.randn(b, h, l, dk, generator=gen).to(dtype).to(dev)
                   for _ in range(4))
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = l
    if empty and b > 1:
        lengths[-1] = 0
    return q, k, v, (torch.arange(l)[None, :] >= lengths[:, None]).to(dev), do


def off_boundary(t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    storage, so its base pointer is off the allocator's alignment."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


def b1_mma_case(gen, b, l, d, h, p, dev, offset: int = 0) -> tuple:
    """B1's bf16 tensor-core route against its plain version at one shape:
    the forward (dropout ``p`` on both streams), the backward on its saved
    state (qkv moved ``offset`` elements off the allocator's alignment) and
    a second backward that must give the same bits; phases 2 and 7's
    tolerances. Returns (the forward's max abs error, the backward's worst
    error as a share of its tolerance)."""
    from allrank_tpu_torch.ops.attention_block import (
        attention_sublayer_bwd,
        attention_sublayer_bwd_plain,
        attention_sublayer_fwd,
        attention_sublayer_fwd_plain,
    )

    bf16 = torch.bfloat16
    seeds = (101, 202)
    args = attn_inputs(gen, b, l, d, bf16, dev)
    dy = torch.randn(b, l, d, generator=gen).to(bf16).to(dev)
    fwd_n = attention_sublayer_fwd.route_launches["mma"]
    bwd_n = attention_sublayer_bwd.route_launches["mma"]
    y, (qkv, stats) = attention_sublayer_fwd(*args, h, p, p, seeds,
                                             return_saved=True)
    if offset:
        qkv = off_boundary(qkv, offset)
    got = attention_sublayer_bwd(*args, dy, h, p, p, seeds,
                                 saved=(qkv, stats))
    again = attention_sublayer_bwd(*args, dy, h, p, p, seeds,
                                   saved=(qkv, stats))
    torch.cuda.synchronize()
    assert (attention_sublayer_fwd.route_launches["mma"] == fwd_n + 1
            and attention_sublayer_bwd.route_launches["mma"] == bwd_n + 2), (
        "B1 did not take its tensor-core route")
    ref_y = attention_sublayer_fwd_plain(*args, h, p, p, seeds)
    assert torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), ref_y.float(), **KERNEL_TOL[bf16])
    ref = attention_sublayer_bwd_plain(*args, dy, h, p, p, seeds)
    rtol, atol = BWD_TOL[bf16]
    worst = 0.0
    for i, (g, r, g2) in enumerate(zip(got, ref, again)):
        assert torch.isfinite(g.float()).all(), (b, l, d, h, p, i)
        assert torch.equal(g, g2), (
            f"B1 mma backward grad {i} differs between two runs "
            f"B={b} L={l} d={d} h={h} p={p}")
        err, scale = rel_err(g, r)
        assert err <= rtol * scale + atol, (
            f"B1 mma grad {i} B={b} L={l} d={d} h={h} p={p} offset={offset}:"
            f" {err} > {rtol} x {scale} + {atol}")
        worst = max(worst, err / (rtol * scale + atol))
    return rel_err(y, ref_y)[0], worst


def timing_row(rows: dict, kernel_name: str, dtype, way: str) -> tuple:
    """(the row in ``rows`` that a timing of ``kernel_name`` in ``dtype``
    goes to, the suffix of its keys): B1's and B2's two routes are two rows
    of unsuffixed keys (the SIMT kernels, fp32, under the kernel's name; the
    tensor cores, bf16, under ``<name>_mma``); any other kernel is one row,
    its bf16 keys suffixed ``_bf16``."""
    if kernel_name.startswith(("attention_sublayer", "ffn_sublayer")):
        name, sfx = kernel_name + ("_mma" if way == "mma" else ""), ""
    else:
        name, sfx = kernel_name, "" if dtype == torch.float32 else "_bf16"
    return rows.setdefault(name, {"name": name, "route": "cuda"}), sfx


def attention_work(b, h, l, dk, dtype, backward: bool) -> tuple:
    """(operations, bytes) of bare attention on [B, h, L, d_k]: forward
    4 B h L^2 d_k (q . k^T and P . v), backward 10 B h L^2 d_k (S and dP
    rebuilt, dV, dQ, dK); q, k, v and the mask read, out written, or in
    the backward q, k, v, dO, out, the row statistics and the mask read
    and dq, dk, dv written."""
    esz = torch.tensor([], dtype=dtype).element_size()
    t = b * h * l * dk * esz
    flops = (10 if backward else 4) * b * h * l * l * dk
    moved = (7 * t + b * h * l * 8 if backward else 4 * t) + b * l
    return flops, moved


def attention_rate(dtype):
    """The peak B4's and B5's kernels of ``dtype`` are bound by: bf16 on the
    tensor cores; fp32 as 3xTF32 on them ("tf32x3")."""
    return "tf32x3" if dtype == torch.float32 else dtype


def plain_scores(model, x, lengths, dtype):
    """The model's scores on the card with every kernel replaced by its
    plain version (called directly; the wrappers take them on the CPU
    only): the reference of the long-slate scorer."""
    from allrank_tpu_torch.models.core import get_activation, std_layer_norm
    from allrank_tpu_torch.models.transformer import split_attention_sublayer
    from allrank_tpu_torch.ops.attention_tiled import (
        tiled_attention_fwd_plain,
    )
    from allrank_tpu_torch.ops.ffn_block import ffn_sublayer_fwd_plain

    def tiled(q, k, v, m, p, seed):
        return tiled_attention_fwd_plain(q, k, v, m, p, seed)[0]

    with torch.inference_mode():
        x = torch.as_tensor(x, device=lengths.device)
        mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                >= lengths[:, None])
        hid = model.fc(x.to(dtype))
        enc = model.transformer
        assert enc.pe is None
        for blk in enc.layers:
            hid = split_attention_sublayer(
                hid, mask, blk.ln1.scale, blk.ln1.bias, blk.qkv.w, blk.qkv.b,
                blk.out.w, blk.out.b, blk.h, attention=tiled)
            hid = ffn_sublayer_fwd_plain(hid, blk.ln2.scale, blk.ln2.bias,
                                         blk.ff1.w, blk.ff1.b, blk.ff2.w,
                                         blk.ff2.b)
        hid = std_layer_norm(hid, enc.final_ln.scale, enc.final_ln.bias)
        out = model.output(hid.float()).squeeze(2)
        out = get_activation(model.mdef.output.output_activation)(out)
        return torch.where(mask, float("-inf"), out.float())



def chain_work(pair_args, kw, ops_per_pair: int, backward: bool) -> tuple:
    """(operations, bytes, selected pairs): what the lambdaLoss pair chain
    needs on these inputs. ``ops_per_pair`` for each pair the scheme selects
    (both documents valid and inside the top k_eff, the first label above
    the second), one compare
    for every other pair; the four [B, k] inputs and the two [k] tables read
    once; the two [B] results written, or [B] read and [B, k] written by the
    backward."""
    yp, ts, _, valid = pair_args
    b, k = yp.shape
    ok = (valid > 0.5) & (torch.arange(k, device=yp.device) < kw["k_eff"])
    sel = ok[:, :, None] & ok[:, None, :]
    if kw["scheme"] != "ndcgLoss1_scheme":
        sel = sel & (ts[:, :, None] > ts[:, None, :])
    selected = int(sel.sum().item())
    moved = nbytes(*pair_args) + 2 * k * 4 + (
        b * 4 + b * k * 4 if backward else 2 * b * 4)
    return ops_per_pair * selected + (b * k * k - selected), moved, selected


def short_kernel_row(name, kernel, plain, lib_fn, work, err, shape,
                     tag) -> dict:
    """The record of a kernel of 10-300 us, printed too: the device's own
    time for the kernel (``graph_ms``) with its event-timed call beside it,
    the event-timed calls of its plain version and of the library
    formulation, and the bound of ``work`` = (operations, bytes, ...)."""
    ms = graph_ms(kernel)
    call_ms, plain_ms, lib_ms = (median_ms(fn, iters=20)
                                 for fn in (kernel, plain, lib_fn))
    flops, moved = work[:2]
    bound_ms, bound_by = bound(flops, moved, torch.float32)
    print(f"time {name} float32 {shape}: kernel {ms:.4f} ms of device time "
          f"(20 calls in one CUDA graph; one event-timed call {call_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms a call, library (torch-op chain, "
          f"autograd) {lib_ms:.4f} ms a call, bound {bound_ms:.5f} ms "
          f"({bound_by}: {flops / 1e9:.4f} G operations, "
          f"{moved / 1e6:.3f} MB) {tag}")
    return {"name": name, "route": "cuda", "max_abs_err": err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "gflop": flops / 1e9, "mbytes": moved / 1e6}


def profile_calls(fn, tag: str, calls: int = 5, also: tuple = ()) -> dict:
    """Device time by kernel name over ``calls`` calls of ``fn`` (the eight
    largest, and every kernel whose name holds one of ``also``), and the
    device's idle share of that window (``timing.trace_kernels``; prints
    "not measured" where every trace lost device events). Returns the
    device us per call by kernel name (empty if not measured)."""
    try:
        kernels, window_us = trace_kernels(fn, calls)
    except IncompleteTrace as err:
        print(f"profile: {err}; device time and idle share not measured "
              f"{tag}")
        return {}
    by_name = {}
    for name, start, end in kernels:
        by_name[name] = by_name.get(name, 0.0) + end - start
    busy = busy_us(kernels)
    print(f"profile: {calls} calls, host window {window_us / calls:.1f} us "
          f"per call, device busy {busy / calls:.1f} us per call, idle "
          f"share {1 - busy / window_us:.3f} {tag}")
    total = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for kname, us in ranked[:8] + [kv for kv in ranked[8:]
                                   if any(a in kv[0] for a in also)]:
        print(f"  {us / calls:9.1f} us per call ({us / total:.3f} of device "
              f"time) {kname[:90]}")
    return {kname: us / calls for kname, us in by_name.items()}


def soft_sort_inputs(gen, n, l, dev):
    """Scores, 0/1 pad floats (ragged lengths, slate 0 full, the last one
    fully padded), power-of-two gains and an output cotangent."""
    s = torch.randn(n, l, generator=gen)
    lengths = torch.randint(1, l + 1, (n,), generator=gen)
    lengths[0] = l
    lengths[-1] = 0
    pad = (torch.arange(l)[None, :] >= lengths[:, None]).float()
    labels = torch.randint(0, 5, (n, l), generator=gen).float()
    vec = (2.0 ** labels - 1.0) * (1.0 - pad)
    dout = torch.randn(n, l, generator=gen)
    return [t.to(dev) for t in (s, pad, vec, dout)]


def premasked_matrices(gen, n, l, dev):
    """Row-stochastic [n, l, l] matrices with the Sinkhorn pre-fill of ragged
    padding (slate 0 full, the last one fully padded)."""
    lengths = torch.randint(1, l + 1, (n,), generator=gen)
    lengths[0] = l
    lengths[-1] = 0
    pad = torch.arange(l)[None, :] >= lengths[:, None]
    m0 = torch.softmax(torch.randn(n, l, l, generator=gen) * 3.0, dim=-1)
    m0 = torch.where(pad[:, :, None] | pad[:, None, :], 0.0, m0)
    return torch.where(pad[:, :, None] & pad[:, None, :], 1.0, m0).to(dev)


def assert_grad_close(got, ref, what) -> float:
    assert torch.isfinite(got).all(), f"{what}: non-finite gradient"
    err, scale = rel_err(got, ref)
    rtol, atol = SOFT_GRAD_TOL
    assert err <= rtol * scale + atol, f"{what}: {err} > {rtol} x {scale}"
    return err


def soft_sort_library(s, pad, vec, transpose):
    """The soft-sort chain in the JAX package's XLA-path formulation
    (``deterministic_neural_sort`` -> the freezing ``sinkhorn_scaling`` ->
    ``einsum``), a yardstick only: returns (forward, backward by autograd)
    as functions that run it once."""
    from allrank_tpu_torch.ops.soft_sort import (
        deterministic_neural_sort,
        sinkhorn_scaling,
    )

    mask = pad > 0.5

    def forward(leaf):
        p = sinkhorn_scaling(deterministic_neural_sort(leaf, 1.0, mask), mask,
                             backend="plain")
        return torch.einsum("bij,bi->bj" if transpose else "bij,bj->bi", p,
                            vec)

    leaf = s.detach().requires_grad_()
    out = forward(leaf)
    dout = torch.ones_like(out)
    return (lambda: forward(s),
            lambda: torch.autograd.grad(out, leaf, dout, retain_graph=True))


def sinkhorn_library(m0):
    """Sinkhorn scaling as the freezing chain of torch ops (forward, and
    backward by autograd), a yardstick only."""
    from allrank_tpu_torch.ops.soft_sort import sinkhorn_scaling

    leaf = m0.detach().requires_grad_()
    out = sinkhorn_scaling(leaf, backend="plain")
    dp = torch.ones_like(out)
    return (lambda: sinkhorn_scaling(m0, backend="plain"),
            lambda: torch.autograd.grad(out, leaf, dp, retain_graph=True))


def write_cli_dataset(data_dir: str, seed: int = 0) -> dict:
    """train.txt (1,024 slates) and one validation file under both role
    names the two configs ask for (test.txt, vali.txt; 256 slates): 136
    features, slate lengths drawn from 40-240, labels 0-4 that follow two
    features plus noise. Returns {role: (X, y, qid)} as written."""
    from allrank_tpu_torch.data.dummy import write_svmlight

    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    arrays = {}
    for role, n_slates in (("train", CLI_TRAIN_SLATES),
                           ("test", CLI_VAL_SLATES)):
        lengths = rng.randint(40, L + 1, size=n_slates)
        x = rng.randn(int(lengths.sum()), N_FEATURES)
        y = np.clip(np.round(2.0 + x[:, 0] + 0.5 * x[:, 1]
                             + 0.5 * rng.randn(len(x))), 0, 4).astype(np.int32)
        qid = np.repeat(np.arange(n_slates), lengths)
        write_svmlight(os.path.join(data_dir, f"{role}.txt"), x, y, qid)
        arrays[role] = (x, y, qid)
    shutil.copyfile(os.path.join(data_dir, "test.txt"),
                    os.path.join(data_dir, "vali.txt"))
    return arrays


def run_cli(config_path: str, work_dir: str, run_id: str, epochs: int):
    """``allrank_tpu_torch.main.run`` on ``config_path`` with only the data
    path, the epochs and the expected-metrics gate changed; returns (result,
    output directory, per-epoch train and validation losses, seconds)."""
    from allrank_tpu_torch.main import run

    with open(config_path) as f:
        cfg = json.load(f)
    cfg["data"]["path"] = os.path.join(work_dir, "data")
    cfg["training"]["epochs"] = epochs
    cfg["expected_metrics"] = {"val": {"ndcg_5": 0.0}}
    cut = os.path.join(work_dir, f"{run_id}.json")
    with open(cut, "w") as f:
        json.dump(cfg, f)
    job_dir = os.path.join(work_dir, "job")
    t0 = time.perf_counter()
    result = run(Namespace(job_dir=job_dir, run_id=run_id,
                           config_file_name=cut))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out_dir = os.path.join(job_dir, "results", run_id)
    losses = {}
    for role in ("train", "val"):
        with open(os.path.join(job_dir, "tb_evals", "single", run_id,
                               f"loss_{role}", "scalars.jsonl")) as f:
            losses[role] = [json.loads(line)["value"] for line in f]
    return result, out_dir, losses, seconds


def check_cli_outputs(result, out_dir, losses, epochs, metric_names) -> None:
    assert result["epochs"] == epochs, result["epochs"]
    for role in ("train", "val"):
        assert len(losses[role]) == epochs, losses
        assert all(math.isfinite(v) for v in losses[role]), losses
    for name in ("model.npz", "experiment_result.json", "used_config.json",
                 "training.log"):
        assert os.path.getsize(os.path.join(out_dir, name)) > 0, name
    with open(os.path.join(out_dir, "experiment_result.json")) as f:
        dumped = json.load(f)
    for name in metric_names:
        for role in ("train", "val"):
            value = result[f"{role}_metrics"][name]
            assert 0.0 <= value <= 1.0, (role, name, value)
            assert dumped[f"{role}_metrics/{name}"] == value
    with np.load(os.path.join(out_dir, "model.npz")) as weights:
        assert all(np.isfinite(weights[k]).all() for k in weights.files)


def post(url: str, slate: np.ndarray, binary: bool) -> np.ndarray:
    if binary:
        buf = io.BytesIO()
        np.save(buf, slate)
        req = urllib.request.Request(
            url + "/score", data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return np.load(io.BytesIO(r.read()), allow_pickle=False)
    req = urllib.request.Request(
        url + "/score", data=json.dumps({"slate": slate.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.asarray(json.loads(r.read())["scores"], dtype=np.float32)


def q8_inputs(gen, m, k, n, dtype, mode, dev):
    """X1's arguments: x [m, k] (every other row on exact .5 ties after
    scaling by 4, row m // 2 all zero), w_t [n, k] int8, scale and b [n],
    and the static multiplier (4.0, or a [k] vector with every third
    channel 4.0) or None (dynamic)."""
    x = torch.randn(m, k, generator=gen) * 3
    x[::2] = (torch.randint(-300, 300, x[::2].shape, generator=gen)
              + 0.5) / 4
    x[m // 2] = 0.0
    w_t = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    scale = torch.rand(n, generator=gen) * 0.01
    b = torch.randn(n, generator=gen)
    inv = {"static": torch.tensor(4.0),
           "static_channels": torch.where(
               torch.arange(k) % 3 == 0, 4.0,
               torch.rand(k, generator=gen) * 30 + 1),
           "dynamic": None}[mode]
    return [x.to(dtype).to(dev), w_t.to(dev), scale.to(dev), b.to(dev),
            None if inv is None else inv.to(dev)]


def q8_work(x, w_t, inv, out_dtype) -> tuple:
    """(operations, bytes) of X1 on these inputs: 2 M K N int8 operations;
    x, w, scale, b and the multiplier (static) or the row scales (dynamic)
    read once, y written once."""
    m, k = x.shape
    n = w_t.shape[0]
    extra = inv.numel() * 4 if inv is not None else m * 4
    moved = (nbytes(x, w_t) + 2 * n * 4 + extra
             + m * n * torch.tensor([], dtype=out_dtype).element_size())
    return 2 * m * k * n, moved


def q8_library(x, w_t, scale, b, inv):
    """The static int8 dense layer in library calls, a yardstick only: the
    quantize ops, ``torch._int_mm`` and the epilogue ops; None where
    ``_int_mm``'s shape rules refuse (M <= 16, K or N not a multiple of 8)."""
    m, k = x.shape
    n = w_t.shape[0]
    if m <= 16 or k % 8 or n % 8:
        return None
    w_kn = w_t.t()

    def run():
        xq = torch.clamp(torch.round(x.float() * inv), -127, 127).to(
            torch.int8)
        return (torch._int_mm(xq, w_kn).float() * scale + b).to(x.dtype)

    return run


def calibration_batches(gen, n, dev):
    """``n`` synthetic serve-style (x [B, L, F], lengths) batches."""
    out = []
    for _ in range(n):
        x = torch.randn(B, L, N_FEATURES, generator=gen)
        lengths = torch.randint(1, L + 1, (B,), generator=gen)
        out.append((x.to(dev), lengths.to(dev)))
    return out


@contextlib.contextmanager
def captured_attention_core():
    """Records ``(wrapper name, q, k, v, key_mask, out)`` of every call the
    int8 tower (``quant.py``) makes to its attention core, through the real
    wrappers: their launches count as the main path's."""
    import allrank_tpu_torch.quant as quant

    real = {name: getattr(quant, name)
            for name in ("attention_fused_fwd", "tiled_attention_fwd")}
    record = []

    def recording(name, fn):
        def call(q, k, v, key_mask, *args, **kwargs):
            out = fn(q, k, v, key_mask, *args, **kwargs)
            record.append((name, q, k, v, key_mask, out))
            return out
        return call

    for name, fn in real.items():
        setattr(quant, name, recording(name, fn))
    try:
        yield record
    finally:
        for name, fn in real.items():
            setattr(quant, name, fn)


def check_captured_attention(record, want_shape) -> dict:
    """Holds each recorded attention-core output against the kernel's plain
    version on the same q, k, v and mask (bf16, p = 0); returns the largest
    error by wrapper name."""
    from allrank_tpu_torch.ops.attention_fused import attention_fused_fwd_plain
    from allrank_tpu_torch.ops.attention_tiled import tiled_attention_fwd_plain

    plain = {"attention_fused_fwd": attention_fused_fwd_plain,
             "tiled_attention_fwd":
             lambda *a: tiled_attention_fwd_plain(*a)[0]}
    errs = {}
    for name, q, k, v, key_mask, out in record:
        assert q.dtype == torch.bfloat16 and tuple(q.shape) == want_shape, (
            name, q.dtype, tuple(q.shape))
        ref = plain[name](q, k, v, key_mask)
        torch.testing.assert_close(out.float(), ref.float(),
                                   **KERNEL_TOL[torch.bfloat16])
        errs[name] = max(errs.get(name, 0.0),
                         float((out.float() - ref.float()).abs().max()))
    return errs


def quality(got, ref, valid) -> tuple:
    """(score correlation, share of non-empty slates whose top document is
    the same) of two [B, L] score arrays."""
    corr = float(np.corrcoef(got[valid], ref[valid])[0, 1])
    rows = valid.any(axis=1)
    top = (np.where(valid, got, -np.inf).argmax(1)
           == np.where(valid, ref, -np.inf).argmax(1))
    return corr, float(top[rows].mean())


def encoder_inputs(gen, b, l, d, h, d_ff, n, dtype, dev):
    """B10's arguments: x and an output cotangent [B, L, d] in ``dtype``,
    the key mask (ragged lengths, slate 0 fully padded), 4N seeds, the 12
    stacked fp32 weights [N, ...] and the final LN pair."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    x, dy = (r(b, l, d).to(dtype).to(dev) for _ in range(2))
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = 0
    mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(dev)
    stacks = [1 + r(n, d, scale=0.1), r(n, d, scale=0.1),
              r(n, d, 3 * d, scale=d ** -0.5), r(n, 3 * d, scale=0.1),
              r(n, d, d, scale=d ** -0.5), r(n, d, scale=0.1),
              1 + r(n, d, scale=0.1), r(n, d, scale=0.1),
              r(n, d, d_ff, scale=d ** -0.5), r(n, d_ff, scale=0.1),
              r(n, d_ff, d, scale=d_ff ** -0.5), r(n, d, scale=0.1)]
    fs, fb = 1 + r(d, scale=0.1), r(d, scale=0.1)
    seeds = tuple(range(300, 300 + 4 * n))
    return (x, dy, mask, seeds, [t.to(dev) for t in stacks], fs.to(dev),
            fb.to(dev))


def encoder_check(y, got, chained_y, chained, plain_y, plain, dtype) -> dict:
    """Holds B10's output and 15 gradients against the chained B1/B2
    kernels (whose tile bodies it runs; only the final LayerNorm is
    computed another way) by phases 2 and 7's tolerances, and against its
    plain version: no further from it than the chained kernels are, plus
    the same tolerance. Each sublayer kernel is held to its plain version on
    the same inputs (phases 2, 3 and 7); through N blocks the kernels and
    the plain chain drift apart by more: an fp32 rounding difference
    upstream flips a ReLU gate whose pre-activation lies near 0 (a jump of
    the gradient), and bf16 one-ulp flips compound block by block. Returns
    the largest errors."""
    rtol, atol = BWD_TOL[dtype]
    assert torch.isfinite(y.float()).all(), "B10: non-finite output"
    torch.testing.assert_close(y.float(), chained_y.float(),
                               **KERNEL_TOL[dtype])
    out = {"fwd_chained": rel_err(y, chained_y)[0],
           "fwd_plain": rel_err(y, plain_y)[0],
           "fwd_chained_plain": rel_err(chained_y, plain_y)[0],
           "y_equal": bool(torch.equal(y, chained_y)), "bwd_chained": 0.0,
           "bwd_chained_rel": 0.0, "bwd_plain": 0.0,
           "bwd_chained_plain": 0.0, "grads_equal": 0}
    tol = KERNEL_TOL[dtype]
    allowed = tol["atol"] + tol["rtol"] * plain_y.float().abs().max().item()
    assert out["fwd_plain"] <= out["fwd_chained_plain"] + allowed, out
    for i, (g, c, r) in enumerate(zip(got, chained, plain)):
        assert g.shape == r.shape and torch.isfinite(g.float()).all(), i
        err, scale = rel_err(g, c)
        assert err <= rtol * scale + atol, (
            f"B10 gradient {i} vs chained: {err} > {rtol} x {scale}")
        base, ref_scale = rel_err(c, r)
        err_plain = rel_err(g, r)[0]
        assert err_plain <= base + rtol * ref_scale + atol, (
            f"B10 gradient {i} vs plain: {err_plain} > chained's {base} + "
            f"{rtol} x {ref_scale}")
        out["bwd_chained"] = max(out["bwd_chained"], err)
        out["bwd_chained_rel"] = max(out["bwd_chained_rel"],
                                     err / (rtol * scale + atol))
        out["bwd_plain"] = max(out["bwd_plain"], err_plain)
        out["bwd_chained_plain"] = max(out["bwd_chained_plain"], base)
        out["grads_equal"] += int(torch.equal(g, c))
    return out


def encoder_chained_fwd(x, mask, seeds, stacks, fs, fb, h, p, way):
    """B10's function through the chained B1/B2 kernels, B1 and B2 on route
    ``way`` (the encoder with the switch off takes ``route``'s; B10 runs the
    SIMT routes' tile bodies), the final LayerNorm in torch ops: (y, the
    state ``encoder_chained_bwd`` reads)."""
    from allrank_tpu_torch.models.core import std_layer_norm
    from allrank_tpu_torch.ops.attention_block import launch_fwd
    from allrank_tpu_torch.ops.ffn_block import launch_fwd as ffn_launch_fwd

    inputs, saved = [], []
    for n in range(stacks[0].shape[0]):
        w = [t[n] for t in stacks]
        inputs.append(x)
        x, sv = launch_fwd(way, x, mask, *w[:6], h, p, p,
                           seeds[4 * n:4 * n + 2], return_saved=True)
        saved.append(sv)
        inputs.append(x)
        x = ffn_launch_fwd(way, x, *w[6:], p, p, seeds[4 * n + 2:4 * n + 4])
    return std_layer_norm(x, fs, fb), (inputs, saved, x, way)


def encoder_chained_bwd(state, mask, seeds, stacks, fs, dy, h, p):
    """The backward of ``encoder_chained_fwd`` through the B1/B2 backward
    kernels on the forward's route: (dx, *12 stacked gradients, dfs, dfb),
    as B10's."""
    from allrank_tpu_torch.ops.attention_block import launch_bwd, ln_backward
    from allrank_tpu_torch.ops.ffn_block import launch_bwd as ffn_launch_bwd

    inputs, saved, z, way = state
    n_blocks = stacks[0].shape[0]
    dz, dfs, dfb = ln_backward(z.float(), fs, dy.float())
    g = dz.to(z.dtype)
    grads = [[None] * n_blocks for _ in range(12)]
    for n in reversed(range(n_blocks)):
        w = [t[n] for t in stacks]
        g, *ffn = ffn_launch_bwd(way, inputs[2 * n + 1], *w[6:], g, p, p,
                                 seeds[4 * n + 2:4 * n + 4])
        g, *attn = launch_bwd(way, inputs[2 * n], mask, *w[:6], g, h, p, p,
                              seeds[4 * n:4 * n + 2], saved=saved[n])
        for i, t in enumerate(attn + ffn):
            grads[i][n] = t
    return (g, *(torch.stack(t) for t in grads), dfs, dfb)


def encoder_work(b, l, d, h, d_ff, n, dtype, backward: bool) -> tuple:
    """(operations, bytes) of B10 on these shapes: per block B1's and B2's
    products counted once (forward 2 M d 3d + 4 B h L^2 d_k + 2 M d^2 +
    4 M d d_ff, backward 16 M d^2 + 12 B h L^2 d_k + 10 M d d_ff, M = B L;
    the backward's replay of the forward is a cost of its design); x, the
    mask and the weights read and y written, or x, dy, the mask and the
    weights read and dx and the fp32 gradients written."""
    m, dk = b * l, d // h
    if backward:
        flops = n * (16 * m * d * d + 12 * b * h * l * l * dk
                     + 10 * m * d * d_ff)
    else:
        flops = n * (2 * m * d * 3 * d + 4 * b * h * l * l * dk
                     + 2 * m * d * d + 4 * m * d * d_ff)
    weights = 4 * (n * (4 * d * d + 2 * d * d_ff + 9 * d + d_ff) + 2 * d)
    esz = torch.tensor([], dtype=dtype).element_size()
    moved = (3 if backward else 2) * m * d * esz + b * l + weights * (
        2 if backward else 1)
    return flops, moved


def encoder_library(x, mask, stacks, fs, fb, dy, h):
    """B10's function in library calls, a yardstick only: per block
    ``b1_library`` (std-LN, torch.matmul, scaled_dot_product_attention) and
    ``b2_library`` (std-LN, torch.matmul, relu), then the final std-LN, in
    x's dtype; returns (forward, backward by autograd) as functions that
    run it once."""
    from allrank_tpu_torch.models.core import std_layer_norm
    from allrank_tpu_torch.tools.time_sublayers import b1_library, b2_library

    dtype = x.dtype
    mask_add = torch.zeros(x.shape[0], 1, 1, x.shape[1], dtype=dtype,
                           device=x.device).masked_fill(
        mask[:, None, None, :], -1e9)

    def forward(xx, ws, fs_, fb_):
        for n in range(ws[0].shape[0]):
            w = [t[n] for t in ws]
            xx = b1_library(xx, mask_add, *w[:6], h)
            xx = b2_library(xx, *w[6:])
        return std_layer_norm(xx, fs_, fb_)

    leaves = [t.detach().to(dtype).requires_grad_()
              for t in [x] + list(stacks) + [fs, fb]]
    out = forward(leaves[0], leaves[1:13], leaves[13], leaves[14])
    cast = [t.to(dtype) for t in stacks]
    return (lambda: forward(x, cast, fs.to(dtype), fb.to(dtype)),
            lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))


def encoder_ffn_gates(record):
    """``ffn_gates``' recorder for the encoder with the switch on: replays
    each recorded B10 call through the chained sublayer forwards (the
    kernels on the card, their plain versions on the CPU: B10's own
    intermediates, which it does not expose) and returns per block the
    [rows, d_ff] gates at the FFN inputs; the replay's launches are taken
    back off the counters."""
    from allrank_tpu_torch.models.core import std_layer_norm
    from allrank_tpu_torch.ops.attention_block import attention_sublayer_fwd
    from allrank_tpu_torch.ops.ffn_block import ffn_sublayer_fwd

    def call(x, mask, seeds, stacks, fs, fb, *, h, p_drop=0.0):
        counts = (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches)
        routes = (dict(attention_sublayer_fwd.route_launches),
                  dict(ffn_sublayer_fwd.route_launches))
        with torch.no_grad():
            hid = x
            for n in range(stacks[0].shape[0]):
                w = [t[n].detach() for t in stacks]
                hid = attention_sublayer_fwd(hid, mask, *w[:6], h, p_drop,
                                             p_drop, seeds[4 * n:4 * n + 2])
                pre = std_layer_norm(hid.float(), w[6], w[7]) @ w[8] + w[9]
                record.append(pre.reshape(-1, pre.shape[-1]) > 0)
                hid = ffn_sublayer_fwd(hid, *w[6:], p_drop, p_drop,
                                       seeds[4 * n + 2:4 * n + 4])
        attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches = counts
        (attention_sublayer_fwd.route_launches,
         ffn_sublayer_fwd.route_launches) = routes
    return call


def x2_inputs(gen, b, l, dev):
    """x [B, L, 128], pre [B, L, 384], W1, W2 and the next kernel's W1',
    bf16, at the JAX probe's scales."""
    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(
            torch.bfloat16).to(dev)

    return (r(b, l, 128, scale=0.5), r(b, l, 384, scale=0.5),
            r(128, 384, scale=0.05), r(384, 128, scale=0.05),
            r(128, 384, scale=0.05))


def x2_library(x, pre, w1, w2, shifted):
    """The boundary kernels in library calls, a yardstick only: the
    no-gain std-LN in torch ops, bf16 ``torch.matmul`` and ``relu``."""
    def ln(v):
        c = v - v.mean(dim=-1, keepdim=True)
        var = (c * c).sum(dim=-1, keepdim=True) / (v.shape[-1] - 1)
        return (c / (torch.sqrt(torch.clamp(var, min=1e-24)) + 1e-6)).to(
            torch.bfloat16)

    if shifted:
        out = x + torch.matmul(torch.relu(pre), w2)
        return out, torch.matmul(ln(out.float()), w1)
    return x + torch.matmul(torch.relu(torch.matmul(ln(x.float()), w1)), w2)


def x3_work(b, l, d, h, mode) -> tuple:
    """(operations, bytes) of one X3 call: the QKV and out-projection
    products, and q . k^T and P . v unless the mode drops them; x, the key
    mask and the fp32 parameters read once, y written."""
    flops = 2 * b * l * d * 3 * d + 2 * b * l * d * d
    if mode != "frame":
        flops += 2 * b * l * l * d                    # q . k^T, all heads
    if mode not in ("frame", "no_pv"):
        flops += 2 * b * l * l * d                    # P . v
    moved = 2 * (2 * b * l * d) + b * l + 4 * (4 * d * d + 6 * d)
    return flops, moved


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    from allrank_tpu_torch.ops import _build
    from allrank_tpu_torch.ops.approx_pos import (
        approx_pos_bwd,
        approx_pos_bwd_plain,
        approx_pos_fwd,
        approx_pos_fwd_plain,
    )
    from allrank_tpu_torch.ops.attention_block import (
        attention_sublayer_bwd,
        attention_sublayer_bwd_plain,
        attention_sublayer_fwd,
        attention_sublayer_fwd_plain,
    )
    from allrank_tpu_torch.ops.attention_block import route as b1_route
    from allrank_tpu_torch.ops.attention_fused import ROUTES as B45_ROUTES
    from allrank_tpu_torch.ops.attention_fused import route as b45_route
    from allrank_tpu_torch.ops.attention_fused import (
        attention_fused_bwd,
        attention_fused_bwd_plain,
        attention_fused_fwd,
        attention_fused_fwd_plain,
    )
    from allrank_tpu_torch.ops.attention_tiled import (
        tiled_attention_bwd,
        tiled_attention_bwd_plain,
        tiled_attention_fwd,
        tiled_attention_fwd_plain,
    )
    from allrank_tpu_torch.ops.ffn_block import (
        ffn_sublayer_bwd,
        ffn_sublayer_bwd_plain,
        ffn_sublayer_fwd,
        ffn_sublayer_fwd_plain,
    )
    from allrank_tpu_torch.ops.lambda_pairs import (
        SCHEMES,
        lambda_pairs_bwd,
        lambda_pairs_bwd_plain,
        lambda_pairs_fwd,
        lambda_pairs_fwd_plain,
    )
    from allrank_tpu_torch.ops.lambda_tiled import (
        lambda_tiled_bwd,
        lambda_tiled_bwd_plain,
        lambda_tiled_fwd,
        lambda_tiled_fwd_plain,
    )
    from allrank_tpu_torch.ops.neuralsort import (
        soft_sort_bwd,
        soft_sort_bwd_plain,
        soft_sort_fwd,
        soft_sort_fwd_plain,
    )
    from allrank_tpu_torch.ops.sinkhorn import (
        sinkhorn_bwd,
        sinkhorn_bwd_plain,
        sinkhorn_fwd,
        sinkhorn_fwd_plain,
    )
    from allrank_tpu_torch.serve_http import SlateScoringService, run_server
    from allrank_tpu_torch.serving import make_ranker, make_scorer
    from allrank_tpu_torch.tools.time_sublayers import b1_library, b2_library

    from allrank_tpu_torch.ops.attention_block import ROUTES as B1_ROUTES
    from allrank_tpu_torch.ops.ffn_block import ROUTES as B2_ROUTES
    from allrank_tpu_torch.ops.ffn_block import route as b2_route

    def reset_routes():
        """B1's and B2's launches by route back to 0."""
        for k in (attention_sublayer_fwd, attention_sublayer_bwd):
            k.route_launches = dict.fromkeys(B1_ROUTES, 0)
        for k in (ffn_sublayer_fwd, ffn_sublayer_bwd):
            k.route_launches = dict.fromkeys(B2_ROUTES, 0)

    def b1_routes():
        """B1's launches by route, forward then backward."""
        return (dict(attention_sublayer_fwd.route_launches),
                dict(attention_sublayer_bwd.route_launches))

    def b2_routes():
        """B2's launches by route, forward then backward."""
        return (dict(ffn_sublayer_fwd.route_launches),
                dict(ffn_sublayer_bwd.route_launches))

    dev = torch.device("cuda", 0)
    name_power = card()
    tag = f"[{name_power}]"
    device_kind = torch.cuda.get_device_name(0)

    # -- 1: card, versions, build --------------------------------------------
    print(f"card: {name_power}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    sources = ["attention_block", "attention_block_mma", "ffn_block",
               "ffn_block_mma", "lambda_pairs", "sinkhorn", "neuralsort",
               "approx_pos", "lambda_tiled", "attention_fused",
               "attention_tiled", "q8_dense", "encoder_block",
               "boundary_shift", "attention_variants", "neuralsort_layout"]
    _build.build(sources)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, the sixteen "
          f"sources in parallel)")
    for src in sources:
        with open(_build.log_path(src)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")
    # B4's and B5's kernels, bf16 and (3xTF32) fp32, and all of B1's and
    # B2's tensor-core routes run on the tensor cores: each holds HMMA, and
    # the two attention sources hold no other kernel (no SIMT one is left)
    for src, marker in (("attention_tiled", "tiled_"),
                        ("attention_fused", "fused_")):
        hmma = hmma_counts(_build.library_path(src), "")
        tf32 = hmma_counts(_build.library_path(src), "", TF32_HMMA)
        for kname, n in sorted(hmma.items()):
            print(f"  {src}: {n} HMMA, {tf32[kname]} of them TF32, in "
                  f"{kname}")
        bf16 = [k for k in hmma if "_mma_kernel" in k and marker in k]
        assert len(bf16) == 18 and all(hmma[k] > 0 for k in bf16), hmma
        # every tensor-core product of the fp32 kernels is a TF32 one
        f32 = [k for k in hmma if "_tf32x3_kernel" in k and marker in k]
        assert len(f32) == ATTN_F32_KERNELS and all(
            0 < tf32[k] == hmma[k] for k in f32), (hmma, tf32)
        assert len(hmma) == 18 + ATTN_F32_KERNELS, sorted(hmma)
        print(f"HMMA: all 18 bf16 {marker} kernels of {src} hold HMMA and "
              f"all {ATTN_F32_KERNELS} fp32 (3xTF32) ones TF32 HMMA only "
              f"(forward, dK/dV, dQ at padded d_k 32, 64, 128, aligned or "
              f"not); no other kernel")
    for src, marker, n_mma, what in (
            ("attention_block_mma", "b1_", B1_MMA_KERNELS,
             "attention + out-projection, dQ, dK/dV at padded d_k 32, 64, "
             "128, aligned or not; LN + QKV, rows, dn + LN backward, A^T B"),
            ("ffn_block_mma", "b2_", B2_MMA_KERNELS,
             "forward and backward rows at d <= 128 and d > 128, A^T B")):
        hmma = hmma_counts(_build.library_path(src), marker)
        for kname, n in sorted(hmma.items()):
            print(f"  {src}: {n} HMMA in {kname}")
        mma_kernels = [k for k in hmma if "_mma_kernel" in k]
        assert len(mma_kernels) == n_mma and all(hmma[k] > 0
                                                 for k in mma_kernels), hmma
        simt = {k: n for k, n in hmma.items() if k not in mma_kernels}
        print(f"HMMA: all {len(mma_kernels)} tensor-core {marker} kernels "
              f"of {src} ({what}) hold HMMA; the others "
              f"{sorted(simt.values())}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1234)
    errs = {}

    # -- 2: B1 against its plain version --------------------------------------
    cases = [(B, L, d, h) for d, h in PAPER_WIDTHS]
    cases += [(3, 1, 128, 4), (2, 1024, 144, 2), (5, 70, 256, 1)]
    for b, l, d, h in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = attn_inputs(gen, b, l, d, dtype, dev)
            err = check_kernel("attention_sublayer_fwd",
                               attention_sublayer_fwd,
                               attention_sublayer_fwd_plain, args + [h], {},
                               dtype)
            errs[("attn", b, l, d, dtype)] = err
            print(f"B1 vs plain B={b} L={l} d={d} h={h} {dtype} "
                  f"({b1_route(dtype, d, h)}): max_abs_err {err:.3e} (tol "
                  f"{KERNEL_TOL[dtype]})")
    # the bf16 tensor-core route at each head-width class, rows aligned and
    # not, L from 1 to B1's longest; every batch holds a fully padded slate.
    # These cases draw from a generator of their own, as phase 7's do, so
    # that every other phase's inputs stay as they were before them
    gen_mma = torch.Generator().manual_seed(1111)
    for d, h in B1_MMA_WIDTHS:
        assert b1_route(torch.bfloat16, d, h) == "mma", (d, h)
        worst = 0.0
        for l in (1, 65, 240, 1024):
            b = 2 if l == 1024 else 3
            args = attn_inputs(gen_mma, b, l, d, torch.bfloat16, dev)
            before = attention_sublayer_fwd.route_launches["mma"]
            err = check_kernel("attention_sublayer_fwd",
                               attention_sublayer_fwd,
                               attention_sublayer_fwd_plain, args + [h], {},
                               torch.bfloat16)
            assert attention_sublayer_fwd.route_launches["mma"] == before + 1
            worst = max(worst, err)
        print(f"B1 (mma) vs plain d={d} h={h} (d_k {d // h}) bf16 at L in "
              f"(1, 65, 240, 1024): max_abs_err {worst:.3e} (tol "
              f"{KERNEL_TOL[torch.bfloat16]})")
    print("phase 2 ok: attention sublayer kernel matches its plain version")

    # -- 3: B2 against its plain version --------------------------------------
    cases = [(B, L, 128, 512), (B, L, 144, 512), (B, L, 96, 384),
             (B, L, 128, 384), (3, 1, 128, 512), (2, 1024, 256, 1024)]
    for b, l, d, d_ff in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = ffn_inputs(gen, b, l, d, d_ff, dtype, dev)
            err = check_kernel("ffn_sublayer_fwd", ffn_sublayer_fwd,
                               ffn_sublayer_fwd_plain, args, {}, dtype)
            errs[("ffn", b, l, d, d_ff, dtype)] = err
            print(f"B2 vs plain B={b} L={l} d={d} d_ff={d_ff} {dtype} "
                  f"({b2_route(dtype, d, d_ff)}): max_abs_err {err:.3e} (tol "
                  f"{KERNEL_TOL[dtype]})")
    # the bf16 tensor-core route at each width class and L, from a generator
    # of its own (as B1's), so that every other phase's inputs stay as they
    # were before them
    gen_b2 = torch.Generator().manual_seed(2222)
    for d, d_ff in B2_MMA_WIDTHS:
        assert b2_route(torch.bfloat16, d, d_ff) == "mma", (d, d_ff)
        worst = 0.0
        for l in (1, 65, 240, 1024):
            b = 2 if l == 1024 else 3
            args = ffn_inputs(gen_b2, b, l, d, d_ff, torch.bfloat16, dev)
            before = ffn_sublayer_fwd.route_launches["mma"]
            err = check_kernel("ffn_sublayer_fwd", ffn_sublayer_fwd,
                               ffn_sublayer_fwd_plain, args, {},
                               torch.bfloat16)
            assert ffn_sublayer_fwd.route_launches["mma"] == before + 1
            worst = max(worst, err)
        print(f"B2 (mma) vs plain d={d} d_ff={d_ff} bf16 at L in (1, 65, 240, "
              f"1024): max_abs_err {worst:.3e} (tol "
              f"{KERNEL_TOL[torch.bfloat16]})")
    print("phase 3 ok: FFN sublayer kernel matches its plain version")

    # -- 4: the flagship scorer and ranker -------------------------------------
    gpu_model = flagship_model(dev)
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(B, L, N_FEATURES).astype(np.float32)
    lengths = rng.randint(1, L + 1, size=B)
    lengths[5] = 0
    lengths[7] = L
    pad = np.arange(L)[None, :] >= lengths[:, None]
    scorer32 = make_scorer(gpu_model, "float32")
    scorer16 = make_scorer(gpu_model, "bfloat16")
    for scorer, label, way in ((scorer32, "fp32", "simt"),
                               (scorer16, "bf16", "mma")):
        scorer(x, lengths)  # first call: loads the kernels
        attention_sublayer_fwd.launches = ffn_sublayer_fwd.launches = 0
        reset_routes()
        s = scorer(x, lengths)
        torch.cuda.synchronize()
        counts = (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches)
        assert counts == (4, 4), f"{label} scorer launches {counts} != (4, 4)"
        assert attention_sublayer_fwd.route_launches == {
            **dict.fromkeys(B1_ROUTES, 0), way: 4}, (
            label, attention_sublayer_fwd.route_launches)
        assert ffn_sublayer_fwd.route_launches == {
            **dict.fromkeys(B2_ROUTES, 0), way: 4}, (
            label, ffn_sublayer_fwd.route_launches)
    s32 = scorer32(x, lengths).cpu().numpy()
    s16 = scorer16(x, lengths).cpu().numpy()
    ref = make_scorer(cpu_model, "float32", device="cpu")(x, lengths).numpy()
    for s in (s32, s16):
        assert s.dtype == np.float32 and s.shape == (B, L)
        assert not np.isnan(s).any(), "NaN in scores"
        assert np.isneginf(s[pad]).all(), "padded positions must be -inf"
        assert np.isfinite(s[~pad]).all(), "non-finite score of a document"
    err32 = float(np.abs(s32[~pad] - ref[~pad]).max())
    assert err32 <= SCORE_TOL, f"GPU vs CPU scores: {err32} > {SCORE_TOL}"
    scale = float(np.abs(s32[~pad]).max())
    err16 = float(np.abs(s16[~pad] - s32[~pad]).max())
    assert err16 <= BF16_SCORE_TOL * scale, (
        f"bf16 vs fp32 scores: {err16} > {BF16_SCORE_TOL} * {scale}")
    order = make_ranker(gpu_model, "float32")(x, lengths).cpu().numpy()
    cpu_order = np.argsort(-ref, axis=-1, kind="stable")
    n_tie_swaps = 0
    for i in range(B):
        n = lengths[i]
        ranked = ref[i][order[i][:n]]
        # descending by the CPU scores, except inside ties within tolerance
        assert (np.diff(ranked) <= 2 * SCORE_TOL).all(), f"slate {i} order"
        assert sorted(order[i][n:]) == list(range(n, L)), "padding last"
        n_tie_swaps += int((order[i][:n] != cpu_order[i][:n]).sum())
    print(f"scorer fp32 GPU vs CPU plain: max_abs_err {err32:.3e} "
          f"(tol {SCORE_TOL}); bf16 vs fp32: {err16:.3e} (tol "
          f"{BF16_SCORE_TOL} x max|score| {scale:.3f}); ranker order equal "
          f"to the CPU's but for {n_tie_swaps} positions inside ties")
    print("phase 4 ok: flagship scorer and ranker on the GPU match the CPU")

    # -- 5: the service, the main path ------------------------------------------
    service = SlateScoringService(gpu_model, L, N_FEATURES, batch_size=64,
                                  max_wait_ms=5, compute_dtype="float32",
                                  batch_buckets=(1, 8, 64))
    server = run_server(service, 0, host="127.0.0.1")
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        slates = [rng.randn(n, N_FEATURES).astype(np.float32)
                  for n in (240, 1, 17, 64, 128, 199, 240, 5, 96, 233, 2,
                            150)]
        waves_before = service.stats()["waves_total"]
        attention_sublayer_fwd.launches = ffn_sublayer_fwd.launches = 0
        reset_routes()
        with concurrent.futures.ThreadPoolExecutor(len(slates)) as pool:
            futs = [pool.submit(post, url, s, i % 2 == 1)
                    for i, s in enumerate(slates)]
            answers = [f.result(timeout=120) for f in futs]
        main_launches = {"attention_sublayer_fwd":
                         attention_sublayer_fwd.launches,
                         "ffn_sublayer_fwd": ffn_sublayer_fwd.launches}
        # an fp32 service: B1 and B2 on their SIMT routes only
        assert b1_routes()[0] == {**dict.fromkeys(B1_ROUTES, 0),
                                  "simt": main_launches[
                                      "attention_sublayer_fwd"]}, b1_routes()
        assert b2_routes()[0] == {**dict.fromkeys(B2_ROUTES, 0),
                                  "simt": main_launches[
                                      "ffn_sublayer_fwd"]}, b2_routes()
        with urllib.request.urlopen(url + "/statz", timeout=30) as r:
            stats = json.loads(r.read())
        waves = stats["waves_total"] - waves_before
        assert waves >= 1 and all(
            v == 4 * waves for v in main_launches.values()), (
            f"launches {main_launches} != 4 x {waves} waves")
        assert stats["requests_total"] == len(slates), stats
        assert sum(stats["waves_by_bucket"].values()) == stats["waves_total"]
        err_service = 0.0
        for s, got in zip(slates, answers):
            xb = np.zeros((1, L, N_FEATURES), dtype=np.float32)
            xb[0, : len(s)] = s
            direct = scorer32(xb, [len(s)]).cpu().numpy()[0, : len(s)]
            assert got.shape == (len(s),) and np.isfinite(got).all()
            np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-4)
            err_service = max(err_service,
                              float(np.abs(got - direct).max()))
        print(f"service: {len(slates)} concurrent requests (JSON and .npy) "
              f"in {waves} waves {stats['waves_by_bucket']}, max_abs_err vs "
              f"direct scorer {err_service:.3e}; launches {main_launches}")
        one = rng.randn(L, N_FEATURES).astype(np.float32)
        lat = []
        for i in range(40):
            t = time.perf_counter()
            post(url, one, binary=True)
            if i >= 5:
                lat.append((time.perf_counter() - t) * 1e3)
        service_p50 = statistics.median(lat)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    server_thread.join(timeout=10)
    print("phase 5 ok: service answers on the GPU and matches the scorer")

    # -- 6: times ------------------------------------------------------------
    d, h, d_ff = 128, 4, 512
    timed = {}
    for kernel_name in ("attention_sublayer_fwd", "ffn_sublayer_fwd"):
        for dtype in (torch.float32, torch.bfloat16):
            if kernel_name == "attention_sublayer_fwd":
                args = attn_inputs(gen, B, L, d, dtype, dev)
                xx, mask, g, bb, wqkv, bqkv, wout, bout = args
                lib_args = [xx, torch.zeros(B, 1, 1, L, dtype=dtype,
                                            device=dev).masked_fill(
                    mask[:, None, None, :], -1e9), g.to(dtype), bb.to(dtype),
                    wqkv.to(dtype), bqkv.to(dtype), wout.to(dtype),
                    bout.to(dtype), h]
                fns = (lambda: attention_sublayer_fwd(*args, h),
                       lambda: attention_sublayer_fwd_plain(*args, h),
                       lambda: b1_library(*lib_args))
                flops = (2 * B * L * d * 3 * d + 2 * 2 * B * h * L * L
                         * (d // h) + 2 * B * L * d * d)
                moved = 2 * nbytes(xx) + nbytes(*args[1:])
                err = errs[("attn", B, L, d, dtype)]
            else:
                args = ffn_inputs(gen, B, L, d, d_ff, dtype, dev)
                lib_args = [args[0]] + [p.to(dtype) for p in args[1:]]
                fns = (lambda: ffn_sublayer_fwd(*args),
                       lambda: ffn_sublayer_fwd_plain(*args),
                       lambda: b2_library(*lib_args))
                flops = 2 * 2 * B * L * d * d_ff
                moved = 2 * nbytes(args[0]) + nbytes(*args[1:])
                err = errs[("ffn", B, L, d, d_ff, dtype)]
            ms, plain_ms, lib_ms = (median_ms(fn) for fn in fns)
            dev_ms, lib_dev_ms = graph_ms(fns[0]), graph_ms(fns[2])
            bound_ms, bound_by = bound(flops, moved, dtype)
            way = (b1_route(dtype, d, h) if kernel_name.startswith("attention")
                   else b2_route(dtype, d, d_ff))
            row, sfx = timing_row(timed, kernel_name, dtype, way)
            row.update({f"max_abs_err{sfx}": err, f"ms{sfx}": ms,
                        f"device_ms{sfx}": dev_ms,
                        f"plain_ms{sfx}": plain_ms,
                        f"bound_ms{sfx}": bound_ms,
                        f"bound_by{sfx}": bound_by,
                        f"library_ms{sfx}": lib_ms,
                        f"library_device_ms{sfx}": lib_dev_ms,
                        f"gflop{sfx}": flops / 1e9,
                        f"mbytes{sfx}": moved / 1e6})
            print(f"time {row['name']} {dtype} B={B} L={L} d={d}: kernel "
                  f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} "
                  f"ms, library {lib_ms:.4f} ms (device {lib_dev_ms:.4f}), "
                  f"bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB) {tag}")
    xd = torch.as_tensor(x, device=dev)
    ld = torch.as_tensor(lengths, device=dev)
    for scorer, label in ((scorer32, "float32"), (scorer16, "bfloat16")):
        ms = median_ms(lambda: scorer(xd, ld), iters=20)
        print(f"time scorer {label} B={B} L={L}: {ms:.4f} ms per call, "
              f"{B / ms * 1e3:.1f} slates/s (input on the device) {tag}")
        profile_calls(lambda: scorer(xd, ld), f"scorer {label} {tag}")
    print(f"time service p50 request latency, one {L}-doc .npy slate, "
          f"fp32, buckets (1, 8, 64): {service_p50:.3f} ms {tag}")

    # -- 7: B1 and B2 backward against their plain versions -----------------
    bwd_errs = {}
    cases = [(B, L, 128, 4, 512), (B, L, 96, 1, 384), (3, 1, 128, 4, 512),
             (2, 1024, 144, 2, 512), (5, 70, 256, 1, 1024),
             # the ordinal recipe's width and dropout: head width 72
             (B, L, 144, 2, 512)]
    for b, l, d, h, d_ff in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for p in ((0.0, 0.4) if (b, d) == (B, 144) else (0.0, 0.3)):
                seeds = (101, 202)
                a_args = attn_inputs(gen, b, l, d, dtype, dev)
                f_args = ffn_inputs(gen, b, l, d, d_ff, dtype, dev)
                dy = torch.randn(b, l, d, generator=gen).to(dtype).to(dev)
                y, saved = attention_sublayer_fwd(*a_args, h, p, p, seeds,
                                                  return_saved=True)
                torch.testing.assert_close(
                    y.float(), attention_sublayer_fwd_plain(
                        *a_args, h, p, p, seeds).float(), **KERNEL_TOL[dtype])
                z = ffn_sublayer_fwd(*f_args, p, p, seeds)
                torch.testing.assert_close(
                    z.float(), ffn_sublayer_fwd_plain(*f_args, p, p,
                                                      seeds).float(),
                    **KERNEL_TOL[dtype])
                worst, worst_rel = {}, {}
                kname = "attention_sublayer_bwd"
                got = attention_sublayer_bwd(*a_args, dy, h, p, p, seeds,
                                             saved=saved)
                ref = attention_sublayer_bwd_plain(*a_args, dy, h, p, p,
                                                   seeds)
                torch.cuda.synchronize()
                rtol, atol = BWD_TOL[dtype]
                for i, (g, r) in enumerate(zip(got, ref)):
                    assert torch.isfinite(g.float()).all(), (kname, i)
                    err, scale = rel_err(g, r)
                    assert err <= rtol * scale + atol, (
                        f"{kname} grad {i} B={b} L={l} d={d} {dtype} "
                        f"p={p}: {err} > {rtol} x {scale} + {atol}")
                    worst[kname] = max(worst.get(kname, 0.0), err)
                    worst_rel[kname] = max(worst_rel.get(kname, 0.0),
                                           err / (scale + atol))
                bwd_errs[(kname, b, l, d, dtype, p)] = worst[kname]
                # B2 under the C5 replay: its ReLU gates may flip
                kname = "ffn_sublayer_bwd"
                got = ffn_sublayer_bwd(*f_args, dy, p, p, seeds)
                torch.cuda.synchronize()
                worst[kname], worst_rel[kname], _, flips = b2_replay(
                    got, f_args, dy, p, seeds)
                bwd_errs[(kname, b, l, d, dtype, p)] = worst[kname]
                print(f"B1/B2 bwd vs plain B={b} L={l} d={d} h={h} "
                      f"d_ff={d_ff} {dtype} p={p} (B2 {flips} gate flips "
                      f"replayed): max_abs_err "
                      f"{worst['attention_sublayer_bwd']:.3e} / "
                      f"{worst['ffn_sublayer_bwd']:.3e}, worst relative to "
                      f"its tensor's max|ref| "
                      f"{worst_rel['attention_sublayer_bwd']:.2e} / "
                      f"{worst_rel['ffn_sublayer_bwd']:.2e} (tol "
                      f"{BWD_TOL[dtype][0]:g})")
    # the bf16 tensor-core route at each head-width class and L, dropout 0
    # and 0.3; then qkv off a 16-byte boundary at aligned head widths
    mma_bwd_worst = 0.0
    for d, h in B1_MMA_WIDTHS:
        for l in (1, 65, 240, 1024):
            for p in (0.0, 0.3):
                _, share = b1_mma_case(gen_mma, 2 if l == 1024 else 3, l, d,
                                       h, p, dev)
                mma_bwd_worst = max(mma_bwd_worst, share)
        print(f"B1 (mma) fwd and bwd vs plain d={d} h={h} (d_k {d // h}) "
              f"bf16, L in (1, 65, 240, 1024), p in (0, 0.3): ok, a second "
              f"backward bit for bit")
    for d, h in ((128, 4), (96, 2), (144, 2)):
        for p in (0.0, 0.3):
            _, share = b1_mma_case(gen_mma, 3, 65, d, h, p, dev, offset=1)
            mma_bwd_worst = max(mma_bwd_worst, share)
    print(f"B1 (mma) backward with qkv 2 bytes off a 16-byte boundary at "
          f"d_k 32, 48, 72: ok; worst gradient error of all mma cases "
          f"{mma_bwd_worst:.2f} of its tolerance")
    # B2's bf16 tensor-core route at each width class and L, dropout 0 and
    # 0.3, with the C5 replay; then x and dy off a 16-byte boundary
    b2_bwd_worst, b2_flips = 0.0, 0
    for d, d_ff in B2_MMA_WIDTHS:
        for l in (1, 65, 240, 1024):
            for p in (0.0, 0.3):
                _, share, flips = b2_mma_case(gen_b2, 2 if l == 1024 else 3,
                                              l, d, d_ff, p, dev)
                b2_bwd_worst = max(b2_bwd_worst, share)
                b2_flips += flips
        print(f"B2 (mma) fwd and bwd vs plain d={d} d_ff={d_ff} bf16, L in "
              f"(1, 65, 240, 1024), p in (0, 0.3): ok, a second backward bit "
              f"for bit")
    for d, d_ff in ((128, 512), (96, 384), (144, 512)):
        for p in (0.0, 0.3):
            _, share, flips = b2_mma_case(gen_b2, 3, 65, d, d_ff, p, dev,
                                          offset=1)
            b2_bwd_worst = max(b2_bwd_worst, share)
            b2_flips += flips
    # the edges: d < 16 and d_ff not a whole 64-unit chunk; d not a whole
    # 16-column step, d_ff 1000; one row of the widest
    for b, l, d, d_ff in ((3, 70, 8, 72), (2, 65, 100, 1000),
                          (1, 1, 256, 1000)):
        for p in (0.0, 0.3):
            _, share, flips = b2_mma_case(gen_b2, b, l, d, d_ff, p, dev)
            b2_bwd_worst = max(b2_bwd_worst, share)
            b2_flips += flips
    print(f"B2 (mma) with x and dy 2 bytes off a 16-byte boundary at d 128, "
          f"96, 144, and at the edges (d, d_ff) = (8, 72), (100, 1000), "
          f"(256, 1000) at L = 1: ok; worst gradient error of all mma cases "
          f"{b2_bwd_worst:.2f} of its tolerance, {b2_flips} gate flips "
          f"replayed in all")
    # ROADMAP Queue C5: on other inputs B2's backward leaves the tolerance
    # above where a hidden unit's pre-activation lies within rounding of 0
    # and its ReLU gate flips; replaying the flipped gates must explain it
    for d, d_ff, dtype, p, seeds_c5 in (
            (96, 384, torch.bfloat16, 0.3, range(12)),
            (144, 512, torch.float32, 0.3, (3,))):
        c5 = [b2_gate_flip_case(s, d, d_ff, dtype, p, dev)
              for s in seeds_c5]
        print(f"B2 bwd vs plain, C5 sweep B={B} L={L} d={d} d_ff={d_ff} "
              f"{dtype} p={p}, seeds {list(seeds_c5)}: error share of the "
              f"tolerance {[round(c[0], 3) for c in c5]}, gate flips "
              f"{[c[1] for c in c5]}, replayed {max(c[2] for c in c5):.3f} "
              f"(ok)")
    print("phase 7 ok: B1 and B2 backward kernels (and the forwards at "
          "p=0.3 and 0.4) match their plain versions, masks bit-identical")

    # -- 8: B3 against its plain version -----------------------------------------
    b3_errs = {"lambda_pairs_fwd": 0.0, "lambda_pairs_bwd": 0.0}
    for l in (1, 240, 384):
        ts = torch.randint(0, 5, (B, l), generator=gen).float()
        valid = (torch.rand(B, l, generator=gen) > 0.15).float()
        valid[-1] = 0.0  # a dummy slate
        yp = torch.randn(B, l, generator=gen) * valid
        g = (2.0 ** ts - 1.0) / 30.0
        pair_args = [t.to(dev) for t in (yp, ts, g, valid)]
        gout = torch.linspace(0.5, 1.5, B, device=dev)
        for scheme in SCHEMES:
            for k in (None, 10):
                kw = dict(scheme=scheme, k_eff=l if k is None else min(k, l),
                          sigma=1.0, mu=10.0, log_base="binary", eps=1e-10)
                loss, cnt = lambda_pairs_fwd(*pair_args, **kw)
                ref_loss, ref_cnt = lambda_pairs_fwd_plain(*pair_args, **kw)
                assert torch.equal(cnt, ref_cnt), (scheme, k, l)
                torch.testing.assert_close(loss, ref_loss, **B3_VALUE_TOL)
                dyp = lambda_pairs_bwd(*pair_args, gout, **kw)
                ref_dyp = lambda_pairs_bwd_plain(*pair_args, gout, **kw)
                torch.testing.assert_close(
                    dyp, ref_dyp, rtol=B3_GRAD_RTOL,
                    atol=B3_GRAD_ATOL * ref_dyp.abs().max().item() + 1e-6)
                assert not dyp[-1].any(), "the dummy slate took a gradient"
                if l == L and k is None and scheme == "ndcgLoss2PP_scheme":
                    b3_errs["lambda_pairs_fwd"] = rel_err(loss, ref_loss)[0]
                    b3_errs["lambda_pairs_bwd"] = rel_err(dyp, ref_dyp)[0]
    print(f"B3 vs plain, 8 schemes x k in (all, 10) x L in (1, 240, 384): "
          f"ok; at L={L} ndcgLoss2PP max_abs_err loss "
          f"{b3_errs['lambda_pairs_fwd']:.3e}, grad "
          f"{b3_errs['lambda_pairs_bwd']:.3e}")
    print("phase 8 ok: lambdaLoss pair-chain kernels match their plain "
          "versions")

    # -- 9: the train step, the second main path ---------------------------------
    train_kernels = (attention_sublayer_fwd, attention_sublayer_bwd,
                     ffn_sublayer_fwd, ffn_sublayer_bwd, lambda_pairs_fwd,
                     lambda_pairs_bwd)
    per_step = (4, 4, 4, 4, 1, 1)
    cfg, model = paper_setup(dev)
    assert cfg.model.transformer.dropout == 0.3
    assert cfg.training.compute_dtype == "bfloat16"
    xb, yb, ib = train_batch(dev)
    step = make_step(cfg, model, cfg.training.compute_dtype)
    for k in train_kernels:
        k.launches = 0
    reset_routes()
    losses = []
    for i in range(20):
        before = [k.launches for k in train_kernels]
        loss, n_real = step(xb, yb, ib)
        losses.append(loss.item())
        got = tuple(k.launches - n for k, n in zip(train_kernels, before))
        assert got == per_step, f"step {i} launches {got} != {per_step}"
        assert math.isfinite(losses[-1]), f"step {i} loss {losses[-1]}"
    train_launches = {k.__name__: k.launches for k in train_kernels}
    assert list(train_launches.values()) == [20 * n for n in per_step]
    # bf16 training: B1 and B2 on the tensor cores only, both ways
    b1_train_routes, b2_train_routes = b1_routes(), b2_routes()
    only_mma = {**dict.fromkeys(B1_ROUTES, 0), "mma": 20 * 4}
    assert b1_train_routes == (only_mma, only_mma), b1_train_routes
    assert b2_train_routes == (only_mma, only_mma), b2_train_routes
    assert n_real.item() == B
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    assert last < first, f"loss did not fall: {first} -> {last}"
    print(f"train step, paper config (dropout 0.3, bf16, Adam 1e-3, "
          f"lambdaLoss ndcgLoss2PP), B={B} L={L}, 40-doc padding tail: 20 "
          f"steps, loss mean of the first 5 {first:.3f}, of the last 5 "
          f"{last:.3f}; launches {train_launches}")

    cfg0, gpu_model = paper_setup(dev, dropout=0.0)
    reset_routes()
    gl, cl, step_err = step_one_gpu_vs_cpu(cfg0, gpu_model, (xb, yb, ib))
    # fp32 training: B1 and B2 on the SIMT kernels only
    b1_fp32_routes, b2_fp32_routes = b1_routes(), b2_routes()
    for routes in (b1_fp32_routes, b2_fp32_routes):
        assert (routes[0]["mma"] == routes[1]["mma"] == 0
                and routes[1]["simt"] == 4), routes
    print(f"train step 1 at dropout 0, fp32, GPU vs CPU plain: loss {gl:.6f} "
          f"vs {cl:.6f}; worst gradient error {step_err:.3f} of its "
          f"tolerance ({STEP_GRAD_TOL} x its tensor's max + 1e-5 x the "
          f"largest gradient)")
    print("phase 9 ok: the paper-config train step runs on the card through "
          "every kernel and learns; it matches the CPU at dropout 0")

    # -- 10: times of the train step and the new kernels ---------------------
    step_ms = {}
    for label, (cfg_t, model_t) in (
            ("bench.py config (flagship, dropout 0, bf16)",
             (cfg, flagship_model(dev))),
            ("paper config (dropout 0.3, bf16)", paper_setup(dev))):
        step = make_step(cfg_t, model_t, "bfloat16", optimizer_name="Adam",
                         lr=1e-3)
        reset_routes()
        step(xb, yb, ib)
        only_mma = {**dict.fromkeys(B1_ROUTES, 0), "mma": 4}
        assert b1_routes() == (only_mma, only_mma), (label, b1_routes())
        assert b2_routes() == (only_mma, only_mma), (label, b2_routes())
        ms = median_ms(lambda: step(xb, yb, ib), iters=20, warmup=3)
        step_ms[label] = ms
        print(f"time train step {label} B={B} L={L}: {ms:.4f} ms per step, "
              f"{B / ms * 1e3:.1f} slates/s {tag}")
        profile_calls(lambda: step(xb, yb, ib), f"train step {label} {tag}")

    d, h, d_ff = 128, 4, 512
    m_rows = B * L
    for kernel_name in ("attention_sublayer_bwd", "ffn_sublayer_bwd"):
        for dtype in (torch.float32, torch.bfloat16):
            esz = torch.tensor([], dtype=dtype).element_size()
            dy = torch.randn(B, L, d, generator=gen).to(dtype).to(dev)
            if kernel_name == "attention_sublayer_bwd":
                args = attn_inputs(gen, B, L, d, dtype, dev)
                _, saved = attention_sublayer_fwd(*args, h, return_saved=True)
                fns = (lambda: attention_sublayer_bwd(*args, dy, h,
                                                      saved=saved),
                       lambda: attention_sublayer_bwd_plain(*args, dy, h),
                       b1_library_bwd(args, dy, h))
                # each product once: dO, S, dP, ctx, dQ, dK, dV, dn, dWqkv,
                # dWout
                flops = 16 * m_rows * d * d + 12 * B * h * L * L * (d // h)
                params = nbytes(*args[2:])
                moved = (nbytes(args[0], args[1], dy, *saved) + params
                         + m_rows * d * esz + params)
            else:
                args = ffn_inputs(gen, B, L, d, d_ff, dtype, dev)
                fns = (lambda: ffn_sublayer_bwd(*args, dy),
                       lambda: ffn_sublayer_bwd_plain(*args, dy),
                       b2_library_bwd(args, dy))
                # pre, dh, dn, dW1, dW2
                flops = 10 * m_rows * d * d_ff
                params = nbytes(*args[1:])
                moved = nbytes(args[0], dy) + params + m_rows * d * esz + params
            ms, plain_ms, lib_ms = (median_ms(fn, iters=20) for fn in fns)
            dev_ms = graph_ms(fns[0])
            # autograd's engine refuses CUDA-graph capture: the library
            # backward's device time is the sum of its kernels in a trace
            # (not measured where every trace lost device events)
            try:
                lib_dev_ms = sum(kernel_ms(fns[2]).values())
            except IncompleteTrace as err:
                print(f"library backward: {err} {tag}")
                lib_dev_ms = None
            bound_ms, bound_by = bound(flops, moved, dtype)
            way = (b1_route(dtype, d, h) if kernel_name.startswith("attention")
                   else b2_route(dtype, d, d_ff))
            row, sfx = timing_row(timed, kernel_name, dtype, way)
            row.update({f"max_abs_err{sfx}": bwd_errs[(kernel_name, B, L, d,
                                                       dtype, 0.0)],
                        f"ms{sfx}": ms, f"device_ms{sfx}": dev_ms,
                        f"plain_ms{sfx}": plain_ms,
                        f"bound_ms{sfx}": bound_ms, f"bound_by{sfx}": bound_by,
                        f"library_ms{sfx}": lib_ms,
                        f"library_device_ms{sfx}": lib_dev_ms,
                        f"gflop{sfx}": flops / 1e9,
                        f"mbytes{sfx}": moved / 1e6})
            lib_txt = ("not measured" if lib_dev_ms is None
                       else f"{lib_dev_ms:.4f}")
            print(f"time {row['name']} {dtype} B={B} L={L} d={d}: kernel "
                  f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} "
                  f"ms, library (autograd) {lib_ms:.4f} ms (device, its "
                  f"kernels' sum: {lib_txt}), bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
                  f"{moved / 1e6:.2f} MB) {tag}")
    rows = list(timed.values())

    # B3 at the train step's shape: the top-k block is all L=240 documents
    ts = torch.randint(0, 5, (B, L), generator=gen).float()
    valid = torch.ones(B, L)
    valid[:, -40:] = 0.0
    pair_args = [t.to(dev) for t in (torch.randn(B, L, generator=gen) * valid,
                                     ts, (2.0 ** ts - 1.0) / 30.0, valid)]
    kw = dict(scheme="ndcgLoss2PP_scheme", k_eff=L, sigma=1.0, mu=10.0,
              log_base="binary", eps=1e-10)
    gout = torch.ones(B, device=dev)
    lib = chain_library(pair_args, kw)
    # per selected pair 28 operations forward, 36 backward: the function
    # needs each c_ij once; the kernel's second evaluation (c_ji, so that no
    # atomics are needed) is a cost of its design and not part of the bound
    rows.append(short_kernel_row(
        "lambda_pairs_fwd", lambda: lambda_pairs_fwd(*pair_args, **kw),
        lambda: lambda_pairs_fwd_plain(*pair_args, **kw), lib[0],
        chain_work(pair_args, kw, 28, False), b3_errs["lambda_pairs_fwd"],
        f"B={B} k={L} (200 valid)", tag))
    rows.append(short_kernel_row(
        "lambda_pairs_bwd", lambda: lambda_pairs_bwd(*pair_args, gout, **kw),
        lambda: lambda_pairs_bwd_plain(*pair_args, gout, **kw), lib[1],
        chain_work(pair_args, kw, 36, True), b3_errs["lambda_pairs_bwd"],
        f"B={B} k={L} (200 valid)", tag))

    # -- 11: B8 against its plain version -------------------------------------
    T = SINKHORN_ITERS
    soft_errs = {}
    for n in (B, 2048):
        for transpose in (False, True):
            sc, pad, vec, dout = soft_sort_inputs(gen, n, L, dev)
            before = (soft_sort_fwd.launches, soft_sort_bwd.launches)
            out, a_hist, b_hist = soft_sort_fwd(sc, pad, vec, 1.0, T,
                                                transpose)
            ds = soft_sort_bwd(sc, pad, vec, a_hist, b_hist, dout, 1.0, T,
                               transpose)
            torch.cuda.synchronize()
            assert (soft_sort_fwd.launches, soft_sort_bwd.launches) == (
                before[0] + 1, before[1] + 1), "B8 did not launch"
            ref, ref_a, ref_b = soft_sort_fwd_plain(sc, pad, vec, 1.0, T,
                                                    transpose)
            assert torch.isfinite(out).all() and torch.isfinite(a_hist).all()
            torch.testing.assert_close(out, ref, **SOFT_TOL)
            assert not out[-1].any(), "the fully padded slate's output"
            # the records against the plain version's: the scaling pair's
            # gauge (a -> c a, b -> b / c) is not contracted, so rounding
            # drifts along it; the output above is free of it
            torch.testing.assert_close(a_hist, ref_a, rtol=1e-3, atol=1e-6)
            torch.testing.assert_close(b_hist, ref_b, rtol=1e-3, atol=1e-6)
            ref_ds = soft_sort_bwd_plain(sc, pad, vec, a_hist, b_hist, dout,
                                         1.0, T, transpose)
            g_err = assert_grad_close(ds, ref_ds, f"B8 ds N={n}")
            assert not ds[pad > 0.5].any(), "a padded document's gradient"
            f_err = rel_err(out, ref)[0]
            if n == B and not transpose:
                soft_errs = {"soft_sort_fwd": f_err, "soft_sort_bwd": g_err}
            print(f"B8 vs plain N={n} L={L} transpose={transpose}: "
                  f"max_abs_err out {f_err:.3e} (tol {SOFT_TOL}), ds "
                  f"{g_err:.3e} of max|ref| {rel_err(ds, ref_ds)[1]:.3e} "
                  f"(tol {SOFT_GRAD_TOL[0]:g} x)")
            del ref, ref_a, ref_b, ref_ds
    print("phase 11 ok: fused soft-sort kernels match their plain versions")

    # -- 12: B7 against its plain version -------------------------------------
    n7, l7 = 8, 640
    m0 = premasked_matrices(gen, n7, l7, dev)
    dp = torch.randn(n7, l7, l7, generator=gen).to(dev)
    before = (sinkhorn_fwd.launches, sinkhorn_bwd.launches)
    p_out, a_hist, b_hist = sinkhorn_fwd(m0, T)
    dm0 = sinkhorn_bwd(m0, a_hist, b_hist, dp, T)
    torch.cuda.synchronize()
    assert (sinkhorn_fwd.launches, sinkhorn_bwd.launches) == (
        before[0] + 1, before[1] + 1), "B7 did not launch"
    ref_p, ref_a, ref_b = sinkhorn_fwd_plain(m0, T)
    assert torch.isfinite(p_out).all()
    torch.testing.assert_close(p_out, ref_p, **SOFT_TOL)
    torch.testing.assert_close(a_hist, ref_a, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(b_hist, ref_b, rtol=1e-3, atol=1e-6)
    sink_errs = {
        "sinkhorn_fwd": rel_err(p_out, ref_p)[0],
        "sinkhorn_bwd": assert_grad_close(
            dm0, sinkhorn_bwd_plain(m0, a_hist, b_hist, dp, T), "B7 dM0")}
    print(f"B7 vs plain N={n7} L={l7}: max_abs_err P "
          f"{sink_errs['sinkhorn_fwd']:.3e} (tol {SOFT_TOL}), dM0 "
          f"{sink_errs['sinkhorn_bwd']:.3e} (tol {SOFT_GRAD_TOL[0]:g} x "
          f"max|ref|)")
    print("phase 12 ok: Sinkhorn kernels match their plain versions")

    # -- 13: the train CLI, the third main path -------------------------------
    all_kernels = train_kernels + (soft_sort_fwd, soft_sort_bwd, sinkhorn_fwd,
                                   sinkhorn_bwd, approx_pos_fwd,
                                   approx_pos_bwd, lambda_tiled_fwd,
                                   lambda_tiled_bwd)

    def reset_counts():
        for k in all_kernels:
            k.launches = 0
        reset_routes()

    def counts():
        got = {k.__name__: k.launches for k in all_kernels}
        for k, by_route in zip(("attention_sublayer_fwd",
                                "attention_sublayer_bwd", "ffn_sublayer_fwd",
                                "ffn_sublayer_bwd"),
                               b1_routes() + b2_routes()):
            got.update({f"{k}[{way}]": n for way, n in by_route.items()})
        return got

    def expect(blocks, fwd, bwd, loss_kernel=None):
        """The launches of a run of ``fwd`` forward and ``bwd`` backward
        passes through ``blocks`` encoder blocks and one loss kernel; every
        recipe trains in bf16, so B1 and B2 take the tensor cores only."""
        want = dict.fromkeys(counts(), 0)
        for sub in ("attention_sublayer", "ffn_sublayer"):
            want[sub + "_fwd"] = want[sub + "_fwd[mma]"] = blocks * fwd
            want[sub + "_bwd"] = want[sub + "_bwd[mma]"] = blocks * bwd
        if loss_kernel:
            want[loss_kernel + "_fwd"] = fwd
            want[loss_kernel + "_bwd"] = bwd
        return want

    # removed after phase 26, or when the script ends, also by an
    # exception: the later CLI runs and the evaluate CLI read the same
    # dataset, and phase 26 evaluates this run's NeuralNDCG model.npz
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    work_dir = work.name
    t0 = time.perf_counter()
    written = write_cli_dataset(os.path.join(work_dir, "data"))
    print(f"cli dataset: {CLI_TRAIN_SLATES} train and {CLI_VAL_SLATES} "
          f"validation slates of 40-{L} documents x {N_FEATURES} "
          f"features written in {time.perf_counter() - t0:.1f} s")
    steps = CLI_TRAIN_SLATES // B          # train steps per epoch
    evals = steps + CLI_VAL_SLATES // B    # evaluation batches per epoch
    epochs = 2
    reset_counts()
    result, out_dir, losses, cli_seconds = run_cli(
        NEURAL_CONFIG, work_dir, "neuralndcg_atmax", epochs)
    neural_out_dir = out_dir  # its model.npz is evaluated in phase 26
    cli_launches = counts()
    check_cli_outputs(result, out_dir, losses, epochs,
                      ("ndcg_5", "ndcg_10", "ndcg_30", "ndcg_60"))
    expected = expect(2, epochs * (steps + evals), epochs * steps,
                      "soft_sort")
    assert cli_launches == expected, (cli_launches, expected)
    with open(os.path.join(out_dir, "training.log")) as f:
        cli_phases = re.findall(
            r"epoch (\d+) phases: train ([\d.]+)s, val eval ([\d.]+)s",
            f.read())
    print(f"train CLI, {NEURAL_CONFIG} (2 blocks of d=96, h=1, d_ff=384, "
          f"dropout 0.1, bf16, Adam 1e-3, neuralNDCG), B={B} L={L}: "
          f"{epochs} epochs of {steps} steps in {cli_seconds:.1f} s with "
          f"loading; train loss {losses['train']}, val loss "
          f"{losses['val']}, val ndcg_5 "
          f"{result['val_metrics']['ndcg_5']:.4f}; the CLI's own log, "
          f"(epoch, train s, val eval s): {cli_phases}; launches "
          f"{cli_launches} {tag}")

    reset_counts()
    result, out_dir, losses, seconds = run_cli(PAPER_CONFIG, work_dir,
                                               "ndcgloss2pp", 1)
    paper_launches = counts()
    check_cli_outputs(result, out_dir, losses, 1, ("ndcg_5", "ndcg_10"))
    expected = expect(4, steps + evals, steps, "lambda_pairs")
    assert paper_launches == expected, (paper_launches, expected)
    print(f"train CLI, {PAPER_CONFIG}: 1 epoch in {seconds:.1f} s with "
          f"loading; train loss {losses['train']}, val ndcg_5 "
          f"{result['val_metrics']['ndcg_5']:.4f}; launches "
          f"{paper_launches}")

    # the epoch's split, on the CLI's own data and batchers
    from allrank_tpu_torch.config import Config
    from allrank_tpu_torch.data.batching import (
        DevicePrefetcher,
        SlateBatcher,
    )
    from allrank_tpu_torch.data.dataset import SlateDataset
    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.training.train_utils import (
        compute_metrics,
        make_eval_fns,
    )

    ncfg = Config.from_json(NEURAL_CONFIG)
    train_ds = SlateDataset(*written["train"])
    val_ds = SlateDataset(*written["test"])
    train_batcher = SlateBatcher(train_ds, L, B, shuffle=True)
    val_batcher = SlateBatcher(val_ds, val_ds.longest_query_length, B)
    nmodel = LTRModel(make_model(ncfg.model, N_FEATURES),
                      torch.Generator().manual_seed(0), device=dev)
    nstep = make_step(ncfg, nmodel, ncfg.training.compute_dtype)
    loss_fn, needs_rng = get_loss(ncfg.loss.name)
    neval = make_eval_fns(nmodel, loss_fn, ncfg.loss.args, needs_rng,
                          ncfg.metrics, ncfg.training.compute_dtype)
    egen = torch.Generator().manual_seed(3)
    split = {}
    for rep in range(2):  # the first pass warms up
        t0 = time.perf_counter()
        for batch in DevicePrefetcher(train_batcher, device=dev):
            pass
        torch.cuda.synchronize()
        split["feed alone"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for batch in DevicePrefetcher(train_batcher, device=dev):
            nstep(*batch)
        torch.cuda.synchronize()
        split["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compute_metrics(neval, DevicePrefetcher(train_batcher, device=dev),
                        egen)
        compute_metrics(neval, DevicePrefetcher(val_batcher, device=dev),
                        egen)
        split["eval (train and validation sets)"] = time.perf_counter() - t0
    print(f"epoch split, NeuralNDCG recipe, {steps} steps and {evals} "
          f"evaluation batches of B={B}: "
          f"{ {k: round(v, 4) for k, v in split.items()} } s (the feed runs "
          f"inside the train and eval loops; alone it is the host's batch "
          f"assembly, pinning and copies) {tag}")

    # a NeuralNDCG step beyond the fused kernel's length: the materialised
    # chain through the Sinkhorn kernel
    rng7 = np.random.RandomState(7)
    x7 = rng7.randn(n7, l7, N_FEATURES).astype(np.float32)
    y7 = rng7.randint(0, 5, (n7, l7)).astype(np.float32)
    y7[:, -100:] = -1.0
    i7 = np.tile(np.arange(l7), (n7, 1))
    i7[:, -100:] = -1
    reset_counts()
    loss7, _ = nstep(x7, y7, i7)
    b7_launches = counts()
    assert math.isfinite(loss7.item()), loss7
    assert (b7_launches["sinkhorn_fwd"], b7_launches["sinkhorn_bwd"],
            b7_launches["soft_sort_fwd"]) == (1, 1, 0), b7_launches
    print(f"NeuralNDCG train step at B={n7} L={l7}: loss {loss7.item():.6f}, "
          f"launches {b7_launches}")

    # step 1 at dropout 0 in fp32: the card's kernels against the CPU
    ncfg0 = Config.from_json(NEURAL_CONFIG)
    ncfg0.model.transformer.dropout = 0.0
    gpu_model = LTRModel(make_model(ncfg0.model, N_FEATURES),
                         torch.Generator().manual_seed(0), device=dev)
    gl, cl, step_err = step_one_gpu_vs_cpu(ncfg0, gpu_model,
                                           [t[:8] for t in (xb, yb, ib)])
    print(f"NeuralNDCG train step 1 at dropout 0, fp32, B=8 L={L}, GPU vs "
          f"CPU plain: loss {gl:.6f} vs {cl:.6f}; worst gradient error "
          f"{step_err:.3f} of its tolerance")
    print("phase 13 ok: the train CLI runs both recipes on the card through "
          "every kernel; the long-slate step runs the Sinkhorn kernel")

    # -- 14: times of the new kernels and the NeuralNDCG step -----------------
    ms = median_ms(lambda: nstep(xb, yb, ib), iters=20, warmup=3)
    step_ms["NeuralNDCG recipe (dropout 0.1, bf16)"] = ms
    print(f"time train step NeuralNDCG recipe B={B} L={L}: {ms:.4f} ms per "
          f"step, {B / ms * 1e3:.1f} slates/s {tag}")
    profile_calls(lambda: nstep(xb, yb, ib),
                  f"train step NeuralNDCG recipe {tag}")

    sc, pad, vec, dout = soft_sort_inputs(gen, B, L, dev)
    _, a_hist, b_hist = soft_sort_fwd(sc, pad, vec, 1.0, T, False)
    lib = soft_sort_library(sc, pad, vec, False)
    m0 = premasked_matrices(gen, n7, l7, dev)
    p_out, a7, b7 = sinkhorn_fwd(m0, T)
    lib7 = sinkhorn_library(m0)
    hist_bytes = 2 * (T + 1) * 4  # both records, per slate and document
    for kernel_name, fns, lib_fn, flops, moved, shape in (
            # per slate: 2 T matvecs of 2 L^2, the NeuralSort chain (row
            # sums, logits, softmax: some 10 L^2) and the contraction (4 L^2)
            ("soft_sort_fwd",
             (lambda: soft_sort_fwd(sc, pad, vec, 1.0, T, False),
              lambda: soft_sort_fwd_plain(sc, pad, vec, 1.0, T, False)),
             lib[0], B * (4 * T + 14) * L * L,
             B * L * (3 * 4 + 4 + hist_bytes), f"N={B} L={L}"),
            # the reverse pass's 2 T matvecs, the two [L, T] . [T, L]
            # products (4 T L^2), the chain again and the softmax and
            # row-sum cotangents (some 31 L^2)
            ("soft_sort_bwd",
             (lambda: soft_sort_bwd(sc, pad, vec, a_hist, b_hist, dout, 1.0,
                                    T, False),
              lambda: soft_sort_bwd_plain(sc, pad, vec, a_hist, b_hist, dout,
                                          1.0, T, False)),
             lib[1], B * (8 * T + 31) * L * L,
             B * L * (4 * 4 + 4 + hist_bytes), f"N={B} L={L}"),
            ("sinkhorn_fwd",
             (lambda: sinkhorn_fwd(m0, T), lambda: sinkhorn_fwd_plain(m0, T)),
             lib7[0], n7 * (4 * T + 2) * l7 * l7,
             n7 * (2 * 4 * l7 * l7 + l7 * hist_bytes), f"N={n7} L={l7}"),
            ("sinkhorn_bwd",
             (lambda: sinkhorn_bwd(m0, a7, b7, dp, T),
              lambda: sinkhorn_bwd_plain(m0, a7, b7, dp, T)),
             lib7[1], n7 * (8 * T + 8) * l7 * l7,
             n7 * (3 * 4 * l7 * l7 + l7 * hist_bytes), f"N={n7} L={l7}")):
        ms, plain_ms, lib_ms = (median_ms(fn, iters=20)
                                for fn in fns + (lib_fn,))
        bound_ms, bound_by = bound(flops, moved, torch.float32)
        rows.append({"name": kernel_name, "route": "cuda",
                     "max_abs_err": {**soft_errs, **sink_errs}[kernel_name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms,
                     "gflop": flops / 1e9, "mbytes": moved / 1e6})
        print(f"time {kernel_name} float32 {shape}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library (torch-op chain, autograd) "
              f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
              f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.3f} MB) {tag}")

    # -- 15: B9 against its plain version ---------------------------------------
    eps = 1e-10
    b9_errs = {"approx_pos_fwd": 0.0, "approx_pos_bwd": 0.0}
    for n, l, scale in ((B, L, 1.0), (B, L, 1e4), (3, 1, 1.0), (5, 37, 1.0),
                        (2, 1308, 1.0), (2, 4096, 1.0)):
        sc = torch.randn(n, l, generator=gen) * scale
        sc[:, 1::5] = sc[:, 0::5][:, :sc[:, 1::5].shape[1]]  # tied scores
        lengths = torch.randint(1, l + 1, (n,), generator=gen)
        lengths[0] = l
        lengths[-1] = 0  # an empty slate
        valid = (torch.arange(l)[None, :] < lengths[:, None]).float()
        u = torch.randn(n, l, generator=gen)
        sc, valid, u = (t.to(dev) for t in (sc, valid, u))
        for alpha in (0.1, 1.0, 10.0):
            before = (approx_pos_fwd.launches, approx_pos_bwd.launches)
            pos = approx_pos_fwd(sc, valid, alpha, eps)
            ds = approx_pos_bwd(sc, valid, u, alpha, eps)
            torch.cuda.synchronize()
            assert (approx_pos_fwd.launches, approx_pos_bwd.launches) == (
                before[0] + 1, before[1] + 1), "B9 did not launch"
            ref = approx_pos_fwd_plain(sc, valid, alpha, eps)
            ref_ds = approx_pos_bwd_plain(sc, valid, u, alpha, eps)
            assert torch.isfinite(pos).all() and torch.isfinite(ds).all()
            torch.testing.assert_close(pos, ref, **B9_VALUE_TOL)
            g_err, g_scale = rel_err(ds, ref_ds)
            assert g_err <= B9_GRAD_TOL[0] * g_scale + B9_GRAD_TOL[1], (
                f"B9 ds N={n} L={l} alpha={alpha}: {g_err} of {g_scale}")
            assert not pos[valid < 0.5].any() and not ds[valid < 0.5].any()
            if scale == 1e4 and alpha == 10.0:
                # away from the tied columns nearly every t is 0 (below
                # eps: the clamp's branch) or 1: no gradient
                assert (ds[:, 2::5] == 0).float().mean() > 0.9
            if (n, l, scale, alpha) == (B, L, 1.0, 1.0):
                b9_errs = {"approx_pos_fwd": rel_err(pos, ref)[0],
                           "approx_pos_bwd": g_err}
            print(f"B9 vs plain N={n} L={l} scores x{scale:g} alpha={alpha}: "
                  f"max_abs_err pos {rel_err(pos, ref)[0]:.3e} (max "
                  f"{ref.max().item():.1f}; tol {B9_VALUE_TOL}), ds "
                  f"{g_err:.3e} of max|ref| {g_scale:.3e} (tol "
                  f"{B9_GRAD_TOL[0]:g} x)")
        del ref, ref_ds
    print("phase 15 ok: approxNDCG rank-sum kernels match their plain "
          "versions")

    # -- 16: B6 against its plain version and against B3 -----------------------
    def pair_inputs(b, k):
        ts = torch.randint(0, 5, (b, k), generator=gen).float()
        valid = (torch.rand(b, k, generator=gen) > 0.15).float()
        valid[-1] = 0.0  # a slate with no valid document
        yp = torch.randn(b, k, generator=gen) * valid
        return [t.to(dev) for t in (yp, ts, (2.0 ** ts - 1.0) / 30.0, valid)]

    def assert_chain_close(got, ref, what):
        (loss, cnt, dyp), (ref_loss, ref_cnt, ref_dyp) = got, ref
        assert torch.equal(cnt, ref_cnt), what
        torch.testing.assert_close(loss, ref_loss, **B3_VALUE_TOL)
        torch.testing.assert_close(
            dyp, ref_dyp, rtol=B3_GRAD_RTOL,
            atol=B3_GRAD_ATOL * ref_dyp.abs().max().item() + 1e-6)

    b6_errs = {}
    for b, k in ((B, 512), (LONG_B, LONG_L), (8, 1308), (2, 4096)):
        pair_args = pair_inputs(b, k)
        gout = torch.linspace(0.5, 1.5, b, device=dev)
        for scheme in SCHEMES:
            for log_base, k_eff in (("binary", k), ("natural", 3 * k // 4)):
                kw = dict(scheme=scheme, k_eff=k_eff, sigma=1.0, mu=10.0,
                          log_base=log_base, eps=eps)
                before = (lambda_tiled_fwd.launches,
                          lambda_tiled_bwd.launches)
                loss, cnt = lambda_tiled_fwd(*pair_args, **kw)
                dyp = lambda_tiled_bwd(*pair_args, gout, **kw)
                torch.cuda.synchronize()
                assert (lambda_tiled_fwd.launches,
                        lambda_tiled_bwd.launches) == (
                    before[0] + 1, before[1] + 1), "B6 did not launch"
                ref = (*lambda_tiled_fwd_plain(*pair_args, **kw),
                       lambda_tiled_bwd_plain(*pair_args, gout, **kw))
                assert_chain_close((loss, cnt, dyp), ref,
                                   (b, k, scheme, log_base, k_eff))
                assert not dyp[-1].any(), "the empty slate took a gradient"
                if k_eff < k:
                    assert not dyp[:, k_eff:].any()
                if scheme == "ndcgLoss2PP_scheme" and k_eff == k:
                    b6_errs[(b, k)] = (rel_err(loss, ref[0])[0],
                                       rel_err(dyp, ref[2])[0],
                                       ref[0].abs().max().item(),
                                       ref[2].abs().max().item())
                del ref
        e = b6_errs[(b, k)]
        print(f"B6 vs plain B={b} k={k}, 8 schemes x (binary, k_eff=k; "
              f"natural, k_eff=3k/4): ok, counts exact; ndcgLoss2PP "
              f"max_abs_err loss {e[0]:.3e} of {e[2]:.3e}, grad {e[1]:.3e} "
              f"of {e[3]:.3e}")
    pair_args = pair_inputs(B, 384)
    gout = torch.linspace(0.5, 1.5, B, device=dev)
    for scheme in SCHEMES:
        kw = dict(scheme=scheme, k_eff=384, sigma=1.0, mu=10.0,
                  log_base="binary", eps=eps)
        assert_chain_close(
            (*lambda_tiled_fwd(*pair_args, **kw),
             lambda_tiled_bwd(*pair_args, gout, **kw)),
            (*lambda_pairs_fwd(*pair_args, **kw),
             lambda_pairs_bwd(*pair_args, gout, **kw)), ("B6 vs B3", scheme))
    print(f"B6 vs B3 at B={B} k=384, 8 schemes: loss sums, counts and "
          f"gradients agree (tol {B3_VALUE_TOL}, grad rtol {B3_GRAD_RTOL})")
    print("phase 16 ok: row-tiled lambdaLoss kernels match their plain "
          "versions and the one-block kernels")

    # -- 17: the train CLI on the five other recipes ------------------------------
    recipe_launches = {}
    for rel_path, blocks, loss_kernel in OTHER_RECIPES:
        path = CONFIG_DIR + rel_path
        run_id = os.path.splitext(os.path.basename(path))[0]
        rcfg = Config.from_json(path)
        reset_counts()
        result, out_dir, losses, seconds = run_cli(path, work_dir, run_id, 1)
        recipe_launches[run_id] = counts()
        check_cli_outputs(result, out_dir, losses, 1,
                          [f"{m}_{at}" for m, ats in rcfg.metrics.items()
                           for at in ats])
        expected = expect(blocks, steps + evals, steps, loss_kernel)
        assert recipe_launches[run_id] == expected, (
            run_id, recipe_launches[run_id], expected)
        tower = (f"FC {rcfg.model.fc_model.sizes}" if not blocks else
                 f"{blocks} blocks of d={rcfg.model.fc_model.sizes[-1]}, "
                 f"h={rcfg.model.transformer.h}")
        print(f"train CLI, {path} ({tower}, d_output "
              f"{rcfg.model.post_model.d_output}, {rcfg.loss.name}): 1 epoch "
              f"of {steps} steps in {seconds:.1f} s with loading; train loss "
              f"{losses['train']}, val loss {losses['val']}, val ndcg_5 "
              f"{result['val_metrics']['ndcg_5']:.4f}; launches "
              f"{ {k: v for k, v in recipe_launches[run_id].items() if v} } "
              f"{tag}")
    print("phase 17 ok: all seven paper recipes train through the CLI on the "
          "card with exact launch counts")

    # -- 18: one train step of each other loss name ------------------------------
    for loss_name, loss_args in OTHER_LOSSES:
        head = "Sigmoid" if loss_name == "bce" else None
        step = make_step(cfg, flagship_model(dev, 0.1, head), "bfloat16",
                         loss=(loss_name, loss_args))
        reset_counts()
        loss, _ = step(xb, yb, ib)
        got = counts()
        assert got == expect(4, 1, 1), (loss_name, got)
        assert math.isfinite(loss.item()), (loss_name, loss.item())
        gl, cl, worst = step_one_gpu_vs_cpu(
            cfg, flagship_model(dev, 0.0, head), (xb, yb, ib),
            loss=(loss_name, loss_args))
        print(f"train step, flagship model, {loss_name} B={B} L={L}: bf16 "
              f"with dropout 0.1 loss {loss.item():.6f}; step 1 at dropout 0, "
              f"fp32, GPU vs CPU plain: loss {gl:.6f} vs {cl:.6f}, worst "
              f"gradient error {worst:.3f} of its tolerance")
    print("phase 18 ok: every loss name takes a train step on the card that "
          "matches the CPU")

    # -- 19: the long-slate lambdaLoss step ---------------------------------------
    lcfg, lmodel = paper_setup(dev)
    long_batch = train_batch(dev, seed=5, b=LONG_B, l=LONG_L, tail=100)
    lstep = make_step(lcfg, lmodel, lcfg.training.compute_dtype)
    long_kernels = (lambda_tiled_fwd, lambda_tiled_bwd, lambda_pairs_fwd,
                    lambda_pairs_bwd, attention_sublayer_fwd,
                    attention_sublayer_bwd, ffn_sublayer_fwd,
                    ffn_sublayer_bwd)
    reset_counts()
    losses = []
    for i in range(10):
        before = [k.launches for k in long_kernels]
        loss, _ = lstep(*long_batch)
        losses.append(loss.item())
        got = tuple(k.launches - n for k, n in zip(long_kernels, before))
        assert got == (1, 1, 0, 0, 4, 4, 4, 4), f"step {i} launches {got}"
        assert math.isfinite(losses[-1]), f"step {i} loss {losses[-1]}"
    long_launches = counts()
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    assert last < first, f"loss did not fall: {first} -> {last}"
    print(f"long-slate train step, paper config (dropout 0.3, bf16, Adam "
          f"1e-3, lambdaLoss ndcgLoss2PP), B={LONG_B} L={LONG_L}, 100-doc "
          f"padding tail: 10 steps, loss mean of the first 3 {first:.3f}, of "
          f"the last 3 {last:.3f}; launches "
          f"{ {k: v for k, v in long_launches.items() if v} }")
    gl, cl, worst = step_one_gpu_vs_cpu(
        lcfg, paper_setup(dev, dropout=0.0)[1],
        [t[:4] for t in long_batch])
    print(f"long-slate train step 1 at dropout 0, fp32, B=4 L={LONG_L}, GPU "
          f"vs CPU plain: loss {gl:.6f} vs {cl:.6f}; worst gradient error "
          f"{worst:.3f} of its tolerance")
    print("phase 19 ok: lambdaLoss trains at L=1024 through the row-tiled "
          "kernel and matches the CPU")

    # -- 20: times of the new kernels and steps -------------------------------
    acfg, amodel = paper_setup(dev, config=CONFIG_DIR + OTHER_RECIPES[0][0])
    astep = make_step(acfg, amodel, acfg.training.compute_dtype)
    for label, fn, n_slates, loss_kernels in (
            (f"approxNDCG recipe (dropout 0.1, bf16) B={B} L={L}",
             lambda: astep(xb, yb, ib), B, ("approx_",)),
            (f"long-slate paper config (dropout 0.3, bf16) B={LONG_B} "
             f"L={LONG_L}", lambda: lstep(*long_batch), LONG_B,
             ("tiled_",))):
        ms = median_ms(fn, iters=20, warmup=3)
        step_ms[label] = ms
        print(f"time train step {label}: {ms:.4f} ms per step, "
              f"{n_slates / ms * 1e3:.1f} slates/s {tag}")
        profile_calls(fn, f"train step {label} {tag}", also=loss_kernels)

    # B9 at the train step's shape: 200 valid documents of 240
    sc = torch.randn(B, L, generator=gen)
    valid = torch.ones(B, L)
    valid[:, -40:] = 0.0
    sc, valid, u = (t.to(dev) for t in (sc * valid, valid,
                                        torch.randn(B, L, generator=gen)))
    lib = approx_library(sc, valid, 1.0, eps)
    pairs = int((valid.sum(dim=1) * (valid.sum(dim=1) - 1)).sum().item())
    # per valid off-diagonal pair, forward 8 operations: the difference, the
    # scale, the exponential, the sum and the quotient of the sigmoid, the
    # clamp, the mask and the accumulation; s and valid read, pos written
    rows.append(short_kernel_row(
        "approx_pos_fwd", lambda: approx_pos_fwd(sc, valid, 1.0, eps),
        lambda: approx_pos_fwd_plain(sc, valid, 1.0, eps), lib[0],
        (8 * pairs, 3 * B * L * 4), b9_errs["approx_pos_fwd"],
        f"B={B} L={L} (200 valid)", tag))
    # backward 12, each c_ij once: the sigmoid (5), 1 - t, the products with
    # -alpha, t and u, the compare, and its two accumulations; the kernel's
    # second sigmoid (t_ji, so that no atomics are needed) is a cost of its
    # design and not part of the bound; u read too
    rows.append(short_kernel_row(
        "approx_pos_bwd", lambda: approx_pos_bwd(sc, valid, u, 1.0, eps),
        lambda: approx_pos_bwd_plain(sc, valid, u, 1.0, eps), lib[1],
        (12 * pairs, 4 * B * L * 4), b9_errs["approx_pos_bwd"],
        f"B={B} L={L} (200 valid)", tag))

    # B6 at the long-slate step's shape and at (64, 512), every document
    # valid; the torch-op chain is what a dispatch gate would have to beat
    b6_rows = {}
    for b, k in ((LONG_B, LONG_L), (B, 512)):
        ts = torch.randint(0, 5, (b, k), generator=gen).float()
        pair_args = [t.to(dev) for t in (torch.randn(b, k, generator=gen), ts,
                                         (2.0 ** ts - 1.0) / 30.0,
                                         torch.ones(b, k))]
        kw = dict(scheme="ndcgLoss2PP_scheme", k_eff=k, sigma=1.0, mu=10.0,
                  log_base="binary", eps=eps)
        gout = torch.ones(b, device=dev)
        lib = chain_library(pair_args, kw)
        e = b6_errs[(b, k)]
        # the operations of B3's bound (phase 10), on the pairs these
        # labels select
        for row in (
                short_kernel_row(
                    "lambda_tiled_fwd",
                    lambda: lambda_tiled_fwd(*pair_args, **kw),
                    lambda: lambda_tiled_fwd_plain(*pair_args, **kw), lib[0],
                    chain_work(pair_args, kw, 28, False), e[0],
                    f"B={b} k={k}", tag),
                short_kernel_row(
                    "lambda_tiled_bwd",
                    lambda: lambda_tiled_bwd(*pair_args, gout, **kw),
                    lambda: lambda_tiled_bwd_plain(*pair_args, gout, **kw),
                    lib[1], chain_work(pair_args, kw, 36, True), e[1],
                    f"B={b} k={k}", tag)):
            if (b, k) == (LONG_B, LONG_L):
                b6_rows[row["name"]] = row
            else:
                b6_rows[row["name"]].update({
                    f"{key}_b64_k512": row[key]
                    for key in ("ms", "call_ms", "plain_ms", "bound_ms",
                                "library_ms")})
        del lib
    rows.extend(b6_rows.values())

    # B6 beside B3 inside B3's envelope, device time on the same inputs: the
    # dispatch sends k <= 384 to B3 because that is B3's length, not
    # because B3 is the faster one there
    for b, k in ((B, 128), (B, L), (B, 384), (256, L)):
        ts = torch.randint(0, 5, (b, k), generator=gen).float()
        pair_args = [t.to(dev) for t in (torch.randn(b, k, generator=gen), ts,
                                         (2.0 ** ts - 1.0) / 30.0,
                                         torch.ones(b, k))]
        kw = dict(scheme="ndcgLoss2PP_scheme", k_eff=k, sigma=1.0, mu=10.0,
                  log_base="binary", eps=eps)
        gout = torch.ones(b, device=dev)
        us = [graph_ms(fn) * 1e3 for fn in (
            lambda: lambda_pairs_fwd(*pair_args, **kw),
            lambda: lambda_tiled_fwd(*pair_args, **kw),
            lambda: lambda_pairs_bwd(*pair_args, gout, **kw),
            lambda: lambda_tiled_bwd(*pair_args, gout, **kw))]
        for name, pair in (("fwd", us[:2]), ("bwd", us[2:])):
            b6_rows[f"lambda_tiled_{name}"][f"b3_b6_us_b{b}_k{k}"] = pair
        print(f"time B3 beside B6, float32 B={b} k={k}, device time: forward "
              f"{us[0]:.1f} us against {us[1]:.1f} us, backward {us[2]:.1f} "
              f"us against {us[3]:.1f} us {tag}")

    # -- 21: B4 and B5 against their plain versions -----------------------------
    from allrank_tpu_torch.models.transformer import split_attention_sublayer
    from allrank_tpu_torch.ops.attention_block import attention_sublayer
    from allrank_tpu_torch.ops.attention_fused import fused_slate_attention
    from allrank_tpu_torch.ops.attention_tiled import tiled_slate_attention

    def attention_pair(kind, args, p, seed, one_key=False):
        """One kernel forward and backward against the plain versions on
        the same inputs; returns (max abs err of out, of the gradients).
        ``one_key`` (fp32 at L = 1): dq and dk are 0 in exact arithmetic
        and held to exactly 0, not to the plain version, whose own fp32
        noise there reaches the absolute tolerance (ROADMAP Queue C6)."""
        q, k, v, mask, do = args
        dtype = q.dtype
        if kind == "fused":
            fwd, bwd = attention_fused_fwd, attention_fused_bwd
            before = (fwd.launches, bwd.launches)
            out, stats = fwd(q, k, v, mask, p, seed, return_saved=True)
            grads = bwd(q, k, v, mask, do, p, seed, stats=stats)
            torch.cuda.synchronize()
            ref = attention_fused_fwd_plain(q, k, v, mask, p, seed)
            ref_grads = attention_fused_bwd_plain(q, k, v, mask, do, p, seed)
        else:
            fwd, bwd = tiled_attention_fwd, tiled_attention_bwd
            before = (fwd.launches, bwd.launches)
            out, lse = fwd(q, k, v, mask, p, seed, return_saved=True)
            grads = bwd(q, k, v, mask, out, lse, do, p, seed)
            torch.cuda.synchronize()
            ref, ref_lse = tiled_attention_fwd_plain(q, k, v, mask, p, seed)
            torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
            ref_grads = tiled_attention_bwd_plain(q, k, v, mask, out, lse, do,
                                                  p, seed)
        assert (fwd.launches, bwd.launches) == (before[0] + 1,
                                                before[1] + 1), kind
        assert torch.isfinite(out.float()).all(), kind
        torch.testing.assert_close(out.float(), ref.float(),
                                   **KERNEL_TOL[dtype])
        rtol, atol = BWD_TOL[dtype]
        g_err = 0.0
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
            assert torch.isfinite(g.float()).all(), (kind, name)
            if one_key and name != "dv":
                assert not g.any(), (kind, name, tuple(q.shape), p)
                continue
            err, scale = rel_err(g, r)
            assert err <= rtol * scale + atol, (
                f"{kind} {name} {tuple(q.shape)} {dtype} p={p}: {err} > "
                f"{rtol} x {scale} + {atol}")
            g_err = max(g_err, err)
        return rel_err(out, ref)[0], g_err

    # each kernel at the shapes its own main paths give it (phase 23's train
    # steps: B4 at B=16, L=1200 and B5 at B=8, L=4096, the paper config's
    # h=4, d_k=32; phase 26's int8 tower: B4 at B=64, L=240 and B5 at B=4,
    # L=4096), at d_k=72 and at L=8192; the plain versions materialise
    # [B, h, L, L] and its int64 mask index (their peak is printed)
    attn_errs = {}
    torch.cuda.reset_peak_memory_stats()
    for kind, shapes in (("fused", ((16, 4, 1200, 32), (64, 4, 240, 32),
                                    (2, 2, 1100, 72))),
                         ("tiled", ((8, 4, 4096, 32), (4, 4, 4096, 32),
                                    (1, 4, 8192, 32)))):
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                for p in (0.0, 0.3):
                    args = qkv_inputs(gen, *shape, dtype, dev)
                    errs_fb = attention_pair(kind, args, p, 303)
                    attn_errs[(kind, shape, dtype, p)] = errs_fb
                    print(f"{'B4' if kind == 'fused' else 'B5'} vs plain "
                          f"(B, h, L, d_k)={shape} {dtype} p={p}: max_abs_err "
                          f"out {errs_fb[0]:.3e}, grads {errs_fb[1]:.3e} (tol "
                          f"{KERNEL_TOL[dtype]}; grads {BWD_TOL[dtype][0]:g} x "
                          f"max|ref|)")
                    del args
            torch.cuda.empty_cache()
    # B5's bf16 tensor-core kernels at the edges of their envelope: one key,
    # a tile and one key, the longest slate past a 64 multiple; each of the
    # 18 kernels: d_k 8 (one 16-wide step, half of it padding), 20 (rows
    # not 16-byte aligned) and 32 (phase 21's shapes) in the 32 class, 36
    # (not aligned) and 48 in the 64 class, 72 (padded to 80), 100 (not
    # aligned) and 128 (the widest) in the 128 class, and d_k 32 with
    # q, k, v and dO starting 2 bytes past a 16-byte boundary (the
    # element-wise staging); slates ragged, the last fully padded; a second
    # backward gives the same bits
    # B4's likewise at L in {1, 65, 1224}: the split block's longest slate,
    # whose last key tile holds 8 keys
    def backward_twice(kind, q, k, v, mask, do, p, seed):
        if kind == "fused":
            _, stats = attention_fused_fwd(q, k, v, mask, p, seed,
                                           return_saved=True)
            return [attention_fused_bwd(q, k, v, mask, do, p, seed,
                                        stats=stats) for _ in range(2)]
        out, lse = tiled_attention_fwd(q, k, v, mask, p, seed,
                                       return_saved=True)
        return [tiled_attention_bwd(q, k, v, mask, out, lse, do, p, seed)
                for _ in range(2)]

    # The fp32 kernels (3xTF32 on the tensor cores) likewise, each of their
    # 18 a source: d_k 20, 32, 36 and 100 with rows one element (4 bytes)
    # off a 16-byte boundary reach the element-wise staging of each class.
    # They run after the one-key case below, which keeps its inputs.
    offsets = {torch.bfloat16: ((8, 0), (20, 0), (32, 1), (36, 0), (48, 0),
                                (72, 0), (100, 0), (128, 0)),
               torch.float32: ((8, 0), (20, 1), (32, 1), (36, 1), (48, 0),
                               (72, 0), (100, 1), (128, 0))}

    def edge_cases(dtype):
        for kind, lengths in (("tiled", (1, 65, 4097)),
                              ("fused", (1, 65, 1224))):
            for l in lengths:
                for dk, offset in offsets[dtype]:
                    for p in (0.0, 0.3):
                        shape = (3, 2, l, dk)
                        q, k, v, mask, do = qkv_inputs(gen, *shape, dtype,
                                                       dev)
                        if offset:
                            q, k, v, do = (off_boundary(t, offset)
                                           for t in (q, k, v, do))
                        one = dtype == torch.float32 and l == 1
                        errs_fb = attention_pair(kind, (q, k, v, mask, do),
                                                 p, 304, one_key=one)
                        attn_errs[(kind, shape, dtype, p)] = errs_fb
                        first, again = backward_twice(kind, q, k, v, mask,
                                                      do, p, 304)
                        assert all(torch.equal(a, b)
                                   for a, b in zip(first, again)), (
                            kind, shape, dtype, p)
                        off = offset * q.element_size()
                        print(f"{'B4' if kind == 'fused' else 'B5'} vs plain "
                              f"(B, h, L, d_k)={shape} {dtype} p={p}"
                              f"{f' rows {off} bytes off' if offset else ''}"
                              f": max_abs_err out {errs_fb[0]:.3e}, grads "
                              f"{errs_fb[1]:.3e}"
                              f"{' (dv; dq, dk exactly 0)' if one else ''}"
                              f"; a second backward bit for bit")
                        del q, k, v, mask, do, first, again
                    torch.cuda.empty_cache()

    edge_cases(torch.bfloat16)
    # one key in fp32: dQ and dK are 0 in exact arithmetic, and dP - D must
    # cancel to no more than the plain version's noise (ROADMAP Queue C3);
    # the 3xTF32 kernels cancel it exactly, so their dQ and dK are 0
    for kind in ("fused", "tiled"):
        args = qkv_inputs(gen, 3, 2, 1, 128, torch.float32, dev)
        errs_fb = attention_pair(kind, args, 0.0, 305)
        attn_errs[(kind, (3, 2, 1, 128), torch.float32, 0.0)] = errs_fb
        dq1, dk1, _ = backward_twice(kind, *args[:4], args[4], 0.0, 305)[0]
        assert not dq1.any() and not dk1.any(), kind
        print(f"{'B4' if kind == 'fused' else 'B5'} vs plain (B, h, L, d_k)="
              f"(3, 2, 1, 128) float32 p=0.0: max_abs_err out "
              f"{errs_fb[0]:.3e}, grads {errs_fb[1]:.3e} (tol "
              f"{BWD_TOL[torch.float32][0]:g} x max|ref| + "
              f"{BWD_TOL[torch.float32][1]:g}); dq and dk exactly 0")
    edge_cases(torch.float32)
    print(f"B4/B5 vs plain: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB {tag}")
    # the split block with B4 and with B5 against the B1 sublayer on the
    # same inputs and seeds, p = 0.3, forward and every gradient (slates
    # with a valid document: a fully padded slate is covered above)
    for b, l in ((B, L), (LONG_B, LONG_L)):
        args = attn_inputs(gen, b, l, 128, torch.float32, dev)
        args[1][0] = torch.arange(l, device=dev) >= l // 2
        dy = torch.randn(b, l, 128, generator=gen).to(dev)
        runs = {}
        for form, fn in (
                ("B1", attention_sublayer),
                ("B4", lambda *a: split_attention_sublayer(
                    *a, attention=fused_slate_attention)),
                ("B5", lambda *a: split_attention_sublayer(
                    *a, attention=tiled_slate_attention))):
            leaves = [t.detach().clone().requires_grad_() if t.is_floating_point()
                      else t for t in args]
            y = fn(*leaves, 4, 0.3, 0.3, (41, 42))
            grads = torch.autograd.grad(
                y, [t for t in leaves if t.requires_grad], dy)
            runs[form] = (y.detach(), grads)
        y1, g1 = runs["B1"]
        for form in ("B4", "B5"):
            y, g = runs[form]
            torch.testing.assert_close(y, y1, **KERNEL_TOL[torch.float32])
            worst = 0.0
            for i, (a, r) in enumerate(zip(g, g1)):
                err, scale = rel_err(a, r)
                assert err <= BWD_TOL[torch.float32][0] * scale + 1e-6, (
                    form, b, l, i, err, scale)
                worst = max(worst, err / (scale + 1e-6))
            print(f"split block with {form} vs the B1 sublayer B={b} L={l} "
                  f"d=128 h=4 p=0.3, same seeds: max_abs_err y "
                  f"{rel_err(y, y1)[0]:.3e}, worst gradient {worst:.2e} of "
                  f"its tensor's max|ref|")
    print("phase 21 ok: B4 and B5 match their plain versions forward and "
          "backward, and the split block matches the B1 sublayer")

    # -- 22: long-slate serving ------------------------------------------------
    serve_b, serve_l = 4, 8192
    attn_kernels = (attention_sublayer_fwd, attention_fused_fwd,
                    tiled_attention_fwd, ffn_sublayer_fwd,
                    attention_sublayer_bwd, attention_fused_bwd,
                    tiled_attention_bwd, ffn_sublayer_bwd, lambda_pairs_fwd,
                    lambda_pairs_bwd, lambda_tiled_fwd, lambda_tiled_bwd)

    b45_kernels = (attention_fused_fwd, attention_fused_bwd,
                   tiled_attention_fwd, tiled_attention_bwd)

    def long_counts():
        return {k.__name__: k.launches for k in attn_kernels}

    def reset_long():
        for k in attn_kernels:
            k.launches = 0
        for k in b45_kernels:
            k.route_launches = dict.fromkeys(B45_ROUTES, 0)

    def b45_routes():
        """B4's and B5's launches by route, wrapper by wrapper."""
        return {k.__name__: dict(k.route_launches) for k in b45_kernels}

    _, smodel = paper_setup(dev, dropout=0.0)
    rng22 = np.random.RandomState(22)
    x22 = rng22.randn(serve_b, serve_l, N_FEATURES).astype(np.float32)
    len22 = np.array([serve_l, 5000, 0, 1])
    len22_dev = torch.as_tensor(len22, device=dev)
    pad22 = np.arange(serve_l)[None, :] >= len22[:, None]
    serve_launches, serve_routes = {}, {}
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        scorer = make_scorer(smodel, dtype)
        scorer(x22, len22)
        reset_long()
        got = scorer(x22, len22)
        torch.cuda.synchronize()
        serve_launches[label] = {k: v for k, v in long_counts().items() if v}
        assert serve_launches[label] == {"tiled_attention_fwd": 4,
                                         "ffn_sublayer_fwd": 4}, (
            label, serve_launches[label])
        # fp32 through the 3xTF32 kernels, bf16 through the bf16 ones
        way = b45_route(dtype, 32)
        serve_routes[label] = b45_routes()["tiled_attention_fwd"]
        assert serve_routes[label][way] == 4, (label, serve_routes[label])
        got = got.cpu().numpy()
        ref = plain_scores(smodel, torch.as_tensor(x22, device=dev),
                           len22_dev, dtype).cpu().numpy()
        assert got.shape == (serve_b, serve_l) and not np.isnan(got).any()
        assert np.isneginf(got[pad22]).all() and np.isfinite(got[~pad22]).all()
        err = float(np.abs(got[~pad22] - ref[~pad22]).max())
        tol = (SCORE_TOL if dtype == torch.float32 else
               BF16_SCORE_TOL * float(np.abs(ref[~pad22]).max()))
        assert err <= tol, f"{label} long scores vs plain: {err} > {tol}"
        print(f"long-slate scorer, paper-config model (no positional "
              f"encoding), B={serve_b} L={serve_l} {label}, lengths "
              f"{len22.tolist()}: max_abs_err vs the plain forward on the card "
              f"{err:.3e} (tol {tol:.3e}); launches {serve_launches[label]}, "
              f"B5 by route {serve_routes[label]}")
    service = SlateScoringService(smodel, serve_l, N_FEATURES, batch_size=4,
                                  max_wait_ms=5, compute_dtype="float32",
                                  batch_buckets=(1, 4))
    try:
        one = rng22.randn(7000, N_FEATURES).astype(np.float32)
        got = service.score(one, timeout=120)
        xb = np.zeros((1, serve_l, N_FEATURES), dtype=np.float32)
        xb[0, :7000] = one
        direct = make_scorer(smodel, "float32")(xb, [7000]).cpu().numpy()
        assert got.shape == (7000,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, direct[0, :7000], rtol=1e-4,
                                   atol=1e-4)
    finally:
        service.close()
    print(f"service with slate_length={serve_l}: one 7000-document request "
          f"answered, equal to the direct scorer")
    print("phase 22 ok: the scorer serves B=4 slates of L=8192 through B5")

    # -- 23: long-slate training -------------------------------------------------
    long_runs = {}
    for b, l, tail, attn in ((8, 4096, 400, "tiled_attention"),
                             (16, 1200, 120, "attention_fused")):
        tcfg, tmodel = paper_setup(dev)
        batch = train_batch(dev, seed=23, b=b, l=l, tail=tail)
        tstep = make_step(tcfg, tmodel, tcfg.training.compute_dtype)
        want = {f"{attn}_fwd": 4, f"{attn}_bwd": 4, "ffn_sublayer_fwd": 4,
                "ffn_sublayer_bwd": 4, "lambda_tiled_fwd": 1,
                "lambda_tiled_bwd": 1}
        reset_long()
        losses = []
        t0 = time.perf_counter()
        for i in range(10):
            before = long_counts()
            loss, n_real = tstep(*batch)
            losses.append(loss.item())
            got = {k: v - before[k] for k, v in long_counts().items()
                   if v - before[k]}
            assert got == want, f"B={b} L={l} step {i} launches {got}"
            assert math.isfinite(losses[-1]), f"step {i} loss {losses[-1]}"
        seconds = time.perf_counter() - t0
        first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
        assert last < first, f"B={b} L={l} loss did not fall: {first} -> {last}"
        long_runs[(b, l)] = (long_counts(), tstep, batch)
        print(f"long-slate train step, paper config (dropout 0.3, bf16, Adam "
              f"1e-3, lambdaLoss ndcgLoss2PP), B={b} L={l}, {tail}-doc "
              f"padding tail: 10 steps in {seconds:.1f} s, loss mean of the "
              f"first 3 {first:.3f}, of the last 3 {last:.3f}; launches "
              f"{ {k: v for k, v in long_counts().items() if v} }")
    f32_step_routes = {}
    for b, l, tail in ((2, 4096, 400), (16, 1200, 120)):
        t0 = time.perf_counter()
        reset_long()
        gl, cl, worst, flips = step_one_gpu_vs_cpu(
            lcfg, paper_setup(dev, dropout=0.0)[1],
            train_batch(dev, seed=24, b=b, l=l, tail=tail), gate_flips=True)
        # the fp32 step's attention ran through the 3xTF32 kernels, both ways
        attn = "tiled_attention" if l > 1224 else "attention_fused"
        routes = b45_routes()
        for name in (f"{attn}_fwd", f"{attn}_bwd"):
            assert routes[name]["tf32x3"] > 0 and not routes[name]["mma"], (
                name, routes[name])
            f32_step_routes[name] = routes[name]["tf32x3"]
        print(f"long-slate train step 1 at dropout 0, fp32, B={b} L={l}, GPU "
              f"vs CPU plain: loss {gl:.6f} vs {cl:.6f}; worst gradient error "
              f"{worst:.3f} of its tolerance, FFN units with a ReLU gate "
              f"flipped between the two held out per block {flips} (at most "
              f"{GATE_FLIPS_MAX}); B4/B5 by route "
              f"{ {k: v for k, v in routes.items() if any(v.values())} } "
              f"({time.perf_counter() - t0:.1f} s)")
    print("phase 23 ok: the paper config trains at L=4096 through B5 and at "
          "L=1200 through B4, and matches the CPU")

    # -- 24: times of B4 and B5, and the long steps -----------------------------
    # B5 in fp32 and bf16 at p = 0 beside its plain version and the library
    attn_rows = {}
    for b, h, l, dk in ((8, 4, 1200, 32), (8, 4, 4096, 32),
                        (LONG_B, 4, LONG_L, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, do = qkv_inputs(gen, b, h, l, dk, dtype, dev,
                                           empty=False)
            out5, lse = tiled_attention_fwd(q, k, v, mask, return_saved=True)
            lib = library_fns(q, k, v, mask, do)
            fns = {
                "tiled_attention_fwd": (
                    lambda: tiled_attention_fwd(q, k, v, mask),
                    lambda: tiled_attention_fwd_plain(q, k, v, mask), lib[0]),
                "tiled_attention_bwd": (
                    lambda: tiled_attention_bwd(q, k, v, mask, out5, lse, do),
                    lambda: tiled_attention_bwd_plain(q, k, v, mask, out5,
                                                      lse, do), lib[1])}
            for name, (kfn, pfn, lfn) in fns.items():
                iters = 10 if l > 2000 else 20
                ms, plain_ms, lib_ms = (median_ms(fn, iters=iters, warmup=2)
                                        for fn in (kfn, pfn, lfn))
                flops, moved = attention_work(b, h, l, dk, dtype,
                                              name.endswith("bwd"))
                bound_ms, bound_by = bound(flops, moved, attention_rate(dtype))
                key = (name, b, l, dtype)
                attn_rows[key] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, gflop=flops / 1e9,
                                      mbytes=moved / 1e6)
                print(f"time {name} {dtype} (B, h, L, d_k)=({b}, {h}, {l}, "
                      f"{dk}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"library (scaled_dot_product_attention"
                      f"{', autograd' if name.endswith('bwd') else ''}) "
                      f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                      f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB; "
                      f"{b * h * l * l:.3e} exps) {tag}")
            del q, k, v, do, out5, lse, lib, fns
            torch.cuda.empty_cache()
    mhz = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # B4 in fp32 (the 3xTF32 kernels) and bf16 (the bf16 ones) at p = 0
    # and at the paper step's 0.3: at (8, 4, 1200, 32) (the (16, 1200)
    # step's slates), (8, 4, 4096, 32) and (16, 4, 1024, 32) beside B5, and
    # the int8 tower's (64, 4, 240, 32); beside each bound the exp floor
    # (one exponential a (query, key) pair forward, two backward, at 16 a
    # clock on each SM) and the floor of this design's own count (two a
    # pair forward, three backward: D, dS and dK/dV each rebuild P)
    b4_rows = {}
    for b, h, l, dk in ((8, 4, 1200, 32), (8, 4, 4096, 32),
                        (LONG_B, 4, LONG_L, 32), (B, 4, L, 32)):
        pairs = b * h * l * l
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, do = qkv_inputs(gen, b, h, l, dk, dtype, dev,
                                           empty=False)
            for p in (0.0, 0.3):
                _, stats = attention_fused_fwd(q, k, v, mask, p, 24,
                                               return_saved=True)
                lib = library_fns(q, k, v, mask, do, p)
                fns = {
                    "attention_fused_fwd": (
                        lambda: attention_fused_fwd(q, k, v, mask, p, 24),
                        lambda: attention_fused_fwd_plain(q, k, v, mask, p,
                                                          24), lib[0]),
                    "attention_fused_bwd": (
                        lambda: attention_fused_bwd(q, k, v, mask, do, p, 24,
                                                    stats=stats),
                        lambda: attention_fused_bwd_plain(q, k, v, mask, do,
                                                          p, 24), lib[1])}
                for name, (kfn, pfn, lfn) in fns.items():
                    backward = name.endswith("bwd")
                    iters = 10 if l > 2000 else 20
                    ms = median_ms(kfn, iters=iters, warmup=2)
                    plain_ms = median_ms(pfn, iters=3 if p else iters,
                                         warmup=1)
                    lib_ms = median_ms(lfn, iters=iters, warmup=2)
                    flops, moved = attention_work(b, h, l, dk, dtype,
                                                  backward)
                    bound_ms, bound_by = bound(flops, moved,
                                               attention_rate(dtype))
                    floor = exp_floor_ms((2 if backward else 1) * pairs, mhz,
                                         sms)
                    design = exp_floor_ms((3 if backward else 2) * pairs,
                                          mhz, sms)
                    b4_rows[(name, b, l, dtype, p)] = dict(
                        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        exp_floor_ms=floor, design_exp_floor_ms=design,
                        gflop=flops / 1e9, mbytes=moved / 1e6)
                    print(f"time {name} {dtype} (B, h, L, d_k)=({b}, {h}, "
                          f"{l}, {dk}) p={p}: kernel {ms:.4f} ms, plain "
                          f"{plain_ms:.4f} ms, library (scaled_dot_product_"
                          f"attention, dropout_p={p}"
                          f"{', autograd' if backward else ''}) {lib_ms:.4f} "
                          f"ms ({ms / lib_ms:.2f}x), bound {bound_ms:.4f} ms "
                          f"({bound_by}: {flops / 1e9:.3f} GFLOP, "
                          f"{moved / 1e6:.2f} MB), exp floor {floor:.4f} ms "
                          f"({(2 if backward else 1) * pairs:.3e} exps), "
                          f"this design's {(3 if backward else 2)} exps a "
                          f"pair {design:.4f} ms, at {mhz:.0f} MHz on {sms} "
                          f"SMs {tag}")
                del stats, lib, fns
            del q, k, v, mask, do
            torch.cuda.empty_cache()
    # B5's bf16 kernels (the tensor-core ones) at p = 0 and at the paper
    # step's 0.3, at the shapes of its main paths (the (8, 4096) step, the
    # (4, 8192) scorer) and at B4's (8, 1200) and (16, 1024); beside each
    # bound the exp floor: one exponential a (query, key) pair forward, two
    # backward (each backward kernel rebuilds P), on 16 special-function
    # units on each of the card's SMs at its largest SM clock. The plain
    # version at (4, 8192) and p > 0 is not timed: its dropout mask of
    # B h L^2 elements takes some 40 GB of int64 intermediates.
    b5_rows = {}
    for b, h, l, dk in ((8, 4, 4096, 32), (4, 4, 8192, 32), (8, 4, 1200, 32),
                        (LONG_B, 4, LONG_L, 32)):
        q, k, v, mask, do = qkv_inputs(gen, b, h, l, dk, torch.bfloat16, dev,
                                       empty=False)
        pairs = b * h * l * l
        for p in (0.0, 0.3):
            out5, lse = tiled_attention_fwd(q, k, v, mask, p, 24,
                                            return_saved=True)
            lib = library_fns(q, k, v, mask, do, p)
            fns = {
                "tiled_attention_fwd": (
                    lambda: tiled_attention_fwd(q, k, v, mask, p, 24),
                    lambda: tiled_attention_fwd_plain(q, k, v, mask, p, 24),
                    lib[0]),
                "tiled_attention_bwd": (
                    lambda: tiled_attention_bwd(q, k, v, mask, out5, lse, do,
                                                p, 24),
                    lambda: tiled_attention_bwd_plain(q, k, v, mask, out5,
                                                      lse, do, p, 24),
                    lib[1])}
            for name, (kfn, pfn, lfn) in fns.items():
                backward = name.endswith("bwd")
                iters = 10 if l > 2000 else 20
                ms = median_ms(kfn, iters=iters, warmup=2)
                lib_ms = median_ms(lfn, iters=iters, warmup=2)
                plain_ms = (None if p and pairs > 6e8 else
                            median_ms(pfn, iters=3, warmup=1))
                flops, moved = attention_work(b, h, l, dk, torch.bfloat16,
                                              backward)
                bound_ms, bound_by = bound(flops, moved, torch.bfloat16)
                floor = exp_floor_ms((2 if backward else 1) * pairs, mhz,
                                     sms)
                b5_rows[(name, b, l, p)] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, exp_floor_ms=floor)
                plain_txt = ("not timed" if plain_ms is None
                             else f"{plain_ms:.4f} ms")
                print(f"time {name} bfloat16 (B, h, L, d_k)=({b}, {h}, {l}, "
                      f"{dk}) p={p}: kernel {ms:.4f} ms, plain {plain_txt}, "
                      f"library (scaled_dot_product_attention, dropout_p={p}"
                      f"{', autograd' if backward else ''}) {lib_ms:.4f} ms, "
                      f"bound {bound_ms:.4f} ms ({bound_by}), exp floor "
                      f"{floor:.4f} ms ({(2 if backward else 1) * pairs:.3e} "
                      f"exps at {mhz:.0f} MHz on {sms} SMs) {tag}")
            del out5, lse, lib, fns
        del q, k, v, mask, do
        torch.cuda.empty_cache()
    # B4 and B5 as device time, fp32 (the 3xTF32 kernels) and bf16, p = 0:
    # 20 calls in one CUDA graph, beside the library's device time, the
    # fp32 SIMT bound (67 TFLOP/s) and the 3xTF32 bound (a third of 495
    # TFLOP/s TF32): its forward in a graph, its backward, which autograd
    # keeps out of a graph, as its kernels' profiler sum (not measured
    # where every trace lost device events, as traces late in this long
    # process have)
    dev_rows = {}
    for b, h, l, dk in ((8, 4, 1200, 32), (8, 4, 4096, 32),
                        (LONG_B, 4, LONG_L, 32), (B, 4, L, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, do = qkv_inputs(gen, b, h, l, dk, dtype, dev,
                                           empty=False)
            _, stats = attention_fused_fwd(q, k, v, mask, return_saved=True)
            out5, lse = tiled_attention_fwd(q, k, v, mask, return_saved=True)
            lib = library_fns(q, k, v, mask, do)
            lib_dev = {False: graph_ms(lib[0])}
            try:
                lib_dev[True] = sum(kernel_ms(lib[1]).values())
            except IncompleteTrace as err:
                print(f"library backward: {err} {tag}")
                lib_dev[True] = None
            fns = {
                "attention_fused_fwd": lambda: attention_fused_fwd(q, k, v,
                                                                   mask),
                "attention_fused_bwd": lambda: attention_fused_bwd(
                    q, k, v, mask, do, stats=stats),
                "tiled_attention_fwd": lambda: tiled_attention_fwd(q, k, v,
                                                                   mask),
                "tiled_attention_bwd": lambda: tiled_attention_bwd(
                    q, k, v, mask, out5, lse, do)}
            for name, fn in fns.items():
                backward = name.endswith("bwd")
                flops, moved = attention_work(b, h, l, dk, dtype, backward)
                row = dict(graph_ms=graph_ms(fn),
                           bound_ms=bound(flops, moved,
                                          attention_rate(dtype))[0])
                row["library_device_ms"] = lib_ms = lib_dev[backward]
                lib_txt = ("library not measured" if lib_ms is None else
                           f"library {lib_ms:.4f} ms "
                           f"({row['graph_ms'] / lib_ms:.2f}x)")
                if dtype == torch.float32:
                    row["bound_simt_ms"] = bound(flops, moved, dtype)[0]
                dev_rows[(name, b, l, dtype)] = row
                print(f"time {name} {dtype} (B, h, L, d_k)=({b}, {h}, {l}, "
                      f"{dk}) p=0, device time: kernel "
                      f"({b45_route(dtype, dk)}) {row['graph_ms']:.4f} ms, "
                      f"{lib_txt}, bound {row['bound_ms']:.4f} ms"
                      + (f" (3xTF32; SIMT fp32 {row['bound_simt_ms']:.4f} ms)"
                         if dtype == torch.float32 else "") + f" {tag}")
            del q, k, v, mask, do, stats, out5, lse, fns, lib
            torch.cuda.empty_cache()
    # inside B1's envelope: the whole attention sublayer three ways, the
    # data of a later threshold between B1 and the split block
    args = attn_inputs(gen, LONG_B, LONG_L, 128, torch.float32, dev)
    for dtype in (torch.float32, torch.bfloat16):
        a_args = [args[0].to(dtype)] + args[1:]
        dy = torch.randn(LONG_B, LONG_L, 128, generator=gen).to(dtype).to(dev)
        leaves = [t.detach().clone().requires_grad_() if t.is_floating_point()
                  else t for t in a_args]
        timings = []
        for form, fn in (
                ("B1 sublayer", attention_sublayer),
                ("split block with B4", lambda *a: split_attention_sublayer(
                    *a, attention=fused_slate_attention)),
                ("split block with B5", lambda *a: split_attention_sublayer(
                    *a, attention=tiled_slate_attention))):
            with torch.no_grad():
                f_ms = median_ms(lambda: fn(*a_args, 4, 0.0, 0.0, (0, 0)),
                                 iters=20, warmup=3)

            def fwd_bwd():
                y = fn(*leaves, 4, 0.0, 0.0, (0, 0))
                torch.autograd.grad(y, [t for t in leaves if t.requires_grad],
                                    dy)

            fb_ms = median_ms(fwd_bwd, iters=10, warmup=2)
            timings.append((form, f_ms, fb_ms))
        print(f"time attention sublayer {dtype} B={LONG_B} L={LONG_L} d=128 "
              f"h=4, forward / forward and backward: "
              + "; ".join(f"{form} {f:.4f} / {fb:.4f} ms"
                          for form, f, fb in timings) + f" {tag}")
    for (b, l), (_, tstep, batch) in long_runs.items():
        label = f"long-slate paper config (dropout 0.3, bf16) B={b} L={l}"
        ms = median_ms(lambda: tstep(*batch), iters=5, warmup=2)
        step_ms[label] = ms
        print(f"time train step {label}: {ms:.4f} ms per step, "
              f"{b / ms * 1e3:.1f} slates/s {tag}")
        profile_calls(lambda: tstep(*batch), f"train step {label} {tag}",
                      also=("fused_", "tiled_"))
    for name in ("attention_fused_fwd", "attention_fused_bwd",
                 "tiled_attention_fwd", "tiled_attention_bwd"):
        kind = "fused" if "fused" in name else "tiled"
        b, l = (8, 1200) if kind == "fused" else (8, 4096)
        shape = ((16, 4, 1200, 32) if kind == "fused" else (8, 4, 4096, 32))
        row = {"name": name, "route": "cuda"}
        for dtype in (torch.float32, torch.bfloat16):
            sfx = "" if dtype == torch.float32 else "_bf16"
            row[f"max_abs_err{sfx}"] = max(
                attn_errs[(kind, shape, dtype, p)][name.endswith("bwd")]
                for p in (0.0, 0.3))
            if kind == "fused":
                # this run's times at p = 0 and 0.3 at every shape, those
                # at (8, 1200) and p = 0 also without a suffix
                for (bname, ob, ol, odt, p), vals in b4_rows.items():
                    if bname != name or odt != dtype:
                        continue
                    for key, value in vals.items():
                        row[f"{key}{sfx}_b{ob}_l{ol}_p{p:g}"] = value
                        if (ob, ol, p) == (b, l, 0.0):
                            row[f"{key}{sfx}"] = value
                continue
            for key, value in attn_rows[(name, b, l, dtype)].items():
                row[f"{key}{sfx}"] = value
            for ob, ol in ((8, 1200), (LONG_B, LONG_L)):
                for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    row[f"{key}{sfx}_b{ob}_l{ol}"] = attn_rows[
                        (name, ob, ol, dtype)][key]
        if kind == "tiled":
            # the tensor-core kernels' times at both rates
            for (bname, ob, ol, p), vals in b5_rows.items():
                if bname == name:
                    for key, value in vals.items():
                        row[f"{key}_bf16_b{ob}_l{ol}_p{p:g}"] = value
        # device time at p = 0 beside the library forward's and the SIMT
        # fp32 bound, at every shape timed; at the row's own shape also
        # without the shape in the key
        for (dname, ob, ol, odt), vals in dev_rows.items():
            if dname != name:
                continue
            sfx = "" if odt == torch.float32 else "_bf16"
            for key, value in vals.items():
                if key == "bound_ms":
                    continue
                row[f"{key}{sfx}_b{ob}_l{ol}"] = value
                if (ob, ol) == (b, l):
                    row[f"{key}{sfx}"] = value
        rows.append(row)

    # -- 25: X1 against its plain version ----------------------------------------
    from allrank_tpu_torch.ops.q8_dense import q8_dense, q8_dense_plain

    q8_errs = []
    q8_dense.launches = 0
    cases = [(B * L, k, n) for _, k, n, _ in Q8_SITES]
    cases += [(m, k, n) for m in (1, 17, B * L + 1) for k in (1, 33)
              for n in (1, 7)]
    for m, k, n in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for mode in Q8_MODES:
                args = q8_inputs(gen, m, k, n, dtype, mode, dev)
                before = q8_dense.launches
                y = q8_dense(*args)
                torch.cuda.synchronize()
                assert q8_dense.launches == before + 1, "X1 did not launch"
                ref = q8_dense_plain(*args)
                assert y.dtype == ref.dtype == (
                    torch.float32 if mode == "dynamic" else dtype)
                assert torch.isfinite(y).all(), (m, k, n, dtype, mode)
                assert torch.equal(y, ref), (
                    f"X1 vs plain ({m}, {k}, {n}) {dtype} {mode}: "
                    f"{(y.float() - ref.float()).abs().max().item()}")
                q8_errs.append((y.float() - ref.float()).abs().max().item())
    print(f"X1 vs plain, bit for bit: the six flagship sites at M={B * L} "
          f"and M in (1, 17, {B * L + 1}) x K in (1, 33) x N in (1, 7), fp32 "
          f"and bf16 x, static (one multiplier and [K]) and dynamic, .5 ties "
          f"and a zero row: {len(q8_errs)} launches, max_abs_err "
          f"{max(q8_errs)}")
    print("phase 25 ok: X1 is its plain version bit for bit")

    # -- 26: int8 serving, the fourth main path ----------------------------------
    from allrank_tpu_torch.evaluate import run as evaluate_run
    from allrank_tpu_torch.interop import load_npz
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.quant import calibrate_activations

    q8_kernels = (q8_dense, attention_fused_fwd, tiled_attention_fwd,
                  attention_sublayer_fwd, ffn_sublayer_fwd)

    def q8_counts():
        return {k.__name__: k.launches for k in q8_kernels}

    def q8_reset():
        for k in q8_kernels:
            k.launches = 0

    flag = flagship_model(dev)
    flag_cpu = copy.deepcopy(flag).to("cpu")
    t0 = time.perf_counter()
    act_scales = calibrate_activations(
        flag, calibration_batches(gen, 8, dev))
    calib_s = time.perf_counter() - t0
    assert len(act_scales) == 18 and all(
        all(math.isfinite(v) and v >= 0 for v in vec)
        for vec in act_scales.values()), "calibration"
    rng = np.random.RandomState(26)
    x = rng.randn(B, L, N_FEATURES).astype(np.float32)
    lengths = rng.randint(1, L + 1, size=B)
    lengths[3] = 0
    lengths[9] = L
    pad = np.arange(L)[None, :] >= lengths[:, None]
    float32_scores = make_scorer(flag, "float32")(x, lengths).cpu().numpy()
    one_call = {"q8_dense": 18, "attention_fused_fwd": 4,
                "tiled_attention_fwd": 0, "attention_sublayer_fwd": 0,
                "ffn_sublayer_fwd": 0}
    q8_scorers = {}
    # B4 and B5 at the int8 tower's own shapes: each call it made in the
    # counted runs, against the plain version on the same q, k, v and mask
    q8_attn_errs = {}
    for mode in ("int8_static", "int8"):
        scales = act_scales if mode == "int8_static" else None
        for flow in ("bfloat16", "float32"):
            scorer = make_scorer(flag, flow, quantize=mode,
                                 act_scales=scales)
            scorer(x, lengths)  # first call: loads the kernels
            q8_reset()
            with captured_attention_core() as record:
                s = scorer(x, lengths).cpu().numpy()
            assert q8_counts() == one_call, (mode, flow, q8_counts())
            for name, err in check_captured_attention(
                    record, (B, 4, L, 32)).items():
                q8_attn_errs[name] = max(q8_attn_errs.get(name, 0.0), err)
            assert s.dtype == np.float32 and s.shape == (B, L)
            assert np.isneginf(s[pad]).all() and np.isfinite(s[~pad]).all()
            q8_scorers[(mode, flow)] = scorer
            if flow == "bfloat16":
                ref = make_scorer(flag_cpu, flow, device="cpu", quantize=mode,
                                  act_scales=scales)(x, lengths).numpy()
                scale = float(np.abs(ref[~pad]).max())
                err = float(np.abs(s[~pad] - ref[~pad]).max())
                assert err <= BF16_SCORE_TOL * scale, (
                    f"{mode} card vs CPU plain: {err} > {BF16_SCORE_TOL} * "
                    f"{scale}")
            corr, top1 = quality(s, float32_scores, ~pad)
            assert corr > Q8_MIN_CORR and top1 >= Q8_MIN_TOP1, (
                mode, flow, corr, top1)
            print(f"scorer {mode}, {flow} flow, B={B} L={L}: launches "
                  f"{q8_counts()}; "
                  + (f"vs the CPU plain tower max_abs_err {err:.3e} (tol "
                     f"{BF16_SCORE_TOL} x max|score| {scale:.3f}); "
                     if flow == "bfloat16" else "")
                  + f"vs the fp32 float tower on the card: correlation "
                  f"{corr:.6f}, top-1 kept on {top1:.3f} of slates")
    print(f"calibration: 8 batches of B={B}, L={L} on the card in "
          f"{calib_s:.2f} s, {len(act_scales)} sites")
    xl = rng.randn(4, 4096, N_FEATURES).astype(np.float32)
    ll = np.array([4096, 3000, 1, 0])
    long_scorer = make_scorer(flag, "bfloat16", quantize="int8_static",
                              act_scales=act_scales)
    q8_reset()
    with captured_attention_core() as record:
        sl = long_scorer(xl, ll).cpu().numpy()
    long_want = dict(one_call, attention_fused_fwd=0, tiled_attention_fwd=4)
    assert q8_counts() == long_want, q8_counts()
    q8_attn_errs.update(check_captured_attention(record, (4, 4, 4096, 32)))
    del record
    print(f"B4 / B5 on the int8 tower's own q, k and v (bf16, p=0) vs plain: "
          f"max_abs_err {q8_attn_errs} (tol {KERNEL_TOL[torch.bfloat16]})")
    lpad = np.arange(4096)[None, :] >= ll[:, None]
    assert np.isneginf(sl[lpad]).all() and np.isfinite(sl[~lpad]).all()
    print(f"scorer int8_static, bf16 flow, B=4 L=4096: launches "
          f"{q8_counts()}")

    service = SlateScoringService(flag, L, N_FEATURES, batch_size=64,
                                  max_wait_ms=5, compute_dtype="int8_static",
                                  act_scales=act_scales,
                                  batch_buckets=(1, 8, 64))
    server = run_server(service, 0, host="127.0.0.1")
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    direct = q8_scorers[("int8_static", "bfloat16")]
    try:
        slates = [rng.randn(n, N_FEATURES).astype(np.float32)
                  for n in (240, 1, 17, 64, 128, 199, 240, 5, 96, 233, 2,
                            150)]
        waves_before = service.stats()["waves_total"]
        q8_reset()
        with concurrent.futures.ThreadPoolExecutor(len(slates)) as pool:
            futs = [pool.submit(post, url, s, i % 2 == 1)
                    for i, s in enumerate(slates)]
            answers = [f.result(timeout=120) for f in futs]
        q8_main_launches = q8_counts()
        with urllib.request.urlopen(url + "/statz", timeout=30) as r:
            stats = json.loads(r.read())
        waves = stats["waves_total"] - waves_before
        assert waves >= 1 and q8_main_launches == {
            k: v * waves for k, v in one_call.items()}, (
            q8_main_launches, waves)
        err_q8_service = 0.0
        for s, got in zip(slates, answers):
            xb = np.zeros((1, L, N_FEATURES), dtype=np.float32)
            xb[0, : len(s)] = s
            want = direct(xb, [len(s)]).cpu().numpy()[0, : len(s)]
            assert got.shape == (len(s),) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            err_q8_service = max(err_q8_service,
                                 float(np.abs(got - want).max()))
        print(f"service int8_static: {len(slates)} concurrent requests (JSON "
              f"and .npy) in {waves} waves {stats['waves_by_bucket']}, "
              f"max_abs_err vs direct scorer {err_q8_service:.3e}; launches "
              f"{q8_main_launches}")
        one = rng.randn(L, N_FEATURES).astype(np.float32)
        lat = []
        for i in range(40):
            t = time.perf_counter()
            post(url, one, binary=True)
            if i >= 5:
                lat.append((time.perf_counter() - t) * 1e3)
        q8_service_p50 = statistics.median(lat)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    server_thread.join(timeout=10)

    # the evaluate CLI on phase 13's dataset and NeuralNDCG model.npz
    neural_cfg = os.path.join(work_dir, "neuralndcg_atmax.json")
    neural_npz = os.path.join(neural_out_dir, "model.npz")
    with open(neural_cfg) as f:
        val_role = json.load(f)["data"].get("validation_ds_role", "vali")
    evaluated = {}
    for quantize in (None, "int8_static"):
        run_id = f"evaluate_{quantize or 'float'}"
        t0 = time.perf_counter()
        evaluated[quantize] = evaluate_run(Namespace(
            job_dir=os.path.join(work_dir, "job"), run_id=run_id,
            config_file_name=neural_cfg, input_model_path=neural_npz,
            roles=[val_role], quantize=quantize, calibration_role=val_role,
            calibration_batches=8))
        eval_s = time.perf_counter() - t0
        eval_dir = os.path.join(work_dir, "job", "results", run_id)
        with open(os.path.join(eval_dir, "evaluation_result.json")) as f:
            flat = json.load(f)
        assert 0.0 <= flat[f"{val_role}/ndcg_5"] <= 1.0, flat
        assert math.isfinite(flat[f"{val_role}/loss"]), flat
        print(f"evaluate --quantize {quantize}, {NEURAL_CONFIG} model of "
              f"phase 13, role {val_role}: {flat} in {eval_s:.1f} s")
    with open(os.path.join(eval_dir, "act_scales.json")) as f:
        neural_scales = json.load(f)
    ndcg_float = evaluated[None][val_role]["ndcg_5"]
    ndcg_q8 = evaluated["int8_static"][val_role]["ndcg_5"]
    assert abs(ndcg_q8 - ndcg_float) <= 0.05, (ndcg_q8, ndcg_float)
    from allrank_tpu_torch.config import Config

    ncfg = Config.from_json(neural_cfg)
    neural = load_npz(LTRModel(make_model(ncfg.model, N_FEATURES),
                               device="cpu"), neural_npz)
    service = SlateScoringService(neural, L, N_FEATURES, batch_size=8,
                                  compute_dtype="int8_static",
                                  act_scales=neural_scales,
                                  batch_buckets=(1, 8))
    try:
        slate = rng.randn(77, N_FEATURES).astype(np.float32)
        got = service.score(slate, timeout=60)
        xb = np.zeros((1, L, N_FEATURES), dtype=np.float32)
        xb[0, :77] = slate
        want = make_scorer(neural, "bfloat16", quantize="int8_static",
                           act_scales=neural_scales)(xb, [77]).cpu().numpy()
        np.testing.assert_allclose(got, want[0, :77], rtol=1e-4, atol=1e-4)
    finally:
        service.close()
    print(f"evaluate's act_scales.json ({len(neural_scales)} sites) serves: "
          f"val ndcg_5 {ndcg_q8:.4f} int8_static vs {ndcg_float:.4f} float")
    work.cleanup()
    print("phase 26 ok: int8 serving through make_scorer, the service and "
          "evaluate --quantize on the card")

    # -- 27: times of X1, the int8 scorers and the service -----------------------
    q8_sites = {}
    for site, k, n, per_call in Q8_SITES:
        dtype = torch.float32 if site == "output" else torch.bfloat16
        args = q8_inputs(gen, B * L, k, n, dtype, "static", dev)
        x2, w_t, sc, bb, inv = args
        wf = torch.randn(k, n, generator=gen).to(torch.bfloat16).to(dev)
        bf = torch.randn(n, generator=gen).to(torch.bfloat16).to(dev)
        lib = q8_library(*args)
        flops, moved = q8_work(x2, w_t, inv, dtype)
        bound_ms, bound_by = bound(flops, moved, torch.int8)
        ms = graph_ms(lambda: q8_dense(*args))
        call_ms, plain_ms = (median_ms(fn, iters=20) for fn in (
            lambda: q8_dense(*args), lambda: q8_dense_plain(*args)))
        x16 = x2.to(torch.bfloat16)

        def matmul():
            return torch.matmul(x16, wf) + bf

        lib_ms = median_ms(lib, iters=20) if lib else None
        mm_ms = median_ms(matmul, iters=20)
        # the device's own time of the two yardsticks too, as X1's
        lib_dev_ms = graph_ms(lib) if lib else None
        mm_dev_ms = graph_ms(matmul)
        q8_sites[site] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms, "bf16_matmul_ms": mm_ms,
                          "library_device_ms": lib_dev_ms,
                          "bf16_matmul_device_ms": mm_dev_ms,
                          "per_call": per_call, "gflop": flops / 1e9,
                          "mbytes": moved / 1e6}
        print(f"time X1 {site} (M, K, N)=({B * L}, {k}, {n}) {dtype} static: "
              f"kernel {ms:.4f} ms of device time (20 calls in one CUDA "
              f"graph; one event-timed call {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library (quantize ops + torch._int_mm + "
              f"epilogue) "
              + (f"{lib_ms:.4f} ms ({lib_dev_ms:.4f} ms of device time)"
                 if lib_ms is not None else
                 "none (_int_mm needs N a multiple of 8)")
              + f", bf16 torch.matmul + bias {mm_ms:.4f} ms ({mm_dev_ms:.4f} "
              f"ms of device time), bound "
              f"{bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.4f} G int8 "
              f"operations, {moved / 1e6:.3f} MB) {tag}")
    per_call = {key: sum(v[key] * v["per_call"] for v in q8_sites.values())
                for key in ("ms", "plain_ms", "bound_ms",
                            "bf16_matmul_device_ms")}
    print(f"time X1 per scorer call (18 launches): kernel {per_call['ms']:.4f}"
          f" ms of device time, bound {per_call['bound_ms']:.4f} ms, plain "
          f"{per_call['plain_ms']:.4f} ms, the float layers' bf16 matmuls "
          f"{per_call['bf16_matmul_device_ms']:.4f} ms of device time {tag}")
    xd = torch.as_tensor(x, device=dev)
    ld = torch.as_tensor(lengths, device=dev)
    q8_scorer_ms = {}
    for label, scorer in (("float32", make_scorer(flag, "float32")),
                          ("bfloat16", make_scorer(flag, "bfloat16")),
                          ("int8", q8_scorers[("int8", "bfloat16")]),
                          ("int8_static",
                           q8_scorers[("int8_static", "bfloat16")])):
        ms = median_ms(lambda: scorer(xd, ld), iters=20)
        q8_scorer_ms[label] = ms
        print(f"time scorer {label} (int8: bf16 flow) B={B} L={L}: "
              f"{ms:.4f} ms per call, {B / ms * 1e3:.1f} slates/s (input on "
              f"the device) {tag}")
        profile_calls(lambda: scorer(xd, ld), f"scorer {label} {tag}",
                      also=("q8_dense", "fused_fwd"))
    print(f"time service p50 request latency, one {L}-doc .npy slate, "
          f"int8_static, buckets (1, 8, 64): {q8_service_p50:.3f} ms {tag}")
    site = q8_sites["ff1"]
    rows.append({"name": "q8_dense", "route": "cuda",
                 "max_abs_err": max(q8_errs), "ms": site["ms"],
                 "call_ms": site["call_ms"], "plain_ms": site["plain_ms"],
                 "bound_ms": site["bound_ms"], "bound_by": site["bound_by"],
                 "library_ms": site["library_ms"],
                 "bf16_matmul_ms": site["bf16_matmul_ms"],
                 "library_device_ms": site["library_device_ms"],
                 "bf16_matmul_device_ms": site["bf16_matmul_device_ms"],
                 "shape": "ff1 (15360, 128, 512) bf16 static",
                 "per_scorer_call_ms": per_call["ms"],
                 "per_scorer_call_bound_ms": per_call["bound_ms"],
                 "sites": q8_sites, "scorer_ms": q8_scorer_ms,
                 "service_p50_ms": q8_service_p50})

    # -- 28: B10 against its plain version and the chained kernels -----------
    import allrank_tpu_torch.models.transformer as transformer_mod
    from allrank_tpu_torch.ops.encoder_block import (
        cooperative_grid,
        encoder_backward_plain,
        encoder_block_bwd,
        encoder_block_fwd,
        encoder_forward_plain,
    )

    for backward in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            grid = cooperative_grid(128, dtype, backward, dev)
            print(f"B10 {'backward' if backward else 'forward'} {dtype} at "
                  f"d=128: cooperative grid {grid['grid']} blocks "
                  f"({grid['blocks_per_sm']} per SM x {grid['sms']} SMs), "
                  f"{grid['smem_bytes']} B of shared memory a block")
            assert grid["grid"] == grid["blocks_per_sm"] * grid["sms"]
    enc_errs = {}
    b10_vs_mma, c4 = {}, {}

    def worst_share(got, ref):
        """The largest max-abs error of ``got`` against ``ref``, tensor by
        tensor, as a share of the reference tensor's largest value."""
        return max(e / (r + 1e-30) for e, r in map(rel_err, got, ref))

    for b, l, d, h, d_ff, n in ENCODER_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for p in (0.0, 0.3):
                x28, dy28, mask28, seeds28, stacks, fs, fb = encoder_inputs(
                    gen, b, l, d, h, d_ff, n, dtype, dev)
                args28 = (x28, mask28, seeds28, stacks, fs, fb)
                kw = dict(h=h, p_drop=p)
                before = (encoder_block_fwd.launches,
                          encoder_block_bwd.launches)
                y28 = encoder_block_fwd(*args28, **kw)
                got = encoder_block_bwd(*args28, dy28, **kw)
                torch.cuda.synchronize()
                assert (encoder_block_fwd.launches,
                        encoder_block_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
                # B10's reference: the chained kernels of the same tile
                # bodies, B1 on its SIMT route in bf16 too
                chained_y, state = encoder_chained_fwd(*args28, h, p, "simt")
                chained = encoder_chained_bwd(state, mask28, seeds28, stacks,
                                              fs, dy28, h, p)
                plain_y = encoder_forward_plain(*args28, **kw)
                plain = encoder_backward_plain(*args28, dy28, **kw)
                torch.cuda.synchronize()
                if b1_route(dtype, d, h) == "mma":
                    # the chain the encoder runs with the switch off, B1 and
                    # B2 on the tensor cores: its distances, recorded
                    mma_y, mstate = encoder_chained_fwd(*args28, h, p, "mma")
                    mma = encoder_chained_bwd(mstate, mask28, seeds28,
                                              stacks, fs, dy28, h, p)
                    b10_vs_mma[(b, l, d, n, p)] = (
                        worst_share(got, mma), worst_share(mma, plain),
                        worst_share([y28], [mma_y]))
                    if (b, l, d, n) == C4_CASE:
                        ref32 = encoder_backward_plain(
                            x28.float(), mask28, seeds28, stacks, fs, fb,
                            dy28.float(), **kw)
                        c4[p] = tuple(worst_share(t, ref32)
                                      for t in (got, mma, chained))
                        del ref32
                    del mma_y, mstate, mma
                again = encoder_block_bwd(*args28, dy28, **kw)
                assert all(torch.equal(a, c) for a, c in zip(got, again)), (
                    "two B10 backwards of the same inputs differ")
                worst = encoder_check(y28, got, chained_y, chained, plain_y,
                                      plain, dtype)
                enc_errs[(b, l, d, n, dtype, p)] = worst
                print(f"B10 B={b} L={l} d={d} h={h} d_ff={d_ff} N={n} "
                      f"{dtype} p={p}: max_abs_err y / worst gradient vs "
                      f"the chained B1/B2 kernels {worst['fwd_chained']:.3e} "
                      f"/ {worst['bwd_chained']:.3e} (the worst gradient at "
                      f"{worst['bwd_chained_rel']:.2e} of its tolerance), vs "
                      f"plain {worst['fwd_plain']:.3e} / "
                      f"{worst['bwd_plain']:.3e} (the chained kernels vs "
                      f"plain {worst['fwd_chained_plain']:.3e} / "
                      f"{worst['bwd_chained_plain']:.3e}); bit-equal to the "
                      f"chained kernels: y {worst['y_equal']}, gradients "
                      f"{worst['grads_equal']}/15")
                del x28, dy28, got, again, chained, plain, state
    torch.cuda.empty_cache()
    for (b, l, d, n, p), (grad_rel, chain_rel, y_rel) in b10_vs_mma.items():
        print(f"B10 bf16 B={b} L={l} d={d} N={n} p={p} against the chain "
              f"with B1 and B2 on the tensor cores (recorded, not held: the "
              f"two run other tile bodies): worst gradient error "
              f"{grad_rel:.2e} of "
              f"its tensor's max (phase 7's tolerance {BWD_TOL[torch.bfloat16][0]:g}), "
              f"y {y_rel:.2e}; that chain against plain, worst gradient "
              f"{chain_rel:.2e}")
    for p, (b10_share, mma_share, simt_share) in c4.items():
        print(f"C4: at (B, L, d, N)={C4_CASE} bf16 p={p}, the worst gradient "
              f"error against the fp32 plain chain on the same bf16 inputs "
              f"and masks, as a share of the reference tensor's max: B10 "
              f"{b10_share:.4f}, the tensor-core chain (B1 and B2 mma) "
              f"{mma_share:.4f}, the SIMT chain {simt_share:.4f}; B10 / "
              f"tensor-core chain {b10_share / mma_share:.3f} (C4 settled "
              f"if <= {C4_RATIO}: "
              f"{'yes' if b10_share <= C4_RATIO * mma_share else 'no'})")
    print("phase 28 ok: B10 matches the chained B1/B2 kernels, and its plain "
          "version as closely as they do, forward and backward")

    # -- 29: the encoder with the switch on: scorer, service, train step ----
    enc_kernels = (encoder_block_fwd, encoder_block_bwd,
                   attention_sublayer_fwd, attention_sublayer_bwd,
                   ffn_sublayer_fwd, ffn_sublayer_bwd, lambda_pairs_fwd,
                   lambda_pairs_bwd)

    def enc_counts():
        return tuple(k.launches for k in enc_kernels)

    def reset_enc():
        for k in enc_kernels:
            k.launches = 0

    emodel = flagship_model(dev)
    ecpu = copy.deepcopy(emodel).to("cpu")
    rng29 = np.random.RandomState(29)
    x29 = rng29.randn(B, L, N_FEATURES).astype(np.float32)
    len29 = rng29.randint(1, L + 1, size=B)
    len29[3], len29[9] = 0, L
    pad29 = np.arange(L)[None, :] >= len29[:, None]
    off = {label: make_scorer(emodel, dtype)(x29, len29).cpu().numpy()
           for label, dtype in (("fp32", "float32"), ("bf16", "bfloat16"))}
    transformer_mod.MEGA_ENCODER_ENABLED = True
    try:
        cpu_ref = make_scorer(ecpu, "float32", device="cpu")(
            x29, len29).numpy()
        on = {}
        for label, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
            scorer = make_scorer(emodel, dtype)
            scorer(x29, len29)
            reset_enc()
            on[label] = scorer(x29, len29).cpu().numpy()
            torch.cuda.synchronize()
            assert enc_counts() == (1, 0, 0, 0, 0, 0, 0, 0), (
                label, enc_counts())
            got = on[label]
            assert got.shape == (B, L) and not np.isnan(got).any()
            assert np.isneginf(got[pad29]).all()
            assert np.isfinite(got[~pad29]).all()
        err_cpu = float(np.abs(on["fp32"][~pad29] - cpu_ref[~pad29]).max())
        assert err_cpu <= SCORE_TOL, f"B10 scorer vs CPU: {err_cpu}"
        err_off = float(np.abs(on["fp32"][~pad29]
                               - off["fp32"][~pad29]).max())
        assert err_off <= SCORE_TOL, f"B10 scorer vs switch off: {err_off}"
        scale = float(np.abs(on["fp32"][~pad29]).max())
        err16 = float(np.abs(on["bf16"][~pad29] - on["fp32"][~pad29]).max())
        assert err16 <= BF16_SCORE_TOL * scale, err16
        err16_off = float(np.abs(on["bf16"][~pad29]
                                 - off["bf16"][~pad29]).max())
        assert err16_off <= BF16_SCORE_TOL * scale, err16_off
        print(f"B10 scorer (switch on) B={B} L={L}: fp32 vs the CPU plain "
              f"run {err_cpu:.3e}, vs the switched-off scorer on the card "
              f"{err_off:.3e} (tol {SCORE_TOL}); bf16 vs fp32 {err16:.3e}, vs "
              f"the switched-off bf16 scorer {err16_off:.3e} (tol "
              f"{BF16_SCORE_TOL} x max|score| {scale:.3f}); one B10 launch a "
              f"call, no B1 or B2")

        service = SlateScoringService(emodel, L, N_FEATURES, batch_size=64,
                                      max_wait_ms=5, compute_dtype="float32",
                                      batch_buckets=(1, 8, 64))
        server = run_server(service, 0, host="127.0.0.1")
        server_thread = threading.Thread(target=server.serve_forever,
                                         daemon=True)
        server_thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        direct29 = make_scorer(emodel, "float32")
        try:
            slates = [rng29.randn(n, N_FEATURES).astype(np.float32)
                      for n in (240, 1, 17, 64, 128, 199, 5, 96)]
            waves_before = service.stats()["waves_total"]
            reset_enc()
            with concurrent.futures.ThreadPoolExecutor(len(slates)) as pool:
                futs = [pool.submit(post, url, sl, i % 2 == 1)
                        for i, sl in enumerate(slates)]
                answers = [f.result(timeout=120) for f in futs]
            service_counts = enc_counts()
            waves = service.stats()["waves_total"] - waves_before
            assert waves >= 1 and service_counts == (
                waves, 0, 0, 0, 0, 0, 0, 0), (waves, service_counts)
            for sl, got in zip(slates, answers):
                xb29 = np.zeros((1, L, N_FEATURES), dtype=np.float32)
                xb29[0, :len(sl)] = sl
                want = direct29(xb29, [len(sl)]).cpu().numpy()[0, :len(sl)]
                assert got.shape == (len(sl),) and np.isfinite(got).all()
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        finally:
            server.shutdown()
            server.server_close()
            service.close()
        server_thread.join(timeout=10)
        enc_service_launches = service_counts[0]
        print(f"B10 service: {len(slates)} concurrent requests in {waves} "
              f"waves, {enc_service_launches} B10 launches, none of B1 or "
              f"B2; answers equal the direct scorer")

        cfg29, model29 = paper_setup(dev)
        batch29 = train_batch(dev)  # phase 9's batch; later phases reuse xb
        step29 = make_step(cfg29, model29, cfg29.training.compute_dtype)
        reset_enc()
        losses29 = []
        for i in range(20):
            before = enc_counts()
            loss, _ = step29(*batch29)
            losses29.append(loss.item())
            got = tuple(a - c for a, c in zip(enc_counts(), before))
            assert got == (1, 1, 0, 0, 0, 0, 1, 1), f"step {i} {got}"
            assert math.isfinite(losses29[-1]), losses29
        enc_train = dict(zip((k.__name__ for k in enc_kernels),
                             enc_counts()))
        first = statistics.mean(losses29[:5])
        last = statistics.mean(losses29[-5:])
        assert last < first, f"B10 step loss did not fall: {first} -> {last}"
        print(f"B10 train step, paper config (dropout 0.3, bf16), B={B} "
              f"L={L}: 20 steps, loss mean of the first 5 {first:.3f}, of "
              f"the last 5 {last:.3f}; launches {enc_train}")
        gl, cl, worst29, flips29 = step_one_gpu_vs_cpu(
            cfg0, paper_setup(dev, dropout=0.0)[1], batch29, gate_flips=True)
        print(f"B10 train step 1 at dropout 0, fp32, GPU vs CPU plain: loss "
              f"{gl:.6f} vs {cl:.6f}; worst gradient error {worst29:.3f} of "
              f"its tolerance, FFN units with a ReLU gate flipped between "
              f"the two held out per block {flips29} (at most "
              f"{GATE_FLIPS_MAX})")
    finally:
        transformer_mod.MEGA_ENCODER_ENABLED = False
    print("phase 29 ok: with the switch on, the scorer, the service and the "
          "paper-config train step run through B10 alone and match")

    # -- 30: times of B10, its yardsticks, and the switch's A/B -------------
    eb, el, ed, eh, eff, en = ENCODER_CASES[0]
    for direction in ("fwd", "bwd"):
        row = {"name": f"encoder_block_{direction}", "route": "cuda"}
        for dtype in (torch.float32, torch.bfloat16):
            x30, dy30, mask30, seeds30, stacks, fs, fb = encoder_inputs(
                gen, eb, el, ed, eh, eff, en, dtype, dev)
            args30 = (x30, mask30, seeds30, stacks, fs, fb)
            kw = dict(h=eh, p_drop=0.0)
            lib = encoder_library(x30, mask30, stacks, fs, fb, dy30, eh)
            way30 = b1_route(dtype, ed, eh)
            _, state = encoder_chained_fwd(*args30, eh, 0.0, way30)
            if direction == "fwd":
                fns = (lambda: encoder_block_fwd(*args30, **kw),
                       lambda: encoder_forward_plain(*args30, **kw), lib[0],
                       lambda: encoder_chained_fwd(*args30, eh, 0.0, way30))
            else:
                fns = (lambda: encoder_block_bwd(*args30, dy30, **kw),
                       lambda: encoder_backward_plain(*args30, dy30, **kw),
                       lib[1],
                       lambda: encoder_chained_bwd(state, mask30, seeds30,
                                                   stacks, fs, dy30, eh, 0.0))
            ms, plain_ms, lib_ms, chained_ms = (
                median_ms(fn, iters=10, warmup=2) for fn in fns)
            by_name = profile_calls(
                fns[0], f"encoder_block_{direction} {dtype} {tag}",
                also=("encoder_",))
            dev_ms = sum(us for kname, us in by_name.items()
                         if "encoder_" in kname) / 1e3 or None
            flops, moved = encoder_work(eb, el, ed, eh, eff, en, dtype,
                                        direction == "bwd")
            bound_ms, bound_by = bound(flops, moved, dtype)
            sfx = "" if dtype == torch.float32 else "_bf16"
            errs28 = [v for key, v in enc_errs.items() if key[4] == dtype]
            err = max(v[f"{direction}_plain"] for v in errs28)
            err_chained = max(v[f"{direction}_chained"] for v in errs28)
            row.update({f"max_abs_err{sfx}": err,
                        f"max_abs_err_vs_chained{sfx}": err_chained,
                        f"ms{sfx}": ms, f"device_ms{sfx}": dev_ms,
                        f"plain_ms{sfx}": plain_ms,
                        f"bound_ms{sfx}": bound_ms,
                        f"bound_by{sfx}": bound_by,
                        f"library_ms{sfx}": lib_ms,
                        f"chained_ms{sfx}": chained_ms,
                        f"gflop{sfx}": flops / 1e9,
                        f"mbytes{sfx}": moved / 1e6})
            print(f"time encoder_block_{direction} {dtype} B={eb} L={el} "
                  f"d={ed} h={eh} d_ff={eff} N={en}: kernel {ms:.4f} ms "
                  f"({dev_ms if dev_ms is None else round(dev_ms, 4)} ms of "
                  f"device time), the chained B1/B2 kernels {chained_ms:.4f} "
                  f"ms, plain {plain_ms:.4f} ms, library (std-LN, matmul, "
                  f"scaled_dot_product_attention, relu"
                  f"{', autograd' if direction == 'bwd' else ''}) "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB) {tag}")
            del x30, dy30, stacks, lib, state, fns
        rows.append(row)
    torch.cuda.empty_cache()

    # the A/B: off, on, on, off in turns, on one card
    ab = {}
    xd = torch.as_tensor(x29, device=dev)
    ld = torch.as_tensor(len29, device=dev)
    ab_cases = (
        ("train step, bench.py config (flagship, dropout 0, bf16)",
         (cfg, flagship_model(dev))),
        ("train step, paper config (dropout 0.3, bf16)", paper_setup(dev)))
    for label, (cfg_t, model_t) in ab_cases:
        step_t = make_step(cfg_t, model_t, "bfloat16", optimizer_name="Adam",
                           lr=1e-3)
        ab[label] = (lambda step_t=step_t: step_t(*batch29), B)
    ab["scorer fp32, flagship"] = (
        lambda s=make_scorer(emodel, "float32"): s(xd, ld), B)
    ab["scorer bf16, flagship"] = (
        lambda s=make_scorer(emodel, "bfloat16"): s(xd, ld), B)
    ab_ms = {}
    for label, (fn, _) in ab.items():
        times = {"off": [], "on": []}
        try:
            for switch in ("off", "on", "on", "off"):
                transformer_mod.MEGA_ENCODER_ENABLED = switch == "on"
                times[switch].append(median_ms(fn, iters=20, warmup=3))
            for switch in ("off", "on"):
                transformer_mod.MEGA_ENCODER_ENABLED = switch == "on"
                profile_calls(fn, f"{label}, switch {switch} {tag}",
                              also=("encoder_",))
        finally:
            transformer_mod.MEGA_ENCODER_ENABLED = False
        ab_ms[label] = {k: statistics.mean(v) for k, v in times.items()}
        print(f"time A/B {label} B={B} L={L}: switch off "
              f"{times['off']} ms, on {times['on']} ms (turns off, on, on, "
              f"off) {tag}")

    # -- 31: X2, the boundary-shift kernels -----------------------------------
    from allrank_tpu_torch.ops.boundary_shift import (
        boundary_plain,
        boundary_plain_plain,
        boundary_shift,
        boundary_shift_plain,
    )
    from allrank_tpu_torch.tools import exp_boundary_shift as x2_tool

    t31 = time.perf_counter()
    tol16 = KERNEL_TOL[torch.bfloat16]
    x2_errs = {"boundary_plain": 0.0, "boundary_shift": 0.0}
    for b, l in ((B, L), (3, 37), (1, 1)):
        x, pre, w1, w2, w1n = x2_inputs(gen, b, l, dev)
        before = (boundary_plain.launches, boundary_shift.launches)
        y = boundary_plain(x, w1, w2)
        out, pre_out = boundary_shift(x, pre, w2, w1n)
        torch.cuda.synchronize()
        assert (boundary_plain.launches, boundary_shift.launches) == (
            before[0] + 1, before[1] + 1), "X2 did not launch"
        pairs = {"boundary_plain": [(y, boundary_plain_plain(x, w1, w2))],
                 "boundary_shift": list(zip(
                     (out, pre_out), boundary_shift_plain(x, pre, w2, w1n)))}
        case_errs = {}
        for name, got_ref in pairs.items():
            for got, ref in got_ref:
                assert got.shape == ref.shape and got.dtype == ref.dtype
                assert torch.isfinite(got.float()).all(), name
                torch.testing.assert_close(got.float(), ref.float(), **tol16)
                case_errs[name] = max(case_errs.get(name, 0.0), rel_err(
                    got.float(), ref.float())[0])
                x2_errs[name] = max(x2_errs[name], case_errs[name])
        print(f"X2 vs plain B={b} L={l} d=128 d3=384 bf16: max_abs_err plain "
              f"{case_errs['boundary_plain']:.3e}, shifted (out and pre_out) "
              f"{case_errs['boundary_shift']:.3e} (tol {tol16})")
    # the probe's own run at its default shape: the launches of its path
    boundary_plain.launches = boundary_shift.launches = 0
    x2_res = x2_tool.main([])
    x2_launches = {"boundary_plain": boundary_plain.launches,
                   "boundary_shift": boundary_shift.launches}
    print(f"X2 probe launches {x2_launches}; per-boundary tax (us): "
          + ", ".join(f"{m} plain {r['tax_plain_us']:.2f} shifted "
                      f"{r['tax_shift_us']:.2f}" for m, r in x2_res.items())
          + f" {tag}")
    x, pre, w1, w2, w1n = x2_inputs(gen, B, L, dev)
    m2 = B * L
    for name, fns, moved in (
            ("boundary_plain",
             (lambda: boundary_plain(x, w1, w2),
              lambda: boundary_plain_plain(x, w1, w2),
              lambda: x2_library(x, pre, w1, w2, False)),
             2 * nbytes(x) + nbytes(w1, w2)),
            ("boundary_shift",
             (lambda: boundary_shift(x, pre, w2, w1n),
              lambda: boundary_shift_plain(x, pre, w2, w1n),
              lambda: x2_library(x, pre, w1n, w2, True)),
             2 * nbytes(x, pre) + nbytes(w1n, w2))):
        flops = 2 * 2 * m2 * 128 * 384
        ms = graph_ms(fns[0])
        plain_ms, lib_ms = (median_ms(fn, iters=20) for fn in fns[1:])
        bound_ms, bound_by = bound(flops, moved, torch.bfloat16)
        rows.append({"name": name, "route": "cuda",
                     "max_abs_err": x2_errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms,
                     "gflop": flops / 1e9, "mbytes": moved / 1e6,
                     "probe": x2_res})
        print(f"time {name} bf16 B={B} L={L} d=128 d3=384: kernel {ms:.4f} "
              f"ms of device time (20 calls in one CUDA graph), plain "
              f"{plain_ms:.4f} ms, library (std-LN ops, bf16 torch.matmul, "
              f"relu) {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
              f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB) {tag}")
    del x, pre, w1, w2, w1n
    print(f"phase 31 ok: X2 matches its plain versions; the boundary probe "
          f"ran ({time.perf_counter() - t31:.1f} s)")

    # -- 32: X3, the attention variants ---------------------------------------
    from allrank_tpu_torch.ops.attention_variants import (
        MODES,
        attention_variant_fwd,
        attention_variant_fwd_plain,
    )
    from allrank_tpu_torch.ops.attention_block import (
        launch_fwd as b1_launch_fwd,
    )
    from allrank_tpu_torch.tools import exp_attn_decompose as x3_tool

    t32 = time.perf_counter()
    d3h = (128, 4)
    args32 = attn_inputs(gen, B, L, d3h[0], torch.bfloat16, dev)
    x0_32, mask0_32, plist32 = x3_tool.inputs(B, L, dev)
    x3_errs = dict.fromkeys(MODES, 0.0)
    x3_scaled_err = None  # no_softmax on ragged keys, held to its scale
    for mode in MODES:
        # the probe's own inputs (no padded key), then ragged keys with one
        # empty slate
        for label, args in (("the probe's inputs", [x0_32, mask0_32]
                             + list(plist32[0])),
                            ("ragged keys, one empty slate", args32)):
            before = attention_variant_fwd.launches[mode]
            y = attention_variant_fwd(*args, d3h[1], mode=mode)
            torch.cuda.synchronize()
            assert attention_variant_fwd.launches[mode] == before + 1, mode
            ref = attention_variant_fwd_plain(*args, d3h[1], mode=mode)
            assert y.dtype == ref.dtype and y.shape == ref.shape
            assert torch.isfinite(y.float()).all(), mode
            err, scale = rel_err(y, ref)
            if mode == "no_softmax" and args is args32:
                # padded keys enter P.V with weight -1e9 x 0.001: ctx
                # reaches 1e6-1e7 and the out-projection's sums cancel, so
                # a one-ulp flip of a bf16 ctx value moves y by up to an ulp
                # of that scale; held relative to the output's largest value
                assert err <= tol16["rtol"] * scale, (mode, err, scale)
                msg = f" (tol {tol16['rtol']:g} x max|ref| {scale:.3e})"
                x3_scaled_err = (err, scale)
            else:
                torch.testing.assert_close(y.float(), ref.float(), **tol16)
                msg = f" (tol {tol16})"
                x3_errs[mode] = max(x3_errs[mode], err)
            if mode == "full":
                # B1's SIMT body, bit for bit; B1's bf16 route within tol16
                assert torch.equal(y, b1_launch_fwd("simt", *args, d3h[1])), (
                    "X3 full is not B1's SIMT forward")
                b1_y = attention_sublayer_fwd(*args, d3h[1])
                torch.testing.assert_close(y.float(), b1_y.float(), **tol16)
                msg += (f"; equal to B1's SIMT forward bit for bit, within "
                        f"{tol16} of B1's tensor-core forward (max_abs_err "
                        f"{rel_err(y, b1_y)[0]:.3e})")
            print(f"X3 [{mode}] vs plain B={B} L={L} d=128 h=4 bf16 "
                  f"({label}): max_abs_err {err:.3e}{msg}")
    attention_variant_fwd.launches = dict.fromkeys(MODES, 0)
    attention_sublayer_fwd.launches = attention_sublayer_bwd.launches = 0
    x3_res = x3_tool.main([])
    x3_launches = dict(attention_variant_fwd.launches)
    assert attention_sublayer_fwd.launches and attention_sublayer_bwd.launches
    print(f"X3 probe launches {x3_launches}; stages (us) "
          f"{json.dumps(x3_res['stages_us'])} {tag}")
    xx, mask32 = args32[:2]
    lib_args32 = [xx, torch.zeros(B, 1, 1, L, dtype=xx.dtype,
                                  device=dev).masked_fill(
        mask32[:, None, None, :], -1e9)] + [
        p.to(torch.bfloat16) for p in args32[2:]] + [d3h[1]]
    for mode in MODES:
        ms = graph_ms(lambda m=mode: attention_variant_fwd(*args32, d3h[1],
                                                           mode=m))
        plain_ms = median_ms(lambda m=mode: attention_variant_fwd_plain(
            *args32, d3h[1], mode=m), iters=20)
        lib_ms = (median_ms(lambda: b1_library(*lib_args32), iters=20)
                  if mode == "full" else None)
        flops, moved = x3_work(B, L, d3h[0], d3h[1], mode)
        bound_ms, bound_by = bound(flops, moved, torch.bfloat16)
        row = {"name": f"attention_variant_{mode}", "route": "cuda",
               "max_abs_err": x3_errs[mode], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms, "gflop": flops / 1e9,
               "mbytes": moved / 1e6,
               "probe_us": x3_res["modes_us"][mode]}
        if lib_ms is None:
            row["library_note"] = ("none: the mode changes a stage on "
                                   "purpose, no library call computes it")
        if mode == "no_softmax":
            row["max_abs_err_ragged_keys"], row["max_abs_ref_ragged_keys"] = (
                x3_scaled_err)
        rows.append(row)
        print(f"time attention_variant_{mode} bf16 B={B} L={L} d=128 h=4: "
              f"kernel {ms:.4f} ms of device time (20 calls in one CUDA "
              f"graph), plain {plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
              f"{moved / 1e6:.2f} MB) {tag}")
    del args32, lib_args32, xx, mask32
    print(f"phase 32 ok: X3 matches its plain versions in all six modes and "
          f"B1 in full; the decomposition probe ran "
          f"({time.perf_counter() - t32:.1f} s)")

    # -- 33: X4, the soft-sort with its records on chip -----------------------
    from allrank_tpu_torch.ops.neuralsort_layout import (
        layout_soft_sort_bwd,
        layout_soft_sort_fwd,
        layout_vectors,
        max_length,
        smem_floats,
    )
    from allrank_tpu_torch.tools import exp_sinkhorn_layout as x4_tool

    t33 = time.perf_counter()
    T = SINKHORN_ITERS
    for backward in (False, True):
        assert layout_vectors(T, backward) == smem_floats(1, T, backward)
    x4_errs = {"layout_soft_sort_fwd": 0.0, "layout_soft_sort_bwd": 0.0}
    s0, pad0, vec0 = x4_tool.inputs(2048, L, dev)
    cases33 = [("the probe's case", 2048, False,
                (s0, pad0, vec0, torch.randn(2048, L, generator=gen).to(dev)))]
    for n, transpose in ((B, False), (B, True), (1, False)):
        cases33.append((f"ragged{', fully padded' if n == 1 else ''}", n,
                        transpose, soft_sort_inputs(gen, n, L, dev)))
    for label, n, transpose, (sc, pad, vec, dout) in cases33:
        before = (layout_soft_sort_fwd.launches, layout_soft_sort_bwd.launches)
        out, a_hist, b_hist = layout_soft_sort_fwd(sc, pad, vec, 1.0, T,
                                                   transpose)
        ds = layout_soft_sort_bwd(sc, pad, vec, a_hist, b_hist, dout, 1.0, T,
                                  transpose)
        torch.cuda.synchronize()
        assert (layout_soft_sort_fwd.launches,
                layout_soft_sort_bwd.launches) == (
            before[0] + 1, before[1] + 1), "X4 did not launch"
        b8 = soft_sort_fwd(sc, pad, vec, 1.0, T, transpose)
        b8_ds = soft_sort_bwd(sc, pad, vec, *b8[1:], dout, 1.0, T, transpose)
        vs_b8 = max((g - w).abs().max().item()
                    for g, w in zip((out, a_hist, b_hist, ds), b8 + (b8_ds,)))
        ref, ref_a, ref_b = soft_sort_fwd_plain(sc, pad, vec, 1.0, T,
                                                transpose)
        assert torch.isfinite(out).all() and torch.isfinite(ds).all()
        torch.testing.assert_close(out, ref, **SOFT_TOL)
        torch.testing.assert_close(a_hist, ref_a, rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(b_hist, ref_b, rtol=1e-3, atol=1e-6)
        ref_ds = soft_sort_bwd_plain(sc, pad, vec, a_hist, b_hist, dout, 1.0,
                                     T, transpose)
        g_err = assert_grad_close(ds, ref_ds, f"X4 ds N={n}")
        assert not ds[pad > 0.5].any(), "a padded document's gradient"
        f_err = rel_err(out, ref)[0]
        x4_errs["layout_soft_sort_fwd"] = max(
            x4_errs["layout_soft_sort_fwd"], f_err)
        x4_errs["layout_soft_sort_bwd"] = max(
            x4_errs["layout_soft_sort_bwd"], g_err)
        print(f"X4 vs plain N={n} L={L} ({label}) transpose={transpose}: "
              f"max_abs_err out {f_err:.3e} (tol {SOFT_TOL}), ds {g_err:.3e} "
              f"of max|ref| {rel_err(ds, ref_ds)[1]:.3e} (tol "
              f"{SOFT_GRAD_TOL[0]:g} x); max |X4 - B8| over out, a_hist, "
              f"b_hist and ds {vs_b8:.3e}")
        del ref, ref_a, ref_b, ref_ds, b8, b8_ds
    too_long = torch.zeros(2, max_length(T) + 1, device=dev)
    before = layout_soft_sort_fwd.launches
    try:
        layout_soft_sort_fwd(too_long, too_long, too_long, 1.0, T)
        raise AssertionError("X4 took a slate past its cap")
    except ValueError as e:
        assert layout_soft_sort_fwd.launches == before
        print(f"X4 refuses L={too_long.shape[1]}: {e}")
    layout_soft_sort_fwd.launches = layout_soft_sort_bwd.launches = 0
    x4_res = x4_tool.main([])
    x4_launches = {"layout_soft_sort_fwd": layout_soft_sort_fwd.launches,
                   "layout_soft_sort_bwd": layout_soft_sort_bwd.launches}
    assert x4_res["max_abs_out"] == 0.0 and x4_res["max_abs_grad"] == 0.0
    print(f"X4 probe launches {x4_launches}; X4 / B8 time "
          f"{x4_res['ratio_fwd']:.4f} forward, {x4_res['ratio_fwd_bwd']:.4f} "
          f"forward + backward at N=2048 L={L} {tag}")
    sc, pad, vec, dout = soft_sort_inputs(gen, B, L, dev)
    _, a_hist, b_hist = layout_soft_sort_fwd(sc, pad, vec, 1.0, T, False)
    lib = soft_sort_library(sc, pad, vec, False)
    hist_bytes = 2 * (T + 1) * 4
    for name, fns, b8_fn, lib_fn, flops, moved in (
            ("layout_soft_sort_fwd",
             (lambda: layout_soft_sort_fwd(sc, pad, vec, 1.0, T, False),
              lambda: soft_sort_fwd_plain(sc, pad, vec, 1.0, T, False)),
             lambda: soft_sort_fwd(sc, pad, vec, 1.0, T, False), lib[0],
             B * (4 * T + 14) * L * L, B * L * (3 * 4 + 4 + hist_bytes)),
            ("layout_soft_sort_bwd",
             (lambda: layout_soft_sort_bwd(sc, pad, vec, a_hist, b_hist, dout,
                                           1.0, T, False),
              lambda: soft_sort_bwd_plain(sc, pad, vec, a_hist, b_hist, dout,
                                          1.0, T, False)),
             lambda: soft_sort_bwd(sc, pad, vec, a_hist, b_hist, dout, 1.0,
                                   T, False), lib[1],
             B * (8 * T + 31) * L * L, B * L * (4 * 4 + 4 + hist_bytes))):
        ms, b8_ms = graph_ms(fns[0]), graph_ms(b8_fn)
        plain_ms, lib_ms = (median_ms(fn, iters=10, warmup=2)
                            for fn in (fns[1], lib_fn))
        bound_ms, bound_by = bound(flops, moved, torch.float32)
        rows.append({"name": name, "route": "cuda",
                     "max_abs_err": x4_errs[name], "ms": ms,
                     "b8_ms": b8_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "gflop": flops / 1e9,
                     "mbytes": moved / 1e6, "probe": x4_res})
        print(f"time {name} float32 N={B} L={L}: kernel {ms:.4f} ms of "
              f"device time (20 calls in one CUDA graph), B8 {b8_ms:.4f} ms "
              f"likewise, plain {plain_ms:.4f} ms, library (torch-op chain"
              f"{', autograd' if name.endswith('bwd') else ''}) "
              f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
              f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.3f} MB) {tag}")
    del sc, pad, vec, dout, a_hist, b_hist, lib, s0, pad0, vec0, cases33
    torch.cuda.empty_cache()
    print(f"phase 33 ok: X4 is B8 bit for bit and matches the plain version; "
          f"the layout probe ran ({time.perf_counter() - t33:.1f} s)")

    # -- 34: the record -------------------------------------------------------
    origin = {"attention_sublayer_fwd": (
        "allrank_tpu_torch/csrc/attention_block.cu",
        "allrank_tpu/ops/attention_block.py:343"),
        "ffn_sublayer_fwd": ("allrank_tpu_torch/csrc/ffn_block.cu",
                             "allrank_tpu/ops/ffn_block.py:204"),
        "attention_sublayer_bwd": ("allrank_tpu_torch/csrc/attention_block.cu",
                                   "allrank_tpu/ops/attention_block.py:375"),
        "attention_sublayer_fwd_mma": (
            "allrank_tpu_torch/csrc/attention_block_mma.cu",
            "allrank_tpu/ops/attention_block.py:343"),
        "attention_sublayer_bwd_mma": (
            "allrank_tpu_torch/csrc/attention_block_mma.cu",
            "allrank_tpu/ops/attention_block.py:375"),
        "ffn_sublayer_bwd": ("allrank_tpu_torch/csrc/ffn_block.cu",
                             "allrank_tpu/ops/ffn_block.py:233"),
        "ffn_sublayer_fwd_mma": ("allrank_tpu_torch/csrc/ffn_block_mma.cu",
                                 "allrank_tpu/ops/ffn_block.py:204"),
        "ffn_sublayer_bwd_mma": ("allrank_tpu_torch/csrc/ffn_block_mma.cu",
                                 "allrank_tpu/ops/ffn_block.py:233"),
        "lambda_pairs_fwd": ("allrank_tpu_torch/csrc/lambda_pairs.cu",
                             "allrank_tpu/ops/lambda_pallas.py:174"),
        "lambda_pairs_bwd": ("allrank_tpu_torch/csrc/lambda_pairs.cu",
                             "allrank_tpu/ops/lambda_pallas.py:197"),
        "soft_sort_fwd": ("allrank_tpu_torch/csrc/neuralsort.cu",
                          "allrank_tpu/ops/neuralsort_pallas.py:186"),
        "soft_sort_bwd": ("allrank_tpu_torch/csrc/neuralsort.cu",
                          "allrank_tpu/ops/neuralsort_pallas.py:214"),
        "sinkhorn_fwd": ("allrank_tpu_torch/csrc/sinkhorn.cu",
                         "allrank_tpu/ops/sinkhorn_pallas.py:286"),
        "sinkhorn_bwd": ("allrank_tpu_torch/csrc/sinkhorn.cu",
                         "allrank_tpu/ops/sinkhorn_pallas.py:325"),
        "approx_pos_fwd": ("allrank_tpu_torch/csrc/approx_pos.cu",
                           "allrank_tpu/ops/approx_pallas.py:79"),
        "approx_pos_bwd": ("allrank_tpu_torch/csrc/approx_pos.cu",
                           "allrank_tpu/ops/approx_pallas.py:94"),
        "lambda_tiled_fwd": ("allrank_tpu_torch/csrc/lambda_tiled.cu",
                             "allrank_tpu/ops/lambda_tiled.py:237"),
        "lambda_tiled_bwd": ("allrank_tpu_torch/csrc/lambda_tiled.cu",
                             "allrank_tpu/ops/lambda_tiled.py:261"),
        "attention_fused_fwd": ("allrank_tpu_torch/csrc/attention_fused.cu",
                                "allrank_tpu/ops/attention_pallas.py:179"),
        "attention_fused_bwd": ("allrank_tpu_torch/csrc/attention_fused.cu",
                                "allrank_tpu/ops/attention_pallas.py:206"),
        "tiled_attention_fwd": ("allrank_tpu_torch/csrc/attention_tiled.cu",
                                "allrank_tpu/ops/attention_tiled.py:228"),
        "tiled_attention_bwd": ("allrank_tpu_torch/csrc/attention_tiled.cu",
                                "allrank_tpu/ops/attention_tiled.py:265"),
        "q8_dense": ("allrank_tpu_torch/csrc/q8_dense.cu",
                     "tools/exp_int8_matmul_kernel.py:50"),
        "encoder_block_fwd": ("allrank_tpu_torch/csrc/encoder_block.cu",
                              "allrank_tpu/ops/encoder_block.py:302"),
        "encoder_block_bwd": ("allrank_tpu_torch/csrc/encoder_block.cu",
                              "allrank_tpu/ops/encoder_block.py:333"),
        "boundary_plain": ("allrank_tpu_torch/csrc/boundary_shift.cu",
                           "tools/exp_boundary_shift.py:95"),
        "boundary_shift": ("allrank_tpu_torch/csrc/boundary_shift.cu",
                           "tools/exp_boundary_shift.py:102"),
        "layout_soft_sort_fwd": ("allrank_tpu_torch/csrc/neuralsort_layout.cu",
                                 "tools/exp_sinkhorn_layout.py:205"),
        "layout_soft_sort_bwd": ("allrank_tpu_torch/csrc/neuralsort_layout.cu",
                                 "tools/exp_sinkhorn_layout.py:231")}
    for mode in MODES:
        origin[f"attention_variant_{mode}"] = (
            "allrank_tpu_torch/csrc/attention_variants.cu",
            "tools/exp_attn_decompose.py:126")
    # each kernel's own main path: serving (phase 5) for the sublayer
    # forwards, the train step (phase 9) for their backwards and the pair
    # chain, the CLI's NeuralNDCG run (phase 13) for the fused soft-sort, its
    # long-slate step for the Sinkhorn kernel, the CLI's approxNDCG run
    # (phase 17) for the rank sum, the long-slate lambdaLoss steps (phase
    # 19) for the row-tiled pair chain
    launches = {**train_launches, **main_launches,
                "soft_sort_fwd": cli_launches["soft_sort_fwd"],
                "soft_sort_bwd": cli_launches["soft_sort_bwd"],
                "sinkhorn_fwd": b7_launches["sinkhorn_fwd"],
                "sinkhorn_bwd": b7_launches["sinkhorn_bwd"],
                "approx_pos_fwd":
                recipe_launches["approxndcg"]["approx_pos_fwd"],
                "approx_pos_bwd":
                recipe_launches["approxndcg"]["approx_pos_bwd"],
                "lambda_tiled_fwd": long_launches["lambda_tiled_fwd"],
                "lambda_tiled_bwd": long_launches["lambda_tiled_bwd"]}
    # B1 and B2 by route: the fp32 service (phase 5) runs the SIMT forwards
    # and the fp32 step 1 against the CPU (phase 9) their backwards; the
    # bf16 train steps (phase 9) run the tensor-core kernels both ways
    for sub, fp32_routes, train_routes in (
            ("attention_sublayer", b1_fp32_routes, b1_train_routes),
            ("ffn_sublayer", b2_fp32_routes, b2_train_routes)):
        launches[f"{sub}_bwd"] = fp32_routes[1]["simt"]
        launches[f"{sub}_fwd_mma"] = train_routes[0]["mma"]
        launches[f"{sub}_bwd_mma"] = train_routes[1]["mma"]
    # X1: the int8_static service (phase 26)
    launches["q8_dense"] = q8_main_launches["q8_dense"]
    # B10: with the switch on, its service (forward) and its 20 train steps
    # (backward) (phase 29)
    launches["encoder_block_fwd"] = enc_service_launches
    launches["encoder_block_bwd"] = enc_train["encoder_block_bwd"]
    # X2, X3 and X4: their probes' own runs (phases 31-33)
    launches.update(x2_launches)
    launches.update({f"attention_variant_{m}": n
                     for m, n in x3_launches.items()})
    launches.update(x4_launches)
    # B4 and B5: their own long-slate steps (phase 23)
    for (b, l), (got, _, _) in long_runs.items():
        for name, n in got.items():
            if n and ("attention_fused" in name or "tiled_attention" in name):
                launches[name] = n
    # B4's and B5's launches by route: bf16 ("mma") in their long-slate
    # steps (phase 23), fp32 ("tf32x3") in the fp32 scorer at L=8192 (phase
    # 22) and the fp32 step 1 against the CPU (phase 23)
    for row in rows:
        name = row["name"]
        if name in f32_step_routes:
            row["launches_mma"] = launches[name]
            row["launches_tf32x3"] = f32_step_routes[name] + (
                serve_routes["fp32"]["tf32x3"]
                if name == "tiled_attention_fwd" else 0)
            assert row["launches_tf32x3"] > 0, name
    # B4's and B5's forward errors also cover the int8 tower's calls (phase
    # 26: bf16, p = 0, at B=64, L=240 and B=4, L=4096)
    for row in rows:
        if row["name"] in q8_attn_errs:
            err = q8_attn_errs[row["name"]]
            row["max_abs_err_q8_path"] = err
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["max_abs_err_bf16"] = max(row["max_abs_err_bf16"], err)
    for row in rows:
        name = row["name"]
        row["source"], row["replaces"] = origin[name]
        row["launches"] = launches[name]
        row["train_launches"] = train_launches.get(name,
                                                   enc_train.get(name, 0))
        row["cli_launches"] = (cli_launches.get(name, 0)
                               + paper_launches.get(name, 0)
                               + sum(r.get(name, 0)
                                     for r in recipe_launches.values()))
        assert row["launches"] > 0
        for k, v in row.items():
            assert not isinstance(v, float) or math.isfinite(v), (k, v)
    assert len(rows) == 35
    print(f"profiler: {trace_kernels.lost} traces of this run lost device "
          f"events and were taken again {tag}")
    print(f"train step ms {json.dumps(step_ms)} {tag}")
    print(f"A/B of MEGA_ENCODER_ENABLED, ms per step or call "
          f"{json.dumps(ab_ms)} {tag}")
    print(json.dumps({"kernels": rows}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
