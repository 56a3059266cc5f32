#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port, ``allrank_tpu_torch``.

Run from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and never prints its last line):

1. the card, torch and CUDA versions; ``g++ --version`` and the host C++
   libraries of ``allrank_tpu_torch/native`` (g++); builds every kernel source
   of ``allrank_tpu_torch/csrc`` with nvcc (one process per source, in
   parallel) and prints the seconds it took and each kernel's registers;
   counts the ``HMMA`` instructions of B4's and B5's bf16 kernels (18
   each) and fp32 kernels (18 each, 3xTF32: TF32 ``HMMA``; the two sources
   hold no other kernel), of B1's bf16 (22) and of B2's bf16 (5), and of
   B1's fp32 (23 ``b1_*_tf32x3_kernel``) and B2's fp32 (5
   ``b2_*_tf32x3_kernel``: TF32 ``HMMA`` only, none in the other kernels
   of their sources) with the toolkit's ``cuobjdump -sass`` (each must
   hold some), and of X2's (4) and X3's tensor-core kernels (7 a mode, 2
   in ``frame``: bf16 ``HMMA`` only; in the probes' class no spill beyond
   that of B1's own kernel, whose body X3 runs);
   turns TF32 off for PyTorch's own products;
2. the attention sublayer kernel (B1) against its plain PyTorch version at
   B=64, L=240 for (d, h) = (128, 4), (144, 2), (96, 1), with ragged
   lengths and one lengths=0 slate, in fp32 (its 3xTF32 kernels) and bf16
   (its tensor-core kernels), plus edge shapes (d_k 256 on the SIMT
   kernels); and in bf16 and fp32 at head widths 8, 20, 32, 36, 48, 72,
   100 and 128 x L in {1, 65, 240, 1024}, which runs each of its
   tensor-core forward instantiations of both dtypes;
3. the FFN sublayer kernel (B2) likewise, d_ff 512 and 384, in fp32 (its
   3xTF32 kernels) and bf16 (its tensor-core kernels); and in both at d
   in {32, 96, 128, 144, 256} x d_ff in {384, 512, 1024} x L in {1, 65,
   240, 1024}, which runs each of its tensor-core instantiations;
4. the flagship ranker (136 features, FC [128], 4 blocks of d=128, h=4,
   d_ff=512, random weights from a seeded ``torch.Generator``) through
   ``make_scorer``/``make_ranker`` on the GPU against the same model's
   plain run with ``device="cpu"``; bf16 against fp32;
5. ``SlateScoringService`` with buckets (1, 8, 64) behind ``run_server``
   on a free localhost port, answering concurrent JSON and ``.npy``
   requests, checked against direct scorer calls; this is the main path
   whose kernel launches are counted. The service replays one CUDA graph
   a bucket (``serving.aot_compile``), and a replay runs no Python: each
   graph's capture recorded B1's and B2's launches a call (4 + 4, 3xTF32
   route), the counters set to 0 just before the requests stay 0, the
   replays equal the waves, and a device trace of the waves
   (``timing.trace_kernels``) shows each of B1's and B2's 3xTF32 forward
   kernels 4 times a wave and no kernel of their other routes;
6. times (CUDA events after warm-up, medians; and as device time, 20
   calls in one CUDA graph): each kernel, its plain version and a PyTorch
   library yardstick at the flagship serving shape (B1 and B2 a row per
   route: fp32 on the 3xTF32 kernels with their bound beside the SIMT one,
   fp32 on the SIMT kernels by name, bf16 on the tensor cores),
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
   first: each of its 5 tensor-core kernels; the same cases in fp32, rows
   one element off a 16-byte boundary: each of B1's 23 and B2's 5 3xTF32
   kernels, at the unchanged fp32 tolerances. Every B2 backward is held
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
   CPU, B1 and B2 on their 3xTF32 routes;
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
    versions on both routes ("cluster", the main one: a slate's M0 on a
    thread-block cluster; "l2" by name) at N=8, L=640 and N=2, L=768 with a
    fully padded slate, a second run bit for bit; the planner against the
    kernel's own counts at every L;
13. the train CLI, the third main path: a dummy libsvm dataset of WEB30K's
    shape from a seed (136 features, 5 grades, 1,024 train and 256
    validation slates of 40-240 documents; the C++ writer), then
    ``allrank_tpu_torch.main.run`` on
    ``reproducibility/configs/neuralndcg_web30k/neuralndcg_atmax.json`` with
    only ``data.path``, ``training.epochs`` (2) and ``expected_metrics``
    changed; every epoch's loss finite, ``model.npz``,
    ``experiment_result.json`` and ``used_config.json`` written, ndcg@5 on
    validation reported, and the launches counted: B8 forward and backward
    once per train step, B8 forward once per evaluation batch, B1/B2 twice
    per step and per evaluation batch (two blocks). Then one epoch of
    ``ndcgloss2pp.json`` the same way (B3 launched), a NeuralNDCG train step
    at B=8, L=640 that launches B7 on its "cluster" route once each way, and
    step 1 of the NeuralNDCG model at dropout 0 in fp32 on the GPU against
    the CPU's plain run;
14. times: B7 by route and B8, their plain versions and a PyTorch
    formulation of the same chain (forward, and backward by autograd); the
    NeuralNDCG train step with its idle share; an epoch's train, evaluation
    and feed seconds;
15. the approxNDCG rank-sum kernels (B9, forward and backward) against
    their plain versions: B=64, L=240 ragged with one empty slate, L in
    {1, 37, 1308, 4096}, alpha in {0.1, 1, 10}, scores of +-1e4 (where
    t < eps takes the clamp's branch), tied scores; scattered masks (not a
    prefix) at B=64, L=240 (with a slate of one valid document and an
    empty one) and at N=2, L in {4097, 8192}; a rerun bit for bit;
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
    in exact arithmetic, the kernels' and the plain versions' exactly
    (ROADMAP Queue C6), and every gradient within tolerance of the plain
    version's; and the split attention block
    (PyTorch ops around B4 or B5) against the B1 sublayer at (64, 240) and
    (16, 1024), dropout 0.3, the same seeds;
22. long-slate serving: the paper config's model (no positional encoding)
    through ``make_scorer`` at B=4, L=8192, fp32 and bf16, ragged lengths
    and an empty slate, against its plain forward on the card; 4 launches
    each of B5 and B2 forward per call, none of B1 or B4, B5's on the route
    of the dtype (fp32 "tf32x3", bf16 "mma"); one 7,000-document
    request through ``SlateScoringService`` at ``slate_length=8192`` (a
    CUDA graph a bucket, each capturing B5 and B2 4 + 4 on their 3xTF32
    routes; one replay);
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
    answering JSON and ``.npy`` requests as direct scorer calls (each
    bucket's graph captured 18 X1 and 4 B4 launches; the counts set to 0
    just before stay 0, the replays equal the waves, and a device trace
    shows 18 X1 and 4 B4 kernels a wave); ``evaluate.run`` on
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
    none of B1 or B2), ``SlateScoringService`` behind ``run_server`` (each
    bucket's graph captured one B10 launch, the cooperative launch inside
    a CUDA graph; replays equal to the waves; a device trace shows one B10
    forward kernel a wave), and
    20 paper-config train steps (B10 1 + 1 launches a step, B1 and B2
    none, B3 1 + 1), step 1 at dropout 0 in fp32 against the CPU's
    plain run with ReLU gate flips held out (the counts set to 0 just
    before each run and read just after);
30. times: B10 forward and backward at the flagship (event-timed, device
    time, the bound, the plain version, the chained B1/B2 kernels and a
    library formulation); the A/B of the switch (off, on, on, off) on the
    train step at ``bench.py``'s configuration and the paper config and on
    the flagship scorer, with idle share and device time by kernel;
31. the boundary-shift kernels (X2, plain and shifted, on B2's tensor-core
    tiles) against their plain versions at B=64, L=240, at a ragged B=3,
    L=37 and at B=1, L=1 (bf16, d=128, d3=384), and at (d, d3) = (100,
    200) and (256, 1000); the plain kernel equal to B2's bf16 forward bit
    for bit at unit gain and zero biases; then the probe
    ``allrank_tpu_torch.tools.exp_boundary_shift`` at its default shape,
    in-process (its launches are the kernels' count): the per-boundary tax
    in one CUDA graph and eager; each kernel's device time, bound, plain
    version and library formulation as device time;
32. the attention variants (X3) in all six modes against their plain
    versions on B1's routes (``ops/attention_variants.route``): at B=64,
    L=240, d=128, h=4 (the probe's inputs; ragged keys and one empty
    slate), at each tensor-core head class (d_k 20, 32, 36, 48, 100, 128:
    rows on and off a 16-byte boundary) and at d_k 256 (the SIMT units),
    ragged and with no key padded; and on the SIMT kernels by name at d_k
    32; ``no_softmax`` element by element in slates with no padded key and
    row by row in the others (``no_softmax_close``); ``full`` equal to
    B1's forward bit for bit on the same route; ``no_pv`` and ``frame``
    with the plain version replaying the kernel's own qkv, that qkv held to
    the plain's (``X3_QKV_REPLAY``); launches counted by route;
    then the probe ``exp_attn_decompose`` (three interleaved rounds of K=8
    chains, the stage costs, the production B1 forward and backward
    K-swept) at its default shape, at B=16, L=1024 and at d=256, h=1;
    X3 full, B1 and B1's library at (16, 1024) as device time; each mode's
    times on both routes;
33. the soft-sort with its records on chip (X4, forward and backward: B8's
    route "cluster" with the records and the backward's U and V stacks in
    shared memory) against B8's route "cluster" (bit for bit) and the plain
    version at N=2048, L=240 with a 40-document tail (the probe's case), at
    N=64 ragged in both ``transpose`` values, at its cap and at one fully
    padded slate; the planner against the kernels' own counts; its refusal
    past its shared-memory cap; then the probe ``exp_sinkhorn_layout`` (B8's
    route "cluster" against X4, forward and forward + backward, 8 steps in
    one CUDA graph); times at N=64 beside B8's;
34. rank-and-click, the sixth main path: ``allrank_tpu_torch.rank_and_click``
    on phase 13's ``vali`` role (256 slates of 40-240 documents) with the
    ``ndcgloss2pp.json`` run's config and flagship ``model.npz``: (a) the
    materialising feed with ``DiverseClicksModel(BaseCascadeModel(eta=1,
    threshold=2), q_percentile=0.5)`` clicking on the card, (b) the same
    with ``data.device_cache`` (its ``vali.txt`` and CSVs byte-identical to
    (a)'s), (c) ``EverythingButDuplicatesClickModel`` on the host; each
    run launches B1 and B2 forward 4 + 4 times a ranking batch on their
    fp32 route and nothing else; the card's ranked order against the CPU
    plain run's (neighbour swaps within ``SCORE_TOL`` counted), every
    batch click model on the card's ranked slates on the card against the
    CPU, bit for bit (diverse but for slates holding a document within
    1e-5 of their margin); ``evaluate`` with ``data.device_cache`` against
    phase 26's float run within 1e-6; the seconds per call and a ranking
    batch's device time and idle share;
35. a deployer's path at the flagship width: a reference-layout
    ``state_dict`` from a seed (``torch.save``d as ``model.pkl``) converted
    by ``python -m allrank_tpu_torch.interop`` (its ``model.npz`` the
    in-process mapping bit for bit) and served by ``python -m
    allrank_tpu_torch.serve_http`` in a subprocess (bf16, buckets 1, 8,
    64, a CUDA graph each): concurrent requests within phase 4's bf16 rule
    of the in-process eager scorer on the same weights, lone requests (a
    wave of bucket 1) equal to it bit for bit; ``export_scorer`` ->
    ``load_scorer`` in bf16 and int8_static equal to ``aot_compile``'s
    graphed scorer and that to the eager scorer, bit for bit; eager
    against graphed in turns (eager, graph, graph, eager) per bucket (1,
    8, 64) x (fp32, bf16, int8_static): event-timed ms a call, device busy
    ms and idle share, the host->device copy of x apart, beside the card's
    name and power limit;
36. the host data path at WEB30K's shape: (a) a quarter of Fold1's
    queries (4,730 train, 1,577 vali; 136 features, grades at WEB30K's
    marginals, slate lengths drawn as ``tools/make_web30k_surrogate.py``
    draws them, the vali role holding a slate of 1,308) written by the
    C++ writer; (b) the C++ parser on both roles bit for bit the writer's
    arrays and the numpy parser's on vali, ``python -m
    allrank_tpu_torch.data.validate`` exiting 0 on both roles, the binary
    cache's memmap-direct miss and its hit bit for bit; (c) the train CLI
    on ``ndcgloss2pp.json`` with ``data.binary_cache``,
    ``data.device_cache``, 4 assembly threads and ``profiler_trace_dir``
    (one epoch): launches exact (B1 and B2 4 + 4 a step on "mma", B3
    1 + 1, the train set's evaluation likewise forward, the vali batches
    at L = 1,308 B5 and B2 4 forward and B6 1), the trace naming B1's,
    B2's and B3's kernels; (d) 5 paper steps over the bf16 store equal to
    the materialising feed's bit for bit; (e) the assembler's bytes at 1
    and 4 threads equal; (f) assembly slates/s (C++ at 1 and 4 threads,
    the Python row loop), the epoch's feed and train seconds with and
    without the store, the store's bytes, beside the card and the host's
    CPU;
37. a ``{"kernels": [...]}`` JSON line (B1 and B2 a row per route: the
    3xTF32 rows count the fp32 service's (its graphs' captured launches a
    wave times their replays), rank-and-click's and step's
    launches, the SIMT rows those of B10's reference chain in phase 28 and
    carry
    ``"launch_source": "b10_reference_chain"``; X3 a row per mode and
    route, the SIMT rows' launches those of the probe at d_k 256; B7 and B8
    a row per route, the "l2" rows' launches 0: no path runs them), the
    card's name and power limit as nvidia-smi reports them, and last
    ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import io
import json
import math
import os
import re
import shutil
import socket
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

from allrank_tpu_torch.tools.time_attention import library_fns, ptxas_lines
from allrank_tpu_torch.tools.time_sublayers import (
    chain_library,
    library_args,
    premasked_matrices,
    sinkhorn_library,
    soft_sort_library,
    x2_inputs,
    x2_library,
)
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
# B1's and B2's fp32 kernels (3xTF32 on the tensor cores): B1's attention
# core, dQ and dK/dV kernels at padded d_k 32, 64, 128, aligned or not, and
# LN + QKV, the out-projection, the backward's rows, dn + LN backward and
# the weight gradients; B2's forward and backward row kernel at d <= 128
# and d > 128, and the weight gradients
B1_F32_KERNELS, B2_F32_KERNELS = 23, 5
# B10's sources, one a dtype and head class (padded d_k 32, 64, 128; wider
# heads on B1's SIMT phases), and the kernels of each: forward and
# backward, each at d <= 128 and d > 128
B10_SOURCES = [f"encoder_block_{dt}_{cls}" for dt in ("bf16", "f32")
               for cls in ("dk32", "dk64", "dk128", "simt")]
B10_KERNELS = 2 * 2
# X2's cases (B, L, d, d3): the probe's widths at the flagship's rows,
# ragged and single rows; d and d3 off the tensor cores' 16 / 64 steps; the
# widest d (two warps a row group)
X2_CASES = [(B, L, 128, 384), (3, 37, 128, 384), (1, 1, 128, 384),
            (3, 37, 100, 200), (2, 50, 256, 1000), (1, 1, 256, 1000)]
# X3's tensor-core head classes (padded d_k 32, 64, 128), each with head
# rows on a 16-byte boundary (d_k 32, 48, 128) and off it (20, 36, 100)
X3_MMA_WIDTHS = [(128, 4), (80, 4), (96, 2), (144, 4), (256, 2), (100, 1)]
# X3's modes whose ctx carries q, k and v as they are, with no P.V to
# average them: a one-ulp flip of a v element between the kernel's LN + QKV
# and the plain version's moves y by ulp(v) x |Wout|, which can pass 2^-6 of
# a small y (one element of 2M in a 64-slate no_pv check on the card).
# Their checks hold qkv to the plain's and y to the plain version replaying
# the kernel's own qkv, both at the bf16 tolerance (ROADMAP Queue C5's way)
X3_QKV_REPLAY = ("no_pv", "frame")
# X3's tensor-core sources, one a mode (exp2 runs full's)
X3_MMA_SOURCES = [f"attention_variants_mma_{m}" for m in (
    "full", "no_softmax", "norm_after_pv", "no_pv", "frame")]
# the kernels of X2's and X3's tensor-core sources: X2's plain and shifted
# at d <= 128 and d > 128; each X3 mode's LN + QKV and attention tile at
# padded d_k 32, 64, 128, aligned or not (frame's one)
PROBE_MMA_KERNELS = {"boundary_shift_mma": 4,
                     **{src: 2 if src.endswith("_frame") else 7
                        for src in X3_MMA_SOURCES}}
# every kernel source, built in parallel in phase 1
SOURCES = ["attention_block", "attention_block_mma", "attention_block_tf32x3",
           "ffn_block", "ffn_block_mma", "ffn_block_tf32x3", "lambda_pairs",
           "sinkhorn", "sinkhorn_cluster", "neuralsort", "neuralsort_cluster",
           "approx_pos",
           "lambda_tiled",
           "attention_fused", "attention_tiled", "q8_dense", *B10_SOURCES,
           "boundary_shift_mma", "attention_variants", *X3_MMA_SOURCES,
           "neuralsort_layout"]
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
# a step-1 check's gate that the FFN kernel's own sums may take the other
# way: a CPU pre-activation within this share of the sum of its terms'
# magnitudes from 0; 16 times the worst rounding of a 256-term fp32 sum
# (256 x 2^-24), to cover the drift the blocks upstream carry in
FLIP_MARGIN = 2.0 ** -12
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
# ROADMAP Queue C4's case (B, L, d, h): B10 and the switch-off chain (B1
# and B2 on B10's routes, the tensor cores), each against the fp32 plain
# chain on the same inputs and masks; C4 is no fault if B10 is no farther
# from that reference than the chain (at most 1.5x)
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


_SASS: dict = {}


def sass_of(library: str) -> str:
    """The toolkit's ``cuobjdump -sass`` of a built library, run once a
    library (``prefetch_sass`` runs several at once)."""
    if library not in _SASS:
        tool = shutil.which("cuobjdump") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
            "cuobjdump")
        if not os.path.exists(tool):
            raise RuntimeError(f"no cuobjdump at {tool}: the tensor-core "
                               "check needs the toolkit's cuobjdump")
        _SASS[library] = subprocess.run(
            [tool, "-sass", library], capture_output=True, text=True,
            check=True, timeout=300).stdout
    return _SASS[library]


def prefetch_sass(libraries) -> None:
    """``sass_of`` of each library, the cuobjdump processes in parallel."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(sass_of, libraries))


def hmma_counts(library: str, marker: str,
                pattern: str = r"\bH(G)?MMA\b") -> dict:
    """The instructions matching ``pattern`` (by default ``HMMA`` and
    ``HGMMA``; ``TF32_HMMA`` the TF32 ones) in each kernel of a built
    library whose name holds ``marker``, from the toolkit's
    ``cuobjdump -sass``."""
    counts, name = {}, None
    for line in sass_of(library).splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1) if marker in found.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.search(pattern, line):
            counts[name] += 1
    return counts


# a TF32 tensor-core product in SASS, as HMMA.1688.F32.TF32; a bf16 one,
# as HMMA.16816.F32.BF16
TF32_HMMA = r"\bHMMA\.\S*\.TF32\b"
BF16_HMMA = r"\bHMMA\.\S*\.BF16\b"


def ptxas_properties(log: str) -> dict:
    """{function: its stack frame and spill line} of a ``-Xptxas=-v``
    build log, the anonymous namespace's tags left in the names."""
    with open(log) as f:
        lines = f.read().splitlines()
    return {m.group(1): lines[i + 1].strip()
            for i, line in enumerate(lines[:-1])
            for m in [re.search(r"Function properties for (\S+)", line)]
            if m}


def spill_bytes(line: str) -> int:
    """The spill stores and loads of a ``ptxas_properties`` line, bytes."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|"
                                          r"loads)", line))


def call_closure_counts(library: str, marker: str, patterns: dict) -> dict:
    """For each kernel of a built library whose name holds ``marker``, the
    instructions matching each of ``patterns`` ({key: regex}) in it and in
    the functions it may call, from the toolkit's ``cuobjdump -sass``. B10's
    phases are __noinline__ functions, and the dump names no call's target
    (``CALL.REL.NOINC 0x...``): a kernel is counted with every function of
    its source that is no kernel, one head class and dtype."""
    own, name = {}, None
    for line in sass_of(library).splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            own[name] = dict.fromkeys(patterns, 0)
        elif name:
            for key, pattern in patterns.items():
                own[name][key] += bool(re.search(pattern, line))
    helpers = [f for f in own if "_kernel" not in f]
    return {kernel: {key: own[kernel][key] + sum(own[f][key] for f in helpers)
                     for key in patterns}
            for kernel in own if marker in kernel}


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


# the flagship's model section as a config file holds it (phase 35)
FLAGSHIP_MODEL = {
    "fc_model": {"sizes": [128], "input_norm": True, "activation": "ReLU",
                 "dropout": 0.0},
    "transformer": {"N": 4, "d_ff": 512, "h": 4, "dropout": 0.0,
                    "positional_encoding": {"strategy": "fixed",
                                            "max_indices": 256}},
    "post_model": {"d_output": 1, "output_activation": None}}
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


def ffn_gates(model, batch, run, calls=None):
    """Runs ``run()`` with every FFN sublayer call of ``model``'s encoder
    recorded (with ``MEGA_ENCODER_ENABLED``, every B10 call, replayed:
    ``encoder_ffn_gates``): returns (run's result, per block the
    [rows, d_ff] bools of the hidden units' ReLU gates at the valid
    documents). A list ``calls`` gains, per sublayer call, its arguments
    and the gradient its backward takes (``"dy"``), for
    ``replay_kernel_flips``."""
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
        out = inner(x, ln_scale, ln_bias, w1, b1, *rest)
        if calls is not None and out.requires_grad:
            call = {"args": [t.detach() for t in (x, ln_scale, ln_bias, w1,
                                                  b1, *rest[:2])],
                    "rates": rest[2:]}
            calls.append(call)
            out.register_hook(lambda g: call.__setitem__("dy", g.detach()))
        return out

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

    With ``gate_flips`` it also returns, per block, the FFN hidden units
    whose ReLU gate flipped between the two runs at some valid document,
    as (held out, replayed); at most ``GATE_FLIPS_MAX`` a block. A gradient
    is not continuous at a gate. Where the recorded gates of the two runs'
    pre-activations differ (a flip carried in from upstream), the unit's
    FFN weights (columns of W1 and b1, rows of W2) are held out of the
    rule. Where they agree and the unit's b1 gradient breaks the rule, the
    flip can only lie inside the FFN kernel's own sums, whose order the
    recorded torch ops do not share: ``replay_kernel_flips`` must show it
    (pre-activations within ``FLIP_MARGIN`` of 0 on the CPU, and the
    plain backward with those gates flipped), and the unit's b1, W1 and W2
    gradients are then held to the rule against that replayed reference.
    The rest of every gradient, and every other gradient whole, stays under
    the rule."""
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    results, gates, calls = [], [], []
    for m, b in ((gpu_model, batch), (cpu_model, [t.cpu() for t in batch])):
        step = make_step(cfg, m, "float32", optimizer_name="SGD", lr=0.0,
                         loss=loss)
        if gate_flips:
            (value, _), g = ffn_gates(m, b, lambda: step(*b),
                                      calls if m is cpu_model else None)
            gates.append(g)
        else:
            value, _ = step(*b)
        results.append((value.item(), {n: p.grad.float().cpu()
                                       for n, p in m.named_parameters()}))
    (gl, gg), (cl, cg) = results
    assert math.isfinite(gl) and abs(gl - cl) <= STEP_LOSS_RTOL * abs(cl), (
        loss, gl, cl)
    if not gate_flips:
        return gl, cl, step_grad_rule(gg, cg, loss)[0]
    valid = (batch[1] != -1.0).reshape(-1).cpu()
    worst, flips = step_grad_rule(gg, cg, loss, gates, calls, valid)
    return gl, cl, worst, flips


def step_grad_rule(gg, cg, loss=None, gates=None, calls=(), valid=None):
    """``step_one_gpu_vs_cpu``'s rule on the GPU step's gradients ``gg``
    against the CPU step's ``cg`` (by parameter name): returns (the worst
    error as a share of its tolerance, per block the FFN units (held out,
    replayed), or None without ``gates``). ``gates`` = the two runs'
    recorded gates per block (``ffn_gates``), ``calls`` the CPU run's
    sublayer calls, ``valid`` the [rows] bools of the valid documents."""
    cg, keep, flips = dict(cg), {}, []
    top = max(v.abs().max().item() for v in cg.values())
    for i, (a, c) in enumerate(zip(*gates) if gates else ()):
        pre = f"transformer.layers.{i}."
        names = (pre + "ff1.b", pre + "ff1.w", pre + "ff2.w")
        same = ~(a != c).any(dim=0)
        b_tol = (STEP_GRAD_TOL * cg[names[0]][same].abs().max().item()
                 + 1e-5 * top)
        bad = same & ((gg[names[0]] - cg[names[0]]).abs() > b_tol)
        if bad.any():
            replayed = replay_kernel_flips(
                calls[i] if len(calls) == len(gates[0]) else None, valid,
                bad, [gg[k] for k in names], [cg[k] for k in names])
            cg.update(zip(names, replayed))
        keep[names[0]] = same
        keep[names[1]] = same[None, :].expand_as(cg[names[1]])
        keep[names[2]] = same[:, None].expand_as(cg[names[2]])
        flips.append((int((~same).sum()), int(bad.sum())))
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
    if gates:
        assert max(sum(f) for f in flips) <= GATE_FLIPS_MAX, (
            f"FFN units with a ReLU gate flipped between GPU and CPU, per "
            f"block (held out, replayed): {flips} (at most {GATE_FLIPS_MAX})")
        return worst, flips
    return worst, None


def replay_kernel_flips(call, valid, units, got, ref) -> tuple:
    """The CPU step's FFN gradients ``ref`` = (b1, W1, W2) of one block
    with the ReLU gates that the GPU's FFN kernel took the other way
    replayed, for the hidden ``units`` whose b1 gradient in the GPU step's
    ``got`` misses the CPU's. ``call`` is the block's recorded CPU
    sublayer call (``ffn_gates``). A candidate gate is one at a ``valid``
    row whose backward term is not 0 and whose CPU pre-activation lies
    within ``FLIP_MARGIN`` of 0, relative to the sum of its terms'
    magnitudes (``ffn_block.gate_flips``' margin); of each unit's four
    nearest, the subset whose flip comes closest to the miss is taken, and
    ``ffn_sublayer_bwd_plain`` runs again with those gates flipped: its
    change, scaled as the step scaled the sublayer's gradients (the
    global-norm clip), is added to ``ref``. A unit with no candidate fails
    here; the caller holds the replayed gradients to its unchanged rule."""
    from allrank_tpu_torch.ops.ffn_block import (
        _bwd_parts,
        ffn_sublayer_bwd_plain,
    )

    assert call is not None and "dy" in call, (
        "an FFN b1 gradient misses the CPU's, and no CPU sublayer call was "
        "recorded to replay a gate flip in")
    x, ln_scale, ln_bias, w1, b1, w2, b2 = call["args"]
    dy, (p_hidden, p_resid, seeds) = call["dy"], call["rates"]
    d, d_ff = x.shape[-1], w1.shape[-1]
    with torch.no_grad():
        # n, the pre-activations and each gate's term (dh before the gate;
        # 0 where dropout dropped the unit) as the plain backward has them
        _, n, pre, _, _, terms, w1c = _bwd_parts(
            x, ln_scale, ln_bias, w1, b1, w2, dy, p_hidden, p_resid, seeds)
        n, pre, terms = (n.reshape(-1, d), pre.reshape(-1, d_ff),
                         terms.reshape(-1, d_ff))
        margin = pre.abs() / (n.abs() @ w1c.abs() + b1.abs())
        args = (x, ln_scale, ln_bias, w1, b1, w2, b2, dy, p_hidden, p_resid,
                seeds)
        plain = ffn_sublayer_bwd_plain(*args)
        raw = [plain[k] for k in (4, 3, 5)]
        scale = (sum((r * c).sum() for r, c in zip(raw, ref))
                 / sum((r * r).sum() for r in raw)).item()
    miss = (got[0] - ref[0]) / scale
    flip = torch.zeros(x.shape[:-1] + (d_ff,), dtype=torch.bool)
    flat = flip.reshape(-1, d_ff)
    for j in torch.nonzero(units).flatten().tolist():
        near = valid & (terms[:, j] != 0.0) & (margin[:, j] <= FLIP_MARGIN)
        rows = torch.nonzero(near).flatten()
        assert rows.numel(), (
            f"FFN unit {j}: b1 gradient off by {miss[j].item()}, and no "
            f"valid row holds its pre-activation within {FLIP_MARGIN} of 0 "
            f"(nearest {margin[valid, j].min().item()})")
        rows = rows[margin[rows, j].argsort()[:4]]
        # flipping an open gate takes its term away, a shut one adds it
        signed = torch.where(pre[rows, j] > 0.0, -terms[rows, j],
                             terms[rows, j])
        subsets = [[k for k in range(rows.numel()) if s >> k & 1]
                   for s in range(1, 2 ** rows.numel())]
        best = min(subsets, key=lambda ks: abs(
            signed[ks].sum().item() - miss[j].item()))
        flat[rows[best], j] = True
    with torch.no_grad():
        flipped = ffn_sublayer_bwd_plain(*args, flip=flip)
    return tuple(c + scale * (flipped[k] - r)
                 for c, k, r in zip(ref, (4, 3, 5), raw))


def rel_err(got, ref) -> tuple:
    """(max abs error, max abs of the reference)."""
    return ((got.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def no_softmax_close(y, ref, key_mask, tol) -> tuple:
    """X3's ``no_softmax`` output ``y`` [B, L, d] against its plain version.
    The rows of a slate with no padded key, element by element at ``tol``.
    In a slate with a padded key every row's ctx takes that key at weight
    -1e9 x 0.001 and reaches 1e6-1e7, where the out-projection's sums
    cancel: a one-ulp flip of a bf16 ctx value moves y by up to an ulp of
    that scale. Each such row's largest error is held to ``tol``'s rtol of
    that row's own largest reference value. Returns (the largest error of
    the rows held element by element, (error, row scale) of the padded
    slates' worst row, or None)."""
    yf, rf = y.float(), ref.float()
    padded = key_mask.any(dim=-1)
    err_full = 0.0
    if (~padded).any():
        torch.testing.assert_close(yf[~padded], rf[~padded], **tol)
        err_full = (yf[~padded] - rf[~padded]).abs().max().item()
    if not padded.any():
        return err_full, None
    err = (yf[padded] - rf[padded]).abs().amax(dim=-1).flatten()
    scale = rf[padded].abs().amax(dim=-1).flatten()
    bad = err > tol["rtol"] * scale
    assert not bad.any(), (
        f"no_softmax: {int(bad.sum())} padded rows past {tol['rtol']:g} x "
        f"their max|ref|, worst {err[bad].max().item():.3e}")
    worst = int(torch.argmax(err / scale))
    return err_full, (err[worst].item(), scale[worst].item())


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


def b2_mma_case(gen, b, l, d, d_ff, p, dev, offset: int = 0,
                dtype=torch.bfloat16) -> tuple:
    """B2's tensor-core route of ``dtype`` (bf16 "mma", fp32 "tf32x3")
    against its plain version at one shape: the forward (dropout ``p`` on
    both streams), the backward with the C5 replay (``b2_replay``) and a
    second backward that must give the same bits; x and dy moved ``offset``
    elements off the allocator's alignment. Phases 3 and 7's tolerances.
    Returns (the forward's max abs error, the backward's worst share of its
    tolerance, flipped gates)."""
    from allrank_tpu_torch.ops.ffn_block import (
        ffn_sublayer_bwd,
        ffn_sublayer_fwd,
        ffn_sublayer_fwd_plain,
    )

    way = "mma" if dtype == torch.bfloat16 else "tf32x3"
    seeds = (101, 202)
    args = ffn_inputs(gen, b, l, d, d_ff, dtype, dev)
    dy = torch.randn(b, l, d, generator=gen).to(dtype).to(dev)
    if offset:
        args[0], dy = off_boundary(args[0], offset), off_boundary(dy, offset)
    fwd_n = ffn_sublayer_fwd.route_launches[way]
    bwd_n = ffn_sublayer_bwd.route_launches[way]
    y = ffn_sublayer_fwd(*args, p, p, seeds)
    got = ffn_sublayer_bwd(*args, dy, p, p, seeds)
    again = ffn_sublayer_bwd(*args, dy, p, p, seeds)
    torch.cuda.synchronize()
    assert (ffn_sublayer_fwd.route_launches[way] == fwd_n + 1
            and ffn_sublayer_bwd.route_launches[way] == bwd_n + 2), (
        f"B2 did not take its {way} route")
    ref_y = ffn_sublayer_fwd_plain(*args, p, p, seeds)
    assert torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), ref_y.float(), **KERNEL_TOL[dtype])
    for i, (g, g2) in enumerate(zip(got, again)):
        assert torch.equal(g, g2), (
            f"B2 {way} backward grad {i} differs between two runs B={b} "
            f"L={l} d={d} d_ff={d_ff} p={p}")
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


def approx_inputs(gen, n, l, scale=1.0, scattered=False):
    """B9's inputs on the CPU, drawn from ``gen``: scores [n, l] times
    ``scale`` with ties (column 5 i + 1 a copy of column 5 i), 0/1 validity
    and a cotangent u. Ragged: slate 0 whole, the last one empty, the
    others prefixes. Scattered (not a prefix): slate 0 whole, the others
    some 70 % valid at random places; where n > 2, slate 1 with a single
    valid document and slate 2 with none."""
    s = torch.randn(n, l, generator=gen) * scale
    s[:, 1::5] = s[:, 0::5][:, :s[:, 1::5].shape[1]]  # tied scores
    if scattered:
        valid = (torch.rand(n, l, generator=gen) < 0.7).float()
        valid[0] = 1.0
        if n > 2:
            valid[1] = 0.0
            valid[1, l // 3] = 1.0
            valid[2] = 0.0
    else:
        lengths = torch.randint(1, l + 1, (n,), generator=gen)
        lengths[0] = l
        if n > 1:
            lengths[-1] = 0  # an empty slate
        valid = (torch.arange(l)[None, :] < lengths[:, None]).float()
    return s, valid, torch.randn(n, l, generator=gen)


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


def b1_mma_case(gen, b, l, d, h, p, dev, offset: int = 0,
                dtype=torch.bfloat16) -> tuple:
    """B1's tensor-core route of ``dtype`` (bf16 "mma", fp32 "tf32x3")
    against its plain version at one shape: the forward (dropout ``p`` on
    both streams), the backward on its saved state (qkv moved ``offset``
    elements off the allocator's alignment) and a second backward that must
    give the same bits; phases 2 and 7's tolerances. Returns (the forward's
    max abs error, the backward's worst error as a share of its
    tolerance)."""
    from allrank_tpu_torch.ops.attention_block import (
        attention_sublayer_bwd,
        attention_sublayer_bwd_plain,
        attention_sublayer_fwd,
        attention_sublayer_fwd_plain,
    )

    way = "mma" if dtype == torch.bfloat16 else "tf32x3"
    seeds = (101, 202)
    args = attn_inputs(gen, b, l, d, dtype, dev)
    dy = torch.randn(b, l, d, generator=gen).to(dtype).to(dev)
    fwd_n = attention_sublayer_fwd.route_launches[way]
    bwd_n = attention_sublayer_bwd.route_launches[way]
    y, (qkv, stats) = attention_sublayer_fwd(*args, h, p, p, seeds,
                                             return_saved=True)
    if offset:
        qkv = off_boundary(qkv, offset)
    got = attention_sublayer_bwd(*args, dy, h, p, p, seeds,
                                 saved=(qkv, stats))
    again = attention_sublayer_bwd(*args, dy, h, p, p, seeds,
                                   saved=(qkv, stats))
    torch.cuda.synchronize()
    assert (attention_sublayer_fwd.route_launches[way] == fwd_n + 1
            and attention_sublayer_bwd.route_launches[way] == bwd_n + 2), (
        f"B1 did not take its {way} route")
    ref_y = attention_sublayer_fwd_plain(*args, h, p, p, seeds)
    assert torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), ref_y.float(), **KERNEL_TOL[dtype])
    ref = attention_sublayer_bwd_plain(*args, dy, h, p, p, seeds)
    rtol, atol = BWD_TOL[dtype]
    worst = 0.0
    for i, (g, r, g2) in enumerate(zip(got, ref, again)):
        assert torch.isfinite(g.float()).all(), (b, l, d, h, p, i)
        assert torch.equal(g, g2), (
            f"B1 {way} backward grad {i} differs between two runs "
            f"B={b} L={l} d={d} h={h} p={p}")
        err, scale = rel_err(g, r)
        assert err <= rtol * scale + atol, (
            f"B1 {way} grad {i} B={b} L={l} d={d} h={h} p={p} "
            f"offset={offset}: {err} > {rtol} x {scale} + {atol}")
        worst = max(worst, err / (rtol * scale + atol))
    return rel_err(y, ref_y)[0], worst


# the row names of B1's and B2's routes: the SIMT kernels under the
# kernel's own name, the tensor cores under a suffix
ROUTE_SUFFIX = {"simt": "", "mma": "_mma", "tf32x3": "_tf32x3"}


def timing_row(rows: dict, kernel_name: str, dtype, way: str) -> tuple:
    """(the row in ``rows`` that a timing of ``kernel_name`` in ``dtype``
    goes to, the suffix of its keys): B1's and B2's three routes are three
    rows of unsuffixed keys (the SIMT kernels, timed in fp32, under the
    kernel's name; the tensor cores under ``<name>_mma`` for bf16 and
    ``<name>_tf32x3`` for fp32); any other kernel is one row, its bf16 keys
    suffixed ``_bf16``."""
    if kernel_name.startswith(("attention_sublayer", "ffn_sublayer")):
        name, sfx = kernel_name + ROUTE_SUFFIX[way], ""
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


def approx_work(valid, backward: bool) -> tuple:
    """(operations, bytes, valid ordered pairs): what the approxNDCG rank
    sum needs on these inputs, per valid off-diagonal pair. The forward 8
    operations: the difference, the scale, the exponential, the sum and the
    quotient of the sigmoid, the clamp, the mask and the accumulation; s
    and valid read, pos written. The backward 12, each c_ij once: the
    sigmoid (5), 1 - t, the products with -alpha, t and u, the compare, and
    its two accumulations; u read too, ds written."""
    b, l = valid.shape
    counts = (valid > 0.5).sum(dim=1)
    pairs = int((counts * (counts - 1)).sum().item())
    return ((12 if backward else 8) * pairs,
            (4 if backward else 3) * b * l * 4, pairs)


def library_device_ms(fn, backward: bool):
    """A library formulation's device time on the kernels' clock: a forward
    as 20 calls in one CUDA graph (``graph_ms``); a backward by autograd,
    whose engine refuses capture, as the sum of its kernels' durations in a
    checked torch.profiler trace (``kernel_ms``), None where every trace
    lost device events."""
    if not backward:
        return graph_ms(fn)
    try:
        return sum(kernel_ms(fn).values())
    except IncompleteTrace as err:
        print(f"library backward not measured: {err}")
        return None


def short_kernel_row(name, kernel, plain, lib_fn, work, err, shape,
                     tag) -> dict:
    """The record of a kernel of 10-300 us, printed too: the device's own
    time for the kernel (``graph_ms``) with its event-timed call beside it,
    the library formulation's device time (``library_device_ms``) with its
    event-timed call beside it, the event-timed call of the plain version,
    and the bound of ``work`` = (operations, bytes, ...)."""
    ms = graph_ms(kernel)
    call_ms, plain_ms, lib_ms = (median_ms(fn, iters=20)
                                 for fn in (kernel, plain, lib_fn))
    lib_dev_ms = library_device_ms(lib_fn, name.endswith("_bwd"))
    flops, moved = work[:2]
    bound_ms, bound_by = bound(flops, moved, torch.float32)
    lib_txt = ("not measured" if lib_dev_ms is None
               else f"{lib_dev_ms:.4f} ms")
    print(f"time {name} float32 {shape}: kernel {ms:.4f} ms of device time "
          f"(20 calls in one CUDA graph; one event-timed call {call_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms a call, library (torch-op chain, "
          f"autograd) {lib_txt} of device time (one event-timed call "
          f"{lib_ms:.4f} ms), bound {bound_ms:.5f} ms "
          f"({bound_by}: {flops / 1e9:.4f} G operations, "
          f"{moved / 1e6:.3f} MB) {tag}")
    return {"name": name, "route": "cuda", "max_abs_err": err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms,
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


def assert_grad_close(got, ref, what) -> float:
    assert torch.isfinite(got).all(), f"{what}: non-finite gradient"
    err, scale = rel_err(got, ref)
    rtol, atol = SOFT_GRAD_TOL
    assert err <= rtol * scale + atol, f"{what}: {err} > {rtol} x {scale}"
    return err


def write_cli_dataset(data_dir: str, seed: int = 0) -> dict:
    """train.txt (1,024 slates) and one validation file under both role
    names the two configs ask for (test.txt, vali.txt; 256 slates): 136
    features, slate lengths drawn from 40-240, labels 0-4 that follow two
    features plus noise, written by the C++ writer. Returns {role: (X, y,
    qid)} as written."""
    from allrank_tpu_torch.data.native import write_svmlight_native

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
        x = x.astype(np.float32)
        write_svmlight_native(x, y, qid, os.path.join(data_dir, f"{role}.txt"))
        arrays[role] = (x, y, qid)
    shutil.copyfile(os.path.join(data_dir, "test.txt"),
                    os.path.join(data_dir, "vali.txt"))
    return arrays


def run_cli(config_path: str, work_dir: str, run_id: str, epochs: int,
            data_path=None, **sections):
    """``allrank_tpu_torch.main.run`` on ``config_path`` with only the data
    path (default ``<work_dir>/data``), the epochs, the expected-metrics
    gate and the fields of ``sections`` ({section: {field: value}})
    changed; returns (result, output directory, per-epoch train and
    validation losses, seconds)."""
    from allrank_tpu_torch.main import run

    with open(config_path) as f:
        cfg = json.load(f)
    cfg["data"]["path"] = data_path or os.path.join(work_dir, "data")
    cfg["training"]["epochs"] = epochs
    for section, fields in sections.items():
        cfg[section].update(fields)
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


# the host data path's dataset (phase 36): a quarter of WEB30K Fold1's
# queries (18,919 train, 6,306 vali), drawn as tools/make_web30k_surrogate.py
# draws them
WEB30K_QUERIES = {"train": 4730, "vali": 1577}
WEB30K_MARGINALS = [0.514, 0.325, 0.134, 0.019, 0.008]
WEB30K_LONGEST = 1308  # the longest WEB30K vali slate
WEB30K_NEGATIVE = [110, 111, 112, 113, 114, 115, 116, 117, 118, 119, 120,
                   123, 124]


def write_web30k_dataset(data_dir: str, seed: int = 42) -> dict:
    """``train.txt`` and ``vali.txt`` of WEB30K's shape, as the surrogate
    tool makes them but in bulk: slate lengths lognormal (mean 4.35, sigma
    0.8 in log space, 5-1,308 documents, a few near 1,308; the vali role
    holds one of exactly 1,308), a latent quality per document, grades 0-4
    at WEB30K's marginals from noisy quantiles of it, 136 features as
    linear, heavy-tailed or noise views of it over spread scales, 13 of
    them negative; qids run on across the roles. Written by the port's C++
    writer. Returns {role: (X, y, qid)} as written and the seconds to draw
    and to write."""
    from statistics import NormalDist

    from allrank_tpu_torch.data.native import write_svmlight_native

    rng = np.random.RandomState(seed)
    kinds = rng.choice(3, size=N_FEATURES, p=[0.45, 0.35, 0.2])
    signal = np.where(kinds == 2, 0.0, rng.uniform(0.1, 1.2, N_FEATURES))
    scale = 10.0 ** rng.uniform(-1, 3, N_FEATURES)
    noise_w = np.sqrt(np.maximum(1e-6, 1.0 - signal ** 2))
    thresholds = np.sqrt(1.0 + 0.9 ** 2) * np.array(
        [NormalDist().inv_cdf(c) for c in np.cumsum(WEB30K_MARGINALS)[:-1]])
    os.makedirs(data_dir, exist_ok=True)
    arrays, seconds, qid0 = {}, {"draw": 0.0, "write": 0.0}, 1
    for role, n_queries in WEB30K_QUERIES.items():
        t0 = time.perf_counter()
        lengths = np.clip(rng.lognormal(4.35, 0.8, n_queries).astype(int), 5,
                          WEB30K_LONGEST)
        tail = rng.choice(n_queries, size=max(3, n_queries // 2000),
                          replace=False)
        lengths[tail] = rng.randint(WEB30K_LONGEST - 60, WEB30K_LONGEST + 1,
                                    size=len(tail))
        if role == "vali":
            lengths[tail[0]] = WEB30K_LONGEST
        u = rng.randn(int(lengths.sum())).astype(np.float32)
        y = np.digitize(u + 0.9 * rng.randn(len(u)), thresholds).astype(
            np.float32)
        base = (signal * u[:, None]).astype(np.float32) + (
            noise_w * rng.randn(len(u), N_FEATURES)).astype(np.float32)
        x = np.where(kinds == 1, np.exp(1.2 * base), base) * scale
        x[:, WEB30K_NEGATIVE] = -np.abs(x[:, WEB30K_NEGATIVE])
        x = x.astype(np.float32)
        qid = np.repeat(np.arange(qid0, qid0 + n_queries), lengths)
        qid0 += n_queries
        seconds["draw"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        write_svmlight_native(x, y, qid, os.path.join(data_dir, f"{role}.txt"))
        seconds["write"] += time.perf_counter() - t0
        arrays[role] = (x, y, qid)
    return arrays, seconds


def host_cpu() -> str:
    """The host's CPU model and core count, as ``lscpu`` reports them; where
    it names no model ("unknown" in a virtual machine), ``/proc/cpuinfo``'s
    model name beside lscpu's vendor, family and model numbers."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    fields = {k.strip(): v.strip() for k, v in (
        line.split(":", 1) for line in out.splitlines() if ":" in line)}
    model = fields.get("Model name", "")
    if model.lower() in ("", "-", "unknown"):
        with open("/proc/cpuinfo") as f:
            names = {v.strip() for k, v in (
                line.split(":", 1) for line in f if ":" in line)
                if k.strip() == "model name"}
        model = "; ".join(sorted(names) + [
            f"{k} {fields[k]}" for k in ("Vendor ID", "CPU family", "Model")
            if k in fields])
    return f"{model}, {fields.get('CPU(s)')} CPUs (lscpu)"


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


def graph_record(service) -> tuple:
    """A service's CUDA graphs (``serving.aot_compile``, one a bucket):
    each bucket's launches captured a call, by kernel wrapper (and route),
    and the replays of all its graphs so far. A replay runs the captured
    kernels again without the wrappers' Python, so their counters count
    the capture only."""
    compiled = service._compiled_by_bucket
    return ({b: c.captured_launches for b, c in compiled.items()},
            sum(c.replays for c in compiled.values()))


def traced_launches(fn, calls: int, want: dict, refuse=()) -> dict:
    """The kernels that a call of ``fn`` ran, launches a call by name, from
    a device trace (``timing.trace_kernels``: the kernels of graph replays
    too). The kernels whose names hold a fragment of ``want`` ran that
    many times a call in all; no kernel's name holds one of ``refuse``."""
    spans, _ = trace_kernels(fn, calls)
    per_call = {name: n / calls for name, n in collections.Counter(
        name for name, _, _ in spans).items()}
    for frag, n in want.items():
        got = sum(v for k, v in per_call.items() if frag in k)
        assert got == n, (frag, n, {k: v for k, v in per_call.items()
                                    if frag in k})
    refused = [k for k in per_call if any(r in k for r in refuse)]
    assert not refused, refused
    return {frag: sum(v for k, v in per_call.items() if frag in k)
            for frag in want}


def reference_state_dict(mdef, seed: int) -> dict:
    """Seeded tensors in the reference allRank LTRModel's ``state_dict``
    layout for ``mdef`` (``nn.Linear`` weights [d_out, d_in], Q, K and V
    projections apart, ``a_2``/``b_2`` LayerNorms, the fixed sin/cos
    table as the buffer ``encoder.position.pe``): a checkpoint as the
    reference saves it, weights at Xavier-like scale."""
    from allrank_tpu_torch.models.positional import fixed_positional_table

    rng = np.random.RandomState(seed)

    def linear(prefix, d_in, d_out):
        sd[f"{prefix}.weight"] = rng.randn(d_out, d_in) / math.sqrt(d_in)
        sd[f"{prefix}.bias"] = 0.02 * rng.randn(d_out)

    def std_norm(prefix, dim):
        sd[f"{prefix}.a_2"] = 1.0 + 0.1 * rng.randn(dim)
        sd[f"{prefix}.b_2"] = 0.1 * rng.randn(dim)

    sd = {}
    dims = (mdef.fc.n_features,) + tuple(mdef.fc.sizes)
    sd["input_layer.input_norm.weight"] = 1.0 + 0.1 * rng.randn(dims[0])
    sd["input_layer.input_norm.bias"] = 0.1 * rng.randn(dims[0])
    for i in range(len(mdef.fc.sizes)):
        linear(f"input_layer.layers.{i}", dims[i], dims[i + 1])
    tdef = mdef.transformer
    d = tdef.d_model
    for i in range(tdef.N):
        for j in range(4):
            linear(f"encoder.layers.{i}.self_attn.linears.{j}", d, d)
        linear(f"encoder.layers.{i}.feed_forward.w_1", d, tdef.d_ff)
        linear(f"encoder.layers.{i}.feed_forward.w_2", tdef.d_ff, d)
        for s in (0, 1):
            std_norm(f"encoder.layers.{i}.sublayer.{s}.norm", d)
    std_norm("encoder.norm", d)
    sd["encoder.position.pe"] = fixed_positional_table(d, tdef.max_indices)
    linear("output_layer.w_1", d, mdef.output.d_output)
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32))
            for k, v in sd.items()}


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


def encoder_work(b, l, d, h, d_ff, n, dtype, backward: bool) -> tuple:
    """(operations, bytes) of B10 on these shapes: per block B1's and B2's
    products counted once (forward 2 M d 3d + 4 B h L^2 d_k + 2 M d^2 +
    4 M d d_ff, backward 16 M d^2 + 12 B h L^2 d_k + 10 M d d_ff, M = B L;
    a backward's replay of the forward is a cost of a design); x, the
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


def encoder_ffn_gates(record):
    """``ffn_gates``' recorder for the encoder with the switch on: replays
    each recorded B10 call through the chained sublayer forwards (on the
    card the kernels of B10's routes, whose tile bodies B10 runs, on the CPU
    the plain versions: B10's own intermediates, which it does not expose)
    and returns per block the [rows, d_ff] gates at the FFN inputs; the
    replay's launches are taken back off the counters."""
    from allrank_tpu_torch.models.core import std_layer_norm
    from allrank_tpu_torch.ops.attention_block import (
        attention_sublayer_fwd,
        launch_fwd,
    )
    from allrank_tpu_torch.ops.encoder_block import route
    from allrank_tpu_torch.ops.ffn_block import ffn_sublayer_fwd
    from allrank_tpu_torch.ops.ffn_block import launch_fwd as ffn_launch_fwd

    def call(x, mask, seeds, stacks, fs, fb, *, h, p_drop=0.0):
        counts = (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches)
        routes = (dict(attention_sublayer_fwd.route_launches),
                  dict(ffn_sublayer_fwd.route_launches))
        cuda = x.device.type == "cuda"
        ways = route(x.dtype, x.shape[-1], h, stacks[8].shape[-1])
        with torch.no_grad():
            hid = x
            for n in range(stacks[0].shape[0]):
                w = [t[n].detach() for t in stacks]
                args = (hid, mask, *w[:6], h, p_drop, p_drop,
                        seeds[4 * n:4 * n + 2])
                hid = (launch_fwd(ways[0], *args) if cuda
                       else attention_sublayer_fwd(*args))
                pre = std_layer_norm(hid.float(), w[6], w[7]) @ w[8] + w[9]
                record.append(pre.reshape(-1, pre.shape[-1]) > 0)
                args = (hid, *w[6:], p_drop, p_drop,
                        seeds[4 * n + 2:4 * n + 4])
                hid = (ffn_launch_fwd(ways[1], *args) if cuda
                       else ffn_sublayer_fwd(*args))
        attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches = counts
        (attention_sublayer_fwd.route_launches,
         ffn_sublayer_fwd.route_launches) = routes
    return call


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


def neighbour_swaps(got, ref, scores, n: int) -> int:
    """The swaps of neighbours that take ``ref``, one slate's ranked order
    (CPU), to ``got`` (card), with ``n`` real documents ranked first: each
    swap must join two documents whose ``scores`` (CPU, by document) are
    less than ``SCORE_TOL`` apart, and the padded tail must be equal.
    Raises otherwise."""
    assert (got[n:] == ref[n:]).all(), "padding last, in order"
    swaps, j = 0, 0
    while j < n:
        if got[j] == ref[j]:
            j += 1
            continue
        assert j + 1 < n and got[j] == ref[j + 1] and got[j + 1] == ref[j], (
            "not a swap of neighbours", j)
        gap = abs(scores[ref[j]] - scores[ref[j + 1]])
        assert gap < SCORE_TOL, ("swap of documents apart", j, gap)
        swaps += 1
        j += 2
    return swaps


def near_margin(dist, margin, y, rtol: float = 1e-5):
    """[B, L] bool: documents with an earlier real document at a distance
    within ``rtol`` of their slate's diverse margin, where the card's and
    the CPU's fp32 sums may decide the keep rule otherwise."""
    real = y != -1
    ell = y.shape[1]
    pair = torch.ones(ell, ell, dtype=torch.bool, device=y.device).triu(1)
    pair = pair & real[:, :, None] & real[:, None, :]
    close = ((dist - margin[:, None, None]).abs()
             <= rtol * margin[:, None, None]) & pair
    return close.any(dim=1)


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
        reciprocal_mismatches,
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
        cluster_size,
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
    from allrank_tpu_torch.ops.neuralsort import ROUTES as B8_ROUTES
    from allrank_tpu_torch.ops.neuralsort import (
        cluster_plan,
        kernel_cluster_blocks,
        kernel_smem_floats,
        soft_sort_bwd,
        soft_sort_bwd_plain,
        soft_sort_fwd,
        soft_sort_fwd_plain,
    )
    from allrank_tpu_torch.ops.neuralsort import launch_bwd as b8_launch_bwd
    from allrank_tpu_torch.ops.neuralsort import launch_fwd as b8_launch_fwd
    from allrank_tpu_torch.ops.sinkhorn import ROUTES as B7_ROUTES
    from allrank_tpu_torch.ops.sinkhorn import (
        cluster_occupancy as b7_occupancy,
    )
    from allrank_tpu_torch.ops.sinkhorn import cluster_plan as b7_plan
    from allrank_tpu_torch.ops.sinkhorn import (
        kernel_cluster_blocks as b7_kernel_blocks,
    )
    from allrank_tpu_torch.ops.sinkhorn import (
        kernel_smem_floats as b7_kernel_floats,
    )
    from allrank_tpu_torch.ops.sinkhorn import launch_bwd as b7_launch_bwd
    from allrank_tpu_torch.ops.sinkhorn import launch_fwd as b7_launch_fwd
    from allrank_tpu_torch.ops.sinkhorn import (
        sinkhorn_bwd,
        sinkhorn_bwd_plain,
        sinkhorn_fwd,
        sinkhorn_fwd_plain,
    )
    from allrank_tpu_torch.serve_http import SlateScoringService, run_server
    from allrank_tpu_torch.serving import make_ranker, make_scorer
    from allrank_tpu_torch.tools.time_sublayers import (
        b1_library,
        b2_library,
        encoder_chained_bwd,
        encoder_chained_fwd,
        encoder_library,
    )

    from allrank_tpu_torch.ops.attention_block import ROUTES as B1_ROUTES
    from allrank_tpu_torch.ops.attention_block import (
        launch_bwd as b1_launch_bwd,
    )
    from allrank_tpu_torch.ops.attention_block import (
        launch_fwd as b1_launch_fwd,
    )
    from allrank_tpu_torch.ops.ffn_block import ROUTES as B2_ROUTES
    from allrank_tpu_torch.ops.ffn_block import launch_bwd as b2_launch_bwd
    from allrank_tpu_torch.ops.ffn_block import launch_fwd as b2_launch_fwd
    from allrank_tpu_torch.ops.ffn_block import route as b2_route

    def reset_routes():
        """B1's, B2's, B8's and B7's launches by route back to 0."""
        for k in (attention_sublayer_fwd, attention_sublayer_bwd):
            k.route_launches = dict.fromkeys(B1_ROUTES, 0)
        for k in (ffn_sublayer_fwd, ffn_sublayer_bwd):
            k.route_launches = dict.fromkeys(B2_ROUTES, 0)
        for k in (soft_sort_fwd, soft_sort_bwd):
            k.route_launches = dict.fromkeys(B8_ROUTES, 0)
        for k in (sinkhorn_fwd, sinkhorn_bwd):
            k.route_launches = dict.fromkeys(B7_ROUTES, 0)

    def b1_routes():
        """B1's launches by route, forward then backward."""
        return (dict(attention_sublayer_fwd.route_launches),
                dict(attention_sublayer_bwd.route_launches))

    def b2_routes():
        """B2's launches by route, forward then backward."""
        return (dict(ffn_sublayer_fwd.route_launches),
                dict(ffn_sublayer_bwd.route_launches))

    t_main = time.perf_counter()

    def phase_ok(line: str) -> None:
        """A phase's closing line, led by the seconds since the start."""
        print(f"[{time.perf_counter() - t_main:.0f} s] {line}", flush=True)

    dev = torch.device("cuda", 0)
    name_power = card()
    tag = f"[{name_power}]"
    device_kind = torch.cuda.get_device_name(0)

    # -- 1: card, versions, build --------------------------------------------
    print(f"card: {name_power}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    # the host libraries of the data path (phase 36) build with g++; its
    # parser needs std::from_chars for floats (GCC >= 11)
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    from allrank_tpu_torch.data import native as host_native

    t0 = time.perf_counter()
    built = [host_native.build(name) for name in (
        "libsvm_parser", "slate_assembler", "libsvm_writer")]
    print(f"g++: {gxx.splitlines()[0]}; host libraries built in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{[os.path.basename(p) for p in built]}")
    t0 = time.perf_counter()
    sources = SOURCES
    _build.build(sources)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, the "
          f"{len(sources)} sources in parallel); the slowest: " + ", ".join(
              f"{n} {sec:.1f} s" for n, sec in sorted(
                  _build.build.seconds.items(), key=lambda kv: -kv[1])[:8]))
    for src in sources:
        with open(_build.log_path(src)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")
    prefetch_sass([_build.library_path(src) for src in (
        "attention_tiled", "attention_fused", "attention_block_mma",
        "ffn_block_mma", "attention_block_tf32x3", "ffn_block_tf32x3",
        *PROBE_MMA_KERNELS, *B10_SOURCES)])
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
    # X2's and X3's tensor-core sources: every x2_* and variant_* kernel
    # holds bf16 HMMA and no other (the headers' split reduction holds
    # none). In the probes' classes X2 and X3's LN + QKV spill nothing, and
    # each X3 attention kernel at d_k 32 no more than B1's own kernel of
    # that class and alignment, whose body it runs (4 bytes where head rows
    # are aligned, at the 128 registers ptxas gives both)
    b1_props = ptxas_properties(_build.log_path("attention_block_mma"))

    def b1_spill(aligned: bool) -> int:
        tag32 = f"b1_attn_out_mma_kernelILi32ELb{int(aligned)}E"
        return spill_bytes(next(line for f, line in b1_props.items()
                                if tag32 in f))

    for src, n_kernels in PROBE_MMA_KERNELS.items():
        marker = "x2_" if src.startswith("boundary") else "variant_"
        hmma = hmma_counts(_build.library_path(src), marker)
        bf16 = hmma_counts(_build.library_path(src), marker, BF16_HMMA)
        for kname, n in sorted(hmma.items()):
            print(f"  {src}: {n} HMMA, {bf16[kname]} of them bf16, in "
                  f"{kname}")
        assert len(hmma) == n_kernels and all(
            0 < bf16[k] == hmma[k] for k in hmma), (src, hmma, bf16)
        props = ptxas_properties(_build.log_path(src))
        over = {}
        for f, line in props.items():
            if spill_bytes(line):
                print(f"  {src} spills: {f[:160]}: {line}")
            if "x2_" in f or "ln_qkv" in f:
                allowed = 0
            elif "ILi32ELb" in f:
                allowed = b1_spill("ILi32ELb1" in f)
            else:
                continue
            if spill_bytes(line) > allowed:
                over[f] = line
        assert not over, (src, over)
        print(f"HMMA: all {n_kernels} {marker}* kernels of {src} hold bf16 "
              f"HMMA only; ptxas: in the probes' class no spill beyond B1's "
              f"own body's")
    # B1's and B2's fp32 routes: every product a TF32 one (3xTF32), in every
    # b1_*_tf32x3_kernel and b2_*_tf32x3_kernel; no other kernel of the two
    # sources (the split reductions) holds any
    for src, marker, n_f32, what in (
            ("attention_block_tf32x3", "b1_", B1_F32_KERNELS,
             "attention core, dQ, dK/dV at padded d_k 32, 64, 128, aligned "
             "or not; LN + QKV, out-projection, rows, dn + LN backward, "
             "A^T B"),
            ("ffn_block_tf32x3", "b2_", B2_F32_KERNELS,
             "forward and backward rows at d <= 128 and d > 128, A^T B")):
        hmma = hmma_counts(_build.library_path(src), "")
        tf32 = hmma_counts(_build.library_path(src), "", TF32_HMMA)
        for kname, n in sorted(hmma.items()):
            print(f"  {src}: {n} HMMA, {tf32[kname]} of them TF32, in "
                  f"{kname}")
        f32 = [k for k in hmma if "_tf32x3_kernel" in k and marker in k]
        assert len(f32) == n_f32 and all(
            0 < tf32[k] == hmma[k] for k in f32), (hmma, tf32)
        assert all(hmma[k] == 0 for k in hmma if k not in f32), hmma
        print(f"HMMA: all {n_f32} fp32 (3xTF32) {marker} kernels of {src} "
              f"({what}) hold TF32 HMMA only; the other kernels none")
    # B10: every instantiation (forward and backward, each head class, each
    # at d <= 128 and d > 128) holds, in the phases it calls, tensor-core
    # products of its dtype's kind only; the SIMT-attention ones through the
    # FFN's phases. The functions that spill are printed.
    for src in B10_SOURCES:
        kind = BF16_HMMA if "_bf16_" in src else TF32_HMMA
        found = call_closure_counts(
            _build.library_path(src), "encoder_",
            {"hmma": r"\bH(G)?MMA\b", "kind": kind})
        kernels = {k: v for k, v in found.items()
                   if "encoder_fwd_kernel" in k or "encoder_bwd_kernel" in k}
        for kname, v in sorted(kernels.items()):
            print(f"  {src}: {v['hmma']} HMMA, {v['kind']} of them "
                  f"{'TF32' if kind == TF32_HMMA else 'bf16'}, in {kname} "
                  f"and its source's phases")
        assert len(kernels) == B10_KERNELS and all(
            0 < v["kind"] == v["hmma"] for v in kernels.values()), kernels
        props = ptxas_properties(_build.log_path(src))
        spilled = {f: line for f, line in props.items() if re.search(
            r"[1-9]\d* bytes spill (stores|loads)", line)}
        for f, line in sorted(spilled.items()):
            print(f"  {src} spills: {f[:160]}: {line}")
        # the main path's head class (the flagship's d_k = 32) spills
        # nothing; the wider classes' bodies sit at 255 registers in their
        # chained kernels already (PERF.md, PR 15)
        assert "_dk32" not in src or not spilled, (src, spilled)
        print(f"HMMA: all {B10_KERNELS} B10 kernels of {src} hold "
              f"{'TF32' if kind == TF32_HMMA else 'bf16'} HMMA only, in "
              f"their phases; ptxas: {len(spilled)} of {len(props)} "
              f"functions spill")
    # B3's cluster kernels, B8's "cluster" route and X4 (one kernel a
    # register shape and direction each) and B7's "cluster" route:
    # registers and spills of each; B3's spill nothing, B8's and X4's hold
    # a block's rows of M0 in 128 registers a thread and spill a few
    # hundred bytes, printed
    cluster_sources = (
        ("lambda_pairs", r"lambda_cluster_[fb]wd_kernel", 2),
        ("neuralsort_cluster", r"soft_sort_cluster_[fb]wd_kernel", 6),
        ("neuralsort_layout", r"soft_sort_cluster_[fb]wd_kernel", 6),
        ("sinkhorn_cluster", r"sinkhorn_cluster_[fb]wd_kernel", 2))
    regs = dict(sum((ptxas_lines(src) for src, _, _ in cluster_sources),
                    []))
    for src, marker, count in cluster_sources:
        found = {f: line for f, line in ptxas_properties(
            _build.log_path(src)).items() if re.search(marker, f)}
        assert len(found) == count, (src, found)
        for f, line in sorted(found.items()):
            kname = re.search(marker + r"\w*", f).group(0)
            print(f"ptxas {src}: {kname}: {regs.get(f, '?')}; {line}")
        assert src != "lambda_pairs" or not any(
            spill_bytes(line) for line in found.values()), found
    # B9's two kernels (the compacted slate, several rows a warp): registers
    # and spills of each
    b9_props = {f: line for f, line in ptxas_properties(
        _build.log_path("approx_pos")).items()
        if re.search(r"approx_[fb]wd_kernel", f)}
    b9_regs = dict(ptxas_lines("approx_pos"))
    assert len(b9_props) == 2, b9_props
    for f, line in sorted(b9_props.items()):
        kname = re.search(r"approx_[fb]wd_kernel", f).group(0)
        print(f"ptxas approx_pos: {kname}: {b9_regs.get(f, '?')}; {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _SASS.clear()
    phase_ok("phase 1 ok: every source built; every tensor-core kernel holds "
             "HMMA of its kind")
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
    # the tensor-core routes (bf16 "mma", fp32 "tf32x3") at each head-width
    # class, rows aligned and not, L from 1 to B1's longest; every batch
    # holds a fully padded slate. These cases draw from a generator of their
    # own, as phase 7's do, so that every other phase's inputs stay as they
    # were before them (the fp32 cases from a third, after the bf16 ones)
    gen_mma = torch.Generator().manual_seed(1111)
    gen_f32 = torch.Generator().manual_seed(3333)
    for dtype, way, gen_w in ((torch.bfloat16, "mma", gen_mma),
                              (torch.float32, "tf32x3", gen_f32)):
        for d, h in B1_MMA_WIDTHS:
            assert b1_route(dtype, d, h) == way, (d, h, dtype)
            worst = 0.0
            for l in (1, 65, 240, 1024):
                b = 2 if l == 1024 else 3
                args = attn_inputs(gen_w, b, l, d, dtype, dev)
                before = attention_sublayer_fwd.route_launches[way]
                err = check_kernel("attention_sublayer_fwd",
                                   attention_sublayer_fwd,
                                   attention_sublayer_fwd_plain, args + [h],
                                   {}, dtype)
                assert (attention_sublayer_fwd.route_launches[way]
                        == before + 1)
                worst = max(worst, err)
            print(f"B1 ({way}) vs plain d={d} h={h} (d_k {d // h}) {dtype} "
                  f"at L in (1, 65, 240, 1024): max_abs_err {worst:.3e} (tol "
                  f"{KERNEL_TOL[dtype]})")
    phase_ok("phase 2 ok: attention sublayer kernel matches its plain version")

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
    gen_b2_f32 = torch.Generator().manual_seed(4444)
    for dtype, way, gen_w in ((torch.bfloat16, "mma", gen_b2),
                              (torch.float32, "tf32x3", gen_b2_f32)):
        for d, d_ff in B2_MMA_WIDTHS:
            assert b2_route(dtype, d, d_ff) == way, (d, d_ff, dtype)
            worst = 0.0
            for l in (1, 65, 240, 1024):
                b = 2 if l == 1024 else 3
                args = ffn_inputs(gen_w, b, l, d, d_ff, dtype, dev)
                before = ffn_sublayer_fwd.route_launches[way]
                err = check_kernel("ffn_sublayer_fwd", ffn_sublayer_fwd,
                                   ffn_sublayer_fwd_plain, args, {}, dtype)
                assert ffn_sublayer_fwd.route_launches[way] == before + 1
                worst = max(worst, err)
            print(f"B2 ({way}) vs plain d={d} d_ff={d_ff} {dtype} at L in "
                  f"(1, 65, 240, 1024): max_abs_err {worst:.3e} (tol "
                  f"{KERNEL_TOL[dtype]})")
    phase_ok("phase 3 ok: FFN sublayer kernel matches its plain version")

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
    for scorer, label, way in ((scorer32, "fp32", "tf32x3"),
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
    phase_ok("phase 4 ok: flagship scorer and ranker on the GPU match the CPU")

    # -- 5: the service, the main path ------------------------------------------
    service = SlateScoringService(gpu_model, L, N_FEATURES, batch_size=64,
                                  max_wait_ms=5, compute_dtype="float32",
                                  batch_buckets=(1, 8, 64))
    # each bucket's CUDA graph captured B1 and B2 forward once a block, on
    # their 3xTF32 route: the launches of one call
    one_wave = {"attention_sublayer_fwd": 4,
                "attention_sublayer_fwd[tf32x3]": 4, "ffn_sublayer_fwd": 4,
                "ffn_sublayer_fwd[tf32x3]": 4}
    captured, replays_before = graph_record(service)
    assert all(c == one_wave for c in captured.values()), captured
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
        eager_launches = (attention_sublayer_fwd.launches,
                          ffn_sublayer_fwd.launches, b1_routes()[0],
                          b2_routes()[0])
        replays = graph_record(service)[1] - replays_before
        with urllib.request.urlopen(url + "/statz", timeout=30) as r:
            stats = json.loads(r.read())
        waves = stats["waves_total"] - waves_before
        # every wave replayed its bucket's graph, and nothing launched from
        # Python: the launches of the waves are the captured ones a replay
        assert eager_launches == (0, 0, dict.fromkeys(B1_ROUTES, 0),
                                  dict.fromkeys(B2_ROUTES, 0)), eager_launches
        assert waves >= 1 and replays == waves, (replays, waves)
        main_launches = {"attention_sublayer_fwd": 4 * replays,
                         "ffn_sublayer_fwd": 4 * replays}
        # and the device ran B1's and B2's 3xTF32 kernels, once a block a
        # wave, and none of their other routes'
        wave_kernels = traced_launches(
            lambda: service.score(slates[0], timeout=60), 3,
            {"b1_ln_qkv_tf32x3_kernel": 4, "b1_attn_tf32x3_kernel": 4,
             "b1_out_tf32x3_kernel": 4, "b2_fwd_tf32x3_kernel": 4},
            refuse=("_mma_kernel", "::ln_qkv_kernel", "::attn_out_kernel",
                    "::ffn_kernel"))
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
              f"direct scorer {err_service:.3e}; {replays} graph replays of "
              f"the captured launches {one_wave} a wave, none from Python: "
              f"launches {main_launches}; a wave's kernels on the device "
              f"{wave_kernels}")
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
    phase_ok("phase 5 ok: service answers on the GPU and matches the scorer")

    # -- 6: times ------------------------------------------------------------
    # each route of B1 and B2: fp32 on its 3xTF32 kernels (the route) and on
    # the SIMT kernels (by name, off every main path but B10's yardstick),
    # bf16 on the tensor cores; the fp32 rows carry both bounds
    d, h, d_ff = 128, 4, 512
    timed = {}
    for kernel_name in ("attention_sublayer_fwd", "ffn_sublayer_fwd"):
        for dtype in (torch.float32, torch.bfloat16):
            attn = kernel_name == "attention_sublayer_fwd"
            if attn:
                args = attn_inputs(gen, B, L, d, dtype, dev)
                xx, mask, g, bb, wqkv, bqkv, wout, bout = args
                lib_args = [xx, torch.zeros(B, 1, 1, L, dtype=dtype,
                                            device=dev).masked_fill(
                    mask[:, None, None, :], -1e9), g.to(dtype), bb.to(dtype),
                    wqkv.to(dtype), bqkv.to(dtype), wout.to(dtype),
                    bout.to(dtype), h]
                launch = (lambda w: b1_launch_fwd(w, *args, h))
                plain = (lambda: attention_sublayer_fwd_plain(*args, h))
                lib_fn = (lambda: b1_library(*lib_args))
                flops = (2 * B * L * d * 3 * d + 2 * 2 * B * h * L * L
                         * (d // h) + 2 * B * L * d * d)
                moved = 2 * nbytes(xx) + nbytes(*args[1:])
                err_key = ("attn", B, L, d, dtype)
                way0 = b1_route(dtype, d, h)
            else:
                args = ffn_inputs(gen, B, L, d, d_ff, dtype, dev)
                lib_args = [args[0]] + [p.to(dtype) for p in args[1:]]
                launch = (lambda w: b2_launch_fwd(w, *args))
                plain = (lambda: ffn_sublayer_fwd_plain(*args))
                lib_fn = (lambda: b2_library(*lib_args))
                flops = 2 * 2 * B * L * d * d_ff
                moved = 2 * nbytes(args[0]) + nbytes(*args[1:])
                err_key = ("ffn", B, L, d, d_ff, dtype)
                way0 = b2_route(dtype, d, d_ff)
            plain_ms, lib_ms = median_ms(plain), median_ms(lib_fn)
            lib_dev_ms = graph_ms(lib_fn)
            for way in ((way0, "simt") if dtype == torch.float32
                        else (way0,)):
                if way == way0:
                    err = errs[err_key]
                else:
                    err = rel_err(launch(way), plain())[0]
                    assert err <= KERNEL_TOL[dtype]["atol"] + KERNEL_TOL[
                        dtype]["rtol"] * plain().float().abs().max().item()
                ms = median_ms(lambda: launch(way))
                dev_ms = graph_ms(lambda: launch(way))
                rate = "tf32x3" if way == "tf32x3" else dtype
                bound_ms, bound_by = bound(flops, moved, rate)
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
                if way == "tf32x3":
                    row["bound_simt_ms"] = bound(flops, moved, dtype)[0]
                print(f"time {row['name']} {dtype} B={B} L={L} d={d}: kernel "
                      f"{ms:.4f} ms (device {dev_ms:.4f}), plain "
                      f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (device "
                      f"{lib_dev_ms:.4f}), bound {bound_ms:.4f} ms "
                      f"({bound_by}: {flops / 1e9:.3f} GFLOP, "
                      f"{moved / 1e6:.2f} MB)"
                      + (f"; SIMT fp32 bound {row['bound_simt_ms']:.4f} ms"
                         if way == "tf32x3" else "") + f" {tag}")
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
    # the tensor-core routes (bf16 "mma", fp32 "tf32x3") at each head-width
    # class and L, dropout 0 and 0.3; then qkv one element (2 or 4 bytes)
    # off a 16-byte boundary at aligned head widths
    for dtype, way, gen_w in ((torch.bfloat16, "mma", gen_mma),
                              (torch.float32, "tf32x3", gen_f32)):
        mma_bwd_worst = 0.0
        for d, h in B1_MMA_WIDTHS:
            for l in (1, 65, 240, 1024):
                for p in (0.0, 0.3):
                    _, share = b1_mma_case(gen_w, 2 if l == 1024 else 3, l,
                                           d, h, p, dev, dtype=dtype)
                    mma_bwd_worst = max(mma_bwd_worst, share)
            print(f"B1 ({way}) fwd and bwd vs plain d={d} h={h} (d_k "
                  f"{d // h}) {dtype}, L in (1, 65, 240, 1024), p in (0, "
                  f"0.3): ok, a second backward bit for bit")
        for d, h in ((128, 4), (96, 2), (144, 2)):
            for p in (0.0, 0.3):
                _, share = b1_mma_case(gen_w, 3, 65, d, h, p, dev, offset=1,
                                       dtype=dtype)
                mma_bwd_worst = max(mma_bwd_worst, share)
        print(f"B1 ({way}) backward with qkv one element off a 16-byte "
              f"boundary at d_k 32, 48, 72: ok; worst gradient error of all "
              f"{way} cases {mma_bwd_worst:.2f} of its tolerance")
    # B2's tensor-core routes at each width class and L, dropout 0 and 0.3,
    # with the C5 replay; then x and dy off a 16-byte boundary
    for dtype, way, gen_w in ((torch.bfloat16, "mma", gen_b2),
                              (torch.float32, "tf32x3", gen_b2_f32)):
        b2_bwd_worst, b2_flips = 0.0, 0
        for d, d_ff in B2_MMA_WIDTHS:
            for l in (1, 65, 240, 1024):
                for p in (0.0, 0.3):
                    _, share, flips = b2_mma_case(
                        gen_w, 2 if l == 1024 else 3, l, d, d_ff, p, dev,
                        dtype=dtype)
                    b2_bwd_worst = max(b2_bwd_worst, share)
                    b2_flips += flips
            print(f"B2 ({way}) fwd and bwd vs plain d={d} d_ff={d_ff} "
                  f"{dtype}, L in (1, 65, 240, 1024), p in (0, 0.3): ok, a "
                  f"second backward bit for bit")
        for d, d_ff in ((128, 512), (96, 384), (144, 512)):
            for p in (0.0, 0.3):
                _, share, flips = b2_mma_case(gen_w, 3, 65, d, d_ff, p, dev,
                                              offset=1, dtype=dtype)
                b2_bwd_worst = max(b2_bwd_worst, share)
                b2_flips += flips
        # the edges: d < 16 and d_ff not a whole chunk; d not a whole
        # 16-column step, d_ff 1000; one row of the widest
        for b, l, d, d_ff in ((3, 70, 8, 72), (2, 65, 100, 1000),
                              (1, 1, 256, 1000)):
            for p in (0.0, 0.3):
                _, share, flips = b2_mma_case(gen_w, b, l, d, d_ff, p, dev,
                                              dtype=dtype)
                b2_bwd_worst = max(b2_bwd_worst, share)
                b2_flips += flips
        print(f"B2 ({way}) with x and dy one element off a 16-byte boundary "
              f"at d 128, 96, 144, and at the edges (d, d_ff) = (8, 72), "
              f"(100, 1000), (256, 1000) at L = 1: ok; worst gradient error "
              f"of all {way} cases {b2_bwd_worst:.2f} of its tolerance, "
              f"{b2_flips} gate flips replayed in all")
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
    phase_ok("phase 7 ok: B1 and B2 backward kernels (and the forwards at "
             "p=0.3 and 0.4) match their plain versions, masks bit-identical")

    # -- 8: B3 against its plain version -----------------------------------------
    # each cluster size at its edges (1 block a slate to k = 32, 2 to 64, 4
    # beyond) and one to six slates; the counts exact, the dummy slate and
    # padded documents without gradient, a second run the same bits
    b3_errs = {"lambda_pairs_fwd": 0.0, "lambda_pairs_bwd": 0.0}
    b3_cases = [(B, l) for l in (1, 31, 32, 33, 64, 65, 240, 384)] + [
        (1, 240), (6, 33), (6, 384)]
    for b, l in b3_cases:
        ts = torch.randint(0, 5, (b, l), generator=gen).float()
        valid = (torch.rand(b, l, generator=gen) > 0.15).float()
        if b > 1:
            valid[-1] = 0.0  # a dummy slate
        yp = torch.randn(b, l, generator=gen) * valid
        g = (2.0 ** ts - 1.0) / 30.0
        pair_args = [t.to(dev) for t in (yp, ts, g, valid)]
        gout = torch.linspace(0.5, 1.5, b, device=dev)
        for scheme in SCHEMES:
            for k in (None, 10):
                kw = dict(scheme=scheme, k_eff=l if k is None else min(k, l),
                          sigma=1.0, mu=10.0, log_base="binary", eps=1e-10)
                before = (lambda_pairs_fwd.launches,
                          lambda_pairs_bwd.launches)
                loss, cnt = lambda_pairs_fwd(*pair_args, **kw)
                dyp = lambda_pairs_bwd(*pair_args, gout, **kw)
                assert (lambda_pairs_fwd.launches,
                        lambda_pairs_bwd.launches) == (
                    before[0] + 1, before[1] + 1), "B3 did not launch"
                ref_loss, ref_cnt = lambda_pairs_fwd_plain(*pair_args, **kw)
                assert torch.equal(cnt, ref_cnt), (scheme, k, b, l)
                torch.testing.assert_close(loss, ref_loss, **B3_VALUE_TOL)
                ref_dyp = lambda_pairs_bwd_plain(*pair_args, gout, **kw)
                torch.testing.assert_close(
                    dyp, ref_dyp, rtol=B3_GRAD_RTOL,
                    atol=B3_GRAD_ATOL * ref_dyp.abs().max().item() + 1e-6)
                assert not dyp[pair_args[3] < 0.5].any(), (
                    "a padded document or the dummy slate took a gradient")
                again = lambda_pairs_fwd(*pair_args, **kw)
                assert torch.equal(loss, again[0]) and torch.equal(
                    cnt, again[1]), "B3's forward moved on a second run"
                assert torch.equal(dyp, lambda_pairs_bwd(
                    *pair_args, gout, **kw)), "B3's backward moved"
                if (b, l) == (B, L) and k is None and (
                        scheme == "ndcgLoss2PP_scheme"):
                    b3_errs["lambda_pairs_fwd"] = rel_err(loss, ref_loss)[0]
                    b3_errs["lambda_pairs_bwd"] = rel_err(dyp, ref_dyp)[0]
    print(f"B3 vs plain, 8 schemes x k in (all, 10) x (B, k) in {b3_cases} "
          f"(clusters of {sorted({cluster_size(l) for _, l in b3_cases})} "
          f"blocks): ok, counts exact, reruns bit for bit; at B={B} k={L} "
          f"ndcgLoss2PP max_abs_err loss {b3_errs['lambda_pairs_fwd']:.3e}, "
          f"grad {b3_errs['lambda_pairs_bwd']:.3e}")
    phase_ok("phase 8 ok: lambdaLoss pair-chain kernels match their plain "
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
    gl, cl, step_err, flips9 = step_one_gpu_vs_cpu(
        cfg0, gpu_model, (xb, yb, ib), gate_flips=True)
    # fp32 training: B1 and B2 on their 3xTF32 routes only
    b1_fp32_routes, b2_fp32_routes = b1_routes(), b2_routes()
    for routes in (b1_fp32_routes, b2_fp32_routes):
        assert (routes[0]["mma"] == routes[1]["mma"] == 0
                and routes[0]["simt"] == routes[1]["simt"] == 0
                and routes[1]["tf32x3"] == 4), routes
    print(f"train step 1 at dropout 0, fp32, GPU vs CPU plain: loss {gl:.6f} "
          f"vs {cl:.6f}; worst gradient error {step_err:.3f} of its "
          f"tolerance ({STEP_GRAD_TOL} x its tensor's max + 1e-5 x the "
          f"largest gradient), FFN units with a ReLU gate flipped per block "
          f"(held out, replayed) {flips9}")
    phase_ok("phase 9 ok: "
             "the paper-config train step runs on the card through "
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
                way0 = b1_route(dtype, d, h)
                # each route's backward on its own forward's saved state
                saved = {w: b1_launch_fwd(w, *args, h, return_saved=True)[1]
                         for w in ((way0, "simt") if dtype == torch.float32
                                   else (way0,))}
                launch = (lambda w: b1_launch_bwd(w, *args, dy, h,
                                                  saved=saved[w]))
                plain = (lambda: attention_sublayer_bwd_plain(*args, dy, h))
                lib_fn = b1_library_bwd(args, dy, h)
                # each product once: dO, S, dP, ctx, dQ, dK, dV, dn, dWqkv,
                # dWout
                flops = 16 * m_rows * d * d + 12 * B * h * L * L * (d // h)
                params = nbytes(*args[2:])
                moved = (nbytes(args[0], args[1], dy, *saved[way0]) + params
                         + m_rows * d * esz + params)
            else:
                args = ffn_inputs(gen, B, L, d, d_ff, dtype, dev)
                way0 = b2_route(dtype, d, d_ff)
                launch = (lambda w: b2_launch_bwd(w, *args, dy))
                plain = (lambda: ffn_sublayer_bwd_plain(*args, dy))
                lib_fn = b2_library_bwd(args, dy)
                # pre, dh, dn, dW1, dW2
                flops = 10 * m_rows * d * d_ff
                params = nbytes(*args[1:])
                moved = nbytes(args[0], dy) + params + m_rows * d * esz + params
            plain_ms = median_ms(plain, iters=20)
            lib_ms = median_ms(lib_fn, iters=20)
            # autograd's engine refuses CUDA-graph capture: the library
            # backward's device time is the sum of its kernels in a trace
            # (not measured where every trace lost device events)
            try:
                lib_dev_ms = sum(kernel_ms(lib_fn).values())
            except IncompleteTrace as err:
                print(f"library backward: {err} {tag}")
                lib_dev_ms = None
            for way in ((way0, "simt") if dtype == torch.float32
                        else (way0,)):
                if way == way0:
                    err = bwd_errs[(kernel_name, B, L, d, dtype, 0.0)]
                elif kernel_name == "ffn_sublayer_bwd":
                    err = b2_replay(launch(way), args, dy, 0.0, (0, 0))[0]
                else:
                    rtol, atol = BWD_TOL[dtype]
                    err = 0.0
                    for g, r in zip(launch(way), plain()):
                        e, sc = rel_err(g, r)
                        assert e <= rtol * sc + atol, (kernel_name, way, e)
                        err = max(err, e)
                ms = median_ms(lambda: launch(way), iters=20)
                dev_ms = graph_ms(lambda: launch(way))
                rate = "tf32x3" if way == "tf32x3" else dtype
                bound_ms, bound_by = bound(flops, moved, rate)
                row, sfx = timing_row(timed, kernel_name, dtype, way)
                row.update({f"max_abs_err{sfx}": err,
                            f"ms{sfx}": ms, f"device_ms{sfx}": dev_ms,
                            f"plain_ms{sfx}": plain_ms,
                            f"bound_ms{sfx}": bound_ms,
                            f"bound_by{sfx}": bound_by,
                            f"library_ms{sfx}": lib_ms,
                            f"library_device_ms{sfx}": lib_dev_ms,
                            f"gflop{sfx}": flops / 1e9,
                            f"mbytes{sfx}": moved / 1e6})
                if way == "tf32x3":
                    row["bound_simt_ms"] = bound(flops, moved, dtype)[0]
                lib_txt = ("not measured" if lib_dev_ms is None
                           else f"{lib_dev_ms:.4f}")
                print(f"time {row['name']} {dtype} B={B} L={L} d={d}: kernel "
                      f"{ms:.4f} ms (device {dev_ms:.4f}), plain "
                      f"{plain_ms:.4f} ms, library (autograd) {lib_ms:.4f} ms "
                      f"(device, its kernels' sum: {lib_txt}), bound "
                      f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} "
                      f"GFLOP, {moved / 1e6:.2f} MB)"
                      + (f"; SIMT fp32 bound {row['bound_simt_ms']:.4f} ms"
                         if way == "tf32x3" else "") + f" {tag}")
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
    # needs each c_ij once, as the kernel evaluates it (adding it to row
    # i's sum and to column j's)
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
    # the "cluster" route at each cluster size of the recipes' lengths (2
    # blocks at L=240 and 241, 8 at 512) and past the clusters the card
    # holds (N=2048); ds against the plain version run in float64 end to end
    # (records and all): the plain version in fp32 is itself 1.2e-4 of
    # max|ds| off it at L=300 and 361 transposed
    T = SINKHORN_ITERS
    soft_errs = {}
    for backward in (False, True):
        for l in range(1, 513):
            plan = cluster_plan(l, backward)
            assert kernel_cluster_blocks(l) == plan[0]
            assert kernel_smem_floats(l, plan[0], backward) * 4 == plan[1]
    for n, l in ((B, L), (2048, L), (B, 241), (2048, 241), (B, 512)):
        for transpose in (False, True):
            sc, pad, vec, dout = soft_sort_inputs(gen, n, l, dev)
            before = (dict(soft_sort_fwd.route_launches),
                      dict(soft_sort_bwd.route_launches))
            out, a_hist, b_hist = soft_sort_fwd(sc, pad, vec, 1.0, T,
                                                transpose)
            ds = soft_sort_bwd(sc, pad, vec, a_hist, b_hist, dout, 1.0, T,
                               transpose)
            torch.cuda.synchronize()
            for k, was in zip((soft_sort_fwd, soft_sort_bwd), before):
                assert k.route_launches == {
                    **was, "cluster": was["cluster"] + 1}, (
                        "B8 did not launch its cluster route")
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
            f_err = rel_err(out, ref)[0]
            del ref, ref_a, ref_b
            g32 = rel_err(ds, soft_sort_bwd_plain(
                sc, pad, vec, a_hist, b_hist, dout, 1.0, T, transpose))[0]
            args64 = [t.double() for t in (sc, pad, vec)]
            ref_ds = soft_sort_bwd_plain(
                *args64, *soft_sort_fwd_plain(*args64, 1.0, T,
                                              transpose)[1:],
                dout.double(), 1.0, T, transpose)
            g_err = assert_grad_close(ds, ref_ds, f"B8 ds N={n} L={l}")
            assert not ds[pad > 0.5].any(), "a padded document's gradient"
            again = soft_sort_fwd(sc, pad, vec, 1.0, T, transpose)
            assert all(torch.equal(x, y) for x, y in zip(
                (out, a_hist, b_hist), again)), "B8 moved on a second run"
            assert torch.equal(ds, soft_sort_bwd(
                sc, pad, vec, a_hist, b_hist, dout, 1.0, T, transpose))
            if (n, l) == (B, L) and not transpose:
                soft_errs = {"soft_sort_fwd": f_err, "soft_sort_bwd": g_err}
            print(f"B8 (cluster, {cluster_plan(l, False)[0]} / "
                  f"{cluster_plan(l, True)[0]} blocks) vs plain N={n} L={l} "
                  f"transpose={transpose}: max_abs_err out {f_err:.3e} (tol "
                  f"{SOFT_TOL}), ds {g_err:.3e} of max|ref| "
                  f"{rel_err(ds, ref_ds)[1]:.3e} against float64 (tol "
                  f"{SOFT_GRAD_TOL[0]:g} x; the fp32 plain version's ds "
                  f"{g32:.3e} away); reruns bit for bit")
            del ref_ds, args64, again
    # route "l2" by name (csrc/neuralsort.cu, one block a slate, M0 in L2;
    # on no main path): its plain version's, counted under its name alone
    for transpose in (False, True):
        sc, pad, vec, dout = soft_sort_inputs(gen, B, L, dev)
        before = (dict(soft_sort_fwd.route_launches),
                  dict(soft_sort_bwd.route_launches))
        out, a_hist, b_hist = b8_launch_fwd("l2", sc, pad, vec, 1.0, T,
                                            transpose)
        ds = b8_launch_bwd("l2", sc, pad, vec, a_hist, b_hist, dout, 1.0, T,
                           transpose)
        torch.cuda.synchronize()
        for k, was in zip((soft_sort_fwd, soft_sort_bwd), before):
            assert k.route_launches == {**was, "l2": was["l2"] + 1}
        ref, ref_a, ref_b = soft_sort_fwd_plain(sc, pad, vec, 1.0, T,
                                                transpose)
        torch.testing.assert_close(out, ref, **SOFT_TOL)
        torch.testing.assert_close(a_hist, ref_a, rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(b_hist, ref_b, rtol=1e-3, atol=1e-6)
        ref_ds = soft_sort_bwd_plain(sc, pad, vec, a_hist, b_hist, dout, 1.0,
                                     T, transpose)
        g_err = assert_grad_close(ds, ref_ds, "B8 l2 ds")
        if not transpose:
            soft_errs.update({"soft_sort_fwd_l2": rel_err(out, ref)[0],
                              "soft_sort_bwd_l2": g_err})
        print(f"B8 (l2, by name) vs plain N={B} L={L} transpose={transpose}"
              f": max_abs_err out {rel_err(out, ref)[0]:.3e}, ds "
              f"{g_err:.3e} of max|ref| {rel_err(ds, ref_ds)[1]:.3e}")
        del ref, ref_a, ref_b, ref_ds
    phase_ok("phase 11 ok: fused soft-sort kernels match their plain versions")

    # -- 12: B7 against its plain version -------------------------------------
    # both routes: "cluster" (the main one, a slate's M0 on a cluster of
    # b7_plan(L)[0] blocks: 8 at L=640, 16 at 768) and "l2" by name, at the
    # NeuralNDCG step's length and the envelope's edge, each with a fully
    # padded slate; the planner against the kernel's own counts at every L
    for backward in (False, True):
        for l in range(1, 769):
            plan = b7_plan(l, backward)
            assert b7_kernel_blocks(l) == plan[0], (l, plan)
            assert b7_kernel_floats(l, plan[0], backward) * 4 == plan[1]
    n7, l7 = 8, 640
    sink_errs = {}
    for n, l in ((n7, l7), (2, 768)):
        m0 = premasked_matrices(gen, n, l, dev)
        dp = torch.randn(n, l, l, generator=gen).to(dev)
        if (n, l) == (n7, l7):
            dp7 = dp
        ref_p, ref_a, ref_b = sinkhorn_fwd_plain(m0, T)
        for way in B7_ROUTES:
            before = (dict(sinkhorn_fwd.route_launches),
                      dict(sinkhorn_bwd.route_launches))
            p_out, a_hist, b_hist = b7_launch_fwd(way, m0, T)
            dm0 = b7_launch_bwd(way, m0, a_hist, b_hist, dp, T)
            torch.cuda.synchronize()
            for k, was in zip((sinkhorn_fwd, sinkhorn_bwd), before):
                assert k.route_launches == {**was, way: was[way] + 1}, (
                    f"B7 did not launch its {way} route")
            assert torch.isfinite(p_out).all()
            torch.testing.assert_close(p_out, ref_p, **SOFT_TOL)
            torch.testing.assert_close(a_hist, ref_a, rtol=1e-3, atol=1e-6)
            torch.testing.assert_close(b_hist, ref_b, rtol=1e-3, atol=1e-6)
            p_err = rel_err(p_out, ref_p)[0]
            ref_dm0 = sinkhorn_bwd_plain(m0, a_hist, b_hist, dp, T)
            g_err = assert_grad_close(dm0, ref_dm0,
                                      f"B7 ({way}) dM0 N={n} L={l}")
            again = b7_launch_fwd(way, m0, T)
            assert all(torch.equal(x, y) for x, y in zip(
                (p_out, a_hist, b_hist), again)), "B7 moved on a second run"
            assert torch.equal(dm0, b7_launch_bwd(way, m0, a_hist, b_hist,
                                                  dp, T))
            if (n, l) == (n7, l7):
                sfx = "" if way == "cluster" else "_l2"
                sink_errs.update({f"sinkhorn_fwd{sfx}": p_err,
                                  f"sinkhorn_bwd{sfx}": g_err})
            blocks = (f"{b7_plan(l, False)[0]} blocks, the card holding "
                      f"{b7_occupancy(b7_plan(l, False), False, dev)} such "
                      f"clusters at once" if way == "cluster" else
                      "one block a slate")
            print(f"B7 ({way}, {blocks}) vs plain N={n} L={l}: max_abs_err "
                  f"P {p_err:.3e} (tol {SOFT_TOL}), dM0 {g_err:.3e} of "
                  f"max|ref| {ref_dm0.abs().max().item():.3e} (tol "
                  f"{SOFT_GRAD_TOL[0]:g} x); reruns bit for bit")
            del again, p_out, a_hist, b_hist, dm0, ref_dm0
        del m0, dp, ref_p, ref_a, ref_b
        torch.cuda.empty_cache()
    phase_ok("phase 12 ok: Sinkhorn kernels match their plain versions on "
             "both routes")

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
                                "ffn_sublayer_bwd", "soft_sort_fwd",
                                "soft_sort_bwd", "sinkhorn_fwd",
                                "sinkhorn_bwd"),
                               b1_routes() + b2_routes() + tuple(
                                   dict(k.route_launches) for k in (
                                       soft_sort_fwd, soft_sort_bwd,
                                       sinkhorn_fwd, sinkhorn_bwd))):
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
        if loss_kernel == "soft_sort":  # B8 on its main route alone
            want["soft_sort_fwd[cluster]"] = fwd
            want["soft_sort_bwd[cluster]"] = bwd
        return want

    # removed after phase 34, or when the script ends, also by an
    # exception: the later CLI runs, the evaluate CLI and the rank-and-click
    # CLI read the same dataset; phases 26 and 34 evaluate this run's
    # NeuralNDCG model.npz and phase 34 ranks with the ndcgloss2pp run's
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
    paper_out_dir = out_dir  # its model.npz is ranked in phase 34
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
    # B7 on its main route once each way, route "l2" and B8 not at all
    assert (b7_launches["sinkhorn_fwd"], b7_launches["sinkhorn_bwd"],
            b7_launches["sinkhorn_fwd[cluster]"],
            b7_launches["sinkhorn_bwd[cluster]"],
            b7_launches["sinkhorn_fwd[l2]"], b7_launches["sinkhorn_bwd[l2]"],
            b7_launches["soft_sort_fwd"]) == (1, 1, 1, 1, 0, 0, 0), (
                b7_launches)
    print(f"NeuralNDCG train step at B={n7} L={l7}: loss {loss7.item():.6f}, "
          f"launches {b7_launches}")

    # step 1 at dropout 0 in fp32: the card's kernels against the CPU
    ncfg0 = Config.from_json(NEURAL_CONFIG)
    ncfg0.model.transformer.dropout = 0.0
    gpu_model = LTRModel(make_model(ncfg0.model, N_FEATURES),
                         torch.Generator().manual_seed(0), device=dev)
    gl, cl, step_err, flips13 = step_one_gpu_vs_cpu(
        ncfg0, gpu_model, [t[:8] for t in (xb, yb, ib)], gate_flips=True)
    print(f"NeuralNDCG train step 1 at dropout 0, fp32, B=8 L={L}, GPU vs "
          f"CPU plain: loss {gl:.6f} vs {cl:.6f}; worst gradient error "
          f"{step_err:.3f} of its tolerance, gates flipped per block "
          f"{flips13}")
    phase_ok("phase 13 ok: "
             "the train CLI runs both recipes on the card through "
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
            # route "l2" by name: the same function and work
            ("soft_sort_fwd_l2",
             (lambda: b8_launch_fwd("l2", sc, pad, vec, 1.0, T, False),
              lambda: soft_sort_fwd_plain(sc, pad, vec, 1.0, T, False)),
             lib[0], B * (4 * T + 14) * L * L,
             B * L * (3 * 4 + 4 + hist_bytes), f"N={B} L={L}"),
            ("soft_sort_bwd_l2",
             (lambda: b8_launch_bwd("l2", sc, pad, vec, a_hist, b_hist, dout,
                                    1.0, T, False),
              lambda: soft_sort_bwd_plain(sc, pad, vec, a_hist, b_hist, dout,
                                          1.0, T, False)),
             lib[1], B * (8 * T + 31) * L * L,
             B * L * (4 * 4 + 4 + hist_bytes), f"N={B} L={L}"),
            # B7 on its main route "cluster", then "l2" by name: M0 in and P
            # out, 2 T matvecs; the backward M0 and dP in and dM0 out, 2 T
            # matvecs and the two [L, T] . [T, L] products
            ("sinkhorn_fwd",
             (lambda: sinkhorn_fwd(m0, T), lambda: sinkhorn_fwd_plain(m0, T)),
             lib7[0], n7 * (4 * T + 2) * l7 * l7,
             n7 * (2 * 4 * l7 * l7 + l7 * hist_bytes), f"N={n7} L={l7}"),
            ("sinkhorn_bwd",
             (lambda: sinkhorn_bwd(m0, a7, b7, dp7, T),
              lambda: sinkhorn_bwd_plain(m0, a7, b7, dp7, T)),
             lib7[1], n7 * (8 * T + 8) * l7 * l7,
             n7 * (3 * 4 * l7 * l7 + l7 * hist_bytes), f"N={n7} L={l7}"),
            ("sinkhorn_fwd_l2",
             (lambda: b7_launch_fwd("l2", m0, T),
              lambda: sinkhorn_fwd_plain(m0, T)),
             lib7[0], n7 * (4 * T + 2) * l7 * l7,
             n7 * (2 * 4 * l7 * l7 + l7 * hist_bytes), f"N={n7} L={l7}"),
            ("sinkhorn_bwd_l2",
             (lambda: b7_launch_bwd("l2", m0, a7, b7, dp7, T),
              lambda: sinkhorn_bwd_plain(m0, a7, b7, dp7, T)),
             lib7[1], n7 * (8 * T + 8) * l7 * l7,
             n7 * (3 * 4 * l7 * l7 + l7 * hist_bytes), f"N={n7} L={l7}")):
        ms, plain_ms, lib_ms = (median_ms(fn, iters=20)
                                for fn in fns + (lib_fn,))
        # the kernel and the library on one clock, the device's
        dev_ms = graph_ms(fns[0])
        lib_dev_ms = library_device_ms(lib_fn, "_bwd" in kernel_name)
        bound_ms, bound_by = bound(flops, moved, torch.float32)
        rows.append({"name": kernel_name, "route": "cuda",
                     "max_abs_err": {**soft_errs, **sink_errs}[kernel_name],
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "gflop": flops / 1e9, "mbytes": moved / 1e6})
        lib_txt = ("not measured" if lib_dev_ms is None
                   else f"{lib_dev_ms:.4f} ms")
        print(f"time {kernel_name} float32 {shape}: kernel {ms:.4f} ms "
              f"({dev_ms:.4f} ms of device time, 20 calls in one CUDA "
              f"graph), plain {plain_ms:.4f} ms, library (torch-op chain, "
              f"autograd) {lib_ms:.4f} ms ({lib_txt} of device time), bound "
              f"{bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
              f"{moved / 1e6:.3f} MB) {tag}")

    # -- 15: B9 against its plain version ---------------------------------------
    t15 = time.perf_counter()
    eps = 1e-10
    b9_errs = {"approx_pos_fwd": 0.0, "approx_pos_bwd": 0.0}
    # the kernels' reciprocal of 1 + e has __frcp_rn's bits on all of [1, 2]
    rcp_bad = reciprocal_mismatches(dev)
    assert rcp_bad == 0, f"B9's reciprocal: {rcp_bad} floats off __frcp_rn"
    print("B9's reciprocal of 1 + e vs __frcp_rn at every float of [1, 2]: "
          "bit for bit")
    # the scattered masks draw from a generator of their own, so that every
    # other phase's inputs stay as they were before them
    gen_b9 = torch.Generator().manual_seed(2020)
    for n, l, scale, scattered in (
            (B, L, 1.0, False), (B, L, 1e4, False), (3, 1, 1.0, False),
            (5, 37, 1.0, False), (2, 1308, 1.0, False), (2, 4096, 1.0, False),
            (B, L, 1.0, True), (2, 4097, 1.0, True), (2, 6000, 1.0, True),
            (2, 6144, 1.0, True), (2, 8192, 1.0, True)):
        sc, valid, u = approx_inputs(gen_b9 if scattered else gen, n, l,
                                     scale, scattered)
        sc, valid, u = (t.to(dev) for t in (sc, valid, u))
        for alpha in (0.1, 1.0, 10.0):
            before = (approx_pos_fwd.launches, approx_pos_bwd.launches)
            pos = approx_pos_fwd(sc, valid, alpha, eps)
            ds = approx_pos_bwd(sc, valid, u, alpha, eps)
            torch.cuda.synchronize()
            assert (approx_pos_fwd.launches, approx_pos_bwd.launches) == (
                before[0] + 1, before[1] + 1), "B9 did not launch"
            # no atomics, sums in a fixed order: a rerun gives the same bits
            assert torch.equal(pos, approx_pos_fwd(sc, valid, alpha, eps))
            assert torch.equal(ds, approx_pos_bwd(sc, valid, u, alpha, eps))
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
            if (n, l, scale, alpha, scattered) == (B, L, 1.0, 1.0, False):
                b9_errs = {"approx_pos_fwd": rel_err(pos, ref)[0],
                           "approx_pos_bwd": g_err}
            print(f"B9 vs plain N={n} L={l} "
                  f"{'scattered' if scattered else 'ragged'} mask, scores "
                  f"x{scale:g} alpha={alpha}: max_abs_err pos "
                  f"{rel_err(pos, ref)[0]:.3e} (max "
                  f"{ref.max().item():.1f}; tol {B9_VALUE_TOL}), ds "
                  f"{g_err:.3e} of max|ref| {g_scale:.3e} (tol "
                  f"{B9_GRAD_TOL[0]:g} x); a rerun bit for bit")
        del ref, ref_ds
        torch.cuda.empty_cache()
    phase_ok(f"phase 15 ok: approxNDCG rank-sum kernels match their plain "
             f"versions, ragged and scattered masks to L = 8192 "
             f"({time.perf_counter() - t15:.1f} s)")

    # -- 16: B6 against its plain version and against B3 -----------------------
    def pair_inputs(b, k):
        ts = torch.randint(0, 5, (b, k), generator=gen).float()
        valid = (torch.rand(b, k, generator=gen) > 0.15).float()
        valid[0, 5 * k // 8 + 3:] = 0.0  # valid documents end mid-tile
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
    for b, k in ((B, 512), (LONG_B, LONG_L), (8, 1308), (2, 4096), (4, 385)):
        pair_args = pair_inputs(b, k)
        gout = torch.linspace(0.5, 1.5, b, device=dev)
        for scheme in SCHEMES:
            for log_base, k_eff in (("binary", k), ("natural", 3 * k // 4),
                                    ("binary", 10)):
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
                assert not dyp[0, 5 * k // 8 + 3:].any()
                if k_eff < k:
                    assert not dyp[:, k_eff:].any()
                again = (*lambda_tiled_fwd(*pair_args, **kw),
                         lambda_tiled_bwd(*pair_args, gout, **kw))
                assert all(torch.equal(x, y) for x, y in zip(
                    again, (loss, cnt, dyp))), "B6 rerun differs"
                if scheme == "ndcgLoss2PP_scheme" and k_eff == k:
                    b6_errs[(b, k)] = (rel_err(loss, ref[0])[0],
                                       rel_err(dyp, ref[2])[0],
                                       ref[0].abs().max().item(),
                                       ref[2].abs().max().item())
                del ref
        e = b6_errs[(b, k)]
        print(f"B6 vs plain B={b} k={k} (slate 0's documents ending "
              f"mid-tile, the last slate padded), 8 schemes x (binary, "
              f"k_eff=k; natural, k_eff=3k/4; binary, k_eff=10): ok, counts "
              f"exact, a rerun bit for bit; ndcgLoss2PP "
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
    phase_ok("phase 16 ok: row-tiled lambdaLoss kernels match their plain "
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
    phase_ok("phase 17 ok: "
             "all seven paper recipes train through the CLI on the "
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
        gl, cl, worst, flips18 = step_one_gpu_vs_cpu(
            cfg, flagship_model(dev, 0.0, head), (xb, yb, ib),
            loss=(loss_name, loss_args), gate_flips=True)
        print(f"train step, flagship model, {loss_name} B={B} L={L}: bf16 "
              f"with dropout 0.1 loss {loss.item():.6f}; step 1 at dropout 0, "
              f"fp32, GPU vs CPU plain: loss {gl:.6f} vs {cl:.6f}, worst "
              f"gradient error {worst:.3f} of its tolerance, gates flipped "
              f"per block {flips18}")
    phase_ok("phase 18 ok: "
             "every loss name takes a train step on the card that "
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
    gl, cl, worst, flips19 = step_one_gpu_vs_cpu(
        lcfg, paper_setup(dev, dropout=0.0)[1],
        [t[:4] for t in long_batch], gate_flips=True)
    print(f"long-slate train step 1 at dropout 0, fp32, B=4 L={LONG_L}, GPU "
          f"vs CPU plain: loss {gl:.6f} vs {cl:.6f}; worst gradient error "
          f"{worst:.3f} of its tolerance, gates flipped per block {flips19}")
    phase_ok("phase 19 ok: lambdaLoss trains at L=1024 through the row-tiled "
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
    rows.append(short_kernel_row(
        "approx_pos_fwd", lambda: approx_pos_fwd(sc, valid, 1.0, eps),
        lambda: approx_pos_fwd_plain(sc, valid, 1.0, eps), lib[0],
        approx_work(valid, False), b9_errs["approx_pos_fwd"],
        f"B={B} L={L} (200 valid)", tag))
    rows.append(short_kernel_row(
        "approx_pos_bwd", lambda: approx_pos_bwd(sc, valid, u, 1.0, eps),
        lambda: approx_pos_bwd_plain(sc, valid, u, 1.0, eps), lib[1],
        approx_work(valid, True), b9_errs["approx_pos_bwd"],
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
                                "library_ms", "library_device_ms")})
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
        ``one_key`` (fp32 at L = 1): dq and dk are 0 in exact arithmetic;
        the kernel's and the plain version's (which takes D in dP's order
        in fp32, ROADMAP Queue C6) are held to exactly 0, and to each other
        under BWD_TOL as every gradient is."""
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
                assert not g.any() and not r.any(), (kind, name,
                                                     tuple(q.shape), p)
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
    phase_ok("phase 21 ok: B4 and B5 match their plain versions forward and "
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
        # each bucket's graph: B5 and B2 forward once a block, on their
        # 3xTF32 route
        captured22, _ = graph_record(service)
        assert all(c == {"tiled_attention_fwd": 4,
                         "tiled_attention_fwd[tf32x3]": 4,
                         "ffn_sublayer_fwd": 4,
                         "ffn_sublayer_fwd[tf32x3]": 4}
                   for c in captured22.values()), captured22
        one = rng22.randn(7000, N_FEATURES).astype(np.float32)
        got = service.score(one, timeout=120)
        assert graph_record(service)[1] == 1
        xb = np.zeros((1, serve_l, N_FEATURES), dtype=np.float32)
        xb[0, :7000] = one
        direct = make_scorer(smodel, "float32")(xb, [7000]).cpu().numpy()
        assert got.shape == (7000,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, direct[0, :7000], rtol=1e-4,
                                   atol=1e-4)
    finally:
        service.close()
    print(f"service with slate_length={serve_l}: one 7000-document request "
          f"answered by one graph replay, equal to the direct scorer; each "
          f"bucket's graph captured {captured22[1]}")
    phase_ok("phase 22 ok: the scorer serves B=4 slates of L=8192 through B5")

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
              f"flipped between the two per block (held out, replayed) "
              f"{flips} (at most {GATE_FLIPS_MAX}); B4/B5 by route "
              f"{ {k: v for k, v in routes.items() if any(v.values())} } "
              f"({time.perf_counter() - t0:.1f} s)")
    phase_ok("phase 23 ok: "
             "the paper config trains at L=4096 through B5 and at "
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
    cases += [(m, k, n) for m in (1, 17, B * L + 1) for k in (1, 33, 136, 512)
              for n in (1, 7, 384, 513)]
    cases += [(65, 1025, 70)]  # K past a block's 1024: two slabs
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
          f"and M in (1, 17, {B * L + 1}) x K in (1, 33, 136, 512) x N in "
          f"(1, 7, 384, 513), and (65, 1025, 70) in two K slabs, fp32 "
          f"and bf16 x, static (one multiplier and [K]) and dynamic, .5 ties "
          f"and a zero row: {len(q8_errs)} launches, max_abs_err "
          f"{max(q8_errs)}")
    phase_ok("phase 25 ok: X1 is its plain version bit for bit")

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
    # each bucket's graph captured one call's 18 X1 and 4 B4 launches, B4
    # on its bf16 route
    q8_wave = {**{k: v for k, v in one_call.items() if v},
               "attention_fused_fwd[mma]": 4}
    captured26, replays_before = graph_record(service)
    assert all(c == q8_wave for c in captured26.values()), captured26
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
        q8_eager = q8_counts()
        replays = graph_record(service)[1] - replays_before
        with urllib.request.urlopen(url + "/statz", timeout=30) as r:
            stats = json.loads(r.read())
        waves = stats["waves_total"] - waves_before
        # one replay a wave and no launch from Python; the device ran X1's
        # and B4's bf16 kernels, 18 and 4 a wave, and no B1, B2 or B5
        assert q8_eager == dict.fromkeys(q8_eager, 0), q8_eager
        assert waves >= 1 and replays == waves, (replays, waves)
        q8_main_launches = {k: v * replays for k, v in one_call.items()}
        q8_wave_kernels = traced_launches(
            lambda: service.score(slates[0], timeout=60), 3,
            {"q8_dense_kernel": 18, "fused_fwd_mma_kernel": 4},
            refuse=("b1_", "b2_", "tiled_", "q8_dequant"))
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
              f"max_abs_err vs direct scorer {err_q8_service:.3e}; {replays} "
              f"graph replays of the captured launches {q8_wave} a wave: "
              f"launches {q8_main_launches}; a wave's kernels on the device "
              f"{q8_wave_kernels}")
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
    phase_ok("phase 26 ok: int8 serving through make_scorer, the service and "
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
    from allrank_tpu_torch.ops.encoder_block import ROUTES as B10_ROUTES
    from allrank_tpu_torch.ops.encoder_block import route as b10_route

    for backward in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            grid = cooperative_grid(128, dtype, backward, dev, h=4)
            print(f"B10 {'backward' if backward else 'forward'} {dtype} at "
                  f"d=128, h=4 ({'/'.join(b10_route(dtype, 128, 4, 512))}): "
                  f"cooperative grid {grid['grid']} blocks "
                  f"({grid['blocks_per_sm']} per SM x {grid['sms']} SMs), "
                  f"{grid['smem_bytes']} B of shared memory a block")
            assert grid["grid"] == grid["blocks_per_sm"] * grid["sms"]
    enc_errs, c4 = {}, {}
    for k in (encoder_block_fwd, encoder_block_bwd):
        k.route_launches = dict.fromkeys(B10_ROUTES, 0)

    def worst_share(got, ref):
        """The largest max-abs error of ``got`` against ``ref``, tensor by
        tensor, as a share of the reference tensor's largest value."""
        return max(e / (r + 1e-30) for e, r in map(rel_err, got, ref))

    # B10's reference: the chained kernels on its own routes. B1's SIMT
    # kernels run here at d_k > 128, B2's nowhere: their launches are this
    # chain's, counted from 0
    reset_routes()
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
                chained_y, state = encoder_chained_fwd(*args28, h, p)
                chained = encoder_chained_bwd(state, mask28, seeds28, stacks,
                                              fs, dy28, h, p)
                plain_y = encoder_forward_plain(*args28, **kw)
                plain = encoder_backward_plain(*args28, dy28, **kw)
                torch.cuda.synchronize()
                if (b, l, d, h) == C4_CASE:
                    ref32 = encoder_backward_plain(
                        x28.float(), mask28, seeds28, stacks, fs, fb,
                        dy28.float(), **kw)
                    c4[(dtype, p)] = tuple(worst_share(t, ref32)
                                           for t in (got, chained))
                    del ref32
                # the backward on the forward's parked state: the replaying
                # backward's bits; and a second backward's
                y_parked, saved = encoder_block_fwd(*args28, **kw,
                                                    return_saved=True)
                parked = encoder_block_bwd(*args28, dy28, **kw, saved=saved)
                again = encoder_block_bwd(*args28, dy28, **kw, saved=saved)
                assert torch.equal(y_parked, y28), "B10: parked y differs"
                assert all(torch.equal(a, c) for a, c in zip(got, parked)), (
                    "B10: the parked backward differs from the replaying one")
                assert all(torch.equal(a, c) for a, c in zip(got, again)), (
                    "two B10 backwards of the same inputs differ")
                worst = encoder_check(y28, got, chained_y, chained, plain_y,
                                      plain, dtype)
                enc_errs[(b, l, d, n, dtype, p)] = worst
                print(f"B10 B={b} L={l} d={d} h={h} d_ff={d_ff} N={n} "
                      f"{dtype} p={p} ({'/'.join(state[3])}): max_abs_err y "
                      f"/ worst gradient vs the chained B1/B2 kernels on "
                      f"B10's routes {worst['fwd_chained']:.3e} / "
                      f"{worst['bwd_chained']:.3e} (the worst gradient at "
                      f"{worst['bwd_chained_rel']:.2e} of its tolerance), vs "
                      f"plain {worst['fwd_plain']:.3e} / "
                      f"{worst['bwd_plain']:.3e} (the chained kernels vs "
                      f"plain {worst['fwd_chained_plain']:.3e} / "
                      f"{worst['bwd_chained_plain']:.3e}); bit-equal to the "
                      f"chained kernels: y {worst['y_equal']}, gradients "
                      f"{worst['grads_equal']}/15; parked backward = "
                      f"replaying backward, bit for bit")
                del x28, dy28, got, again, parked, saved, chained, plain
                del state
    chain_routes = (b1_routes(), b2_routes())
    b10_case_routes = (dict(encoder_block_fwd.route_launches),
                       dict(encoder_block_bwd.route_launches))
    print(f"B10 launches by route (attention/FFN) in phase 28: forward "
          f"{b10_case_routes[0]}, backward {b10_case_routes[1]} (the "
          f"parked and the replaying backward)")
    torch.cuda.empty_cache()
    for (dtype, p), (b10_share, chain_share) in c4.items():
        print(f"C4: at (B, L, d, h)={C4_CASE} {dtype} p={p}, the worst "
              f"gradient error against the fp32 plain chain on the same "
              f"inputs and masks, as a share of the reference tensor's max: "
              f"B10 {b10_share:.4f}, the chain on B10's routes "
              f"{chain_share:.4f}; ratio {b10_share / chain_share:.3f} (C4 "
              f"settled if <= {C4_RATIO}: "
              f"{'yes' if b10_share <= C4_RATIO * chain_share else 'no'})")
    phase_ok("phase 28 ok: "
             "B10 matches the chained B1/B2 kernels, and its plain "
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

    for k in (encoder_block_fwd, encoder_block_bwd):
        k.route_launches = dict.fromkeys(B10_ROUTES, 0)
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
        # each bucket's graph captured one B10 launch (the cooperative
        # launch inside a CUDA graph), on its 3xTF32 routes
        enc_wave = {"encoder_block_fwd": 1,
                    "encoder_block_fwd[tf32x3/tf32x3]": 1}
        captured29, replays_before = graph_record(service)
        assert all(c == enc_wave for c in captured29.values()), captured29
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
            replays = graph_record(service)[1] - replays_before
            waves = service.stats()["waves_total"] - waves_before
            # one replay a wave, nothing launched from Python; the device
            # ran B10's forward once a wave and no B1 or B2
            assert service_counts == (0,) * len(enc_kernels), service_counts
            assert waves >= 1 and replays == waves, (replays, waves)
            enc_wave_kernels = traced_launches(
                lambda: service.score(slates[0], timeout=60), 3,
                {"encoder_fwd_kernel": 1}, refuse=("b1_", "b2_"))
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
        enc_service_launches = replays
        print(f"B10 service: {len(slates)} concurrent requests in {waves} "
              f"waves, {replays} graph replays of the captured launches "
              f"{enc_wave} a wave, none from Python; a wave's kernels on the "
              f"device {enc_wave_kernels}; answers equal the direct scorer")

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
        # the scorers (fp32 and bf16), the fp32 service and the bf16 steps:
        # each on its dtype's routes, the tensor cores
        enc_routes = {"fwd": dict(encoder_block_fwd.route_launches),
                      "bwd": dict(encoder_block_bwd.route_launches)}
        assert (enc_routes["fwd"]["tf32x3/tf32x3"] > 0
                and enc_routes["fwd"]["mma/mma"] > 0
                and enc_routes["bwd"]["mma/mma"] == 20), enc_routes
        assert not any(n for r in enc_routes.values()
                       for way, n in r.items() if way.startswith("simt"))
        first = statistics.mean(losses29[:5])
        last = statistics.mean(losses29[-5:])
        assert last < first, f"B10 step loss did not fall: {first} -> {last}"
        print(f"B10 train step, paper config (dropout 0.3, bf16), B={B} "
              f"L={L}: 20 steps, loss mean of the first 5 {first:.3f}, of "
              f"the last 5 {last:.3f}; launches {enc_train}; B10's launches "
              f"by route in this phase {enc_routes}")
        gl, cl, worst29, flips29 = step_one_gpu_vs_cpu(
            cfg0, paper_setup(dev, dropout=0.0)[1], batch29, gate_flips=True)
        print(f"B10 train step 1 at dropout 0, fp32, GPU vs CPU plain: loss "
              f"{gl:.6f} vs {cl:.6f}; worst gradient error {worst29:.3f} of "
              f"its tolerance, FFN units with a ReLU gate flipped between "
              f"the two per block (held out, replayed) {flips29} (at most "
              f"{GATE_FLIPS_MAX})")
    finally:
        transformer_mod.MEGA_ENCODER_ENABLED = False
    phase_ok("phase 29 ok: "
             "with the switch on, the scorer, the service and the "
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
            _, state = encoder_chained_fwd(*args30, eh, 0.0)
            _, saved30 = encoder_block_fwd(*args30, **kw, return_saved=True)
            if direction == "fwd":
                fns = (lambda: encoder_block_fwd(*args30, **kw),
                       lambda: encoder_forward_plain(*args30, **kw), lib[0],
                       lambda: encoder_chained_fwd(*args30, eh, 0.0),
                       lambda: encoder_block_fwd(*args30, **kw,
                                                 return_saved=True))
            else:
                # the main path's backward reads the parked state; the
                # replaying one is the JAX signature's
                fns = (lambda: encoder_block_bwd(*args30, dy30, **kw,
                                                 saved=saved30),
                       lambda: encoder_backward_plain(*args30, dy30, **kw),
                       lib[1],
                       lambda: encoder_chained_bwd(state, mask30, seeds30,
                                                   stacks, fs, dy30, eh, 0.0),
                       lambda: encoder_block_bwd(*args30, dy30, **kw))
            ms, plain_ms, lib_ms, chained_ms, other_ms = (
                median_ms(fn, iters=10, warmup=2) for fn in fns)
            by_name = profile_calls(
                fns[0], f"encoder_block_{direction} {dtype} {tag}",
                also=("encoder_",))
            dev_ms = sum(us for kname, us in by_name.items()
                         if "encoder_" in kname) / 1e3 or None
            flops, moved = encoder_work(eb, el, ed, eh, eff, en, dtype,
                                        direction == "bwd")
            bound_ms, bound_by = bound(
                flops, moved, "tf32x3" if dtype == torch.float32 else dtype)
            sfx = "" if dtype == torch.float32 else "_bf16"
            errs28 = [v for key, v in enc_errs.items() if key[4] == dtype]
            err = max(v[f"{direction}_plain"] for v in errs28)
            err_chained = max(v[f"{direction}_chained"] for v in errs28)
            other = "parked_ms" if direction == "fwd" else "replay_ms"
            row.update({f"max_abs_err{sfx}": err,
                        f"max_abs_err_vs_chained{sfx}": err_chained,
                        f"ms{sfx}": ms, f"device_ms{sfx}": dev_ms,
                        f"plain_ms{sfx}": plain_ms,
                        f"bound_ms{sfx}": bound_ms,
                        f"bound_by{sfx}": bound_by,
                        f"library_ms{sfx}": lib_ms,
                        f"chained_ms{sfx}": chained_ms,
                        f"{other}{sfx}": other_ms,
                        f"routes{sfx}": "/".join(
                            b10_route(dtype, ed, eh, eff)),
                        f"gflop{sfx}": flops / 1e9,
                        f"mbytes{sfx}": moved / 1e6})
            print(f"time encoder_block_{direction} {dtype} B={eb} L={el} "
                  f"d={ed} h={eh} d_ff={eff} N={en} "
                  f"({'/'.join(b10_route(dtype, ed, eh, eff))}): kernel "
                  f"{ms:.4f} ms ({dev_ms if dev_ms is None else round(dev_ms, 4)} "
                  f"ms of device time), "
                  + (f"parked forward {other_ms:.4f} ms, "
                     if direction == "fwd" else
                     f"on the parked state (the replaying backward "
                     f"{other_ms:.4f} ms), ")
                  + f"the chained B1/B2 kernels on its routes "
                  f"{chained_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"(std-LN, matmul, scaled_dot_product_attention, relu"
                  f"{', autograd' if direction == 'bwd' else ''}) "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB at the "
                  f"{'3xTF32' if dtype == torch.float32 else 'bf16'} "
                  f"tensor-core rate) {tag}")
            del x30, dy30, stacks, lib, state, fns, saved30
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
    f32 = dict(device=dev, dtype=torch.float32)
    for b, l, d2, d3 in X2_CASES:
        x, pre, w1, w2, w1n = x2_inputs(gen, b, l, dev, d=d2, d3=d3)
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
        # the plain kernel is B2's bf16 forward tile at unit gain and zero
        # biases: ffn_sublayer_fwd's bits on the same values
        b2_y = ffn_sublayer_fwd(x, torch.ones(d2, **f32),
                                torch.zeros(d2, **f32), w1.float(),
                                torch.zeros(d3, **f32), w2.float(),
                                torch.zeros(d2, **f32))
        assert torch.equal(y, b2_y), ("X2 plain is not B2's forward", b, l,
                                      d2, d3)
        print(f"X2 vs plain B={b} L={l} d={d2} d3={d3} bf16: max_abs_err "
              f"plain {case_errs['boundary_plain']:.3e}, shifted (out and "
              f"pre_out) {case_errs['boundary_shift']:.3e} (tol {tol16}); "
              f"plain equal to B2's bf16 forward bit for bit")
    # the probe's own run at its default shape: the launches of its path
    boundary_plain.launches = boundary_shift.launches = 0
    x2_res = x2_tool.main([])
    x2_launches = {"boundary_plain": boundary_plain.launches,
                   "boundary_shift": boundary_shift.launches}
    print(f"X2 probe launches {x2_launches}; per-boundary tax (us): "
          + ", ".join(f"{m} plain {r['tax_plain_us']:.2f} shifted "
                      f"{r['tax_shift_us']:.2f} ({r['verdict']})"
                      for m, r in x2_res.items())
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
        ms, lib_dev_ms = graph_ms(fns[0]), graph_ms(fns[2])
        call_ms, plain_ms, lib_ms = (median_ms(fn, iters=20) for fn in fns)
        bound_ms, bound_by = bound(flops, moved, torch.bfloat16)
        rows.append({"name": name, "route": "cuda",
                     "max_abs_err": x2_errs[name], "ms": ms,
                     "call_ms": call_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "gflop": flops / 1e9, "mbytes": moved / 1e6,
                     "probe": x2_res})
        print(f"time {name} bf16 B={B} L={L} d=128 d3=384: kernel {ms:.4f} "
              f"ms of device time (20 calls in one CUDA graph; one "
              f"event-timed call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"library (std-LN ops, bf16 torch.matmul, relu) "
              f"{lib_dev_ms:.4f} ms of device time (one event-timed call "
              f"{lib_ms:.4f} ms), bound {bound_ms:.5f} ms ({bound_by}: "
              f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB) {tag}")
    del x, pre, w1, w2, w1n
    phase_ok(f"phase 31 ok: X2 matches its plain versions; the boundary probe "
             f"ran ({time.perf_counter() - t31:.1f} s)")

    # -- 32: X3, the attention variants ---------------------------------------
    from allrank_tpu_torch.ops.attention_variants import MMA_LIBRARIES
    from allrank_tpu_torch.ops.attention_variants import (
        MODES,
        attention_variant_fwd,
        attention_variant_fwd_plain,
    )
    from allrank_tpu_torch.ops.attention_variants import ROUTES as X3_ROUTES
    from allrank_tpu_torch.ops.attention_variants import (
        launch_fwd as x3_launch_fwd,
    )
    from allrank_tpu_torch.ops.attention_variants import qkv_plain
    from allrank_tpu_torch.ops.attention_variants import route as x3_route
    from allrank_tpu_torch.tools import exp_attn_decompose as x3_tool

    t32 = time.perf_counter()
    x3_errs = {(way, mode): 0.0 for way in X3_ROUTES for mode in MODES}
    # no_softmax's padded rows by route: the worst (err, the row's max|ref|)
    x3_scaled_err = {}

    def x3_check(args, h, mode, way, label):
        """One call of ``mode`` on route ``way`` against the plain version;
        ``full`` against B1's forward: bit for bit on B1's own route."""
        d = args[0].shape[-1]
        by_route = way == x3_route(d, h)
        before = (attention_variant_fwd.launches[mode],
                  dict(attention_variant_fwd.route_launches))
        y = (attention_variant_fwd(*args, h, mode=mode) if by_route
             else x3_launch_fwd(way, *args, h, mode=mode))
        torch.cuda.synchronize()
        assert attention_variant_fwd.launches[mode] == before[0] + 1, mode
        assert attention_variant_fwd.route_launches[way] == (
            before[1][way] + 1), (mode, way)
        if mode in X3_QKV_REPLAY:
            # LN + QKV held to the plain's; the rest to the plain version
            # replaying the kernel's own qkv
            y2, kqkv = x3_launch_fwd(way, *args, h, mode=mode,
                                     return_qkv=True)
            assert torch.equal(y2, y), (mode, way)
            torch.testing.assert_close(
                kqkv.float(), qkv_plain(args[0], *args[2:6]).float(), **tol16)
            ref = attention_variant_fwd_plain(*args, h, mode=mode, qkv=kqkv)
        else:
            ref = attention_variant_fwd_plain(*args, h, mode=mode)
        assert y.dtype == ref.dtype and y.shape == ref.shape
        assert torch.isfinite(y.float()).all(), mode
        err = rel_err(y, ref)[0]
        if mode == "no_softmax":
            err_full, worst = no_softmax_close(y, ref, args[1], tol16)
            msg = f" (unpadded slates' rows: {err_full:.3e}, tol {tol16}"
            if worst is not None:
                msg += (f"; padded slates' worst row {worst[0]:.3e}, tol "
                        f"{tol16['rtol']:g} x its max|ref| {worst[1]:.3e}")
                prev = x3_scaled_err.get(way)
                if prev is None or worst[0] / worst[1] > prev[0] / prev[1]:
                    x3_scaled_err[way] = worst
            msg += ")"
            x3_errs[(way, mode)] = max(x3_errs[(way, mode)], err_full)
        else:
            torch.testing.assert_close(y.float(), ref.float(), **tol16)
            msg = f" (tol {tol16})"
            x3_errs[(way, mode)] = max(x3_errs[(way, mode)], err)
        if mode == "full":
            b1_way = b1_route(torch.bfloat16, d, h)
            b1_y = b1_launch_fwd(way, *args, h)
            assert torch.equal(y, b1_y), (f"X3 full is not B1's {way} "
                                          f"forward", label)
            msg += f"; equal to B1's {way} forward bit for bit"
            if way == b1_way:
                assert torch.equal(y, attention_sublayer_fwd(*args, h))
                msg += " (B1's route)"
        print(f"X3 [{mode}] ({way}) vs plain B={args[0].shape[0]} "
              f"L={args[0].shape[1]} d={d} h={h} bf16 ({label}): "
              f"max_abs_err {err:.3e}{msg}")

    x0_32, mask0_32, plist32 = x3_tool.inputs(B, L, dev)
    cases32 = [("the probe's inputs", [x0_32, mask0_32] + list(plist32[0]),
                4),
               ("ragged keys, one empty slate",
                attn_inputs(gen, B, L, 128, torch.bfloat16, dev), 4)]
    # every tensor-core instantiation: the three head classes, head rows on
    # and off a 16-byte boundary; then B1's SIMT route (d_k 256); each
    # ragged and with no key padded
    for d, h in X3_MMA_WIDTHS + [(256, 1)]:
        args = attn_inputs(gen, 8, max(L, d // h), d, torch.bfloat16, dev)
        cases32 += [(f"d_k {d // h}, ragged keys, one empty slate", args, h),
                    (f"d_k {d // h}, no padded key",
                     [args[0], torch.zeros_like(args[1])] + args[2:], h)]
    for label, args, h in cases32:
        for mode in MODES:
            x3_check(args, h, mode, x3_route(args[0].shape[-1], h), label)
    # the SIMT kernels by name at the probe's width
    for label, args, h in cases32[:2]:
        for mode in MODES:
            x3_check(args, h, mode, "simt", f"by name, {label}")
    del cases32
    # the probe's own runs: at its default shape (the tensor cores), at
    # B1's costliest slate length, and at d_k 256 (the SIMT units; no_pv
    # needs L >= d_k); each one's launches by route
    x3_res, x3_launches = {}, {}
    for key, argv in (("mma", []), ("long", ["16", "1024"]),
                      ("simt", ["8", "256", "--d", "256", "--h", "1"])):
        attention_variant_fwd.launches = dict.fromkeys(MODES, 0)
        attention_variant_fwd.route_launches = dict.fromkeys(X3_ROUTES, 0)
        attention_sublayer_fwd.launches = attention_sublayer_bwd.launches = 0
        x3_res[key] = x3_tool.main(argv)
        routes32 = dict(attention_variant_fwd.route_launches)
        way = "simt" if key == "simt" else "mma"
        assert routes32[way] == sum(routes32.values()) > 0, (key, routes32)
        assert attention_sublayer_fwd.launches and (
            attention_sublayer_bwd.launches)
        x3_launches[key] = dict(attention_variant_fwd.launches)
        print(f"X3 probe {argv}: launches {x3_launches[key]} by route "
              f"{routes32}; stages (us) "
              f"{json.dumps(x3_res[key]['stages_us'])} {tag}")
    # B1 where it costs most, (16, 1024): X3 full, B1's forward and its
    # library on one clock
    args_long = attn_inputs(gen, LONG_B, LONG_L, 128, torch.bfloat16, dev)
    lib_long = library_args(args_long, 4)
    x3_long = {"x3_full_ms": graph_ms(
        lambda: attention_variant_fwd(*args_long, 4, mode="full")),
        "b1_ms": graph_ms(lambda: attention_sublayer_fwd(*args_long, 4)),
        "library_device_ms": graph_ms(lambda: b1_library(*lib_long)),
        "library_ms": median_ms(lambda: b1_library(*lib_long), iters=20)}
    print(f"time X3 full and B1 bf16 B={LONG_B} L={LONG_L} d=128 h=4, "
          f"device ms: X3 full {x3_long['x3_full_ms']:.4f}, B1 "
          f"{x3_long['b1_ms']:.4f}, library {x3_long['library_device_ms']:.4f}"
          f" (one event-timed call {x3_long['library_ms']:.4f}) {tag}")
    del args_long, lib_long
    args32 = attn_inputs(gen, B, L, 128, torch.bfloat16, dev)
    lib_args32 = library_args(args32, 4)
    lib32 = {"library_device_ms": graph_ms(lambda: b1_library(*lib_args32)),
             "library_ms": median_ms(lambda: b1_library(*lib_args32),
                                     iters=20)}
    for mode in MODES:
        plain_ms = median_ms(lambda m=mode: attention_variant_fwd_plain(
            *args32, 4, mode=m), iters=20)
        flops, moved = x3_work(B, L, 128, 4, mode)
        bound_ms, bound_by = bound(flops, moved, torch.bfloat16)
        for way in X3_ROUTES:
            def call(m=mode, w=way):
                return x3_launch_fwd(w, *args32, 4, mode=m)

            ms, call_ms = graph_ms(call), median_ms(call, iters=20)
            name = f"attention_variant_{mode}" + (
                "_mma" if way == "mma" else "")
            row = {"name": name, "route": "cuda",
                   "max_abs_err": x3_errs[(way, mode)], "ms": ms,
                   "call_ms": call_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "library_device_ms": None,
                   "gflop": flops / 1e9, "mbytes": moved / 1e6,
                   "probe_us": x3_res["mma" if way == "mma" else "simt"][
                       "modes_us"][mode]}
            if mode == "full":
                row.update(lib32)
            else:
                row["library_note"] = ("none: the mode changes a stage on "
                                       "purpose, no library call computes "
                                       "it")
            if mode == "full" and way == "mma":
                row["long_b16_l1024"] = x3_long
                row["probe_long_us"] = x3_res["long"]["modes_us"]
            if mode == "no_softmax" and way in x3_scaled_err:
                # the padded slates' worst row, held to its own max|ref|
                (row["max_abs_err_padded_row"],
                 row["max_abs_ref_padded_row"]) = x3_scaled_err[way]
            rows.append(row)
            lib_txt = ("none" if row["library_device_ms"] is None else
                       f"{row['library_device_ms']:.4f} ms of device time "
                       f"(one event-timed call {row['library_ms']:.4f} ms)")
            print(f"time {name} ({way}) bf16 B={B} L={L} d=128 h=4: kernel "
                  f"{ms:.4f} ms of device time (20 calls in one CUDA graph; "
                  f"one event-timed call {call_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, library {lib_txt}, bound "
                  f"{bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
                  f"{moved / 1e6:.2f} MB) {tag}")
    del args32, lib_args32
    phase_ok(f"phase 32 ok: X3 matches its plain versions in all six modes on "
             f"both routes and is B1's forward in full; the decomposition "
             f"probe ran at three shapes ({time.perf_counter() - t32:.1f} s)")

    # -- 33: X4, the soft-sort with its records on chip -----------------------
    # X4 is B8's route "cluster" with the records and the backward's U and
    # V stacks in shared memory, at B8's cluster sizes: bit for bit that
    # route (out, records, ds), and the plain version's at phase 11's
    # tolerances (ds against it run in float64)
    from allrank_tpu_torch.ops.neuralsort_layout import (
        kernel_smem_floats as x4_kernel_floats,
    )
    from allrank_tpu_torch.ops.neuralsort_layout import (
        layout_plan,
        layout_soft_sort_bwd,
        layout_soft_sort_fwd,
        max_length,
    )
    from allrank_tpu_torch.tools import exp_sinkhorn_layout as x4_tool

    t33 = time.perf_counter()
    T = SINKHORN_ITERS
    x4_cap = max_length(T)
    for backward in (False, True):
        for l in range(1, x4_cap + 1):
            plan = layout_plan(l, T, backward)
            assert plan[0] == cluster_plan(l, backward)[0], (l, plan)
            assert x4_kernel_floats(l, plan[0], T, backward) * 4 == plan[1]
    x4_errs = {"layout_soft_sort_fwd": 0.0, "layout_soft_sort_bwd": 0.0}
    s0, pad0, vec0 = x4_tool.inputs(2048, L, dev)
    cases33 = [("the probe's case", 2048, False,
                (s0, pad0, vec0, torch.randn(2048, L, generator=gen).to(dev)))]
    for n, l, transpose, label in ((B, L, False, "ragged"),
                                   (B, L, True, "ragged"),
                                   (5, x4_cap, True, "ragged, at its cap"),
                                   (1, L, False, "fully padded")):
        cases33.append((label, n, transpose,
                        soft_sort_inputs(gen, n, l, dev)))
    for label, n, transpose, (sc, pad, vec, dout) in cases33:
        l = sc.shape[1]
        before = (layout_soft_sort_fwd.launches, layout_soft_sort_bwd.launches)
        out, a_hist, b_hist = layout_soft_sort_fwd(sc, pad, vec, 1.0, T,
                                                   transpose)
        ds = layout_soft_sort_bwd(sc, pad, vec, a_hist, b_hist, dout, 1.0, T,
                                  transpose)
        torch.cuda.synchronize()
        assert (layout_soft_sort_fwd.launches,
                layout_soft_sort_bwd.launches) == (
            before[0] + 1, before[1] + 1), "X4 did not launch"
        b8 = b8_launch_fwd("cluster", sc, pad, vec, 1.0, T, transpose)
        b8_ds = b8_launch_bwd("cluster", sc, pad, vec, *b8[1:], dout, 1.0, T,
                              transpose)
        assert all(torch.equal(g, w) for g, w in zip(
            (out, a_hist, b_hist, ds), b8 + (b8_ds,))), (
                f"X4 is not B8's route \"cluster\" bit for bit ({label})")
        ref, ref_a, ref_b = soft_sort_fwd_plain(sc, pad, vec, 1.0, T,
                                                transpose)
        assert torch.isfinite(out).all() and torch.isfinite(ds).all()
        torch.testing.assert_close(out, ref, **SOFT_TOL)
        torch.testing.assert_close(a_hist, ref_a, rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(b_hist, ref_b, rtol=1e-3, atol=1e-6)
        f_err = rel_err(out, ref)[0]
        del ref, ref_a, ref_b
        args64 = [t.double() for t in (sc, pad, vec)]
        ref_ds = soft_sort_bwd_plain(
            *args64, *soft_sort_fwd_plain(*args64, 1.0, T, transpose)[1:],
            dout.double(), 1.0, T, transpose)
        g_err = assert_grad_close(ds, ref_ds, f"X4 ds N={n} L={l}")
        assert not ds[pad > 0.5].any(), "a padded document's gradient"
        x4_errs["layout_soft_sort_fwd"] = max(
            x4_errs["layout_soft_sort_fwd"], f_err)
        x4_errs["layout_soft_sort_bwd"] = max(
            x4_errs["layout_soft_sort_bwd"], g_err)
        print(f"X4 ({layout_plan(l, T, False)[0]} / "
              f"{layout_plan(l, T, True)[0]} blocks) vs plain N={n} L={l} "
              f"({label}) transpose={transpose}: max_abs_err out {f_err:.3e} "
              f"(tol {SOFT_TOL}), ds {g_err:.3e} of max|ref| "
              f"{rel_err(ds, ref_ds)[1]:.3e} against float64 (tol "
              f"{SOFT_GRAD_TOL[0]:g} x); B8's route \"cluster\" bit for bit "
              f"(out, a_hist, b_hist, ds)")
        del ref_ds, args64, b8, b8_ds
    too_long = torch.zeros(2, x4_cap + 1, device=dev)
    before = layout_soft_sort_fwd.launches
    try:
        layout_soft_sort_fwd(too_long, too_long, too_long, 1.0, T)
        raise AssertionError("X4 took a slate past its cap")
    except ValueError as e:
        assert layout_soft_sort_fwd.launches == before
        print(f"X4 refuses L={too_long.shape[1]}: {e}")
    layout_soft_sort_fwd.launches = layout_soft_sort_bwd.launches = 0
    reset_routes()
    x4_res = x4_tool.main([])
    x4_launches = {"layout_soft_sort_fwd": layout_soft_sort_fwd.launches,
                   "layout_soft_sort_bwd": layout_soft_sort_bwd.launches}
    # the probe's B8 arm runs route "cluster" by name, never "l2"
    probe_b8 = (dict(soft_sort_fwd.route_launches),
                dict(soft_sort_bwd.route_launches))
    assert all(r["l2"] == 0 and r["cluster"] > 0 for r in probe_b8), probe_b8
    assert all(x4_launches.values()), x4_launches
    assert x4_res["max_abs_out"] == 0.0 and x4_res["max_abs_grad"] == 0.0
    print(f"X4 probe launches {x4_launches}, its B8 arm's by route "
          f"{probe_b8}; X4 / B8 time {x4_res['ratio_fwd']:.4f} forward, "
          f"{x4_res['ratio_fwd_bwd']:.4f} forward + backward at N=2048 "
          f"L={L} {tag}")
    sc, pad, vec, dout = soft_sort_inputs(gen, B, L, dev)
    _, a_hist, b_hist = layout_soft_sort_fwd(sc, pad, vec, 1.0, T, False)
    lib = soft_sort_library(sc, pad, vec, False)
    hist_bytes = 2 * (T + 1) * 4
    for name, fns, b8_fn, lib_fn, flops, moved in (
            ("layout_soft_sort_fwd",
             (lambda: layout_soft_sort_fwd(sc, pad, vec, 1.0, T, False),
              lambda: soft_sort_fwd_plain(sc, pad, vec, 1.0, T, False)),
             lambda: b8_launch_fwd("cluster", sc, pad, vec, 1.0, T, False),
             lib[0], B * (4 * T + 14) * L * L,
             B * L * (3 * 4 + 4 + hist_bytes)),
            ("layout_soft_sort_bwd",
             (lambda: layout_soft_sort_bwd(sc, pad, vec, a_hist, b_hist, dout,
                                           1.0, T, False),
              lambda: soft_sort_bwd_plain(sc, pad, vec, a_hist, b_hist, dout,
                                          1.0, T, False)),
             lambda: b8_launch_bwd("cluster", sc, pad, vec, a_hist, b_hist,
                                   dout, 1.0, T, False), lib[1],
             B * (8 * T + 31) * L * L, B * L * (4 * 4 + 4 + hist_bytes))):
        ms, b8_ms = graph_ms(fns[0]), graph_ms(b8_fn)
        plain_ms, lib_ms = (median_ms(fn, iters=10, warmup=2)
                            for fn in (fns[1], lib_fn))
        lib_dev_ms = library_device_ms(lib_fn, name.endswith("_bwd"))
        bound_ms, bound_by = bound(flops, moved, torch.float32)
        rows.append({"name": name, "route": "cuda",
                     "max_abs_err": x4_errs[name], "ms": ms,
                     "b8_ms": b8_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "gflop": flops / 1e9, "mbytes": moved / 1e6,
                     "probe": x4_res})
        lib_txt = ("not measured" if lib_dev_ms is None
                   else f"{lib_dev_ms:.4f} ms")
        print(f"time {name} float32 N={B} L={L}: kernel {ms:.4f} ms of "
              f"device time (20 calls in one CUDA graph), B8 by route "
              f"\"cluster\" {b8_ms:.4f} ms likewise ({ms / b8_ms:.3f}x), "
              f"plain {plain_ms:.4f} ms, library (torch-op chain"
              f"{', autograd' if name.endswith('bwd') else ''}) "
              f"{lib_txt} of device time (one event-timed call "
              f"{lib_ms:.4f} ms), bound {bound_ms:.5f} ms ({bound_by}: "
              f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.3f} MB) {tag}")
    del sc, pad, vec, dout, a_hist, b_hist, lib, s0, pad0, vec0, cases33
    torch.cuda.empty_cache()
    phase_ok(f"phase 33 ok: "
             f"X4 is B8's route \"cluster\" bit for bit and matches the "
             f"plain version; the layout probe ran "
             f"({time.perf_counter() - t33:.1f} s)")

    # -- 34: rank-and-click, the sixth main path -----------------------------
    from allrank_tpu_torch.click_models import (
        BaseCascadeModel,
        ConditionedClickModel,
        DiverseClicksModel,
        FixedClickModel,
        MaxClicksModel,
        MultipleClickModel,
        OnlyRelevantClickModel,
        RandomClickModel,
    )
    from allrank_tpu_torch.click_models.device_models import (
        ClickKey,
        as_device_click_fn,
        diverse_margin,
        pairwise_distances,
    )
    from allrank_tpu_torch.data.dataset import SlateDataset, parse_svmlight
    from allrank_tpu_torch.inference.inference_utils import (
        make_rank_and_click_step,
        make_rank_step,
        rank_order,
    )
    from allrank_tpu_torch.rank_and_click import run as rank_and_click_run

    t34 = time.perf_counter()
    paper_cfg_path = os.path.join(work_dir, "ndcgloss2pp.json")
    paper_npz = os.path.join(paper_out_dir, "model.npz")
    with open(paper_cfg_path) as f:
        rc_base = json.load(f)
    rc_batch = rc_base["data"]["batch_size"]
    rc_batches = -(-CLI_VAL_SLATES // rc_batch)
    cascade_cfg = {"name": "allrank_tpu_torch.click_models.cascade_models."
                           "BaseCascadeModel",
                   "args": {"eta": 1, "threshold": 2}}
    diverse_cfg = {"name": "allrank_tpu_torch.click_models.cascade_models."
                           "DiverseClicksModel",
                   "args": {"inner_click_model": cascade_cfg,
                            "q_percentile": 0.5}}
    duplicates_cfg = {"name": "allrank_tpu_torch.click_models."
                              "duplicate_aware."
                              "EverythingButDuplicatesClickModel",
                      "args": {}}

    def rank_and_click_cli(run_id, click_model, device_cache):
        """The CLI on the vali role with the ndcgloss2pp run's config and
        model.npz, ``click_model`` and ``data.device_cache`` set; returns
        (means, output directory, seconds, launches)."""
        cfg = copy.deepcopy(rc_base)
        cfg["click_model"] = click_model
        cfg["data"]["device_cache"] = device_cache
        path = os.path.join(work_dir, f"{run_id}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        reset_counts()
        t0 = time.perf_counter()
        means = rank_and_click_run(Namespace(
            job_dir=os.path.join(work_dir, "job"), run_id=run_id,
            config_file_name=path, input_model_path=paper_npz,
            roles=["vali"]))["vali"]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return (means, os.path.join(work_dir, "job", "results", run_id),
                seconds, counts())

    # every ranking batch runs the 4 blocks' B1 and B2 forwards on their
    # fp32 route, and nothing else
    rc_expected = dict.fromkeys(counts(), 0)
    for k in ("attention_sublayer_fwd", "attention_sublayer_fwd[tf32x3]",
              "ffn_sublayer_fwd", "ffn_sublayer_fwd[tf32x3]"):
        rc_expected[k] = 4 * rc_batches
    rc_runs = {}
    for run_id, click_model, cache in (
            ("rank_and_click_a", diverse_cfg, False),
            ("rank_and_click_b", diverse_cfg, True),
            ("rank_and_click_c", duplicates_cfg, False)):
        rc_runs[run_id] = rank_and_click_cli(run_id, click_model, cache)
        launched = rc_runs[run_id][3]
        assert launched == rc_expected, (run_id, launched, rc_expected)
    rc_files = {}
    for run_id, (means, rc_dir, _, _) in rc_runs.items():
        rc_files[run_id] = {}
        for name in ("vali.txt", "vali_metrics.csv", "vali_metrics_mean.csv",
                     "used_config.json"):
            with open(os.path.join(rc_dir, name), "rb") as f:
                rc_files[run_id][name] = f.read()
            assert rc_files[run_id][name], (run_id, name)
        assert 0.0 <= means["ndcg"] <= 1.0, (run_id, means)
    # the index-mode feed writes what the materialising feed writes
    for name in ("vali.txt", "vali_metrics.csv", "vali_metrics_mean.csv"):
        assert (rc_files["rank_and_click_a"][name]
                == rc_files["rank_and_click_b"][name]), name
    val_ds = SlateDataset(*parse_svmlight(
        os.path.join(work_dir, "data", "vali.txt")))
    val_y = val_ds.flat_slate_buffers()[1]
    rc_x, rc_y, rc_qid = parse_svmlight(
        os.path.join(rc_runs["rank_and_click_a"][1], "vali.txt"))
    assert rc_x.shape[1] == N_FEATURES and set(np.unique(rc_y)) <= {0, 1}
    n_clicked = len(np.unique(rc_qid))
    # no two documents coincide, so the duplicate-aware model clicks every
    # document of every slate
    dup_x, dup_y, dup_qid = parse_svmlight(
        os.path.join(rc_runs["rank_and_click_c"][1], "vali.txt"))
    assert len(dup_y) == len(val_y) and (dup_y == 1).all()
    assert len(np.unique(dup_qid)) == CLI_VAL_SLATES
    np.testing.assert_array_equal(np.sort(dup_x, axis=0),
                                  np.sort(val_ds.flat_slate_buffers()[0],
                                          axis=0))
    rc_seconds = {k: round(v[2], 3) for k, v in rc_runs.items()}
    print(f"rank_and_click CLI, {PAPER_CONFIG} model of phase 13, role vali "
          f"({CLI_VAL_SLATES} slates, {rc_batches} batches of {rc_batch}): "
          f"(a) DiverseClicksModel(BaseCascadeModel(1, 2), 0.5), (b) the "
          f"same with data.device_cache, (c) "
          f"EverythingButDuplicatesClickModel on the host; seconds per "
          f"call {rc_seconds}; (a) and (b) byte-identical, {n_clicked} "
          f"slates clicked, means {rc_runs['rank_and_click_a'][0]}; "
          f"launches a call {rc_runs['rank_and_click_a'][3]} {tag}")

    # the card against the CPU's plain run, batch by batch
    rc_model_cfg = Config.from_json(paper_cfg_path).model
    rc_gpu = load_npz(LTRModel(make_model(rc_model_cfg, N_FEATURES),
                               device=dev), paper_npz).eval()
    rc_cpu = load_npz(LTRModel(make_model(rc_model_cfg, N_FEATURES),
                               device="cpu"), paper_npz).eval()
    host_models = {
        "only_relevant": OnlyRelevantClickModel(2),
        "fixed": FixedClickModel([0, 2, 5]),
        "base_cascade": BaseCascadeModel(1, 2),
        "random": RandomClickModel(3),
        "multiple": MultipleClickModel(
            [BaseCascadeModel(1, 2), RandomClickModel(2)], [0.5, 0.5]),
        "conditioned": ConditionedClickModel(
            [BaseCascadeModel(1, 1), OnlyRelevantClickModel(2)], "all"),
        "max_clicks": MaxClicksModel(BaseCascadeModel(0.5, 1), 3),
        "diverse": DiverseClicksModel(BaseCascadeModel(1, 2), 0.5),
    }
    click_fns = {k: as_device_click_fn(m) for k, m in host_models.items()}
    rc_len = val_ds.longest_query_length
    swaps, click_diffs = 0, dict.fromkeys(click_fns, 0)
    n_near, diverse_slates_off, dist_err, margin_err = 0, 0, 0.0, 0.0
    rc_batch0 = None
    for i, batch in enumerate(SlateBatcher(val_ds, rc_len, rc_batch)):
        xg = torch.from_numpy(batch.x).to(dev)
        yg = torch.from_numpy(batch.y).to(dev)
        with torch.inference_mode():
            _, order_g = rank_order(rc_gpu, xg, yg)
            scores_c, order_c = rank_order(rc_cpu, torch.from_numpy(batch.x),
                                           torch.from_numpy(batch.y))
        order_g, order_c = order_g.cpu().numpy(), order_c.numpy()
        scores_c = scores_c.numpy()
        for row in np.flatnonzero(batch.slate_mask):
            swaps += neighbour_swaps(order_g[row], order_c[row],
                                     scores_c[row],
                                     int((batch.y[row] != -1).sum()))
        # the clicks on the card's ranked slates, on the card and the CPU
        xr = torch.take_along_dim(xg, torch.from_numpy(order_g).to(dev)[
            ..., None], dim=1)
        yr = torch.take_along_dim(yg, torch.from_numpy(order_g).to(dev),
                                  dim=1)
        xr_c, yr_c = xr.cpu(), yr.cpu()
        if rc_batch0 is None:
            rc_batch0 = (xg, yg)
        got = {}
        for name, fn in click_fns.items():
            key = ClickKey(42, i)
            on_card = fn(key, yr, xr).cpu()
            on_cpu = fn(key, yr_c, xr_c)
            got[name] = (on_card, on_cpu)
            if name != "diverse":
                assert torch.equal(on_card, on_cpu), (name, i)
            click_diffs[name] += int((on_card != on_cpu).sum())
        # diverse: only a slate holding a document within fp32 rounding
        # (1e-5 relative) of its margin may click otherwise
        dist_g = pairwise_distances(xr)
        margin_g = diverse_margin(dist_g, yr, 0.5).cpu()
        dist_g = dist_g.cpu()
        dist_c = pairwise_distances(xr_c)
        margin_c = diverse_margin(dist_c, yr_c, 0.5)
        dist_err = max(dist_err, float(
            ((dist_g - dist_c).abs() / dist_c.clamp(min=1e-30)).max()))
        margin_err = max(margin_err, float(
            ((margin_g - margin_c).abs() / margin_c.clamp(min=1e-30)).max()))
        near = near_margin(dist_c, margin_c, yr_c)
        n_near += int(near.sum())
        on_card, on_cpu = got["diverse"]
        off = (on_card != on_cpu).any(dim=1)
        assert not (off & ~near.any(dim=1)).any(), (
            "diverse clicks differ on a slate with no document near its "
            "margin", i)
        diverse_slates_off += int(off.sum())
    print(f"rank_and_click, card against the CPU plain run on the vali "
          f"role: ranked order equal but for {swaps} swaps of neighbours "
          f"within {SCORE_TOL} of each other (CPU scores); clicks on the "
          f"card's ranked slates, card against CPU, elements that differ "
          f"{click_diffs}; diverse: {n_near} documents within 1e-5 of "
          f"their slate's margin, {diverse_slates_off} slates clicked "
          f"otherwise, distances max rel err {dist_err:.3e}, margins "
          f"{margin_err:.3e}")

    # evaluate over the device feature store, against phase 26's float run
    cached_cfg = os.path.join(work_dir, "neuralndcg_atmax_cached.json")
    with open(neural_cfg) as f:
        cfg34 = json.load(f)
    cfg34["data"]["device_cache"] = True
    with open(cached_cfg, "w") as f:
        json.dump(cfg34, f)
    t0 = time.perf_counter()
    cached = evaluate_run(Namespace(
        job_dir=os.path.join(work_dir, "job"), run_id="evaluate_cached",
        config_file_name=cached_cfg, input_model_path=neural_npz,
        roles=[val_role], quantize=None, calibration_role=val_role,
        calibration_batches=8))[val_role]
    cached_s = time.perf_counter() - t0
    floats = evaluated[None][val_role]
    assert sorted(cached) == sorted(floats), (cached, floats)
    cache_err = max(abs(cached[k] - floats[k]) for k in floats)
    assert cache_err <= 1e-6, (cached, floats)
    print(f"evaluate with data.device_cache (a bf16 store, the recipe's "
          f"compute dtype), {NEURAL_CONFIG} model of phase 13, role "
          f"{val_role}: {cached} in {cached_s:.1f} s; max |difference| from "
          f"phase 26's materialising run {cache_err:.3e}")

    # the ranking's device time a batch (B=64 at the role's longest slate)
    xg, yg = rc_batch0
    rank_step = make_rank_step(rc_gpu)
    click_step = make_rank_and_click_step(rc_gpu, click_fns["diverse"])
    for label, fn in (("rank", lambda: rank_step(xg, yg)),
                      ("rank + diverse clicks",
                       lambda: click_step(xg, yg, ClickKey(42, 0)))):
        ms = median_ms(fn, iters=10, warmup=2)
        print(f"rank_and_click {label}, one batch B={rc_batch} L={rc_len}: "
              f"{ms:.3f} ms a batch (event-timed) {tag}")
        profile_calls(fn, f"rank_and_click {label} a batch {tag}", calls=5)
    del rc_gpu, rc_cpu, rc_batch0, xg, yg, xr, yr
    torch.cuda.empty_cache()
    rc_launches = {k: sum(r[3][f"{k}[tf32x3]"] for r in rc_runs.values())
                   for k in ("attention_sublayer_fwd", "ffn_sublayer_fwd")}
    work.cleanup()
    phase_ok(f"phase 34 ok: rank_and_click on the card at the flagship "
             f"width, both feeds byte-identical, the card against the CPU "
             f"({time.perf_counter() - t34:.1f} s)")

    # -- 35: a deployer's path: a reference checkpoint served on graphs ------
    t35 = time.perf_counter()
    from allrank_tpu_torch.interop import (
        export_params,
        flatten_params,
        load_torch_state_dict,
        torch_state_dict_to_params,
    )
    from allrank_tpu_torch.serving import (
        GraphPool,
        aot_compile,
        export_scorer,
        load_scorer,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    env35 = dict(os.environ, PYTHONPATH=root)
    deploy = tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_")
    ddir = deploy.name
    rng35 = np.random.RandomState(35)
    try:
        # the flagship as the reference allRank saves it, converted by the
        # port's interop CLI into the model.npz that both packages load
        pkl = os.path.join(ddir, "model.pkl")
        npz = os.path.join(ddir, "model.npz")
        cfg35 = os.path.join(ddir, "config.json")
        sd35 = reference_state_dict(flag.mdef, seed=35)
        torch.save(sd35, pkl)
        with open(cfg35, "w") as f:
            json.dump({"model": FLAGSHIP_MODEL, "data": {
                "path": ddir, "num_workers": 0, "batch_size": B,
                "slate_length": L, "validation_ds_role": "vali"}}, f)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "allrank_tpu_torch.interop",
             "--config-file-name", cfg35, "--n-features", str(N_FEATURES),
             "--input-model-path", pkl, "--output-model-path", npz],
            cwd=root, env=env35, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, timeout=300)
        assert out.returncode == 0, out.stdout.decode()[-3000:]
        convert_s = time.perf_counter() - t0
        model35 = load_npz(LTRModel(flag.mdef, device="cpu"), npz)
        mapped = flatten_params(torch_state_dict_to_params(
            load_torch_state_dict(pkl), flag.mdef))
        stored = export_params(model35)
        assert sorted(stored) == sorted(mapped) and all(
            np.array_equal(stored[k], mapped[k]) for k in mapped)
        eager35 = make_scorer(model35, "bfloat16")
        port = free_port()
        log_path = os.path.join(ddir, "serve.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "allrank_tpu_torch.serve_http",
                 "--config-file-name", cfg35, "--input-model-path", npz,
                 "--n-features", str(N_FEATURES), "--port", str(port),
                 "--host", "127.0.0.1", "--batch-size", str(B),
                 "--batch-buckets", f"1,8,{B}", "--compute-dtype",
                 "bfloat16"],
                cwd=root, env=env35, stdout=log, stderr=subprocess.STDOUT)
        url35 = f"http://127.0.0.1:{port}"
        try:
            while True:
                if proc.poll() is not None:
                    with open(log_path) as f:
                        raise AssertionError("the serve CLI exited:\n"
                                             + f.read()[-3000:])
                try:
                    with urllib.request.urlopen(url35 + "/healthz",
                                                timeout=2):
                        break
                except OSError:
                    assert time.perf_counter() - t0 < 300, "no service"
                    time.sleep(0.5)
            startup_s = time.perf_counter() - t0
            slates = [rng35.randn(n, N_FEATURES).astype(np.float32)
                      for n in (240, 1, 17, 64, 128, 199, 240, 5, 96, 233,
                                2, 150)]
            with concurrent.futures.ThreadPoolExecutor(len(slates)) as pool:
                futs = [pool.submit(post, url35, sl, i % 2 == 1)
                        for i, sl in enumerate(slates)]
                answers = [f.result(timeout=120) for f in futs]

            def eager_one(sl):
                xb = np.zeros((1, L, N_FEATURES), dtype=np.float32)
                xb[0, :len(sl)] = sl
                return eager35(xb, [len(sl)]).cpu().numpy()[0, :len(sl)]

            # a wave packs other requests' slates beside each one, so the
            # FC layer's and the head's products run at other shapes than
            # the eager B=1 call's: phase 4's bf16 rule
            worst35 = 0.0
            for sl, got in zip(slates, answers):
                want = eager_one(sl)
                scale = float(np.abs(want).max())
                err = float(np.abs(got - want).max())
                assert got.shape == want.shape and err <= (
                    BF16_SCORE_TOL * scale), (len(sl), err, scale)
                worst35 = max(worst35, err / scale)
            # a lone request is a wave of bucket 1: its graph replays the
            # eager B=1 call's kernels on the same inputs, bit for bit
            for n in (240, 33, 1):
                sl = rng35.randn(n, N_FEATURES).astype(np.float32)
                got = post(url35, sl, True)
                assert np.array_equal(got, eager_one(sl)), n
            with urllib.request.urlopen(url35 + "/statz", timeout=30) as r:
                stats35 = json.loads(r.read())
            assert stats35["requests_total"] == len(slates) + 3, stats35
            assert stats35["wave_errors_total"] == 0, stats35
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        print(f"reference checkpoint -> service: the flagship's reference "
              f"state_dict ({len(sd35)} tensors) converted by `python -m "
              f"allrank_tpu_torch.interop` in {convert_s:.1f} s (the "
              f"model.npz is the in-process mapping bit for bit); `python -m "
              f"allrank_tpu_torch.serve_http` (bf16, buckets 1,8,{B}) up in "
              f"{startup_s:.1f} s; {len(slates)} concurrent requests in "
              f"{stats35['waves_total'] - 3} waves "
              f"{stats35['waves_by_bucket']} within {worst35:.3e} x "
              f"max|score| of the in-process eager scorer (tol "
              f"{BF16_SCORE_TOL}); 3 lone requests equal to it bit for bit")

        # export, load, and the graphed scorer of the same settings
        x35 = rng35.randn(B, L, N_FEATURES).astype(np.float32)
        l35 = rng35.randint(1, L + 1, size=B)
        l35[0], l35[5] = L, 0
        sizes35 = {}
        for label, quantize, scales in (("bf16", None, None),
                                        ("int8_static", "int8_static",
                                         act_scales)):
            path = export_scorer(flag, L, N_FEATURES,
                                 os.path.join(ddir, f"{label}.npz"),
                                 batch_size=B, compute_dtype="bfloat16",
                                 quantize=quantize, act_scales=scales)
            sizes35[label] = os.path.getsize(path)
            loaded = load_scorer(path)
            eager = make_scorer(flag, "bfloat16", quantize=quantize,
                                act_scales=scales)
            graphed, _ = aot_compile(eager, B, L, N_FEATURES)
            a, g = loaded(x35, l35), graphed(x35, l35)
            assert torch.equal(a, g), label
            assert torch.equal(g, eager(x35, l35)), label
        print(f"export_scorer -> load_scorer at B={B} L={L}, bf16 flow: the "
              f"loaded scorer equals the graphed scorer, and it the eager "
              f"one, bit for bit; files {sizes35} bytes")

        # eager against graphed, in turns, per dtype and bucket
        serve35 = {}
        for label, quantize, flow in (("fp32", None, "float32"),
                                      ("bf16", None, "bfloat16"),
                                      ("int8_static", "int8_static",
                                       "bfloat16")):
            scorer = make_scorer(flag, flow, quantize=quantize,
                                 act_scales=act_scales if quantize else None)
            pool35 = GraphPool()
            for b in (1, 8, B):
                graphed, info = aot_compile(scorer, b, L, N_FEATURES,
                                            pool=pool35)
                xd = torch.as_tensor(x35[:b], device=dev)
                ld = torch.as_tensor(l35[:b], device=dev)
                assert torch.equal(graphed(xd, ld), scorer(xd, ld)), (
                    label, b)
                runs = {"eager": lambda: scorer(xd, ld),
                        "graph": lambda: graphed(xd, ld)}
                ms = {"eager": [], "graph": []}
                for way in ("eager", "graph", "graph", "eager"):
                    ms[way].append(median_ms(runs[way], iters=20, warmup=3))
                busy = {}
                for way, fn in runs.items():
                    try:
                        spans, window_us = trace_kernels(fn, 5)
                        us = busy_us(spans)
                        busy[way] = (us / 5 / 1e3, 1 - us / window_us)
                    except IncompleteTrace:
                        busy[way] = None
                copy_ms = median_ms(
                    lambda: torch.as_tensor(x35[:b], device=dev), iters=20,
                    warmup=3)
                serve35[f"{label} B={b}"] = {
                    "eager_ms": ms["eager"], "graph_ms": ms["graph"],
                    "busy_ms_idle": busy, "h2d_ms": copy_ms,
                    "temp_bytes": info["temp_size_in_bytes"]}

                def fmt(v):
                    return ("not measured" if v is None else
                            f"busy {v[0]:.4f} ms, idle {v[1]:.3f}")

                print(f"time scorer {label} B={b} L={L}: eager "
                      f"{ms['eager'][0]:.4f} / {ms['eager'][1]:.4f} ms a "
                      f"call, graphed {ms['graph'][0]:.4f} / "
                      f"{ms['graph'][1]:.4f} (in turns: eager, graph, graph, "
                      f"eager; x on the device); eager {fmt(busy['eager'])}; "
                      f"graphed {fmt(busy['graph'])}; the host->device copy "
                      f"of x apart {copy_ms:.4f} ms; graph pool "
                      f"+{info['temp_size_in_bytes']} bytes {tag}")
    finally:
        deploy.cleanup()
    phase_ok(f"phase 35 ok: a reference checkpoint converted by the interop "
             f"CLI and served by the serve CLI on CUDA graphs; exported "
             f"scorers round-trip; graphed scores are the eager ones bit for "
             f"bit ({time.perf_counter() - t35:.1f} s)")

    # -- 36: the host data path at WEB30K's shape -----------------------------
    t36 = time.perf_counter()
    from itertools import islice

    from allrank_tpu_torch.data.batching import SlateBatcher as Batcher
    from allrank_tpu_torch.data.dataset import (
        SlateDataset as Dataset,
        parse_svmlight,
        parse_svmlight_cached,
    )
    from allrank_tpu_torch.data.feature_store import DeviceFeatureStore
    from allrank_tpu_torch.data.batching import DevicePrefetcher as Feed

    host_tag = f"[{name_power}; host {host_cpu()}]"
    host_kernels = (attention_sublayer_fwd, attention_sublayer_bwd,
                    ffn_sublayer_fwd, ffn_sublayer_bwd, lambda_pairs_fwd,
                    lambda_pairs_bwd, lambda_tiled_fwd, lambda_tiled_bwd,
                    attention_fused_fwd, attention_fused_bwd,
                    tiled_attention_fwd, tiled_attention_bwd)
    routed = host_kernels[:4] + host_kernels[8:]

    def host_counts():
        got = {k.__name__: k.launches for k in host_kernels}
        for k in routed:
            got.update({f"{k.__name__}[{way}]": n
                        for way, n in k.route_launches.items()})
        return got

    def host_reset():
        for k in host_kernels:
            k.launches = 0
        for k in routed:
            k.route_launches = dict.fromkeys(k.route_launches, 0)

    def same_bits(got, ref, what):
        for a, b in zip(got, ref, strict=True):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                               b.dtype)
            assert np.array_equal(a, b), what

    host_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_web30k_")
    try:
        # (a) the data, written by the C++ writer
        hdata = os.path.join(host_dir.name, "data")
        host_arrays, host_s = write_web30k_dataset(hdata)
        paths = {r: os.path.join(hdata, f"{r}.txt") for r in host_arrays}
        sizes = {r: (len(np.unique(a[2])), len(a[1]),
                     os.path.getsize(paths[r])) for r, a in
                 host_arrays.items()}
        lengths = np.bincount(host_arrays["vali"][2])
        assert lengths.max() == WEB30K_LONGEST, lengths.max()
        print(f"web30k-shaped data (queries, documents, bytes) {sizes}, "
              f"grades {np.bincount(host_arrays['train'][1].astype(int))}: "
              f"drawn in {host_s['draw']:.2f} s, written by the C++ writer "
              f"in {host_s['write']:.2f} s {host_tag}")

        # (b) parsing: the C++ parser on the writer's own arrays (the round
        # trip), against the numpy parser on vali, the validate CLI on both
        # roles, the binary cache's miss (memmap-direct) and hit
        secs = {}
        for role, path in paths.items():
            t0 = time.perf_counter()
            parsed = parse_svmlight(path)
            secs[f"C++ parse {role}"] = time.perf_counter() - t0
            same_bits(parsed, host_arrays[role], f"round trip {role}")
        t0 = time.perf_counter()
        plain = parse_svmlight(paths["vali"], backend="numpy")
        secs["numpy parse vali"] = time.perf_counter() - t0
        same_bits(plain, host_arrays["vali"], "numpy parser on vali")
        del plain, parsed
        t0 = time.perf_counter()
        checked = subprocess.run(
            [sys.executable, "-m", "allrank_tpu_torch.data.validate",
             "--ds_path", hdata, "--roles", "train,vali", "--slate_length",
             str(L)], capture_output=True, text=True, timeout=300)
        secs["validate CLI (a process)"] = time.perf_counter() - t0
        assert checked.returncode == 0, checked.stderr[-3000:]
        for line in checked.stderr.splitlines()[-8:]:  # its warnings
            print("  validate CLI: " + line)
        cached = {}
        for role, path in paths.items():
            t0 = time.perf_counter()
            miss = parse_svmlight_cached(path)
            secs[f"cache miss {role} (memmap-direct)"] = (
                time.perf_counter() - t0)
            t0 = time.perf_counter()
            hit = parse_svmlight_cached(path)
            secs[f"cache hit {role}"] = time.perf_counter() - t0
            assert isinstance(miss[0], np.memmap) and isinstance(
                hit[0], np.memmap)
            same_bits(miss, host_arrays[role], f"cache miss {role}")
            same_bits(hit, miss, f"cache hit {role}")
            cached[role] = hit
        print("parse seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in secs.items()) + " (every parse bit for "
            f"bit the writer's arrays; the numpy parser's vali too) "
            f"{host_tag}")
        rate = {role: host_arrays[role][0].size / secs[what] / 1e6
                for role, what in (("train", "C++ parse train"),
                                   ("vali", "numpy parse vali"))}
        print(f"C++ parser: {rate['train']:.1f} M numbers/s on train, numpy "
              f"parser {rate['vali']:.1f} M/s on vali {host_tag}")

        # (c) the train CLI on the paper recipe over the store, the binary
        # cache, 4 assembly threads and a profiler trace of its one epoch
        trace_dir = os.path.join(host_dir.name, "trace")
        n_train = WEB30K_QUERIES["train"]
        n_val = WEB30K_QUERIES["vali"]
        steps = -(-n_train // B)
        val_batches = -(-n_val // B)
        host_reset()
        result, out_dir, losses, cli_s = run_cli(
            PAPER_CONFIG, host_dir.name, "web30k", 1, data_path=hdata,
            data={"binary_cache": True, "device_cache": True,
                  "num_workers": 4},
            training={"profiler_trace_dir": trace_dir})
        host_launches = host_counts()
        check_cli_outputs(result, out_dir, losses, 1, ("ndcg_5", "ndcg_10"))
        # train steps at L=240: B1, B2 4 + 4 and B3 1 + 1; the train set's
        # evaluation at 240 likewise forward; vali padded to its longest
        # slate, 1,308 (past B4's 1,224): B5 and B2 4 forward, B6 1
        want = dict.fromkeys(host_launches, 0)
        for sub, fwd in (("attention_sublayer", 2 * steps),
                         ("ffn_sublayer", 2 * steps + val_batches)):
            want[f"{sub}_fwd"] = want[f"{sub}_fwd[mma]"] = 4 * fwd
            want[f"{sub}_bwd"] = want[f"{sub}_bwd[mma]"] = 4 * steps
        want["lambda_pairs_fwd"], want["lambda_pairs_bwd"] = 2 * steps, steps
        want["lambda_tiled_fwd"] = val_batches
        want["tiled_attention_fwd"] = 4 * val_batches
        want["tiled_attention_fwd[mma]"] = 4 * val_batches
        assert host_launches == want, (host_launches, want)
        with open(os.path.join(out_dir, "training.log")) as f:
            log = f.read()
        assert "device feature store: train" in log and (
            "dataset cache hit" in log), log[-3000:]
        trace_file = os.path.join(trace_dir, "epoch_0.pt.trace.json")
        with open(trace_file) as f:
            kernels = collections.Counter(
                e["name"] for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel")
        traced = {what: sum(n for k, n in kernels.items() if all(
            p in k for p in parts)) for what, parts in (
            ("B1", ("b1_", "_mma_kernel")), ("B2", ("b2_", "_mma_kernel")),
            ("B3", ("lambda_cluster_",)))}
        assert all(traced.values()), (traced, kernels.most_common(20))
        print(f"train CLI, {PAPER_CONFIG} over the device feature store "
              f"(binary cache, 4 assembly threads, a profiler trace): 1 "
              f"epoch of {steps} steps, {val_batches} vali batches at "
              f"L={WEB30K_LONGEST}, in {cli_s:.1f} s with loading; train "
              f"loss {losses['train']}, val ndcg_5 "
              f"{result['val_metrics']['ndcg_5']:.4f}; launches "
              f"{host_launches}; the trace "
              f"({os.path.getsize(trace_file) / 1e6:.1f} MB) names "
              f"B1/B2/B3 kernels {traced} times {host_tag}")

        # (d) the first 5 steps over the store against the materialising
        # feed: the same parameters bit for bit on the card
        train_ds = Dataset(*cached["train"])
        cfg, store_model = paper_setup(dev)
        _, feed_model = paper_setup(dev)
        dtype = cfg.training.compute_dtype
        store = DeviceFeatureStore(train_ds, device=dev, dtype="bfloat16")
        store_step = make_step(cfg, store_model, dtype)
        feed_step = make_step(cfg, feed_model, dtype)
        index_batches = Batcher(train_ds, L, B, shuffle=True, num_workers=4,
                                emit_row_indices=True)
        feature_batches = Batcher(train_ds, L, B, shuffle=True,
                                  num_workers=4)
        for bi, bm in islice(zip(Feed(index_batches, device=dev),
                                 Feed(feature_batches, device=dev)), 5):
            store_step(*bi, table=store.table)
            feed_step(*bm)
        torch.cuda.synchronize()
        for (name, p), q in zip(store_model.named_parameters(),
                                feed_model.parameters()):
            assert torch.equal(p, q), name
        print(f"5 paper-config steps over the bf16 store (gathered in the "
              f"step) equal the materialising feed's bit for bit: "
              f"{sum(p.numel() for p in store_model.parameters())} "
              f"parameters")

        # (e) the C++ assembler's bytes at 1 and 4 threads
        for a, b in zip(Batcher(train_ds, L, B, shuffle=True, num_workers=1),
                        Batcher(train_ds, L, B, shuffle=True, num_workers=4),
                        strict=True):
            same_bits(a, b, "assembly at 1 and 4 threads")

        # (f) host times: assembly, the epoch's feed and train loops with
        # and without the store, the store's bytes
        rates = {}
        for label, kw in (("C++, 1 thread", {"num_workers": 1}),
                          ("C++, 4 threads", {"num_workers": 4}),
                          ("Python row loop", {"assembly": "python"})):
            batches = Batcher(train_ds, L, B, shuffle=True, **kw)
            t0 = time.perf_counter()
            for _ in batches:
                pass
            rates[label] = n_train / (time.perf_counter() - t0)
        split = {}
        for label, batches, step, table in (
                ("store", index_batches, store_step, store.table),
                ("materialising", feature_batches, feed_step, None)):
            t0 = time.perf_counter()
            for _ in Feed(batches, device=dev):
                pass
            torch.cuda.synchronize()
            split[f"{label} feed alone"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for batch in Feed(batches, device=dev):
                step(*batch, table=table)
            torch.cuda.synchronize()
            split[f"{label} train"] = time.perf_counter() - t0
        store_bytes = store.table.numel() * store.table.element_size()
        print(f"assembly slates/s over train ({n_train} slates, L={L}): "
              + ", ".join(f"{k} {v:.0f}" for k, v in rates.items())
              + f"; epoch of {steps} steps, seconds: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; the bf16 store {store_bytes} bytes on the card "
              f"({store.table.shape[0]} rows) {host_tag}")
        del store, store_model, feed_model, cached, train_ds
        torch.cuda.empty_cache()
    finally:
        host_dir.cleanup()
    phase_ok(f"phase 36 ok: the host data path at WEB30K's shape: C++ "
             f"writer, parser, cache and validator bit for bit; the train "
             f"CLI over the store with exact launches and a trace; the store "
             f"equal to the feed ({time.perf_counter() - t36:.1f} s)")

    # -- 37: the record -------------------------------------------------------
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
        "attention_sublayer_fwd_tf32x3": (
            "allrank_tpu_torch/csrc/attention_block_tf32x3.cu",
            "allrank_tpu/ops/attention_block.py:343"),
        "attention_sublayer_bwd_tf32x3": (
            "allrank_tpu_torch/csrc/attention_block_tf32x3.cu",
            "allrank_tpu/ops/attention_block.py:375"),
        "ffn_sublayer_fwd_tf32x3": (
            "allrank_tpu_torch/csrc/ffn_block_tf32x3.cu",
            "allrank_tpu/ops/ffn_block.py:204"),
        "ffn_sublayer_bwd_tf32x3": (
            "allrank_tpu_torch/csrc/ffn_block_tf32x3.cu",
            "allrank_tpu/ops/ffn_block.py:233"),
        "lambda_pairs_fwd": ("allrank_tpu_torch/csrc/lambda_pairs.cu",
                             "allrank_tpu/ops/lambda_pallas.py:174"),
        "lambda_pairs_bwd": ("allrank_tpu_torch/csrc/lambda_pairs.cu",
                             "allrank_tpu/ops/lambda_pallas.py:197"),
        "soft_sort_fwd": ("allrank_tpu_torch/csrc/neuralsort_cluster.cu",
                          "allrank_tpu/ops/neuralsort_pallas.py:186"),
        "soft_sort_bwd": ("allrank_tpu_torch/csrc/neuralsort_cluster.cu",
                          "allrank_tpu/ops/neuralsort_pallas.py:214"),
        "soft_sort_fwd_l2": ("allrank_tpu_torch/csrc/neuralsort.cu",
                             "allrank_tpu/ops/neuralsort_pallas.py:186"),
        "soft_sort_bwd_l2": ("allrank_tpu_torch/csrc/neuralsort.cu",
                             "allrank_tpu/ops/neuralsort_pallas.py:214"),
        "sinkhorn_fwd": ("allrank_tpu_torch/csrc/sinkhorn_cluster.cu",
                         "allrank_tpu/ops/sinkhorn_pallas.py:286"),
        "sinkhorn_bwd": ("allrank_tpu_torch/csrc/sinkhorn_cluster.cu",
                         "allrank_tpu/ops/sinkhorn_pallas.py:325"),
        "sinkhorn_fwd_l2": ("allrank_tpu_torch/csrc/sinkhorn.cu",
                            "allrank_tpu/ops/sinkhorn_pallas.py:286"),
        "sinkhorn_bwd_l2": ("allrank_tpu_torch/csrc/sinkhorn.cu",
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
        "encoder_block_fwd": ("allrank_tpu_torch/csrc/encoder_block.cuh",
                              "allrank_tpu/ops/encoder_block.py:302"),
        "encoder_block_bwd": ("allrank_tpu_torch/csrc/encoder_block.cuh",
                              "allrank_tpu/ops/encoder_block.py:333"),
        "boundary_plain": ("allrank_tpu_torch/csrc/boundary_shift_mma.cu",
                           "tools/exp_boundary_shift.py:95"),
        "boundary_shift": ("allrank_tpu_torch/csrc/boundary_shift_mma.cu",
                           "tools/exp_boundary_shift.py:102"),
        "layout_soft_sort_fwd": ("allrank_tpu_torch/csrc/neuralsort_layout.cu",
                                 "tools/exp_sinkhorn_layout.py:205"),
        "layout_soft_sort_bwd": ("allrank_tpu_torch/csrc/neuralsort_layout.cu",
                                 "tools/exp_sinkhorn_layout.py:231")}
    for mode in MODES:
        origin[f"attention_variant_{mode}"] = (
            "allrank_tpu_torch/csrc/attention_variants.cu",
            "tools/exp_attn_decompose.py:126")
        origin[f"attention_variant_{mode}_mma"] = (
            f"allrank_tpu_torch/csrc/{MMA_LIBRARIES[mode]}.cu",
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
    # B1 and B2 by route: the fp32 service (phase 5) runs the 3xTF32
    # forwards and the fp32 step 1 against the CPU (phase 9) their
    # backwards; the bf16 train steps (phase 9) run the tensor-core kernels
    # both ways. B1's SIMT kernels run on B10's reference chain at d_k > 128
    # alone (phase 28), a check and no main path; B2's on no path at all
    # (B10's FFN phases run on the tensor cores, as B2's route): their rows
    # say so
    launch_source = {}
    for sub, fp32_routes, train_routes, routes in (
            ("attention_sublayer", b1_fp32_routes, b1_train_routes,
             chain_routes[0]),
            ("ffn_sublayer", b2_fp32_routes, b2_train_routes,
             chain_routes[1])):
        # the fp32 service's (phase 5) and rank_and_click's (phase 34)
        launches[f"{sub}_fwd_tf32x3"] = (launches.pop(f"{sub}_fwd")
                                         + rc_launches[f"{sub}_fwd"])
        launches[f"{sub}_bwd_tf32x3"] = fp32_routes[1]["tf32x3"]
        launches[f"{sub}_fwd"] = routes[0]["simt"]
        launches[f"{sub}_bwd"] = routes[1]["simt"]
        launch_source[f"{sub}_fwd"] = launch_source[f"{sub}_bwd"] = (
            "b10_reference_chain_d_k_over_128" if sub == "attention_sublayer"
            else "none: no path runs the SIMT FFN kernels")
        launches[f"{sub}_fwd_mma"] = train_routes[0]["mma"]
        launches[f"{sub}_bwd_mma"] = train_routes[1]["mma"]
    assert launches["attention_sublayer_fwd"] > 0
    assert launches["ffn_sublayer_fwd"] == launches["ffn_sublayer_bwd"] == 0
    # X1: the int8_static service (phase 26)
    launches["q8_dense"] = q8_main_launches["q8_dense"]
    # B10: with the switch on, its service (forward) and its 20 train steps
    # (backward) (phase 29)
    launches["encoder_block_fwd"] = enc_service_launches
    launches["encoder_block_bwd"] = enc_train["encoder_block_bwd"]
    # the services replay a CUDA graph a wave: their launches are the ones
    # each graph captured a wave times its replays, its kernels seen by name
    # in a device trace of a wave
    graphs = "CUDA graph replays x launches captured a wave, traced"
    launch_source["attention_sublayer_fwd_tf32x3"] = launch_source[
        "ffn_sublayer_fwd_tf32x3"] = (
        f"phase 5's fp32 service ({graphs}) and rank_and_click (phase 34)")
    launch_source["q8_dense"] = f"phase 26's int8_static service ({graphs})"
    launch_source["encoder_block_fwd"] = (
        f"phase 29's switch-on service ({graphs})")
    for row in rows:
        if row["name"].startswith("encoder_block_"):
            row["routes_source"] = [
                "allrank_tpu_torch/csrc/encoder_block_f32.cuh",
                "allrank_tpu_torch/csrc/encoder_block_bf16.cuh"]
            row["launches_by_route_phase29"] = enc_routes[
                row["name"][-3:]]
    # X2, X3 and X4: their probes' own runs (phases 31-33); X3's by route,
    # the tensor cores at the default d_k 32, the SIMT units at d_k 256
    launches.update(x2_launches)
    for m in MODES:
        launches[f"attention_variant_{m}_mma"] = x3_launches["mma"][m]
        launches[f"attention_variant_{m}"] = x3_launches["simt"][m]
        launch_source[f"attention_variant_{m}"] = (
            "the X3 probe at B=8, L=256, d=256, h=1 (d_k > 128: B1's SIMT "
            "route)")
    launches.update(x4_launches)
    # B8 and B7: the main routes' launches are the CLI's NeuralNDCG run's
    # and the L=640 step's (phase 13), all on "cluster"; route "l2" of
    # either runs on no path (phases 11-12 hold it against its plain
    # version by name; the X4 probe's B8 arm runs "cluster")
    assert (cli_launches["soft_sort_fwd[cluster]"],
            cli_launches["soft_sort_bwd[cluster]"]) == (
        launches["soft_sort_fwd"], launches["soft_sort_bwd"])
    assert (b7_launches["sinkhorn_fwd[cluster]"],
            b7_launches["sinkhorn_bwd[cluster]"]) == (
        launches["sinkhorn_fwd"], launches["sinkhorn_bwd"])
    l2_rows = ("soft_sort_fwd_l2", "soft_sort_bwd_l2", "sinkhorn_fwd_l2",
               "sinkhorn_bwd_l2")
    for name in l2_rows:
        launches[name] = (cli_launches[name.replace("_l2", "[l2]")]
                          + b7_launches[name.replace("_l2", "[l2]")])
        launch_source[name] = ("none: route \"l2\" runs on no path (the "
                               "CLI's NeuralNDCG run and the L=640 step "
                               "launch it 0 times); phases 11-12 check it by "
                               "name")
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
        if name in launch_source:
            row["launch_source"] = launch_source[name]
        row["train_launches"] = train_launches.get(name,
                                                   enc_train.get(name, 0))
        row["cli_launches"] = (cli_launches.get(name, 0)
                               + paper_launches.get(name, 0)
                               + sum(r.get(name, 0)
                                     for r in recipe_launches.values()))
        # every kernel of a path launched on it; B2's SIMT kernels and B7's
        # and B8's "l2" routes run on none (launch_source)
        assert row["launches"] > 0 or name in ("ffn_sublayer_fwd",
                                               "ffn_sublayer_bwd",
                                               *l2_rows), name
        for k, v in row.items():
            assert not isinstance(v, float) or math.isfinite(v), (k, v)
    # the host data path's CLI run (phase 36), beside each kernel it ran
    host_rows = {f"{sub}_{way}_mma": host_launches[f"{sub}_{way}[mma]"]
                 for sub in ("attention_sublayer", "ffn_sublayer")
                 for way in ("fwd", "bwd")}
    host_rows.update({k: host_launches[k] for k in (
        "lambda_pairs_fwd", "lambda_pairs_bwd", "lambda_tiled_fwd",
        "tiled_attention_fwd")})
    for row in rows:
        if row["name"] in host_rows:
            row["host_data_launches"] = host_rows[row["name"]]
    assert len(rows) == 49
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
