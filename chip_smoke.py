"""Smoke run of fastervit_tpu_torch, the PyTorch/CUDA port of FasterViT, on
one NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles the port's CUDA sources (fastervit_tpu_torch/csrc),
     one nvcc per source, all at once;
  3. K1, the window-attention kernel, against its plain PyTorch version on
     the card, at FasterViT-0's batch-256 shapes and an odd shape, in fp32
     (scalar FMA) and bf16 (the tensor cores, wgmma), every call's plan
     and its shared memory held to short_plan and the library, two bf16
     launches bit-identical; ptxas' registers and spills of each
     tensor-core instance; kernel, plain version and SDPA timed at the fv0
     shapes, with TFLOP/s and GB/s;
  4. K2, the window-attention backward kernel, against its plain version,
     in fp32 (scalar FMA) and bf16 (wgmma), at FasterViT-0's batch-128
     training shapes, an odd shape and K2's largest shape, every call's
     plan held to short_bwd_plan and the library, dqkv and dbias of two
     bf16 launches bit-identical; ptxas' registers and spills; kernel,
     plain version and SDPA's backward timed at the training shapes, with
     TFLOP/s and GB/s;
  5. faster_vit_0_224 in fp32 through create_model, on the card (kernel
     path) against the CPU (plain path), batch 4, counting kernel launches,
     every K1 call on scalar FMA;
  6. the inference path: faster_vit_0_224 in bf16 at batch 256, its K1
     launches counted, each on the tensor cores, its logits against fp32
     on the same weights, timed;
  7. one fv0 fp32 train step, card against CPU, batch 4, same weights and
     mixup draws: loss and every gradient, 17 K1 and 17 K2 launches, each
     on scalar FMA, the attention gradients non-zero;
  8. the training path: the train.py CLI on synthetic data (4 steps at
     batch 128 and eval, in the config's bf16: K1 and K2 on the tensor
     cores), then
     make_train_step with the fv0 recipe in bf16 at batch 128: 10 steps on
     one batch must lower the loss, then 20 steps timed, launches counted,
     every K1 and K2 call on the tensor cores, and 2 profiled;
  9. K3, the long-window attention kernel, against its plain version in
     fp32 (scalar FMA) and bf16 (the tensor cores, wgmma; bias f32 and
     bf16) at the 21k-768 and 21k-384 shapes, the any-res carrier shape,
     an fv5 shape (hd 80), ragged S and B = 0, every call's route and
     shared memory held to long_plan and the library; ptxas' registers
     and spills of each tensor-core instance; kernel, plain version and
     SDPA timed at the 21k shapes, with TFLOP/s;
 10. faster_vit_4_21k_768 in fp32 through create_model, on the card (K3
     path) against the CPU (plain path), batch 1;
 11. the serving path: faster_vit_4_21k_768 in bf16 at batch 16, a live
     forward, bake_posemb, a baked forward bit-identical to it, launches
     counted, logits against fp32 on the same weights, live and baked
     forwards timed, one baked forward profiled;
 12. faster_vit_0_any_res (576x960) and faster_vit_5_224 in bf16: their
     K1 and K3 launches, logits against fp32;
 13. K4, the long-window attention backward, against its plain version in
     fp32 (scalar FMA) and bf16 (the tensor cores, wgmma; bias f32 and
     bf16) at the 21k-384 and 21k-768 shapes, 21k-224's, fv5's (hd 80),
     the any-res carriers', a K1-forward window past K2, ragged S and B =
     0, then bf16 at every padded head dim (32, 49, 64, 80, 128) and S 1,
     63, 64, 65, 127, 129, 2305; dqkv and dbias bit-identical over two
     launches; every call's route and shared memory held to long_bwd_plan
     and the library; ptxas' registers and spills of each tensor-core
     instance; kernel, plain version and SDPA's backward timed at the 21k
     shapes, with TFLOP/s;
 14. one faster_vit_4_21k_384 fp32 train step, card against CPU, batch 2:
     loss and every gradient, 17 K3 and 17 K4 launches, K4 on scalar FMA;
 15. the fine-tuning CLI: a 21841-class faster_vit_4_21k_224 state_dict
     saved as a reference .pth.tar warm-starts faster_vit_4_21k_384 in
     bf16 at batch 32 (3 steps and eval), which writes a checkpoint; the
     same command again auto-resumes from it;
 16. the large-window training path: faster_vit_4_21k_384 with the fine-tune
     recipe in bf16 at batch 32, 12 steps timed, launches counted, K4 on
     the tensor cores, peak memory, one step profiled; then peak memory
     and step time with gradient checkpointing;
 17. one bf16 train step of faster_vit_5_224 and of faster_vit_0_any_res
     (576x960) at batch 8: their K1, K2, K3 and K4 launches, K4 on the
     tensor cores;
 18. K5, the multi-scale deformable attention kernel, against its plain
     version in fp32 and bf16 at DINO-4scale's encoder and decoder shapes
     (batch 2, 800x1333) and at odd ones (D 1, 4, 8, 24, 33, 48 and 64, a
     1x1 level, border and far-outside locations, N = 0, Q = 0), and with
     a value one element into its storage (scalar loads, the aligned
     launch's bits), two launches bit-identical; the C entry point's
     refusal of plans it cannot run; ptxas' registers and spills of every
     instance, the served ones without spills; kernel, plain version and
     upstream's grid_sample form timed at the served shapes, and the
     kernel at the encoder shape with coherent locations (each query's
     samples near its own token, as the model's);
 19. DINO-4scale on faster_vit_4_21k_224 in fp32, batch 1, 480x640: the
     card (kernel path) against the CPU (plain path), the backbone maps,
     the encoder's proposals, the two-stage selection and every decoder
     layer, and its K1, K3 and K5 launches, the K5 ones counted by plan;
 20. the serving path: that detector in bf16 at batch 2 on an 800x1333
     canvas: 17 K1 (each on the tensor cores), 12 K3 and 12 K5 launches
     a forward, each bf16 K5 launch on a vector plan (V > 1), bf16
     against fp32 on the same weights up to the encoder output, 10 timed
     batches, peak memory, one forward profiled;
 21. the detection CLI (--eval --synthetic, the served config, 800x800)
     from a reference-layout DINO checkpoint it writes first, then the
     route check of DINO-4scale on faster_vit_0_224 at 800x1333 (11 K1,
     6 K3, 12 K5);
 22. K6, the fused HAT sub-block kernel: ptxas' registers and spills of
     its two tensor-core instances (none in the served one), its C entry
     point's refusal of 7 wrong plans; against its plain version in fp32
     and bf16 at FasterViT-0's batch-256 sites (carrier, joint, level 3;
     bf16 on the wgmma route with a ring of 3 or more slots) and odd ones
     (fv1's carrier, 10 heads, hd 49, S = 1, a ragged batch, B = 0), γ
     learned and ones, its DropPath instantiation with zero masks, two
     launches bit-identical; K6, the plain version and the composed
     sub-block timed at the fv0 sites beside the bound;
 23. faster_vit_0_224 fp32 b4 with set_fused_hat(True): the card (17 K6, no
     K1) against the CPU (plain path) and the card's composed path;
 24. the serving path through the fused block: faster_vit_0_224 bf16 b256
     with set_fused_hat(True): 17 K6 launches and none of K1-K5 a forward,
     logits against fp32, 20 batches timed in turns with the switch off,
     launches a forward and device busy share from torch.profiler both
     ways, peak memory, both forwards profiled; a baked forward
     bit-identical;
 25. fused_hat_block_dp forward and backward at the joint site in bf16 and
     fp32 against autograd through the plain version (output, x, params,
     bias, dp1, dp2): 1 K6, 1 K1 and 1 K2 launch, K1 and K2 on the tensor
     cores in bf16 and on scalar FMA in fp32;
 26. the long-window attention probes' kernels: P1 (chunked online
     softmax, C = 1, 2, 4) and P2 (no bias; on separate q, k, v and on
     views of a packed qkv) against their plain versions in fp32 (scalar
     FMA) and bf16 (wgmma) at the probes' call (16 windows, S 2304, 16
     heads, hd 49), 21k-768 level 3, ragged S, hd 128 and B = 0, every
     call's route held to long_plan, ptxas' registers and spills of each
     tensor-core instance, two launches bit-identical; kernel, plain
     version, SDPA and bound timed in turns at the probes' call, with
     TFLOP/s; then the probes' main path, attn_vpu_probe and
     attn_online_probe through their main at that call, their JSON printed
     and kept in the output directory, P1 and P2 launched there;
 27. the MSDA gather probes' kernels: ptxas' registers and spills of the 108
     instances of the vec kernel (pair, packed and coeff mode: P3a-c, P4a,
     P4b, P4c; none in the 24 that D 32 runs), their C entry points' refusal
     of 7 wrong plans; P3a (fused_gather), P3b (fused_gather_p4, P = 1, 2, 4),
     P3c (fused_gather_per_head) and P4a (packed_gather on f32 and bf16
     corner-packed maps, P = 1, 2, 4) against their plain versions at MOTR's
     four padded levels at the probes' QP 408,000 and at odd shapes (a 3x3
     map, QP 4 and 4,004, one head, D 64, QP 0), each also with out-of-range
     samples, which must give NaN at the plain versions' places, every
     launch's plan held to probe_plan; two launches bit-identical, each timed
     call's route (smem for the pair kernels at level 3, l2 elsewhere) and its
     16-byte vectors checked, maps one element into their storage on V 1 with
     the aligned launch's bits; kernel, plain version, the grid_sample form
     and bound timed in turns at levels 0 and 3; then the probes' main path,
     msda_pallas_probe (the levels, then K5's encoder call) and
     msda_packed_probe through their main, their JSON printed and kept in the
     output directory, the four kernels and K5 launched there;
 28. the second MSDA gather probe's kernels: P4b (pair_staticr), P4c
     (packed_coeff) and P4d (packed_wide) against their plain versions at
     every shape of phase 27, P 1, 2, 4, on f32 and bf16 maps, P4c and P4d
     on the weights of coeff_scalars / coeff_wide and on random ones, each
     also with out-of-range samples (NaN at the plain versions' places),
     every P4b and P4c launch's plan held to probe_plan; P4b on an f32
     map equal to P3b and P4c on coeff_scalars equal to P4a bit for bit,
     P4d's groups summed within the order bound of P4a; two launches
     bit-identical, P4b's and P4c's routes (P4c on l2 at both levels) and
     16-byte vectors checked;
     kernel, plain version, the grid_sample form and bound timed in turns
     at levels 0 and 3, f32 and bf16 maps; then the probe's main path,
     msda_packed_probe2 through its main at all four levels, its JSON
     printed and kept in the output directory, the three kernels (and P3b,
     P4a) launched there.
It prints one JSON line on the kernels and, as its last line,
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result. It imports no jax.
"""
from __future__ import annotations

import collections
import copy
import csv
import gc
import json
import logging
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from fastervit_tpu_torch import probes  # noqa: E402
from fastervit_tpu_torch.probes import (  # noqa: E402
    HBM_BYTES_PER_S, gather_bytes, gather_grid, gather_grid_sample,
    msda_grid_sample, sdpa_backend, sdpa_for, time_ms)

# (B, S, heads, head_dim, calls per FasterViT-0 forward): level-2 joint
# window + carrier attention, level-2 carrier attention, level 3, at batch
# 256; then an odd shape with FasterViT-4's head_dim, checked but not timed.
FV0_SHAPES = [(1024, 53, 8, 32, 6), (256, 16, 8, 32, 6), (256, 49, 16, 32, 5)]
ODD_SHAPE = (3, 53, 4, 49, 0)
# The same sites in one training step at batch 128 (K2's calls), then the
# odd shape and K2's largest S and head_dim, checked but not timed.
TRAIN_SHAPES = [(512, 53, 8, 32, 6), (128, 16, 8, 32, 6),
                (128, 49, 16, 32, 5)]
K2_EXTRA_SHAPES = [(3, 53, 4, 49, 0), (5, 64, 2, 64, 0)]
TOL_FP32 = 2e-5      # f32 throughout, TF32 off: only the order of sums differs
# bf16 output and probabilities against f32 on bf16 inputs (K1's tensor-core
# route rounds the unnormalised p, the plain version the normalised one)
TOL_BF16 = 2e-2
# K2, relative to max(1, max |plain|): f32 throughout, TF32 off, sums in
# another order (dbias sums over up to 512 windows) ...
TOL_K2_FP32 = 1e-4
# ... and bf16 inputs on both sides, the kernel's outputs rounded to bf16
# once (2^-8 relative), and on the tensor cores P and dl rounded to bf16 for
# dq = dl·k, dk = dlᵀ·q and dv = Pᵀ·g (2^-9 a term; the JAX kernel and the
# plain version keep them f32; dbias sums the unrounded dl)
TOL_K2_BF16 = 1e-2
# K3 keeps K1's bounds, for the same reasons: f32 throughout with TF32 off
# (its running max adds rescalings, each exact to an ulp or so), and bf16
# output and probabilities against f32 on bf16 inputs
# (B, S, heads, head_dim, calls per forward, timing iterations):
# faster_vit_4_21k_768 at batch 16, level 2 then level 3 ...
K3_21K768_SHAPES = [(16, 2304, 16, 49, 12, 5), (16, 576, 32, 49, 5, 20)]
# ... faster_vit_4_21k_384 at batch 32, timed per call ...
K3_21K384_SHAPES = [(32, 576, 16, 49, 0, 20), (32, 144, 32, 49, 0, 20)]
# ... then checked only: fv0_any_res's carrier attention at 576x960 and
# batch 64, fv5's joint attention at batch 64 (hd 80), ragged S, and an
# empty batch
K3_EXTRA_SHAPES = [(64, 216, 8, 32), (256, 53, 16, 80),
                   (2, 129, 2, 49), (2, 197, 2, 49), (2, 2305, 2, 49),
                   (2, 129, 2, 128), (2, 197, 2, 128), (2, 2305, 2, 128),
                   (0, 576, 4, 49)]
# K4 (B, S, heads, head_dim): checked against its plain version in fp32 and
# bf16: faster_vit_4_21k_384 at batch 32, faster_vit_4_21k_768 (level 2 at
# batch 2, where the plain version's (B, H, S, S) f32 tensors are small;
# level 3 at batch 16), 21k-224's level 2, fv5's joint attention (hd 80),
# the any-res carriers, a K1-forward window past K2, ragged S at hd 49 and
# 128, an empty batch
K4_CHECK_SHAPES = [(32, 576, 16, 49), (32, 144, 32, 49), (2, 2304, 16, 49),
                   (16, 576, 32, 49), (8, 196, 16, 49), (64, 53, 16, 80),
                   (64, 216, 8, 32), (8, 100, 4, 32), (2, 129, 2, 49),
                   (2, 197, 2, 49), (2, 2305, 2, 49), (2, 129, 2, 128),
                   (2, 197, 2, 128), (2, 2305, 2, 128), (0, 576, 4, 49)]
# ... then bf16 only, on the tensor cores: each padded head dim (49 pads to
# 64) at S of one key, a key tile less one, one, one more, a block of 128
# q rows less one, one more, and the 21k-768 level-2 window plus one
K4_BF16_SHAPES = [(2, s, 2, d) for d in (32, 49, 64, 80, 128)
                  for s in (1, 63, 64, 65, 127, 129, 2305)]
# ... and timed, bf16, (B, S, heads, head_dim, calls per 21k-384 b32 train
# step, timing iterations): 21k-384 at batch 32, then 21k-768 at batch 16
K4_TIME_SHAPES = [(32, 576, 16, 49, 12, 20), (32, 144, 32, 49, 5, 20),
                  (16, 2304, 16, 49, 0, 3), (16, 576, 32, 49, 0, 10)]
# f32 throughout, TF32 off (the order of the sums and the online row
# statistics differ), relative to the tensor's largest entry; bf16 inputs
# on both sides, the kernel's outputs rounded to bf16 once
TOL_K4_FP32 = 1e-5
TOL_K4_BF16 = 1e-2
SERVE_BATCH = 16
FINETUNE_BATCH = 32
TOL_MODEL_FP32 = 1e-3
TOL_MODEL_BF16 = 0.15  # the bf16-vs-fp32 bound of tests/test_variants.py
# fp32 train step, card against CPU: the loss, and each gradient tensor
# relative to its largest entry (floor: 1e-5 of the largest of all, for the
# conv biases in front of a train-mode BatchNorm, whose gradient is zero in
# exact arithmetic and so only noise on both devices)
TOL_STEP_LOSS = 1e-4
TOL_STEP_GRAD = 1e-3
# ... except, where asked and where an input of the stem's two ReLUs lies
# on the other side of 0 on the card than on the CPU (a "flip": it sat
# within rounding of the kink), the stem's parameters, whose gradients then
# move by whole per-element terms: relative to the tensor's largest entry
TOL_STEM_GRAD = 2e-2
BATCH = 256
TRAIN_BATCH = 128
# H100 SXM, NVIDIA's data sheet: HBM_BYTES_PER_S (probes), and
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12      # f32 outside the tensor cores
# DINO-4scale at 800x1333: the transformer's four levels, and the encoder
# (Q = S) and decoder calls of K5 at batch 2, with 8 heads of 32 channels
# and 4 points: (N, Q, M, D, P, levels, calls per forward)
DINO_LEVELS = ((100, 167), (50, 84), (25, 42), (13, 21))
K5_SERVED = [(2, 22223, 8, 32, 4, DINO_LEVELS, 6),
             (2, 900, 8, 32, 4, DINO_LEVELS, 6)]
# ... and odd shapes, checked only: narrow and wide heads, a 1x1 level,
# one level, many points, an empty batch and an empty query set
K5_ODD = [(1, 37, 3, 4, 2, ((5, 7), (1, 1), (3, 2)), 0),
          (2, 50, 2, 8, 3, ((9, 4), (1, 1)), 0),
          (1, 64, 4, 64, 4, ((12, 17), (6, 9), (3, 5), (2, 3)), 0),
          (3, 41, 5, 33, 1, ((7, 7),), 0),
          (2, 29, 3, 24, 3, ((8, 6), (4, 3), (1, 2)), 0),
          (1, 23, 2, 1, 3, ((5, 4), (2, 2)), 0),
          (2, 30, 3, 48, 2, ((7, 9), (4, 5)), 0),
          (0, 10, 8, 32, 4, DINO_LEVELS, 0),
          (2, 0, 8, 32, 4, DINO_LEVELS, 0)]
# ... and with value one element into its storage: the decoder call and an
# odd one
K5_OFFSET = [K5_SERVED[1], K5_ODD[4]]
TOL_K5_FP32 = 1e-5   # f32 throughout; only the order of the sums differs
# K5 plans its C entry point must refuse at D 32 bf16, each beside whether
# the value it is handed lies one element into its storage
K5_WRONG_PLANS = [
    ((4, 8, 8, 8, 8), True),    # 16-byte loads from a 2-byte-aligned value
    ((4, 4, 4, 8, 8), False),   # 4 lanes of 4 channels: 16 of D's 32
    ((2, 8, 16, 16, 8), False),  # two lanes a row: no instance runs it
    ((4, 8, 8, 8, 9), False),   # nine warps a block, past kMaxWarps
]
# the instances msda_plan gives the served calls' f32 and bf16 launches
K5_SERVED_INSTANCES = ("<bf16, V 8, G 4, NV 1>", "<float, V 4, G 8, NV 1>")
DINO_CONFIG = "configs/dino/dino_4scale_faster_vit_4_21k_224.py"
DINO_CANVAS = (800, 1333)
DINO_BATCH = 2
# DINO fp32 card vs CPU, relative to each tensor's largest entry: f32 with
# TF32 off through 23 backbone blocks and 6 + 6 transformer layers, the
# sums in another order
TOL_DINO_FP32 = 1e-4
# DINO bf16 vs fp32 up to the encoder output, as ||bf16 - fp32|| / ||fp32||
# over the encoder memory and the proposals' class logits: bf16 keeps 8
# significant bits (2^-9 relative rounding) at every stored activation of
# the 23 backbone blocks and 6 encoder layers (MSDA's sampling locations
# and the reference boxes stay f32, as in the JAX detector): a few percent
TOL_DINO_BF16 = 5e-2
# K6, the fused HAT sub-block: (B, S, heads, C, calls per FasterViT-0 bf16
# b256 forward): the level-2 carrier and joint sub-blocks and level 3, timed;
# then checked only: faster_vit_1's carrier (C 320, 8 heads, hd 40), 10
# heads of 32 at C 320, a head dim of 49, one token a window, a ragged
# batch of carrier windows, and an empty batch
K6_FV0_SITES = [(256, 16, 8, 256, 6), (1024, 53, 8, 256, 6),
                (256, 49, 16, 512, 5)]
K6_ODD = [(64, 16, 8, 320, 0), (6, 16, 10, 320, 0), (8, 49, 4, 196, 0),
          (5, 1, 2, 32, 0), (3, 16, 8, 256, 0), (0, 53, 8, 256, 0)]
# K6 against its plain version (relative to max(1, max |plain|)): f32
# throughout with TF32 off, the sums in another order; bf16: the plain
# version rounds each product to bf16 before its f32 bias (as the JAX
# reference does) and the kernel does not, one bf16 step at each of the
# rounded intermediates
TOL_K6_FP32 = 2e-5
TOL_K6_BF16 = 1e-2
# fused_hat_block_dp's gradients through the recompute backward (K1 + K2)
# against autograd through the plain version, relative to each tensor's
# largest entry: f32 (dbias and the weights' gradients sum over 54,272
# tokens in another order), and bf16 (the same roundings but for the
# attention's, which K2 keeps in f32)
TOL_K6_GRAD_FP32 = 1e-4
TOL_K6_GRAD_BF16 = 5e-2
# The long-window attention probes' kernels P1 (chunked online softmax) and
# P2 (no bias), (B, S, heads, head_dim): the probes' call, 21k-768 level 2
# (timed); 21k-768 level 3; S past one tile and past the probe's S that 4
# divides and 64 does not (P1), that 2 does not divide (P2); hd 128; an
# empty batch. P1 runs at every chunk count C that divides S.
PROBE_SHAPE = (16, 2304, 16, 49)
P1_SHAPES = [PROBE_SHAPE, (16, 576, 32, 49), (2, 132, 2, 49),
             (2, 2308, 2, 49), (2, 2304, 2, 128), (0, 2304, 2, 49)]
P2_SHAPES = [PROBE_SHAPE, (16, 576, 32, 49), (2, 129, 2, 49),
             (2, 2305, 2, 49), (2, 2304, 2, 128), (0, 2304, 2, 49)]
PROBE_CHUNKS = (1, 2, 4)
# P1, P2 against their plain versions on the same inputs: f32 with TF32 off
# (TOL_FP32: only the order of the sums differs); bf16 outputs from the
# same roundings, where the order of the f32 sums can move p's or the
# output's rounding by one bf16 step, at most 2^-7 of the output. So a bf16
# call is held to TOL_PROBE_BF16_REL of its largest plain output, and never
# to more than TOL_PROBE_BF16 (one step on outputs up to 2).
TOL_PROBE_BF16 = 1e-2
TOL_PROBE_BF16_REL = 2.0 ** -7
# The MSDA gather probes' kernels P3a-c and P4a, (Hp, Wp, QP, M, D):
# MOTR's padded levels at the probes' full QP (levels 0 and 3 timed), then
# a 3x3 map, QP 4 and 4,004, one head, D 64, and QP 0; each at P 1, 2, 4
# (P3b, P4a) and with some of its samples out of range.
GATHER_LEVELS = ((202, 386), (102, 194), (52, 98), (27, 50))
GATHER_SHAPES = ([(hp, wp, 408_000, 8, 32) for hp, wp in GATHER_LEVELS]
                 + [(3, 3, 4_004, 8, 32), (27, 50, 4, 8, 32),
                    (27, 50, 4_004, 1, 32), (52, 98, 4_004, 2, 64),
                    (27, 50, 0, 8, 32)])
GATHER_TIMED = (0, 3)   # the indices of the timed levels
GATHER_POINTS = (1, 2, 4)
# The kernels repeat their plain versions' f32 roundings in the same order
# (every product and sum rounded alone, a bf16 map widened exactly): held
# to TOL_GATHER, and NaN at the same places
TOL_GATHER = 1e-6
# Plans the C entry points of P3a-c and P4a-c must refuse: (kernel,
# (Hp, Wp, D, map dtype, the map's element offset), ProbePlan fields, what
# is wrong)
PROBE_WRONG_PLANS = [
    ("P3b", (27, 50, 32, torch.float32, 1), (8, 4, 4, 4, 8, 528, "l2"),
     "16-byte loads from a 4-byte-aligned map"),
    ("P4b", (27, 50, 20, torch.bfloat16, 0), (4, 8, 8, 8, 8, 528, "l2"),
     "V 8 on D 20, which it does not divide"),
    ("P3b", (202, 386, 32, torch.float32, 0), (8, 4, 4, 4, 32, 132, "smem"),
     "route smem for a 10 MB map"),
    ("P3a", (27, 50, 32, torch.float32, 0), (8, 4, 4, 4, 33, 132, "l2"),
     "33 warps a block, past kMaxWarps"),
    ("P4a", (27, 50, 32, torch.float32, 0), (8, 4, 4, 4, 32, 132, "smem"),
     "route smem in packed mode"),
    ("P4c", (27, 50, 32, torch.bfloat16, 0), (4, 8, 8, 8, 32, 132, "smem"),
     "route smem in coeff mode"),
    ("P4c", (27, 50, 32, torch.float32, 1), (8, 4, 4, 4, 8, 528, "l2"),
     "16-byte loads from a 4-byte-aligned coeff map"),
]
REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def in_turns(plain, kernel, library, iters: int = 30):
    """Times of plain, kernel and library call, taken in turns (plain,
    kernel, library, library, kernel, plain), each averaged over its two.
    A function given as None is not timed, and its time is None."""
    return tuple(probes.in_turns({"plain": plain, "kernel": kernel,
                                  "library": library}, iters).values())


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes moved over the memory rate
    or operations over the bf16 peak, whichever is larger."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def split_heads(qkv: torch.Tensor, heads: int):
    """(B, S, 3C) -> contiguous q, k, v of (B, H, S, hd), for SDPA."""
    b, s, c3 = qkv.shape
    return [t.contiguous() for t in qkv.reshape(
        b, s, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)]


def ptxas_summary(log: str) -> dict:
    """{kernel: (most registers, most spill-store bytes)} over the
    instantiations that nvcc's -Xptxas -v log reports."""
    out, kernel = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = re.findall(r"\d+([a-z_]+_kernel)", entry.group(1))[-1]
            out.setdefault(kernel, (0, 0))
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if kernel and (regs or spill):
            r, sp = out[kernel]
            out[kernel] = (max(r, int(regs.group(1))) if regs else r,
                           max(sp, int(spill.group(1))) if spill else sp)
    return out


def ptxas_entries(log: str, describe) -> list:
    """[{..., registers, spill_stores, static_smem}] for each entry function
    of nvcc's -Xptxas -v log that describe(mangled name) returns a dict of
    its own keys for (and None for the rest)."""
    out, cur = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = describe(entry.group(1))
            if cur is not None:
                cur.update(registers=0, spill_stores=0, static_smem=0)
                out.append(cur)
            continue
        if cur is None:
            continue
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        smem = re.search(r"(\d+) bytes smem", line)
        if regs:
            cur["registers"] = int(regs.group(1))
        if spill:
            cur["spill_stores"] = int(spill.group(1))
        if smem:
            cur["static_smem"] = int(smem.group(1))
    return out


def ptxas_instances(log: str, kernel: str, cuda_attention) -> list:
    """[{instance, registers, spill_stores, static_smem, plan_smem}] for
    each instantiation of the kernel template `kernel` (a tensor-core
    route one: window_mhsa_long_tc_kernel or attn_online_tc_kernel) that
    nvcc's -Xptxas -v log reports; the instance names its bias type,
    whether the bias is read, the padded head dim D and the load width.
    Its dynamic shared memory, which ptxas does not see, is its plan's
    (long_plan)."""
    def describe(name):
        if kernel + "I" not in name:
            return None
        args = name.split(kernel + "I", 1)[1]
        tb = "bf16" if args.startswith("13__nv_bfloat16") else "f32"
        ints = re.findall(r"Li(\d+)E", args)
        read = "Lb0" not in args
        bias = (torch.bfloat16 if tb == "bf16" else torch.float32
                ) if read else None
        return {"instance": (f"bias {tb}" if read else "no bias")
                + f", D {ints[0]}, {2 * int(ints[1])}-byte loads",
                "plan_smem": cuda_attention.long_plan(
                    int(ints[0]), torch.bfloat16, bias).smem_bytes}

    return ptxas_entries(log, describe)


def ptxas_k5_instances(log: str) -> dict:
    """{instance: {registers, spill_stores, static_smem}} for each
    msda_fwd_kernel<T, V, G, NV> that nvcc's -Xptxas -v log reports, each
    printed."""
    def describe(name):
        args = re.search(r"msda_fwd_kernelI(f|13__nv_bfloat16)"
                         r"Li(\d+)ELi(\d+)ELi(\d+)E", name)
        if args is None:
            return None
        return {"instance": f"<{'float' if args[1] == 'f' else 'bf16'}, "
                            f"V {args[2]}, G {args[3]}, NV {args[4]}>"}

    out = {}
    for i in ptxas_entries(log, describe):
        name = i.pop("instance")
        out[name] = i
        print(f"  ptxas: msda_fwd_kernel{name}: {i['registers']} registers, "
              f"{i['spill_stores']} bytes of spill stores")
    return out


def ptxas_probe_instances(log: str) -> dict:
    """{instance: {registers, spill_stores, static_smem}} for each
    msda_probe_vec_kernel<P, mode, T, V, NV, smem> (P3a-c, P4a, P4b, P4c)
    that nvcc's -Xptxas -v log reports, each printed."""
    def describe(name):
        args = re.search(r"msda_probe_vec_kernelILi(\d)ELNS_4ModeE(\d)E"
                         r"(f|13__nv_bfloat16)Li(\d)ELi(\d)ELb(\d)E", name)
        if args is None:
            return None
        return {"instance": f"<P {args[1]}, "
                            f"{('pair', 'packed', 'coeff')[int(args[2])]}, "
                            f"{'float' if args[3] == 'f' else 'bf16'}, "
                            f"V {args[4]}, NV {args[5]}, "
                            f"{('l2', 'smem')[int(args[6])]}>"}

    out = {}
    for i in ptxas_entries(log, describe):
        name = i.pop("instance")
        out[name] = i
        print(f"  ptxas: msda_probe_vec_kernel{name}: {i['registers']} "
              f"registers, {i['spill_stores']} bytes of spill stores")
    return out


def print_instances(what: str, instances: list) -> None:
    for i in instances:
        print(f"  ptxas: {what} <{i['instance']}>: {i['registers']} "
              f"registers, {i['spill_stores']} bytes of spill stores, "
              f"{i['static_smem']} bytes of static shared memory; "
              f"{i['plan_smem']} bytes of dynamic shared memory (its plan)")


def check_plan(kernel, cuda_attention, bf16: bool, head_dim: int,
               bias_dtype=None, what: str = "") -> None:
    """The wrapper's latest launch took the route its dtype names (bf16:
    the tensor cores, f32: scalar FMA), by long_plan, whose shared memory
    is the library's own figure."""
    plan = kernel.last_plan
    want = "wgmma" if bf16 else "scalar"
    check(plan is not None and plan.route == want,
          f"{what} ran route {plan and plan.route}, expected {want}")
    bias_bytes = 0 if bias_dtype is None else bias_dtype.itemsize
    lib = cuda_attention._library().long_attention_smem_bytes(
        head_dim, int(bf16), bias_bytes)
    check(plan.smem_bytes == lib, f"{what}: the plan's {plan.smem_bytes} "
                                  f"bytes of shared memory, the library's "
                                  f"{lib}")


def check_bwd_plan(cuda_attention, bf16: bool, head_dim: int,
                   bias_dtype=None, what: str = "") -> None:
    """K4's latest launch took the route its dtype names (bf16: the tensor
    cores, f32: scalar FMA), by long_bwd_plan for its bias dtype (either,
    where the caller does not know it), each pass's shared memory the
    library's own figure."""
    plan = cuda_attention.window_mhsa_long_backward_cuda.last_plan
    want = "wgmma" if bf16 else "scalar"
    check(plan is not None and plan.route == want,
          f"{what}: K4 ran route {plan and plan.route}, expected {want}")
    dtype = torch.bfloat16 if bf16 else torch.float32
    biases = ([bias_dtype] if bias_dtype is not None
              else [torch.float32, torch.bfloat16])
    lib = cuda_attention._library().long_attention_bwd_smem_bytes
    check(any(plan == cuda_attention.long_bwd_plan(head_dim, dtype, b)
              and plan.smem_bytes == tuple(
                  lib(head_dim, int(bf16), b.itemsize, p) for p in range(3))
              for b in biases),
          f"{what}: K4's plan {plan} is not long_bwd_plan's for hd "
          f"{head_dim} with the library's shared memory")


class RouteLog:
    """Inside `with RouteLog(cuda_attention) as routes:`, the routes of the
    plans K1 and K2 are launched with, counted: routes.k1 and routes.k2
    are Counters of "wgmma" and "scalar". short_plan and short_bwd_plan
    are wrapped for the block's duration; each wrapper makes its plan
    just before its launch, and the C entry point refuses any other."""

    def __init__(self, cuda_attention):
        self.ca = cuda_attention

    def __enter__(self):
        self.k1, self.k2 = collections.Counter(), collections.Counter()
        self.orig = (self.ca.short_plan, self.ca.short_bwd_plan)

        def counted(fn, counter):
            def plan(*args):
                how = fn(*args)
                counter[how.route] += 1
                return how
            return plan

        self.ca.short_plan = counted(self.orig[0], self.k1)
        self.ca.short_bwd_plan = counted(self.orig[1], self.k2)
        return self

    def __exit__(self, *exc):
        self.ca.short_plan, self.ca.short_bwd_plan = self.orig

    def check(self, k1: int, k2: int, route: str, what: str) -> None:
        """k1 K1 and k2 K2 launches, every one on `route`."""
        want = (collections.Counter({route: k1} if k1 else {}),
                collections.Counter({route: k2} if k2 else {}))
        check((self.k1, self.k2) == want,
              f"{what}: K1 routes {dict(self.k1)}, K2 routes "
              f"{dict(self.k2)}, expected {k1} and {k2} on {route}")
        print(f"{what}: K1 {dict(self.k1)}, K2 {dict(self.k2)} launches by "
              f"route")


class K5Plans:
    """Inside `with K5Plans(cuda_msda) as plans:`, each K5 launch's plan,
    read from last_plan just after the launch, is counted in plans.count
    by (dtype, plan). ms_deform_attn_cuda is wrapped for the block's
    duration (its launches and last_plan read and written through to it);
    the model, and the wrapper itself, look it up at each call."""

    def __init__(self, cuda_msda):
        self.cm = cuda_msda

    def __enter__(self):
        self.count = collections.Counter()
        orig, count = self.cm.ms_deform_attn_cuda, self.count
        self.orig = orig

        class Counted:
            launches = property(
                lambda _: orig.launches,
                lambda _, n: setattr(orig, "launches", n))
            last_plan = property(
                lambda _: orig.last_plan,
                lambda _, plan: setattr(orig, "last_plan", plan))

            def __call__(self, value, *args):
                before = orig.launches
                out = orig(value, *args)
                if orig.launches > before:
                    count[(str(value.dtype).split(".")[-1],
                           orig.last_plan)] += 1
                return out

        self.cm.ms_deform_attn_cuda = Counted()
        return self

    def __exit__(self, *exc):
        self.cm.ms_deform_attn_cuda = self.orig

    def check(self, launches: int, what: str, vector: bool = False) -> None:
        """At least `launches` K5 launches in the block and, where `vector`,
        every bf16 one on vector loads (V > 1)."""
        total = sum(self.count.values())
        scalar = sum(n for (dtype, plan), n in self.count.items()
                     if dtype == "bfloat16" and plan.vec == 1)
        print(f"{what}: {total} K5 launches by plan: "
              + "; ".join(f"{n} {dtype} at {plan._asdict()}"
                          for (dtype, plan), n in self.count.items()))
        check(total >= launches, f"{what}: {total} K5 launches, expected "
                                 f"at least {launches}")
        check(not (vector and scalar), f"{what}: {scalar} bf16 K5 launches "
                                       "on scalar loads (V 1)")


def check_short_plan(kernel, cuda_attention, bf16: bool, seq: int,
                     head_dim: int, bias_dtype, backward: bool,
                     what: str) -> None:
    """K1's or K2's latest launch took the route its dtype names (bf16: the
    tensor cores, f32: scalar FMA), by short_plan or short_bwd_plan, whose
    shared memory is the library's own figure."""
    plan = kernel.last_plan
    want = "wgmma" if bf16 else "scalar"
    dtype = torch.bfloat16 if bf16 else torch.float32
    make = (cuda_attention.short_bwd_plan if backward
            else cuda_attention.short_plan)
    check(plan is not None and plan.route == want
          and plan == make(seq, head_dim, dtype, bias_dtype),
          f"{what} ran plan {plan}, expected route {want}")
    lib = cuda_attention._library()
    smem = (lib.short_attention_bwd_smem_bytes if backward
            else lib.short_attention_smem_bytes)(seq, head_dim, int(bf16))
    check(plan.smem_bytes == smem, f"{what}: the plan's {plan.smem_bytes} "
                                   f"bytes of shared memory, the library's "
                                   f"{smem}")


def ptxas_short_instances(log: str, cuda_attention) -> list:
    """[{instance, registers, spill_stores, static_smem, plan_smem}] for
    each tensor-core instantiation of K1 (window_mhsa_tc_kernel<D, key
    tiles>) and K2 (window_mhsa_bwd_tc_kernel<D>) that nvcc's -Xptxas -v
    log reports; plan_smem is the dynamic shared memory of its plan, which
    ptxas does not see."""
    def describe(name):
        kind = re.search(r"(window_mhsa_bwd_tc_kernel|window_mhsa_tc_kernel)"
                         r"I(.*)", name)
        if not kind:
            return None
        ints = [int(x) for x in re.findall(r"Li(\d+)E", kind.group(2))]
        if kind.group(1) == "window_mhsa_tc_kernel":
            d, r = ints[:2]
            plan = cuda_attention.short_plan(64 * r, d, torch.bfloat16,
                                             torch.float32)
            return {"instance": f"K1, D {d}, {r} key tile"
                                + "s" * (r > 1), "plan_smem": plan.smem_bytes}
        plan = cuda_attention.short_bwd_plan(64, ints[0], torch.bfloat16,
                                             torch.float32)
        return {"instance": f"K2, D {ints[0]}", "plan_smem": plan.smem_bytes}

    return ptxas_entries(log, describe)


def ptxas_k4_instances(log: str, cuda_attention) -> list:
    """[{instance, registers, spill_stores, static_smem, plan_smem}] for
    each tensor-core instantiation of K4's three passes
    (long_bwd_{stats,dq,dkv}_tc_kernel<TB, D, kVec>) that nvcc's -Xptxas
    -v log reports; plan_smem is the dynamic shared memory long_bwd_plan
    names for the pass, which ptxas does not see."""
    passes = ("stats", "dq", "dkv")

    def describe(name):
        kind = re.search(r"long_bwd_(stats|dq|dkv)_tc_kernelI(.*)", name)
        if not kind:
            return None
        args = kind.group(2)
        bias = (torch.bfloat16 if args.startswith("13__nv_bfloat16")
                else torch.float32)
        d, vec = (int(x) for x in re.findall(r"Li(\d+)E", args)[:2])
        plan = cuda_attention.long_bwd_plan(d, torch.bfloat16, bias)
        p = passes.index(kind.group(1))
        return {"instance": f"{kind.group(1)}, bias "
                            f"{'bf16' if bias.itemsize == 2 else 'f32'}, "
                            f"D {d}, {2 * vec}-byte loads, "
                            f"{plan.stages[p]} stage"
                            + "s" * (plan.stages[p] > 1),
                "plan_smem": plan.smem_bytes[p]}

    return ptxas_entries(log, describe)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


def rel_to_largest(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over the largest |want| (an all-zero want counts as
    1e-6)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-6)).item()


def k1_phase(cuda_attention, attention, ptx_log: str) -> dict:
    kernel = cuda_attention.window_mhsa_cuda
    instances = [i for i in ptxas_short_instances(ptx_log, cuda_attention)
                 if i["instance"].startswith("K1")]
    print_instances("K1 window_mhsa_tc_kernel", instances)
    check(len(instances) == 4, f"K1's tensor-core instances {instances}")
    plain = attention.window_mhsa_reference
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    err32_all, err16_all = 0.0, 0.0
    ms_fwd = plain_ms_fwd = lib_ms_fwd = bound_fwd = 0.0
    backend = ""
    plans, per_call = {}, {}
    for b, s, h, d, calls in FV0_SHAPES + [ODD_SHAPE]:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        bias = torch.randn(h, s, s, device="cuda", generator=gen)
        scale = d ** -0.5
        what = f"K1 window_mhsa B={b} S={s} H={h} hd={d}"
        err32 = (kernel(qkv, bias, h, scale)
                 - plain(qkv, bias, h, scale)).abs().max().item()
        check_short_plan(kernel, cuda_attention, False, s, d, torch.float32,
                         False, f"{what} fp32")
        plan32 = kernel.last_plan
        q16, b16 = qkv.bfloat16(), bias.bfloat16()
        got16 = kernel(q16, b16, h, scale)
        check_short_plan(kernel, cuda_attention, True, s, d, torch.bfloat16,
                         False, f"{what} bf16")
        plan16 = kernel.last_plan
        same = torch.equal(got16, kernel(q16, b16, h, scale))
        err16 = (got16.float()
                 - plain(q16.float(), b16.float(), h, scale)).abs().max().item()
        torch.cuda.synchronize()
        print(f"{what}: max|err| fp32 {err32:.3e} (tol {TOL_FP32}), bf16 "
              f"{err16:.3e} (tol {TOL_BF16}); two bf16 launches "
              f"bit-identical: {same}; plans fp32 {tuple(plan32)}, bf16 "
              f"{tuple(plan16)}")
        check(err32 <= TOL_FP32, f"fp32 kernel error {err32} at {(b, s, h, d)}")
        check(err16 <= TOL_BF16, f"bf16 kernel error {err16} at {(b, s, h, d)}")
        check(same, f"K1 bf16 launches differ at {(b, s, h, d)}")
        err32_all, err16_all = max(err32_all, err32), max(err16_all, err16)
        plans[f"({b},{s},{h},{d})"] = {"fp32": plan32._asdict(),
                                       "bf16": plan16._asdict()}
        if calls:
            # the main path's dtype, in turns
            q, k, v = split_heads(q16, h)
            mask = b16[None]
            run_l = lambda: sdpa(q, k, v, attn_mask=mask, scale=scale)
            backend = sdpa_backend(run_l)
            plain_ms, ms, lib_ms = in_turns(
                lambda: plain(q16, b16, h, scale),
                lambda: kernel(q16, b16, h, scale), run_l)
            nbytes = 2 * (qkv.numel() + b * s * h * d + bias.numel())
            flops = 4.0 * b * h * s * s * d
            bound = bound_ms(nbytes, flops)
            ms_fwd += calls * ms
            plain_ms_fwd += calls * plain_ms
            lib_ms_fwd += calls * lib_ms
            bound_fwd += calls * bound
            per_call[f"({b},{s},{h},{d})"] = {
                "calls": calls, "ms": ms, "tflop_s": flops / ms / 1e9,
                "gb_s": nbytes / ms / 1e6, "bound_ms": bound}
            print(f"{what} bf16: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s), plain "
                  f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB) per call")
    print(f"SDPA forward with a float mask ran: {backend}")
    print(f"K1 window_mhsa over one fv0 bf16 b{BATCH} forward's 17 calls: "
          f"kernel {ms_fwd:.4f} ms, plain {plain_ms_fwd:.4f} ms, SDPA "
          f"{lib_ms_fwd:.4f} ms, bound {bound_fwd:.4f} ms")
    # ms, plain_ms, library_ms, bound_ms: sums over one FasterViT-0 bf16
    # b256 forward's calls
    return {"name": "window_mhsa", "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/window_mhsa.cu",
            "replaces": "fastervit_tpu/ops/pallas_attention.py:103",
            "launches": None, "max_abs_err": err16_all,
            "max_abs_err_fp32": err32_all,
            "ms": ms_fwd, "plain_ms": plain_ms_fwd, "bound_ms": bound_fwd,
            "bound_by": "bytes", "library_ms": lib_ms_fwd,
            "library": f"scaled_dot_product_attention ({backend})",
            "per": f"one fv0 bf16 b{BATCH} forward (17 calls)",
            "per_call": per_call, "plans": plans, "ptxas": instances}


def k2_phase(cuda_attention, attention, ptx_log: str) -> dict:
    kernel = cuda_attention.window_mhsa_backward_cuda
    instances = [i for i in ptxas_short_instances(ptx_log, cuda_attention)
                 if i["instance"].startswith("K2")]
    print_instances("K2 window_mhsa_bwd_tc_kernel", instances)
    check(len(instances) == 2, f"K2's tensor-core instances {instances}")
    plain = attention.window_mhsa_backward_reference
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    err32_all = err16_all = 0.0
    ms_step = plain_step = lib_step = bound_step = 0.0
    backend = ""
    plans, per_call = {}, {}
    for b, s, h, d, calls in TRAIN_SHAPES + K2_EXTRA_SHAPES:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        bias = torch.randn(h, s, s, device="cuda", generator=gen)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen)
        scale = d ** -0.5
        what = f"K2 window_mhsa_backward B={b} S={s} H={h} hd={d}"
        got = kernel(qkv, bias, g, h, scale)
        check_short_plan(kernel, cuda_attention, False, s, d, torch.float32,
                         True, f"{what} fp32")
        plan32 = kernel.last_plan
        want = plain(qkv, bias, g, h, scale)
        err32 = max(rel_err(got[0], want[0]), rel_err(got[1], want[1]))
        q16, b16, g16 = qkv.bfloat16(), bias.bfloat16(), g.bfloat16()
        got = kernel(q16, b16, g16, h, scale)
        check_short_plan(kernel, cuda_attention, True, s, d, torch.bfloat16,
                         True, f"{what} bf16")
        plan16 = kernel.last_plan
        again = kernel(q16, b16, g16, h, scale)
        same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        want = plain(q16.float(), b16.float(), g16.float(), h, scale)
        err16 = max(rel_err(got[0], want[0]), rel_err(got[1], want[1]))
        torch.cuda.synchronize()
        print(f"{what}: max|err| / max(1, max|plain|) of dqkv and dbias: fp32 "
              f"{err32:.3e} (tol {TOL_K2_FP32}), bf16 {err16:.3e} (tol "
              f"{TOL_K2_BF16}); two bf16 launches bit-identical: {same}; "
              f"plans fp32 {tuple(plan32)}, bf16 {tuple(plan16)}")
        check(err32 <= TOL_K2_FP32, f"K2 fp32 error {err32} at {(b, s, h, d)}")
        check(err16 <= TOL_K2_BF16, f"K2 bf16 error {err16} at {(b, s, h, d)}")
        check(same, f"K2 bf16 launches differ at {(b, s, h, d)}")
        err32_all, err16_all = max(err32_all, err32), max(err16_all, err16)
        plans[f"({b},{s},{h},{d})"] = {"fp32": plan32._asdict(),
                                       "bf16": plan16._asdict()}
        if calls:
            q, k, v = (t.requires_grad_() for t in split_heads(q16, h))
            mask = b16[None].clone().requires_grad_()
            out = sdpa(q, k, v, attn_mask=mask, scale=scale)
            g4 = g16.reshape(b, s, h, d).transpose(1, 2).contiguous()
            run_l = lambda: torch.autograd.grad(out, (q, k, v, mask), g4,
                                                retain_graph=True)
            backend = sdpa_backend(run_l)
            plain_ms, ms, lib_ms = in_turns(
                lambda: plain(q16, b16, g16, h, scale),
                lambda: kernel(q16, b16, g16, h, scale), run_l)
            del out
            # qkv and g read, dqkv written, bias read, dbias written (bf16)
            nbytes = 2 * (2 * qkv.numel() + g.numel() + 2 * bias.numel())
            flops = 10.0 * b * h * s * s * d
            bound = bound_ms(nbytes, flops)
            ms_step += calls * ms
            plain_step += calls * plain_ms
            lib_step += calls * lib_ms
            bound_step += calls * bound
            per_call[f"({b},{s},{h},{d})"] = {
                "calls": calls, "ms": ms, "tflop_s": flops / ms / 1e9,
                "gb_s": nbytes / ms / 1e6, "bound_ms": bound}
            print(f"{what} bf16: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s), plain "
                  f"{plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB) per call")
    print(f"SDPA backward with a float mask that needs its gradient ran: "
          f"{backend}")
    print(f"K2 window_mhsa_backward over one fv0 bf16 b{TRAIN_BATCH} train "
          f"step's 17 calls: kernel {ms_step:.4f} ms, plain "
          f"{plain_step:.4f} ms, SDPA backward {lib_step:.4f} ms, bound "
          f"{bound_step:.4f} ms")
    return {"name": "window_mhsa_backward", "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/window_mhsa_bwd.cu",
            "replaces": "fastervit_tpu/ops/pallas_attention.py:249",
            "launches": None, "max_abs_err": err16_all,
            "max_abs_err_fp32": err32_all,
            "err_is": "max |err| / max(1, max |plain|) of dqkv and dbias",
            "ms": ms_step, "plain_ms": plain_step, "bound_ms": bound_step,
            "bound_by": "bytes", "library_ms": lib_step,
            "library": f"scaled_dot_product_attention backward ({backend})",
            "per": f"one fv0 bf16 b{TRAIN_BATCH} train step (17 calls)",
            "per_call": per_call, "plans": plans, "ptxas": instances}


def k3_phase(cuda_attention, attention, ptx_log: str) -> dict:
    kernel = cuda_attention.window_mhsa_long_cuda
    instances = [i for i in ptxas_instances(
        ptx_log, "window_mhsa_long_tc_kernel", cuda_attention)
                 if i["instance"].startswith("bias")]
    print_instances("K3 window_mhsa_long_tc_kernel", instances)
    plain = attention.window_mhsa_long_reference
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(10)
    err32_all = err16_all = 0.0
    ms_fwd = plain_fwd = lib_fwd = bound_fwd = 0.0
    per_call = {}
    backend = ""
    for b, s, h, d, calls, iters in ([t + (0, 0) for t in K3_EXTRA_SHAPES]
                                     + K3_21K768_SHAPES + K3_21K384_SHAPES):
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        bias = torch.randn(h, s, s, device="cuda", generator=gen)
        scale = d ** -0.5
        before = kernel.launches
        err32 = 0.0
        if b:
            err32 = (kernel(qkv, bias, h, scale)
                     - plain(qkv, bias, h, scale)).abs().max().item()
            check_plan(kernel, cuda_attention, False, d, bias.dtype,
                       f"K3 fp32 at {(b, s, h, d)}")
        q16 = qkv.bfloat16()
        err16 = 0.0
        for bias_in in (bias, bias.bfloat16()):
            if b:
                err16 = max(err16, (kernel(q16, bias_in, h, scale).float()
                                    - plain(q16.float(), bias_in.float(), h,
                                            scale)).abs().max().item())
                check_plan(kernel, cuda_attention, True, d, bias_in.dtype,
                           f"K3 bf16 at {(b, s, h, d)}")
            else:
                check(kernel(q16, bias_in, h, scale).shape == (0, s, h * d),
                      "K3 output of an empty batch")
        torch.cuda.synchronize()
        if not b:
            check(kernel.launches == before, "K3 launched on an empty batch")
        print(f"K3 window_mhsa_long B={b} S={s} H={h} hd={d}: max|err| fp32 "
              f"{err32:.3e} (tol {TOL_FP32}, scalar FMA), bf16 with f32 and "
              f"bf16 bias {err16:.3e} (tol {TOL_BF16}, wgmma, D "
              f"{cuda_attention.long_plan(d, torch.bfloat16).qk_depth})")
        check(err32 <= TOL_FP32, f"K3 fp32 error {err32} at {(b, s, h, d)}")
        check(err16 <= TOL_BF16, f"K3 bf16 error {err16} at {(b, s, h, d)}")
        err32_all, err16_all = max(err32_all, err32), max(err16_all, err16)
        if not iters:
            continue
        # the serving path's dtypes (bf16 qkv and bias), in turns; SDPA on
        # the same q, k, v and bias as a float mask, zero-padded to a head
        # dim of 56 if hd 49 would leave it the math backend (the padding
        # adds zero terms to q kᵀ and zero output columns: the same function)
        b16 = bias.bfloat16()
        del bias, qkv
        q, k, v = split_heads(q16, h)
        mask = b16[None]
        run_l = lambda: sdpa(q, k, v, attn_mask=mask, scale=scale)
        native = sdpa_backend(run_l)
        if "math" in native and d % 8:
            pad = (0, (-d) % 8)
            q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
            run_l = lambda: sdpa(q, k, v, attn_mask=mask, scale=scale)[
                ..., :d]
        backend = sdpa_backend(run_l)
        if backend != native:
            backend = (f"{backend}, with q, k, v zero-padded from hd {d} to "
                       f"{q.shape[-1]}; at hd {d} it ran {native}")
        plain_ms, ms, lib_ms = in_turns(
            lambda: plain(q16, b16, h, scale),
            lambda: kernel(q16, b16, h, scale), run_l, iters)
        del q, k, v, run_l
        nbytes = 2 * (q16.numel() + b * s * h * d + b16.numel())
        flops = 4.0 * b * h * s * s * d
        bound = bound_ms(nbytes, flops)
        check_plan(kernel, cuda_attention, True, d, b16.dtype,
                   f"K3 timed at {(b, s, h, d)}")
        per_call[f"({b},{s},{h},{d})"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": ("operations" if flops
                                            / BF16_FLOP_PER_S > nbytes
                                            / HBM_BYTES_PER_S else "bytes"),
            "tflop_s": flops / ms / 1e9, "route": kernel.last_plan.route}
        if calls:
            ms_fwd += calls * ms
            plain_fwd += calls * plain_ms
            lib_fwd += calls * lib_ms
            bound_fwd += calls * bound
        print(f"K3 window_mhsa_long B={b} S={s} H={h} hd={d} bf16: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bound:.4f} "
              f"ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP) per "
              f"call; SDPA ran {backend}")
        del q16, b16, mask
    print(f"K3 window_mhsa_long over one faster_vit_4_21k_768 bf16 "
          f"b{SERVE_BATCH} forward's 17 calls: kernel {ms_fwd:.4f} ms, plain "
          f"{plain_fwd:.4f} ms, SDPA {lib_fwd:.4f} ms, bound {bound_fwd:.4f} "
          f"ms [{card()}]")
    return {"name": "window_mhsa_long", "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/window_mhsa_long.cu",
            "replaces": "fastervit_tpu/ops/pallas_flash_attention.py:199",
            "launches": None, "max_abs_err": err16_all,
            "max_abs_err_fp32": err32_all,
            "kernel_route": {"bf16": "wgmma", "f32": "scalar"},
            "ptxas": instances,
            "ms": ms_fwd, "plain_ms": plain_fwd, "bound_ms": bound_fwd,
            "bound_by": "operations", "library_ms": lib_fwd,
            "library": f"scaled_dot_product_attention ({backend})",
            "per": f"one faster_vit_4_21k_768 bf16 b{SERVE_BATCH} forward "
                   "(17 calls: 12 at level 2, operations-bound; 5 at level "
                   "3, bytes-bound)",
            "per_call": per_call}


def launches(cuda_attention):
    """Launches so far of K1, K2, K3 and K4."""
    return (cuda_attention.window_mhsa_cuda.launches,
            cuda_attention.window_mhsa_backward_cuda.launches,
            cuda_attention.window_mhsa_long_cuda.launches,
            cuda_attention.window_mhsa_long_backward_cuda.launches)


def detection_launches(cuda_attention, cuda_msda):
    """Launches so far of K1, K3 and K5, the kernels of the detector's
    forward."""
    return (cuda_attention.window_mhsa_cuda.launches,
            cuda_attention.window_mhsa_long_cuda.launches,
            cuda_msda.ms_deform_attn_cuda.launches)


def reset_launches(cuda_attention, cuda_msda=None) -> None:
    """Every kernel's count to 0 (K5's too, given cuda_msda)."""
    cuda_attention.window_mhsa_cuda.launches = 0
    cuda_attention.window_mhsa_backward_cuda.launches = 0
    cuda_attention.window_mhsa_long_cuda.launches = 0
    cuda_attention.window_mhsa_long_backward_cuda.launches = 0
    if cuda_msda is not None:
        cuda_msda.ms_deform_attn_cuda.launches = 0


def synthetic_batch(batch: int, seed: int, size=(224, 224)) -> dict:
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(batch, *size, 3).astype(np.float32),
            "label": rng.randint(0, 1000, batch).astype(np.int32)}


def relu_inputs(model) -> list:
    """Hooks that keep the inputs of the stem's ReLUs, one list per call
    of the model; returns the list they fill."""
    seen = []
    for m in model.patch_embed.conv_down:
        if isinstance(m, torch.nn.ReLU):
            m.register_forward_hook(
                lambda mod, args, out: seen.append(args[0].detach().cpu()))
    return seen


def train_parity_phase(fvt, cuda_attention, steps,
                       name: str = "faster_vit_0_224", batch_size: int = 4,
                       want=(17, 17, 0, 0), stem_tol: float = 0.0) -> None:
    """One fp32 step of `name`, card against CPU, on the same weights and
    batch; `want` are its K1, K2, K3 and K4 launches, K1's and K2's on
    scalar FMA. With stem_tol, and
    only if a ReLU input of the stem flipped, the stem's parameters are
    held to stem_tol of their largest entry (see TOL_STEM_GRAD) and the
    others to phase 7's bound."""
    t0 = time.perf_counter()
    model_cpu = fvt.create_model(name, device="cpu", drop_path_rate=0.0,
                                 generator=torch.Generator().manual_seed(3))
    model = copy.deepcopy(model_cpu).to("cuda")
    cfg = steps.TrainConfig()   # the fv0 recipe: mixup, adamw, clip, EMA
    batch = synthetic_batch(batch_size, 4, model.cfg.resolution)
    metrics = {}
    relus = {m: relu_inputs(m) for m in (model_cpu, model)}
    for m in (model_cpu, model):
        step = steps.make_train_step(cfg, lambda t: 1e-3, seed=5)
        before = launches(cuda_attention)
        with RouteLog(cuda_attention) as routes:
            metrics[m] = step(steps.create_train_state(m, cfg), batch)
            torch.cuda.synchronize()
        calls = tuple(a - b for a, b in zip(launches(cuda_attention), before))
    check(calls == tuple(want), f"{name} K1, K2, K3, K4 launches per step "
                                f"{calls}, expected {tuple(want)}")
    routes.check(want[0], want[1], "scalar", f"{name} fp32 train step")
    dloss = abs(metrics[model]["loss"].item()
                - metrics[model_cpu]["loss"].item())
    grads_cpu = dict(model_cpu.named_parameters())
    floor = 1e-5 * max(p.grad.abs().max().item() for p in grads_cpu.values())
    worst, worst_name = 0.0, ""
    flips = sum(int(((a > 0) != (b > 0)).sum())
                for a, b in zip(relus[model_cpu], relus[model]))
    stem_errs = []
    for pname, p in model.named_parameters():
        ref = grads_cpu[pname].grad
        err = (p.grad.cpu() - ref).abs().max().item()
        bound = max(TOL_STEP_GRAD * ref.abs().max().item(), floor)
        if stem_tol and flips and pname.startswith("patch_embed."):
            rel = err / ref.abs().max().item()
            stem_errs.append(f"{pname} {rel:.2e}")
            check(rel <= stem_tol, f"gradient of {pname}: card vs CPU "
                                   f"{rel} of its largest entry > {stem_tol}")
            continue
        check(err <= bound,
              f"gradient of {pname}: card vs CPU {err} > {bound}")
        if err / bound > worst:
            worst, worst_name = err / bound, pname
        if ".qkv." in pname or ".pos_emb_funct.cpb_mlp." in pname:
            check(bool(p.grad.abs().sum() > 0), f"zero gradient at {pname}")
    print(f"{name} fp32 train step b{batch_size}, card vs CPU: |dloss| "
          f"{dloss:.3e} (tol {TOL_STEP_LOSS}); every gradient within "
          f"{TOL_STEP_GRAD} of its tensor's largest entry (worst "
          f"{worst:.3f} of the bound, at {worst_name})"
          + (f" outside the stem; the stem's, relative to their largest "
             f"entry (tol {stem_tol}): {', '.join(stem_errs)}"
             if stem_errs else "")
          + f"; inputs of the stem's ReLUs on the other side of 0 on the "
          f"card: {flips} of "
          f"{sum(a.numel() for a in relus[model_cpu])}; qkv and cpb_mlp "
          f"gradients non-zero; K1, K2, K3, K4 launches per step {calls}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(dloss <= TOL_STEP_LOSS, f"loss card vs CPU {dloss}")


KINDS = [  # (kind, substrings of a kernel's name), first match wins
    ("K6 hat_block", ("hat_block_kernel", "hat_block_tc_kernel")),
    ("K5 ms_deform_attn", ("msda_fwd",)),
    ("K4 window_mhsa_long_backward", ("long_bwd", "long_dbias_sum")),
    ("K3 window_mhsa_long", ("window_mhsa_long",)),
    ("K2 window_mhsa_backward", ("window_mhsa_bwd", "dbias_sum")),
    ("K1 window_mhsa", ("window_mhsa_kernel", "window_mhsa_tc_kernel")),
    ("input copy to the card", ("memcpy htod",)),
    ("layout transposes (cuDNN)", ("nchwtonhwc", "nhwctonchw")),
    ("convolutions (cuDNN)", ("conv", "dgrad", "wgrad", "fprop", "cudnn")),
    ("matmuls (cuBLAS)", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("LayerNorm", ("layer_norm", "layernorm", "gammabeta")),
    ("BatchNorm (incl. its f32 statistics)", ("batch_norm", "batchnorm",
                                              "welford")),
    ("optimizer, clip and EMA (foreach)", ("multi_tensor", "foreach")),
    ("GELU", ("gelu",)),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("copies, gathers and cat", ("copy", "cat", "transpose", "index",
                                 "radixsort", "memset")),
    ("elementwise", ("elementwise", "vectorized")),
]


def profile_device(fn, n: int, what: str, unit_ms: float, smi: str,
                   out_name: str):
    """torch.profiler over n calls of fn (n `what`s): device time by kind
    of kernel, against the unprofiled time unit_ms of one call, written to
    chiprun_out/<out_name> with the raw kernel table. Annotations that the
    profiler mirrors onto the device's timeline (such as
    Optimizer.step#AdamW.step) are not kernels and are left out. Returns
    {"device_ms", "launches", "busy"} a call (busy: device time over
    unit_ms), or None if the profiler recorded no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    kernels = {}
    for e in prof.key_averages():
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.key.startswith(("Optimizer.", "ProfilerStep")))
        if e.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + t / 1e3 / n,
                              e.count / n)
    total = sum(t for t, _ in kernels.values())
    if not total:
        print("profile: torch.profiler recorded no device time")
        return None
    kinds = {}
    for name, (t, c) in kernels.items():
        low = name.lower()
        kind = next((k for k, subs in KINDS if any(x in low for x in subs)),
                    "other")
        kt, kc = kinds.get(kind, (0.0, 0.0))
        kinds[kind] = (kt + t, kc + c)
    unit = what.split()[-1]
    print(f"profile of {n} {what}s: device {total:.3f} ms a {unit}, "
          f"{100 * total / unit_ms:.1f}% of the unprofiled {unit_ms:.3f} ms "
          f"(profiled wall {wall_ms:.3f} ms); device ms a {unit} by kind "
          f"[{smi}]:")
    for kind, (t, c) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind:36s} {t:9.3f} ms {100 * t / total:5.1f}%  "
              f"{c:6.1f} launches")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out_name).write_text(json.dumps({
        "card": smi, "what": what, "n": n, "wall_ms_per_call": wall_ms,
        "unprofiled_ms_per_call": unit_ms, "device_ms_per_call": total,
        "kinds": {k: {"ms": t, "launches": c} for k, (t, c) in kinds.items()},
        "kernels": [{"name": k, "ms": t, "launches": c}
                    for k, (t, c) in top]}, indent=1))
    return {"device_ms": total, "busy": total / unit_ms,
            "launches": sum(c for _, c in kernels.values())}


def train_main_phase(fvt, cuda_attention, steps, train_cli, schedule,
                     mixup) -> dict:
    """The training path: the CLI end to end, then make_train_step with the
    fv0 recipe in bf16 at batch 128."""
    out = {}
    # 1. the CLI: 4 steps at batch 128 and synthetic eval
    with tempfile.TemporaryDirectory() as tmp, \
            RouteLog(cuda_attention) as cli_routes:
        reset_launches(cuda_attention)
        t0 = time.perf_counter()
        train_cli.main(["--config", str(REPO / "configs"
                                        / "faster_vit_0_224_1k.yaml"),
                        "--synthetic", "--epochs", "1", "--warmup-epochs",
                        "0", "--cooldown-epochs", "0", "--data-len", "512",
                        "--output", tmp])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_calls = launches(cuda_attention)
        rows = list(csv.DictReader(open(Path(tmp) / "summary.csv")))
    check(len(rows) == 1 and all(
        math.isfinite(float(rows[0][k]))
        for k in ("train_loss", "eval_loss", "eval_top1")),
        f"CLI summary.csv rows {rows}")
    # 4 train steps x 17 K1 and K2; eval: 4 batches x (model + EMA) x 17 K1
    check(cli_calls == (4 * 17 + 8 * 17, 4 * 17, 0, 0),
          f"CLI K1, K2, K3, K4 launches {cli_calls}")
    # the fv0 config trains in bfloat16: K1 and K2 on the tensor cores
    cli_routes.check(4 * 17 + 8 * 17, 4 * 17, "wgmma", "CLI (train.py)")
    print(f"CLI (train.py, fv0 recipe, 4 steps b{TRAIN_BATCH} + eval): "
          f"{cli_s:.1f} s; summary.csv {dict(rows[0])}; K1, K2, K3, K4 "
          f"launches {cli_calls}")

    batch = synthetic_batch(TRAIN_BATCH, 6)
    # 2. 10 steps on one batch: no mixup, no drop path, lr 1e-3
    model = fvt.create_model("faster_vit_0_224", drop_path_rate=0.0,
                             generator=torch.Generator().manual_seed(7))
    cfg = steps.TrainConfig(mixup=None)
    state = steps.create_train_state(model, cfg)
    step = steps.make_train_step(cfg, lambda t: 1e-3, torch.bfloat16)
    losses = [step(state, batch)["loss"].item() for _ in range(10)]
    print(f"fv0 bf16 b{TRAIN_BATCH}, 10 steps on one batch (no mixup, no "
          f"drop path, lr 1e-3): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({', '.join(f'{x:.3f}' for x in losses)})")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"loss did not fall: {losses}")
    del model, state, step

    # 3. the fv0 recipe (mixup, drop path 0.2, adamw, clip 5, EMA, cosine
    #    schedule with warmup), 5 warm-up steps, then 20 timed
    model = fvt.create_model("faster_vit_0_224",
                             generator=torch.Generator().manual_seed(8))
    cfg = steps.TrainConfig(mixup=mixup.MixupConfig())
    sched, _ = schedule.create_scheduler(schedule.ScheduleConfig())
    state = steps.create_train_state(model, cfg)
    step = steps.make_train_step(cfg, sched, torch.bfloat16, seed=9)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(cuda_attention)
    with RouteLog(cuda_attention) as routes:
        for _ in range(5):
            step(state, batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            metrics = step(state, batch)
        end.record()
        end.synchronize()
    calls = launches(cuda_attention)
    ms = start.elapsed_time(end) / 20
    peak = torch.cuda.max_memory_allocated()
    loss = metrics["loss"].item()
    smi = card()
    check(calls == (25 * 17, 25 * 17, 0, 0),
          f"K1, K2, K3, K4 launches over 25 steps {calls}, expected 425, "
          "425, 0 and 0")
    routes.check(25 * 17, 25 * 17, "wgmma",
                 f"fv0 bf16 b{TRAIN_BATCH} train steps (25)")
    check(math.isfinite(loss), f"loss {loss}")
    print(f"fv0 bf16 b{TRAIN_BATCH} train step (fv0 recipe, eager): "
          f"{ms:.3f} ms a step, {TRAIN_BATCH * 1000 / ms:.1f} img/s; peak "
          f"memory {peak / 2**20:.1f} MiB; K1, K2, K3, K4 launches over 25 "
          f"steps "
          f"{calls}; last loss {loss:.4f}, grad_norm "
          f"{metrics['grad_norm'].item():.4f} [{smi}]")
    out.update(launches=calls, step_ms=ms, peak=peak)
    profile_device(lambda: step(state, batch), 2,
                   f"fv0 bf16 b{TRAIN_BATCH} train step", ms, smi,
                   "train_profile.json")
    return out


def long_fp32_phase(fvt, cuda_attention):
    """faster_vit_4_21k_768 in fp32, batch 1: the card's K3 path against
    the CPU's plain path on the same weights. Returns the card's model."""
    t0 = time.perf_counter()
    model_cpu = fvt.create_model("faster_vit_4_21k_768", device="cpu",
                                 generator=torch.Generator().manual_seed(11))
    model_cpu.eval()
    model = copy.deepcopy(model_cpu).to("cuda")
    build_s = time.perf_counter() - t0
    x = torch.randn(1, 3, 768, 768,
                    generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        t0 = time.perf_counter()
        want = model_cpu(x)
        cpu_s = time.perf_counter() - t0
        before = launches(cuda_attention)
        got = model(x.to("cuda"))
        torch.cuda.synchronize()
        calls = tuple(a - b for a, b in zip(launches(cuda_attention), before))
    err = (got.cpu() - want).abs().max().item()
    print(f"faster_vit_4_21k_768 fp32 b1: card vs CPU max|dlogits| "
          f"{err:.3e} (tol {TOL_MODEL_FP32}); K1, K2, K3, K4 launches per "
          f"forward {calls}; build on the CPU and copy {build_s:.1f} s, CPU "
          f"forward {cpu_s:.1f} s")
    check(got.shape == (1, 1000) and bool(torch.isfinite(got).all()),
          "21k-768 fp32 logits finite, (1, 1000)")
    check(err <= TOL_MODEL_FP32, f"21k-768 fp32 logits error {err}")
    check(calls == (0, 0, 17, 0),
          f"21k-768 launches {calls}, expected 17 K3")
    return model


def serving_phase(fvt, model, cuda_attention) -> dict:
    """The serving path: faster_vit_4_21k_768 in bf16 at batch 16, live and
    baked, against fp32 on the same weights; timed and profiled."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(SERVE_BATCH, 3, 768, 768, device="cuda", generator=gen)
    with torch.no_grad():
        ref = model(x)
    model16 = model.to(torch.bfloat16)  # the same weights, now bf16
    x16 = x.bfloat16()
    del x
    with torch.no_grad():
        reset_launches(cuda_attention)
        live = model16(x16)
        fvt.bake_posemb(model16)
        baked = model16(x16)
        torch.cuda.synchronize()
        calls = launches(cuda_attention)
    gap = (live.float() - ref).abs().max().item()
    same = torch.equal(baked, live)
    print(f"faster_vit_4_21k_768 bf16 b{SERVE_BATCH}, a live then a baked "
          f"forward: K1, K2, K3, K4 launches {calls}; baked logits "
          f"bit-identical "
          f"to live: {same}; max|bf16 - fp32 logits| {gap:.4f} (tol "
          f"{TOL_MODEL_BF16})")
    check(calls == (0, 0, 34, 0), f"launches {calls}, expected 34 K3 only")
    check(cuda_attention.window_mhsa_long_cuda.last_plan.route == "wgmma",
          "the bf16 serving path's K3 left the tensor cores")
    check(same, "baked and live bf16 logits differ")
    check(live.shape == (SERVE_BATCH, 1000)
          and bool(torch.isfinite(live).all()),
          f"bf16 logits finite, ({SERVE_BATCH}, 1000)")
    check(gap <= TOL_MODEL_BF16, f"bf16 logits off fp32 by {gap}")
    del ref, live, baked

    # baked and live forwards in turns (baked, live, live, baked); the
    # peak memory is the baked forward's
    modules = [m for m in model16.modules()
               if hasattr(m, "relative_bias") and hasattr(m, "cpb_mlp")]
    stored = [m.relative_bias for m in modules]
    baked_bytes = sum(t.numel() * t.element_size() for t in stored)

    def baking(on: bool) -> None:
        for m, t in zip(modules, stored):
            m.relative_bias = t if on else None

    run = lambda: model16(x16)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        b1 = time_ms(run, iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated()
        baking(False)
        l1 = time_ms(run, iters=5, warmup=2)
        l2 = time_ms(run, iters=5, warmup=2)
        baking(True)
        b2 = time_ms(run, iters=5, warmup=2)
    smi = card()
    ms, live_ms = (b1 + b2) / 2, (l1 + l2) / 2
    print(f"faster_vit_4_21k_768 bf16 b{SERVE_BATCH} eager, baked: {ms:.3f} "
          f"ms per batch ({b1:.3f}, {b2:.3f}), {SERVE_BATCH * 1000 / ms:.2f} "
          f"img/s; live: {live_ms:.3f} ms ({l1:.3f}, {l2:.3f}), "
          f"{SERVE_BATCH * 1000 / live_ms:.2f} img/s; peak memory "
          f"{peak / 2**20:.1f} MiB, {baked_bytes / 2**20:.1f} MiB of it "
          f"baked tensors [{smi}]")
    with torch.no_grad():
        profile_device(run, 1, f"faster_vit_4_21k_768 bf16 b{SERVE_BATCH} "
                       "baked forward", ms, smi, "serve_profile.json")
    return {"launches": calls[2], "ms": ms, "live_ms": live_ms,
            "peak": peak}


def family_phase(fvt, cuda_attention) -> None:
    """faster_vit_0_any_res at 576x960 and faster_vit_5_224 in bf16, batch
    8: their K1 and K3 launches, and logits against fp32 on the same
    weights."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    for name, want in (("faster_vit_0_any_res", (11, 0, 6, 0)),
                       ("faster_vit_5_224", (0, 0, 29, 0))):
        model = fvt.create_model(
            name, generator=torch.Generator().manual_seed(14)).eval()
        h, w = model.cfg.resolution
        x = torch.randn(8, 3, h, w, device="cuda", generator=gen)
        with torch.no_grad():
            ref = model(x)
            model16 = model.to(torch.bfloat16)
            reset_launches(cuda_attention)
            logits = model16(x.bfloat16())
            torch.cuda.synchronize()
            calls = launches(cuda_attention)
        gap = (logits.float() - ref).abs().max().item()
        print(f"{name} bf16 b8 at {h}x{w}: K1, K2, K3, K4 launches {calls}; "
              f"max|bf16 - fp32 logits| {gap:.4f} (tol {TOL_MODEL_BF16})")
        check(calls == want, f"{name} launches {calls}, expected {want}")
        check(logits.shape == (8, 1000)
              and bool(torch.isfinite(logits).all()),
              f"{name} bf16 logits finite, (8, 1000)")
        check(gap <= TOL_MODEL_BF16, f"{name} bf16 logits off fp32 by {gap}")
        del model, model16, x, ref, logits


def sdpa_backward(q, k, v, mask, g4, scale):
    """One call of SDPA's backward on (q, k, v, mask) with output gradient
    g4, the mask's gradient included, as a function of no arguments."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    mask = mask.detach().clone().requires_grad_()
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)
    return lambda: torch.autograd.grad(out, (q, k, v, mask), g4,
                                       retain_graph=True)


def k4_phase(cuda_attention, attention, ptx_log: str) -> dict:
    kernel = cuda_attention.window_mhsa_long_backward_cuda
    plain = attention.window_mhsa_backward_reference
    instances = ptxas_k4_instances(ptx_log, cuda_attention)
    print_instances("K4 long_bwd_*_tc_kernel", instances)
    check(len(instances) == 3 * 2 * 4 * 2,
          f"{len(instances)} tensor-core instances of K4 in the build log, "
          "expected 48 (3 passes, 2 bias types, 4 depths, 2 load widths)")
    gen = torch.Generator(device="cuda").manual_seed(20)
    err32_all = err16_all = 0.0

    def same_twice(first, *args):
        again = kernel(*args)
        return torch.equal(again[0], first[0]) and torch.equal(again[1],
                                                                first[1])

    for b, s, h, d, fp32 in ([t + (True,) for t in K4_CHECK_SHAPES]
                             + [t + (False,) for t in K4_BF16_SHAPES]):
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        bias = torch.randn(h, s, s, device="cuda", generator=gen)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen)
        scale = d ** -0.5
        before = kernel.launches
        err32 = err16 = 0.0
        if b and fp32:
            got = kernel(qkv, bias, g, h, scale)
            check_bwd_plan(cuda_attention, False, d, bias.dtype,
                           f"K4 fp32 at {(b, s, h, d)}")
            want = plain(qkv, bias, g, h, scale)
            err32 = max(rel_to_largest(got[0], want[0]),
                        rel_to_largest(got[1], want[1]))
            check(same_twice(got, qkv, bias, g, h, scale),
                  f"K4 fp32 differs between two launches at {(b, s, h, d)}")
            del got, want
        q16, g16 = qkv.bfloat16(), g.bfloat16()
        for bias_in in (bias, bias.bfloat16()):
            got = kernel(q16, bias_in, g16, h, scale)
            if b:
                check_bwd_plan(cuda_attention, True, d, bias_in.dtype,
                               f"K4 bf16 at {(b, s, h, d)}")
                want = plain(q16.float(), bias_in.float(), g16.float(), h,
                             scale)
                err16 = max(err16, rel_to_largest(got[0], want[0]),
                            rel_to_largest(got[1], want[1]))
                check(same_twice(got, q16, bias_in, g16, h, scale),
                      f"K4 bf16 differs between two launches at "
                      f"{(b, s, h, d)}, bias {bias_in.dtype}")
                del want
            else:
                check(got[0].shape == qkv.shape and not got[1].any(),
                      "K4 output of an empty batch")
            del got
        torch.cuda.synchronize()
        if not b:
            check(kernel.launches == before, "K4 launched on an empty batch")
        plan = cuda_attention.long_bwd_plan(d, torch.bfloat16, torch.bfloat16)
        print(f"K4 window_mhsa_long_backward B={b} S={s} H={h} hd={d}: "
              f"max|err| / max|plain| of dqkv and dbias: fp32 "
              + (f"{err32:.3e} (tol {TOL_K4_FP32}, scalar FMA)" if fp32
                 else "not checked here")
              + f", bf16 with f32 and bf16 bias {err16:.3e} (tol "
              f"{TOL_K4_BF16}, wgmma, D {plan.depth}); dqkv and dbias "
              "bit-identical over two launches")
        check(err32 <= TOL_K4_FP32, f"K4 fp32 error {err32} at "
                                    f"{(b, s, h, d)}")
        check(err16 <= TOL_K4_BF16, f"K4 bf16 error {err16} at "
                                    f"{(b, s, h, d)}")
        err32_all, err16_all = max(err32_all, err32), max(err16_all, err16)
        del qkv, bias, g, q16, g16

    # bf16 (the training path's dtypes), in turns; SDPA's backward on the
    # same q, k, v and bias as a float mask that needs its gradient,
    # zero-padded to a head dim of 56 if hd 49 would leave it the math
    # backend (zero columns of q, k, v and g add nothing: the same function)
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    per_call = {}
    backend = ""
    ops_ms = bytes_ms = 0.0
    for b, s, h, d, calls, iters in K4_TIME_SHAPES:
        q16 = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=torch.bfloat16)
        b16 = torch.randn(h, s, s, device="cuda", generator=gen,
                          dtype=torch.bfloat16)
        g16 = torch.randn(b, s, h * d, device="cuda", generator=gen,
                          dtype=torch.bfloat16)
        scale = d ** -0.5
        q, k, v = split_heads(q16, h)
        g4 = g16.reshape(b, s, h, d).transpose(1, 2).contiguous()
        # the backend, by the forward's op (the math backend's backward is
        # generic ops), on one window
        native = sdpa_backend(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:1], k[:1], v[:1], attn_mask=b16[None], scale=scale))
        if "math" in native and d % 8:
            pad = (0, (-d) % 8)
            q, k, v, g4 = (torch.nn.functional.pad(t, pad)
                           for t in (q, k, v, g4))
        run_l = sdpa_backward(q, k, v, b16[None], g4, scale)
        backend = sdpa_backend(run_l)
        if q.shape[-1] != d:
            backend = (f"{backend}, with q, k, v and g zero-padded from hd "
                       f"{d} to {q.shape[-1]}; at hd {d} it ran {native}")
        # the plain version holds about six (B, H, S, S) f32 tensors
        free = (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
                - torch.cuda.memory_allocated())
        fits = 6 * 4 * b * h * s * s < 0.8 * free
        plain_ms, ms, lib_ms = in_turns(
            (lambda: plain(q16, b16, g16, h, scale)) if fits else None,
            lambda: kernel(q16, b16, g16, h, scale), run_l, iters)
        check_bwd_plan(cuda_attention, True, d, b16.dtype,
                       f"K4 timed at {(b, s, h, d)}")
        del q, k, v, g4, run_l
        # qkv and g read, dqkv written, bias read, dbias written (bf16)
        nbytes = 2 * (2 * q16.numel() + g16.numel() + 2 * b16.numel())
        flops = 10.0 * b * h * s * s * d
        bound = bound_ms(nbytes, flops)
        by = ("operations" if flops / BF16_FLOP_PER_S
              > nbytes / HBM_BYTES_PER_S else "bytes")
        per_call[f"({b},{s},{h},{d})"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": by,
            "tflop_s": flops / ms / 1e9,
            "library_tflop_s": flops / lib_ms / 1e9,
            "route": kernel.last_plan.route}
        if calls:
            for key, t in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bound_ms", bound)):
                step[key] += calls * t
            ops_ms += calls * 1e3 * flops / BF16_FLOP_PER_S
            bytes_ms += calls * 1e3 * nbytes / HBM_BYTES_PER_S
        plain_text = (f"{plain_ms:.4f} ms" if plain_ms is not None else
                      "not measured (its f32 tensors do not fit)")
        print(f"K4 window_mhsa_long_backward B={b} S={s} H={h} hd={d} bf16 "
              f"(wgmma): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_text}, SDPA backward {lib_ms:.4f} ms "
              f"({flops / lib_ms / 1e9:.1f} TFLOP/s), bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP, {by}) per "
              f"call; SDPA ran {backend}")
        del q16, b16, g16
    print(f"K4 window_mhsa_long_backward over one faster_vit_4_21k_384 bf16 "
          f"b{FINETUNE_BATCH} train step's 17 calls: kernel {step['ms']:.4f} "
          f"ms, plain {step['plain_ms']:.4f} ms, SDPA backward "
          f"{step['library_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms "
          f"[{card()}]")
    return {"name": "window_mhsa_long_backward", "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/window_mhsa_long_bwd.cu",
            "replaces": "fastervit_tpu/ops/pallas_flash_attention.py:288",
            "replaces_kernels": "_bwd_dq_kernel (:243, its pallas_call at "
                                ":288) and _bwd_dkv_kernel (:263, its "
                                "pallas_call at :315), both called by "
                                "_flash_backward",
            "launches": None, "max_abs_err": err16_all,
            "max_abs_err_fp32": err32_all,
            "err_is": "max |err| / max |plain| of dqkv and dbias",
            "kernel_route": {"bf16": "wgmma", "f32": "scalar"},
            "ptxas": instances,
            **step,
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "library": f"scaled_dot_product_attention backward ({backend})",
            "per": f"one faster_vit_4_21k_384 bf16 b{FINETUNE_BATCH} train "
                   "step (17 calls: 12 at level 2, operations-bound; 5 at "
                   "level 3, bytes-bound)",
            "per_call": per_call}


class _Records(logging.Handler):
    """Keeps the messages of the records it is handed."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def finetune_cli_phase(fvt, cuda_attention, train_cli) -> None:
    """The fine-tuning CLI: a 21841-class faster_vit_4_21k_224 state_dict,
    saved as a reference checkpoint, warm-starts faster_vit_4_21k_384 (3
    steps at batch 32 in bf16, then eval), which writes a checkpoint; the
    same command run again restores it."""
    records = _Records()
    pkg_log = logging.getLogger("fastervit_tpu_torch")
    prev_level = pkg_log.level
    pkg_log.addHandler(records)
    pkg_log.setLevel(logging.INFO)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            src = fvt.create_model("faster_vit_4_21k_224", device="cpu",
                                   num_classes=21841,
                                   generator=torch.Generator().manual_seed(16))
            ref = Path(tmp) / "faster_vit_4_21k_224.pth.tar"
            torch.save({"state_dict": {"module." + k: v for k, v in
                                       src.state_dict().items()}}, ref)
            del src
            write_s = time.perf_counter() - t0
            out = Path(tmp) / "out"
            argv = ["--model", "faster_vit_4_21k_384", "--loadcheckpoint",
                    str(ref), "--synthetic", "-b", str(FINETUNE_BATCH),
                    "--dtype", "bfloat16", "--epochs", "1",
                    "--warmup-epochs", "0", "--cooldown-epochs", "0",
                    "--data-len", str(3 * FINETUNE_BATCH), "--lr", "1e-4",
                    "--checkpoint-hist", "2", "--output", str(out)]
            runs = []
            for _ in range(2):
                records.messages.clear()
                reset_launches(cuda_attention)
                t0 = time.perf_counter()
                train_cli.main(argv)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0,
                             launches(cuda_attention),
                             list(records.messages)))
                gc.collect()
                torch.cuda.empty_cache()
            rows = list(csv.DictReader(open(out / "summary.csv")))
            kept = sorted(int(p.stem) for p in
                          (out / "checkpoints").glob("*.pt"))
            ckpt_mb = sum(p.stat().st_size for p in
                          (out / "checkpoints").glob("*.pt")) / 2**20
    finally:
        pkg_log.removeHandler(records)
        pkg_log.setLevel(prev_level)
    (first_s, first_calls, first_log), (second_s, second_calls,
                                        second_log) = runs
    warned = [m for m in first_log if m.startswith("shape-mismatched")]
    # 3 steps x 17 K3 and K4; eval: 4 batches x (model + EMA) x 17 K3
    want_calls = (0, 0, 3 * 17 + 8 * 17, 3 * 17)
    print(f"fine-tune CLI (faster_vit_4_21k_384 from a 21841-class "
          f"faster_vit_4_21k_224 .pth.tar, written in {write_s:.1f} s; bf16 "
          f"b{FINETUNE_BATCH}, 3 steps + eval): first run {first_s:.1f} s, "
          f"warm start: {warned}; second run {second_s:.1f} s: "
          f"{[m for m in second_log if 'resumed' in m]}; checkpoints kept "
          f"{kept} ({ckpt_mb:.0f} MiB); K1, K2, K3, K4 launches per run "
          f"{first_calls}, {second_calls}; summary rows "
          f"{[dict(r) for r in (rows[0], rows[-1])]}")
    check(len(warned) == 1 and "head.weight (21841, 1568)->(1000, 1568)"
          in warned[0] and "head.bias (21841,)->(1000,)" in warned[0],
          f"warm start warnings {warned}")
    check(not any(m.startswith(("missing keys", "unexpected keys"))
                  for m in first_log), "warm start: keys missing or unused")
    check(not any("resumed" in m for m in first_log),
          "the first run resumed")
    check("auto-resumed from checkpoint at step 3" in second_log,
          "the second run did not resume from step 3")
    check(kept == [3, 6], f"checkpoints kept {kept}, expected [3, 6]")
    check(first_calls == want_calls and second_calls == want_calls,
          f"CLI launches {first_calls}, {second_calls}, expected "
          f"{want_calls}")
    check(all(math.isfinite(float(r[k])) for r in (rows[0], rows[-1])
              for k in ("train_loss", "eval_loss", "eval_top1")),
          f"summary rows {rows}")


def long_train_phase(fvt, cuda_attention, steps, schedule, mixup) -> dict:
    """faster_vit_4_21k_384 with the fine-tune recipe (mixup, drop path
    0.42, adamw, clip 5, EMA) in bf16 at batch 32: 2 warm-up steps, 10
    timed, launches counted, peak memory, one step profiled; then 1 + 3
    steps with gradient checkpointing, for its peak memory and step
    time."""
    batch = synthetic_batch(FINETUNE_BATCH, 17, (384, 384))
    out = {}
    smi = card()
    for gc_on in (False, True):
        model = fvt.create_model("faster_vit_4_21k_384",
                                 generator=torch.Generator().manual_seed(18))
        cfg = steps.TrainConfig(mixup=mixup.MixupConfig(),
                                grad_checkpoint=gc_on)
        sched, _ = schedule.create_scheduler(schedule.ScheduleConfig())
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_step(cfg, sched, torch.bfloat16, seed=19)
        warm, timed = (1, 3) if gc_on else (2, 10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(cuda_attention)
        for _ in range(warm):
            step(state, batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(timed):
            metrics = step(state, batch)
        end.record()
        end.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / timed
        calls = launches(cuda_attention)
        ms = start.elapsed_time(end) / timed
        peak = torch.cuda.max_memory_allocated()
        loss = metrics["loss"].item()
        n = warm + timed
        what = "with gradient checkpointing" if gc_on else "plain"
        print(f"faster_vit_4_21k_384 bf16 b{FINETUNE_BATCH} train step "
              f"(fine-tune recipe, eager, {what}): {ms:.3f} ms a step "
              f"(CUDA events over {timed} steps; host {wall_ms:.3f} ms), "
              f"{FINETUNE_BATCH * 1000 / ms:.2f} img/s; peak memory "
              f"{peak / 2**20:.1f} MiB; K1, K2, K3, K4 launches over {n} "
              f"steps {calls}; last loss {loss:.4f}, grad_norm "
              f"{metrics['grad_norm'].item():.4f} [{smi}]")
        # with checkpointing each block's recompute runs its K3 again
        k3 = 17 * n * (2 if gc_on else 1)
        check(calls == (0, 0, k3, 17 * n),
              f"21k-384 launches over {n} steps {calls}, expected {k3} K3 "
              f"and {17 * n} K4")
        check(math.isfinite(loss), f"21k-384 loss {loss}")
        if gc_on:
            out.update(gc_ms=ms, gc_peak=peak)
        else:
            out.update(launches=calls, ms=ms, peak=peak)
            profile_device(lambda: step(state, batch), 1,
                           f"faster_vit_4_21k_384 bf16 b{FINETUNE_BATCH} "
                           "train step", ms, smi, "finetune_profile.json")
        del model, state, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    print(f"gradient checkpointing: peak memory {out['gc_peak'] / 2**20:.1f}"
          f" MiB against {out['peak'] / 2**20:.1f} MiB, step "
          f"{out['gc_ms']:.3f} ms against {out['ms']:.3f} ms")
    return out


def family_train_phase(fvt, cuda_attention, steps, mixup) -> None:
    """One bf16 train step (fv0 recipe) of faster_vit_5_224 and of
    faster_vit_0_any_res at 576x960, batch 8: their K1, K2, K3 and K4
    launches. fv5's head dim of 80 sends all 29 attention sites to K3 and
    K4; fv0_any_res has 11 sites with S <= 64 (K1 and K2) and 6 carrier
    sites with S = 216 (K3 and K4). K4 must have run on the tensor cores.
    """
    for name, want, k4_hd in (("faster_vit_5_224", (0, 0, 29, 29), 80),
                              ("faster_vit_0_any_res", (11, 11, 6, 6), 32)):
        model = fvt.create_model(name,
                                 generator=torch.Generator().manual_seed(21))
        cfg = steps.TrainConfig(mixup=mixup.MixupConfig())
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_step(cfg, lambda t: 1e-3, torch.bfloat16,
                                     seed=22)
        batch = synthetic_batch(8, 23, model.cfg.resolution)
        reset_launches(cuda_attention)
        loss = step(state, batch)["loss"].item()
        torch.cuda.synchronize()
        calls = launches(cuda_attention)
        h, w = model.cfg.resolution
        print(f"{name} bf16 b8 at {h}x{w}, one train step: K1, K2, K3, K4 "
              f"launches {calls}; loss {loss:.4f}")
        check(calls == want, f"{name} train-step launches {calls}, expected "
                             f"{want}")
        check(math.isfinite(loss), f"{name} loss {loss}")
        check_bwd_plan(cuda_attention, True, k4_hd,
                       what=f"{name}'s bf16 step")
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()


def msda_inputs(n, q, m, d, p, shapes, gen, timing=False):
    """f32 MSDA inputs on the card: value N(0, 1); weights softmax-
    normalised over L·P; locations uniform in [0, 1] for timing (the
    model's samples fall inside the map), else in [-0.1, 1.1] with a
    quarter of them on the borders (0, 1) or far outside (±10, ±1e9) and a
    tenth half a pixel inside an edge."""
    s, nl = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(n, s, m, d, device="cuda", generator=gen)
    w = torch.randn(n, q, m, nl * p, device="cuda", generator=gen)
    w = w.softmax(-1).reshape(n, q, m, nl, p)
    loc = torch.rand(n, q, m, nl, p, 2, device="cuda", generator=gen)
    if not timing:
        loc = loc * 1.2 - 0.1
        special = torch.tensor([0.0, 1.0, -10.0, 10.0, -1e9, 1e9],
                               device="cuda")
        pick = torch.rand(loc.shape, device="cuda", generator=gen) < 0.25
        idx = torch.randint(0, len(special), loc.shape, device="cuda",
                            generator=gen)
        loc = torch.where(pick, special[idx], loc)
        wh = torch.tensor([[w_, h_] for h_, w_ in shapes], device="cuda")
        edge = (0.5 / wh)[None, None, None, :, None, :].expand_as(loc)
        r = torch.rand(loc.shape, device="cuda", generator=gen)
        loc = torch.where(r < 0.05, edge, torch.where(r < 0.1, 1 - edge, loc))
    return value, loc.contiguous(), w.contiguous()


def at_element_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t one element into its storage, so that its
    address is aligned to the element alone."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def k5_refuses_wrong_plans(cuda_msda, gen) -> None:
    """K5's C entry point, handed each plan of K5_WRONG_PLANS in place of
    msda_plan's, refuses it: the call raises and counts no launch."""
    kernel = cuda_msda.ms_deform_attn_cuda
    n, q, m, d, p, shapes, _ = K5_SERVED[1]
    value, loc, w = msda_inputs(n, q, m, d, p, shapes, gen)
    v16, w16 = value.bfloat16(), w.bfloat16()
    shifted = at_element_offset(v16)
    make = cuda_msda.msda_plan
    try:
        for plan, offset in K5_WRONG_PLANS:
            cuda_msda.msda_plan = lambda *_: cuda_msda.MsdaPlan(*plan)
            before = kernel.launches
            try:
                kernel(shifted if offset else v16, shapes, loc, w16)
                refused = False
            except RuntimeError as err:
                refused = "msda_forward" in str(err)
            check(refused and kernel.launches == before,
                  f"K5 ran plan {plan}, which its C entry point must refuse")
    finally:
        cuda_msda.msda_plan = make
    torch.cuda.synchronize()
    print(f"K5's C entry point refuses {len(K5_WRONG_PLANS)} wrong plans "
          f"(misaligned vectors, too few channels, no instance, too many "
          f"warps), each counting no launch")


def k5_phase(cuda_msda, msda, ptx_log: str) -> dict:
    """K5 against its plain version at the served and odd shapes and on a
    value one element into its storage, its C entry point's refusal of
    wrong plans and its instances' registers and spills, then kernel, plain
    version and the grid_sample form timed in bf16 at the served shapes,
    and the kernel at the encoder shape with coherent locations. The bf16
    inputs are what the bf16 detector hands K5: value and weights in bf16,
    the sampling locations in f32."""
    from fastervit_tpu_torch.probes import msda_turns
    kernel = cuda_msda.ms_deform_attn_cuda
    plain = msda.msda_reference
    gen = torch.Generator(device="cuda").manual_seed(30)
    err32_all = err16_all = 0.0
    for n, q, m, d, p, shapes, _ in K5_SERVED + K5_ODD:
        value, loc, w = msda_inputs(n, q, m, d, p, shapes, gen)
        v16, w16 = value.bfloat16(), w.bfloat16()
        before = kernel.launches
        got = kernel(value, shapes, loc, w)
        plans = [kernel.last_plan] if n * q else []
        got16 = kernel(v16, shapes, loc, w16)
        err32 = err16 = 0.0
        if n * q:
            plans.append(kernel.last_plan)
            err32 = (got - plain(value, shapes, loc, w)).abs().max().item()
            want = plain(v16.float(), shapes, loc, w16.float())
            err16 = ((got16.float() - want).abs().max()
                     / want.abs().max().clamp(min=1.0)).item()
            check(torch.equal(kernel(value, shapes, loc, w), got)
                  and torch.equal(kernel(v16, shapes, loc, w16), got16),
                  f"K5 differs between two launches at {(n, q, m, d, p)}")
            del want
        else:
            check(kernel.launches == before
                  and got.shape == got16.shape == (n, q, m * d),
                  f"K5 on an empty input {(n, q)}")
        torch.cuda.synchronize()
        print(f"K5 ms_deform_attn N={n} Q={q} M={m} D={d} P={p} levels "
              f"{shapes}: max|err| fp32 {err32:.3e} (tol {TOL_K5_FP32}), "
              f"bf16 max|err| / max(1, max|plain|) {err16:.3e} (tol "
              f"{2 ** -8:.3e}: one bf16 rounding); two launches "
              "bit-identical; plans (G, V, channels a lane) "
              + ", ".join(f"{pl.lanes}, {pl.vec}, {pl.channels}"
                          for pl in plans))
        check(err32 <= TOL_K5_FP32, f"K5 fp32 error {err32} at "
                                    f"{(n, q, m, d, p)}")
        check(err16 <= 2 ** -8, f"K5 bf16 error {err16} at {(n, q, m, d, p)}")
        err32_all, err16_all = max(err32_all, err32), max(err16_all, err16)
        del value, loc, w, v16, w16, got, got16

    # a value one element into its storage: scalar loads, the same bits
    for n, q, m, d, p, shapes, _ in K5_OFFSET:
        value, loc, w = msda_inputs(n, q, m, d, p, shapes, gen)
        for dtype, tol in ((torch.float32, TOL_K5_FP32),
                           (torch.bfloat16, 2 ** -8)):
            v, wt = value.to(dtype), w.to(dtype)
            shifted = at_element_offset(v)
            got = kernel(shifted, shapes, loc, wt)
            plan = kernel.last_plan
            same = torch.equal(got, kernel(v, shapes, loc, wt))
            want = plain(v.float(), shapes, loc, wt.float())
            err = ((got.float() - want).abs().max().item() if dtype ==
                   torch.float32 else ((got.float() - want).abs().max()
                                       / want.abs().max().clamp(min=1.0))
                   .item())
            print(f"K5 ms_deform_attn N={n} Q={q} M={m} D={d} {dtype}, value "
                  f"one element into its storage: plan (G, V) "
                  f"({plan.lanes}, {plan.vec}), error {err:.3e} (tol "
                  f"{tol:.3e}), the aligned launch's bits: {same}")
            check(plan.vec == 1 and same and err <= tol,
                  f"K5 on an offset value at {(n, q, m, d, p)} {dtype}")
            del v, wt, shifted, got, want
        del value, loc, w
    k5_refuses_wrong_plans(cuda_msda, gen)
    instances = ptxas_k5_instances(ptx_log)
    served = {i: instances.get(i) for i in K5_SERVED_INSTANCES}
    check(all(r is not None and not r["spill_stores"]
              for r in served.values()),
          f"K5's served instances in the ptxas log, without spills: "
          f"{served}")

    step = {"ms": 0.0, "plain_ms": 0.0, "grid_sample_ms": 0.0,
            "bound_ms": 0.0}
    per_call = {}
    ops_ms = bytes_ms = 0.0
    served_plan = None
    for n, q, m, d, p, shapes, calls in K5_SERVED:
        value, loc, w = msda_inputs(n, q, m, d, p, shapes, gen, timing=True)
        gs_err = (msda_grid_sample(value, shapes, loc, w)
                  - plain(value, shapes, loc, w)).abs().max().item()
        v16, w16 = value.bfloat16(), w.bfloat16()
        del value, w
        plain_ms, ms, gs_ms = in_turns(
            lambda: plain(v16, shapes, loc, w16),
            lambda: kernel(v16, shapes, loc, w16),
            lambda: msda_grid_sample(v16, shapes, loc, w16), 20)
        served_plan = kernel.last_plan
        check(served_plan.vec > 1, f"K5's served bf16 call on scalar loads: "
                                   f"{served_plan}")
        # value, locations and weights read, the output written: bf16 but
        # for the f32 locations
        nbytes = (2 * (v16.numel() + w16.numel() + n * q * m * d)
                  + 4 * loc.numel())
        # per sample: its geometry and four corner weights (18 f32 ops),
        # then one FMA per corner and channel
        samples = n * q * m * len(shapes) * p
        flops = samples * (8.0 * d + 18)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
        by = ("operations" if flops / F32_FLOP_PER_S
              > nbytes / HBM_BYTES_PER_S else "bytes")
        # the corner rows a call gathers: 4 a sample, D bf16 channels each
        corner_gb = samples * 4 * d * 2 / 1e9
        row = {"ms": ms, "plain_ms": plain_ms, "grid_sample_ms": gs_ms,
               "bound_ms": bound, "bound_by": by,
               "g_samples_s": samples / ms / 1e6,
               "corner_gb_s": corner_gb / ms * 1e3}
        for key, t in (("ms", ms), ("plain_ms", plain_ms),
                       ("grid_sample_ms", gs_ms), ("bound_ms", bound)):
            step[key] += calls * t
        ops_ms += calls * 1e3 * flops / F32_FLOP_PER_S
        bytes_ms += calls * 1e3 * nbytes / HBM_BYTES_PER_S
        print(f"K5 ms_deform_attn N={n} Q={q} bf16, uniform locations: "
              f"kernel {ms:.4f} ms ({row['g_samples_s']:.1f} G samples/s, "
              f"{row['corner_gb_s']:.0f} GB/s of corner rows), plain "
              f"{plain_ms:.4f} ms, grid_sample form {gs_ms:.4f} ms (fp32 "
              f"max|err| against plain {gs_err:.3e}), bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP f32, {by}) "
              "per call")
        check(gs_err <= 1e-4, f"grid_sample form off the plain version by "
                              f"{gs_err}")
        if q == sum(h * w for h, w in shapes):
            # the encoder's coherent locations, timed beside the uniform
            loc_c = msda_turns.locations("coherent", n, q, m, p, shapes, gen)
            ms_c = time_ms(lambda: kernel(v16, shapes, loc_c, w16), iters=20)
            row["coherent"] = {"ms": ms_c,
                               "g_samples_s": samples / ms_c / 1e6,
                               "corner_gb_s": corner_gb / ms_c * 1e3}
            print(f"K5 ms_deform_attn N={n} Q={q} bf16, coherent locations "
                  f"(each query's samples near its own token): kernel "
                  f"{ms_c:.4f} ms ({row['coherent']['g_samples_s']:.1f} G "
                  f"samples/s, {row['coherent']['corner_gb_s']:.0f} GB/s of "
                  "corner rows) per call")
            del loc_c
        per_call[f"({n},{q},{m},{d},{p})"] = row
        del v16, loc, w16
    print(f"K5 ms_deform_attn over one DINO-4scale bf16 b{DINO_BATCH} "
          f"800x1333 forward's 12 calls: kernel {step['ms']:.4f} ms, plain "
          f"{step['plain_ms']:.4f} ms, grid_sample form "
          f"{step['grid_sample_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms "
          f"[{card()}]")
    return {"name": "ms_deform_attn", "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/msda_fwd.cu",
            "replaces": "fastervit_tpu/ops/msda_pallas.py:141",
            "replaces_kernels": "_p_kernel (:79) and _sample_loop (:42) of "
                                "fused_bilinear_gather, run per level by "
                                "msda_forward_pallas (:156)",
            "launches": None, "max_abs_err": err16_all,
            "max_abs_err_fp32": err32_all,
            "err_is": "bf16: max |err| / max(1, max |plain|); fp32: max "
                      "|err|",
            **step,
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "library_ms": None,
            "library": "none: no one PyTorch call computes MSDA; upstream's "
                       "ms_deform_attn_core_pytorch form (4 grid_sample "
                       "calls and a weighted sum) is timed as "
                       "grid_sample_ms",
            "plan": served_plan._asdict(),
            "ptxas": served,
            "per": f"one DINO-4scale bf16 b{DINO_BATCH} 800x1333 forward (12 "
                   "calls: 6 in the encoder at Q = 22,223, 6 in the decoder "
                   "at Q = 900), uniform locations",
            "per_call": per_call}


def dino_fp32_phase(cuda_attention, cuda_msda, dino, cfg) -> None:
    """The served detector in fp32, batch 1, 480x640: the card (kernel
    path) against the CPU (plain path) on the same weights, step by step;
    both decoders run on the CPU's two-stage selection."""
    t0 = time.perf_counter()
    det_cpu = dino.build_dino_from_config(
        cfg, resolution=(480, 640), device="cpu",
        generator=torch.Generator().manual_seed(31)).eval()
    det = copy.deepcopy(det_cpu).to("cuda")
    build_s = time.perf_counter() - t0
    x = torch.randn(1, 3, 480, 640, generator=torch.Generator().manual_seed(32))
    runs, seconds = {}, {}
    with torch.no_grad():
        for where, m in (("cpu", det_cpu), ("card", det)):
            t0 = time.perf_counter()
            before = detection_launches(cuda_attention, cuda_msda)
            feats = m.features(x.to(where if where == "cpu" else "cuda"))
            enc = m.transformer.encode(m.project(feats))
            runs[where] = (feats, enc, m.transformer.select(enc))
            seconds[where] = time.perf_counter() - t0
        topk = runs["cpu"][2]
        out_cpu = det_cpu.transformer.decode(runs["cpu"][1], topk)
        out = det.transformer.decode(runs["card"][1], topk.cuda())
        torch.cuda.synchronize()
        calls = tuple(a - b for a, b in zip(
            detection_launches(cuda_attention, cuda_msda), before))
    errs = {}
    for key in runs["cpu"][0]:
        errs[key] = rel_to_largest(runs["card"][0][key].cpu(),
                                   runs["cpu"][0][key])
    for key in ("enc_logits", "memory"):
        errs[key] = rel_to_largest(runs["card"][1][key].cpu(),
                                   runs["cpu"][1][key])
    errs["enc_boxes"] = rel_to_largest(
        torch.sigmoid(runs["card"][1]["enc_unsig"]).cpu(),
        torch.sigmoid(runs["cpu"][1]["enc_unsig"]))
    for key in ("interm_logits", "interm_boxes"):
        errs[key] = rel_to_largest(out[key].cpu(), out_cpu[key])
    for i in range(len(out_cpu["logits"])):
        errs[f"logits {i}"] = rel_to_largest(out["logits"][i].cpu(),
                                             out_cpu["logits"][i])
        errs[f"boxes {i}"] = rel_to_largest(out["boxes"][i].cpu(),
                                            out_cpu["boxes"][i])
    scores = runs["cpu"][1]["enc_logits"].max(-1).values[0]
    k = topk.shape[1]
    ranked = scores.sort(descending=True).values
    margin = (ranked[k - 1] - ranked[k]).item()
    card_topk = runs["card"][2].cpu()[0]
    diff = (card_topk != topk[0]).nonzero().flatten()
    gap = ((scores[card_topk[diff]] - scores[topk[0][diff]]).abs().max()
           .item() if len(diff) else 0.0)
    worst = max(errs, key=errs.get)
    print(f"DINO-4scale faster_vit_4_21k_224 fp32 b1 480x640, card vs CPU, "
          f"max|err| / max|CPU| per tensor (tol {TOL_DINO_FP32}): "
          + ", ".join(f"{k_} {v:.2e}" for k_, v in errs.items())
          + f"; worst {worst}; two-stage selection: {len(diff)} of {k} "
          f"positions differ (largest score gap {gap:.2e}; margin between "
          f"the {k}-th and {k + 1}-th score {margin:.2e}); K1, K3, K5 "
          f"launches per forward {calls}; build {build_s:.1f} s, CPU "
          f"{seconds['cpu']:.1f} s, card {seconds['card']:.1f} s")
    check(all(v <= TOL_DINO_FP32 for v in errs.values()),
          f"DINO fp32 card vs CPU: {worst} off by {errs[worst]}")
    check(gap <= TOL_DINO_FP32 * ranked[0].abs().item(),
          f"two-stage selections differ by score gaps up to {gap}")
    check(calls == (17, 12, 12), f"DINO 480x640 K1, K3, K5 launches {calls},"
                                 " expected 17, 12, 12")


def dino_serving_phase(cuda_attention, cuda_msda, dino, cfg) -> dict:
    """The serving path: the served detector in bf16 at batch 2 on an
    800x1333 canvas, against fp32 on the same weights up to the encoder
    output; 10 batches timed, one forward profiled."""
    det = dino.build_dino_from_config(
        cfg, resolution=DINO_CANVAS,
        generator=torch.Generator().manual_seed(33)).eval()
    gen = torch.Generator(device="cuda").manual_seed(34)
    x = torch.randn(DINO_BATCH, 3, *DINO_CANVAS, device="cuda", generator=gen)
    with torch.no_grad():
        enc = det.transformer.encode(det.project(det.features(x)))
        ref = {k: enc[k] for k in ("memory", "enc_logits")}
        del enc
        det16 = det.to(torch.bfloat16)  # the same weights, now bf16
        x16 = x.bfloat16()
        del x
        reset_launches(cuda_attention, cuda_msda)
        with RouteLog(cuda_attention) as routes:
            out = det16(x16)
            torch.cuda.synchronize()
        routes.check(17, 0, "wgmma", f"DINO-4scale bf16 b{DINO_BATCH} "
                                     "forward")
        calls = detection_launches(cuda_attention, cuda_msda)
        post = dino.postprocess(out, torch.tensor([DINO_CANVAS] * DINO_BATCH,
                                                  device="cuda"))
        enc16 = det16.transformer.encode(det16.project(det16.features(x16)))
        gaps = {k: ((enc16[k].float() - v).norm() / v.norm()).item()
                for k, v in ref.items()}
        maxabs = {k: (enc16[k].float() - v).abs().max().item()
                  for k, v in ref.items()}
        del enc16, ref
    q, kc = det16.num_queries, det16.num_classes
    finite = all(bool(torch.isfinite(t).all()) for t in
                 out["logits"] + out["boxes"] + list(post.values()))
    print(f"DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} "
          f"{DINO_CANVAS[0]}x{DINO_CANVAS[1]}: K1, K3, K5 launches per "
          f"forward {calls}; bf16 vs fp32 up to the encoder output, "
          f"||bf16 - fp32|| / ||fp32||: "
          + ", ".join(f"{k} {v:.3e} (max|diff| {maxabs[k]:.3e})"
                      for k, v in gaps.items())
          + f" (tol {TOL_DINO_BF16}); decoder outputs and the "
          f"{post['boxes'].shape[1]} detections a image finite: {finite}")
    check(calls == (17, 12, 12), f"DINO serving K1, K3, K5 launches {calls}, "
                                 "expected 17, 12, 12")
    check(all(v <= TOL_DINO_BF16 for v in gaps.values()),
          f"DINO bf16 off fp32: {gaps}")
    check(finite and out["logits"][-1].shape == (DINO_BATCH, q, kc)
          and out["boxes"][-1].shape == (DINO_BATCH, q, 4)
          and post["boxes"].shape == (DINO_BATCH, 300, 4),
          "DINO bf16 outputs finite, of the expected shapes")
    del out, post

    run = lambda: det16(x16)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(10):
            run()
        end.record()
        end.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 10
        ms = start.elapsed_time(end) / 10
        peak = torch.cuda.max_memory_allocated()
    smi = card()
    print(f"DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} "
          f"{DINO_CANVAS[0]}x{DINO_CANVAS[1]} eager: {ms:.3f} ms per batch "
          f"(CUDA events over 10 batches after 2; host {wall_ms:.3f} ms), "
          f"{DINO_BATCH * 1000 / ms:.2f} img/s; peak memory "
          f"{peak / 2**20:.1f} MiB [{smi}]")
    with torch.no_grad():
        profile_device(run, 1, f"DINO-4scale faster_vit_4_21k_224 bf16 "
                       f"b{DINO_BATCH} 800x1333 forward", ms, smi,
                       "dino_profile.json")
    del det16, x16
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": calls, "ms": ms, "peak": peak}


def dino_cli_phase(cuda_attention, cuda_msda, dino, detection_cli,
                   cfg) -> None:
    """The detection CLI on the card from a reference-layout checkpoint
    (the shared heads under both of their names, and upstream's denoising
    label embedding, which the port reports and skips); then the route of
    DINO-4scale on faster_vit_0_224 at 800x1333."""
    records = _Records()
    pkg_log = logging.getLogger("fastervit_tpu_torch")
    prev_level = pkg_log.level
    pkg_log.addHandler(records)
    pkg_log.setLevel(logging.INFO)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            src = dino.build_dino_from_config(
                cfg, resolution=(800, 800),
                generator=torch.Generator().manual_seed(35))
            sd = {k: v.cpu() for k, v in src.state_dict().items()}
            del src
            sd["label_enc.weight"] = torch.randn(92, 256)
            heads = sum(k.startswith(("bbox_embed.", "class_embed.",
                                      "transformer.decoder.bbox_embed.",
                                      "transformer.decoder.class_embed."))
                        for k in sd)
            path = Path(tmp) / "dino_4scale_faster_vit_4_21k_224.pth"
            torch.save({"model": sd}, path)
            del sd
            write_s = time.perf_counter() - t0
            reset_launches(cuda_attention, cuda_msda)
            t0 = time.perf_counter()
            stats = detection_cli.main([
                "--config", str(REPO / DINO_CONFIG), "--eval", "--synthetic",
                "--image-size", "800", "--dtype", "bfloat16",
                "--checkpoint", str(path), "--output", str(Path(tmp) / "out")])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            calls = detection_launches(cuda_attention, cuda_msda)
            written = json.loads((Path(tmp) / "out" / "eval.json").read_text())
    finally:
        pkg_log.removeHandler(records)
        pkg_log.setLevel(prev_level)
    warned = [m for m in records.messages
              if m.startswith(("missing keys", "unexpected keys",
                               "shape-mismatched"))]
    print(f"detection CLI (--eval --synthetic, {DINO_CONFIG}, 800x800, bf16, "
          f"2 batches of 2) from a reference-layout .pth ({heads} shared-head "
          f"keys, written in {write_s:.1f} s): {cli_s:.1f} s; load warnings "
          f"{warned}; K1, K3, K5 launches {calls}; eval.json {written}")
    check(warned == ["unexpected keys in source state_dict: label_enc.weight"],
          f"checkpoint load warnings {warned}")
    check(calls == (34, 24, 24), f"CLI K1, K3, K5 launches {calls}, expected "
                                 "34, 24, 24")
    check(json.dumps(written) == json.dumps(stats)
          and {"mAP", "AP50", "AR100"} <= set(written),
          f"eval.json {written}")

    cfg0 = type(cfg).fromfile(REPO / "configs/dino/"
                                     "dino_4scale_faster_vit_0_224.py")
    det0 = dino.build_dino_from_config(
        cfg0, resolution=DINO_CANVAS, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(36)).eval()
    gen = torch.Generator(device="cuda").manual_seed(37)
    x = torch.randn(DINO_BATCH, 3, *DINO_CANVAS, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    with torch.no_grad():
        reset_launches(cuda_attention, cuda_msda)
        out = det0(x)
        torch.cuda.synchronize()
        calls = detection_launches(cuda_attention, cuda_msda)
    finite = all(bool(torch.isfinite(t).all())
                 for t in out["logits"] + out["boxes"])
    print(f"DINO-4scale faster_vit_0_224 bf16 b{DINO_BATCH} 800x1333: K1, "
          f"K3, K5 launches per forward {calls}; outputs finite: {finite}")
    check(calls == (11, 6, 12), f"fv0 DINO K1, K3, K5 launches {calls}, "
                                "expected 11, 6, 12")
    check(finite, "fv0 DINO outputs finite")
    del det0, x, out
    gc.collect()
    torch.cuda.empty_cache()


def hat_inputs(b, s, h, c, gen, dtype=torch.float32, learned=True):
    """x (B, S, C), the params of ops.hat_block.PARAM_ORDER (matrices
    (out, in), scaled by 1/sqrt(fan in)) and a bias (H, S, S) on the card,
    all in `dtype`; γ learned or ones."""
    hidden = 4 * c

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    def u(n, shift=0.0):
        return torch.rand(n, device="cuda", generator=gen) + shift

    params = {"ln1_scale": u(c, 0.5), "ln1_bias": r(c, scale=0.1),
              "qkv_w": r(3 * c, c, scale=c ** -0.5),
              "qkv_b": r(3 * c, scale=0.05),
              "proj_w": r(c, c, scale=c ** -0.5), "proj_b": r(c, scale=0.05),
              "gamma3": u(c) if learned else torch.ones(c, device="cuda"),
              "ln2_scale": u(c, 0.5), "ln2_bias": r(c, scale=0.1),
              "fc1_w": r(hidden, c, scale=c ** -0.5),
              "fc1_b": r(hidden, scale=0.05),
              "fc2_w": r(c, hidden, scale=hidden ** -0.5),
              "fc2_b": r(c, scale=0.05),
              "gamma4": u(c) if learned else torch.ones(c, device="cuda")}
    x, bias = r(b, s, c), r(h, s, s)
    return (x.to(dtype), {k: v.to(dtype) for k, v in params.items()},
            bias.to(dtype))


def composed_sub_block(attention, x, p, bias, h, scale):
    """The port's composed HAT sub-block (models.layers.HAT._sub_block with
    the switch off): LayerNorm, cuBLAS products, K1, GELU and elementwise
    passes."""
    c = x.shape[-1]
    F = torch.nn.functional
    y = F.layer_norm(x, (c,), p["ln1_scale"], p["ln1_bias"], 1e-5)
    y = attention.window_mhsa(F.linear(y, p["qkv_w"], p["qkv_b"]), bias, h,
                              scale)
    x = x + p["gamma3"] * F.linear(y, p["proj_w"], p["proj_b"])
    y = F.layer_norm(x, (c,), p["ln2_scale"], p["ln2_bias"], 1e-5)
    y = F.linear(F.gelu(F.linear(y, p["fc1_w"], p["fc1_b"])), p["fc2_w"],
                 p["fc2_b"])
    return x + p["gamma4"] * y


def drop_masks(b, gen, keep=0.6):
    """Two (B,) DropPath scales (0 or 1/keep), each with a zero in it."""
    masks = []
    for _ in range(2):
        m = (torch.rand(b, device="cuda", generator=gen) < keep).float()
        m[0] = 0.0
        masks.append(m / keep)
    return masks


def ptxas_k6_instances(log: str) -> list:
    """[{instance, served, registers, spill_stores, static_smem}] for each
    hat_block_tc_kernel<HAS_DP> (K6's tensor-core route) that nvcc's
    -Xptxas -v log reports, each printed; the instance without DropPath is
    the served one (set_fused_hat's forwards)."""
    def describe(name):
        args = re.search(r"hat_block_tc_kernelILb([01])E", name)
        if args is None:
            return None
        return {"instance": f"<HAS_DP {args[1]}>", "served": args[1] == "0"}

    out = ptxas_entries(log, describe)
    for i in out:
        print(f"  ptxas: hat_block_tc_kernel{i['instance']}: "
              f"{i['registers']} registers, {i['spill_stores']} bytes of "
              f"spill stores{' (served)' if i['served'] else ''}")
    return out


def k6_refuses_wrong_plans(cuda_hat_block, gen) -> None:
    """K6's C entry point, handed each wrong plan below in place of
    cuda_hat_block.plan's, refuses it: the call raises and counts no
    launch."""
    kernel = cuda_hat_block.hat_block_cuda
    b, s, h, c = 4, 16, 8, 256
    tc = cuda_hat_block.plan(b, s, c, 4 * c, h, True)
    sc = cuda_hat_block.plan(b, s, c, 4 * c, h, False)
    wrong = [(torch.float32, tc, "the tensor cores for f32"),
             (torch.bfloat16, tc._replace(stages=2), "a ring of 2 slots"),
             (torch.bfloat16, tc._replace(stages=9), "a ring of 9 slots"),
             (torch.bfloat16, tc._replace(warpgroups=3), "3 warpgroups"),
             (torch.bfloat16, tc._replace(smem_bytes=tc.smem_bytes + 16),
              "a wrong shared-memory figure"),
             (torch.bfloat16, tc._replace(windows_per_block=5),
              "80 tokens a block"),
             (torch.float32, sc._replace(stages=3), "a scalar plan with a "
                                                    "ring")]
    make = cuda_hat_block.plan
    try:
        for dtype, plan, what in wrong:
            x, p, bias = hat_inputs(b, s, h, c, gen, dtype)
            cuda_hat_block.plan = lambda *_: plan
            before = kernel.launches
            try:
                kernel(x, p, bias, h, 0.1)
                refused = False
            except RuntimeError as err:
                refused = "hat_block" in str(err)
            check(refused and kernel.launches == before,
                  f"K6 ran the plan {tuple(plan)} ({what}), which its C "
                  "entry point must refuse")
    finally:
        cuda_hat_block.plan = make
    torch.cuda.synchronize()
    print(f"K6's C entry point refuses {len(wrong)} wrong plans ("
          + ", ".join(w for *_, w in wrong) + "), each counting no launch")


def k6_phase(cuda_hat_block, hat_block, attention, ptx_log: str) -> dict:
    """K6 against its plain version in fp32 and bf16 at FasterViT-0's
    batch-256 sites and odd shapes, γ learned and ones, the DropPath
    instantiation at the joint site, two launches bit-identical, every bf16
    fv0 site on the tensor-core route; wrong plans refused; ptxas of the
    tensor-core instances (no spills in the served one); K6, the plain
    version and the composed sub-block timed at the fv0 sites."""
    kernel = cuda_hat_block.hat_block_cuda
    plain = hat_block.hat_block_reference
    lib = cuda_hat_block.cuda_attention._library()
    gen = torch.Generator(device="cuda").manual_seed(40)
    instances = ptxas_k6_instances(ptx_log)
    check(len(instances) == 2, f"ptxas reports {len(instances)} K6 "
                               "tensor-core instances, expected 2")
    for i in instances:
        check(not (i["served"] and i["spill_stores"]),
              f"K6's served instance {i['instance']} spills "
              f"{i['spill_stores']} bytes")
    k6_refuses_wrong_plans(cuda_hat_block, gen)

    def plan_of_launch(s, h, c):
        """The plan K6 just launched with, held against the kernel's own
        shared-memory figure."""
        pl = kernel.last_plan
        smem = lib.hat_block_smem_bytes(s, c, h, pl.windows_per_block,
                                        int(pl.tensor_cores), pl.stages)
        check(smem == pl.smem_bytes, f"K6's plan at S={s} H={h} C={c} counts "
                                     f"{pl.smem_bytes} bytes, the kernel {smem}")
        return pl

    err32_all = err16_all = abs16_all = 0.0
    ms_fwd = plain_fwd = composed_fwd = bound_fwd = 0.0
    per_call = []
    for b, s, h, c, calls in K6_FV0_SITES + K6_ODD:
        scale = (c // h) ** -0.5
        if b == 0:
            x, p, bias = hat_inputs(b, s, h, c, gen)
            before = kernel.launches
            out = kernel(x, p, bias, h, scale)
            print(f"K6 hat_block B=0 S={s} H={h} C={c}: output "
                  f"{tuple(out.shape)}, launches {kernel.launches - before}")
            check(out.shape == (0, s, c) and kernel.launches == before,
                  "K6 on an empty batch launches nothing")
            continue
        for learned in ((True, False) if calls else (True,)):
            x, p, bias = hat_inputs(b, s, h, c, gen, learned=learned)
            got = kernel(x, p, bias, h, scale)
            plan32 = plan_of_launch(s, h, c)
            want = plain(x, p, bias, h, scale, attn_impl="plain")
            err32 = rel_err(got, want)
            x16, bias16 = x.bfloat16(), bias.bfloat16()
            p16 = {k: v.bfloat16() for k, v in p.items()}
            got16 = kernel(x16, p16, bias16, h, scale)
            plan16 = plan_of_launch(s, h, c)
            want16 = plain(x16, p16, bias16, h, scale, attn_impl="plain")
            err16 = rel_err(got16, want16)
            abs16 = ((got16.float() - want16.float()).abs().max().item()
                     if b else 0.0)
            same = (torch.equal(kernel(x, p, bias, h, scale), got)
                    and torch.equal(kernel(x16, p16, bias16, h, scale),
                                    got16))
            torch.cuda.synchronize()
            print(f"K6 hat_block B={b} S={s} H={h} C={c} γ "
                  f"{'learned' if learned else 'ones'}: max|err| / max(1, "
                  f"max|plain|) fp32 {err32:.3e} (tol {TOL_K6_FP32}), bf16 "
                  f"{err16:.3e} (tol {TOL_K6_BF16}); two launches "
                  f"bit-identical: {same}; plan fp32 {tuple(plan32)}, bf16 "
                  f"{tuple(plan16)} (route, windows a block, ring stages, "
                  "warpgroups, smem bytes)")
            check(err32 <= TOL_K6_FP32, f"K6 fp32 error {err32} at "
                                        f"{(b, s, h, c)}")
            check(err16 <= TOL_K6_BF16, f"K6 bf16 error {err16} at "
                                        f"{(b, s, h, c)}")
            check(same, f"K6 launches differ at {(b, s, h, c)}")
            check(got.shape == (b, s, c) and got16.dtype == torch.bfloat16,
                  f"K6 output at {(b, s, h, c)}")
            err32_all, err16_all = max(err32_all, err32), max(err16_all,
                                                              err16)
            abs16_all = max(abs16_all, abs16)
        if not calls:
            continue
        check(plan16.route == "wgmma"
              and plan16.stages >= cuda_hat_block.MIN_STAGES,
              f"K6 bf16 at the fv0 site {(b, s, h, c)} runs {tuple(plan16)}, "
              "not the tensor-core route with a ring of 3 or more slots")
        # the serving path's dtypes, in turns; the composed sub-block is
        # the yardstick (no single PyTorch call computes a HAT sub-block)
        hidden, hd = 4 * c, c // h
        plain_ms, ms, composed_ms = in_turns(
            lambda: plain(x16, p16, bias16, h, scale, attn_impl="plain"),
            lambda: kernel(x16, p16, bias16, h, scale),
            lambda: composed_sub_block(attention, x16, p16, bias16, h,
                                       scale))
        gap = rel_err(composed_sub_block(attention, x16, p16, bias16, h,
                                         scale), got16)
        flops = (2.0 * b * s * c * (4 * c + 2 * hidden)
                 + 4.0 * b * h * s * s * hd)
        nbytes = 2 * (2 * b * s * c + sum(v.numel() for v in p16.values())
                      + bias16.numel())
        bound = bound_ms(nbytes, flops)
        ms_fwd += calls * ms
        plain_fwd += calls * plain_ms
        composed_fwd += calls * composed_ms
        bound_fwd += calls * bound
        per_call.append({"B": b, "S": s, "H": h, "C": c, "calls": calls,
                         "plan": plan16._asdict(),
                         "ms": ms, "plain_ms": plain_ms,
                         "composed_ms": composed_ms, "bound_ms": bound,
                         "gflop": flops / 1e9, "mb": nbytes / 1e6})
        print(f"K6 hat_block B={b} S={s} H={h} C={c} bf16: kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, composed sub-block "
              f"{composed_ms:.4f} ms, bound {bound:.4f} ms ({flops / 1e9:.1f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB; {flops / ms / 1e9:.1f} TFLOP/s) "
              f"per call; composed vs K6 {gap:.3e}")

    # the DropPath instantiation at the joint site, masks with zeros
    b, s, h, c, _ = K6_FV0_SITES[1]
    scale = (c // h) ** -0.5
    dp1, dp2 = drop_masks(b, gen)
    for dtype, tol in ((torch.float32, TOL_K6_FP32),
                       (torch.bfloat16, TOL_K6_BF16)):
        x, p, bias = hat_inputs(b, s, h, c, gen, dtype)
        got = kernel(x, p, bias, h, scale, dp1, dp2)
        err = rel_err(got, plain(x, p, bias, h, scale, dp1, dp2,
                                 attn_impl="plain"))
        same = torch.equal(kernel(x, p, bias, h, scale, dp1, dp2), got)
        torch.cuda.synchronize()
        print(f"K6 hat_block (DropPath) B={b} S={s} H={h} C={c} {dtype}: "
              f"max|err| / max(1, max|plain|) {err:.3e} (tol {tol}); two "
              f"launches bit-identical: {same}")
        check(err <= tol and same, f"K6 DropPath {dtype}: {err}, {same}")
    print(f"K6 hat_block over one fv0 bf16 b{BATCH} forward's 17 calls: "
          f"kernel {ms_fwd:.4f} ms, plain {plain_fwd:.4f} ms, composed "
          f"sub-blocks {composed_fwd:.4f} ms, bound {bound_fwd:.4f} ms")
    return {"name": "hat_block", "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/hat_block.cu",
            "replaces": "fastervit_tpu/ops/pallas_hat_block.py:259",
            "launches": None, "max_abs_err": abs16_all,
            "max_rel_err_bf16": err16_all, "max_rel_err_fp32": err32_all,
            "ms": ms_fwd, "plain_ms": plain_fwd, "bound_ms": bound_fwd,
            "bound_by": "operations", "library_ms": None,
            "composed_ms": composed_fwd,
            "library": "none: no single PyTorch call computes a HAT "
                       "sub-block; composed_ms is the port's composed "
                       "sub-block (LayerNorm, cuBLAS, K1, elementwise)",
            "per": f"one fv0 bf16 b{BATCH} forward (17 calls)",
            "per_call": per_call}


def fused_fp32_phase(fvt, cuda_attention, cuda_hat_block) -> None:
    """faster_vit_0_224 fp32 b4 with the fused block on: the card (K6)
    against the CPU (the plain version), and against the card's composed
    path."""
    model_cpu = fvt.create_model("faster_vit_0_224", device="cpu",
                                 generator=torch.Generator().manual_seed(41))
    model_cpu.eval()
    model = copy.deepcopy(model_cpu).to("cuda")
    x = torch.randn(4, 3, 224, 224,
                    generator=torch.Generator().manual_seed(42))
    prev = fvt.set_fused_hat(True)
    try:
        with torch.no_grad():
            want = model_cpu(x)
            k6 = cuda_hat_block.hat_block_cuda.launches
            before = launches(cuda_attention)
            got = model(x.to("cuda"))
            torch.cuda.synchronize()
            k6 = cuda_hat_block.hat_block_cuda.launches - k6
            calls = tuple(a - b for a, b in zip(launches(cuda_attention),
                                                before))
    finally:
        fvt.set_fused_hat(prev)
    with torch.no_grad():
        composed = model(x.to("cuda"))
    err = (got.cpu() - want).abs().max().item()
    gap = (got - composed).abs().max().item()
    print(f"fv0 fp32 b4, fused block on: card (K6) vs CPU (plain) max"
          f"|dlogits| {err:.3e} (tol {TOL_MODEL_FP32}); vs the card's "
          f"composed path {gap:.3e}; K6 launches {k6}, K1, K2, K3, K4 "
          f"{calls}")
    check(got.shape == (4, 1000) and bool(torch.isfinite(got).all()),
          "fused fp32 logits finite, (4, 1000)")
    check(err <= TOL_MODEL_FP32, f"fused fp32 logits error {err}")
    check(gap <= TOL_MODEL_FP32, f"fused vs composed fp32 logits {gap}")
    check(k6 == 17 and calls == (0, 0, 0, 0),
          f"fused fp32 launches K6 {k6}, K1-K4 {calls}, expected 17 K6")


def fused_serving_phase(fvt, cuda_attention, cuda_msda,
                        cuda_hat_block) -> dict:
    """The serving path with the fused block: faster_vit_0_224 bf16 b256,
    set_fused_hat(True): 17 K6 and no other kernel's launch a forward,
    logits against fp32 on the same weights, timed in turns with the
    switch off, launches a forward from torch.profiler both ways, peak
    memory, one forward profiled; then a baked forward."""
    model = fvt.create_model("faster_vit_0_224",
                             generator=torch.Generator().manual_seed(43))
    model.eval()
    gen = torch.Generator(device="cuda").manual_seed(44)
    x = torch.randn(BATCH, 3, 224, 224, device="cuda", generator=gen)
    with torch.no_grad():
        ref = model(x)
    model16 = model.to(torch.bfloat16)  # the same weights, now bf16
    x16 = x.bfloat16()
    del x
    run = lambda: model16(x16)
    prev = fvt.set_fused_hat(True)
    try:
        with torch.no_grad():
            reset_launches(cuda_attention, cuda_msda)
            cuda_hat_block.hat_block_cuda.launches = 0
            logits = run()
            torch.cuda.synchronize()
            k6 = cuda_hat_block.hat_block_cuda.launches
            others = launches(cuda_attention) + (
                cuda_msda.ms_deform_attn_cuda.launches,)
            gap = (logits.float() - ref).abs().max().item()
            print(f"fv0 bf16 b{BATCH}, fused block on: K6 launches {k6}; "
                  f"K1, K2, K3, K4, K5 {others}; max|bf16 - fp32 logits| "
                  f"{gap:.4f} (tol {TOL_MODEL_BF16})")
            check(k6 == 17 and others == (0, 0, 0, 0, 0),
                  f"fused serving launches K6 {k6}, K1-K5 {others}")
            check(logits.shape == (BATCH, 1000)
                  and bool(torch.isfinite(logits).all()),
                  f"fused bf16 logits finite, ({BATCH}, 1000)")
            check(gap <= TOL_MODEL_BF16, f"fused bf16 logits off fp32 by "
                                         f"{gap}")
            # on, off, off, on; peak memory of each
            times, peaks = {True: [], False: []}, {}
            for on in (True, False, False, True):
                fvt.set_fused_hat(on)
                torch.cuda.reset_peak_memory_stats()
                times[on].append(time_ms(run, iters=20, warmup=5))
                peaks[on] = torch.cuda.max_memory_allocated()
            on_ms, off_ms = (sum(times[k]) / 2 for k in (True, False))
            smi = card()
            print(f"fv0 bf16 b{BATCH} eager, fused block on: {on_ms:.3f} ms "
                  f"per batch ({times[True][0]:.3f}, {times[True][1]:.3f}), "
                  f"{BATCH * 1000 / on_ms:.1f} img/s, peak memory "
                  f"{peaks[True] / 2**20:.1f} MiB; off (composed, K1): "
                  f"{off_ms:.3f} ms ({times[False][0]:.3f}, "
                  f"{times[False][1]:.3f}), {BATCH * 1000 / off_ms:.1f} img/s, "
                  f"peak {peaks[False] / 2**20:.1f} MiB [{smi}]")
            prof = {}
            for on, ms, name in ((False, off_ms, "composed_serve_profile"),
                                 (True, on_ms, "fused_serve_profile")):
                fvt.set_fused_hat(on)
                prof[on] = profile_device(
                    run, 1, f"fv0 bf16 b{BATCH} fused-"
                    f"{'on' if on else 'off'} forward", ms, smi,
                    f"{name}.json")
            if prof[True] and prof[False]:
                print(f"kernel launches a forward (torch.profiler): fused "
                      f"on {prof[True]['launches']:.0f}, off "
                      f"{prof[False]['launches']:.0f}; device busy "
                      f"{100 * prof[True]['busy']:.1f}% on, "
                      f"{100 * prof[False]['busy']:.1f}% off")
            # deploy mode with the switch on
            fvt.bake_posemb(model16)
            cuda_hat_block.hat_block_cuda.launches = 0
            baked = run()
            torch.cuda.synchronize()
            same = torch.equal(baked, logits)
            print(f"fv0 bf16 b{BATCH}, fused block on, baked: K6 launches "
                  f"{cuda_hat_block.hat_block_cuda.launches}; logits "
                  f"bit-identical to live: {same}")
            check(same and cuda_hat_block.hat_block_cuda.launches == 17,
                  "baked fused forward")
    finally:
        fvt.set_fused_hat(prev)
    del model16, x16, logits, ref, baked
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": k6, "ms": on_ms, "off_ms": off_ms,
            "peak": peaks[True], "peak_off": peaks[False],
            "profile": prof}


def k6_dp_grad_phase(cuda_attention, cuda_hat_block, hat_block) -> None:
    """fused_hat_block_dp forward and backward at fv0's joint site, bf16
    and fp32, against autograd through the plain version: the output and
    the gradients of x, every param, the bias, dp1 and dp2; K6, K1 and K2
    launches (the backward recomputes through K1 and K2)."""
    b, s, h, c, _ = K6_FV0_SITES[1]
    scale = (c // h) ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(45)
    names = ["x", "bias"] + list(hat_block.PARAM_ORDER) + ["dp1", "dp2"]
    for dtype, tol in ((torch.bfloat16, TOL_K6_GRAD_BF16),
                       (torch.float32, TOL_K6_GRAD_FP32)):
        x, p, bias = hat_inputs(b, s, h, c, gen, dtype)
        dps = drop_masks(b, gen)
        g = torch.randn(b, s, c, device="cuda", generator=gen).to(dtype)

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_() for t in
                      [x, bias] + [p[k] for k in hat_block.PARAM_ORDER]
                      + dps]
            xx, bb, *rest = leaves
            out = fn(xx, dict(zip(hat_block.PARAM_ORDER, rest[:14])), bb,
                     *rest[14:])
            return [out] + list(torch.autograd.grad(out, leaves, g))

        before = (cuda_hat_block.hat_block_cuda.launches,
                  cuda_attention.window_mhsa_cuda.launches,
                  cuda_attention.window_mhsa_backward_cuda.launches)
        with RouteLog(cuda_attention) as routes:
            got = grads(lambda xx, pp, bb, d1, d2:
                        hat_block.fused_hat_block_dp(xx, pp, bb, d1, d2, h,
                                                     scale))
            torch.cuda.synchronize()
        routes.check(1, 1, "wgmma" if dtype == torch.bfloat16 else "scalar",
                     f"fused_hat_block_dp {dtype}")
        calls = tuple(a - b_ for a, b_ in zip(
            (cuda_hat_block.hat_block_cuda.launches,
             cuda_attention.window_mhsa_cuda.launches,
             cuda_attention.window_mhsa_backward_cuda.launches), before))
        want = grads(lambda xx, pp, bb, d1, d2: hat_block.hat_block_reference(
            xx, pp, bb, h, scale, d1, d2, attn_impl="plain"))
        errs = {n: rel_to_largest(a, e)
                for n, a, e in zip(["out"] + names, got, want)}
        worst = max(errs, key=errs.get)
        print(f"fused_hat_block_dp B={b} S={s} H={h} C={c} {dtype}, forward "
              f"and backward vs autograd through the plain version, max|err| "
              f"/ max|plain| (tol {tol}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; K6, K1, K2 launches {calls}")
        check(all(v <= tol for v in errs.values()),
              f"fused_hat_block_dp {dtype}: {worst} off by {errs[worst]}")
        check(calls == (1, 1, 1), f"fused_hat_block_dp launches {calls}, "
                                  "expected 1 K6, 1 K1, 1 K2")
        del got, want
    gc.collect()
    torch.cuda.empty_cache()


def probe_phase(cuda_attention, attention_probes, probe_modules,
                ptx_log: str) -> tuple:
    """P1 and P2 against their plain versions on the card, fp32 and bf16
    (P1 at C = 1, 2, 4 and with f32 and bf16 bias; P2 on separate q, k, v
    and on views of one packed qkv, K3's layout), two launches
    bit-identical; kernel, plain version, SDPA and bound timed at the
    probes' call in turns; then the probes' main path: attn_vpu_probe and
    attn_online_probe run through their main at the default geometry, every
    kernel's count set to 0 just before and read just after."""
    p1 = cuda_attention.online_attention_cuda
    p2 = cuda_attention.nobias_attention_cuda
    plains = {"P1": attention_probes.online_attention_reference,
              "P2": attention_probes.nobias_attention_reference}
    instances = {
        "P1": ptxas_instances(ptx_log, "attn_online_tc_kernel",
                              cuda_attention),
        "P2": [i for i in ptxas_instances(ptx_log,
                                          "window_mhsa_long_tc_kernel",
                                          cuda_attention)
               if i["instance"].startswith("no bias")]}
    print_instances("P1 attn_online_tc_kernel", instances["P1"])
    print_instances("P2 window_mhsa_long_tc_kernel", instances["P2"])
    gen = torch.Generator(device="cuda").manual_seed(50)
    errs = {"P1": [0.0, 0.0], "P2": [0.0, 0.0]}  # fp32, bf16 (absolute)
    for name, kernel, shapes in (("P1", p1, P1_SHAPES), ("P2", p2,
                                                          P2_SHAPES)):
        for b, s, h, d in shapes:
            q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                       for _ in range(3))
            bias = torch.randn(h, s, s, device="cuda", generator=gen)
            scale = d ** -0.5
            calls = []  # (bf16?, arguments after q, k, v)
            for half in (False, True):
                if name == "P2":
                    calls.append((half, (scale,)))
                    continue
                for bias_in in ((bias, bias.bfloat16()) if half else (bias,)):
                    calls += [(half, (bias_in, scale, c)) for c in PROBE_CHUNKS
                              if s % c == 0]
            err = [0.0, 0.0]
            limit = TOL_PROBE_BF16  # the tightest bf16 limit at this shape
            for half, rest in calls:
                qkv = [t.bfloat16() for t in (q, k, v)] if half else (q, k, v)
                want = plains[name](*qkv, *rest)
                layouts = [qkv]
                if name == "P2":  # and on views of one packed qkv
                    layouts.append(attention_probes.qkv_views(
                        attention_probes.pack_qkv(*qkv), h))
                for inputs in layouts:
                    before = kernel.launches
                    got = kernel(*inputs, *rest)
                    torch.cuda.synchronize()
                    if b:
                        check_plan(kernel, cuda_attention, half, d,
                                   rest[0].dtype if name == "P1" else None,
                                   f"{name} at {(b, s, h, d)}, "
                                   f"{'bf16' if half else 'fp32'}")
                    # the output keeps the inputs' order of axes: K3's
                    # (B, S, H·hd) for the packed views
                    dense = (got if inputs is qkv
                             else got.transpose(1, 2)).is_contiguous()
                    check(got.shape == want.shape and got.dtype == want.dtype
                          and dense, f"{name} output at {(b, s, h, d)}")
                    if not b:
                        check(kernel.launches == before,
                              f"{name} launched on an empty batch")
                        continue
                    e = (got.float() - want.float()).abs().max().item()
                    err[half] = max(err[half], e)
                    if half:
                        tol = min(TOL_PROBE_BF16, TOL_PROBE_BF16_REL
                                  * want.float().abs().max().item())
                        limit = min(limit, tol)
                        check(e <= tol, f"{name} bf16 error {e} over {tol} "
                                        f"at {(b, s, h, d)}, {rest[1:]}")
                    del got
                del want, layouts
            print(f"{name} {kernel.__name__} B={b} S={s} H={h} hd={d}"
                  + (" (the probes' call)" if (b, s, h, d) == PROBE_SHAPE
                     else "")
                  + (f" C in {[c for c in PROBE_CHUNKS if s % c == 0]}"
                     if name == "P1" else " (B, H, S, hd) and packed qkv")
                  + f": max|err| fp32 {err[0]:.3e} (tol {TOL_FP32}, scalar "
                  f"FMA), bf16 (wgmma, D "
                  f"{cuda_attention.long_plan(d, torch.bfloat16).qk_depth})"
                  + (" with f32 and bf16 bias" if name == "P1" else "")
                  + f" {err[1]:.3e} (tol {TOL_PROBE_BF16_REL:.4g} of each "
                  f"call's largest output, at most {TOL_PROBE_BF16}; "
                  f"tightest here {limit:.3e})")
            check(err[0] <= TOL_FP32, f"{name} fp32 error {err[0]} at "
                                      f"{(b, s, h, d)}")
            errs[name] = [max(a, e) for a, e in zip(errs[name], err)]
            del q, k, v, bias

    # the probes' call in bf16 with a bf16 bias: two launches bit-identical,
    # then kernel, plain version and SDPA in turns beside the bound
    b, s, h, d = PROBE_SHAPE
    q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    bias = torch.randn(h, s, s, device="cuda", generator=gen,
                       dtype=torch.bfloat16)
    scale = d ** -0.5
    for name, call in (("P1", lambda: p1(q, k, v, bias, scale, 2)),
                       ("P2", lambda: p2(q, k, v, scale))):
        same = torch.equal(call(), call())
        print(f"{name} at {PROBE_SHAPE} bf16: two launches bit-identical: "
              f"{same}")
        check(same, f"{name}'s two launches differ")
    flops = 4.0 * b * h * s * s * d
    nbytes = {"P2": 2 * 4 * q.numel()}
    nbytes["P1"] = nbytes["P2"] + 2 * bias.numel()
    timed = {}
    lib_p1, hd_p1 = sdpa_for(q, k, v, bias[None], scale)
    lib_p2, hd_p2 = sdpa_for(q, k, v, None, scale)
    lib_p1_ran = f"{sdpa_backend(lib_p1)}, q, k, v zero-padded to hd {hd_p1}"
    lib_p2_ran = f"{sdpa_backend(lib_p2)}, q, k, v zero-padded to hd {hd_p2}"
    for label, (plain, kernel, lib) in {
            **{f"P1 C={c}": (
                lambda c=c: plains["P1"](q, k, v, bias, scale, c),
                lambda c=c: p1(q, k, v, bias, scale, c), lib_p1)
               for c in PROBE_CHUNKS},
            "P2": (lambda: plains["P2"](q, k, v, scale),
                   lambda: p2(q, k, v, scale), lib_p2)}.items():
        plain_ms, ms, lib_ms = in_turns(plain, kernel, lib, iters=5)
        name = label.split()[0]
        check_plan(p1 if name == "P1" else p2, cuda_attention, True, d,
                   bias.dtype if name == "P1" else None,
                   f"{label} at {PROBE_SHAPE}")
        bound = bound_ms(nbytes[name], flops)
        timed[label] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound,
            "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                         > nbytes[name] / HBM_BYTES_PER_S else "bytes"),
            "tflop_s": flops / ms / 1e9}
        print(f"{label} at {PROBE_SHAPE} bf16"
              + (", bf16 bias" if name == "P1" else "")
              + f": kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes[name] / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP) "
              f"[{card()}]")
    print(f"SDPA ran: with the bias as a float mask {lib_p1_ran}; with no "
          f"mask {lib_p2_ran}")
    del q, k, v, bias, lib_p1, lib_p2
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: both probes at the default geometry, through main
    from fastervit_tpu_torch.ops import cuda_hat_block, cuda_msda
    counted = (cuda_attention.window_mhsa_cuda,
               cuda_attention.window_mhsa_backward_cuda,
               cuda_attention.window_mhsa_long_cuda,
               cuda_attention.window_mhsa_long_backward_cuda,
               cuda_msda.ms_deform_attn_cuda, cuda_hat_block.hat_block_cuda,
               cuda_msda.fused_gather_cuda, cuda_msda.fused_gather_p4_cuda,
               cuda_msda.fused_gather_per_head_cuda,
               cuda_msda.packed_gather_cuda, cuda_msda.pair_staticr_cuda,
               cuda_msda.packed_coeff_cuda, cuda_msda.packed_wide_cuda,
               p1, p2)
    for fn in counted:
        fn.launches = 0
    OUT_DIR.mkdir(exist_ok=True)
    results = [probe.main(["--out", str(OUT_DIR / (
        probe.__name__.rsplit(".", 1)[-1] + ".json"))])
        for probe in probe_modules]
    torch.cuda.synchronize()
    calls = [fn.launches for fn in counted]
    print(f"the probes' main path: K1-K6, P3a-c, P4a-d, P1, P2 launches "
          f"{calls}")
    check(calls[-2] > 0 and calls[-1] > 0, f"the probes launched P1 "
                                           f"{calls[-2]} and P2 {calls[-1]} "
                                           "times")
    for result in results:
        rows = {n: r for n, r in result.items()
                if isinstance(r, dict) and "ms" in r}
        check(result["device"]["type"] == "cuda" and bool(rows)
              and all(math.isfinite(r["ms"]) and r["ms"] > 0
                      for r in rows.values()),
              f"{result['probe']}: every row timed on the card")
        for n, r in rows.items():
            if "maxdiff_vs_shipped" in r:
                check(r["maxdiff_vs_shipped"] <= TOL_PROBE_BF16,
                      f"{n} off K3 by {r['maxdiff_vs_shipped']}")

    per = (f"one {PROBE_SHAPE} bf16 call (the long-window attention probes' "
           "21k-768 level-2 call)")
    p1_line = {"name": "attn_online", "route": "cuda",
               "source": "fastervit_tpu_torch/csrc/attn_online.cu",
               "replaces": "scripts/attn_online_probe.py:79",
               "launches": calls[-2], "max_abs_err": errs["P1"][1],
               "max_abs_err_fp32": errs["P1"][0],
               "kernel_route": {"bf16": "wgmma", "f32": "scalar"},
               "ptxas": instances["P1"],
               **timed["P1 C=2"],
               "library": ("scaled_dot_product_attention with the bias as a "
                           f"float mask ({lib_p1_ran})"),
               "per": per + ", bf16 bias, C = 2",
               "per_chunks": {label: t for label, t in timed.items()
                              if label.startswith("P1")},
               "launches_in": "the probes' main path (attn_online_probe)"}
    p2_line = {"name": "attn_nobias", "route": "cuda",
               "source": "fastervit_tpu_torch/csrc/window_mhsa_long.cu",
               "replaces": "scripts/attn_vpu_probe.py:135",
               "launches": calls[-1], "max_abs_err": errs["P2"][1],
               "max_abs_err_fp32": errs["P2"][0],
               "kernel_route": {"bf16": "wgmma", "f32": "scalar"},
               "ptxas": instances["P2"], **timed["P2"],
               "library": f"scaled_dot_product_attention ({lib_p2_ran})",
               "per": per + ", no bias",
               "launches_in": "the probes' main path (attn_vpu_probe)"}
    return p1_line, p2_line


def gather_out_of_range(t: torch.Tensor, edge: int,
                        gen: torch.Generator) -> torch.Tensor:
    """A copy of an int32 (M, QP) index tensor with about a thirty-second
    of its entries, and its first column, out of range: -1, `edge` (one
    past the last valid index), -2^31 or 2^31 - 1."""
    values = t.new_tensor([-1, edge, -2 ** 31, 2 ** 31 - 1])
    pick = torch.rand(t.shape, device="cuda", generator=gen) < 1 / 32
    pick[:, :1] = True  # so that every case has some
    which = torch.randint(0, len(values), t.shape, device="cuda",
                          generator=gen)
    return torch.where(pick, values[which], t)


def check_probe_plan(cuda_msda, kernel, mode: str, map_t: torch.Tensor,
                     what: str):
    """The wrapper's latest launch ran probe_plan's plan for map_t (one
    head's map, pair, packed or coeff, as it lies on the card); MOTR's
    width, D 32, on a 16-byte-aligned map loads 16-byte vectors. Returns the
    plan."""
    d = map_t.shape[-1] // (1 if mode == "pair" else 4)
    want = cuda_msda._probe_plan_for(mode, map_t, d)
    plan = kernel.last_plan
    check(plan == want, f"{what} ran plan {plan}, probe_plan gives {want}")
    if d == 32 and cuda_msda.pointer_alignment(map_t.data_ptr()) == 16:
        check(plan.vec * map_t.element_size() == 16,
              f"{what} at D 32 on {plan.vec}-element vectors")
    return plan


def probe_refuses_wrong_plans(cuda_msda, msda_probes, gen) -> None:
    """The C entry points of P3a-c and P4a-c, handed each plan of
    PROBE_WRONG_PLANS in place of probe_plan's, refuse it: the call raises
    and counts no launch."""
    kernels = {"P3a": cuda_msda.fused_gather_cuda,
               "P3b": cuda_msda.fused_gather_p4_cuda,
               "P4a": cuda_msda.packed_gather_cuda,
               "P4b": cuda_msda.pair_staticr_cuda,
               "P4c": cuda_msda.packed_coeff_cuda}
    make = cuda_msda.probe_plan
    try:
        for name, (hp, wp, d, dtype, offset), fields, what in (
                PROBE_WRONG_PLANS):
            case = list(msda_probes.sample_case(hp, wp, 400, 8, d, gen,
                                                "cuda"))
            if name in ("P4a", "P4c"):
                weights = (case[3:] if name == "P4a" else
                           msda_probes.coeff_scalars(*case[3:]))
                args = [msda_probes.pack_corners(case[0]).to(dtype),
                        case[1] * (wp - 1) + case[2], *weights, 4]
            else:
                args = [case[0].to(dtype), *case[1:]]
                args += [] if name == "P3a" else [4]
            if offset:
                args[0] = at_element_offset(args[0])
            cuda_msda.probe_plan = lambda *_: cuda_msda.ProbePlan(*fields)
            kernel = kernels[name]
            before = kernel.launches
            try:
                kernel(*args)
                refused = False
            except RuntimeError as err:
                refused = "msda_probe_" in str(err)
            check(refused and kernel.launches == before,
                  f"{name} ran plan {fields} ({what}), which its C entry "
                  "point must refuse")
    finally:
        cuda_msda.probe_plan = make
    torch.cuda.synchronize()
    print(f"the probes' C entry points refuse {len(PROBE_WRONG_PLANS)} wrong "
          "plans (" + "; ".join(w for *_, w in PROBE_WRONG_PLANS)
          + "), each counting no launch")


def msda_probe_phase(cuda_msda, msda_probes, probe_modules,
                     ptx_log: str) -> tuple:
    """The registers and spills of the vec kernel's 108 instances (pair,
    packed and coeff mode: P3a-c, P4a, P4b, P4c; P 1, 2, 4 × f32 V 1×1, 1×2,
    2, 4 and bf16 V 1×1, 1×2, 2, 4, 8; pair mode on route l2 and smem, the
    others on l2 alone; no spill in the 24 of D 32: f32 V 4 and bf16 V 8) and
    their C entry points' refusal of wrong plans; P3a, P3b, P3c and P4a
    against their plain versions on the card at GATHER_SHAPES, at P 1, 2, 4
    (P3b, P4a), P4a on f32 and bf16 packed maps, each case also with
    out-of-range samples (NaN at the same places), every launch's plan held to
    probe_plan; two launches bit-identical, the pair kernels on route smem at
    level 3 and l2 at level 0, 16-byte vectors, a map one element into its
    storage on V 1 with the aligned launch's bits; kernel, plain version, the
    grid_sample form and the bound timed in turns at levels 0 and 3; then the
    probes' main path: msda_pallas_probe and msda_packed_probe through their
    main at the default geometry, every kernel's count set to 0 just before
    and read just after. Returns the four kernels' lines and K5's launches on
    that path (the encoder call)."""
    instances = ptxas_probe_instances(ptx_log)
    d32 = {k: v for k, v in instances.items()
           if "float, V 4," in k or "bf16, V 8," in k}
    check(len(instances) == 108 and len(d32) == 24
          and all(not r["spill_stores"] for r in d32.values()),
          f"the probes' 108 instances in the ptxas log, the 24 of D 32 "
          f"without spills: {d32}")
    gen = torch.Generator(device="cuda").manual_seed(60)
    probe_refuses_wrong_plans(cuda_msda, msda_probes, gen)
    kernels = {"P3a": cuda_msda.fused_gather_cuda,
               "P3b": cuda_msda.fused_gather_p4_cuda,
               "P3c": cuda_msda.fused_gather_per_head_cuda,
               "P4a": cuda_msda.packed_gather_cuda}
    plains = {"P3a": msda_probes.gather_reference,
              "P3b": msda_probes.gather_p4_reference,
              "P3c": msda_probes.gather_reference,
              "P4a": msda_probes.packed_gather_reference}
    errs = dict.fromkeys(kernels, 0.0)
    timed = {name: {} for name in ("P3a", "P3b", "P3c", "P4a", "P4a bf16")}
    for index, (hp, wp, qp, m, d) in enumerate(GATHER_SHAPES):
        case = list(msda_probes.sample_case(hp, wp, qp, m, d, gen, "cuda"))
        pm = msda_probes.pack_corners(case[0])
        fl = case[1] * (wp - 1) + case[2]
        broken = [case[0], gather_out_of_range(case[1], hp - 1, gen),
                  gather_out_of_range(case[2], wp - 1, gen), *case[3:]]
        broken_fl = gather_out_of_range(fl, pm.shape[1], gen)
        for p3, p4_fl, label in ((case, fl, "in range"),
                                 (broken, broken_fl, "out of range")):
            runs = [("P3a", p3), ("P3c", p3)]
            runs += [("P3b", p3 + [p]) for p in GATHER_POINTS if qp % p == 0]
            runs += [("P4a", [packed, p4_fl, *p3[3:], p])
                     for packed in (pm, pm.bfloat16())
                     for p in GATHER_POINTS if qp % p == 0]
            worst = dict.fromkeys(kernels, 0.0)
            for name, args in runs:
                kernel = kernels[name]
                before = kernel.launches
                got, want = kernel(*args), plains[name](*args)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == torch.float32,
                      f"{name} output {tuple(got.shape)} at {hp}x{wp}")
                if not qp:
                    check(kernel.launches == before,
                          f"{name} launched on QP 0")
                    continue
                nan = torch.isnan(want)
                check(torch.equal(torch.isnan(got), nan),
                      f"{name} NaN elsewhere than its plain version's at "
                      f"{(hp, wp, qp, m, d)} {label}")
                check(bool(nan.any()) == (label == "out of range"),
                      f"{name} NaN only for out-of-range samples")
                err = ((got - want)[~nan].abs().max().item()
                       if bool((~nan).any()) else 0.0)
                check(err <= TOL_GATHER, f"{name} off its plain version by "
                                         f"{err} at {(hp, wp, qp, m, d)}")
                worst[name] = max(worst[name], err)
                check_probe_plan(
                    cuda_msda, kernel, "packed" if name == "P4a" else "pair",
                    args[0][-1] if name == "P3c" else args[0],
                    f"{name} at {(hp, wp, qp, m, d)}")
                del got, want
            print(f"P3a-c, P4a msda_probe Hp={hp} Wp={wp} QP={qp} M={m} D={d}"
                  f" {label} (P3b, P4a at P {GATHER_POINTS}, P4a f32 and "
                  f"bf16 map): max|err| {worst} (tol {TOL_GATHER}), NaN at "
                  "the plain versions' places, every plan probe_plan's")
            errs = {n: max(errs[n], worst[n]) for n in errs}
        del broken, broken_fl
        if index not in GATHER_TIMED:
            continue

        # a timed level: two launches bit-identical, then kernel, plain
        # version and the grid_sample form in turns, beside the bound
        vm, iy, ix, fy, fx, w = case
        pm16 = pm.bfloat16()
        vm_nchw = vm.permute(0, 3, 1, 2).contiguous()
        grid = gather_grid(iy, ix, fy, fx, hp, wp)
        level = f"{hp - 2}x{wp - 2}"
        rows = {  # label: (kernel's name, arguments, P, map bytes, scalars)
            "P3a": ("P3a", case, 1, vm.numel() * 4, 5),
            "P3b": ("P3b", case + [4], 4, vm.numel() * 4, 5),
            "P3c": ("P3c", case, 1, vm.numel() * 4, 5),
            "P4a": ("P4a", [pm, fl, fy, fx, w, 4], 4, pm.numel() * 4, 4),
            "P4a bf16": ("P4a", [pm16, fl, fy, fx, w, 4], 4,
                         pm16.numel() * 2, 4)}
        for label, (name, args, p, map_bytes, scalars) in rows.items():
            kernel, plain = kernels[name], plains[name]
            same = torch.equal(kernel(*args), kernel(*args))
            check(same, f"{label}'s two launches differ at {level}")
            plan = kernel.last_plan
            route = ("smem" if name != "P4a" and index == GATHER_TIMED[1]
                     else "l2")
            check(plan.route == route and plan.vec * (
                2 if label.endswith("bf16") else 4) == 16,
                  f"{label} at {level} ran {plan}: expected route {route} "
                  "on 16-byte vectors")
            plain_ms, ms, lib_ms = in_turns(
                lambda: plain(*args), lambda: kernel(*args),
                lambda: gather_grid_sample(vm_nchw, grid, w, p), iters=10)
            nbytes = gather_bytes(map_bytes, m, qp, d, p, scalars)
            # per sample: P3 1 - fx, 1 - fy and 10 ops a channel; P4a those
            # two, 6 corner-weight products and 7 ops a channel; then the
            # P sum
            per_sample = 2 + 10 * d if name != "P4a" else 8 + 7 * d
            flops = m * qp * per_sample + m * (qp // p) * (p - 1) * d
            by = ("operations" if flops / F32_FLOP_PER_S
                  > nbytes / HBM_BYTES_PER_S else "bytes")
            bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                              flops / F32_FLOP_PER_S)
            timed[label][level] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound, "bound_by": by,
                "ns_per_sample": ms * 1e6 / (m * qp),
                "plan": plan._asdict()}
            print(f"{label} at {level} (M {m}, QP {qp}, D {d}, P {p}): "
                  f"two launches bit-identical, plan {tuple(plan)}; kernel "
                  f"{ms:.4f} ms ({ms * 1e6 / (m * qp):.4f} ns a sample), "
                  f"plain {plain_ms:.4f} ms, grid_sample form {lib_ms:.4f} "
                  f"ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP f32, {by}) [{card()}]")
        # a map one element into its storage: V 1, the aligned launch's bits
        for name, mapped, rest in (("P3b", vm, case[1:] + [4]),
                                   ("P4a", pm, [fl, fy, fx, w, 4]),
                                   ("P4a", pm16, [fl, fy, fx, w, 4])):
            kernel = kernels[name]
            want = kernel(mapped, *rest)
            got = kernel(at_element_offset(mapped), *rest)
            plan = kernel.last_plan
            check(plan.vec == 1 and bits_equal(got, want),
                  f"{name} on a {mapped.dtype} map one element into its "
                  f"storage at {level}: plan {plan}, the aligned launch's "
                  f"bits {bits_equal(got, want)}")
            print(f"{name} at {level}, a {mapped.dtype} map one element into "
                  f"its storage: plan {tuple(plan)}, the aligned launch's "
                  "bits")
            del want, got
        del case, pm, pm16, fl, vm, iy, ix, fy, fx, w, vm_nchw, grid, rows
        gc.collect()
        torch.cuda.empty_cache()

    # the main path: both probes at the default geometry, through main
    from fastervit_tpu_torch.ops import cuda_attention, cuda_hat_block
    counted = {"K1": cuda_attention.window_mhsa_cuda,
               "K2": cuda_attention.window_mhsa_backward_cuda,
               "K3": cuda_attention.window_mhsa_long_cuda,
               "K4": cuda_attention.window_mhsa_long_backward_cuda,
               "K5": cuda_msda.ms_deform_attn_cuda,
               "K6": cuda_hat_block.hat_block_cuda,
               "P1": cuda_attention.online_attention_cuda,
               "P2": cuda_attention.nobias_attention_cuda, **kernels,
               "P4b": cuda_msda.pair_staticr_cuda,
               "P4c": cuda_msda.packed_coeff_cuda,
               "P4d": cuda_msda.packed_wide_cuda}
    for fn in counted.values():
        fn.launches = 0
    OUT_DIR.mkdir(exist_ok=True)
    results = [probe.main(["--out", str(OUT_DIR / (
        probe.__name__.rsplit(".", 1)[-1] + ".json"))])
        for probe in probe_modules]
    torch.cuda.synchronize()
    calls = {name: fn.launches for name, fn in counted.items()}
    print(f"the MSDA probes' main path: launches {calls}")
    check(all(calls[name] > 0 for name in ("K5", *kernels)),
          f"the MSDA probes launched K5, P3a-c and P4a {calls}")
    for result in results:
        levels = result["levels"]
        rows = [r for level in levels for r in level.values()
                if isinstance(r, dict)]
        check(result["device"]["type"] == "cuda" and len(levels) == 4
              and all(math.isfinite(r["ms"]) and r["ms"] > 0
                      and r["bound_ms"] > 0 for r in rows),
              f"{result['probe']}: every row of every level timed")
        check(all(e <= 1e-4 for e in result["correctness_max_err"].values()),
              f"{result['probe']} correctness {result['correctness_max_err']}")
        if "encoder_call" in result:
            enc = result["encoder_call"]
            check(enc["parity_max_abs_diff"] <= TOL_K5_FP32
                  and enc["ms_k5"] > 0,
                  f"the encoder call: K5 off its plain version by "
                  f"{enc['parity_max_abs_diff']}")

    per = ("one MOTR level-0 call (202x386 padded, M 8, QP 408,000, D 32, "
           "f32; P 4 for P3b and P4a)")
    library = ("F.grid_sample (bilinear, zeros, align_corners=True) of the "
               "padded map at the same samples, times w{}: one grid_sample "
               "and one or two elementwise passes, output left (M, D, QP/P)")
    lines = []
    for name, fn_name, replaces, extra in (
            ("P3a", "fused_gather", "scripts/msda_pallas_probe.py:102", {}),
            ("P3b", "fused_gather_p4", "scripts/msda_pallas_probe.py:165",
             {"launches_in": "the MSDA probes' main path (msda_pallas_probe "
                             "and msda_packed_probe's pair_p4)"}),
            ("P3c", "fused_gather_per_head",
             "scripts/msda_pallas_probe.py:221",
             {"per": per + "; M launches a call"}),
            ("P4a", "packed_gather", "scripts/msda_packed_probe.py:94",
             {"per": per + ", f32 packed map",
              "per_level_bf16_map": timed["P4a bf16"],
              "launches_in": "the MSDA probes' main path "
                             "(msda_packed_probe)"})):
        lines.append({
            "name": fn_name, "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/msda_probe.cu",
            "replaces": replaces, "launches": calls[name],
            "max_abs_err": errs[name], **timed[name]["200x384"],
            "library": library.format(", summed over P" if name in (
                "P3b", "P4a") else ""),
            "per": per, "per_level": timed[name],
            "launches_in": "the MSDA probes' main path (msda_pallas_probe)",
            **extra})
    return lines, calls["K5"]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same f32 bits, NaN's too."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def msda_probe2_phase(cuda_msda, msda_probes, probe2) -> list:
    """P4b, P4c and P4d against their plain versions on the card at
    GATHER_SHAPES, at P 1, 2, 4, on f32 and bf16 maps, P4c and P4d on the
    weights of coeff_scalars / coeff_wide and on random ones (uniform in
    [-1/4, 1/4), which no coeff_* gives), each case also with out-of-range
    samples (NaN at the same places), every P4b and P4c launch's plan held
    to probe_plan; P4b on an f32 map against P3b and P4c on coeff_scalars
    against P4a, bit for bit, and P4d on coeff_wide, its groups summed,
    against P4a within the order bound of the same 4P products' sums; two
    launches bit-identical, P4b's and P4c's routes (P4c on l2, P4b on smem
    at level 3) and 16-byte vectors checked; kernel, plain version, the
    grid_sample form and the bound timed in turns at levels 0 and 3 (f32
    and bf16 maps); then the probe's main path: msda_packed_probe2 through
    its main at all four levels, every kernel's count set to 0 just before
    and read just after. Returns the three kernels' lines."""
    kernels = {"P4b": cuda_msda.pair_staticr_cuda,
               "P4c": cuda_msda.packed_coeff_cuda,
               "P4d": cuda_msda.packed_wide_cuda}
    plains = {"P4b": msda_probes.pair_staticr_reference,
              "P4c": msda_probes.packed_coeff_reference,
              "P4d": msda_probes.packed_wide_reference}
    gen = torch.Generator(device="cuda").manual_seed(70)
    errs = dict.fromkeys(kernels, 0.0)
    grouped_err = 0.0   # P4d's groups summed against P4a
    timed = {name + kind: {} for name in kernels for kind in ("", " bf16")}
    for index, (hp, wp, qp, m, d) in enumerate(GATHER_SHAPES):
        case = list(msda_probes.sample_case(hp, wp, qp, m, d, gen, "cuda"))
        fy, fx, w = case[3:]
        pm = msda_probes.pack_corners(case[0])
        fl = case[1] * (wp - 1) + case[2]
        cs = msda_probes.coeff_scalars(fy, fx, w)
        cw = msda_probes.coeff_wide(fy, fx, w, d)
        rand_cs = [torch.rand(m, qp, device="cuda", generator=gen) * 0.5
                   - 0.25 for _ in range(4)]
        rand_cf = (torch.rand(m, qp, 4 * d, device="cuda", generator=gen)
                   * 0.5 - 0.25)
        broken = [case[0], gather_out_of_range(case[1], hp - 1, gen),
                  gather_out_of_range(case[2], wp - 1, gen), *case[3:]]
        broken_fl = gather_out_of_range(fl, pm.shape[1], gen)
        for p3, p4_fl, label in ((case, fl, "in range"),
                                 (broken, broken_fl, "out of range")):
            worst = dict.fromkeys(kernels, 0.0)
            for dtype in (torch.float32, torch.bfloat16):
                vm_t, pm_t = p3[0].to(dtype), pm.to(dtype)
                for p in GATHER_POINTS:
                    if qp % p:
                        continue
                    runs = [("P4b", [vm_t, *p3[1:], p]),
                            ("P4c", [pm_t, p4_fl, *cs, p]),
                            ("P4c", [pm_t, p4_fl, *rand_cs, p]),
                            ("P4d", [pm_t, p4_fl, cw, p]),
                            ("P4d", [pm_t, p4_fl, rand_cf, p])]
                    first = {}   # each kernel's output on coeff_* weights
                    for name, args in runs:
                        kernel = kernels[name]
                        before = kernel.launches
                        got, want = kernel(*args), plains[name](*args)
                        torch.cuda.synchronize()
                        width = 4 * d if name == "P4d" else d
                        check(got.shape == want.shape == (m, qp // p, width)
                              and got.dtype == torch.float32,
                              f"{name} output {tuple(got.shape)} at "
                              f"{hp}x{wp}")
                        if not qp:
                            check(kernel.launches == before,
                                  f"{name} launched on QP 0")
                            continue
                        nan = torch.isnan(want)
                        check(torch.equal(torch.isnan(got), nan),
                              f"{name} NaN elsewhere than its plain "
                              f"version's at {(hp, wp, qp, m, d)} {label}")
                        check(bool(nan.any()) == (label == "out of range"),
                              f"{name} NaN only for out-of-range samples")
                        err = ((got - want)[~nan].abs().max().item()
                               if bool((~nan).any()) else 0.0)
                        check(err <= TOL_GATHER,
                              f"{name} off its plain version by {err} at "
                              f"{(hp, wp, qp, m, d)} {dtype} P {p}")
                        worst[name] = max(worst[name], err)
                        if name != "P4d":   # P4d keeps the first walk
                            check_probe_plan(
                                cuda_msda, kernel,
                                "pair" if name == "P4b" else "coeff",
                                args[0],
                                f"{name} at {(hp, wp, qp, m, d)} {dtype}")
                        first.setdefault(name, got)
                    if not qp:
                        continue
                    # the cross-checks, on the coeff_* weights
                    if dtype == torch.float32:
                        check(bits_equal(first["P4b"],
                                         cuda_msda.fused_gather_p4_cuda(
                                             *p3, p)),
                              f"P4b on an f32 map is not P3b's bits at "
                              f"{(hp, wp, qp, m, d)} P {p} {label}")
                    p4a = cuda_msda.packed_gather_cuda(pm_t, p4_fl, fy, fx,
                                                       w, p)
                    check(bits_equal(first["P4c"], p4a),
                          f"P4c on coeff_scalars is not P4a's bits at "
                          f"{(hp, wp, qp, m, d)} {dtype} P {p} {label}")
                    grouped = probe2.group_sum(first["P4d"])
                    bound = (2 * (4 * p - 1) * 2.0 ** -24
                             * cuda_msda.packed_coeff_cuda(
                                 pm_t.abs(), p4_fl, *(c.abs() for c in cs),
                                 p))
                    nan = torch.isnan(p4a)
                    diff = (grouped - p4a).abs()[~nan]
                    check(torch.equal(torch.isnan(grouped), nan)
                          and bool((diff <= bound[~nan]
                                    * (1 + 1e-6)).all()),
                          f"P4d's groups summed off P4a past the order "
                          f"bound at {(hp, wp, qp, m, d)} {dtype} P {p}")
                    if diff.numel():
                        grouped_err = max(grouped_err, diff.max().item())
                    del first, p4a, grouped, bound, diff
            print(f"P4b-d msda_probe Hp={hp} Wp={wp} QP={qp} M={m} D={d} "
                  f"{label} (P {GATHER_POINTS}, f32 and bf16 maps, P4c/P4d "
                  f"on coeff_* and random weights): max|err| {worst} (tol "
                  f"{TOL_GATHER}), NaN at the plain versions' places; P4b "
                  "(f32) = P3b and P4c = P4a bit for bit, P4d's groups "
                  "summed within the order bound of P4a")
            errs = {n: max(errs[n], worst[n]) for n in errs}
        del broken, broken_fl, rand_cs, rand_cf
        if index not in GATHER_TIMED:
            del case, pm, fl, cs, cw
            gc.collect()
            torch.cuda.empty_cache()
            continue

        # a timed level: two launches bit-identical, then kernel, plain
        # version and the grid_sample form in turns, beside the bound
        vm, iy, ix = case[:3]
        pm16 = pm.bfloat16()
        vm_nchw = vm.permute(0, 3, 1, 2).contiguous()
        grid = gather_grid(iy, ix, fy, fx, hp, wp)
        level = f"{hp - 2}x{wp - 2}"
        rows = {}  # label: (kernel's name, arguments, map bytes)
        for suffix, vm_t, pm_t, size in (("", vm, pm, 4),
                                         (" bf16", vm.bfloat16(), pm16, 2)):
            rows["P4b" + suffix] = ("P4b", [vm_t, iy, ix, fy, fx, w, 4],
                                    vm.numel() * size)
            rows["P4c" + suffix] = ("P4c", [pm_t, fl, *cs, 4],
                                    pm.numel() * size)
            rows["P4d" + suffix] = ("P4d", [pm_t, fl, cw, 4],
                                    pm.numel() * size)
        for label, (name, args, map_bytes) in rows.items():
            kernel, plain = kernels[name], plains[name]
            same = torch.equal(kernel(*args), kernel(*args))
            check(same, f"{label}'s two launches differ at {level}")
            plan = getattr(kernel, "last_plan", None)  # none for P4d
            if plan is not None:
                route = ("smem" if name == "P4b" and index == GATHER_TIMED[1]
                         else "l2")
                check(plan.route == route
                      and plan.vec * args[0].element_size() == 16,
                      f"{label} at {level} ran {plan}: expected route "
                      f"{route} on 16-byte vectors")
            plain_ms, ms, lib_ms = in_turns(
                lambda: plain(*args), lambda: kernel(*args),
                lambda: gather_grid_sample(vm_nchw, grid, w, 4), iters=10)
            # 4-byte values a sample, output width, f32 ops a sample: P4b
            # P3's 2 + 10 a channel; P4c 7 a channel; P4d one product a
            # lane; then the P sum
            scalars, width, per_sample = {
                "P4b": (5, d, 2 + 10 * d), "P4c": (5, d, 7 * d),
                "P4d": (1 + 4 * d, 4 * d, 4 * d)}[name]
            nbytes = gather_bytes(map_bytes, m, qp, width, 4, scalars)
            flops = m * qp * per_sample + m * (qp // 4) * 3 * width
            by = ("operations" if flops / F32_FLOP_PER_S
                  > nbytes / HBM_BYTES_PER_S else "bytes")
            bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                              flops / F32_FLOP_PER_S)
            timed[label][level] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound, "bound_by": by,
                "ns_per_sample": ms * 1e6 / (m * qp)}
            if plan is not None:
                timed[label][level]["plan"] = plan._asdict()
            print(f"{label} at {level} (M {m}, QP {qp}, D {d}, P 4): two "
                  f"launches bit-identical; kernel {ms:.4f} ms "
                  f"({ms * 1e6 / (m * qp):.4f} ns a sample), plain "
                  f"{plain_ms:.4f} ms, grid_sample form {lib_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP f32, {by}) [{card()}]")
        del case, pm, pm16, fl, cs, cw, vm, iy, ix, fy, fx, w, vm_nchw, grid
        del rows
        gc.collect()
        torch.cuda.empty_cache()

    # the main path: the probe at all four levels, through main
    from fastervit_tpu_torch.ops import cuda_attention, cuda_hat_block
    counted = {"K1": cuda_attention.window_mhsa_cuda,
               "K2": cuda_attention.window_mhsa_backward_cuda,
               "K3": cuda_attention.window_mhsa_long_cuda,
               "K4": cuda_attention.window_mhsa_long_backward_cuda,
               "K5": cuda_msda.ms_deform_attn_cuda,
               "K6": cuda_hat_block.hat_block_cuda,
               "P1": cuda_attention.online_attention_cuda,
               "P2": cuda_attention.nobias_attention_cuda,
               "P3a": cuda_msda.fused_gather_cuda,
               "P3b": cuda_msda.fused_gather_p4_cuda,
               "P3c": cuda_msda.fused_gather_per_head_cuda,
               "P4a": cuda_msda.packed_gather_cuda, **kernels}
    for fn in counted.values():
        fn.launches = 0
    OUT_DIR.mkdir(exist_ok=True)
    result = probe2.main(["--out", str(OUT_DIR / "msda_packed_probe2.json"),
                          "--levels", "4"])
    torch.cuda.synchronize()
    calls = {name: fn.launches for name, fn in counted.items()}
    print(f"the second MSDA probe's main path: launches {calls}")
    check(all(calls[name] > 0 for name in ("P3b", "P4a", *kernels)),
          f"msda_packed_probe2 launched P4b-d, P3b and P4a {calls}")
    levels = result["levels"]
    rows = [r for level in levels for r in level.values()
            if isinstance(r, dict)]
    check(result["device"]["type"] == "cuda" and len(levels) == 4
          and all(len([r for r in level.values() if isinstance(r, dict)])
                  == 7 for level in levels)
          and all(math.isfinite(r["ms"]) and r["ms"] > 0
                  and r["bound_ms"] > 0 for r in rows),
          "msda_packed_probe2: every row of every level timed")
    check(all(e <= probe2.TOL_CHECK
              for e in result["correctness_max_err"].values()),
          f"msda_packed_probe2 correctness {result['correctness_max_err']}")

    per = ("one MOTR level-0 call (202x386 padded, M 8, QP 408,000, D 32, "
           "P 4, f32 map)")
    library = ("F.grid_sample (bilinear, zeros, align_corners=True) of the "
               "padded map at the same samples, times w, summed over P: one "
               "grid_sample and two elementwise passes, output left "
               "(M, D, QP/P){}")
    lines = []
    for name, fn_name, replaces, extra in (
            ("P4b", "pair_staticr", "scripts/msda_packed_probe2.py:86", {}),
            ("P4c", "packed_coeff", "scripts/msda_packed_probe2.py:141",
             {"per": per + ", packed, the weights of coeff_scalars"}),
            ("P4d", "packed_wide", "scripts/msda_packed_probe2.py:194",
             {"per": per + ", packed, cf = coeff_wide (1.67 GB)",
              "max_abs_err_groups_vs_packed_gather": grouped_err})):
        lines.append({
            "name": fn_name, "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/msda_probe.cu",
            "replaces": replaces, "launches": calls[name],
            "max_abs_err": errs[name], **timed[name]["200x384"],
            "library": library.format(
                "; P4d's function group-summed, for cf = coeff_wide"
                if name == "P4d" else ""),
            "per": per, "per_level": timed[name],
            "per_level_bf16_map": timed[name + " bf16"],
            "launches_in": "the second MSDA probe's main path "
                           "(msda_packed_probe2 --levels 4)",
            **extra})
    return lines


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    import fastervit_tpu_torch as fvt
    from fastervit_tpu_torch.detection import dino
    from fastervit_tpu_torch.detection import main as detection_cli
    from fastervit_tpu_torch.ops import attention, cuda_attention, cuda_msda
    from fastervit_tpu_torch.ops import attention_probes, cuda_hat_block
    from fastervit_tpu_torch.ops import hat_block, msda, msda_probes
    from fastervit_tpu_torch.probes import attn_online_probe, attn_vpu_probe
    from fastervit_tpu_torch.probes import msda_packed_probe, msda_pallas_probe
    from fastervit_tpu_torch.probes import msda_packed_probe2
    from fastervit_tpu_torch.train import mixup, schedule, steps
    from fastervit_tpu_torch.train import train as train_cli
    from fastervit_tpu_torch.utils.pyconfig import PyConfig

    # 1. device
    smi = card()
    name = torch.cuda.get_device_name(0)
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN convolutions")

    # 2. build
    t0 = time.perf_counter()
    lib = cuda_attention.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib.name})")
    ptx_log = lib.with_suffix(".log").read_text()
    for kernel, (regs, spill) in ptxas_summary(ptx_log).items():
        print(f"  ptxas: {kernel}: at most {regs} registers, {spill} bytes "
              "of spill stores (over its instantiations)")

    # 3, 4. the kernels against their plain versions
    k1 = k1_phase(cuda_attention, attention, ptx_log)
    k2 = k2_phase(cuda_attention, attention, ptx_log)

    # 5. fp32: kernel path on the card against the plain path on the CPU
    model_cpu = fvt.create_model("faster_vit_0_224", device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    model_cpu.eval()
    model = copy.deepcopy(model_cpu).to("cuda")
    x = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), RouteLog(cuda_attention) as routes:
        want = model_cpu(x)
        before = launches(cuda_attention)
        got = model(x.to("cuda"))
        torch.cuda.synchronize()
        calls = tuple(a - b for a, b in zip(launches(cuda_attention), before))
    routes.check(17, 0, "scalar", "fv0 fp32 b4 forward")
    err = (got.cpu() - want).abs().max().item()
    print(f"fv0 fp32 b4: card vs CPU max|dlogits| {err:.3e} "
          f"(tol {TOL_MODEL_FP32}); K1, K2, K3, K4 launches per forward "
          f"{calls}")
    check(got.shape == (4, 1000) and bool(torch.isfinite(got).all()),
          "fp32 logits finite, (4, 1000)")
    check(err <= TOL_MODEL_FP32, f"fp32 logits error {err}")
    check(calls == (17, 0, 0, 0), f"launches per forward {calls}, expected "
                                  "17 K1 only")
    del model_cpu

    # 6. the inference path: bf16, batch 256
    gen = torch.Generator(device="cuda").manual_seed(2)
    xb = torch.randn(BATCH, 3, 224, 224, device="cuda", generator=gen)
    with torch.no_grad():
        ref = model(xb)
    model16 = model.to(torch.bfloat16)  # the same weights, now bf16
    del model
    xb16 = xb.bfloat16()
    del xb
    with torch.no_grad():
        reset_launches(cuda_attention)
        with RouteLog(cuda_attention) as routes:
            logits = model16(xb16)
            torch.cuda.synchronize()
        routes.check(17, 0, "wgmma", f"fv0 bf16 b{BATCH} forward")
        calls = launches(cuda_attention)
        k1_inference = calls[0]
        gap = (logits.float() - ref).abs().max().item()
        print(f"fv0 bf16 b{BATCH}: K1, K2, K3, K4 launches {calls}; "
              f"max|bf16 - "
              f"fp32 logits| {gap:.4f} (tol {TOL_MODEL_BF16})")
        check(calls == (17, 0, 0, 0),
              f"launches {calls}, expected 17 K1 only")
        check(logits.shape == (BATCH, 1000)
              and bool(torch.isfinite(logits).all()),
              f"bf16 logits finite, ({BATCH}, 1000)")
        check(gap <= TOL_MODEL_BF16, f"bf16 logits off fp32 by {gap}")
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: model16(xb16), iters=20, warmup=5)
        peak = torch.cuda.max_memory_allocated()
    smi = card()
    print(f"fv0 bf16 b{BATCH} eager: {ms:.3f} ms per batch, "
          f"{BATCH * 1000 / ms:.1f} img/s; peak memory {peak / 2**20:.1f} MiB "
          f"[{smi}]")
    del model16, xb16, logits, ref

    # 7. one fp32 train step, card against CPU
    train_parity_phase(fvt, cuda_attention, steps)

    # 8. the training path
    trained = train_main_phase(fvt, cuda_attention, steps, train_cli,
                               schedule, mixup)
    k1["launches"], k2["launches"], _, _ = trained["launches"]
    k1["launches_in"] = k2["launches_in"] = (
        f"25 fv0 bf16 b{TRAIN_BATCH} train steps of the training path")
    k1["launches_inference"] = k1_inference

    # 9. K3 against its plain version
    k3 = k3_phase(cuda_attention, attention, ptx_log)

    # 10. 21k-768 fp32: K3 path on the card against the plain path on the CPU
    model = long_fp32_phase(fvt, cuda_attention)

    # 11. the serving path: 21k-768, bf16, batch 16, live and baked
    served = serving_phase(fvt, model, cuda_attention)
    del model
    k3["launches"] = served["launches"]
    k3["launches_in"] = (f"the serving path: two faster_vit_4_21k_768 bf16 "
                         f"b{SERVE_BATCH} forwards, live then baked")

    # 12. the any-res and head-dim-80 routes
    family_phase(fvt, cuda_attention)

    # 13. K4 against its plain version
    k4 = k4_phase(cuda_attention, attention, ptx_log)

    # 14. 21k-384 fp32 train step: K3 and K4 on the card against the CPU
    train_parity_phase(fvt, cuda_attention, steps, "faster_vit_4_21k_384",
                       2, (0, 0, 17, 17), stem_tol=TOL_STEM_GRAD)
    check_bwd_plan(cuda_attention, False, 49, what="phase 14's fp32 step")

    # 15. the fine-tuning CLI: warm start, checkpoint, auto-resume
    finetune_cli_phase(fvt, cuda_attention, train_cli)

    # 16. the large-window training path: 21k-384, bf16, batch 32
    tuned = long_train_phase(fvt, cuda_attention, steps, schedule, mixup)
    check_bwd_plan(cuda_attention, True, 49, what="phase 16's bf16 step")
    k3["launches_training"] = tuned["launches"][2]
    k4["launches"] = tuned["launches"][3]
    k4["launches_in"] = k3["launches_training_in"] = (
        f"12 faster_vit_4_21k_384 bf16 b{FINETUNE_BATCH} train steps of the "
        "large-window training path")

    # 17. the train-step routes of fv5 (hd 80) and fv0_any_res
    family_train_phase(fvt, cuda_attention, steps, mixup)

    # 18. K5 against its plain version
    k5 = k5_phase(cuda_msda, msda, ptx_log)

    # 19. DINO fp32: the kernel path on the card against the plain path on
    #     the CPU
    cfg = PyConfig.fromfile(REPO / DINO_CONFIG)
    with K5Plans(cuda_msda) as plans:
        dino_fp32_phase(cuda_attention, cuda_msda, dino, cfg)
    plans.check(12, "DINO fp32 b1 forward (phase 19)")

    # 20. the serving path: DINO-4scale, bf16, batch 2, 800x1333
    with K5Plans(cuda_msda) as plans:
        served_det = dino_serving_phase(cuda_attention, cuda_msda, dino, cfg)
    plans.check(12, "DINO serving path (phase 20)", vector=True)
    k1["launches_detection"], k3["launches_detection"], k5["launches"] = (
        served_det["launches"])
    k5["launches_in"] = k1["launches_detection_in"] = \
        k3["launches_detection_in"] = (
            f"one DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} "
            "800x1333 forward of the detection serving path")

    # 21. the detection CLI, and the fv0 detector's route
    dino_cli_phase(cuda_attention, cuda_msda, dino, detection_cli, cfg)

    # 22. K6 against its plain version
    k6 = k6_phase(cuda_hat_block, hat_block, attention, ptx_log)

    # 23. fv0 fp32 with the fused block: K6 on the card against the plain
    #     version on the CPU
    fused_fp32_phase(fvt, cuda_attention, cuda_hat_block)

    # 24. the serving path through the fused block: fv0, bf16, batch 256
    served_fused = fused_serving_phase(fvt, cuda_attention, cuda_msda,
                                       cuda_hat_block)
    k6["launches"] = served_fused["launches"]
    k6["launches_in"] = (f"one faster_vit_0_224 bf16 b{BATCH} forward with "
                         "set_fused_hat(True), the fused serving path")

    # 25. fused_hat_block_dp forward and backward at the joint site
    k6_dp_grad_phase(cuda_attention, cuda_hat_block, hat_block)

    # 26. the long-window attention probes: P1 and P2 against their plain
    #     versions, timed, then both probes through their main
    p1, p2 = probe_phase(cuda_attention, attention_probes,
                         (attn_vpu_probe, attn_online_probe), ptx_log)

    # 27. the MSDA gather probes: P3a-c and P4a against their plain
    #     versions, timed, then both probes through their main
    gathers, k5["launches_msda_probes"] = msda_probe_phase(
        cuda_msda, msda_probes, (msda_pallas_probe, msda_packed_probe),
        ptx_log)
    k5["launches_msda_probes_in"] = (
        "the MSDA probes' main path (msda_pallas_probe's encoder call)")

    # 28. the second MSDA gather probe: P4b-d against their plain versions,
    #     timed, then the probe through its main
    gathers += msda_probe2_phase(cuda_msda, msda_probes, msda_packed_probe2)

    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, p1, p2,
                                  *gathers]}))
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
