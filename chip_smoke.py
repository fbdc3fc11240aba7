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
     P4a) launched there;
 29. K7, the MSDA backward kernel, against its plain version in fp32 and
     bf16 (beside f32 locations) at phase 18's shapes (the served encoder
     and decoder calls, D 1-64, a 1x1 level, border and far-outside
     samples, N = 0, Q = 0) and with value and grad_out one element into
     their storage (scalar loads): dloc and dweights within TOL_K7 of
     their largest entry (bf16 dweights one bf16 rounding more) and bit
     for bit over two launches, dvalue (f32 atomics and the tile's
     flushes) within its order bound c·2^-24·Σ|terms| against the plain
     version and between two launches; every launch's plan held to
     msda_bwd_plan, the encoder calls' on route smem tiling level 3; its
     C entry point's refusal of 4 wrong plans (a tile over a block's
     shared memory, a tile that is not the coarsest suffix, runs that miss
     rows, misaligned vectors); ptxas' registers and spills of every
     instance, the served ones without spills; kernel, plain version,
     autograd through the grid_sample form and bound timed at the encoder
     (uniform and coherent locations) and decoder calls;
 30. one fp32 DINO-4scale train step (faster_vit_4_21k_224, use_checkpoint,
     b1 480x640, given assignments), card against CPU, the CPU's step on
     the card's MSDA cells and ReLU branches (PinLog): the loss and every
     gradient, 17 K1, 12 K3, 24 K5 (each layer's forward twice), 12 K7
     and 29 K2 or K4 launches;
 31. the detection training path: that detector as configured, f32 weights
     under bf16 autocast, b2 800x1333, the fused step (auction): one step's
     launches by route and plan (K1 and K2 on the tensor cores, every K5
     and K7 launch bf16 on vector loads, every K7 launch on its
     msda_bwd_plan, the 6 at the encoder on route smem), 10 steps timed
     after 2, peak
     memory, one step profiled to chiprun_out/dino_train_profile.json, then
     the loss finite and falling over 30 steps on the batch;
 30, again: the fp32 train step card against CPU with contrastive
     denoising (the config's dn queries, 5 groups, 200 queries) on a
     480x512 image padded onto the 480x640 canvas, every gradient
     (label_enc's included) to phase 30's bound;
 32. padded serving: that detector in fp32 at batch 2 on the 800x1333
     canvas, an all-False mask against no mask (encoder outputs and every
     decoder layer on one selection, TF32 off); then in bf16 at batch 2 on
     COCO evaluation's mixed-size batch (an 800x1333 image and an 800x1066
     one padded onto the canvas by pad_to_canvas): 17 K1, 12 K3 and 12 K5
     launches a forward (6 at the encoder's Q, 6 at the decoder's 900),
     each bf16 K5 on a vector plan, outputs finite, 10 batches timed, peak
     memory; then phase 19's fp32 card against CPU on a 480x512 image
     padded onto the 480x640 canvas;
 33. the detection training path with contrastive denoising on the padded
     800x1333 batch: f32 weights under bf16 autocast, use_checkpoint, the
     auction, the config's dn queries drawn each step (targets padded to
     20: 5 groups, 200 queries, decoder calls at Q 1,100), the matching
     loss on the last 900 slots plus the denoising loss: one step's
     launches by route, plan and Q (K1 17, K2 + K4 29, K3 12, K5 24, K7
     12; half of K5's and K7's at Q 1,100), 10 steps timed after 2, peak
     memory, one step profiled to chiprun_out/dino_cdn_train_profile.json,
     the loss finite and falling over 30 steps;
 34. the detection training CLI (--synthetic --dtype bfloat16 --epochs 1,
     800x800) with --matcher auction and --matcher host, its best.pth
     under TMPDIR, 48 K7 and 120 K5 launches each;
 35. MOTRv2 streaming, card against CPU: the checkpoint-exact detector
     (faster_vit_0_any_res, dim 256, 6 + 6 layers, FFN 1024, 10 detect and
     10 proposal queries, 50 track slots) in fp32 on a 256x384 clip, 3
     frames of exact_inference_sequence on each: every frame's last-layer
     logits and boxes within TOL_MOTR_FP32 of their largest entry, the
     track ids equal;
 36. the tracking serving path: that detector in bf16 at 800x1536 on an
     8-frame synthetic clip with proposals (tracks born and carried): one
     frame's K1 launches by route, K3's, and K5's by plan and Q (6 at the
     encoder's Q 102,000, 6 at the decoder's 70), K5 at the encoder call
     and K3 at the any-res carriers (S 448, hd 32) held to their plain
     versions on the model's own inputs and timed beside them and their
     bounds, the clip's launches, the median ms a frame after 2 warm-up
     frames, peak memory, one frame profiled to
     chiprun_out/motr_frame_profile.json; then the same with the lite
     encoder (K5 at Q 25,200 over 102,000 values; its profile in
     motr_lite_frame_profile.json); then both clips timed in turns, 10
     rounds;
 37. the JAX package's own MOTRDetector at the submit CLI's defaults (60
     detect and 60 track queries, 10 proposals, 3 + 3 layers, FFN 2048) in
     bf16 at 800x1536: 3 frames of motr_inference_sequence, launches by
     route, plan and Q;
 38. the tracking CLI (python -m fastervit_tpu_torch.tracking.submit
     --exact --dtype bfloat16 --max-frames 4) on 800x1536 JPEG frames and
     a proposal db it writes to a temporary directory; the MOT file it
     writes, parsed.
 39. MOTR clip training, card against CPU: the MOTRDetector that
     tracking/main.py trains (faster_vit_0_any_res, dim 256, 60 detect and
     60 track queries, 10 proposals, 3 + 3 layers) in fp32 at 256x384, a
     2-frame clip with proposals: the matching passes' assignments equal,
     then one clip train step on the CPU's assignments, the CPU's on the
     card's MSDA cells, ReLU sides and two-stage selections (PinLog,
     SelectLog): the loss and every gradient, 24 K5 (each frame's forward
     again in the backward) and 12 K7 launches;
 40. the tracking training path: that detector at 800x1536, f32 weights
     under bf16 autocast, batch 1, a 5-frame synthetic clip with proposals
     (an identity leaving, one arriving), AdamW at lr 2e-4, clip 0.1: one
     step's launches by route, plan and Q (K1 and K2 on the tensor cores;
     90 K5 and 30 K7, half at the encoder's Q 102,000, half at the
     decoder's 130, every one bf16 on a vector plan, K7's encoder launches
     on route l2); on the step's own tensors (grad_out scaled by a power
     of two to a largest entry in [1, 2)), K7 at the encoder and decoder
     calls held to its plain version (dloc and dweights to TOL_K7
     and bit for bit over two launches, dvalue to its order bound, no
     flushes) and timed beside it, the bound and autograd through the
     grid_sample form; K5 at both calls (2^-8 of max(1, max|plain|)) and
     K4 at the carriers (TOL_K4_BF16), each bit for bit over two launches,
     timed beside its plain version and bound; the matching pass's
     last-layer logits bit-identical to the gradient pass's; 10 steps timed
     after 2, peak memory, one step profiled to
     chiprun_out/motr_train_profile.json, the loss finite over 20 steps and
     its last 5 steps' mean at most MOTR_LOSS_FALL of the first step's and
     of steps 3-5's;
 41. the MOTR training CLI (python -m fastervit_tpu_torch.tracking.main) in
     process, f32 at 800x1536: --synthetic --epochs 1 --sampler-lengths 2,
     then --mot-path on a MOT-layout tree of JPEG frames and a --det-db it
     writes (--clips-per-epoch 1); K5 and K7 launches counted (K7's
     encoder launches on route l2); each checkpoint.pth loaded strictly
     through build_motr_detector and 2 frames of motr_inference_sequence
     run on it.
 42. the tracking evaluation path, in a temporary directory: (a) a
     DanceTrack-layout ground-truth tree (seqmap, seqinfo.ini, gt.txt: 10
     identities of class 1 moving across 5 JPEG frames at 800x1536), each
     frame's proposal file beside it, swept into a det_db by
     tracking.tools.build_det_db; the checkpoint-exact MOTRv2 detector
     (phase 36's widths) in bf16 run in process on the frames as the submit
     CLI reads them (submit._load_sequences), its birth threshold from
     frame 1's scores, the clip through exact_inference_sequence and
     submit._write into a tracker folder beside an oracle (the ground truth
     copied); the evaluator CLI (python -m fastervit_tpu_torch.tracking.
     evaluator --dataset kind=dancetrack,... --parallel --cores 4
     --output ...) in a subprocess: exit 0, the oracle's HOTA, MOTA and
     IDF1 1.0, every MOTRv2 metric finite (HOTA, DetA, AssA and IDF1 in
     [0, 1]), its seq01 row equal to evaluate_mot_files on the same files
     within TOL_TRACK_EVAL, merge_tracklets keeping the file's rows; 11 K1,
     6 K3 and 12 K5 launches a frame; (b) DINO-4scale (phase 20's detector)
     bf16 b1 800x1333 on a 4-frame synthetic clip as a tracker: postprocess,
     then track_sequence with a RuntimeTracker born at the frames' k-th
     best score, ids carried between frames only across boxes of IoU at
     least its iou_thresh, written with write_mot_file and scored by
     evaluate_mot_files against a ground truth the phase writes (frame
     1's tracks moving with the image), every metric finite; 17 K1, 12 K3
     and 12 K5 launches a frame; each path's in-process ms a frame.
 43. the int8 layers (ops/quant.py): quantize_kernel of fv0's 82 int8
     weights on the card against the CPU (the same bits and scales); every
     int8 product shape of a fv0 int8 bf16 b256 forward and of a
     faster_vit_4_224 int8 fp32 b2 forward (width 196: k 1764 and n 196
     padded to 1768 and 200), at its first call, its int32 accumulation
     through torch._int_mm against the plain int32 product of the same
     int8 operands and its output against their dequantisation (both
     torch.equal), the rows, k and n after padding printed;
 44. int8 serving (create_model(quantized=True)): (a) fv0 int8 fp32 b4,
     card against CPU on the same int8 weights within TOL_INT8_LOGITS of
     the largest logit, 17 K1 launches on scalar FMA; (b) fv0 int8 bf16
     b256: 17 K1 launches on the tensor cores, its logits against the
     unquantised bf16 model on the same weights (cosine and top-1
     agreement to floors), int8 and bf16 forwards timed in turns, each
     profiled (launches, device busy share; chiprun_out/
     int8_serve_profile.json, bf16_serve_profile.json), then with
     99.9-percentile activation scales (quantiles of up to 2.1e8
     elements); (c) faster_vit_4_224 int8 fp32 b2 card against CPU;
 45. the evaluation path, in a temporary directory: an ImageFolder of 600
     JPEGs in 10 classes at mixed sizes (the last batch of 256 padded);
     the validate CLI (python -m fastervit_tpu_torch.validate) in a
     subprocess, bf16 b256, float and --int8 (exit 0, count 600, top-1
     and top-5 in [0, 100], img/s printed), and --synthetic --int8; the
     train CLI from --data-dir (train/ of 256 of the images): 2 bf16 b128
     steps and eval of the model and its EMA, K1 and K2 counted by route;
     whether the native decoder built, printed;
 46. export (utils/export.py): faster_vit_0_224 bf16 and
     faster_vit_4_21k_384 bf16 exported with a symbolic batch (K1's and
     K3's fastervit:: operators in the graphs: 17 each) and the fv0 int8
     model at b256, saved, then loaded and run in a fresh process that
     imports only the port (`chip_smoke.py --serve-programs DIR`): fv0 at
     b256 and b7, 21k-384 at b2, int8 at b256, each forward's logits
     bit-equal to the eager model's (torch.equal) and its K1 and K3
     launches counted there (17 K1, 17 K3, 17 K1); the fv0 program and
     the eager forward at b256 timed in turns; the fv0 ONNX graph (the
     plain version, traced on the CPU, folded and not) run by
     utils/onnx_eval.py at b3 against the port's CPU logits
     (TOL_ONNX), its node count, no Mod node, check_constant_folded;
 47. data parallel: the train CLI in a subprocess under torchrun's
     variables for one process (a one-process NCCL group,
     DistributedDataParallel, SyncBatchNorm2d), fv0 bf16 b128, 2 steps on
     synthetic data and the eval, then the same without the variables:
     each step's loss equal between the two, K1 and K2 launches counted;
 48. dropout: the fv0 bf16 b128 step with drop_rate and attn_drop_rate
     0.1 twice from one seed (equal losses), every attention on the route
     "plain: attention dropout" (17 calls, no K1 or K2 launch), then K1's
     17 launches at eval.
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
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

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
# COCO evaluation's batch on the canvas: image 0 fills it, image 1 is a 4:3
# image at short side 800, padded right by pad_to_canvas; phase 19's
# 480x640 canvas with one 480x512 image on it, for fp32 card against CPU
DINO_PAD_VALID = (DINO_CANVAS, (800, 1066))
DINO_SMALL_CANVAS, DINO_SMALL_VALID = (480, 640), (480, 512)
# fp32 with TF32 off, an all-False mask against no mask, relative to each
# output's largest entry: the masked tables are the constant ones up to
# the order of their sums (the position embedding's f32 against f64)
TOL_DINO_MASK = 1e-5
# contrastive denoising in training: targets padded to 20 a image (the JAX
# CLI's --max-targets), so the config's dn_number of 100 makes 5 groups of
# 2 x 20 dn queries, 200 in front of the 900 matching ones
DINO_DN_TARGETS = 20
# K7, the MSDA backward, at K5's shapes (K5_SERVED: the encoder and decoder
# calls, 6 each a train step; K5_ODD: D 1-64, a 1x1 level, border and far
# outside samples, N = 0, Q = 0) and K5_OFFSET's, value and grad_out one
# element into their storage. dloc and dweights against the plain version
# relative to each tensor's largest entry (f32, the sums over D in another
# order); bf16 dweights also one bf16 rounding of the entry; dvalue within
# the order bound of msda.dvalue_order_bound, c counting the launch's tile
# flushes (plus one bf16 rounding)
TOL_K7 = 2e-5
K7_SERVED_INSTANCES = ("<bf16, V 8, G 4, NV 1>", "<float, V 4, G 8, NV 1>")
# the levels msda_bwd_plan tiles at DINO-4scale's encoder call (D 32)
K7_ENCODER_TILED = (3,)
# wrong K7 plans its C entry point must refuse, each a change to the bf16
# decoder call's own plan (and whether the value it is handed lies one
# element into its storage)
K7_WRONG_PLANS = [
    ("a tile over a block's shared memory (levels 1-3, 707 KB)",
     dict(tiled=(1, 2, 3), tile_bytes=(50 * 84 + 25 * 42 + 13 * 21) * 128),
     False),
    ("a tile of level 2 without level 3, not the coarsest suffix",
     dict(tiled=(2,), tile_bytes=25 * 42 * 128), False),
    ("runs that miss rows (too short for the grid's rounds)", "short_runs",
     False),
    ("16-byte vectors on a value one element into its storage", {}, True),
]
# the DINO-4scale train step: fp32 card against CPU at phase 19's b1
# 480x640, the loss relative to itself and each gradient relative to its
# tensor's largest entry (floor: 1e-5 of the largest of all): f32 with TF32
# off through 23 backbone blocks and 6 + 6 transformer layers and back,
# the sums in another order
TOL_DINO_STEP_LOSS = 1e-4
TOL_DINO_STEP_GRAD = 1e-3
# (the CPU's step takes the card's MSDA cells and ReLU branches, with its
# own autograd path: see PinLog)
DINO_TRAIN_STEPS = 10      # timed bf16 steps, after 2
# steps on one batch over which the loss must fall: the matcher re-solves
# each step and the two-stage selection moves, so the box losses swing
# from step to step (±40% over 13 steps in PR 17's runs); over 30 the mean
# of the last 5 lay 27-36% under the first 3's, the class loss 50% under
DINO_LOSS_STEPS = 30
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
# MOTRv2 streaming (fastervit_tpu/tracking/submit.py's --exact defaults):
# the checkpoint-exact detector on faster_vit_0_any_res at 800x1536 with
# upstream MOTRv2's widths (dim 256, 6 + 6 layers, FFN 1024, 8 heads, 4
# points, 4 levels), 10 detect and 10 proposal queries and 50 track slots:
# the decoder's K5 calls at Q 70, the encoder's at Q 102,000 (25,200 with
# the lite encoder, over the same 102,000 values)
MOTR_CANVAS = (800, 1536)
MOTR_SMALL_CANVAS = (256, 384)
MOTR_QUERIES, MOTR_PROPOSALS, MOTR_CAPACITY = 10, 10, 50
MOTR_FRAMES, MOTR_WARMUP = 8, 2
MOTR_TURNS = 10       # rounds of the exact and the lite clip in turns
MOTR_ENC_Q, MOTR_LITE_Q = 102_000, 25_200
MOTR_DEC_Q = MOTR_QUERIES + MOTR_PROPOSALS + MOTR_CAPACITY
# the submit CLI's default path (tracking/motr.py's MOTRDetector): 60
# detect and 60 track queries, 10 proposals, 3 + 3 layers
MOTR_DEFAULT_QUERIES, MOTR_DEFAULT_LAYERS = 60, 3
# MOTR fp32 card vs CPU, relative to each tensor's largest entry: f32 with
# TF32 off through 16 backbone blocks and 6 + 6 transformer layers, the sums
# in another order (as TOL_DINO_FP32)
TOL_MOTR_FP32 = 1e-4
# MOTR clip training (fastervit_tpu/tracking/main.py's defaults): that
# detector, a 5-frame clip (--sampler-lengths 5), AdamW at lr 2e-4, clip
# 0.1; the decoder's K5 and K7 calls at Q 130 (60 track, 10 proposal, 60
# detect queries)
MOTR_TRAIN_FRAMES = 5
MOTR_TRAIN_DEC_Q = 2 * MOTR_DEFAULT_QUERIES + MOTR_PROPOSALS
MOTR_TRAIN_STEPS = 10      # timed bf16 steps, after 2
MOTR_LOSS_STEPS = 20
# the loss after a spike at step 2 (1.6, 86, then about 1; lr 2e-4 on every
# parameter from a random init): the mean of the last 5 steps at most this
# share of the first step's and of steps 3-5's mean (two runs read 0.42-0.46
# and 0.59-0.64)
MOTR_LOSS_FALL = 0.8
# fp32 clip step card vs CPU on the same branches: as phase 30's bounds
TOL_MOTR_STEP_LOSS = 1e-4
TOL_MOTR_STEP_GRAD = 1e-3
# the tracking evaluation path (phase 42): a 5-frame DanceTrack-layout
# sequence of 10 identities for the MOTRv2 clip, a 4-frame clip for DINO
# as a tracker, born at each frame's TRACK_DINO_K-th best score
TRACK_EVAL_FRAMES, TRACK_EVAL_IDS = 5, 10
TRACK_DINO_FRAMES, TRACK_DINO_K = 4, 8
# the DanceTrack adapter's row against evaluate_mot_files on the same two
# files: the same numpy metrics over the same boxes (xywh against xyxy
# IoU, so only the rounding of x + w - x differs), relative to max(1, |v|)
TOL_TRACK_EVAL = 1e-12
# int8 serving (phases 43-44): the card against the CPU on the same int8
# weights, the logits relative to the largest. Not the fp32 bound: a
# quantiser's input differs between the two by an ulp or so (the float
# layers between the int8 ones sum in another order), and where x / scale
# lies within that of a half-integer, round() takes the other integer: one
# quantisation step, ~1/127 of the token's range, which the layers after it
# carry to the logits (tests/test_torch_quant.py holds the port to JAX by
# the same bound, and every layer alone to 1e-6)
TOL_INT8_LOGITS = 2e-2
# int8 against the unquantised bf16 model on the same weights at b256: each
# row's cosine (mean and least) and the share of rows whose top-1 agrees;
# on the CPU, fv0 fp32 at b16 read a least cosine of 0.9998 and 100% (max
# scales) and 94% (99.9-percentile scales) agreement
INT8_COS_MEAN_FLOOR = 0.99
INT8_COS_MIN_FLOOR = 0.95
INT8_TOP1_FLOOR = 0.75
INT8_CLIP_PERCENTILE = 99.9
FV4_INT8_BATCH = 2
# the evaluation path (phase 45): an ImageFolder of JPEGs at mixed sizes,
# 10 classes, 600 images (two full batches of 256 and one padded), and a
# train/ tree of 256 of them (2 steps at batch 128)
EVAL_CLASSES = 10
EVAL_IMAGES = 600
EVAL_TRAIN_IMAGES = 256
EVAL_TRAIN_BATCH = 128
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


def ptxas_k5_instances(log: str, kernel: str = "msda_fwd_kernel") -> dict:
    """{instance: {registers, spill_stores, static_smem}} for each
    msda_fwd_kernel<T, V, G, NV> (K5; or, given kernel="msda_bwd_kernel",
    K7's) that nvcc's -Xptxas -v log reports, each printed."""
    def describe(name):
        args = re.search(kernel + r"I(f|13__nv_bfloat16)"
                         r"Li(\d+)ELi(\d+)ELi(\d+)E", name)
        if args is None:
            return None
        return {"instance": f"<{'float' if args[1] == 'f' else 'bf16'}, "
                            f"V {args[2]}, G {args[3]}, NV {args[4]}>"}

    out = {}
    for i in ptxas_entries(log, describe):
        name = i.pop("instance")
        out[name] = i
        print(f"  ptxas: {kernel}{name}: {i['registers']} registers, "
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


def kernel_proxy(orig, call):
    """A stand-in for the kernel wrapper `orig` that runs `call` and reads
    and writes `launches` and `last_plan` through to `orig`."""

    class Proxy:
        launches = property(lambda _: orig.launches,
                            lambda _, n: setattr(orig, "launches", n))
        last_plan = property(lambda _: orig.last_plan,
                             lambda _, plan: setattr(orig, "last_plan", plan))

        def __call__(self, *args):
            return call(*args)

    return Proxy()


def cloned(args) -> tuple:
    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


class K5Plans:
    """Inside `with K5Plans(cuda_msda) as plans:`, each K5 launch's plan,
    read from last_plan just after the launch, is counted in plans.count
    by (dtype, plan). ms_deform_attn_cuda is wrapped for the block's
    duration (`kernel_proxy`); the model, and the wrapper itself, look it
    up at each call. With kernel="ms_deform_attn_backward_cuda" it counts
    K7's launches alike. With `capture_q`, a query count Q or a tuple of
    them, plans.captured[Q] keeps (cloned) the inputs of the first launch
    at each, and plans.inputs those at the first Q given."""

    def __init__(self, cuda_msda, kernel: str = "ms_deform_attn_cuda",
                 capture_q=None):
        self.cm, self.kernel = cuda_msda, kernel
        self.capture_q = ((capture_q,) if isinstance(capture_q, int)
                          else tuple(capture_q or ()))
        self.label = "K5" if kernel == "ms_deform_attn_cuda" else "K7"

    @property
    def inputs(self):
        return (self.captured.get(self.capture_q[0]) if self.capture_q
                else None)

    def __enter__(self):
        self.count = collections.Counter()
        self.off_plan, self.encoder = [], collections.Counter()
        self.queries = collections.Counter()
        self.captured = {}
        orig = self.orig = getattr(self.cm, self.kernel)
        k7 = self.label == "K7"

        def counted(value, *args):
            before = orig.launches
            out = orig(value, *args)
            if orig.launches > before:
                plan, q = orig.last_plan, args[1].shape[1]
                self.count[(str(value.dtype).split(".")[-1], plan)] += 1
                self.queries[q] += 1
                if q in self.capture_q and q not in self.captured:
                    self.captured[q] = cloned((value, *args))
                if k7:
                    # K7's launch against msda_bwd_plan of its inputs; the
                    # encoder's (Q = S) plans kept apart
                    want = k7_plan(self.cm, value, *args)
                    if plan != want:
                        self.off_plan.append((plan, want))
                    if q == value.shape[1]:
                        self.encoder[plan] += 1
            return out

        setattr(self.cm, self.kernel, kernel_proxy(orig, counted))
        return self

    def __exit__(self, *exc):
        setattr(self.cm, self.kernel, self.orig)

    def check(self, launches: int, what: str, vector: bool = False) -> None:
        """At least `launches` launches in the block and, where `vector`,
        every bf16 one on vector loads (V > 1)."""
        total = sum(self.count.values())
        scalar = sum(n for (dtype, plan), n in self.count.items()
                     if dtype == "bfloat16" and plan.vec == 1)
        print(f"{what}: {total} {self.label} launches by plan: "
              + "; ".join(f"{n} {dtype} at {plan._asdict()}"
                          for (dtype, plan), n in self.count.items()))
        check(total >= launches, f"{what}: {total} {self.label} launches, "
                                 f"expected at least {launches}")
        check(not (vector and scalar), f"{what}: {scalar} bf16 "
                                       f"{self.label} launches on scalar "
                                       "loads (V 1)")
        check(not self.off_plan, f"{what}: K7 launches off msda_bwd_plan "
                                 f"(ran, planned): {self.off_plan}")

    def check_queries(self, want: dict, what: str) -> None:
        """The launches by query count Q (the encoder's Q = S, the
        decoder's the queries it runs) are `want`'s."""
        print(f"{what}: {self.label} launches by Q {dict(self.queries)}")
        check(dict(self.queries) == want, f"{what}: {self.label} launches "
                                          f"by Q {dict(self.queries)}, "
                                          f"expected {want}")

    def check_encoder(self, launches: int, what: str, route: str = "smem",
                      levels: tuple = K7_ENCODER_TILED) -> None:
        """At least `launches` K7 launches at the encoder calls (Q = S),
        every one on `route` tiling `levels` (DINO's: route smem with
        K7_ENCODER_TILED's levels)."""
        ran = sum(self.encoder.values())
        tiled = {(p.route, p.tiled) for p in self.encoder}
        print(f"{what}: {ran} K7 launches at the encoder calls, on "
              f"(route, tiled levels) {sorted(tiled)}")
        check(ran >= launches and tiled == {(route, levels)},
              f"{what}: K7's encoder launches {dict(self.encoder)}, "
              f"expected {launches} on route {route} tiling levels "
              f"{levels}")


class FirstLaunches:
    """Inside `with FirstLaunches(module, name) as first:`, first.inputs
    maps each distinct set of input shapes to the (cloned) inputs of the
    kernel wrapper module.name's first launch at it; the wrapper is
    stood in for (`kernel_proxy`) for the block only."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name

    def __enter__(self):
        self.inputs = {}
        orig = self.orig = getattr(self.module, self.name)

        def call(*args):
            before = orig.launches
            out = orig(*args)
            key = tuple(tuple(a.shape) if torch.is_tensor(a) else a
                        for a in args)
            if orig.launches > before and key not in self.inputs:
                self.inputs[key] = cloned(args)
            return out

        setattr(self.module, self.name, kernel_proxy(orig, call))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def k7_plan(cuda_msda, value, shapes, loc, w, g):
    """msda_bwd_plan of K7's inputs, as its wrapper makes it."""
    n, _, m, d = value.shape
    return cuda_msda.msda_bwd_plan(
        d, value.dtype, cuda_msda.pointer_alignment(value.data_ptr()),
        cuda_msda.pointer_alignment(g.data_ptr()),
        tuple((int(h), int(w_)) for h, w_ in shapes), loc.shape[1], n * m,
        cuda_msda._sm_count(value.device))


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
    ("K7 ms_deform_attn_backward", ("msda_bwd",)),
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


def padded_batch(transforms, images: torch.Tensor, valid):
    """images (B, 3, H, W) -> (the batch with image i cut to its top-left
    valid[i] (h, w) and padded back onto the H x W canvas by
    transforms.pad_to_canvas, its (B, H, W) mask), on images' device."""
    x = images.permute(0, 2, 3, 1).cpu().numpy()
    batch, mask = transforms.pad_to_canvas(
        [x[i, :h, :w] for i, (h, w) in enumerate(valid)],
        tuple(images.shape[-2:]))
    return (torch.from_numpy(batch).permute(0, 3, 1, 2).contiguous()
            .to(images.device), torch.from_numpy(mask).to(images.device))


def dino_fp32_phase(cuda_attention, cuda_msda, dino, cfg,
                    transforms=None) -> None:
    """The served detector in fp32, batch 1, 480x640: the card (kernel
    path) against the CPU (plain path) on the same weights, step by step;
    both decoders run on the CPU's two-stage selection. Given `transforms`,
    the batch is a 480x512 image padded onto the canvas, and its mask runs
    through the encoder and decoder."""
    t0 = time.perf_counter()
    det_cpu = dino.build_dino_from_config(
        cfg, resolution=DINO_SMALL_CANVAS, device="cpu",
        generator=torch.Generator().manual_seed(31)).eval()
    det = copy.deepcopy(det_cpu).to("cuda")
    build_s = time.perf_counter() - t0
    x = torch.randn(1, 3, *DINO_SMALL_CANVAS,
                    generator=torch.Generator().manual_seed(32))
    mask, what = None, ""
    if transforms is not None:
        x, pad = padded_batch(transforms, x, [DINO_SMALL_VALID])
        mask = dino.level_padding_mask(pad, det_cpu.spatial_shapes)
        what = (f", a {DINO_SMALL_VALID[0]}x{DINO_SMALL_VALID[1]} image "
                "padded onto it, its mask through the encoder and decoder")
    runs, seconds = {}, {}
    with torch.no_grad():
        for where, m in (("cpu", det_cpu), ("card", det)):
            t0 = time.perf_counter()
            before = detection_launches(cuda_attention, cuda_msda)
            dev = "cpu" if where == "cpu" else "cuda"
            feats = m.features(x.to(dev))
            enc = m.transformer.encode(m.project(feats), None if mask is None
                                       else mask.to(dev))
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
    print(f"DINO-4scale faster_vit_4_21k_224 fp32 b1 480x640{what}, card "
          f"vs CPU, max|err| / max|CPU| per tensor (tol {TOL_DINO_FP32}): "
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


def train_launches(cuda_attention, cuda_msda):
    """Launches so far of K1, K2, K3, K4, K5 and K7, the kernels of the
    detector's train step."""
    return (*launches(cuda_attention), cuda_msda.ms_deform_attn_cuda.launches,
            cuda_msda.ms_deform_attn_backward_cuda.launches)


def reset_train_launches(cuda_attention, cuda_msda) -> None:
    reset_launches(cuda_attention, cuda_msda)
    cuda_msda.ms_deform_attn_backward_cuda.launches = 0


def k7_check(cuda_msda, kernel, plain, msda, value, shapes, loc, w,
             g) -> dict:
    """K7 against its plain version on these inputs, and a second launch
    against the first, to the bounds of TOL_K7; returns the errors."""
    got = kernel(value, shapes, loc, w, g)
    torch.cuda.synchronize()
    plan = kernel.last_plan
    bf16 = value.dtype == torch.bfloat16
    want = plain(value.float(), shapes, loc, w.float(), g.float())
    # c counts the tile flushes of the launch's plan too
    bound, c = msda.dvalue_order_bound(
        value, shapes, loc, w, g,
        cuda_msda.msda_bwd_flushes(plan, loc.shape[1]))
    tiny = torch.finfo(torch.float32).tiny
    # the kernel's bf16 dvalue is its f32 sum rounded once: half a bf16
    # step, at most 2^-8 of the value, from the f32 sum
    dv_bound = bound + (2 ** -8 * (want[0].abs() + bound) if bf16 else 0)
    dv_ratio = ((got[0].float() - want[0]).abs()
                / dv_bound.clamp(min=tiny)).max().item()
    dl_err = rel_to_largest(got[1], want[1])
    top = want[2].abs().max()
    dw_bound = TOL_K7 * top + (2 ** -8 * want[2].abs() if bf16 else 0)
    dw_ratio = ((got[2].float() - want[2]).abs()
                / dw_bound.clamp(min=tiny)).max().item()
    again = kernel(value, shapes, loc, w, g)
    same = torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
    # two f32 sums of dvalue, each rounded to bf16: one bf16 step apart
    rerun_bound = bound + (2 ** -7 * got[0].float().abs() if bf16 else 0)
    rerun_ratio = ((again[0].float() - got[0].float()).abs()
                   / rerun_bound.clamp(min=tiny)).max().item()
    measured = (got[0].float() - want[0]).abs().max().item()
    return {"c": c, "dvalue_over_bound": dv_ratio, "dvalue_max_abs_err":
            measured, "dvalue_bound_max": bound.max().item(),
            "dloc_rel": dl_err, "dweights_over_bound": dw_ratio,
            "same_bits": same, "rerun_over_bound": rerun_ratio,
            "plan": plan}



def k7_checks(cuda_msda, msda, gen):
    """K7 against its plain version at K5's served and odd shapes and with
    value and grad_out one element into their storage, f32 and bf16, two
    launches compared; returns the worst of each tensor against its bound
    and bf16 dvalue's largest error."""
    kernel = cuda_msda.ms_deform_attn_backward_cuda
    plain = msda.msda_backward_reference
    worst = {"dvalue_over_bound": 0.0, "dloc_rel": 0.0,
             "dweights_over_bound": 0.0, "rerun_over_bound": 0.0}
    err16 = 0.0
    for n, q, m, d, p, shapes, _ in K5_SERVED + K5_ODD:
        value, loc, w = msda_inputs(n, q, m, d, p, shapes, gen)
        g = torch.randn(n, q, m * d, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            args = (value.to(dtype), shapes, loc, w.to(dtype), g.to(dtype))
            if not n * q:
                before = kernel.launches
                got = kernel(*args)
                check(kernel.launches == before
                      and not any(t.abs().sum() for t in got),
                      f"K7 on an empty input {(n, q)}")
                continue
            r = k7_check(cuda_msda, kernel, plain, msda, *args)
            print(f"K7 ms_deform_attn_backward N={n} Q={q} M={m} D={d} P={p} "
                  f"{str(dtype).split('.')[-1]} levels {shapes}: dvalue "
                  f"max|err| {r['dvalue_max_abs_err']:.3e}, at most "
                  f"{r['dvalue_over_bound']:.3f} of its order bound c·2^-24·"
                  f"Σ|terms| (c {r['c']}, largest bound "
                  f"{r['dvalue_bound_max']:.3e}"
                  f"{', plus one bf16 rounding' if dtype != torch.float32 else ''}"
                  f"); dloc max|err| / max|plain| {r['dloc_rel']:.3e} (tol "
                  f"{TOL_K7}); dweights at most "
                  f"{r['dweights_over_bound']:.3f} of its bound; second "
                  f"launch: dloc and dweights bit-identical {r['same_bits']}, "
                  f"dvalue at most {r['rerun_over_bound']:.3f} of the order "
                  f"bound; plan (G, V, channels a lane) {r['plan'].lanes}, "
                  f"{r['plan'].vec}, {r['plan'].channels}")
            check(r["dvalue_over_bound"] <= 1 and r["dloc_rel"] <= TOL_K7
                  and r["dweights_over_bound"] <= 1 and r["same_bits"]
                  and r["rerun_over_bound"] <= 1,
                  f"K7 at {(n, q, m, d, p, dtype)}: {r}")
            for key in worst:
                worst[key] = max(worst[key], r[key])
            if dtype == torch.bfloat16:
                err16 = max(err16, r["dvalue_max_abs_err"])
        del value, loc, w, g
    # value and grad_out one element into their storage: scalar loads
    for n, q, m, d, p, shapes, _ in K5_OFFSET:
        value, loc, w = msda_inputs(n, q, m, d, p, shapes, gen)
        g = torch.randn(n, q, m * d, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            r = k7_check(cuda_msda, kernel, plain, msda,
                         at_element_offset(value.to(dtype)), shapes, loc,
                         w.to(dtype), at_element_offset(g.to(dtype)))
            print(f"K7 ms_deform_attn_backward N={n} Q={q} M={m} D={d} "
                  f"{dtype}, value and grad_out one element into their "
                  f"storage: plan (G, V) ({r['plan'].lanes}, {r['plan'].vec})"
                  f", dvalue at most {r['dvalue_over_bound']:.3f} of its "
                  f"bound, dloc {r['dloc_rel']:.3e}, dweights at most "
                  f"{r['dweights_over_bound']:.3f} of its bound")
            check(r["plan"].vec == 1 and r["dvalue_over_bound"] <= 1
                  and r["dloc_rel"] <= TOL_K7
                  and r["dweights_over_bound"] <= 1 and r["same_bits"],
                  f"K7 on an offset value at {(n, q, m, d, p, dtype)}: {r}")
        del value, loc, w, g
    return worst, err16


def k7_refuses_wrong_plans(cuda_msda, gen) -> None:
    """K7's C entry point, handed each plan of K7_WRONG_PLANS in place of
    msda_bwd_plan's, refuses it: the call raises and counts no launch."""
    kernel = cuda_msda.ms_deform_attn_backward_cuda
    n, q, m, d, p, shapes, _ = K5_SERVED[1]
    value, loc, w = msda_inputs(n, q, m, d, p, shapes, gen)
    v16, w16 = value.bfloat16(), w.bfloat16()
    g16 = torch.randn(n, q, m * d, device="cuda", generator=gen).bfloat16()
    shifted = at_element_offset(v16)
    make = cuda_msda.msda_bwd_plan
    served = make(d, torch.bfloat16, 16, 16, shapes, q, n * m,
                  cuda_msda._sm_count(v16.device))
    try:
        for what, change, offset in K7_WRONG_PLANS:
            if change == "short_runs":
                change = dict(run=(n * q * m - 1)
                              // (served.blocks * served.rounds))
            plan = served._replace(**change)
            cuda_msda.msda_bwd_plan = lambda *_: plan
            before = kernel.launches
            try:
                kernel(shifted if offset else v16, shapes, loc, w16, g16)
                refused = False
            except RuntimeError as err:
                refused = "msda_backward" in str(err)
            check(refused and kernel.launches == before,
                  f"K7 ran {what}: {plan}, which its C entry point must "
                  "refuse")
    finally:
        cuda_msda.msda_bwd_plan = make
    torch.cuda.synchronize()
    print(f"K7's C entry point refuses {len(K7_WRONG_PLANS)} wrong plans ("
          + "; ".join(what for what, *_ in K7_WRONG_PLANS)
          + "), each counting no launch")


def k7_timed(cuda_msda, msda, v16, shapes, loc, w16, g16,
             iters: int = 10) -> dict:
    """K7, its plain version and autograd through upstream's grid_sample
    form (the library call) timed in turns on these inputs, the launch's
    plan held to msda_bwd_plan on vector loads, beside the bound: ms,
    plain_ms, library_ms, bound_ms, bound_by, mbytes, gflop,
    dvalue_buffer_mbytes, g_samples_s and the plan."""
    kernel = cuda_msda.ms_deform_attn_backward_cuda
    plain = msda.msda_backward_reference
    n, q, m, nl, p = loc.shape[:5]
    d = v16.shape[-1]
    leaves = [t.detach().clone().requires_grad_() for t in (v16, loc, w16)]
    out = msda_grid_sample(leaves[0], shapes, leaves[1], leaves[2])
    plain_ms, ms, lib_ms = in_turns(
        lambda: plain(v16, shapes, loc, w16, g16),
        lambda: kernel(v16, shapes, loc, w16, g16),
        lambda: torch.autograd.grad(out, leaves, g16, retain_graph=True),
        iters)
    del leaves, out
    plan = kernel.last_plan
    check(plan.vec > 1
          and plan == k7_plan(cuda_msda, v16, shapes, loc, w16, g16),
          f"K7's bf16 call {(n, q, m, d, p)} ran {plan}, not its "
          "msda_bwd_plan on vector loads")
    samples = n * q * m * nl * p
    # value, grad_out, loc and weights read once, dvalue, dloc and dweights
    # written once, each in its dtype (bf16 but for f32 locations and dloc)
    nbytes = (2 * v16.element_size() * v16.numel()
              + g16.element_size() * g16.numel()
              + 2 * loc.element_size() * loc.numel()
              + 2 * w16.element_size() * w16.numel())
    # the least f32 work: per sample and channel, the four corner dots
    # <v_c, g> (4 FMAs, 8) and the four corner multiply-adds into dvalue
    # (8), since dweights and both location terms are per-sample
    # combinations of the dots; per sample, the geometry, the corner
    # weights and those combinations (~40)
    flops = samples * (16.0 * d + 40)
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
    by = ("operations" if flops / F32_FLOP_PER_S
          > nbytes / HBM_BYTES_PER_S else "bytes")
    # the f32 dvalue buffer: zeroed, 4 corner atomics a sample and channel,
    # read for the cast
    buffer_mb = (4 * 2 * v16.numel() + v16.element_size() * v16.numel()) \
        / 1e6
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": by, "mbytes": nbytes / 1e6,
            "gflop": flops / 1e9, "dvalue_buffer_mbytes": buffer_mb,
            "g_samples_s": samples / ms / 1e6, "plan": plan}


def k7_phase(cuda_msda, msda, ptx_log: str) -> dict:
    """K7 against its plain version at K5's served and odd shapes, f32 and
    bf16 (beside f32 locations), and on a value and grad_out one element
    into their storage; two launches compared; every launch's plan held to
    msda_bwd_plan, the encoder call's on route smem; its C entry point's
    refusal of wrong plans; ptxas' registers and spills of every instance
    (none in the served ones); then kernel, plain version, autograd through
    the grid_sample form and the bound timed in bf16 at the encoder and
    decoder calls (uniform locations; the encoder also coherent)."""
    from fastervit_tpu_torch.probes import msda_turns
    gen = torch.Generator(device="cuda").manual_seed(40)
    with K5Plans(cuda_msda, "ms_deform_attn_backward_cuda") as plans:
        worst, err16 = k7_checks(cuda_msda, msda, gen)
    # two launches a check, f32 and bf16
    plans.check(4 * (sum(n * q > 0 for n, q, *_ in K5_SERVED + K5_ODD)
                     + len(K5_OFFSET)), "phase 29's K7 checks")
    plans.check_encoder(4, "phase 29's K7 checks")
    k7_refuses_wrong_plans(cuda_msda, gen)
    kernel = cuda_msda.ms_deform_attn_backward_cuda
    instances = ptxas_k5_instances(ptx_log, "msda_bwd_kernel")
    served = {i: instances.get(i) for i in K7_SERVED_INSTANCES}
    check(all(r is not None and not r["spill_stores"]
              for r in served.values()),
          f"K7's served instances in the ptxas log, without spills: "
          f"{served}")

    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    per_call, ops_ms, bytes_ms, served_plan = {}, 0.0, 0.0, None
    for n, q, m, d, p, shapes, calls in K5_SERVED:
        value, loc, w = msda_inputs(n, q, m, d, p, shapes, gen, timing=True)
        g16 = torch.randn(n, q, m * d, device="cuda",
                          generator=gen).bfloat16()
        v16, w16 = value.bfloat16(), w.bfloat16()
        del value, w
        row = k7_timed(cuda_msda, msda, v16, shapes, loc, w16, g16)
        served_plan = row.pop("plan")
        ms, plain_ms, lib_ms = row["ms"], row["plain_ms"], row["library_ms"]
        bound, by = row["bound_ms"], row["bound_by"]
        for key, t in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound)):
            step[key] += calls * t
        ops_ms += calls * 1e3 * row["gflop"] * 1e9 / F32_FLOP_PER_S
        bytes_ms += calls * 1e3 * row["mbytes"] * 1e6 / HBM_BYTES_PER_S
        print(f"K7 ms_deform_attn_backward N={n} Q={q} bf16, uniform "
              f"locations: kernel {ms:.4f} ms ({row['g_samples_s']:.1f} G "
              f"samples/s; with its f32 dvalue buffer's zeroing and cast), "
              f"plain {plain_ms:.4f} ms, autograd through the grid_sample "
              f"form {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({row['mbytes']:.1f} MB, {row['gflop']:.2f} GFLOP f32, {by}; "
              f"the f32 buffer adds {row['dvalue_buffer_mbytes']:.1f} MB) per "
              f"call")
        if q == sum(h * w_ for h, w_ in shapes):
            # the encoder's coherent locations, timed beside the uniform
            samples = n * q * m * len(shapes) * p
            loc_c = msda_turns.locations("coherent", n, q, m, p, shapes, gen)
            ms_c = time_ms(lambda: kernel(v16, shapes, loc_c, w16, g16),
                           iters=20)
            row["coherent"] = {"ms": ms_c,
                               "g_samples_s": samples / ms_c / 1e6}
            print(f"K7 ms_deform_attn_backward N={n} Q={q} bf16, coherent "
                  f"locations (each query's samples near its own token): "
                  f"kernel {ms_c:.4f} ms "
                  f"({row['coherent']['g_samples_s']:.1f} G samples/s) per "
                  "call")
            del loc_c
        per_call[f"({n},{q},{m},{d},{p})"] = row
        del v16, loc, w16, g16
    print(f"K7 ms_deform_attn_backward over one DINO-4scale bf16 "
          f"b{DINO_BATCH} 800x1333 train step's 12 calls: kernel "
          f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, autograd "
          f"through the grid_sample form {step['library_ms']:.4f} ms, bound "
          f"{step['bound_ms']:.4f} ms [{card()}]")
    return {"name": "ms_deform_attn_backward", "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/msda_bwd.cu",
            "replaces": "fastervit_tpu/ops/msda.py:184",
            "replaces_kernels": "none: the JAX package's MSDA backward, "
                                "_msda_core_bwd (msda.py:184-237), is XLA "
                                "(its value gradient one-hot matmuls), not "
                                "Pallas; K7 computes that function",
            "launches": None, "max_abs_err": err16,
            "err_is": "bf16 dvalue: max |kernel - plain| over the checked "
                      "shapes; every tensor is held to its bound "
                      "(worst_over_bound: dvalue's order bound, dloc "
                      "relative to its largest entry)",
            "worst_over_bound": worst, **step,
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "library": "autograd through upstream's ms_deform_attn_core_"
                       "pytorch form (4 F.grid_sample calls and the "
                       "weighted sum), its backward only",
            "plan": served_plan._asdict(), "ptxas": served,
            "per": f"one DINO-4scale bf16 b{DINO_BATCH} 800x1333 train step "
                   "(12 calls: 6 in the encoder at Q = 22,223, 6 in the "
                   "decoder at Q = 900), uniform locations",
            "per_call": per_call}


def dino_targets(detection_cli, batch: int, seed: int, max_targets: int,
                 engine, device):
    """A synthetic batch's targets (the CLI's), padded, on `device`."""
    _, targets = next(detection_cli.synthetic_batches(1, batch, 32, 91,
                                                      seed=seed))
    return engine.targets_on(engine.pad_targets(targets, max_targets),
                             device)


def detection_optimizer(engine, det, cfg):
    """The config's optimizer (engine.create_detection_optimizer)."""
    return engine.create_detection_optimizer(
        det, lr=float(cfg.get("lr", 1e-4)),
        lr_backbone=float(cfg.get("lr_backbone", 1e-5)),
        weight_decay=float(cfg.get("weight_decay", 1e-4)),
        clip_norm=float(cfg.get("clip_max_norm", 0.1)),
        lr_linear_proj_mult=float(cfg.get("lr_linear_proj_mult", 1.0)),
        linear_proj_names=tuple(cfg.get("lr_linear_proj_names", [])))


def _msda_cells(loc: torch.Tensor, shapes) -> torch.Tensor:
    """Each sample's bilinear cell, floor(loc·W − 0.5) and floor(loc·H −
    0.5) (msda._level_geometry's rounding), int16 on the CPU."""
    wh = torch.tensor([[w_, h_] for h_, w_ in shapes], dtype=torch.float32,
                      device=loc.device)
    cells = torch.floor(loc.detach().float()
                        * wh[None, None, None, :, None, :] - 0.5)
    return cells.clamp(-2, 2 ** 14).to(torch.int16).cpu()


class PinLog:
    """Inside `with PinLog(msda, replay) as log:`, the step's two kinds of
    branch are logged in call order: every MSDA call's sampling locations
    (log.locs, f32), which pick each sample's bilinear cell, and every
    ReLU's sign mask (log.masks, bool), both on the CPU; log.cells keeps
    the cells of the model's own locations. `msda.ms_deform_attn`, which
    MSDeformAttnModule looks up at each call, and F.relu, which the stem's
    nn.ReLU, the FFNs and the box heads call, are wrapped for the block's
    duration. Given `replay`, another run's PinLog, each call takes that
    run's branch through the model's own autograd path: MSDA samples at
    replay's locations (given + (loc − loc.detach()): exactly the given
    values forward, the identity backward) and a ReLU is its input times
    replay's mask; log.relu_flips counts the ReLU inputs on the other side
    of 0 from replay's."""

    def __init__(self, msda, replay=None):
        self.msda, self.replay = msda, replay

    def __enter__(self):
        self.locs, self.masks, self.cells, self.relu_flips = [], [], [], 0
        self.orig = self.msda.ms_deform_attn, torch.nn.functional.relu
        orig_msda, orig_relu = self.orig

        def msda_call(value, shapes, loc, w):
            self.cells.append(_msda_cells(loc, shapes))
            if self.replay is not None:
                given = self.replay.locs[len(self.locs)].to(loc)
                check(given.shape == loc.shape, f"MSDA call {len(self.locs)}"
                      f": locations {tuple(loc.shape)}, replayed "
                      f"{tuple(given.shape)}")
                loc = given + (loc - loc.detach())
            self.locs.append(loc.detach().float().cpu())
            return orig_msda(value, shapes, loc, w)

        def relu(x, inplace=False):
            own = x.detach() > 0
            if self.replay is None:
                self.masks.append(own.cpu())
                return orig_relu(x, inplace=inplace)
            given = self.replay.masks[len(self.masks)].to(x.device)
            check(given.shape == x.shape, f"ReLU call {len(self.masks)}: "
                  f"input {tuple(x.shape)}, replayed {tuple(given.shape)}")
            self.relu_flips += int((own != given).sum())
            self.masks.append(given)
            return x * given.to(x.dtype)

        self.msda.ms_deform_attn, torch.nn.functional.relu = msda_call, relu
        return self

    def __exit__(self, *exc):
        self.msda.ms_deform_attn, torch.nn.functional.relu = self.orig


def dn_settings(cfg) -> dict:
    """The config's contrastive-denoising settings (configs/dino/*.py:
    use_dn, dn_number, dn_label_noise_ratio, dn_box_noise_scale,
    dn_labelbook_size), which the caller hands to the detector's build and
    to prepare_cdn."""
    check(bool(cfg.get("use_dn", False)), "the config sets use_dn")
    return {"dn_labelbook_size": int(cfg["dn_labelbook_size"]),
            "dn_number": int(cfg["dn_number"]),
            "label_noise_ratio": float(cfg["dn_label_noise_ratio"]),
            "box_noise_scale": float(cfg["dn_box_noise_scale"])}


def draw_cdn(dino, generator, tgt, det, dn_cfg):
    """prepare_cdn's queries for the padded targets `tgt` at the config's
    settings, drawn from `generator`, on tgt's device."""
    return dino.prepare_cdn(generator, tgt, det.num_classes, det.num_queries,
                            dn_number=dn_cfg["dn_number"],
                            label_noise_ratio=dn_cfg["label_noise_ratio"],
                            box_noise_scale=dn_cfg["box_noise_scale"])


def make_cdn_train_step(engine, dino, steps, matcher_device,
                        dtype=torch.float32):
    """train_step(state, images, pad_mask, tgt, dn, meta, assignment=None)
    -> metrics: a DINO train step with contrastive denoising on a padded
    batch, composed as the JAX tests compose it (the JAX engine has no CDN
    step): the detector in eval mode (frozen BatchNorm) with the dn queries
    and the mask, under autocast for a bf16 `dtype` over f32 weights; the
    set criterion given assignments (`engine.detection_loss`) on the last
    num_queries slots of every layer and the interm layer, the
    assignments given or by the on-device auction; plus `dino.cdn_loss` on
    the first meta['n_dn'] slots; backward, the clip, AdamW."""
    def train_step(state, images, pad_mask, tgt, dn, meta, assignment=None):
        model = state.model.eval()
        state.optimizer.zero_grad()
        with steps._autocast(images.device, dtype):
            out = model(images, dn=dn, pad_mask=pad_mask)
        out = engine._f32(out)
        n_dn = meta["n_dn"]
        main = {"logits": [t[:, n_dn:] for t in out["logits"]],
                "boxes": [t[:, n_dn:] for t in out["boxes"]],
                "interm_logits": out["interm_logits"],
                "interm_boxes": out["interm_boxes"]}
        if assignment is None:
            costs = engine.compute_costs(main, tgt,
                                         len(engine.loss_layers(main)[0]))
            assignment = matcher_device.solve_assignments_device(
                costs, tgt["mask"])
        assignment = torch.as_tensor(assignment).to(images.device)
        loss, parts = engine.detection_loss(main, tgt, assignment,
                                            model.num_classes)
        dn_parts = dino.cdn_loss(out, tgt, meta, model.num_classes)
        total = loss + dn_parts["loss_dn"]
        total.backward()
        grad_norm = state.optimizer.step(state.step)
        state.step += 1
        return {"loss": total.detach(), "loss_ce": parts["loss_ce"].detach(),
                "loss_dn": dn_parts["loss_dn"].detach(),
                "grad_norm": grad_norm}
    return train_step


def dino_step_fp32_phase(cuda_attention, cuda_msda, msda, dino, engine,
                         detection_cli, cfg, cdn=None) -> None:
    """One fp32 DINO-4scale train step (the config's use_checkpoint on),
    card against CPU, batch 1, 480x640, on the same weights, targets and
    assignments (solved once from the CPU's costs): the loss and every
    gradient, and the step's launches of K1-K5 and K7; the sampling-offset
    kernels drawn at random (see below). A sample whose bilinear cell
    differs between card and CPU (its location within rounding of a cell
    border) or a ReLU input on the other side of 0 (within rounding of the
    kink) would change the gradients upstream of it by a whole term, so the
    CPU's step takes the card's branches through its own autograd path
    (PinLog); how many of its own would have differed is printed. Given
    `cdn` (transforms, steps and matcher_device), the step is
    make_cdn_train_step's: a 480x512 image padded onto the canvas, and the
    config's dn queries (T = DINO_DN_TARGETS), label_enc's gradient
    included."""
    t0 = time.perf_counter()
    dn_cfg = dn_settings(cfg) if cdn is not None else {}
    det_cpu = dino.build_dino_from_config(
        cfg, resolution=DINO_SMALL_CANVAS, device="cpu",
        generator=torch.Generator().manual_seed(41),
        dn_labelbook_size=dn_cfg.get("dn_labelbook_size"))
    # at the init the offset heads' kernels are zero, so every sample sits
    # on the lattice of its reference point plus the directional bias:
    # on a cell border exactly, where the bilinear gradient jumps and f32
    # rounding picks the side. A trained detector's offsets vary with the
    # query: draw the kernels, as flax's lecun_normal would
    gen = torch.Generator().manual_seed(47)
    with torch.no_grad():
        for m in det_cpu.modules():
            if isinstance(m, msda.MSDeformAttnModule):
                w = m.sampling_offsets.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        / math.sqrt(w.shape[1]))
    det = copy.deepcopy(det_cpu).to("cuda")
    x = torch.randn(1, 3, *DINO_SMALL_CANVAS,
                    generator=torch.Generator().manual_seed(42))
    tgt = dino_targets(detection_cli, 1, 43, DINO_DN_TARGETS, engine, "cpu")
    pad = flat = dn = meta = None
    what = ""
    if cdn is not None:
        transforms, steps, matcher_device = cdn
        x, pad = padded_batch(transforms, x, [DINO_SMALL_VALID])
        flat = dino.level_padding_mask(pad, det_cpu.spatial_shapes)
        dn, meta = draw_cdn(dino, torch.Generator().manual_seed(49), tgt,
                            det_cpu, dn_cfg)
        what = (f", a {DINO_SMALL_VALID[0]}x{DINO_SMALL_VALID[1]} image "
                f"padded onto it, {meta['n_dn']} dn queries in "
                f"{meta['groups']} groups")

    def on(t, dev):
        return None if t is None else (
            {k: v.to(dev) for k, v in t.items()} if isinstance(t, dict)
            else t.to(dev))

    # both decoders on the CPU's two-stage selection: at a near-tie the
    # card's top-k swaps queries, and every decoder gradient then differs
    with torch.no_grad():
        topk, scores = {}, None
        for where, m in (("cpu", det_cpu), ("card", det)):
            dev = "cpu" if where == "cpu" else "cuda"
            enc = m.eval().transformer.encode(m.project(m.features(
                x.to(dev))), on(flat, dev))
            topk[where] = m.transformer.select(enc).cpu()
            if where == "cpu":
                scores = enc["enc_logits"].max(-1).values[0]
            del enc
    k = topk["cpu"].shape[1]
    by_score = scores.sort(descending=True).values
    margin = (by_score[k - 1] - by_score[k]).item()
    diff = (topk["card"][0] != topk["cpu"][0]).nonzero().flatten()
    gap = ((scores[topk["card"][0][diff]] - scores[topk["cpu"][0][diff]])
           .abs().max().item() if len(diff) else 0.0)
    for where, m in (("cpu", det_cpu), ("card", det)):
        pinned = topk["cpu"].to("cpu" if where == "cpu" else "cuda")
        m.transformer.select = lambda enc, pinned=pinned: pinned
    with torch.no_grad():
        out = det_cpu(x, dn=dn, pad_mask=pad)
        if meta is not None:    # the matching queries, after the dn ones
            out = {k: [t[:, meta["n_dn"]:] for t in v] if k in (
                "logits", "boxes") else v for k, v in out.items()}
        layers = len(engine.loss_layers(out)[0])
        assignment = engine.solve_assignments(
            engine.compute_costs(out, tgt, layers), tgt["mask"])
    del out
    metrics, grads, seconds, logs = {}, {}, {}, {}
    for where, m in (("card", det), ("cpu", det_cpu)):
        dev = "cpu" if where == "cpu" else "cuda"
        state = engine.DetectionTrainState(m, detection_optimizer(engine, m,
                                                                  cfg))
        t1 = time.perf_counter()
        before = train_launches(cuda_attention, cuda_msda)
        replay = logs["card"] if where == "cpu" else None
        with RouteLog(cuda_attention) as log_routes, \
                PinLog(msda, replay) as log:
            if cdn is None:
                metrics[where] = engine.make_detection_train_step()(
                    state, x.to(dev), on(tgt, dev), assignment)
            else:
                metrics[where] = make_cdn_train_step(
                    engine, dino, steps, matcher_device)(
                    state, x.to(dev), on(pad, dev), on(tgt, dev),
                    on(dn, dev), meta, assignment)
            torch.cuda.synchronize()
        if where == "card":
            calls = tuple(a - b for a, b in zip(
                train_launches(cuda_attention, cuda_msda), before))
            routes = log_routes
        seconds[where] = time.perf_counter() - t1
        grads[where] = {n: p.grad.detach().cpu()
                        for n, p in m.named_parameters()}
        logs[where] = log
    # the cells the CPU's own locations would have sampled against the
    # card's
    cell_flips = sum(int((a != b).sum())
                     for a, b in zip(logs["cpu"].cells, logs["card"].cells))
    coords = sum(a.numel() for a in logs["cpu"].cells)
    relus = sum(a.numel() for a in logs["cpu"].masks)
    check(len(logs["cpu"].locs) == len(logs["card"].locs)
          and len(logs["cpu"].masks) == len(logs["card"].masks),
          f"MSDA calls: CPU {len(logs['cpu'].locs)}, card "
          f"{len(logs['card'].locs)}; ReLU calls: CPU "
          f"{len(logs['cpu'].masks)}, card {len(logs['card'].masks)}")
    loss = {k: v["loss"].item() for k, v in metrics.items()}
    dloss = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    floor = 1e-5 * max(g.abs().max().item() for g in grads["cpu"].values())
    errs = {}
    for name, ref in grads["cpu"].items():
        err = (grads["card"][name] - ref).abs().max().item()
        errs[name] = err / max(ref.abs().max().item(), floor)
    ranked = sorted(errs.items(), key=lambda kv: -kv[1])
    print(f"DINO-4scale faster_vit_4_21k_224 fp32 train step b1 480x640"
          f"{what} (use_checkpoint, given assignments), card vs CPU: loss "
          f"{loss['card']:.6f} / {loss['cpu']:.6f}, relative |dloss| "
          f"{dloss:.3e} (tol {TOL_DINO_STEP_LOSS}); gradients' max|err| / "
          f"max|CPU| (floor {floor:.2e}), the 12 largest: "
          + ", ".join(f"{n} {v:.2e}" for n, v in ranked[:12])
          + f"; median {ranked[len(ranked) // 2][1]:.2e} over "
          f"{len(ranked)} tensors (tol {TOL_DINO_STEP_GRAD})"
          f"; two-stage selection: {len(diff)} of {k} positions differ "
          f"on the card (largest score gap {gap:.2e}; margin between the "
          f"{k}-th and {k + 1}-th score {margin:.2e}), both steps on the "
          f"CPU's; both steps take the card's branches: the CPU's own "
          f"MSDA locations would have sampled another cell at "
          f"{cell_flips} of {coords} coordinates over "
          f"{len(logs['cpu'].cells)} calls, its own ReLU inputs been on "
          f"the other side of 0 at {logs['cpu'].relu_flips} of {relus} "
          f"over {len(logs['cpu'].masks)} calls; K1, K2, K3, K4, K5, "
          f"K7 launches per step {calls}; K1 routes {dict(routes.k1)}, K2 "
          f"routes {dict(routes.k2)}; build {t1 - t0:.1f} s, CPU step "
          f"{seconds['cpu']:.1f} s, card {seconds['card']:.1f} s")
    check(dloss <= TOL_DINO_STEP_LOSS, f"DINO step loss card vs CPU {dloss}")
    check(gap <= TOL_DINO_FP32 * scores.abs().max().item(),
          f"two-stage selections differ by score gaps up to {gap}")
    worst, worst_name = ranked[0][1], ranked[0][0]
    check(worst <= TOL_DINO_STEP_GRAD, f"gradient of {worst_name}: card vs "
                                       f"CPU {worst} of its largest entry")
    check(calls[0] == 17 and calls[2] == 12 and calls[4] == 24
          and calls[5] == 12 and calls[1] + calls[3] == 29,
          f"DINO fp32 step launches {calls}, expected K1 17, K3 12, K5 24 "
          "(each layer's forward again under use_checkpoint), K7 12 and "
          "29 of K2 and K4")
    if cdn is not None:
        label_enc = errs["transformer.label_enc.weight"]
        print(f"  label_enc's gradient: card vs CPU {label_enc:.2e} of its "
              f"largest entry, "
              f"{grads['cpu']['transformer.label_enc.weight'].abs().max():.3e}")
        check(grads["cpu"]["transformer.label_enc.weight"].abs().max() > 0,
              "label_enc's gradient is non-zero")
    del det_cpu, det, grads, logs
    gc.collect()
    torch.cuda.empty_cache()


def dino_train_phase(cuda_attention, cuda_msda, dino, engine, detection_cli,
                     cfg) -> dict:
    """The training path at full width: DINO-4scale on faster_vit_4_21k_224
    as configured (use_checkpoint on), f32 weights and a bf16 forward by
    autocast, batch 2 at 800x1333, the fused step (the auction on the
    card): one step with its launches counted by route and plan, then 2
    steps and DINO_TRAIN_STEPS timed with CUDA events on the same batch,
    peak memory, one step profiled; then steps up to DINO_LOSS_STEPS, over
    which the loss and the class loss are finite and fall."""
    det = dino.build_dino_from_config(
        cfg, resolution=DINO_CANVAS,
        generator=torch.Generator().manual_seed(44))
    check(det.transformer.use_checkpoint, "the config's use_checkpoint")
    state = engine.DetectionTrainState(det, detection_optimizer(engine, det,
                                                                cfg))
    step = engine.make_fused_detection_train_step(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(45)
    x = torch.randn(DINO_BATCH, 3, *DINO_CANVAS, device="cuda", generator=gen)
    tgt = dino_targets(detection_cli, DINO_BATCH, 46, 20, engine, "cuda")
    losses = []
    reset_train_launches(cuda_attention, cuda_msda)
    with RouteLog(cuda_attention) as routes, \
            K5Plans(cuda_msda) as k5_plans, \
            K5Plans(cuda_msda, "ms_deform_attn_backward_cuda") as k7_plans:
        m = step(state, x, tgt)
        losses.append((m["loss"], m["loss_ce"]))
        torch.cuda.synchronize()
    calls = train_launches(cuda_attention, cuda_msda)
    print(f"DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} 800x1333 "
          f"train step (autocast, f32 weights, use_checkpoint, auction): K1, "
          f"K2, K3, K4, K5, K7 launches per step {calls}; K1 routes "
          f"{dict(routes.k1)}, K2 routes {dict(routes.k2)}")
    k5_plans.check(24, "DINO bf16 train step", vector=True)
    k7_plans.check(12, "DINO bf16 train step", vector=True)
    k7_plans.check_encoder(6, "DINO bf16 train step")
    check(calls[0] == 17 and calls[2] == 12 and calls[4] == 24
          and calls[5] == 12 and calls[1] + calls[3] == 29
          and all(calls[i] > 0 for i in (0, 2, 4, 5)),
          f"DINO bf16 train step launches {calls}, expected K1 17, K3 12, "
          "K5 24, K7 12 and 29 of K2 and K4")
    check(set(routes.k1) == {"wgmma"} and set(routes.k2) <= {"wgmma"},
          f"DINO bf16 step's K1 and K2 routes {dict(routes.k1)}, "
          f"{dict(routes.k2)}")
    check(all(dtype == "bfloat16" for dtype, _ in k5_plans.count)
          and all(dtype == "bfloat16" for dtype, _ in k7_plans.count),
          "every K5 and K7 launch of the bf16 step in bf16")
    def run():
        m = step(state, x, tgt)
        losses.append((m["loss"], m["loss_ce"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(DINO_TRAIN_STEPS):
        run()
    end.record()
    end.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / DINO_TRAIN_STEPS
    ms = start.elapsed_time(end) / DINO_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    smi = card()
    print(f"DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} 800x1333 "
          f"train step: {ms:.3f} ms a step (CUDA events over "
          f"{DINO_TRAIN_STEPS} steps after 2; host {wall_ms:.3f} ms), "
          f"{DINO_BATCH * 1000 / ms:.2f} img/s; peak memory "
          f"{peak / 2**20:.1f} MiB [{smi}]")
    prof = profile_device(run, 1, f"DINO-4scale faster_vit_4_21k_224 bf16 "
                          f"b{DINO_BATCH} 800x1333 train step", ms, smi,
                          "dino_train_profile.json")
    while len(losses) < DINO_LOSS_STEPS:
        run()
    values = [v.item() for v, _ in losses]
    ce = [c.item() for _, c in losses]

    def mean(v):
        return sum(v) / len(v)

    print(f"DINO bf16 train steps on one batch: the loss over "
          f"{len(values)} steps {[round(v, 3) for v in values]} (mean of "
          f"the first 3 {mean(values[:3]):.3f}, of the last 5 "
          f"{mean(values[-5:]):.3f}); the class loss {ce[0]:.3f} -> "
          f"{ce[-1]:.3f} (means {mean(ce[:3]):.3f}, {mean(ce[-5:]):.3f})")
    check(all(math.isfinite(v) for v in values + ce), f"DINO losses {values}")
    check(mean(values[-5:]) < mean(values[:3]) and mean(ce[-5:]) < mean(ce[:3]),
          f"DINO loss did not fall over {len(values)} steps (mean of the last "
          f"5 against the first 3): {values}, class loss {ce}")
    del det, state, x
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": calls, "ms": ms, "peak": peak, "profile": prof}


def dino_padded_serving_phase(cuda_attention, cuda_msda, dino, transforms,
                              cfg) -> dict:
    """The served detector on COCO evaluation's mixed-size batch: first in
    fp32 (TF32 off) at batch 2 on the unpadded 800x1333 canvas, an
    all-False mask against no mask (the encoder's outputs, then both
    decoders on the unmasked selection); then in bf16 at batch 2 on a
    batch of an 800x1333 image and an 800x1066 one padded onto the canvas
    by pad_to_canvas: launches by route and plan, outputs finite, 10
    batches timed after 2, peak memory."""
    det = dino.build_dino_from_config(
        cfg, resolution=DINO_CANVAS,
        generator=torch.Generator().manual_seed(51)).eval()
    gen = torch.Generator(device="cuda").manual_seed(52)
    x = torch.randn(DINO_BATCH, 3, *DINO_CANVAS, device="cuda", generator=gen)
    s = sum(h * w for h, w in det.spatial_shapes)
    with torch.no_grad():
        src = det.project(det.features(x))
        enc = det.transformer.encode(src)
        enc_m = det.transformer.encode(src, torch.zeros(
            DINO_BATCH, s, dtype=torch.bool, device="cuda"))
        topk = det.transformer.select(enc)
        diff = int((det.transformer.select(enc_m) != topk).sum())
        out = det.transformer.decode(enc, topk)
        out_m = det.transformer.decode(enc_m, topk)
    errs = {k: rel_to_largest(enc_m[k], enc[k])
            for k in ("memory", "enc_logits")}
    errs["enc_boxes"] = rel_to_largest(torch.sigmoid(enc_m["enc_unsig"]),
                                       torch.sigmoid(enc["enc_unsig"]))
    for key in ("interm_logits", "interm_boxes", "init_proposals"):
        errs[key] = rel_to_largest(out_m[key], out[key])
    for i in range(len(out["logits"])):
        errs[f"logits {i}"] = rel_to_largest(out_m["logits"][i],
                                             out["logits"][i])
        errs[f"boxes {i}"] = rel_to_largest(out_m["boxes"][i],
                                            out["boxes"][i])
    worst = max(errs, key=errs.get)
    print(f"DINO-4scale faster_vit_4_21k_224 fp32 b{DINO_BATCH} "
          f"{DINO_CANVAS[0]}x{DINO_CANVAS[1]}, an all-False mask against no "
          f"mask, max|diff| / max|unmasked| (tol {TOL_DINO_MASK}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; worst {worst}; the masked selection differs at {diff} of "
          f"{topk.numel()} positions (both decoders on the unmasked one)")
    check(errs[worst] <= TOL_DINO_MASK,
          f"DINO all-False mask against no mask: {worst} off by "
          f"{errs[worst]}")
    del src, enc, enc_m, out, out_m

    det16 = det.to(torch.bfloat16)  # the same weights, now bf16
    x16, pad = padded_batch(transforms, x, DINO_PAD_VALID)
    x16 = x16.bfloat16()
    del x
    sizes = torch.tensor(DINO_PAD_VALID, device="cuda")
    with torch.no_grad():
        reset_launches(cuda_attention, cuda_msda)
        with RouteLog(cuda_attention) as routes, \
                K5Plans(cuda_msda) as plans:
            out = det16(x16, pad_mask=pad)
            torch.cuda.synchronize()
        calls = detection_launches(cuda_attention, cuda_msda)
        post = dino.postprocess(out, sizes)
    what = (f"DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} "
            f"{DINO_CANVAS[0]}x{DINO_CANVAS[1]} padded batch (images "
            f"{DINO_PAD_VALID})")
    routes.check(17, 0, "wgmma", what)
    plans.check(12, what, vector=True)
    plans.check_queries({s: 6, det16.num_queries: 6}, what)
    q, kc = det16.num_queries, det16.num_classes
    finite = all(bool(torch.isfinite(t).all()) for t in
                 out["logits"] + out["boxes"] + list(post.values()))
    print(f"{what}: K1, K3, K5 launches per forward {calls}; outputs and "
          f"detections finite: {finite}")
    check(calls == (17, 12, 12), f"padded DINO serving K1, K3, K5 launches "
                                 f"{calls}, expected 17, 12, 12")
    check(finite and out["logits"][-1].shape == (DINO_BATCH, q, kc)
          and post["boxes"].shape == (DINO_BATCH, 300, 4),
          "padded DINO bf16 outputs finite, of the expected shapes")
    del out, post

    run = lambda: det16(x16, pad_mask=pad)
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
    print(f"{what} eager: {ms:.3f} ms per batch (CUDA events over 10 "
          f"batches after 2; host {wall_ms:.3f} ms), "
          f"{DINO_BATCH * 1000 / ms:.2f} img/s; peak memory "
          f"{peak / 2**20:.1f} MiB [{card()}]")
    del det16, x16, det
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": calls, "ms": ms, "peak": peak}


def dino_cdn_train_phase(cuda_attention, cuda_msda, dino, engine, steps,
                         matcher_device, transforms, detection_cli,
                         cfg) -> dict:
    """The training path with contrastive denoising on a padded batch: the
    served detector as configured (use_checkpoint, label_enc), f32
    weights and a bf16 forward by autocast, batch 2 on the 800x1333 canvas
    (an 800x1333 image and an 800x1066 one padded onto it), targets padded
    to DINO_DN_TARGETS, the config's dn queries drawn afresh each step
    (5 groups, 200 queries: the decoder runs at Q 1,100),
    make_cdn_train_step with the auction: one step's launches by route,
    plan and Q, 10 steps timed after 2, peak memory, one step profiled;
    then steps up to DINO_LOSS_STEPS, over which the loss falls."""
    dn_cfg = dn_settings(cfg)
    det = dino.build_dino_from_config(
        cfg, resolution=DINO_CANVAS,
        generator=torch.Generator().manual_seed(54),
        dn_labelbook_size=dn_cfg["dn_labelbook_size"])
    check(det.transformer.use_checkpoint and det.label_enc is not None,
          "the config's use_checkpoint, and label_enc")
    state = engine.DetectionTrainState(det, detection_optimizer(engine, det,
                                                                cfg))
    step = make_cdn_train_step(engine, dino, steps, matcher_device,
                               torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(55)
    x = torch.randn(DINO_BATCH, 3, *DINO_CANVAS, device="cuda", generator=gen)
    x, pad = padded_batch(transforms, x, DINO_PAD_VALID)
    tgt = dino_targets(detection_cli, DINO_BATCH, 56, DINO_DN_TARGETS, engine,
                       "cuda")
    draws = torch.Generator().manual_seed(57)
    losses = []

    def run():
        dn, meta = draw_cdn(dino, draws, tgt, det, dn_cfg)
        m = step(state, x, pad, tgt, dn, meta)
        losses.append((m["loss"], m["loss_ce"], m["loss_dn"]))
        return meta

    s = sum(h * w for h, w in det.spatial_shapes)
    reset_train_launches(cuda_attention, cuda_msda)
    with RouteLog(cuda_attention) as routes, \
            K5Plans(cuda_msda) as k5_plans, \
            K5Plans(cuda_msda, "ms_deform_attn_backward_cuda") as k7_plans:
        meta = run()
        torch.cuda.synchronize()
    calls = train_launches(cuda_attention, cuda_msda)
    q = meta["n_dn"] + det.num_queries
    what = (f"DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} 800x1333 "
            f"padded train step with CDN ({meta['n_dn']} dn queries in "
            f"{meta['groups']} groups, decoder Q {q})")
    print(f"{what}: K1, K2, K3, K4, K5, K7 launches per step {calls}; K1 "
          f"routes {dict(routes.k1)}, K2 routes {dict(routes.k2)}")
    check(meta["n_dn"] == 200 and meta["groups"] == 5,
          f"CDN groups {meta}, expected 5 groups, 200 dn queries")
    k5_plans.check(24, what, vector=True)
    k7_plans.check(12, what, vector=True)
    k7_plans.check_encoder(6, what)
    k5_plans.check_queries({s: 12, q: 12}, what)
    k7_plans.check_queries({s: 6, q: 6}, what)
    check(calls[0] == 17 and calls[2] == 12 and calls[4] == 24
          and calls[5] == 12 and calls[1] + calls[3] == 29,
          f"CDN train step launches {calls}, expected K1 17, K3 12, K5 24, "
          "K7 12 and 29 of K2 and K4")
    check(set(routes.k1) == {"wgmma"} and set(routes.k2) <= {"wgmma"},
          f"CDN step's K1 and K2 routes {dict(routes.k1)}, {dict(routes.k2)}")
    check(all(dtype == "bfloat16" for dtype, _ in k5_plans.count)
          and all(dtype == "bfloat16" for dtype, _ in k7_plans.count),
          "every K5 and K7 launch of the CDN step in bf16")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(DINO_TRAIN_STEPS):
        run()
    end.record()
    end.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / DINO_TRAIN_STEPS
    ms = start.elapsed_time(end) / DINO_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    smi = card()
    print(f"{what}: {ms:.3f} ms a step (CUDA events over {DINO_TRAIN_STEPS} "
          f"steps after 2, each with its draw of the dn queries; host "
          f"{wall_ms:.3f} ms), {DINO_BATCH * 1000 / ms:.2f} img/s; peak "
          f"memory {peak / 2**20:.1f} MiB [{smi}]")
    prof = profile_device(run, 1, f"DINO-4scale faster_vit_4_21k_224 bf16 "
                          f"b{DINO_BATCH} 800x1333 padded CDN train step", ms,
                          smi, "dino_cdn_train_profile.json")
    while len(losses) < DINO_LOSS_STEPS:
        run()
    values, ce, dn_loss = ([t.item() for t in col] for col in zip(*losses))

    def mean(v):
        return sum(v) / len(v)

    print(f"DINO bf16 CDN train steps on one padded batch: the loss over "
          f"{len(values)} steps {[round(v, 3) for v in values]} (mean of "
          f"the first 3 {mean(values[:3]):.3f}, of the last 5 "
          f"{mean(values[-5:]):.3f}); the class loss means "
          f"{mean(ce[:3]):.3f} -> {mean(ce[-5:]):.3f}, the dn loss "
          f"{mean(dn_loss[:3]):.3f} -> {mean(dn_loss[-5:]):.3f}")
    check(all(math.isfinite(v) for v in values + ce + dn_loss),
          f"CDN losses {values}")
    check(mean(values[-5:]) < mean(values[:3]),
          f"CDN loss did not fall over {len(values)} steps (mean of the last "
          f"5 against the first 3): {values}")
    del det, state, x
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": calls, "ms": ms, "peak": peak, "profile": prof}


def dino_train_cli_phase(cuda_attention, cuda_msda, detection_cli) -> None:
    """The training CLI on the card: one synthetic epoch of the served
    config at 800x800 in bf16 (4 steps of batch 2, then 2 evaluation
    batches), once with each matcher; its best weights under TMPDIR."""
    for matcher in ("auction", "host"):
        with tempfile.TemporaryDirectory() as tmp:
            reset_train_launches(cuda_attention, cuda_msda)
            t0 = time.perf_counter()
            result = detection_cli.main([
                "--config", str(REPO / DINO_CONFIG), "--synthetic",
                "--image-size", "800", "--dtype", "bfloat16", "--epochs",
                "1", "--matcher", matcher, "--output", tmp])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            calls = train_launches(cuda_attention, cuda_msda)
            best = Path(tmp) / "best.pth"
            size = best.stat().st_size if best.exists() else 0
        print(f"detection training CLI (--synthetic --dtype bfloat16 "
              f"--epochs 1 --matcher {matcher}, {DINO_CONFIG}, 800x800, 4 "
              f"steps of 2 and 2 eval batches): {seconds:.1f} s; {result}; "
              f"best.pth {size / 2**20:.1f} MiB; K1, K2, K3, K4, K5, K7 "
              f"launches {calls}")
        check(size > 0 and math.isfinite(result["loss"])
              and result["best_mAP"] >= 0,
              f"the training CLI with --matcher {matcher}: {result}")
        check(calls[5] == 4 * 12 and calls[4] == 4 * 24 + 2 * 12,
              f"training CLI K5, K7 launches {calls[4:]}, expected "
              f"{4 * 24 + 2 * 12} and {4 * 12}")


def motr_exact_pair(motr_exact, canvas, device, seed: int,
                    lite: bool = False):
    """The checkpoint-exact MOTRv2 detector and its QIMv2 at the served
    widths for `canvas`, f32, random weights from `seed`, in eval mode."""
    return motr_exact.build_motr_exact(
        canvas, device=device, generator=torch.Generator().manual_seed(seed),
        num_queries=MOTR_QUERIES, lite_encoder=lite)


def motr_clip(canvas, frames: int, seed: int, device):
    """A synthetic clip: one N(0, 1) image shifted 8 pixels right a frame,
    (3, H, W) f32 tensors on `device`, and each frame's MOTR_PROPOSALS
    proposals (cxcywh normalised + score) drifting with it, from numpy."""
    rng = np.random.RandomState(seed)
    base = torch.from_numpy(rng.randn(3, *canvas).astype(np.float32))
    clip = [torch.roll(base, 8 * f, dims=2).to(device) for f in range(frames)]
    boxes = np.concatenate([rng.uniform(0.2, 0.7, (MOTR_PROPOSALS, 2)),
                            rng.uniform(0.03, 0.2, (MOTR_PROPOSALS, 2))], -1)
    scores = rng.uniform(0.3, 0.95, (MOTR_PROPOSALS, 1))
    props = []
    for f in range(frames):
        moved = boxes + np.asarray([8 * f / canvas[1], 0, 0, 0])
        props.append(np.concatenate([moved, scores], -1).astype(np.float32))
    return clip, props


class MotrRecorder:
    """Each forward of a MOTR detector, its last layer's logits and boxes
    copied to the host (a forward hook)."""

    def __init__(self, det):
        self.seen = []
        self.handle = det.register_forward_hook(self._keep)

    def _keep(self, module, args, out):
        self.seen.append({"logits": out["logits"][-1].detach().float().cpu(),
                          "boxes": out["boxes"][-1].detach().float().cpu()})

    def close(self):
        self.handle.remove()


def motr_thresholds(scores: torch.Tensor) -> float:
    """A birth threshold from one frame's fresh-query scores: midway across
    the widest gap between the 2nd and the 7th highest, so that 2 to 6
    tracks are born, with the most room on either side."""
    top = scores.flatten().sort(descending=True).values
    k = int((top[1:6] - top[2:7]).argmax()) + 1
    return float((top[k] + top[k + 1]) / 2)


def run_motr(motr_exact, det, qim, frames, props, thresh: float):
    """exact_inference_sequence at the served slots with birth and filter
    threshold `thresh`, every active track written (prob_threshold 0), a
    miss tolerance of 10 (so born tracks are carried through the clip)."""
    return motr_exact.exact_inference_sequence(
        det, qim, frames, MOTR_QUERIES, det.dim, proposals_per_frame=props,
        num_proposals=MOTR_PROPOSALS, track_capacity=MOTR_CAPACITY,
        score_thresh=thresh, filter_score_thresh=thresh, miss_tolerance=10,
        prob_threshold=0.0)


def motr_fp32_phase(cuda_attention, cuda_msda, motr_exact) -> None:
    """Phase 35: the exact detector in fp32 on a 256x384 clip, 3 frames of
    exact_inference_sequence on the card (kernel path) and on the CPU (plain
    path) from the same weights: every frame's logits and boxes, and the
    track ids."""
    t0 = time.perf_counter()
    det_cpu, qim_cpu = motr_exact_pair(motr_exact, MOTR_SMALL_CANVAS, "cpu",
                                       seed=51)
    det, qim = copy.deepcopy(det_cpu).to("cuda"), copy.deepcopy(qim_cpu).to(
        "cuda")
    frames, props = motr_clip(MOTR_SMALL_CANVAS, 3, 52, "cpu")
    rec = MotrRecorder(det_cpu)
    run_motr(motr_exact, det_cpu, qim_cpu, frames[:1], props, 0.5)
    thresh = motr_thresholds(torch.sigmoid(rec.seen[0]["logits"][0, :20]))
    rec.seen.clear()
    t1 = time.perf_counter()
    want = run_motr(motr_exact, det_cpu, qim_cpu, frames, props, thresh)
    cpu_s = time.perf_counter() - t1
    rec.close()
    rec_card = MotrRecorder(det)
    before = detection_launches(cuda_attention, cuda_msda)
    got = run_motr(motr_exact, det, qim, [f.cuda() for f in frames], props,
                   thresh)
    torch.cuda.synchronize()
    calls = tuple(a - b for a, b in zip(
        detection_launches(cuda_attention, cuda_msda), before))
    rec_card.close()
    errs = {}
    for f, (a, b) in enumerate(zip(rec_card.seen, rec.seen)):
        for key in ("logits", "boxes"):
            errs[f"{key} {f}"] = rel_to_largest(a[key], b[key])
    scores = torch.sigmoid(torch.cat([r["logits"].flatten()
                                      for r in rec.seen]))
    margin = (scores - thresh).abs().min().item()
    ids = [r["ids"].tolist() for r in want]
    same = all(np.array_equal(a["ids"], b["ids"]) for a, b in zip(got, want))
    worst = max(errs, key=errs.get)
    print(f"MOTRv2 exact fp32 {MOTR_SMALL_CANVAS[0]}x{MOTR_SMALL_CANVAS[1]}, "
          f"3 frames, card vs CPU, max|err| / max|CPU| (tol "
          f"{TOL_MOTR_FP32}): " + ", ".join(f"{k} {v:.2e}"
                                            for k, v in errs.items())
          + f"; track ids equal: {same} (CPU {ids}; threshold {thresh:.4f},"
          f" nearest score {margin:.2e} from it); K1, K3, K5 launches over "
          f"the clip {calls}; build and threshold {t1 - t0:.1f} s, CPU "
          f"{cpu_s:.1f} s [{card()}]")
    check(all(v <= TOL_MOTR_FP32 for v in errs.values()),
          f"MOTR fp32 card vs CPU: {worst} off by {errs[worst]}")
    check(same or margin <= TOL_MOTR_FP32,
          f"MOTR fp32 track ids differ: card "
          f"{[r['ids'].tolist() for r in got]}, CPU {ids}")
    check(len({i for r in ids for i in r}) >= 2 and all(ids),
          f"MOTR fp32: tracks born and carried in every frame: {ids}")
    check(calls[2] == 3 * 12, f"MOTR fp32 K5 launches {calls[2]}, expected "
                              "12 a frame")
    for f, r in enumerate(got):
        check(bool(np.isfinite(r["boxes"]).all()),
              f"MOTR fp32 frame {f} boxes finite")


def check_motr_k5_plans(plans, cuda_msda, what: str) -> None:
    """Every K5 launch counted by `plans` bf16 on msda_plan's plan for
    MOTR's heads (D 32, value 16-byte aligned)."""
    served = cuda_msda.msda_plan(32, torch.bfloat16,
                                 cuda_msda.MAX_VECTOR_BYTES)
    ran = {(dtype, plan) for dtype, plan in plans.count}
    check(ran == {("bfloat16", served)}, f"{what}: K5 plans {ran}, "
                                         f"expected msda_plan's {served}")


def motr_k5_check(cuda_msda, msda, inputs, what: str) -> dict:
    """K5 at a captured encoder call against its plain version on the
    card (bf16: ≤ 2^-8 of max(1, max|plain|)), two launches bit-identical,
    then kernel (with the model's bf16 locations, which the binding widens;
    with f32 ones; and all in f32, as msda_pallas_probe's encoder call
    times it) and plain version timed, and the bound."""
    kernel, plain = cuda_msda.ms_deform_attn_cuda, msda.msda_reference
    value, shapes, loc, w = inputs
    n, s, m, d = value.shape
    q, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    got = kernel(value, shapes, loc, w)
    plan = kernel.last_plan
    want = plain(value.float(), shapes, loc.float(), w.float())
    err = ((got.float() - want).abs().max()
           / want.abs().max().clamp(min=1.0)).item()
    same = torch.equal(kernel(value, shapes, loc, w), got)
    del want
    loc32 = loc.float()
    plain_ms, ms, _ = in_turns(lambda: plain(value, shapes, loc, w),
                               lambda: kernel(value, shapes, loc, w), None, 5)
    ms32 = time_ms(lambda: kernel(value, shapes, loc32, w), iters=20)
    v32, w32 = value.float(), w.float()
    ms_f32 = time_ms(lambda: kernel(v32, shapes, loc32, w32), iters=20)
    del v32, w32, loc32
    nbytes = value.element_size() * (value.numel() + w.numel() + n * q * m
                                     * d) + loc.element_size() * loc.numel()
    samples = n * q * m * nl * p
    flops = samples * (8.0 * d + 18)
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
    by = ("operations" if flops / F32_FLOP_PER_S > nbytes / HBM_BYTES_PER_S
          else "bytes")
    print(f"K5 at {what} (N={n} Q={q} over S={s} values, M={m} D={d} P={p}, "
          f"{value.dtype} value, {loc.dtype} locations): max|err| / max(1, "
          f"max|plain|) {err:.3e} (tol {2 ** -8:.3e}), two launches "
          f"bit-identical {same}, plan (G, V) ({plan.lanes}, {plan.vec}); "
          f"kernel {ms:.4f} ms ({samples / ms / 1e6:.1f} G samples/s; with "
          f"f32 locations {ms32:.4f}; all f32 {ms_f32:.4f}), plain "
          f"{plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP "
          f"f32, {by}) [{card()}]")
    check(err <= 2 ** -8 and same, f"K5 at {what}: error {err}, "
                                   f"bit-identical {same}")
    check(value.dtype != torch.bfloat16 or plan.vec > 1,
          f"K5 at {what} on scalar loads: {plan}")
    return {"Q": q, "S": s, "ms": ms, "ms_f32_locations": ms32,
            "ms_all_f32": ms_f32,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "max_abs_err": err, "g_samples_s": samples / ms / 1e6,
            "plan": plan._asdict()}


def motr_k3_check(cuda_attention, attention, first, what: str) -> list:
    """K3 at each captured call of the frame (the any-res carriers) against
    its plain version on the same card tensors, bf16 against f32 on the
    bf16 inputs: max|err| over max(1, max|plain|) within TOL_BF16 (K3's
    bf16 bound, which k3_phase holds on N(0, 1) inputs, whose outputs lie
    within ±1); its route and plan; kernel and plain version timed in
    turns beside the bound."""
    kernel = cuda_attention.window_mhsa_long_cuda
    plain = attention.window_mhsa_long_reference
    calls = []
    for qkv, bias, h, scale in first.inputs.values():
        b, s, c3 = qkv.shape
        d = c3 // 3 // h
        got = kernel(qkv, bias, h, scale)
        check_plan(kernel, cuda_attention, qkv.dtype == torch.bfloat16, d,
                   bias.dtype, f"K3 at {what}")
        want = plain(qkv.float(), bias.float(), h, scale)
        err, err_abs = rel_err(got, want), (got.float() - want).abs().max(
            ).item()
        largest = want.abs().max().item()
        plain_ms, ms, _ = in_turns(lambda: plain(qkv, bias, h, scale),
                                   lambda: kernel(qkv, bias, h, scale),
                                   None, 10)
        nbytes = qkv.element_size() * (qkv.numel() + b * s * c3 // 3) \
            + bias.element_size() * bias.numel()
        flops = 4.0 * b * h * s * s * d
        bound = bound_ms(nbytes, flops)
        by = ("operations" if flops / BF16_FLOP_PER_S
              > nbytes / HBM_BYTES_PER_S else "bytes")
        print(f"K3 at {what} (B={b} S={s} H={h} hd={d}, {qkv.dtype} qkv, "
              f"{bias.dtype} bias): max|err| {err_abs:.3e}, over max(1, "
              f"max|plain| {largest:.3f}) {err:.3e} (tol {TOL_BF16}), route "
              f"{kernel.last_plan.route}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}) [{card()}]")
        check(err <= TOL_BF16, f"K3 at {what} {(b, s, h, d)}: error {err}")
        calls.append({"shape": [b, s, h, d], "max_abs_err": err_abs,
                      "max_err_over_max1_plain": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by})
    check(bool(calls), f"K3 at {what}: no launch captured")
    return calls


def unit_scaled(g: torch.Tensor) -> torch.Tensor:
    """g times the power of two that puts its largest |entry| in [1, 2):
    exact in any float type at a training gradient's magnitudes, so the
    kernel's function is the same; a check relative to the largest entry
    with a floor (rel_to_largest's 1e-6) then sees the error of a g whose
    entries all lie below the floor. An all-zero g fails."""
    top = g.abs().max().item()
    check(top > 0 and math.isfinite(top), f"grad_out's largest |entry| "
                                          f"{top}")
    return g * 2.0 ** -math.floor(math.log2(top))


def motr_k4_check(cuda_attention, attention, first, what: str) -> list:
    """K4 at each captured call of the train step (the any-res carriers)
    against its plain version on the same card tensors, g `unit_scaled`,
    f32 on the bf16 inputs: max|err| of dqkv and dbias over their largest
    |plain| entry within TOL_K4_BF16 (k4_phase's bf16 bound), two launches
    bit-identical, its route and plan; kernel and plain version timed in
    turns beside the bound (k4_phase's count)."""
    kernel = cuda_attention.window_mhsa_long_backward_cuda
    plain = attention.window_mhsa_backward_reference
    calls = []
    for qkv, bias, g_step, h, scale in first.inputs.values():
        g = unit_scaled(g_step)
        b, s, c3 = qkv.shape
        d = c3 // 3 // h
        bf16 = qkv.dtype == torch.bfloat16
        got = kernel(qkv, bias, g, h, scale)
        check_bwd_plan(cuda_attention, bf16, d, bias.dtype,
                       f"K4 at {what} {(b, s, h, d)}")
        want = plain(qkv.float(), bias.float(), g.float(), h, scale)
        err = max(rel_to_largest(got[0], want[0]),
                  rel_to_largest(got[1], want[1]))
        err_abs = max((got[i].float() - want[i]).abs().max().item()
                      for i in range(2))
        largest = [want[i].abs().max().item() for i in range(2)]
        again = kernel(qkv, bias, g, h, scale)
        same = torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
        del want, again
        plain_ms, ms, _ = in_turns(lambda: plain(qkv, bias, g, h, scale),
                                   lambda: kernel(qkv, bias, g, h, scale),
                                   None, 10)
        nbytes = (qkv.element_size() * 2 * qkv.numel()
                  + g.element_size() * g.numel()
                  + bias.element_size() * 2 * bias.numel())
        flops = 10.0 * b * h * s * s * d
        bound = bound_ms(nbytes, flops)
        by = ("operations" if flops / BF16_FLOP_PER_S
              > nbytes / HBM_BYTES_PER_S else "bytes")
        print(f"K4 at {what} (B={b} S={s} H={h} hd={d}, {qkv.dtype} qkv, "
              f"{bias.dtype} bias, {g.dtype} g, the step's largest |g| "
              f"{g_step.abs().max().item():.3e} scaled to "
              f"{g.abs().max().item():.3f}): max|err| {err_abs:.3e}, "
              f"max|plain| of dqkv {largest[0]:.3e}, of dbias "
              f"{largest[1]:.3e}; max|err| over max|plain| {err:.3e} (tol "
              f"{TOL_K4_BF16}), two launches bit-identical {same}, route "
              f"{kernel.last_plan.route}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}) [{card()}]")
        check(err <= TOL_K4_BF16 and same,
              f"K4 at {what} {(b, s, h, d)}: error {err}, bit-identical "
              f"{same}")
        calls.append({"shape": [b, s, h, d], "max_abs_err": err_abs,
                      "max_err_over_max_plain": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by})
    check(bool(calls), f"K4 at {what}: no launch captured")
    return calls


def time_clip(motr_exact, det, qim, frames, props, thresh: float):
    """run_motr over the clip, each frame timed on the host clock (a frame
    ends with its outputs on the host): (results, ms a frame)."""
    starts = []

    def timed():
        for f in frames:
            starts.append(time.perf_counter())
            yield f

    results = run_motr(motr_exact, det, qim, timed(), props, thresh)
    torch.cuda.synchronize()
    starts.append(time.perf_counter())
    return results, [1e3 * (b - a) for a, b in zip(starts[:-1], starts[1:])]


def motr_clip_phase(cuda_attention, cuda_msda, attention, msda,
                    motr_exact, lite: bool) -> dict:
    """Phase 36: the exact detector in bf16 at 800x1536 on an 8-frame clip
    with proposals. Frame 0 alone first: the birth threshold from its
    scores, its K1 launches by route, its K5 launches by plan and Q, K5 at
    the encoder call and K3 at the carriers held to their plain versions
    on the frame's own inputs. Then the clip, its launches counted from 0
    and its frames timed on the host clock; the median after MOTR_WARMUP
    frames; peak memory; one frame profiled."""
    name = "lite encoder" if lite else "exact"
    enc_q = MOTR_LITE_Q if lite else MOTR_ENC_Q
    t0 = time.perf_counter()
    det, qim = motr_exact_pair(motr_exact, MOTR_CANVAS, "cuda", seed=41,
                               lite=lite)
    det = det.to(torch.bfloat16)
    frames, props = motr_clip(MOTR_CANVAS, MOTR_FRAMES, 42, "cuda")
    build_s = time.perf_counter() - t0
    rec = MotrRecorder(det)
    reset_launches(cuda_attention, cuda_msda)
    with RouteLog(cuda_attention) as routes, \
            K5Plans(cuda_msda, capture_q=enc_q) as plans, \
            FirstLaunches(cuda_attention, "window_mhsa_long_cuda") as k3s, \
            torch.no_grad():
        run_motr(motr_exact, det, qim, frames[:1], props, 0.5)
        torch.cuda.synchronize()
    frame_calls = detection_launches(cuda_attention, cuda_msda)
    thresh = motr_thresholds(torch.sigmoid(rec.seen[0]["logits"][0, :20]))
    rec.close()
    what = f"MOTRv2 {name} bf16 {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]} frame"
    print(f"{what}: K1, K3, K5 launches {frame_calls}; K1 routes "
          f"{dict(routes.k1)}")
    check(routes.k1 == collections.Counter({"wgmma": frame_calls[0]})
          and frame_calls[0] > 0, f"{what}: K1 routes {dict(routes.k1)}")
    plans.check(12, what, vector=True)
    plans.check_queries({enc_q: 6, MOTR_DEC_Q: 6}, what)
    check_motr_k5_plans(plans, cuda_msda, what)
    k5_call = motr_k5_check(cuda_msda, msda, plans.inputs,
                            f"MOTR's {name} encoder call")
    k3_calls = motr_k3_check(cuda_attention, attention, k3s,
                             f"MOTR's {name} carrier attention")
    del plans, k3s

    reset_launches(cuda_attention, cuda_msda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, frame_ms = time_clip(motr_exact, det, qim, frames, props,
                                  thresh)
    calls = detection_launches(cuda_attention, cuda_msda)
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(frame_ms[MOTR_WARMUP:]))
    ids = [r["ids"].tolist() for r in results]
    smi = card()
    print(f"MOTRv2 {name} bf16 {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]} "
          f"{MOTR_FRAMES}-frame clip: K1, K3, K5 launches {calls}; ms a "
          f"frame {[round(t, 3) for t in frame_ms]}, median after "
          f"{MOTR_WARMUP} {median:.3f} ms ({1e3 / median:.2f} frames/s); "
          f"peak memory {peak / 2**20:.1f} MiB; track ids {ids} (threshold "
          f"{thresh:.4f}); build {build_s:.1f} s [{smi}]")
    check(calls == tuple(MOTR_FRAMES * c for c in frame_calls),
          f"{name} clip launches {calls}, expected {MOTR_FRAMES} x "
          f"{frame_calls}")
    check(len({i for r in ids for i in r}) >= 2 and all(ids[1:]),
          f"{name} clip: tracks born and carried: {ids}")
    check(all(np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"])
              .all() for r in results), f"{name} clip outputs finite")
    out = {"launches": calls, "frame_launches": frame_calls, "ms": median,
           "frame_ms": frame_ms, "peak_mib": peak / 2**20, "k5": k5_call,
           "k3": k3_calls, "thresh": thresh}
    with torch.no_grad():
        out["profile"] = profile_device(
            lambda: run_motr(motr_exact, det, qim, frames[:1], props,
                             thresh), 1,
            f"MOTRv2 {name} bf16 {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]} frame",
            median, smi, "motr_lite_frame_profile.json" if lite
            else "motr_frame_profile.json")
    del det, qim, frames
    gc.collect()
    torch.cuda.empty_cache()
    return out


def motr_turns(motr_exact, exact: dict, lite: dict) -> dict:
    """The exact and the lite-encoder clip timed in turns, MOTR_TURNS
    rounds (exact first in even rounds, lite first in odd ones): each
    run's median ms a frame after MOTR_WARMUP, and the median of each
    path's frames after warm-up pooled over its runs. A host-bound frame
    spreads from run to run; this says whether the two paths' order holds
    across runs taken side by side. The models, clip and thresholds are
    phase 36's, built again here."""
    frames, props = motr_clip(MOTR_CANVAS, MOTR_FRAMES, 42, "cuda")
    paths = {}
    for key, phase in (("exact", exact), ("lite", lite)):
        det, qim = motr_exact_pair(motr_exact, MOTR_CANVAS, "cuda", seed=41,
                                   lite=key == "lite")
        paths[key] = (det.to(torch.bfloat16), qim, frames, props,
                      phase["thresh"])
    runs = {"exact": [], "lite": []}
    pooled = {"exact": [], "lite": []}
    for r in range(MOTR_TURNS):
        for key in (("exact", "lite") if r % 2 == 0 else ("lite", "exact")):
            _, frame_ms = time_clip(motr_exact, *paths[key])
            runs[key].append(float(np.median(frame_ms[MOTR_WARMUP:])))
            pooled[key] += frame_ms[MOTR_WARMUP:]
    out = {k: {"run_medians": runs[k],
               "pooled_median": float(np.median(pooled[k])),
               "frames": len(pooled[k])} for k in runs}
    lite_wins = sum(a > b for a, b in zip(runs["exact"], runs["lite"]))
    print(f"MOTRv2 bf16 {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]}, exact and lite "
          f"encoder in turns ({MOTR_TURNS} rounds of a {MOTR_FRAMES}-frame "
          f"clip each): ms a frame, each run's median after {MOTR_WARMUP}: "
          f"exact {[round(t, 3) for t in runs['exact']]}, lite "
          f"{[round(t, 3) for t in runs['lite']]}; pooled medians exact "
          f"{out['exact']['pooled_median']:.3f} ms, lite "
          f"{out['lite']['pooled_median']:.3f} ms over "
          f"{out['exact']['frames']} frames each; lite faster in "
          f"{lite_wins} of {MOTR_TURNS} rounds [{card()}]")
    out["lite_faster_rounds"] = lite_wins
    del paths, frames
    gc.collect()
    torch.cuda.empty_cache()
    return out


def motr_default_phase(cuda_attention, cuda_msda, motr) -> tuple:
    """Phase 37: the JAX package's own MOTRDetector at the submit CLI's
    defaults in bf16 at 800x1536, 3 frames of motr_inference_sequence with
    the CLI's thresholds: launches by route, plan and Q a frame."""
    nq, layers = MOTR_DEFAULT_QUERIES, MOTR_DEFAULT_LAYERS
    det = motr.build_motr_detector(
        MOTR_CANVAS, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(43), num_detect_queries=nq,
        num_track_queries=nq, num_proposal_queries=MOTR_PROPOSALS,
        enc_layers=layers, dec_layers=layers)
    frames, props = motr_clip(MOTR_CANVAS, 3, 44, "cuda")
    reset_launches(cuda_attention, cuda_msda)
    with RouteLog(cuda_attention) as routes, K5Plans(cuda_msda) as plans:
        results = motr.motr_inference_sequence(
            det, frames, num_track_slots=nq, dim=det.dim, score_thresh=0.5,
            filter_thresh=0.5, miss_tolerance=20, proposals_per_frame=props)
        torch.cuda.synchronize()
    calls = detection_launches(cuda_attention, cuda_msda)
    what = (f"MOTRDetector (submit's default path) bf16 "
            f"{MOTR_CANVAS[0]}x{MOTR_CANVAS[1]}, 3 frames")
    print(f"{what}: K1, K3, K5 launches {calls}; K1 routes "
          f"{dict(routes.k1)}; tracks a frame "
          f"{[len(r['ids']) for r in results]}")
    check(routes.k1 == collections.Counter({"wgmma": calls[0]})
          and calls[0] > 0, f"{what}: K1 routes {dict(routes.k1)}")
    plans.check(3 * 2 * layers, what, vector=True)
    plans.check_queries({MOTR_ENC_Q: 3 * layers,
                         2 * nq + MOTR_PROPOSALS: 3 * layers}, what)
    check_motr_k5_plans(plans, cuda_msda, what)
    check(all(np.isfinite(r["boxes"]).all() for r in results),
          f"{what}: boxes finite")
    del det, frames
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def motr_cli_phase() -> None:
    """Phase 38: the tracking CLI on 4 JPEG frames at 800x1536 and a
    proposal db, in a temporary directory: it runs on the card, writes
    seq01.txt, which parses as MOT rows of 4 frames."""
    from PIL import Image

    from fastervit_tpu_torch.tracking.mot_data import load_mot_file
    rng = np.random.RandomState(45)
    h, w = MOTR_CANVAS
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = Path(tmp) / "val" / "seq01" / "img1"
        img_dir.mkdir(parents=True)
        base = (np.cumsum(rng.randint(-8, 9, (h, w, 3)), 1) % 256).astype(
            np.uint8)
        db = {}
        for f in range(4):
            Image.fromarray(np.roll(base, 8 * f, axis=1)).save(
                img_dir / f"{f + 1:08d}.jpg")
            db[f"val/seq01/img1/{f + 1:08d}.txt"] = [
                f"{100 + 8 * f + 40 * i},{200 + 30 * i},120,260,"
                f"{0.9 - 0.05 * i:.2f}" for i in range(12)]
        (Path(tmp) / "det_db.json").write_text(json.dumps(db))
        out = Path(tmp) / "out"
        cmd = [sys.executable, "-m", "fastervit_tpu_torch.tracking.submit",
               "--mot-path", tmp, "--split", "val", "--exact", "--dtype",
               "bfloat16", "--max-frames", "4", "--det-db", "det_db.json",
               "--score-thresh", "0.0", "--output", str(out)]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=600)
        secs = time.perf_counter() - t0
        print(f"tracking CLI: {' '.join(cmd[1:])}: exit {run.returncode} in "
              f"{secs:.1f} s [{card()}]; its log's tail: "
              + " | ".join(run.stderr.strip().splitlines()[-3:]))
        check(run.returncode == 0, f"the tracking CLI failed: "
                                   f"{run.stderr[-2000:]}")
        rows = load_mot_file(str(out / "seq01.txt"))
        n = {f: len(r["ids"]) for f, r in sorted(rows.items())}
        print(f"tracking CLI: seq01.txt has MOT rows a frame {n}")
        check(sorted(rows) == [1, 2, 3, 4]
              and all(np.isfinite(r["boxes"]).all() for r in rows.values()),
              f"the tracking CLI's MOT file: frames {sorted(rows)}")


def motr_phases(cuda_attention, cuda_msda, attention, msda, motr,
                motr_exact, k1, k3, k5) -> None:
    """Phases 35-38, MOTRv2 streaming; the served clip's launches go into
    K1's, K3's and K5's entries of the kernels line."""
    motr_fp32_phase(cuda_attention, cuda_msda, motr_exact)
    clip = motr_clip_phase(cuda_attention, cuda_msda, attention, msda,
                           motr_exact, lite=False)
    lite = motr_clip_phase(cuda_attention, cuda_msda, attention, msda,
                           motr_exact, lite=True)
    turns = motr_turns(motr_exact, clip, lite)
    default = motr_default_phase(cuda_attention, cuda_msda, motr)
    motr_cli_phase()
    where = (f"the tracking serving path: a {MOTR_FRAMES}-frame MOTRv2 "
             f"clip, the checkpoint-exact detector bf16 "
             f"{MOTR_CANVAS[0]}x{MOTR_CANVAS[1]}")
    for entry, i in ((k1, 0), (k3, 1), (k5, 2)):
        entry["launches_motr"] = clip["launches"][i]
        entry["launches_motr_in"] = where
        entry["launches_motr_lite"] = lite["launches"][i]
        entry["launches_motr_default_path"] = default[i]
    k5["motr_encoder_call"] = clip["k5"]
    k5["motr_lite_encoder_call"] = lite["k5"]
    k3["motr_carrier_calls"] = clip["k3"]
    k3["motr_lite_carrier_calls"] = lite["k3"]
    print(f"MOTRv2 streaming bf16 {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]}: "
          f"{clip['ms']:.3f} ms a frame (lite encoder {lite['ms']:.3f}), "
          f"peak {clip['peak_mib']:.1f} MiB ({lite['peak_mib']:.1f}); K5 at "
          f"the encoder call {clip['k5']['ms']:.4f} ms (lite "
          f"{lite['k5']['ms']:.4f}); in turns, pooled medians "
          f"{turns['exact']['pooled_median']:.3f} ms (lite "
          f"{turns['lite']['pooled_median']:.3f}) [{card()}]")


def motr_train_detector(motr, canvas, device, seed: int):
    """The MOTRDetector tracking/main.py trains, at its widths (dim 256,
    60 detect and 60 track queries, 10 proposals, 3 + 3 layers) for
    `canvas`, f32, random weights from `seed`."""
    return motr.build_motr_detector(
        canvas, device=device, generator=torch.Generator().manual_seed(seed),
        num_detect_queries=MOTR_DEFAULT_QUERIES,
        num_track_queries=MOTR_DEFAULT_QUERIES,
        num_proposal_queries=MOTR_PROPOSALS, enc_layers=MOTR_DEFAULT_LAYERS,
        dec_layers=MOTR_DEFAULT_LAYERS)


def motr_train_clip(canvas, frames: int, seed: int, device):
    """A synthetic training clip of batch 1: one N(0, 1) image shifted 8
    pixels right a frame, (F, 1, 3, H, W) f32 on `device`; each frame's
    targets, identities moving with the image (1 throughout, 2 until frame
    F // 2, which it leaves, 3 from it on), as targets_per_frame; and
    MOTR_PROPOSALS proposals a frame, (F, 1, P, 5) on `device`: a jittered
    box of each identity in the frame, the rest random, scores random."""
    rng = np.random.RandomState(seed)
    h, w = canvas
    base = torch.from_numpy(rng.randn(3, h, w).astype(np.float32))
    clip = torch.stack([torch.roll(base, 8 * f, dims=2)
                        for f in range(frames)])[:, None].to(device)
    boxes = {1: (0.3, 0.4, 0.1, 0.25), 2: (0.6, 0.5, 0.08, 0.2),
             3: (0.45, 0.65, 0.12, 0.3)}
    targets, props = [], []
    for f in range(frames):
        ids = [1] + ([2] if f < frames // 2 else [3])
        bx = (np.asarray([boxes[i] for i in ids], np.float32)
              + np.asarray([8 * f / w, 0, 0, 0], np.float32))
        targets.append([{"labels": np.zeros(len(ids), np.int32),
                         "boxes": bx, "track_ids": np.asarray(ids)}])
        rest = MOTR_PROPOSALS - len(ids)
        near = bx + rng.uniform(-0.01, 0.01, bx.shape)
        far = np.concatenate([rng.uniform(0.2, 0.8, (rest, 2)),
                              rng.uniform(0.05, 0.25, (rest, 2))], -1)
        props.append(np.concatenate([np.concatenate([near, far]),
                                     rng.uniform(0.3, 0.95,
                                                 (MOTR_PROPOSALS, 1))], -1))
    return (clip, targets,
            torch.from_numpy(np.stack(props).astype(np.float32))[:, None]
            .to(device))


class SelectLog:
    """Inside `with SelectLog(det, replay) as log:`, the detector's two-stage
    selections (det.transformer.select) logged in call order (log.topk, on
    the CPU). Given `replay`, another run's SelectLog, each call selects
    replay's queries instead of its own, and log.gaps keeps, a call, the
    largest gap between the scores of its own queries and of replay's where
    they differ (0 where none does)."""

    def __init__(self, det, replay=None):
        self.tr, self.replay = det.transformer, replay

    def __enter__(self):
        self.topk, self.gaps, self.scale = [], [], 0.0
        orig = self.tr.select

        def select(enc):
            own = orig(enc)
            if self.replay is not None:
                given = self.replay.topk[len(self.topk)].to(own.device)
                scores = enc["enc_logits"].detach().float().max(-1).values
                diff = given != own
                self.gaps.append((scores.gather(1, given)
                                  - scores.gather(1, own))[diff].abs()
                                 .max().item() if diff.any() else 0.0)
                self.scale = max(self.scale, scores.abs().max().item())
                own = given
            self.topk.append(own.cpu())
            return own

        self.tr.select = select
        return self

    def __exit__(self, *exc):
        del self.tr.select


def motr_train_fp32_phase(cuda_attention, cuda_msda, msda, motr) -> None:
    """Phase 39: one fp32 clip train step of the MOTRDetector
    tracking/main.py trains (phase 40's widths) at 256x384 on a 2-frame
    clip with proposals, card against CPU (TF32 off) from the same weights:
    the matching passes' assignments equal; then the step on the CPU's
    assignments, the loss and every gradient. As in phase 30, the
    sampling-offset kernels are drawn at random (at the init every sample
    sits on a cell border) and the CPU's step takes the card's branches,
    MSDA cells, ReLU sides and two-stage selections, through its own
    autograd path (PinLog, SelectLog); how many of its own would have
    differed is printed."""
    t0 = time.perf_counter()
    det_cpu = motr_train_detector(motr, MOTR_SMALL_CANVAS, "cpu", seed=53)
    gen = torch.Generator().manual_seed(54)
    with torch.no_grad():
        for m in det_cpu.modules():
            if isinstance(m, msda.MSDeformAttnModule):
                w = m.sampling_offsets.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        / math.sqrt(w.shape[1]))
    det = copy.deepcopy(det_cpu).to("cuda")
    frames, targets, props = motr_train_clip(MOTR_SMALL_CANVAS, 2, 55, "cpu")
    assignments = {}
    with torch.no_grad():
        for where, m in (("cpu", det_cpu), ("card", det)):
            dev = "cpu" if where == "cpu" else "cuda"
            outs = motr.motr_clip_forward(m, frames.to(dev), props.to(dev))
            assignments[where] = motr.clip_assignments(outs, targets, 10)
            del outs
    same_assignment = np.array_equal(assignments["card"],
                                     assignments["cpu"])
    metrics, grads, logs, selects, seconds = {}, {}, {}, {}, {}
    for where, m in (("card", det), ("cpu", det_cpu)):
        dev = "cpu" if where == "cpu" else "cuda"
        state = motr_state(motr, m)
        replay = where == "cpu"
        t1 = time.perf_counter()
        before = train_launches(cuda_attention, cuda_msda)
        with PinLog(msda, logs["card"] if replay else None) as log, \
                SelectLog(m, selects["card"] if replay else None) as sel:
            metrics[where] = motr.make_motr_clip_train_step()(
                state, frames.to(dev), targets, props.to(dev),
                assignments["cpu"])
            torch.cuda.synchronize()
        if where == "card":
            calls = tuple(a - b for a, b in zip(
                train_launches(cuda_attention, cuda_msda), before))
        seconds[where] = time.perf_counter() - t1
        grads[where] = {n: (p.grad if p.grad is not None
                            else torch.zeros_like(p)).detach().cpu()
                        for n, p in m.named_parameters()}
        logs[where], selects[where] = log, sel
    cell_flips = sum(int((a != b).sum())
                     for a, b in zip(logs["cpu"].cells, logs["card"].cells))
    coords = sum(a.numel() for a in logs["cpu"].cells)
    relus = sum(a.numel() for a in logs["cpu"].masks)
    check(len(logs["cpu"].locs) == len(logs["card"].locs)
          and len(logs["cpu"].masks) == len(logs["card"].masks)
          and len(selects["cpu"].topk) == len(selects["card"].topk),
          f"MSDA calls: CPU {len(logs['cpu'].locs)}, card "
          f"{len(logs['card'].locs)}; ReLU calls: CPU "
          f"{len(logs['cpu'].masks)}, card {len(logs['card'].masks)}; "
          f"selections: CPU {len(selects['cpu'].topk)}, card "
          f"{len(selects['card'].topk)}")
    loss = {k: v["loss"].item() for k, v in metrics.items()}
    dloss = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    floor = 1e-5 * max(g.abs().max().item() for g in grads["cpu"].values())
    errs = {}
    for name, ref in grads["cpu"].items():
        err = (grads["card"][name] - ref).abs().max().item()
        errs[name] = err / max(ref.abs().max().item(), floor)
    ranked = sorted(errs.items(), key=lambda kv: -kv[1])
    gap = max(selects["cpu"].gaps)
    print(f"MOTRDetector fp32 clip train step, 2 frames at "
          f"{MOTR_SMALL_CANVAS[0]}x{MOTR_SMALL_CANVAS[1]} with proposals, "
          f"card vs CPU: matching passes' assignments equal "
          f"{same_assignment} ({assignments['cpu'][:, 0, :3].tolist()}); "
          f"loss {loss['card']:.6f} / {loss['cpu']:.6f}, relative |dloss| "
          f"{dloss:.3e} (tol {TOL_MOTR_STEP_LOSS}); gradients' max|err| / "
          f"max|CPU| (floor {floor:.2e}), the 12 largest: "
          + ", ".join(f"{n} {v:.2e}" for n, v in ranked[:12])
          + f"; median {ranked[len(ranked) // 2][1]:.2e} over "
          f"{len(ranked)} tensors (tol {TOL_MOTR_STEP_GRAD}); both steps "
          f"take the card's branches: the CPU's own two-stage selections "
          f"differ by score gaps up to {gap:.2e} over "
          f"{len(selects['cpu'].topk)} calls, its own MSDA locations would "
          f"have sampled another cell at {cell_flips} of {coords} "
          f"coordinates over {len(logs['cpu'].cells)} calls, its own ReLU "
          f"inputs been on the other side of 0 at "
          f"{logs['cpu'].relu_flips} of {relus}; K1, K2, K3, K4, K5, K7 "
          f"launches per step {calls}; CPU step {seconds['cpu']:.1f} s, "
          f"card {seconds['card']:.1f} s, "
          f"phase {time.perf_counter() - t0:.1f} s")
    check(same_assignment, f"MOTR matching passes' assignments: card "
                           f"{assignments['card'].tolist()}, CPU "
                           f"{assignments['cpu'].tolist()}")
    check(dloss <= TOL_MOTR_STEP_LOSS, f"MOTR step loss card vs CPU {dloss}")
    check(gap <= TOL_MOTR_FP32 * selects["cpu"].scale,
          f"MOTR two-stage selections differ by score gaps up to {gap}")
    check(ranked[0][1] <= TOL_MOTR_STEP_GRAD,
          f"gradient of {ranked[0][0]}: card vs CPU {ranked[0][1]} of its "
          "largest entry")
    check(calls[4] == 2 * 2 * 6 and calls[5] == 2 * 6,
          f"MOTR fp32 step launches {calls}, expected K5 24 (each frame's "
          "forward again in the backward) and K7 12")
    del det_cpu, det, grads, logs, selects
    gc.collect()
    torch.cuda.empty_cache()


def motr_state(motr, det):
    """A DetectionTrainState of `det` with tracking/main.py's optimizer
    (AdamW at lr 2e-4, weight decay 1e-4, clip 0.1, every parameter)."""
    from fastervit_tpu_torch.detection.engine import DetectionTrainState
    return DetectionTrainState(det, motr.create_motr_optimizer(
        det, lr=2e-4, weight_decay=1e-4, clip_max_norm=0.1))


def motr_train_phase(cuda_attention, cuda_msda, attention, msda,
                     motr) -> dict:
    """Phase 40: MOTR clip training as tracking/main.py configures it, at
    800x1536, batch 1, a MOTR_TRAIN_FRAMES-frame synthetic clip with
    proposals (an identity leaving, one arriving), f32 weights under bf16
    autocast: one step's launches by route, plan and Q (K7's encoder
    launches on route l2); on the step's own card tensors (grad_out
    `unit_scaled`), K7 and K5 at the encoder call (Q = S) and at the
    decoder's Q MOTR_TRAIN_DEC_Q, and K4 at the carriers, held to their plain versions and timed beside them (K7
    beside autograd through the grid_sample form too) and their bounds;
    the matching pass's last-layer logits equal to the gradient pass's bit
    for bit; 10 steps timed after 2; peak memory; one step profiled; the
    loss finite and falling over MOTR_LOSS_STEPS steps."""
    t0 = time.perf_counter()
    det = motr_train_detector(motr, MOTR_CANVAS, "cuda", seed=57)
    state = motr_state(motr, det)
    step = motr.make_motr_clip_train_step(torch.bfloat16)
    frames, targets, props = motr_train_clip(MOTR_CANVAS, MOTR_TRAIN_FRAMES,
                                             58, "cuda")
    build_s = time.perf_counter() - t0
    both_q = (MOTR_ENC_Q, MOTR_TRAIN_DEC_Q)
    reset_train_launches(cuda_attention, cuda_msda)
    with RouteLog(cuda_attention) as routes, \
            K5Plans(cuda_msda, capture_q=both_q) as k5_plans, \
            K5Plans(cuda_msda, "ms_deform_attn_backward_cuda",
                    capture_q=both_q) as k7_plans, \
            FirstLaunches(cuda_attention,
                          "window_mhsa_long_backward_cuda") as k4s:
        m = step(state, frames, targets, props)
        torch.cuda.synchronize()
    calls = train_launches(cuda_attention, cuda_msda)
    f = MOTR_TRAIN_FRAMES
    what = (f"MOTR clip train step bf16 {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]}, "
            f"{f} frames")
    same = all(torch.equal(a, b) for a, b in zip(m["match_logits"],
                                                 m["logits"]))
    print(f"{what} (autocast, f32 weights, per-frame checkpoint): K1, K2, "
          f"K3, K4, K5, K7 launches per step {calls}; K1 routes "
          f"{dict(routes.k1)}, K2 routes {dict(routes.k2)}; assignment "
          f"{m['assignment'][:, 0, :3].tolist()}; the matching pass's "
          f"last-layer logits bit-identical to the gradient pass's {same}; "
          f"build {build_s:.1f} s")
    k5_plans.check(3 * 6 * f, what, vector=True)
    k5_plans.check_queries({MOTR_ENC_Q: 3 * 3 * f,
                            MOTR_TRAIN_DEC_Q: 3 * 3 * f}, what)
    check_motr_k5_plans(k5_plans, cuda_msda, what)
    k7_plans.check(6 * f, what, vector=True)
    k7_plans.check_queries({MOTR_ENC_Q: 3 * f, MOTR_TRAIN_DEC_Q: 3 * f}, what)
    k7_plans.check_encoder(3 * f, what, route="l2", levels=())
    check(calls[4] == 3 * 6 * f and calls[5] == 6 * f
          and all(calls[i] > 0 for i in (0, 2, 3)),
          f"{what}: launches {calls}, expected K5 {3 * 6 * f} and K7 "
          f"{6 * f}, K1, K3 and K4")
    check(set(routes.k1) == {"wgmma"} and set(routes.k2) <= {"wgmma"},
          f"{what}: K1 and K2 routes {dict(routes.k1)}, {dict(routes.k2)}")
    check(same, f"{what}: the matching pass's logits differ from the "
                "gradient pass's")
    slots = m["assignment"][:, 0]
    check(all((slots[i, :len(t[0]["track_ids"])] >= 0).all()
              for i, t in enumerate(targets))
          and len(set(slots[:, 0].tolist())) == 1,
          f"{what}: every identity matched, identity 1 in one slot "
          f"throughout: {slots.tolist()}")

    # K7 at the encoder and decoder calls on the step's own tensors,
    # grad_out unit_scaled
    kernel = cuda_msda.ms_deform_attn_backward_cuda
    k7_calls = {}
    for q, call in zip(both_q, ("encoder", "decoder")):
        inputs = k7_plans.captured.get(q)
        check(inputs is not None, f"{what}: no K7 launch at Q {q}")
        value, shapes, loc, w, g_step = inputs
        g = unit_scaled(g_step)
        r = k7_check(cuda_msda, kernel, msda.msda_backward_reference, msda,
                     value, shapes, loc, w, g)
        flushes = cuda_msda.msda_bwd_flushes(r["plan"], loc.shape[1])
        name = f"K7 at the MOTR train step's {call} call"
        print(f"{name} (N={value.shape[0]} Q={loc.shape[1]} over "
              f"S={value.shape[1]} values, M={value.shape[2]} "
              f"D={value.shape[3]} P={loc.shape[4]}, {value.dtype} value, "
              f"{loc.dtype} locations, {g.dtype} grad_out, the step's own "
              f"tensors, its largest |grad_out| "
              f"{g_step.abs().max().item():.3e} scaled to "
              f"{g.abs().max().item():.3f}): dvalue max|err| "
              f"{r['dvalue_max_abs_err']:.3e}, at "
              f"most {r['dvalue_over_bound']:.3f} of its order bound (c "
              f"{r['c']}, {flushes} flushes); dloc max|err| / max|plain| "
              f"{r['dloc_rel']:.3e} (tol {TOL_K7}); dweights at most "
              f"{r['dweights_over_bound']:.3f} of its bound; second launch: "
              f"dloc and dweights bit-identical {r['same_bits']}, dvalue at "
              f"most {r['rerun_over_bound']:.3f} of the bound; plan "
              f"{r['plan']}")
        check(r["dvalue_over_bound"] <= 1 and r["dloc_rel"] <= TOL_K7
              and r["dweights_over_bound"] <= 1 and r["same_bits"]
              and r["rerun_over_bound"] <= 1 and flushes == 0
              and r["plan"].route == "l2", f"{name}: {r}, {flushes} flushes")
        row = k7_timed(cuda_msda, msda, value, shapes, loc, w, g)
        plan = row.pop("plan")
        print(f"{name}, timed: kernel {row['ms']:.4f} ms "
              f"({row['g_samples_s']:.1f} G samples/s), plain "
              f"{row['plain_ms']:.4f} ms, autograd through the grid_sample "
              f"form {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
              f"ms ({row['mbytes']:.1f} MB, {row['gflop']:.2f} GFLOP f32, "
              f"{row['bound_by']}) [{card()}]")
        k7_calls[call] = {**row, "plan": plan._asdict(),
                          "max_abs_err": r["dvalue_max_abs_err"],
                          "worst_over_bound": {
                              k: r[k] for k in ("dvalue_over_bound",
                                                "dloc_rel",
                                                "dweights_over_bound",
                                                "rerun_over_bound")},
                          "flushes": flushes}
        del inputs, value, loc, w, g, g_step
    # K5 at both calls and K4 at the carriers, on the step's own tensors
    k5_calls = {}
    for q, call in zip(both_q, ("encoder", "decoder")):
        check(q in k5_plans.captured, f"{what}: no K5 launch at Q {q}")
        k5_calls[call] = motr_k5_check(cuda_msda, msda,
                                       k5_plans.captured[q],
                                       f"the MOTR train step's {call} call")
    k4_calls = motr_k4_check(cuda_attention, attention, k4s,
                             "the MOTR train step's carrier attention")
    k7_by_q = dict(k7_plans.queries)
    del k7_plans, k4s
    k5_plans.captured.clear()
    gc.collect()

    losses = [m["loss"]]

    def run():
        losses.append(step(state, frames, targets, props)["loss"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    start.record()
    for _ in range(MOTR_TRAIN_STEPS):
        run()
    end.record()
    end.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t1) / MOTR_TRAIN_STEPS
    ms = start.elapsed_time(end) / MOTR_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    smi = card()
    print(f"{what}: {ms:.3f} ms a step (CUDA events over "
          f"{MOTR_TRAIN_STEPS} steps after 2; host {wall_ms:.3f} ms), "
          f"{f * 1000 / ms:.2f} frames/s; peak memory {peak / 2**20:.1f} MiB "
          f"[{smi}]")
    prof = profile_device(run, 1, f"MOTR clip train step bf16 "
                          f"{MOTR_CANVAS[0]}x{MOTR_CANVAS[1]} {f}-frame step",
                          ms, smi, "motr_train_profile.json")
    while len(losses) < MOTR_LOSS_STEPS:
        run()
    values = [v.item() for v in losses]

    def mean(v):
        return sum(v) / len(v)

    last = mean(values[-5:])
    print(f"MOTR bf16 clip train steps on one clip: the loss over "
          f"{len(values)} steps {[round(v, 3) for v in values]} (the first "
          f"{values[0]:.3f}, mean of steps 3-5 {mean(values[2:5]):.3f}, of "
          f"the last 5 {last:.3f}: {last / values[0]:.3f} and "
          f"{last / mean(values[2:5]):.3f} of them, limit {MOTR_LOSS_FALL})")
    check(all(math.isfinite(v) for v in values), f"MOTR losses {values}")
    check(last <= MOTR_LOSS_FALL * min(values[0], mean(values[2:5])),
          f"MOTR loss did not fall over {len(values)} steps (mean of the "
          f"last 5 against the first and steps 3-5's mean): {values}")
    del det, state, frames
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": calls, "ms": ms, "host_ms": wall_ms, "peak": peak,
            "profile": prof, "k7_calls": k7_calls, "k5_calls": k5_calls,
            "k4_calls": k4_calls, "k5_by_q": dict(k5_plans.queries),
            "k7_by_q": k7_by_q}


def write_mot_tree(root: Path, seqs: int, frames: int, seed: int) -> None:
    """A MOT-layout training tree under root: train/seqNN/img1 with
    `frames` JPEG frames at MOTR_CANVAS (phase 38's image, shifted 8 pixels
    a frame), gt/gt.txt with two identities (one leaving two frames before
    the end) and det_db.json with three proposals a frame."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    h, w = MOTR_CANVAS
    db = {}
    for s in range(1, seqs + 1):
        seq = root / "train" / f"seq{s:02d}"
        (seq / "img1").mkdir(parents=True)
        (seq / "gt").mkdir()
        base = (np.cumsum(rng.randint(-8, 9, (h, w, 3)), 1) % 256).astype(
            np.uint8)
        rows = []
        for f in range(1, frames + 1):
            Image.fromarray(np.roll(base, 8 * f, axis=1)).save(
                seq / "img1" / f"{f:08d}.jpg")
            rows.append(f"{f},1,{300 + 8 * f},200,120,260,1,1,1")
            if f <= frames - 2:
                rows.append(f"{f},2,{900 + 8 * f},300,100,220,1,1,1")
            db[f"train/seq{s:02d}/img1/{f:08d}.txt"] = [
                f"{296 + 8 * f},204,124,254,0.9",
                f"{904 + 8 * f},296,96,224,0.8", "40,40,200,200,0.3"]
        (seq / "gt" / "gt.txt").write_text("\n".join(rows) + "\n")
    (root / "det_db.json").write_text(json.dumps(db))


def motr_train_cli_phase(cuda_attention, cuda_msda, motr) -> list:
    """Phase 41: the MOTR training CLI (fastervit_tpu_torch.tracking.main)
    in process on the card at its defaults' 800x1536 in f32, under TMPDIR,
    twice: --synthetic --epochs 1 --sampler-lengths 2 (two 2-frame clips),
    then --mot-path on a MOT-layout tree and a --det-db it writes (2
    sequences of 6 JPEG frames) with --clips-per-epoch 1. Each run's K5 and
    K7 launches counted, K7's encoder launches on route l2; each
    checkpoint.pth loads strictly through build_motr_detector and tracks 2
    frames of motr_inference_sequence."""
    from fastervit_tpu_torch.tracking import main as train_cli
    runs = []
    for name in ("synthetic", "mot-path"):
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--epochs", "1", "--sampler-lengths", "2", "--output",
                    str(Path(tmp) / "out")]
            if name == "synthetic":
                argv += ["--synthetic"]
                clips = 2
            else:
                write_mot_tree(Path(tmp) / "mot", 2, 6, 59)
                argv += ["--mot-path", str(Path(tmp) / "mot"), "--det-db",
                         "det_db.json", "--clips-per-epoch", "1",
                         "--sample-interval", "2"]
                clips = 1
            reset_train_launches(cuda_attention, cuda_msda)
            t0 = time.perf_counter()
            with K5Plans(cuda_msda, "ms_deform_attn_backward_cuda") as k7s:
                result = train_cli.main(argv)
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            calls = train_launches(cuda_attention, cuda_msda)
            ckpt = Path(tmp) / "out" / "checkpoint.pth"
            size = ckpt.stat().st_size if ckpt.exists() else 0
            det = motr.build_motr_detector(
                MOTR_CANVAS, checkpoint=str(ckpt),
                num_detect_queries=MOTR_DEFAULT_QUERIES,
                num_track_queries=MOTR_DEFAULT_QUERIES,
                num_proposal_queries=MOTR_PROPOSALS,
                enc_layers=MOTR_DEFAULT_LAYERS,
                dec_layers=MOTR_DEFAULT_LAYERS)
            frames, props = motr_clip(MOTR_CANVAS, 2, 60, "cuda")
            tracked = motr.motr_inference_sequence(
                det, frames, num_track_slots=MOTR_DEFAULT_QUERIES,
                dim=det.dim, score_thresh=0.0, proposals_per_frame=props)
        what = (f"MOTR training CLI (--{name} --epochs 1 --sampler-lengths "
                f"2, f32, {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]})")
        print(f"{what}: {seconds:.1f} s; {result}; checkpoint.pth "
              f"{size / 2**20:.1f} MiB, loaded strictly, 2 frames tracked "
              f"({[len(r['ids']) for r in tracked]} tracks); K1, K2, K3, "
              f"K4, K5, K7 launches {calls} [{card()}]")
        k7s.check(12 * clips, what)
        k7s.check_encoder(6 * clips, what, route="l2", levels=())
        check(size > 0 and math.isfinite(result["loss"]),
              f"{what}: {result}, checkpoint {size} bytes")
        check(calls[4] == 36 * clips and calls[5] == 12 * clips,
              f"{what}: K5, K7 launches {calls[4:]}, expected {36 * clips} "
              f"and {12 * clips}")
        check(all(np.isfinite(r["boxes"]).all() for r in tracked),
              f"{what}: tracked boxes finite")
        runs.append({"run": name, "seconds": seconds, "loss": result["loss"],
                     "launches": calls})
        del det, frames
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def motr_train_phases(cuda_attention, cuda_msda, attention, msda, motr,
                      k4, k5, k7) -> None:
    """Phases 39-41, MOTR clip training; the full-width step's launches
    and its checked calls go into K4's, K5's and K7's entries of the
    kernels line."""
    motr_train_fp32_phase(cuda_attention, cuda_msda, msda, motr)
    trained = motr_train_phase(cuda_attention, cuda_msda, attention, msda,
                               motr)
    cli_runs = motr_train_cli_phase(cuda_attention, cuda_msda, motr)
    where = (f"one MOTR clip train step (tracking/main.py's MOTRDetector, "
             f"bf16 autocast, {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]}, "
             f"{MOTR_TRAIN_FRAMES} frames: the matching pass, the gradient "
             f"pass and its per-frame recompute)")
    k5["launches_motr_training"] = trained["launches"][4]
    k5["launches_motr_training_by_q"] = trained["k5_by_q"]
    k5["launches_motr_training_in"] = where
    k5["motr_train_calls"] = trained["k5_calls"]
    k4["launches_motr_training"] = trained["launches"][3]
    k4["launches_motr_training_in"] = where
    k4["motr_train_carrier_calls"] = trained["k4_calls"]
    k7["launches_motr_training"] = trained["launches"][5]
    k7["launches_motr_training_by_q"] = trained["k7_by_q"]
    k7["launches_motr_training_in"] = where
    k7["motr_encoder_call"] = trained["k7_calls"]["encoder"]
    k7["motr_decoder_call"] = trained["k7_calls"]["decoder"]
    k7["motr_train_cli_launches"] = {r["run"]: r["launches"][5]
                                     for r in cli_runs}
    prof = trained["profile"] or {}
    enc = trained["k7_calls"]["encoder"]
    print(f"MOTR clip training bf16 {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]}, "
          f"{MOTR_TRAIN_FRAMES} frames: {trained['ms']:.3f} ms a step, "
          f"device busy {100 * prof.get('busy', float('nan')):.1f}%, peak "
          f"{trained['peak'] / 2**20:.1f} MiB; K7 at the encoder call "
          f"{enc['ms']:.4f} ms (plain {enc['plain_ms']:.4f}, bound "
          f"{enc['bound_ms']:.4f}, grid_sample form "
          f"{enc['library_ms']:.4f}) [{card()}]")


def write_dance_tree(root: Path):
    """Phase 42's DanceTrack-layout tree under root: data/val/seq01/img1
    with TRACK_EVAL_FRAMES JPEG frames at MOTR_CANVAS (phase 38's image,
    shifted 8 pixels a frame, TRACK_EVAL_IDS boxes painted on it moving
    with it) and each frame's proposal file beside it (x,y,w,h,score rows:
    the boxes jittered); gt/DanceTrack-val/seq01/{seqinfo.ini, gt/gt.txt}
    (class 1, mark 1) and gt/seqmaps/DanceTrack-val.txt.
    -> (the --mot-path root, the gt folder, gt.txt)."""
    from PIL import Image
    rng = np.random.RandomState(46)
    h, w = MOTR_CANVAS
    mot = root / "data"
    img_dir = mot / "val" / "seq01" / "img1"
    img_dir.mkdir(parents=True)
    seq = root / "gt" / "DanceTrack-val" / "seq01"
    (seq / "gt").mkdir(parents=True)
    (root / "gt" / "seqmaps").mkdir()
    (root / "gt" / "seqmaps" / "DanceTrack-val.txt").write_text(
        "name\nseq01\n")
    (seq / "seqinfo.ini").write_text(
        f"[Sequence]\nname=seq01\nimDir=img1\nframeRate=20\n"
        f"seqLength={TRACK_EVAL_FRAMES}\nimWidth={w}\nimHeight={h}\n"
        "imExt=.jpg\n")
    base = (np.cumsum(rng.randint(-8, 9, (h, w, 3)), 1) % 256).astype(
        np.uint8)
    n = TRACK_EVAL_IDS
    colors = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    x0, y0 = 60 + 135 * np.arange(n), 120 + 70 * (np.arange(n) % 5)
    bw, bh = rng.randint(90, 121, n), rng.randint(200, 281, n)
    rows = []
    for f in range(1, TRACK_EVAL_FRAMES + 1):
        img = np.roll(base, 8 * f, axis=1)
        props = []
        for i in range(n):
            x, y = int(x0[i] + 8 * f), int(y0[i])
            img[y:y + bh[i], x:x + bw[i]] = colors[i]
            rows.append(f"{f},{i + 1},{x},{y},{bw[i]},{bh[i]},1,1,1")
            j = rng.uniform(-3, 3, 4)
            props.append(f"{x + j[0]:.2f},{y + j[1]:.2f},{bw[i] + j[2]:.2f},"
                         f"{bh[i] + j[3]:.2f},{0.95 - 0.04 * i:.2f}")
        Image.fromarray(img).save(img_dir / f"{f:08d}.jpg")
        (img_dir / f"{f:08d}.txt").write_text("\n".join(props) + "\n")
    gt = seq / "gt" / "gt.txt"
    gt.write_text("\n".join(rows) + "\n")
    return mot, root / "gt", gt


def track_eval_motr_phase(cuda_attention, cuda_msda, motr_exact,
                          root: Path) -> dict:
    """Phase 42 (a): MOTRv2 tracks written as the submit CLI writes them,
    scored by the evaluator CLI in a subprocess."""
    from fastervit_tpu_torch.tracking import submit, tools
    from fastervit_tpu_torch.tracking.mot_data import evaluate_mot_files
    mot, gt_folder, gt = write_dance_tree(root)
    db = {str(Path(k).relative_to(mot)): v
          for k, v in tools.build_det_db([str(mot / "val")]).items()}
    want_keys = {f"val/seq01/img1/{f:08d}.txt"
                 for f in range(1, TRACK_EVAL_FRAMES + 1)}
    check(set(db) == want_keys and all(len(v) == TRACK_EVAL_IDS
                                       for v in db.values()),
          f"build_det_db's keys {sorted(db)}")
    (mot / "det_db.json").write_text(json.dumps(db))
    trackers = root / "trackers" / "DanceTrack-val"
    args = submit.parse_args([
        "--mot-path", str(mot), "--split", "val", "--exact", "--dtype",
        "bfloat16", "--det-db", "det_db.json", "--num-queries",
        str(MOTR_QUERIES), "--num-proposals", str(MOTR_PROPOSALS),
        "--enc-layers", "6", "--dec-layers", "6", "--track-capacity",
        str(MOTR_CAPACITY), "--miss-tolerance", "10", "--img-height",
        str(MOTR_CANVAS[0]), "--img-width", str(MOTR_CANVAS[1]),
        "--output", str(trackers / "motrv2" / "data")])
    (seq, frames, props, sizes), = list(submit._load_sequences(args))
    check(seq == "seq01" and len(frames) == TRACK_EVAL_FRAMES
          and all(p[:, 4].max() > 0.9 for p in props),
          "submit._load_sequences: the frames and the det_db's proposals")
    det, qim = motr_exact.build_motr_exact(
        (args.img_height, args.img_width), args.backbone,
        getattr(torch, args.dtype), "cuda",
        generator=torch.Generator().manual_seed(47), dim=args.dim,
        num_queries=args.num_queries, enc_layers=args.enc_layers,
        dec_layers=args.dec_layers)

    def stream(clip, thresh: float):
        return motr_exact.exact_inference_sequence(
            det, qim, clip, args.num_queries, args.dim,
            proposals_per_frame=props, num_proposals=args.num_proposals,
            track_capacity=args.track_capacity, score_thresh=thresh,
            filter_score_thresh=thresh, miss_tolerance=args.miss_tolerance,
            prob_threshold=0.0)

    rec = MotrRecorder(det)
    stream(frames[:1], 0.5)
    thresh = motr_thresholds(torch.sigmoid(
        rec.seen[0]["logits"][0, :MOTR_QUERIES + MOTR_PROPOSALS]))
    rec.close()
    starts = []

    def timed():
        for f in frames:
            starts.append(time.perf_counter())
            yield f

    reset_launches(cuda_attention, cuda_msda)
    results = stream(timed(), thresh)
    torch.cuda.synchronize()
    starts.append(time.perf_counter())
    calls = detection_launches(cuda_attention, cuda_msda)
    frame_ms = [1e3 * (b - a) for a, b in zip(starts[:-1], starts[1:])]
    ids = [r["ids"].tolist() for r in results]
    submit._write(args, seq, results, sizes)
    (trackers / "oracle" / "data").mkdir(parents=True)
    (trackers / "oracle" / "data" / "seq01.txt").write_text(gt.read_text())
    what = (f"MOTRv2 exact bf16 {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]} "
            f"{TRACK_EVAL_FRAMES}-frame DanceTrack clip")
    print(f"{what}: K1, K3, K5 launches {calls}; ms a frame "
          f"{[round(t, 3) for t in frame_ms]}; track ids {ids} (threshold "
          f"{thresh:.4f}) [{card()}]")
    check(calls == tuple(TRACK_EVAL_FRAMES * c for c in (11, 6, 12)),
          f"{what}: launches {calls}, expected {TRACK_EVAL_FRAMES} x "
          "(11, 6, 12)")
    del det, qim, frames
    gc.collect()
    torch.cuda.empty_cache()

    out = root / "eval"
    cmd = [sys.executable, "-m", "fastervit_tpu_torch.tracking.evaluator",
           "--dataset", f"kind=dancetrack,name=DanceTrack-val,split=val,"
           f"gt_folder={gt_folder},trackers_folder={root / 'trackers'}",
           "--parallel", "--cores", "4", "--output", str(out)]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    eval_s = time.perf_counter() - t0
    print(f"evaluator CLI: {' '.join(cmd[1:])}: exit {run.returncode} in "
          f"{eval_s:.1f} s [{card()}]; its summary: "
          + " | ".join(line.strip() for line in run.stdout.splitlines()
                       if "HOTA=" in line))
    check(run.returncode == 0, f"the evaluator CLI failed: "
                               f"{run.stdout[-1000:]} {run.stderr[-2000:]}")
    summary = json.loads((out / "DanceTrack-val" / "summary.json")
                         .read_text())
    for name in ("oracle", "motrv2"):
        row = summary[name]["COMBINED_SEQ"]
        print(f"DanceTrack-val {name}: HOTA {row['HOTA']:.6f}, MOTA "
              f"{row['MOTA']:.6f}, IDF1 {row['IDF1']:.6f} (DetA "
              f"{row['DetA']:.6f}, AssA {row['AssA']:.6f}, IDSW "
              f"{row['IDSW']}, CLR_TP {row['CLR_TP']}, CLR_FP "
              f"{row['CLR_FP']}, CLR_FN {row['CLR_FN']})")
    oracle = summary["oracle"]["seq01"]
    check(all(abs(oracle[k] - 1.0) <= TOL_TRACK_EVAL
              for k in ("HOTA", "MOTA", "IDF1")),
          f"the oracle's HOTA, MOTA, IDF1: "
          f"{[oracle[k] for k in ('HOTA', 'MOTA', 'IDF1')]}")
    mine = summary["motrv2"]["seq01"]
    check(all(math.isfinite(v) for v in mine.values())
          and all(0.0 <= mine[k] <= 1.0
                  for k in ("HOTA", "DetA", "AssA", "IDF1")),
          f"MOTRv2's metrics: {mine}")
    trk = trackers / "motrv2" / "data" / "seq01.txt"
    direct = evaluate_mot_files(str(gt), str(trk))
    shared = sorted(set(direct) & set(mine))
    gap = max(abs(float(direct[k]) - mine[k]) / max(1.0, abs(mine[k]))
              for k in shared)
    print(f"DanceTrack adapter's seq01 row against evaluate_mot_files: "
          f"{len(shared)} shared keys, largest relative gap {gap:.3e} "
          f"(tol {TOL_TRACK_EVAL})")
    check(len(shared) >= 20 and gap <= TOL_TRACK_EVAL,
          f"the DanceTrack adapter off evaluate_mot_files by {gap}")
    lines = trk.read_text().splitlines(keepends=True)
    merged = tools.merge_tracklets(lines)
    check(len(lines) > 0 and len(merged) == len(lines),
          f"merge_tracklets: {len(lines)} rows in, {len(merged)} out")
    return {"launches": calls, "ms": float(np.median(frame_ms)),
            "eval_s": eval_s, "hota": mine["HOTA"]}


def track_eval_dino_phase(cuda_attention, cuda_msda, dino, cfg,
                          root: Path) -> dict:
    """Phase 42 (b): DINO-4scale as a tracker through the runtime tracker,
    scored by evaluate_mot_files."""
    from fastervit_tpu_torch.detection.coco_eval import _iou_matrix
    from fastervit_tpu_torch.tracking import tracker as runtime
    from fastervit_tpu_torch.tracking.mot_data import (evaluate_mot_files,
                                                       write_mot_file)
    det = dino.build_dino_from_config(
        cfg, resolution=DINO_CANVAS, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(48)).eval()
    base = torch.randn(3, *DINO_CANVAS,
                       generator=torch.Generator().manual_seed(49))
    clip = [torch.roll(base, 8 * f, dims=2).to("cuda", torch.bfloat16)
            for f in range(TRACK_DINO_FRAMES)]
    sizes = torch.tensor([DINO_CANVAS], device="cuda")
    with torch.no_grad():
        dino.postprocess(det(clip[0][None]), sizes)     # warm-up
        torch.cuda.synchronize()
        reset_launches(cuda_attention, cuda_msda)
        dets, det_ms = [], []
        for x in clip:
            t0 = time.perf_counter()
            post = dino.postprocess(det(x[None]), sizes)
            dets.append({k: v[0].cpu().numpy() for k, v in post.items()})
            det_ms.append(1e3 * (time.perf_counter() - t0))
    calls = detection_launches(cuda_attention, cuda_msda)
    ranked = [np.sort(d["scores"])[::-1] for d in dets]
    born = float(min(r[TRACK_DINO_K - 1] for r in ranked))
    kept = float(min(r[4 * TRACK_DINO_K - 1] for r in ranked))
    tracker = runtime.RuntimeTracker(score_thresh=born, filter_thresh=kept)
    t0 = time.perf_counter()
    tracks = runtime.track_sequence(dets, tracker)
    track_ms = 1e3 * (time.perf_counter() - t0) / len(dets)
    ids = [r["ids"].tolist() for r in tracks]
    carried = []
    for a, b in zip(tracks, tracks[1:]):
        for i in sorted(set(a["ids"].tolist()) & set(b["ids"].tolist())):
            iou = _iou_matrix(a["boxes"][a["ids"] == i],
                              b["boxes"][b["ids"] == i])[0, 0]
            carried.append((i, float(iou)))
    what = (f"DINO-4scale faster_vit_4_21k_224 bf16 b1 "
            f"{DINO_CANVAS[0]}x{DINO_CANVAS[1]} as a tracker, "
            f"{TRACK_DINO_FRAMES} frames")
    print(f"{what}: K1, K3, K5 launches {calls}; detector + postprocess ms "
          f"a frame {[round(t, 3) for t in det_ms]}, track_sequence "
          f"{track_ms:.3f} ms a frame; born at {born:.4f} (the frames' "
          f"{TRACK_DINO_K}th best score), kept at {kept:.4f}; track ids "
          f"{ids}; carried (id, IoU) {carried} [{card()}]")
    check(calls == tuple(TRACK_DINO_FRAMES * c for c in (17, 12, 12)),
          f"{what}: launches {calls}, expected {TRACK_DINO_FRAMES} x "
          "(17, 12, 12)")
    check(len(ids[0]) >= TRACK_DINO_K and carried
          and all(iou >= tracker.iou_thresh for _, iou in carried),
          f"{what}: tracks born {ids[0]} and carried across matched boxes "
          f"{carried}")
    gt = [{"ids": tracks[0]["ids"],
           "boxes": tracks[0]["boxes"] + np.asarray([8 * f, 0, 8 * f, 0]),
           "scores": np.ones(len(tracks[0]["ids"]))}
          for f in range(TRACK_DINO_FRAMES)]
    write_mot_file(str(root / "dino" / "gt.txt"), gt)
    write_mot_file(str(root / "dino" / "tracks.txt"), tracks)
    scores = evaluate_mot_files(str(root / "dino" / "gt.txt"),
                                str(root / "dino" / "tracks.txt"))
    print(f"{what}: against frame 1's tracks moving with the image: HOTA "
          f"{scores['HOTA']:.6f}, MOTA {scores['MOTA']:.6f}, IDF1 "
          f"{scores['IDF1']:.6f}")
    check(all(np.isfinite(v).all() for v in scores.values()),
          f"{what}: metrics {scores}")
    del det, clip
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": calls, "ms": float(np.median(det_ms)) + track_ms,
            "hota": scores["HOTA"]}


def track_eval_phase(cuda_attention, cuda_msda, motr_exact, dino, cfg, k1,
                     k3, k5) -> None:
    """Phase 42, the tracking evaluation path; its clips' launches go into
    K1's, K3's and K5's entries of the kernels line."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        motr_run = track_eval_motr_phase(cuda_attention, cuda_msda,
                                         motr_exact, Path(tmp))
        dino_run = track_eval_dino_phase(cuda_attention, cuda_msda, dino,
                                         cfg, Path(tmp))
    secs = time.perf_counter() - t0
    where = (f"the tracking evaluation path: a {TRACK_EVAL_FRAMES}-frame "
             f"DanceTrack-layout clip through the checkpoint-exact MOTRv2 "
             f"detector bf16 {MOTR_CANVAS[0]}x{MOTR_CANVAS[1]} and a "
             f"{TRACK_DINO_FRAMES}-frame clip through DINO-4scale bf16 b1 "
             f"{DINO_CANVAS[0]}x{DINO_CANVAS[1]} as a tracker, both scored")
    total = tuple(a + b for a, b in zip(motr_run["launches"],
                                        dino_run["launches"]))
    for entry, i in ((k1, 0), (k3, 1), (k5, 2)):
        entry["launches_track_eval"] = total[i]
        entry["launches_track_eval_in"] = where
    print(f"the tracking evaluation path (phase 42): {secs:.1f} s; the "
          f"evaluator CLI {motr_run['eval_s']:.1f} s; in-process ms a frame "
          f"MOTRv2 {motr_run['ms']:.3f}, DINO + runtime tracker "
          f"{dino_run['ms']:.3f}; K1, K3, K5 launches MOTRv2 "
          f"{motr_run['launches']}, DINO {dino_run['launches']} [{card()}]")


def int8_checked_shapes(quant, model, seen: dict) -> list:
    """Forward hooks on every int8 layer of `model`: at the first call of
    each (kind, rows, k, n), the layer's int32 accumulation through int_mm
    (torch._int_mm, padded) against int_mm_reference on the same int8
    operands (torch.equal), and its output against the dequantisation of
    that reference (torch.equal). Results go into `seen`; returns the
    hooks' handles."""
    def hook(mod, inp, out):
        x = inp[0]
        o = mod.weight_q.shape[0]
        if isinstance(mod, quant.Int8Linear):
            acc, xs, op = quant.int8_dense_acc(x, mod.weight_q,
                                               mod.act_clip_percentile)
            w, ws, bias = mod.weight_q.t(), mod.weight_scale, mod.bias
            kind, flat = "linear", acc.reshape(-1, o)
        else:
            acc, xs, op = quant.int8_conv_acc(x, mod.weight_q, mod.stride,
                                              mod.padding,
                                              mod.act_clip_percentile)
            w = mod.weight_q.reshape(o, -1).t()
            ws = mod.weight_scale.view(-1, 1, 1)
            bias = None if mod.bias is None else mod.bias.view(-1, 1, 1)
            kind, flat = "conv", acc.permute(0, 2, 3, 1).reshape(-1, o)
        key = (kind, op.shape[0], op.shape[1], o)
        if key in seen:
            return
        ref = quant.int_mm_reference(op, w)
        ref_acc = (ref.reshape(acc.shape) if kind == "linear" else
                   ref.reshape(acc.shape[0], acc.shape[2], acc.shape[3],
                               o).permute(0, 3, 1, 2))
        y = quant._dequant(ref_acc, xs, ws, bias, x.dtype)
        seen[key] = (torch.equal(flat, ref), torch.equal(out, y),
                     quant.int_mm_padding(*key[1:]))

    return [m.register_forward_hook(hook) for _, m in quant.int8_layers(model)]


def print_int8_shapes(seen: dict, what: str) -> None:
    print(f"{what}: {len(seen)} int8 product shapes, each accumulation "
          "through torch._int_mm against the plain int32 product on the "
          "same int8 operands, and the layer's output against its "
          "dequantisation (kind, rows, k, n -> the padded rows, k, n; "
          "equal, equal):")
    for (kind, m, k, n), (acc_ok, out_ok, pad) in sorted(seen.items()):
        print(f"  {kind:6s} ({m}, {k}, {n}) -> {pad}: {acc_ok}, {out_ok}")
    bad = [key for key, (a, b, _) in seen.items() if not (a and b)]
    check(not bad, f"{what}: int8 products off the plain int32 ones at {bad}")


def int8_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float().cpu() - want.float().cpu()).abs().max()
            / want.float().abs().max()).item()


def int8_agreement(q: torch.Tensor, ref: torch.Tensor):
    """(mean cosine, least cosine, top-1 agreement) of each row's logits."""
    cos = torch.nn.functional.cosine_similarity(q.float(), ref.float(), -1)
    top1 = (q.float().argmax(-1) == ref.float().argmax(-1)).float().mean()
    return cos.mean().item(), cos.min().item(), top1.item()


def int8_phases(fvt, cuda_attention, quant) -> dict:
    """Phases 43 and 44: the int8 layers on the card, then fv0 int8
    serving (fp32 b4 card vs CPU; bf16 b256 against the unquantised bf16
    model, timed in turns, profiled; with 99.9-percentile scales) and fv4
    int8 fp32 b2 card vs CPU."""
    out = {}
    model = fvt.create_model("faster_vit_0_224", device="cpu",
                             generator=torch.Generator().manual_seed(47))
    model.eval()
    # 43 (a): quantize_kernel on the card against the CPU
    t0 = time.perf_counter()
    layers = [(n, m) for n, m in model.named_modules()
              if type(m) in (torch.nn.Linear, torch.nn.Conv2d)
              and quant.eligible(n, m)]
    same = 0
    for n, m in layers:
        qc, sc = quant.quantize_kernel(m.weight)
        qg, sg = quant.quantize_kernel(m.weight.cuda())
        same += torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
    print(f"int8 layers (phase 43): quantize_kernel of fv0's {len(layers)} "
          f"eligible weights on the card: {same} give the CPU's int8 bits "
          "and scales")
    check(same == len(layers) == 82, f"quantize_kernel: {same} of "
                                     f"{len(layers)} weights equal")
    # 44 (a): fp32 b4, card against CPU on the same int8 weights
    qcpu = quant.quantize_model(copy.deepcopy(model))
    qgpu = copy.deepcopy(qcpu).to("cuda")
    x = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(48))
    with torch.no_grad(), RouteLog(cuda_attention) as routes:
        want = qcpu(x)
        reset_launches(cuda_attention)
        got = qgpu(x.cuda())
        torch.cuda.synchronize()
        calls = launches(cuda_attention)
    routes.check(17, 0, "scalar", "fv0 int8 fp32 b4 forward")
    err = int8_rel_err(got, want)
    print(f"fv0 int8 fp32 b4 (phase 44a): card vs CPU max|dlogits| / "
          f"max|logits| {err:.3e} (tol {TOL_INT8_LOGITS}); K1, K2, K3, K4 "
          f"launches {calls}")
    check(got.shape == (4, 1000) and bool(torch.isfinite(got).all()),
          "int8 fp32 logits finite, (4, 1000)")
    check(err <= TOL_INT8_LOGITS, f"int8 fp32 card vs CPU {err}")
    check(calls == (17, 0, 0, 0), f"int8 fp32 launches {calls}")
    del qcpu, want, got
    # the bf16 models from the same f32 weights: int8 (its scales and
    # biases stay f32) and unquantised
    q16 = qgpu.to(torch.bfloat16)
    f16 = model.to("cuda", torch.bfloat16)
    del qgpu, model
    check(all(m.weight_scale.dtype == torch.float32
              for _, m in quant.int8_layers(q16)), "scales f32 in bf16")
    gen = torch.Generator(device="cuda").manual_seed(49)
    xb = torch.randn(BATCH, 3, 224, 224, device="cuda",
                     generator=gen).bfloat16()
    # 43 (b): every quantised shape of fv0 b256
    seen = {}
    handles = int8_checked_shapes(quant, q16, seen)
    with torch.no_grad():
        q16(xb)
    for h in handles:
        h.remove()
    print_int8_shapes(seen, f"fv0 int8 bf16 b{BATCH} (phase 43)")
    # 44 (b): the serving path
    with torch.no_grad():
        ref = f16(xb)
        reset_launches(cuda_attention)
        with RouteLog(cuda_attention) as routes:
            logits = q16(xb)
            torch.cuda.synchronize()
        calls = launches(cuda_attention)
        routes.check(17, 0, "wgmma", f"fv0 int8 bf16 b{BATCH} forward")
        check(calls == (17, 0, 0, 0), f"int8 bf16 launches {calls}")
        check(logits.shape == (BATCH, 1000)
              and bool(torch.isfinite(logits.float()).all()),
              f"int8 bf16 logits finite, ({BATCH}, 1000)")
        cos_mean, cos_min, top1 = int8_agreement(logits, ref)
        print(f"fv0 int8 bf16 b{BATCH} (phase 44b): K1, K2, K3, K4 launches "
              f"{calls}; against the unquantised bf16 model on the same "
              f"weights: cosine mean {cos_mean:.5f}, least {cos_min:.5f}, "
              f"top-1 agreement {100 * top1:.1f}% (floors "
              f"{INT8_COS_MEAN_FLOOR}, {INT8_COS_MIN_FLOOR}, "
              f"{100 * INT8_TOP1_FLOOR:.0f}%)")
        check(cos_mean >= INT8_COS_MEAN_FLOOR and cos_min >= INT8_COS_MIN_FLOOR
              and top1 >= INT8_TOP1_FLOOR,
              f"int8 vs bf16: cosine {cos_mean}, {cos_min}, top-1 {top1}")
        runs = {"int8": lambda: q16(xb), "bf16": lambda: f16(xb)}
        times, peaks = {"int8": [], "bf16": []}, {}
        for name in ("int8", "bf16", "bf16", "int8"):
            torch.cuda.reset_peak_memory_stats()
            times[name].append(time_ms(runs[name], iters=20, warmup=5))
            peaks[name] = torch.cuda.max_memory_allocated()
        ms = {k: sum(v) / 2 for k, v in times.items()}
        smi = card()
        print(f"fv0 b{BATCH} eager, in turns (int8, bf16, bf16, int8), 20 "
              f"forwards each: int8 {ms['int8']:.3f} ms "
              f"({times['int8'][0]:.3f}, {times['int8'][1]:.3f}), "
              f"{BATCH * 1000 / ms['int8']:.1f} img/s, peak "
              f"{peaks['int8'] / 2**20:.1f} MiB; bf16 {ms['bf16']:.3f} ms "
              f"({times['bf16'][0]:.3f}, {times['bf16'][1]:.3f}), "
              f"{BATCH * 1000 / ms['bf16']:.1f} img/s, peak "
              f"{peaks['bf16'] / 2**20:.1f} MiB [{smi}]")
        prof = {name: profile_device(runs[name], 1,
                                     f"fv0 {name} b{BATCH} forward",
                                     ms[name], smi,
                                     f"{name}_serve_profile.json")
                for name in ("int8", "bf16")}
        if prof["int8"] and prof["bf16"]:
            print(f"kernel launches a forward (torch.profiler): int8 "
                  f"{prof['int8']['launches']:.0f}, bf16 "
                  f"{prof['bf16']['launches']:.0f}; device busy "
                  f"{100 * prof['int8']['busy']:.1f}% int8, "
                  f"{100 * prof['bf16']['busy']:.1f}% bf16")
        # act_clip_percentile at this size: per-tensor quantiles of up to
        # 2.1e8 elements, past torch.quantile's 2^24
        quant.set_act_clip_percentile(q16, INT8_CLIP_PERCENTILE)
        clipped = q16(xb)
        torch.cuda.synchronize()
        clip_ms = time_ms(lambda: q16(xb), iters=3, warmup=1)
        quant.set_act_clip_percentile(q16, None)
        check(bool(torch.isfinite(clipped.float()).all()),
              "percentile-scaled logits finite")
        c_mean, c_min, c_top1 = int8_agreement(clipped, ref)
        print(f"fv0 int8 bf16 b{BATCH}, {INT8_CLIP_PERCENTILE}-percentile "
              f"scales: {clip_ms:.3f} ms a forward; against bf16: cosine "
              f"mean {c_mean:.5f}, least {c_min:.5f}, top-1 agreement "
              f"{100 * c_top1:.1f}% [{smi}]")
        check(c_mean >= INT8_COS_MEAN_FLOOR and c_min >= INT8_COS_MIN_FLOOR
              and c_top1 >= INT8_TOP1_FLOOR,
              f"percentile int8 vs bf16: {c_mean}, {c_min}, {c_top1}")
    out.update(launches=calls[0], ms=ms, profile=prof, cos=cos_mean,
               top1=top1, clip_ms=clip_ms)
    del q16, f16, xb, ref, logits, clipped
    gc.collect()
    torch.cuda.empty_cache()
    # 43 (c) and 44 (c): faster_vit_4_224 (width 196: k 1764, n 196 pad)
    cpu4 = fvt.create_model("faster_vit_4_224", device="cpu", quantized=True,
                            generator=torch.Generator().manual_seed(50))
    cpu4.eval()
    gpu4 = copy.deepcopy(cpu4).to("cuda")
    x4 = torch.randn(FV4_INT8_BATCH, 3, 224, 224,
                     generator=torch.Generator().manual_seed(51))
    seen = {}
    handles = int8_checked_shapes(quant, gpu4, seen)
    with torch.no_grad():
        gpu4(x4.cuda())
    for h in handles:
        h.remove()
    print_int8_shapes(seen, f"fv4 int8 fp32 b{FV4_INT8_BATCH} (phase 43)")
    check(any(pad[1:] != key[2:] for key, (_, _, pad) in seen.items()),
          "fv4: no product was padded")
    with torch.no_grad():
        want = cpu4(x4)
        reset_launches(cuda_attention)
        got = gpu4(x4.cuda())
        torch.cuda.synchronize()
        calls = launches(cuda_attention)
    err = int8_rel_err(got, want)
    print(f"fv4 int8 fp32 b{FV4_INT8_BATCH} (phase 44c): card vs CPU "
          f"max|dlogits| / max|logits| {err:.3e} (tol {TOL_INT8_LOGITS}); "
          f"K1, K2, K3, K4 launches {calls}")
    check(bool(torch.isfinite(got).all()) and err <= TOL_INT8_LOGITS,
          f"fv4 int8 card vs CPU {err}")
    del cpu4, gpu4
    gc.collect()
    torch.cuda.empty_cache()
    return out


def write_eval_folder(root: Path, seed: int) -> list:
    """An ImageFolder of JPEGs at mixed sizes: EVAL_CLASSES classes,
    EVAL_IMAGES images in all; returns their paths by class."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    per = [EVAL_IMAGES // EVAL_CLASSES] * EVAL_CLASSES
    paths = []
    for c in range(EVAL_CLASSES):
        d = root / f"n{c:08d}"
        d.mkdir(parents=True)
        cls = []
        for i in range(per[c]):
            w, h = rng.randint(160, 400), rng.randint(160, 400)
            base = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
            img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
            cls.append(d / f"{c}_{i}.jpg")
            img.save(cls[-1], quality=90)
        paths.append(cls)
    return paths


def eval_phase(cuda_attention, train_cli) -> dict:
    """Phase 45, the evaluation path, in a temporary directory: the
    validate CLI in a subprocess on a folder (float and --int8) and on
    --synthetic, then the train CLI from --data-dir, 2 steps."""
    from fastervit_tpu_torch.data import native
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths = write_eval_folder(root / "val", 52)
        # train/: the first EVAL_TRAIN_IMAGES of them, linked
        n = 0
        for c, cls in enumerate(paths):
            d = root / "train" / cls[0].parent.name
            d.mkdir(parents=True)
            take = EVAL_TRAIN_IMAGES // EVAL_CLASSES + (
                c < EVAL_TRAIN_IMAGES % EVAL_CLASSES)
            for p in cls[:take]:
                (d / p.name).symlink_to(p)
                n += 1
        check(n == EVAL_TRAIN_IMAGES, f"train/ holds {n} images")
        print(f"the evaluation path (phase 45): {EVAL_IMAGES} JPEGs in "
              f"{EVAL_CLASSES} classes at 160-400 px written in "
              f"{time.perf_counter() - t0:.1f} s; the native decoder "
              f"{'built' if native.available() else 'did not build'} "
              f"({native.library_path().name})")
        # --synthetic at batch 64: its 8 batches of N(0, 1) images are
        # drawn on the host, 38.5 M numbers a batch at 256
        runs = (("float", BATCH, ["--data-dir", str(root / "val")]),
                ("int8", BATCH, ["--data-dir", str(root / "val"), "--int8"]),
                ("synthetic", 64, ["--synthetic", "--int8"]))
        for name, batch, flags in runs:
            t1 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "fastervit_tpu_torch.validate",
                 "--model", "faster_vit_0_224", "--dtype", "bfloat16",
                 "--batch-size", str(batch)] + flags,
                cwd=REPO, capture_output=True, text=True, timeout=600)
            secs = time.perf_counter() - t1
            lines = [l for l in res.stdout.splitlines() if l.startswith("{")]
            check(res.returncode == 0 and lines,
                  f"validate CLI ({name}) rc {res.returncode}: "
                  f"{res.stderr[-2000:]}")
            r = json.loads(lines[-1])
            want = EVAL_IMAGES if name != "synthetic" else 8 * batch
            print(f"validate CLI ({name}, bf16 b{batch}): {secs:.1f} s in "
                  f"its process; count {r['count']}, top-1 {r['top1']:.2f}, "
                  f"top-5 {r['top5']:.2f}, loss {r['loss']:.4f}, "
                  f"{r['img_s']:.1f} img/s (batches after the first, "
                  f"decoding included) [{card()}]")
            check(r["count"] == want and 0 <= r["top1"] <= 100
                  and 0 <= r["top5"] <= 100 and math.isfinite(r["loss"]),
                  f"validate CLI ({name}): {r}")
            out[name] = r
        # the train CLI from --data-dir: 2 steps at batch 128, then eval of
        # the model and its EMA over val/ (5 batches each)
        with RouteLog(cuda_attention) as routes:
            reset_launches(cuda_attention)
            t1 = time.perf_counter()
            train_cli.main([
                "--config", str(REPO / "configs" / "faster_vit_0_224_1k.yaml"),
                "--data-dir", str(root), "--epochs", "1", "--warmup-epochs",
                "0", "--cooldown-epochs", "0", "--data-len",
                str(EVAL_TRAIN_IMAGES), "-b", str(EVAL_TRAIN_BATCH),
                "--output", str(root / "out")])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            calls = launches(cuda_attention)
        rows = list(csv.DictReader(open(root / "out" / "summary.csv")))
        steps = EVAL_TRAIN_IMAGES // EVAL_TRAIN_BATCH
        evals = 2 * -(-EVAL_IMAGES // EVAL_TRAIN_BATCH)
        check(calls == (17 * (steps + evals), 17 * steps, 0, 0),
              f"train CLI --data-dir launches {calls}")
        routes.check(17 * (steps + evals), 17 * steps, "wgmma",
                     "train CLI --data-dir")
        check(len(rows) == 1 and all(
            math.isfinite(float(rows[0][k]))
            for k in ("train_loss", "eval_loss", "eval_top1")),
            f"train CLI --data-dir summary.csv {rows}")
        print(f"train CLI --data-dir (fv0 recipe, bf16, {steps} steps "
              f"b{EVAL_TRAIN_BATCH} + eval of model and EMA over "
              f"{EVAL_IMAGES} images): {secs:.1f} s; K1, K2, K3, K4 launches "
              f"{calls}; summary.csv {dict(rows[0])}")
        out["train_launches"] = calls
    out["secs"] = time.perf_counter() - t0
    print(f"the evaluation path (phase 45): {out['secs']:.1f} s [{card()}]")
    return out


EXPORT_SMALL_BATCH = 7     # a batch the program's trace did not see
EXPORT_LONG = "faster_vit_4_21k_384"
EXPORT_LONG_BATCH = 2
EXPORT_TIMED = 20          # forwards a turn, after 5
ONNX_BATCH = 3             # an ONNX batch the trace (at 1) did not see
TOL_ONNX = 1e-4            # numpy's f32 sums against torch's, fp32 logits
DDP_STEPS = 2
DROPOUT = 0.1


def serve_programs(directory: Path) -> None:
    """Phase 46's serving process (`chip_smoke.py --serve-programs DIR`):
    imports only the port, loads each program that phase 46 saved in DIR
    (`utils.export.load_program`), runs it on its inputs on the card with
    every launch count set to 0 just before, and prints one JSON line:
    each run's K1 and K3 launches and whether its logits equal the eager
    model's (torch.equal), and the modules of the JAX package loaded."""
    from fastervit_tpu_torch.ops import cuda_attention
    from fastervit_tpu_torch.utils.export import load_program
    # main's settings, under which the eager logits were taken
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = torch.load(directory / "cases.pt")
    runs = []
    for case in cases:
        t0 = time.perf_counter()
        program = load_program(str(directory / case["file"])).module()
        load_s = time.perf_counter() - t0
        for x, want in zip(case["inputs"], case["wants"]):
            with torch.no_grad():
                reset_launches(cuda_attention)
                got = program(x.cuda())
                torch.cuda.synchronize()
                calls = launches(cuda_attention)
            got = got.cpu()
            runs.append({"name": case["name"], "batch": x.shape[0],
                         "load_s": load_s, "k1": calls[0], "k3": calls[2],
                         "k2_k4": calls[1] + calls[3],
                         "equal": bool(torch.equal(got, want)),
                         "max_abs": float((got.float() - want.float())
                                          .abs().max())})
    bad = sorted(k for k in sys.modules if k.split(".")[0] in
                 ("jax", "jaxlib", "flax", "fastervit_tpu"))
    print(json.dumps({"served": runs, "jax_modules": bad}))


def export_phase(fvt, cuda_attention) -> dict:
    """Phase 46: (a) faster_vit_0_224 bf16 exported with a symbolic batch,
    (b) faster_vit_4_21k_384 bf16 likewise, (c) the fv0 int8 model at
    b256; each saved, then loaded and run in a fresh process that imports
    only the port (`serve_programs`), its logits bit-equal to the eager
    forward's at each batch (fv0 b256 and b7, fv4 b2, int8 b256) and its
    K1 and K3 launches counted there; (d) the fv0 program and the eager
    forward at b256 timed in turns; (e) the fv0 ONNX graph (the plain
    version, on the CPU) run by utils/onnx_eval.py at b3 against the
    port's CPU logits."""
    from fastervit_tpu_torch.utils import export
    from fastervit_tpu_torch.utils.onnx_eval import run_onnx
    from fastervit_tpu_torch.utils.onnx_inspect import (check_constant_folded,
                                                        inspect_onnx)
    t0 = time.perf_counter()
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(46)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cases = []

        def add_case(name, model, program, batches, res):
            inputs, wants = [], []
            for b in batches:
                x = torch.randn(b, 3, res, res, device="cuda",
                                generator=gen).bfloat16()
                with torch.no_grad():
                    wants.append(model(x).cpu())
                inputs.append(x.cpu())
            t1 = time.perf_counter()
            export.save_program(program, str(tmp / f"{name}.pt2"))
            size = (tmp / f"{name}.pt2").stat().st_size
            print(f"export (phase 46): {name} saved, {size / 2**20:.1f} MiB "
                  f"in {time.perf_counter() - t1:.1f} s")
            cases.append({"name": name, "file": f"{name}.pt2",
                          "inputs": inputs, "wants": wants})

        # (a) fv0 bf16, a symbolic batch
        model = fvt.create_model("faster_vit_0_224", dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(46)
                                 ).eval()
        t1 = time.perf_counter()
        program = export.export_program(model, None, torch.bfloat16)
        ops = [str(n.target) for n in program.graph.nodes
               if "fastervit" in str(n.target)]
        print(f"export (phase 46): faster_vit_0_224 bf16, batch symbolic "
              f"({program.range_constraints}), exported in "
              f"{time.perf_counter() - t1:.1f} s; fastervit:: operators in "
              f"the graph: {collections.Counter(ops)}")
        check(ops == ["fastervit.window_mhsa_short.default"] * 17,
              f"fv0 program's operators {ops}")
        add_case("fv0", model, program, (BATCH, EXPORT_SMALL_BATCH), 224)
        # (d) program and eager forward at b256, in turns
        served = program.module()
        x = torch.randn(BATCH, 3, 224, 224, device="cuda",
                        generator=gen).bfloat16()
        with torch.no_grad():
            check(torch.equal(served(x), model(x)),
                  "fv0 program in this process != eager")
            times = probes.in_turns({"eager": lambda: model(x),
                                     "program": lambda: served(x)},
                                    EXPORT_TIMED)
        out["eager_ms"], out["program_ms"] = times["eager"], times["program"]
        print(f"export (phase 46): fv0 bf16 b{BATCH} in turns (eager, "
              f"program, program, eager; {EXPORT_TIMED} forwards each): "
              f"eager {times['eager']:.3f} ms, exported program "
              f"{times['program']:.3f} ms [{card()}]")
        # (e) the ONNX graph: the plain version, traced on the CPU
        cpu = copy.deepcopy(model).to("cpu", torch.float32)
        del served, program, model, x
        t1 = time.perf_counter()
        paths = {fold: export.export_onnx(cpu, str(tmp / f"fv0_{fold}.onnx"),
                                          optimize=fold)
                 for fold in (True, False)}
        folded, raw = (inspect_onnx(paths[f]) for f in (True, False))
        check_constant_folded(paths[True], max_constant_nodes=raw[
            "op_types"].get("Constant", 0))
        xo = np.random.RandomState(46).randn(ONNX_BATCH, 3, 224, 224).astype(
            np.float32)
        got = run_onnx(paths[True], {"input": xo})["output"]
        with torch.no_grad():
            want = cpu(torch.from_numpy(xo)).numpy()
        err = float(np.abs(got - want).max())
        print(f"export (phase 46): fv0 ONNX on the CPU (the plain version; "
              f"exported with and without folding and evaluated at b"
              f"{ONNX_BATCH} in {time.perf_counter() - t1:.1f} s): "
              f"{folded['num_nodes']} nodes folded ({raw['num_nodes']} "
              f"unfolded), Constant {folded['op_types'].get('Constant', 0)} "
              f"({raw['op_types'].get('Constant', 0)}), Mod "
              f"{folded['op_types'].get('Mod', 0)}; max|onnx - port CPU| "
              f"{err:.3e} (tol {TOL_ONNX}, largest logit "
              f"{np.abs(want).max():.3f})")
        check(got.shape == (ONNX_BATCH, 1000) and err <= TOL_ONNX
              and "Mod" not in folded["op_types"]
              and folded["num_nodes"] <= raw["num_nodes"],
              f"ONNX graph off the port's CPU logits by {err}")
        out["onnx_err"], out["onnx_nodes"] = err, folded["num_nodes"]
        del cpu
        # (b) 21k-384 bf16, a symbolic batch: K3
        model = fvt.create_model(EXPORT_LONG, dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(47)
                                 ).eval()
        t1 = time.perf_counter()
        program = export.export_program(model, None, torch.bfloat16)
        ops = collections.Counter(str(n.target) for n in program.graph.nodes
                                  if "fastervit" in str(n.target))
        print(f"export (phase 46): {EXPORT_LONG} bf16 exported in "
              f"{time.perf_counter() - t1:.1f} s; operators {dict(ops)}")
        check(ops["fastervit.window_mhsa_long.default"] > 0,
              f"{EXPORT_LONG} program has no K3 operator: {dict(ops)}")
        add_case("fv4_21k_384", model, program, (EXPORT_LONG_BATCH,), 384)
        k3_per_forward = ops["fastervit.window_mhsa_long.default"]
        del model, program
        # (c) fv0 int8 at b256
        model = fvt.create_model("faster_vit_0_224", quantized=True,
                                 dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(48)
                                 ).eval()
        add_case("fv0_int8", model,
                 export.export_program(model, BATCH, torch.bfloat16),
                 (BATCH,), 224)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        torch.save(cases, tmp / "cases.pt")
        del cases
        t1 = time.perf_counter()
        res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                              "--serve-programs", str(tmp)], cwd=tmp,
                             capture_output=True, text=True, timeout=600)
        lines = [l for l in res.stdout.splitlines() if l.startswith("{")]
        check(res.returncode == 0 and lines, f"serving process rc "
                                             f"{res.returncode}: "
                                             f"{res.stderr[-3000:]}")
        served = json.loads(lines[-1])
    print(f"export (phase 46): the serving process ({time.perf_counter() - t1:.1f}"
          f" s) loaded the JAX package's modules {served['jax_modules']}")
    check(not served["jax_modules"], "the serving process loaded jax")
    want_k = {"fv0": (17, 0), "fv4_21k_384": (None, k3_per_forward),
              "fv0_int8": (17, 0)}
    for r in served["served"]:
        k1, k3 = want_k[r["name"]]
        print(f"export (phase 46): loaded {r['name']} b{r['batch']} "
              f"(load {r['load_s']:.1f} s): logits equal to eager "
              f"{r['equal']} (max|diff| {r['max_abs']:.3e}); K1 {r['k1']}, "
              f"K3 {r['k3']}, K2 + K4 {r['k2_k4']} launches a forward")
        check(r["equal"], f"loaded {r['name']} b{r['batch']} != eager")
        check((k1 is None or r["k1"] == k1) and r["k3"] == k3
              and r["k2_k4"] == 0 and (r["name"] != "fv4_21k_384"
                                       or r["k3"] > 0),
              f"loaded {r['name']} launches {r}")
    out["served"] = served["served"]
    out["k1_per_forward"] = next(r["k1"] for r in served["served"]
                                 if r["name"] == "fv0")
    out["k3_per_forward"] = next(r["k3"] for r in served["served"]
                                 if r["name"] == "fv4_21k_384")
    out["secs"] = time.perf_counter() - t0
    print(f"export (phase 46): {out['secs']:.1f} s [{card()}]")
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


DDP_CHILD = """
import json, sys, torch
sys.path.insert(0, {repo!r})
from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.parallel import data_parallel
from fastervit_tpu_torch.train import train
import torch.distributed as dist
seen = {{"sync_bn": 0, "ddp": 0}}
wrap = data_parallel.wrap_model
def counted(model, device, **kw):
    ddp = wrap(model, device, **kw)
    seen["ddp"] += ddp is not None
    seen["sync_bn"] = sum(type(m) is data_parallel.SyncBatchNorm2d
                          for m in model.modules())
    seen["backend"] = dist.get_backend() if dist.is_initialized() else None
    seen["world"] = dist.get_world_size() if dist.is_initialized() else 1
    return ddp
data_parallel.wrap_model = counted
res = train.main({args!r})
torch.cuda.synchronize()
print(json.dumps({{"losses": res["train_losses"], **seen,
    "k1": cuda_attention.window_mhsa_cuda.launches,
    "k2": cuda_attention.window_mhsa_backward_cuda.launches}}))
"""


def ddp_phase() -> dict:
    """Phase 47: the train CLI in a subprocess under torchrun's variables
    for one process (RANK 0, WORLD_SIZE 1, LOCAL_RANK 0, MASTER_ADDR and a
    free MASTER_PORT: NCCL, DistributedDataParallel and SyncBatchNorm on
    the path), fv0 bf16 b128, DDP_STEPS steps on synthetic data and the
    eval; then the same without the variables. Each step's loss is equal
    between the two (DDP over one process divides by 1, SyncBatchNorm over
    one takes the local statistics), K1 and K2 launches counted in each."""
    t0 = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("ddp", "plain"):
            args = ["--model", "faster_vit_0_224", "--synthetic", "-b",
                    str(TRAIN_BATCH), "--dtype", "bfloat16", "--epochs", "1",
                    "--warmup-epochs", "0", "--cooldown-epochs", "0",
                    "--data-len", str(DDP_STEPS * TRAIN_BATCH),
                    "--log-interval", "1", "--no-model-ema",
                    "--no-auto-resume",
                    "--output", str(Path(tmp) / name)]
            env = {k: v for k, v in os.environ.items()
                   if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "MASTER_ADDR", "MASTER_PORT")}
            if name == "ddp":
                env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(_free_port()))
            t1 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-c",
                 DDP_CHILD.format(repo=str(REPO), args=args)],
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=600)
            lines = [l for l in res.stdout.splitlines() if l.startswith("{")]
            check(res.returncode == 0 and lines,
                  f"train CLI ({name}) rc {res.returncode}: "
                  f"{res.stderr[-3000:]}")
            runs[name] = json.loads(lines[-1])
            r = runs[name]
            print(f"data parallel (phase 47): train CLI {name} "
                  f"({time.perf_counter() - t1:.1f} s): group "
                  f"{r.get('backend')} world {r.get('world')}, DDP "
                  f"{r['ddp']}, SyncBatchNorm2d {r['sync_bn']}; losses "
                  f"{r['losses']}; K1 {r['k1']}, K2 {r['k2']} launches")
    ddp, plain = runs["ddp"], runs["plain"]
    evals = 4
    check(ddp["backend"] == "nccl" and ddp["world"] == 1 and ddp["ddp"] == 1
          and ddp["sync_bn"] > 0, f"the DDP run's group {ddp}")
    check(plain["ddp"] == 0 and plain["sync_bn"] == 0,
          f"the plain run took a group {plain}")
    check(len(ddp["losses"]) == DDP_STEPS
          and all(math.isfinite(v) for v in ddp["losses"]),
          f"DDP losses {ddp['losses']}")
    check(ddp["losses"] == plain["losses"],
          f"DDP losses {ddp['losses']} != plain {plain['losses']}")
    want = (17 * (DDP_STEPS + evals), 17 * DDP_STEPS)
    check((ddp["k1"], ddp["k2"]) == (plain["k1"], plain["k2"]) == want,
          f"K1, K2 launches {ddp['k1'], ddp['k2']} and "
          f"{plain['k1'], plain['k2']}, expected {want}")
    secs = time.perf_counter() - t0
    print(f"data parallel (phase 47): {secs:.1f} s [{card()}]")
    return {"losses": ddp["losses"], "launches": (ddp["k1"], ddp["k2"]),
            "secs": secs}


def routes_taken(plain_route: str, plain: int, launches: tuple) -> dict:
    """The attention routes a run took, each with its count: the plain
    dropout route's calls and K1-K4's launches, those above 0."""
    counts = {plain_route: plain, **dict(zip(("K1", "K2", "K3", "K4"),
                                             launches))}
    return {route: n for route, n in counts.items() if n}


def dropout_phase(fvt, cuda_attention, steps, mixup) -> dict:
    """Phase 48: the fv0 bf16 b128 train step with drop_rate and
    attn_drop_rate DROPOUT: every attention on the route "plain: attention
    dropout" in training (K1 and K2 launched 0 times), K1 at eval; two
    models from one seed, stepped with one generator seed, give equal
    losses."""
    from fastervit_tpu_torch.ops import attention
    t0 = time.perf_counter()
    batch = synthetic_batch(TRAIN_BATCH, 48)
    cfg = steps.TrainConfig(mixup=mixup.MixupConfig(), use_ema=False)
    losses = []
    for _ in range(2):
        model = fvt.create_model(
            "faster_vit_0_224", drop_rate=DROPOUT, attn_drop_rate=DROPOUT,
            generator=torch.Generator().manual_seed(48))
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_step(cfg, lambda s: 1e-3, torch.bfloat16,
                                     seed=48)
        reset_launches(cuda_attention)
        attention.dropout_window_mhsa.calls = 0
        loss = step(state, batch)["loss"].item()
        torch.cuda.synchronize()
        taken = routes_taken(attention.PLAIN_DROPOUT,
                             attention.dropout_window_mhsa.calls,
                             launches(cuda_attention))
        losses.append(loss)
        print(f"dropout (phase 48): fv0 bf16 b{TRAIN_BATCH} step, drop and "
              f"attention drop {DROPOUT}: loss {loss!r}; routes taken "
              f"{taken}")
        check(taken == {attention.PLAIN_DROPOUT: 17} and math.isfinite(loss),
              f"dropout step: routes taken {taken}")
    check(losses[0] == losses[1], f"dropout losses {losses} differ")
    with torch.no_grad():
        reset_launches(cuda_attention)
        attention.dropout_window_mhsa.calls = 0
        x = torch.from_numpy(batch["image"]).cuda().permute(0, 3, 1, 2)
        with torch.autocast("cuda", torch.bfloat16):
            logits = model.eval()(x)
        torch.cuda.synchronize()
    taken = routes_taken(attention.PLAIN_DROPOUT,
                         attention.dropout_window_mhsa.calls,
                         launches(cuda_attention))
    print(f"dropout (phase 48): eval forward: routes taken {taken}")
    check(taken == {"K1": 17} and bool(torch.isfinite(logits).all()),
          f"dropout model's eval: routes taken {taken}")
    secs = time.perf_counter() - t0
    print(f"dropout (phase 48): {secs:.1f} s [{card()}]")
    return {"losses": losses, "secs": secs}


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    if sys.argv[1:2] == ["--serve-programs"]:
        serve_programs(Path(sys.argv[2]))
        return
    import fastervit_tpu_torch as fvt
    from fastervit_tpu_torch.detection import dino, engine, matcher_device
    from fastervit_tpu_torch.detection import main as detection_cli
    from fastervit_tpu_torch.detection import transforms
    from fastervit_tpu_torch.ops import attention, cuda_attention, cuda_msda
    from fastervit_tpu_torch.ops import attention_probes, cuda_hat_block
    from fastervit_tpu_torch.ops import hat_block, msda, msda_probes, quant
    from fastervit_tpu_torch.probes import attn_online_probe, attn_vpu_probe
    from fastervit_tpu_torch.probes import msda_packed_probe, msda_pallas_probe
    from fastervit_tpu_torch.probes import msda_packed_probe2
    from fastervit_tpu_torch.tracking import motr, motr_exact
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

    # 29. K7, the MSDA backward, against its plain version
    k7 = k7_phase(cuda_msda, msda, ptx_log)

    # 30. the fp32 DINO train step, card against CPU; then again with
    #     contrastive denoising on a padded batch
    dino_step_fp32_phase(cuda_attention, cuda_msda, msda, dino, engine,
                         detection_cli, cfg)
    dino_step_fp32_phase(cuda_attention, cuda_msda, msda, dino, engine,
                         detection_cli, cfg,
                         cdn=(transforms, steps, matcher_device))

    # 31. the detection training path: DINO-4scale bf16 b2 800x1333
    trained_det = dino_train_phase(cuda_attention, cuda_msda, dino, engine,
                                   detection_cli, cfg)
    k7["launches"] = trained_det["launches"][5]
    k5["launches_training"] = trained_det["launches"][4]
    k7["launches_in"] = k5["launches_training_in"] = (
        f"one DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} 800x1333 "
        "train step of the detection training path (use_checkpoint: K5 "
        "twice a layer)")

    # 32. padded DINO serving: an all-False mask against no mask (fp32),
    #     the padded fp32 b1 480x640 batch card against CPU, then COCO
    #     evaluation's mixed-size bf16 b2 batch on the 800x1333 canvas
    padded = dino_padded_serving_phase(cuda_attention, cuda_msda, dino,
                                       transforms, cfg)
    with K5Plans(cuda_msda) as plans:
        dino_fp32_phase(cuda_attention, cuda_msda, dino, cfg, transforms)
    plans.check(12, "DINO fp32 b1 padded forward (phase 32)")
    k5["launches_padded_serving"] = padded["launches"][2]
    k5["launches_padded_serving_in"] = (
        f"one DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} forward of "
        f"a padded 800x1333 batch (images {DINO_PAD_VALID})")

    # 33. the detection training path with contrastive denoising on a
    #     padded batch
    cdn_trained = dino_cdn_train_phase(cuda_attention, cuda_msda, dino,
                                       engine, steps, matcher_device,
                                       transforms, detection_cli, cfg)
    k5["launches_cdn_training"] = cdn_trained["launches"][4]
    k7["launches_cdn_training"] = cdn_trained["launches"][5]
    k5["launches_cdn_training_in"] = k7["launches_cdn_training_in"] = (
        f"one DINO-4scale faster_vit_4_21k_224 bf16 b{DINO_BATCH} 800x1333 "
        "padded train step with 200 dn queries (half the K5 and K7 "
        "launches at the decoder's Q 1,100)")

    # 34. the detection training CLI, with each matcher
    dino_train_cli_phase(cuda_attention, cuda_msda, detection_cli)

    # 35-38. MOTRv2 streaming: card against CPU, the full-width clip (and
    #     with the lite encoder), the default path, the CLI
    motr_phases(cuda_attention, cuda_msda, attention, msda, motr,
                motr_exact, k1, k3, k5)

    # 39-41. MOTR clip training: card against CPU, the full-width clip step,
    #     the training CLI
    motr_train_phases(cuda_attention, cuda_msda, attention, msda, motr, k4,
                      k5, k7)

    # 42. the tracking evaluation path: MOTRv2 tracks scored by the
    #     evaluator CLI, DINO-4scale as a tracker scored by evaluate_mot_files
    track_eval_phase(cuda_attention, cuda_msda, motr_exact, dino, cfg, k1,
                     k3, k5)

    # 43, 44. int8 serving: the int8 layers against their plain int32
    #     products, fv0 int8 fp32 card vs CPU, the bf16 b256 serving path
    #     against bf16, timed in turns, and fv4 int8 card vs CPU
    t0 = time.perf_counter()
    served_int8 = int8_phases(fvt, cuda_attention, quant)
    print(f"int8 serving (phases 43-44): {time.perf_counter() - t0:.1f} s")
    k1["launches_int8_serving"] = served_int8["launches"]
    k1["launches_int8_serving_in"] = (
        f"one faster_vit_0_224 int8 bf16 b{BATCH} forward of the int8 "
        "serving path (create_model(quantized=True))")

    # 45. the evaluation path: the validate CLI (float, --int8,
    #     --synthetic) and the train CLI from --data-dir
    evaluated = eval_phase(cuda_attention, train_cli)
    k1["launches_data_dir_training"], k2["launches_data_dir_training"] = \
        evaluated["train_launches"][:2]
    k1["launches_data_dir_training_in"] = \
        k2["launches_data_dir_training_in"] = (
            f"the train CLI from --data-dir: 2 fv0 bf16 b{EVAL_TRAIN_BATCH} "
            f"steps and eval of the model and its EMA over {EVAL_IMAGES} "
            "images")

    # 46. export on the card: fv0, 21k-384 and fv0 int8 programs loaded in
    #     a fresh process, bit-equal to eager; program against eager in
    #     turns; the ONNX graph on the CPU
    exported = export_phase(fvt, cuda_attention)
    k1["launches_exported_program"] = exported["k1_per_forward"]
    k3["launches_exported_program"] = exported["k3_per_forward"]
    k1["launches_exported_program_in"] = (
        f"one forward of the exported faster_vit_0_224 bf16 b{BATCH} program "
        "loaded in a fresh process")
    k3["launches_exported_program_in"] = (
        f"one forward of the exported {EXPORT_LONG} bf16 "
        f"b{EXPORT_LONG_BATCH} program loaded in a fresh process")

    # 47. data parallel on the card: the train CLI over a one-process NCCL
    #     group (DDP, SyncBatchNorm) against the plain run
    ddp = ddp_phase()
    k1["launches_ddp_training"], k2["launches_ddp_training"] = \
        ddp["launches"]
    k1["launches_ddp_training_in"] = k2["launches_ddp_training_in"] = (
        f"the train CLI under a one-process NCCL group: {DDP_STEPS} fv0 "
        f"bf16 b{TRAIN_BATCH} steps and the eval, in its process")

    # 48. dropout: the plain attention route in training, K1 at eval
    dropout_phase(fvt, cuda_attention, steps, mixup)

    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, p1, p2,
                                  *gathers, k7]}))
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
