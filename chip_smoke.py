"""Smoke run of fastervit_tpu_torch, the PyTorch/CUDA port of FasterViT, on
one NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles the port's CUDA sources (fastervit_tpu_torch/csrc),
     one nvcc per source, all at once;
  3. K1, the window-attention kernel, against its plain PyTorch version on
     the card, at FasterViT-0's batch-256 shapes and an odd shape, in fp32
     and bf16; kernel, plain version and SDPA timed at the fv0 shapes;
  4. K2, the window-attention backward kernel, against its plain version,
     in fp32 and bf16, at FasterViT-0's batch-128 training shapes, an odd
     shape and K2's largest shape; kernel, plain version and SDPA's backward
     timed at the training shapes;
  5. faster_vit_0_224 in fp32 through create_model, on the card (kernel
     path) against the CPU (plain path), batch 4, counting kernel launches;
  6. the inference path: faster_vit_0_224 in bf16 at batch 256, its K1
     launches counted, its logits against fp32 on the same weights, timed;
  7. one fv0 fp32 train step, card against CPU, batch 4, same weights and
     mixup draws: loss and every gradient, 17 K1 and 17 K2 launches, the
     attention gradients non-zero;
  8. the training path: the train.py CLI on synthetic data (4 steps at
     batch 128 and eval), then make_train_step with the fv0 recipe in bf16
     at batch 128: 10 steps on one batch must lower the loss, then 20 steps
     timed, launches counted, and 2 profiled;
  9. K3, the long-window attention kernel, against its plain version in
     fp32 and bf16 (bias f32 and bf16) at the 21k-768 and 21k-384 shapes,
     the any-res carrier shape, an fv5 shape (hd 80), ragged S and B = 0;
     kernel, plain version and SDPA timed at the 21k shapes;
 10. faster_vit_4_21k_768 in fp32 through create_model, on the card (K3
     path) against the CPU (plain path), batch 1;
 11. the serving path: faster_vit_4_21k_768 in bf16 at batch 16, a live
     forward, bake_posemb, a baked forward bit-identical to it, launches
     counted, logits against fp32 on the same weights, live and baked
     forwards timed, one baked forward profiled;
 12. faster_vit_0_any_res (576x960) and faster_vit_5_224 in bf16: their
     K1 and K3 launches, logits against fp32.
It prints one JSON line on the kernels and, as its last line,
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result. It imports no jax.
"""
from __future__ import annotations

import copy
import csv
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

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
TOL_BF16 = 2e-2      # bf16 output and probabilities against f32 on bf16 inputs
# K2, relative to max(1, max |plain|): f32 throughout, TF32 off, sums in
# another order (dbias sums over up to 512 windows) ...
TOL_K2_FP32 = 1e-4
# ... and bf16 inputs on both sides, the kernel's outputs rounded to bf16
# once (2^-8 relative)
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
SERVE_BATCH = 16
TOL_MODEL_FP32 = 1e-3
TOL_MODEL_BF16 = 0.15  # the bf16-vs-fp32 bound of tests/test_variants.py
# fp32 train step, card against CPU: the loss, and each gradient tensor
# relative to its largest entry (floor: 1e-5 of the largest of all, for the
# conv biases in front of a train-mode BatchNorm, whose gradient is zero in
# exact arithmetic and so only noise on both devices)
TOL_STEP_LOSS = 1e-4
TOL_STEP_GRAD = 1e-3
BATCH = 256
TRAIN_BATCH = 128
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
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


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, with CUDA events after a warm-up."""
    for _ in range(warmup):
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


def in_turns(plain, kernel, library, iters: int = 30):
    """Times of plain, kernel and library call, taken in turns (plain,
    kernel, library, library, kernel, plain), each averaged over its two."""
    p1, k1, l1, l2, k2, p2 = (time_ms(f, iters) for f in
                              (plain, kernel, library, library, kernel, plain))
    return (p1 + p2) / 2, (k1 + k2) / 2, (l1 + l2) / 2


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes moved over the memory rate
    or operations over the bf16 peak, whichever is larger."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def split_heads(qkv: torch.Tensor, heads: int):
    """(B, S, 3C) -> contiguous q, k, v of (B, H, S, hd), for SDPA."""
    b, s, c3 = qkv.shape
    return [t.contiguous() for t in qkv.reshape(
        b, s, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)]


def sdpa_backend(fn) -> str:
    """The aten SDPA ops that one call of fn runs, by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if "attention" in e.name and e.name.startswith("aten::_")})
    return ", ".join(names) or "unknown"


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


def k1_phase(cuda_attention, attention) -> dict:
    kernel = cuda_attention.window_mhsa_cuda
    plain = attention.window_mhsa_reference
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    err32_all, err16_all = 0.0, 0.0
    ms_fwd = plain_ms_fwd = lib_ms_fwd = bound_fwd = 0.0
    backend = ""
    for b, s, h, d, calls in FV0_SHAPES + [ODD_SHAPE]:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        bias = torch.randn(h, s, s, device="cuda", generator=gen)
        scale = d ** -0.5
        err32 = (kernel(qkv, bias, h, scale)
                 - plain(qkv, bias, h, scale)).abs().max().item()
        q16, b16 = qkv.bfloat16(), bias.bfloat16()
        err16 = (kernel(q16, b16, h, scale).float()
                 - plain(q16.float(), b16.float(), h, scale)).abs().max().item()
        torch.cuda.synchronize()
        print(f"K1 window_mhsa B={b} S={s} H={h} hd={d}: max|err| fp32 "
              f"{err32:.3e} (tol {TOL_FP32}), bf16 {err16:.3e} "
              f"(tol {TOL_BF16})")
        check(err32 <= TOL_FP32, f"fp32 kernel error {err32} at {(b, s, h, d)}")
        check(err16 <= TOL_BF16, f"bf16 kernel error {err16} at {(b, s, h, d)}")
        err32_all, err16_all = max(err32_all, err32), max(err16_all, err16)
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
            bound = bound_ms(nbytes, 4.0 * b * h * s * s * d)
            ms_fwd += calls * ms
            plain_ms_fwd += calls * plain_ms
            lib_ms_fwd += calls * lib_ms
            bound_fwd += calls * bound
            print(f"K1 window_mhsa B={b} S={s} H={h} hd={d} bf16: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
                  f"ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB) per call")
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
            "per": f"one fv0 bf16 b{BATCH} forward (17 calls)"}


def k2_phase(cuda_attention, attention) -> dict:
    kernel = cuda_attention.window_mhsa_backward_cuda
    plain = attention.window_mhsa_backward_reference
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    err32_all = err16_all = 0.0
    ms_step = plain_step = lib_step = bound_step = 0.0
    backend = ""
    for b, s, h, d, calls in TRAIN_SHAPES + K2_EXTRA_SHAPES:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        bias = torch.randn(h, s, s, device="cuda", generator=gen)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen)
        scale = d ** -0.5
        got = kernel(qkv, bias, g, h, scale)
        want = plain(qkv, bias, g, h, scale)
        err32 = max(rel_err(got[0], want[0]), rel_err(got[1], want[1]))
        q16, b16, g16 = qkv.bfloat16(), bias.bfloat16(), g.bfloat16()
        got = kernel(q16, b16, g16, h, scale)
        want = plain(q16.float(), b16.float(), g16.float(), h, scale)
        err16 = max(rel_err(got[0], want[0]), rel_err(got[1], want[1]))
        torch.cuda.synchronize()
        print(f"K2 window_mhsa_backward B={b} S={s} H={h} hd={d}: max|err| "
              f"/ max(1, max|plain|) of dqkv and dbias: fp32 {err32:.3e} "
              f"(tol {TOL_K2_FP32}), bf16 {err16:.3e} (tol {TOL_K2_BF16})")
        check(err32 <= TOL_K2_FP32, f"K2 fp32 error {err32} at {(b, s, h, d)}")
        check(err16 <= TOL_K2_BF16, f"K2 bf16 error {err16} at {(b, s, h, d)}")
        err32_all, err16_all = max(err32_all, err32), max(err16_all, err16)
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
            bound = bound_ms(nbytes, 10.0 * b * h * s * s * d)
            ms_step += calls * ms
            plain_step += calls * plain_ms
            lib_step += calls * lib_ms
            bound_step += calls * bound
            print(f"K2 window_mhsa_backward B={b} S={s} H={h} hd={d} bf16: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
                  f"backward {lib_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB) per call")
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
            "per": f"one fv0 bf16 b{TRAIN_BATCH} train step (17 calls)"}


def k3_phase(cuda_attention, attention) -> dict:
    kernel = cuda_attention.window_mhsa_long_cuda
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
        q16 = qkv.bfloat16()
        err16 = 0.0
        for bias_in in (bias, bias.bfloat16()):
            if b:
                err16 = max(err16, (kernel(q16, bias_in, h, scale).float()
                                    - plain(q16.float(), bias_in.float(), h,
                                            scale)).abs().max().item())
            else:
                check(kernel(q16, bias_in, h, scale).shape == (0, s, h * d),
                      "K3 output of an empty batch")
        torch.cuda.synchronize()
        if not b:
            check(kernel.launches == before, "K3 launched on an empty batch")
        print(f"K3 window_mhsa_long B={b} S={s} H={h} hd={d}: max|err| fp32 "
              f"{err32:.3e} (tol {TOL_FP32}), bf16 with f32 and bf16 bias "
              f"{err16:.3e} (tol {TOL_BF16})")
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
        per_call[f"({b},{s},{h},{d})"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": ("operations" if flops
                                            / BF16_FLOP_PER_S > nbytes
                                            / HBM_BYTES_PER_S else "bytes")}
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
            "ms": ms_fwd, "plain_ms": plain_fwd, "bound_ms": bound_fwd,
            "bound_by": "operations", "library_ms": lib_fwd,
            "library": f"scaled_dot_product_attention ({backend})",
            "per": f"one faster_vit_4_21k_768 bf16 b{SERVE_BATCH} forward "
                   "(17 calls: 12 at level 2, operations-bound; 5 at level "
                   "3, bytes-bound)",
            "per_call": per_call}


def launches(cuda_attention):
    """Launches so far of K1, K2 and K3."""
    return (cuda_attention.window_mhsa_cuda.launches,
            cuda_attention.window_mhsa_backward_cuda.launches,
            cuda_attention.window_mhsa_long_cuda.launches)


def reset_launches(cuda_attention) -> None:
    cuda_attention.window_mhsa_cuda.launches = 0
    cuda_attention.window_mhsa_backward_cuda.launches = 0
    cuda_attention.window_mhsa_long_cuda.launches = 0


def synthetic_batch(batch: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(batch, 224, 224, 3).astype(np.float32),
            "label": rng.randint(0, 1000, batch).astype(np.int32)}


def train_parity_phase(fvt, cuda_attention, steps) -> None:
    """One fp32 step, card against CPU, on the same weights and batch."""
    model_cpu = fvt.create_model("faster_vit_0_224", device="cpu",
                                 drop_path_rate=0.0,
                                 generator=torch.Generator().manual_seed(3))
    model = copy.deepcopy(model_cpu).to("cuda")
    cfg = steps.TrainConfig()   # the fv0 recipe: mixup, adamw, clip, EMA
    batch = synthetic_batch(4, 4)
    metrics = {}
    for m in (model_cpu, model):
        step = steps.make_train_step(cfg, lambda t: 1e-3, seed=5)
        before = launches(cuda_attention)
        metrics[m] = step(steps.create_train_state(m, cfg), batch)
        torch.cuda.synchronize()
        calls = [a - b for a, b in zip(launches(cuda_attention), before)]
    check(calls == [17, 17, 0], f"K1, K2, K3 launches per step {calls}, "
                                "expected 17, 17 and 0")
    dloss = abs(metrics[model]["loss"].item()
                - metrics[model_cpu]["loss"].item())
    grads_cpu = dict(model_cpu.named_parameters())
    floor = 1e-5 * max(p.grad.abs().max().item() for p in grads_cpu.values())
    worst, worst_name = 0.0, ""
    for name, p in model.named_parameters():
        want = grads_cpu[name].grad
        err = (p.grad.cpu() - want).abs().max().item()
        bound = max(TOL_STEP_GRAD * want.abs().max().item(), floor)
        check(err <= bound, f"gradient of {name}: card vs CPU {err} > {bound}")
        if err / bound > worst:
            worst, worst_name = err / bound, name
        if ".qkv." in name or ".pos_emb_funct.cpb_mlp." in name:
            check(bool(p.grad.abs().sum() > 0), f"zero gradient at {name}")
    print(f"fv0 fp32 train step b4, card vs CPU: |dloss| {dloss:.3e} (tol "
          f"{TOL_STEP_LOSS}); every gradient within {TOL_STEP_GRAD} of its "
          f"tensor's largest entry (worst {worst:.3f} of the bound, at "
          f"{worst_name}); qkv and cpb_mlp gradients non-zero; K1, K2, K3 "
          f"launches per step {calls}")
    check(dloss <= TOL_STEP_LOSS, f"loss card vs CPU {dloss}")


KINDS = [  # (kind, substrings of a kernel's name), first match wins
    ("K3 window_mhsa_long", ("window_mhsa_long",)),
    ("K2 window_mhsa_backward", ("window_mhsa_bwd", "dbias_sum")),
    ("K1 window_mhsa", ("window_mhsa_kernel",)),
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
                   out_name: str) -> None:
    """torch.profiler over n calls of fn (n `what`s): device time by kind
    of kernel, against the unprofiled time unit_ms of one call, written to
    chiprun_out/<out_name> with the raw kernel table. Annotations that the
    profiler mirrors onto the device's timeline (such as
    Optimizer.step#AdamW.step) are not kernels and are left out."""
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
        return
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


def train_main_phase(fvt, cuda_attention, steps, train_cli, schedule,
                     mixup) -> dict:
    """The training path: the CLI end to end, then make_train_step with the
    fv0 recipe in bf16 at batch 128."""
    out = {}
    # 1. the CLI: 4 steps at batch 128 and synthetic eval
    with tempfile.TemporaryDirectory() as tmp:
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
    check(cli_calls == (4 * 17 + 8 * 17, 4 * 17, 0),
          f"CLI K1, K2, K3 launches {cli_calls}")
    print(f"CLI (train.py, fv0 recipe, 4 steps b{TRAIN_BATCH} + eval): "
          f"{cli_s:.1f} s; summary.csv {dict(rows[0])}; K1, K2, K3 launches "
          f"{cli_calls}")

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
    check(calls == (25 * 17, 25 * 17, 0), f"K1, K2, K3 launches over 25 "
                                          f"steps {calls}, expected 425, "
                                          "425 and 0")
    check(math.isfinite(loss), f"loss {loss}")
    print(f"fv0 bf16 b{TRAIN_BATCH} train step (fv0 recipe, eager): "
          f"{ms:.3f} ms a step, {TRAIN_BATCH * 1000 / ms:.1f} img/s; peak "
          f"memory {peak / 2**20:.1f} MiB; K1, K2, K3 launches over 25 steps "
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
          f"{err:.3e} (tol {TOL_MODEL_FP32}); K1, K2, K3 launches per "
          f"forward {calls}; build on the CPU and copy {build_s:.1f} s, CPU "
          f"forward {cpu_s:.1f} s")
    check(got.shape == (1, 1000) and bool(torch.isfinite(got).all()),
          "21k-768 fp32 logits finite, (1, 1000)")
    check(err <= TOL_MODEL_FP32, f"21k-768 fp32 logits error {err}")
    check(calls == (0, 0, 17), f"21k-768 launches {calls}, expected 17 K3")
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
          f"forward: K1, K2, K3 launches {calls}; baked logits bit-identical "
          f"to live: {same}; max|bf16 - fp32 logits| {gap:.4f} (tol "
          f"{TOL_MODEL_BF16})")
    check(calls == (0, 0, 34), f"launches {calls}, expected 34 K3 only")
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
    for name, want in (("faster_vit_0_any_res", (11, 0, 6)),
                       ("faster_vit_5_224", (0, 0, 29))):
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
        print(f"{name} bf16 b8 at {h}x{w}: K1, K2, K3 launches {calls}; "
              f"max|bf16 - fp32 logits| {gap:.4f} (tol {TOL_MODEL_BF16})")
        check(calls == want, f"{name} launches {calls}, expected {want}")
        check(logits.shape == (8, 1000)
              and bool(torch.isfinite(logits).all()),
              f"{name} bf16 logits finite, (8, 1000)")
        check(gap <= TOL_MODEL_BF16, f"{name} bf16 logits off fp32 by {gap}")
        del model, model16, x, ref, logits


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(REPO))
    import fastervit_tpu_torch as fvt
    from fastervit_tpu_torch.ops import attention, cuda_attention
    from fastervit_tpu_torch.train import mixup, schedule, steps
    from fastervit_tpu_torch.train import train as train_cli

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
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # 3, 4. the kernels against their plain versions
    k1 = k1_phase(cuda_attention, attention)
    k2 = k2_phase(cuda_attention, attention)

    # 5. fp32: kernel path on the card against the plain path on the CPU
    model_cpu = fvt.create_model("faster_vit_0_224", device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    model_cpu.eval()
    model = copy.deepcopy(model_cpu).to("cuda")
    x = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model_cpu(x)
        before = launches(cuda_attention)
        got = model(x.to("cuda"))
        torch.cuda.synchronize()
        calls = tuple(a - b for a, b in zip(launches(cuda_attention), before))
    err = (got.cpu() - want).abs().max().item()
    print(f"fv0 fp32 b4: card vs CPU max|dlogits| {err:.3e} "
          f"(tol {TOL_MODEL_FP32}); K1, K2, K3 launches per forward {calls}")
    check(got.shape == (4, 1000) and bool(torch.isfinite(got).all()),
          "fp32 logits finite, (4, 1000)")
    check(err <= TOL_MODEL_FP32, f"fp32 logits error {err}")
    check(calls == (17, 0, 0), f"launches per forward {calls}, expected 17 "
                               "K1 only")
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
        logits = model16(xb16)
        torch.cuda.synchronize()
        calls = launches(cuda_attention)
        k1_inference = calls[0]
        gap = (logits.float() - ref).abs().max().item()
        print(f"fv0 bf16 b{BATCH}: K1, K2, K3 launches {calls}; max|bf16 - "
              f"fp32 logits| {gap:.4f} (tol {TOL_MODEL_BF16})")
        check(calls == (17, 0, 0), f"launches {calls}, expected 17 K1 only")
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
    k1["launches"], k2["launches"], _ = trained["launches"]
    k1["launches_in"] = k2["launches_in"] = (
        f"25 fv0 bf16 b{TRAIN_BATCH} train steps of the training path")
    k1["launches_inference"] = k1_inference

    # 9. K3 against its plain version
    k3 = k3_phase(cuda_attention, attention)

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

    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
