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
     timed, launches counted, and 2 profiled.
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


def launches(cuda_attention):
    return (cuda_attention.window_mhsa_cuda.launches,
            cuda_attention.window_mhsa_backward_cuda.launches)


def reset_launches(cuda_attention) -> None:
    cuda_attention.window_mhsa_cuda.launches = 0
    cuda_attention.window_mhsa_backward_cuda.launches = 0


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
    check(calls == [17, 17], f"K1, K2 launches per step {calls}, "
                             "expected 17 and 17")
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
          f"{worst_name}); qkv and cpb_mlp gradients non-zero; K1, K2 "
          f"launches per step {calls}")
    check(dloss <= TOL_STEP_LOSS, f"loss card vs CPU {dloss}")


KINDS = [  # (kind, substrings of a kernel's name), first match wins
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


def profile_steps(step, state, batch, n: int, step_ms: float,
                  smi: str) -> None:
    """torch.profiler over n train steps: device time by kind of kernel,
    against the unprofiled step time step_ms, written to
    chiprun_out/train_profile.json with the raw kernel table. Annotations
    that the profiler mirrors onto the device's timeline (such as
    Optimizer.step#AdamW.step) are not kernels and are left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step(state, batch)
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
    print(f"profile of {n} fv0 bf16 b{TRAIN_BATCH} train steps: device "
          f"{total:.3f} ms a step, {100 * total / step_ms:.1f}% of the "
          f"unprofiled {step_ms:.3f} ms step (profiled wall {wall_ms:.3f} "
          f"ms); device ms a step by kind [{smi}]:")
    for kind, (t, c) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind:36s} {t:9.3f} ms {100 * t / total:5.1f}%  "
              f"{c:6.1f} launches")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "train_profile.json").write_text(json.dumps({
        "card": smi, "steps": n, "wall_ms_per_step": wall_ms,
        "unprofiled_ms_per_step": step_ms, "device_ms_per_step": total,
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
    check(cli_calls == (4 * 17 + 8 * 17, 4 * 17),
          f"CLI K1, K2 launches {cli_calls}")
    print(f"CLI (train.py, fv0 recipe, 4 steps b{TRAIN_BATCH} + eval): "
          f"{cli_s:.1f} s; summary.csv {dict(rows[0])}; K1, K2 launches "
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
    check(calls == (25 * 17, 25 * 17), f"K1, K2 launches over 25 steps "
                                       f"{calls}, expected 425 and 425")
    check(math.isfinite(loss), f"loss {loss}")
    print(f"fv0 bf16 b{TRAIN_BATCH} train step (fv0 recipe, eager): "
          f"{ms:.3f} ms a step, {TRAIN_BATCH * 1000 / ms:.1f} img/s; peak "
          f"memory {peak / 2**20:.1f} MiB; K1, K2 launches over 25 steps "
          f"{calls}; last loss {loss:.4f}, grad_norm "
          f"{metrics['grad_norm'].item():.4f} [{smi}]")
    out.update(launches=calls, step_ms=ms, peak=peak)
    profile_steps(step, state, batch, 2, ms, smi)
    return out


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
        before = cuda_attention.window_mhsa_cuda.launches
        got = model(x.to("cuda"))
        torch.cuda.synchronize()
        calls = cuda_attention.window_mhsa_cuda.launches - before
    err = (got.cpu() - want).abs().max().item()
    print(f"fv0 fp32 b4: card vs CPU max|dlogits| {err:.3e} "
          f"(tol {TOL_MODEL_FP32}); K1 launches per forward {calls}")
    check(got.shape == (4, 1000) and bool(torch.isfinite(got).all()),
          "fp32 logits finite, (4, 1000)")
    check(err <= TOL_MODEL_FP32, f"fp32 logits error {err}")
    check(calls == 17, f"{calls} K1 launches per forward, expected 17")
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
        k1_inference = cuda_attention.window_mhsa_cuda.launches
        gap = (logits.float() - ref).abs().max().item()
        print(f"fv0 bf16 b{BATCH}: K1 launches {k1_inference}; max|bf16 - "
              f"fp32 logits| {gap:.4f} (tol {TOL_MODEL_BF16})")
        check(k1_inference == 17, f"{k1_inference} K1 launches, expected 17")
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
    k1["launches"], k2["launches"] = trained["launches"]
    k1["launches_in"] = k2["launches_in"] = (
        f"25 fv0 bf16 b{TRAIN_BATCH} train steps of the training path")
    k1["launches_inference"] = k1_inference

    print(json.dumps({"kernels": [k1, k2]}))
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
