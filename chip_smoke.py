"""Smoke run of fastervit_tpu_torch, the PyTorch/CUDA port of FasterViT, on
one NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles the port's CUDA sources (fastervit_tpu_torch/csrc);
  3. the window-attention kernel against its plain PyTorch version on the
     card, at FasterViT-0's batch-256 shapes and an odd shape, in fp32 and
     bf16, and both timed at the FasterViT-0 shapes;
  4. faster_vit_0_224 in fp32 through create_model, on the card (kernel
     path) against the CPU (plain path), batch 4, counting kernel launches;
  5. the main path: faster_vit_0_224 in bf16 at batch 256, its launches
     counted, its logits against fp32 on the same weights, then timed.
It prints one JSON line on the kernels and, as its last line,
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result. It imports no jax.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

# (B, S, heads, head_dim, calls per FasterViT-0 forward): level-2 joint
# window + carrier attention, level-2 carrier attention, level 3, at batch
# 256; then an odd shape with FasterViT-4's head_dim, checked but not timed.
FV0_SHAPES = [(1024, 53, 8, 32, 6), (256, 16, 8, 32, 6), (256, 49, 16, 32, 5)]
ODD_SHAPE = (3, 53, 4, 49, 0)
TOL_FP32 = 2e-5      # f32 throughout, TF32 off: only the order of sums differs
TOL_BF16 = 2e-2      # bf16 output and probabilities against f32 on bf16 inputs
TOL_MODEL_FP32 = 1e-3
TOL_MODEL_BF16 = 0.15  # the bf16-vs-fp32 bound of tests/test_variants.py
BATCH = 256


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


def kernel_phase(cuda_attention, attention) -> dict:
    kernel = cuda_attention.window_mhsa_cuda
    plain = attention.window_mhsa_reference
    gen = torch.Generator(device="cuda").manual_seed(0)
    err32_all, err16_all = 0.0, 0.0
    ms_fwd = plain_ms_fwd = 0.0
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
            # the main path's dtype, in turns: plain, kernel, kernel, plain
            run_k = lambda: kernel(q16, b16, h, scale)
            run_p = lambda: plain(q16, b16, h, scale)
            p1, k1, k2, p2 = (time_ms(f, 50) for f in (run_p, run_k, run_k,
                                                       run_p))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            ms_fwd += calls * ms
            plain_ms_fwd += calls * plain_ms
            print(f"K1 window_mhsa B={b} S={s} H={h} hd={d} bf16: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms per call")
    print(f"K1 window_mhsa over one fv0 bf16 b{BATCH} forward's 17 calls: "
          f"kernel {ms_fwd:.4f} ms, plain {plain_ms_fwd:.4f} ms")
    # ms and plain_ms: the sum over one FasterViT-0 bf16 b256 forward's calls
    return {"name": "window_mhsa", "route": "cuda",
            "source": "fastervit_tpu_torch/csrc/window_mhsa.cu",
            "replaces": "fastervit_tpu/ops/pallas_attention.py:73",
            "launches": None, "max_abs_err": err16_all,
            "max_abs_err_fp32": err32_all,
            "ms": ms_fwd, "plain_ms": plain_ms_fwd}


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import fastervit_tpu_torch as fvt
    from fastervit_tpu_torch.ops import attention, cuda_attention

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
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. the kernel against its plain version
    k1 = kernel_phase(cuda_attention, attention)

    # 4. fp32: kernel path on the card against the plain path on the CPU
    model_cpu = fvt.create_model("faster_vit_0_224",
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

    # 5. main path: bf16, batch 256
    gen = torch.Generator(device="cuda").manual_seed(2)
    xb = torch.randn(BATCH, 3, 224, 224, device="cuda", generator=gen)
    with torch.no_grad():
        ref = model(xb)
    model16 = model.to(torch.bfloat16)  # the same weights, now bf16
    del model
    xb16 = xb.bfloat16()
    del xb
    with torch.no_grad():
        cuda_attention.window_mhsa_cuda.launches = 0
        logits = model16(xb16)
        torch.cuda.synchronize()
        k1["launches"] = cuda_attention.window_mhsa_cuda.launches
        gap = (logits.float() - ref).abs().max().item()
        print(f"fv0 bf16 b{BATCH}: K1 launches {k1['launches']}; max|bf16 - "
              f"fp32 logits| {gap:.4f} (tol {TOL_MODEL_BF16})")
        check(k1["launches"] == 17, f"{k1['launches']} K1 launches, expected 17")
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

    print(json.dumps({"kernels": [k1]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
