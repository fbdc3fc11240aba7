"""The port's probes, counterparts of the JAX package's probe scripts
under the same names:

- the long-window attention at FasterViT-4-21k's 768² level-2 call (16
  windows of S = 2304 tokens, 16 heads, head dim 49, bf16):
  attn_vpu_probe and attn_online_probe (scripts/attn_vpu_probe.py,
  scripts/attn_online_probe.py);
- MSDA's bilinear gather at MOTR's streaming levels (8 heads, D 32, P 4,
  408,000 samples a head and level): msda_pallas_probe,
  msda_packed_probe and msda_packed_probe2 (scripts/msda_pallas_probe.py,
  scripts/msda_packed_probe.py, scripts/msda_packed_probe2.py).

    python -m fastervit_tpu_torch.probes.attn_vpu_probe [--out PATH]
    python -m fastervit_tpu_torch.probes.attn_online_probe --device cpu \\
        --batch 2 --seq 64 --heads 2
    python -m fastervit_tpu_torch.probes.msda_pallas_probe [--e2e-only]
    python -m fastervit_tpu_torch.probes.msda_packed_probe --device cpu
    python -m fastervit_tpu_torch.probes.msda_packed_probe2 --device cpu

Each prints one JSON object to stdout and writes a file only at --out,
never over the JAX package's TPU records at the repo root. On the card
(the default) it times each row with CUDA events after a warm-up, the rows
in turns (in order, then in reverse, each averaged over its two). With
--device cpu it runs the plain versions once each, at a small size, and
times nothing; without a card and without --device cpu it exits non-zero.
Inputs come from a seeded torch.Generator.

This module holds what the probes share, and the timing, SDPA and
grid_sample helpers that chip_smoke.py uses too.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

ITERS = 10  # timed calls a row and turn, as the JAX probes' ITERS
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
# the JAX package's TPU records, which these probes must never overwrite
_TPU_RECORDS = tuple(Path(__file__).resolve().parents[2] / name for name in
                     ("ATTN_ONLINE_PROBE.json", "ATTN_VPU_PROBE.json",
                      "MSDA_PALLAS_PROBE.json", "MSDA_PACKED_PROBE.json",
                      "MSDA_PACKED_PROBE2.json"))


def probe_parser(description: str) -> argparse.ArgumentParser:
    """The flags every probe takes: device, seed, output."""
    ap = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; exits non-zero without a card) or "
                         "cpu (the plain versions, untimed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON here (no file otherwise)")
    return ap


def parse_probe_args(ap: argparse.ArgumentParser,
                     argv: Optional[Sequence[str]]) -> argparse.Namespace:
    """Parse; refuse an --out that is one of the JAX package's TPU
    records."""
    args = ap.parse_args(argv)
    if args.out is not None and Path(args.out).resolve() in _TPU_RECORDS:
        ap.error(f"--out {args.out} is a TPU record of the JAX package; "
                 "choose another path")
    return args


def parse_args(description: str, argv: Optional[Sequence[str]]
               ) -> argparse.Namespace:
    """The attention probes' flags: device, geometry, seed, output."""
    ap = probe_parser(description)
    ap.add_argument("--batch", type=int, default=16, help="windows B")
    ap.add_argument("--seq", type=int, default=2304, help="tokens S")
    ap.add_argument("--heads", type=int, default=16, help="heads H")
    ap.add_argument("--head-dim", type=int, default=49, help="head dim hd")
    return parse_probe_args(ap, argv)


def resolve_device(name: str) -> torch.device:
    """The probe's device; exits non-zero when the card is asked for and
    there is none."""
    if name == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: run on the card, or pass --device cpu for "
                 "the plain versions")
    return torch.device(name)


def device_record(device: torch.device) -> dict:
    """What ran the probe: the device's name and, on the card, its name and
    power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return {"type": "cpu", "timed": False}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "not read"
    return {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": smi, "timed": True}


def time_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
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


def in_turns(fns: Dict[str, Optional[Callable[[], object]]],
             iters: int = ITERS) -> Dict[str, Optional[float]]:
    """Each function's time, taken in order and then in reverse order and
    averaged over the two. A function given as None is not timed, and its
    time is None."""
    names = [n for n, fn in fns.items() if fn is not None]
    first = {n: time_ms(fns[n], iters) for n in names}
    second = {n: time_ms(fns[n], iters) for n in reversed(names)}
    return {n: (first[n] + second[n]) / 2 if n in first else None
            for n in fns}


def sdpa_backend(fn: Callable[[], object]) -> str:
    """The aten SDPA ops that one call of fn runs, by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if "attention" in e.name and e.name.startswith("aten::_")})
    return ", ".join(names) or "unknown"


def sdpa_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: Optional[torch.Tensor], scale: float
             ) -> Tuple[Callable[[], torch.Tensor], int]:
    """One scaled_dot_product_attention call on (B, H, S, hd) q, k, v with
    an optional float mask, and the head dim it runs at. On the card q, k
    and v are zero-padded to a head dim that is a multiple of 8, which
    SDPA's fused backends want (at hd 49 it runs its math backend with a
    float mask, and flash attention, padding inside, without one); the
    zeros add nothing to q kᵀ and the padded output columns are dropped."""
    d = q.shape[-1]
    pad = (-d) % 8 if q.is_cuda else 0
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    return (lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)[..., :d]), d + pad


def msda_grid_sample(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                     loc: torch.Tensor, weights: torch.Tensor
                     ) -> torch.Tensor:
    """Upstream's plain MSDA, ms_deform_attn_core_pytorch (dino/models/dino/
    ops/functions/ms_deform_attn_func.py:41-61): F.grid_sample per level
    (zero padding, align_corners=False), then the weighted sum. value
    (N, S, M, D), loc (N, Q, M, L, P, 2), weights (N, Q, M, L, P); returns
    (N, Q, M·D). Timed as the yardstick of K5; the port never calls it."""
    n, s, m, d = value.shape
    _, q, _, nl, p, _ = loc.shape
    values = value.split([h * w for h, w in shapes], dim=1)
    grids = (2 * loc - 1).to(value.dtype)  # grid_sample takes one dtype
    sampled = []
    for lid, (h, w) in enumerate(shapes):
        v = values[lid].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    weights = weights.transpose(1, 2).reshape(n * m, 1, q, nl * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * weights).sum(-1)
    return out.view(n, m * d, q).transpose(1, 2).contiguous()


def gather_grid(iy: torch.Tensor, ix: torch.Tensor, fy: torch.Tensor,
                fx: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """The MSDA gather probes' samples as a grid_sample grid (M, 1, QP, 2)
    over the padded (Hp, Wp) map with align_corners=True: x = 2(ix + fx) /
    (Wp − 1) − 1, y likewise."""
    x = 2 * (ix + fx) / (wp - 1) - 1
    y = 2 * (iy + fy) / (hp - 1) - 1
    return torch.stack((x, y), -1)[:, None]


def gather_grid_sample(vm_nchw: torch.Tensor, grid: torch.Tensor,
                       w: torch.Tensor, p: int) -> torch.Tensor:
    """The library yardstick of the MSDA gather probes: F.grid_sample
    (bilinear, zero padding, align_corners=True) of the padded map
    (M, D, Hp, Wp) at `gather_grid`'s samples, times w (M, QP), summed over
    each query's P samples when P > 1. Returns (M, D, QP/P), the probes'
    output transposed (left so: the transpose is no part of the gather).
    Timed beside P3a-c and P4a; the port never calls it."""
    out = F.grid_sample(vm_nchw, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)[:, :, 0] * w[:, None]
    if p > 1:
        m, d, qp = out.shape
        out = out.view(m, d, qp // p, p).sum(-1)
    return out


def gather_bytes(map_bytes: int, m: int, qp: int, d: int, p: int,
                 scalars: int) -> int:
    """Bytes an MSDA gather probe must move: the map, `scalars` 4-byte
    values a sample (P3, P4b: iy, ix, fy, fx, w; P4a: fl, fy, fx, w; P4c:
    fl, c00, c01, c10, c11; P4d: fl and its cf row, 1 + 4D) and the f32
    output (M, QP/P, d), each once (P4d's output is d = 4D wide)."""
    return map_bytes + 4 * scalars * m * qp + 4 * m * (qp // p) * d


def report(result: dict, out: Optional[str]) -> dict:
    """Print the result as one JSON line; write it at `out` if given."""
    text = json.dumps(result)
    print(text, flush=True)
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result, indent=1) + "\n")
    return result
