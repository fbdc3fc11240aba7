"""The host cost of reaching K1 through its operator, on the card: the
window attention calls of one faster_vit_0_224 bf16 b256 eval forward,
captured with their own inputs, issued three ways in one process, in turns:

* "wrapper": `cuda_attention.window_mhsa_cuda` (or `window_mhsa_long_cuda`
  on the K3 route) called directly;
* "op": `torch.ops.fastervit.window_mhsa_short` / `window_mhsa_long`;
* "window_mhsa": `ops.attention.window_mhsa`, as the model calls it
  (the route, then `WindowMHSA` and the op).

    python fastervit_tpu_torch/probes/dispatch_turns.py \\
        --out chiprun_out/dispatch_turns.json

Each turn issues the captured calls --iters times over, with no
synchronisation between them, and takes the host's time to issue them
(`time.perf_counter`, then one synchronisation) and the card's time
(CUDA events around the same calls). The forms go in order and then in
reverse, --rounds times. Every form's outputs must equal the wrapper's
(torch.equal). It prints one JSON object, with the card's name and power
limit, and writes it to --out if given. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH = 256
WARMUP = 3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    import fastervit_tpu_torch as fvt
    from fastervit_tpu_torch.models.layers import WindowAttention
    from fastervit_tpu_torch.ops import attention, cuda_attention, library
    if not torch.cuda.is_available():
        raise SystemExit("dispatch_turns needs a CUDA device")
    model = fvt.create_model("faster_vit_0_224", dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0)
                             ).eval()
    x = torch.randn(BATCH, 3, 224, 224, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).bfloat16()
    captured = []
    hooks = [m.qkv.register_forward_hook(
        lambda mod, inp, out, m=m: captured.append((m, out)))
        for m in model.modules() if isinstance(m, WindowAttention)]
    with torch.no_grad():
        model(x)
        for h in hooks:
            h.remove()
        calls = []
        for m, qkv in captured:
            bias = m.pos_emb_funct()
            route = attention.attention_route(
                qkv.shape[1], qkv.shape[2] // 3 // m.num_heads)
            if qkv.dtype == torch.bfloat16 and route == "K3":
                bias = bias.to(torch.bfloat16)
            calls.append((route, qkv, bias, m.num_heads, m.scale))
    wrappers = {"K1": cuda_attention.window_mhsa_cuda,
                "K3": cuda_attention.window_mhsa_long_cuda}
    forms = {
        "wrapper": lambda r, *a: wrappers[r](*a),
        "op": lambda r, *a: library.FORWARD_OPS[r](*a),
        "window_mhsa": lambda r, *a: attention.window_mhsa(*a),
    }

    def run(form):
        return [forms[form](*c) for c in calls]

    def turn(form):
        with torch.no_grad():
            for _ in range(WARMUP):
                run(form)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            t0 = time.perf_counter()
            start.record()
            for _ in range(args.iters):
                run(form)
            end.record()
            host = time.perf_counter() - t0
            end.synchronize()
        n = args.iters * len(calls)
        return host / n * 1e6, start.elapsed_time(end) / n * 1e3

    with torch.no_grad():
        want = run("wrapper")
        for form in forms:
            got = run(form)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{form}'s outputs differ from the wrapper's")
    names = list(forms)
    host = {n: [] for n in names}
    device = {n: [] for n in names}
    for _ in range(args.rounds):
        for n in names + names[::-1]:
            h, d = turn(n)
            host[n].append(h)
            device[n].append(d)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"batch": BATCH, "calls": len(calls),
           "routes": sorted({c[0] for c in calls}),
           "shapes": sorted({tuple(c[1].shape) for c in calls}),
           "iters": args.iters, "rounds": args.rounds, "card": smi,
           "host_us_a_call": host, "device_us_a_call": device,
           "median_host_us_a_call": {n: statistics.median(v)
                                     for n, v in host.items()},
           "median_device_us_a_call": {n: statistics.median(v)
                                       for n, v in device.items()}}
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
