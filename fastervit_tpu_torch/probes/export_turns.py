"""The faster_vit_0_224 bf16 b256 forward timed on the card, eager and, in
a tree that has `utils/export.py`, as the exported program, in the port
found under --root: for comparing two trees of the port (a parent unpacked
by `git archive`, and the change) on one card, each in its own process, in
turns:

    for t in parent change change parent; do d=.; [ $t = parent ] && \\
        d=_trees/parent; python fastervit_tpu_torch/probes/export_turns.py \\
        --root $d --out chiprun_out/export_turns_$t.json; done

It is run by path, so that it imports `fastervit_tpu_torch` from --root
(whose kernels it builds there). The model's weights and the input come
from seeded generators, the same in every tree. Each form is timed with
CUDA events over --iters forwards after 5, the forms in order and then in
reverse (eager, program, program, eager), --rounds times, and each form's
SHA-256 of its logits is kept: the two trees and the two forms must
agree. It prints one
JSON object, with the card's name and power limit, and writes it to --out
if given. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

BATCH = 256
WARMUP = 5


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=".")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import fastervit_tpu_torch as fvt
    if not torch.cuda.is_available():
        raise SystemExit("export_turns needs a CUDA device")
    model = fvt.create_model("faster_vit_0_224", dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0)
                             ).eval()
    x = torch.randn(BATCH, 3, 224, 224, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).bfloat16()
    forms = {"eager": model}
    try:
        from fastervit_tpu_torch.utils.export import export_program
    except ImportError:
        export_program = None
    if export_program is not None:
        forms["program"] = export_program(model, None,
                                          torch.bfloat16).module()

    def time_ms(fn) -> float:
        with torch.no_grad():
            for _ in range(WARMUP):
                fn(x)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            for _ in range(args.iters):
                fn(x)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / args.iters

    names = list(forms)
    runs = {n: [] for n in names}
    for _ in range(args.rounds):
        for n in names + names[::-1]:
            runs[n].append(time_ms(forms[n]))
    with torch.no_grad():
        sha = {n: hashlib.sha256(forms[n](x).float().cpu().numpy()
                                 .tobytes()).hexdigest() for n in names}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"root": args.root, "batch": BATCH, "iters": args.iters,
           "rounds": args.rounds,
           "card": smi, "ms": runs,
           "mean_ms": {n: sum(v) / len(v) for n, v in runs.items()},
           "sha256": sha}
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
