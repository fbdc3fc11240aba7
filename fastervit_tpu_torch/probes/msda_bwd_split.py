"""K7, the MSDA backward, split by its dvalue adds at the bf16 encoder call
of a DINO-4scale b2 800x1333 train step (N 2, Q = S = 22,223, M 8, D 32,
L 4, P 4), in the port found under --root: the kernel as the tree builds
it, with all its dvalue adds, with none, and with the adds of one level
only, each in both location modes of `msda_turns.py` (uniform, coherent),
timed in turns:

    python fastervit_tpu_torch/probes/msda_bwd_split.py --root _trees/parent \\
        --out out/k7_split_parent.json

It copies the tree's csrc/msda_bwd.cu into a temporary directory, cuts its
dvalue adds there to a mask of levels (a compile-time ADD_MASK, inserted
where a corner's add is skipped), and builds the copy once a mask with
nvcc, beside the tree's own build of the file; the tree's sources stay as
they are. It knows the add site of the first K7 (PR 17) and of its
redesign (PR 18), and refuses a file with neither. Each build is called
through the tree's own plan (`cuda_msda.msda_bwd_plan`) on one set of
inputs, the f32 dvalue buffer zeroed once (kernel times only, CUDA events,
20 calls after 3, the builds in order and then in reverse, twice); every
build's dloc and dweights are compared bit for bit with the tree's own,
and the split is marked faithful where the copy with every add takes
within 5% of the tree's build (the cut's branch can change the copy's
registers: on PR 18's kernel it did, by 25%). It prints one JSON object, with the card's name and power limit, and
writes it to --out if given. It needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ITERS, WARMUP, TURNS = 20, 3, 2
# (label, levels whose dvalue adds run)
MASKS = (("all adds", 15), ("no adds", 0), ("level 0 only", 1),
         ("level 1 only", 2), ("level 2 only", 4), ("level 3 only", 8))
# the add sites: (the line that skips a corner's add, the sample's level
# there)
SITES = (("        if (o[c] < 0) continue;", "(first + i) / points"),
         ("              if (!on[u] || !adds[u] || tok[u] < 0) continue;",
          "s / points"))


def masked_source(src: str) -> str:
    """The kernel source with ADD_MASK (default all levels) cutting the
    dvalue adds of the levels it leaves out."""
    for line, level in SITES:
        if src.count(line) == 1:
            cut = line.replace(") continue;",
                               f" || !((ADD_MASK >> ({level})) & 1)) "
                               "continue;")
            return ("#ifndef ADD_MASK\n#define ADD_MASK 15\n#endif\n"
                    + src.replace(line, cut))
    raise SystemExit("msda_bwd.cu has no dvalue add site this probe knows")


def build(root: Path, work: Path) -> dict:
    """{label: ctypes library} of the masked builds."""
    from torch.utils.cpp_extension import CUDA_HOME
    csrc = root / "fastervit_tpu_torch" / "csrc"
    src = work / "msda_bwd.cu"
    src.write_text(masked_source((csrc / "msda_bwd.cu").read_text()))
    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    procs = {}
    for label, mask in MASKS:
        so = work / f"k7_mask{mask}.so"
        procs[label] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", f"-DADD_MASK={mask}",
             "-I", str(csrc), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {label}:\n{log}")
        libs[label] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose msda_bwd.cu is split")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if not torch.cuda.is_available():
        sys.exit("msda_bwd_split needs a CUDA device")
    from fastervit_tpu_torch.ops import cuda_attention, cuda_msda
    from fastervit_tpu_torch.probes import msda_turns
    if not Path(cuda_msda.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {cuda_msda.__file__}, not from {root}")
    kernel = cuda_msda.ms_deform_attn_backward_cuda
    # the tree's own entry point and plan, the first K7's (no host shapes)
    # or the redesign's
    redesign = hasattr(cuda_msda, "_host_shapes")
    shapes, n, m, d, p = (msda_turns.LEVELS, msda_turns.N, msda_turns.M,
                          msda_turns.D, msda_turns.P)
    s = q = sum(h * w for h, w in shapes)
    with tempfile.TemporaryDirectory() as tmp:
        own = cuda_attention._library()
        libs = {"kernel (the tree's build)": own, **build(root, Path(tmp))}
        for lib in libs.values():
            lib.msda_backward.argtypes = own.msda_backward.argtypes
            lib.msda_backward.restype = ctypes.c_int
        gen = torch.Generator(device="cuda").manual_seed(0)
        levels = cuda_msda._level_table(shapes, torch.device("cuda"))
        out = {"root": str(root), "iters": ITERS, "turns": TURNS,
               "call": {"N": n, "Q": q, "M": m, "D": d, "P": p,
                        "levels": shapes, "dtype": "bf16"}, "ms": {},
               "same_dloc_dweights": {}}
        for mode in msda_turns.MODES:
            value, loc, w = msda_turns.inputs(q, mode, gen)
            g = torch.randn(n, q, m * d, device="cuda", generator=gen)
            v16, w16, g16 = value.bfloat16(), w.bfloat16(), g.bfloat16()
            want = kernel(v16, shapes, loc, w16, g16)
            plan = kernel.last_plan
            dv = torch.zeros(value.shape, dtype=torch.float32, device="cuda")
            dl = torch.zeros(loc.shape, dtype=torch.float32, device="cuda")
            dw = torch.zeros_like(w16)
            extra = ([cuda_msda._host_shapes(shapes)] if redesign else [])

            def call(lib):
                err = lib.msda_backward(
                    v16.data_ptr(), levels.data_ptr(), loc.data_ptr(),
                    w16.data_ptr(), g16.data_ptr(), dv.data_ptr(),
                    dl.data_ptr(), dw.data_ptr(), n, q, s, m, d, len(shapes),
                    p, 1, *extra, plan.as_c(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"msda_backward returned {err}")

            same = {}
            for label, lib in libs.items():
                call(lib)
                torch.cuda.synchronize()
                same[label] = bool(torch.equal(dl, want[1])
                                   and torch.equal(dw, want[2]))
            times = {label: [] for label in libs}
            order = list(libs)
            for turn in range(2 * TURNS):
                for label in order if turn % 2 == 0 else order[::-1]:
                    for _ in range(WARMUP):
                        call(libs[label])
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in "se")
                    start.record()
                    for _ in range(ITERS):
                        call(libs[label])
                    end.record()
                    torch.cuda.synchronize()
                    times[label].append(start.elapsed_time(end) / ITERS)
            ms = out["ms"][mode] = {label: sum(t) / len(t)
                                    for label, t in times.items()}
            # the split speaks for the kernel only where the masked copy
            # with every add runs as fast as the tree's build (the cut's
            # branch can change the copy's registers)
            own_ms = ms["kernel (the tree's build)"]
            out.setdefault("faithful", {})[mode] = (
                abs(ms["all adds"] - own_ms) <= 0.05 * own_ms)
            out["same_dloc_dweights"][mode] = same
            out["plan"] = plan._asdict()
            del value, loc, w, g, v16, w16, g16, want, dv, dl, dw
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
