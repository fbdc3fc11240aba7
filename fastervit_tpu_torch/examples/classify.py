"""Classification: build, serve, export for deploy, load and serve again
(the port's copy of examples/classify.py).

    python -m fastervit_tpu_torch.examples.classify [--device cpu] \\
        [--batch 8] [--checkpoint fastervit_0_224_1k.pth.tar]

fv0 in bf16 runs one eager forward, then `export_for_deploy` bakes the
position biases and exports the forward at the batch (torch.export; on the
card the window attention is the hand-written kernels' `fastervit::`
operators). The program is saved, loaded back as a serving process would
(`utils.export.load_program`) and serves a batch.
"""
import argparse
import os
import tempfile

import torch

import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.utils.export import load_program, save_program


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda', 'cpu')")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--checkpoint", default="",
                   help="reference .pth.tar (random init if omitted)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu")

    model = fvt.create_model("faster_vit_0_224", dtype=torch.bfloat16,
                             device=device,
                             checkpoint_path=args.checkpoint).eval()
    x = torch.zeros(args.batch, 3, 224, 224, dtype=torch.bfloat16,
                    device=device)
    with torch.no_grad():
        logits = model(x)
    print("logits:", tuple(logits.shape))

    # deploy: biases baked, the forward exported at this batch
    deploy = fvt.export_for_deploy(model, args.batch, torch.bfloat16)
    with torch.no_grad():
        print("deploy:", tuple(deploy(x).shape))

    # serving across processes: save the program, load it where it serves
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fv0.pt2")
        with torch.no_grad():
            save_program(torch.export.export(deploy, (x,)), path)
        served = load_program(path).module()
        with torch.no_grad():
            out = served(x)
    print("served:", tuple(out.shape))
    return {"logits": tuple(logits.shape), "served": tuple(out.shape),
            "equal": bool(torch.equal(out, logits))}


if __name__ == "__main__":
    main()
