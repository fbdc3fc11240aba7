"""Model export for deployment (port of fastervit_tpu/utils/export.py).

* `export_program`: `torch.export` of the classifier's forward, the
  counterpart of JAX's StableHLO export (`export_stablehlo`) and of its
  compiled executable (`export_executable`). The window attention is
  recorded as the operators `fastervit::window_mhsa_short` (K1) and
  `fastervit::window_mhsa_long` (K3) of `ops.library`, so the program
  launches the hand-written kernels when it runs on the card, in any
  process that has imported `ops.library` (`load_program` does). The
  batch axis is symbolic unless a batch size is given.
* `export_onnx`: an ONNX graph through torch's TorchScript exporter, with a
  dynamic batch axis and constant folding, traced from the port's own
  model (JAX's version loads its weights into the upstream pip package's
  model). The ONNX graph is a CPU artifact of the plain version: under the
  tracer the attention is the plain PyTorch function, recorded op by op,
  and no kernel of the card is in it. `utils/onnx_eval.py::run_onnx` runs
  it with numpy.

JAX's TF SavedModel and pickled-executable formats have no counterpart:
`torch.export` takes their place.

    python -m fastervit_tpu_torch.utils.export --model faster_vit_0_224 \\
        --format program --out fv0.pt2 [--batch N] [--dtype bfloat16] \\
        [--int8] [--checkpoint fv0.pth.tar] [--device cpu]
    python -m fastervit_tpu_torch.utils.export --model faster_vit_0_224 \\
        --format onnx --out fv0.onnx
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn


def _check_exportable(model: nn.Module) -> None:
    from fastervit_tpu_torch.models import layers
    if layers._FUSED_HAT:
        raise NotImplementedError(
            "export with set_fused_hat(True): K6, the fused HAT block, is "
            "called directly and is not an operator; see ROADMAP.md queue 1, "
            "'Export'")
    if not hasattr(getattr(model, "cfg", None), "resolution"):
        raise TypeError("export takes a FasterViT classifier (create_model)")


def example_input(model: nn.Module, batch: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Zeros of the model's input shape (batch, C, H, W) on its device."""
    h, w = model.cfg.resolution
    device = next(model.parameters()).device
    return torch.zeros(batch, model.cfg.in_chans, h, w, dtype=dtype,
                       device=device)


def export_program(model: nn.Module, batch_size: Optional[int] = None,
                   dtype: torch.dtype = torch.float32
                   ) -> torch.export.ExportedProgram:
    """`torch.export.export` of `model`'s forward in eval mode, without
    gradients, on (batch, C, H, W) inputs of `dtype` on the model's device.

    batch_size None gives a symbolic batch, `torch.export.Dim("batch")` on
    axis 0 (JAX `export_stablehlo`'s symbolic batch): the widest range that
    exports, every batch from 0 up (the trace sees batch 2, and no guard of
    the float model's forward depends on the batch). An int fixes it; the
    int8 model (`create_model(quantized=True)`) exports at a fixed batch,
    since `quant.int_mm` pads its rows up to 17 and so branches on the
    batch. Raises NotImplementedError with the fused HAT block on."""
    _check_exportable(model)
    model.eval()
    x = example_input(model, batch_size or 2, dtype)
    dynamic = (None if batch_size
               else {"x": {0: torch.export.Dim("batch")}})
    with torch.no_grad():
        return torch.export.export(model, (x,), dynamic_shapes=dynamic)


def save_program(program: torch.export.ExportedProgram, path: str) -> str:
    """Write an exported program (weights included) to `path`
    (`torch.export.save`). Returns the path."""
    torch.export.save(program, path)
    return path


def load_program(path: str) -> torch.export.ExportedProgram:
    """Load a program written by `save_program`. Imports `ops.library`
    first, so that the `fastervit::` operators it calls are registered in
    this process; call `.module()` on the result for a callable."""
    from fastervit_tpu_torch.ops import library  # noqa: F401 (registers)
    return torch.export.load(path)


@contextlib.contextmanager
def _onnx_package_guard():
    """Without the `onnx` package, patch out the one step of torch's
    TorchScript exporter that imports it (`_add_onnxscript_fn`, a no-op
    unless custom onnxscript functions are registered), as JAX's
    export_onnx does (fastervit_tpu/utils/export.py:178-195)."""
    try:
        import onnx  # noqa: F401
        yield
        return
    except ImportError:
        pass
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda proto, custom_opsets: proto
    try:
        yield
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


def export_onnx(model: nn.Module, path: str,
                batch_size: Optional[int] = None, opset: int = 17,
                optimize: bool = True) -> str:
    """Write an ONNX graph of `model`'s forward (JAX export_onnx,
    fastervit_tpu/utils/export.py:134-207), traced from the port's own
    model: a float32 copy on the CPU in eval mode, so the attention is the
    plain version (`ops.attention.window_mhsa` under the TorchScript tracer)
    and the graph is a CPU artifact of it, not a path of the card. NCHW
    float32 input "input", logits "output", a dynamic batch axis unless
    `batch_size` is given; `optimize` folds constants at export (check it
    with `utils.onnx_inspect.check_constant_folded`). Works without the
    `onnx` package. Returns the path."""
    import copy

    _check_exportable(model)
    if any(p.dtype == torch.int8 for p in model.state_dict().values()):
        raise ValueError("the int8 model exports through export_program; "
                         "the ONNX graph is the float forward")
    cpu = copy.deepcopy(model).to(device="cpu", dtype=torch.float32).eval()
    x = example_input(cpu, batch_size or 1)
    dynamic = None if batch_size else {"input": {0: "batch"},
                                       "output": {0: "batch"}}
    with torch.no_grad(), _onnx_package_guard():
        torch.onnx.export(cpu, (x,), path, input_names=["input"],
                          output_names=["output"], dynamic_axes=dynamic,
                          opset_version=opset, dynamo=False,
                          do_constant_folding=optimize)
    return path


def main(argv=None) -> None:
    """CLI: export a model to a deploy artifact.

        python -m fastervit_tpu_torch.utils.export --model faster_vit_0_224 \\
            [--checkpoint fv0.pth.tar] --format program --out fv0.pt2
        # formats: program (torch.export; dynamic batch unless --batch; the
        #          hand-written kernels as fastervit:: operators),
        #          onnx (the plain forward, a CPU artifact; float only)
    """
    import argparse

    from fastervit_tpu_torch.models.registry import create_model

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--checkpoint", default="",
                   help="reference .pth.tar (random init if omitted)")
    p.add_argument("--format", required=True, choices=["program", "onnx"])
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=0,
                   help="0 = dynamic batch")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--int8", action="store_true",
                   help="int8 serving forward (program only)")
    p.add_argument("--device", default="cuda",
                   help="where the program's weights and inputs live "
                        "(the card unless 'cpu')")
    args = p.parse_args(argv)

    if args.int8 and args.format == "onnx":
        raise SystemExit("onnx export runs the TorchScript tracer on the "
                         "float forward; the int8 serving path exports with "
                         "--format program")
    if args.int8 and not args.batch:
        raise SystemExit("--int8 exports at a fixed --batch")
    dtype = getattr(torch, args.dtype)
    device = "cpu" if args.format == "onnx" else args.device
    model = create_model(args.model, dtype=dtype, device=device,
                         checkpoint_path=args.checkpoint,
                         quantized=args.int8).eval()
    batch = args.batch or None
    if args.format == "program":
        save_program(export_program(model, batch, dtype), args.out)
    else:
        export_onnx(model, args.out, batch_size=batch)
    print(f"exported {args.model} [{args.format}"
          f"{', int8' if args.int8 else ''}] -> {args.out}")


if __name__ == "__main__":
    main()
