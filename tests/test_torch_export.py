"""The port's export (fastervit_tpu_torch/utils/export.py, ops/library.py,
models/registry.py::export_for_deploy, utils/convert.py's CLI, the
classify example) on the CPU, on a narrow FasterViT-0 (depths 1, 1, 1, 1,
dim 32, 10 classes) with random weights made with numpy and bridged from
the JAX package's variables:

- `export_program` with a symbolic batch, saved and loaded (a process
  without the port's operators cannot load it): at batches the trace did
  not see, its logits equal the eager model's bit for bit (the
  same operators in the same order), the window attention recorded as the
  `fastervit::` operators (K1's; K3's at a window past K1's limit), which
  run their plain versions on the CPU; the loaded program's fp32 logits
  within 1e-5 of the JAX model's on the same weights (the sums in another
  order);
- the int8 model's program equal to its eager forward, bit for bit;
- `export_onnx`, then `utils/onnx_eval.py::run_onnx` at a batch the trace
  did not see, within 1e-4 of the port's logits (numpy's sums against
  torch's); the graph constant-folded and free of Mod nodes;
- the operators' fake implementations against their real ones (shapes and
  dtypes, `torch.library.opcheck`);
- the convert CLI on a state_dict written here; the classify example in a
  subprocess, which loads no jax.

The counterpart of tests/test_onnx_eval.py, which needs the upstream
package."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fastervit_tpu import create_model as jax_create_model
from fastervit_tpu_torch import create_model, export_for_deploy
from fastervit_tpu_torch.models import layers
from fastervit_tpu_torch.ops import attention, library
from fastervit_tpu_torch.utils import export
from torch_parity import (few_torch_threads, nchw,  # noqa: F401
                          port_state_dict, random_variables)

REPO = Path(__file__).resolve().parent.parent
KW = dict(depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8], dim=32, in_dim=16,
          num_classes=10)
JAX_TOL = 1e-5
ONNX_TOL = 1e-4


def _x(b, seed=7, hw=(224, 224)):
    return np.random.RandomState(seed).randn(b, *hw, 3).astype(np.float32)


def _ops(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and "fastervit" in str(n.target)]


@pytest.fixture(scope="module")
def bridged():
    """The JAX model's jitted forward on random variables, and the port's
    model on the same weights, in eval mode."""
    jm = jax_create_model("faster_vit_0_224", **KW)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    variables = random_variables(shapes, seed=21)
    tm = create_model("faster_vit_0_224", device="cpu", **KW)
    tm.load_state_dict(port_state_dict(variables), strict=True)
    forward = jax.jit(jm.module.apply)
    return (lambda x: np.asarray(forward(variables, x))), tm.eval()


@pytest.fixture(scope="module")
def saved(bridged, tmp_path_factory):
    """The port's program, exported with a symbolic batch and saved."""
    _, tm = bridged
    path = str(tmp_path_factory.mktemp("program") / "fv0.pt2")
    return export.save_program(export.export_program(tm), path)


@pytest.fixture(scope="module")
def loaded(saved):
    return export.load_program(saved)


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_program_at_unseen_batch_equals_eager_bit_for_bit(bridged, loaded,
                                                          batch):
    _, tm = bridged
    x = nchw(_x(batch, seed=batch))
    with torch.no_grad():
        assert torch.equal(loaded.module()(x), tm(x))


def test_a_process_without_the_operators_cannot_load_a_program(saved):
    """torch.export.load alone, in a process that has not imported the
    port's operators, raises rather than run anything else."""
    code = f"import torch; torch.export.load({saved!r})"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "fastervit" in out.stderr


def test_program_records_the_kernels_as_operators(loaded):
    # level 2's carrier and joint attention, level 3's window attention
    assert _ops(loaded) == ["fastervit.window_mhsa_short.default"] * 3


def test_program_matches_jax_fp32(bridged, loaded):
    jax_forward, _ = bridged
    x = _x(4, seed=11)
    with torch.no_grad():
        got = loaded.module()(nchw(x)).numpy()
    np.testing.assert_allclose(got, jax_forward(x), atol=JAX_TOL,
                               rtol=JAX_TOL)


def test_long_window_program_runs_k3s_operator(tmp_path):
    """A 12x12 window at level 2 (S = 148 with its carriers) takes K3's
    route; exported, saved and loaded, it equals eager."""
    tm = create_model("faster_vit_0_224", device="cpu",
                      window_size=[7, 7, 12, 7], **KW).eval()
    path = str(tmp_path / "long.pt2")
    export.save_program(export.export_program(tm), path)
    program = export.load_program(path)
    assert "fastervit.window_mhsa_long.default" in _ops(program)
    x = nchw(_x(2, seed=3))
    with torch.no_grad():
        assert torch.equal(program.module()(x), tm(x))


def test_int8_program_equals_eager_int8(tmp_path):
    qm = create_model("faster_vit_0_224", device="cpu", quantized=True,
                      **KW).eval()
    path = str(tmp_path / "int8.pt2")
    export.save_program(export.export_program(qm, batch_size=2), path)
    x = nchw(_x(2, seed=5))
    with torch.no_grad():
        assert torch.equal(export.load_program(path).module()(x), qm(x))


def test_deploy_module_is_the_baked_forward(bridged):
    _, tm = bridged
    import copy
    deploy = export_for_deploy(copy.deepcopy(tm), 2)
    x = nchw(_x(2, seed=9))
    with torch.no_grad():
        assert torch.equal(deploy(x), tm(x))


def test_export_with_the_fused_block_raises(bridged):
    _, tm = bridged
    prev = layers.set_fused_hat(True)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            export.export_program(tm)
    finally:
        layers.set_fused_hat(prev)


@pytest.mark.cuda
def test_tracing_on_the_card_raises():
    """The TorchScript tracer (the ONNX export) records the plain version
    only on the CPU; on the card window attention refuses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 53, 3 * 64, device="cuda", generator=g)
    bias = torch.randn(2, 53, 53, device="cuda", generator=g)
    with pytest.raises(NotImplementedError, match="CPU artifact"):
        torch.jit.trace(lambda q, b: attention.window_mhsa(q, b, 2, 0.125),
                        (qkv, bias))


@pytest.mark.parametrize("op,seq", [(library.window_mhsa_short, 53),
                                    (library.window_mhsa_long, 148)],
                         ids=["short", "long"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fake_implementations_match_the_real_ones(op, seq, dtype):
    g = torch.Generator().manual_seed(seq)
    qkv = torch.randn(3, seq, 3 * 64, generator=g).to(dtype)
    bias = torch.randn(2, seq, seq, generator=g).to(dtype)
    torch.library.opcheck(op, (qkv, bias, 2, 0.125),
                          test_utils=("test_schema", "test_faketensor"))
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = op(mode.from_tensor(qkv), mode.from_tensor(bias), 2, 0.125)
    real = op(qkv, bias, 2, 0.125)
    assert (fake.shape, fake.dtype) == (real.shape, real.dtype) == \
        ((3, seq, 64), dtype)


@pytest.fixture(scope="module")
def onnx_graph(bridged, tmp_path_factory):
    _, tm = bridged
    path = str(tmp_path_factory.mktemp("onnx") / "fv0.onnx")
    return export.export_onnx(tm, path)


def test_onnx_graph_at_unseen_batch_matches_the_port(bridged, onnx_graph):
    from fastervit_tpu_torch.utils.onnx_eval import run_onnx
    _, tm = bridged
    x = nchw(_x(3, seed=13))
    out = run_onnx(onnx_graph, {"input": x.numpy()})
    assert set(out) == {"output"} and out["output"].shape == (3, 10)
    with torch.no_grad():
        want = tm(x).numpy()
    np.testing.assert_allclose(out["output"], want, atol=ONNX_TOL,
                               rtol=ONNX_TOL)


def test_onnx_graph_is_folded_and_has_no_mod(onnx_graph):
    from fastervit_tpu_torch.utils.onnx_inspect import (check_constant_folded,
                                                        inspect_onnx)
    info = inspect_onnx(onnx_graph)
    assert info["inputs"] == ["input"] and info["outputs"] == ["output"]
    assert info["opsets"].get("") == 17 and info["op_types"]["Conv"] >= 4
    assert "Mod" not in info["op_types"]
    assert not any(t.startswith("fastervit") for t in info["op_types"])
    check_constant_folded(onnx_graph,
                          max_constant_nodes=info["op_types"]["Constant"])


def test_export_cli_refuses_int8_onnx(tmp_path):
    with pytest.raises(SystemExit, match="program"):
        export.main(["--model", "faster_vit_0_224", "--format", "onnx",
                     "--int8", "--out", str(tmp_path / "x.onnx")])


def test_convert_cli_round_trips_a_reference_checkpoint(tmp_path):
    from fastervit_tpu_torch.utils import convert
    from fastervit_tpu_torch.utils.checkpoint import restore_variables
    src = create_model("faster_vit_0_224", device="cpu",
                       generator=torch.Generator().manual_seed(4))
    sd = {"module." + k: v for k, v in src.state_dict().items()}
    # a constant table the reference's checkpoints carry and the model
    # rebuilds
    sd["module.levels.2.blocks.0.attn.pos_emb_funct.relative_coords_table"] \
        = torch.zeros(1)
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "ref.pth.tar")
    convert.main(["--model", "faster_vit_0_224", "--checkpoint",
                  str(tmp_path / "ref.pth.tar"), "--out",
                  str(tmp_path / "fv0.pt")])
    dst = restore_variables(str(tmp_path / "fv0.pt"),
                            create_model("faster_vit_0_224", device="cpu"))
    want = src.state_dict()
    for k, v in dst.state_dict().items():
        assert torch.equal(v, want[k]), k
    sd["module.extra.weight"] = torch.zeros(1)
    torch.save({"state_dict": sd}, tmp_path / "bad.pth.tar")
    with pytest.raises(RuntimeError, match="extra.weight"):
        convert.main(["--model", "faster_vit_0_224", "--checkpoint",
                      str(tmp_path / "bad.pth.tar"), "--out",
                      str(tmp_path / "bad.pt")])


CLASSIFY = """
import sys, torch
torch.set_num_threads(2)
from fastervit_tpu_torch.examples import classify
res = classify.main(["--device", "cpu", "--batch", "1"])
assert res["served"] == (1, 1000) and res["equal"], res
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "fastervit_tpu"))
print("LOADED", bad)
"""


def test_classify_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", CLASSIFY], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout
