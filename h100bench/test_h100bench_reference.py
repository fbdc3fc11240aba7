"""The plain reference against the port on the CPU at small sizes, float32,
on the seed's weights: FasterViT-0's layout with carrier tokens, the
21k family's single large windows with layer scale, and the options the
cells do not set (propagation, a LayerNorm last, layer scale in the conv
blocks). The port's CPU path is its plain attention, so the two differ
only in the order of sums."""
import ast
from pathlib import Path

import pytest
import torch

import fastervit_tpu_torch as fvt
from h100bench import program, weights
from h100bench.conftest import TINY_CONFIG
from h100bench.reference import fastervit as reference

TOL = 1e-5   # of the largest logit: float32, only the order of sums differs

K21_SMALL = dict(TINY_CONFIG, registry_name="faster_vit_4_21k_768",
                 window_size=[7, 7, 8, 4], resolution=128,
                 hat=[False] * 4)
OPTIONS = dict(TINY_CONFIG, layer_scale_conv=1e-5, layer_norm_last=True,
               do_propagation=True)


def port(cfg, seed, dtype=torch.float32, baked=False):
    return program.build(cfg, seed, torch.device("cpu"), dtype, baked)


@pytest.mark.parametrize("cfg", [TINY_CONFIG, K21_SMALL, OPTIONS],
                         ids=["carriers", "large_windows", "options"])
@pytest.mark.parametrize("baked", [False, True])
def test_reference_matches_the_port(cfg, baked, cpu_threads):
    params = weights.reference_weights(reference.parameter_layout(cfg), 5,
                                       "cpu", torch.float32)
    x = weights.input_pool(5, 1, (2, 3, cfg["resolution"],
                                  cfg["resolution"]), "cpu", torch.float32)[0]
    with torch.no_grad():
        got = port(cfg, 5, baked=baked)(x)
        want = reference.forward(params, x, cfg)
    assert (got - want).abs().max() <= TOL * want.abs().max()


def test_layout_is_the_ports_state_dict(cpu_threads):
    model = fvt.create_model("faster_vit_0_224", device="meta",
                             **{k: TINY_CONFIG[k] for k in program.ARCH_KEYS})
    state = {k: tuple(v.shape) for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")
             and ".to_global_feature.pos." not in k}
    assert dict(reference.parameter_layout(TINY_CONFIG)) == state


def test_served_weights_reach_the_reference_unchanged(cpu_threads):
    layout = reference.parameter_layout(TINY_CONFIG)
    served = weights.make_weights(layout, 9, "cpu", torch.bfloat16)
    ref = weights.reference_weights(layout, 9, "cpu", torch.bfloat16)
    model = port(TINY_CONFIG, 9, torch.bfloat16)
    state = model.state_dict()
    for name, value in served.items():
        assert torch.equal(state[name], value), name
        assert torch.equal(ref[name], value.float()), name


def test_weights_follow_the_seed():
    layout = reference.parameter_layout(TINY_CONFIG)
    a = weights.make_weights(layout, 2 ** 31 + 3, "cpu", torch.float32)
    b = weights.make_weights(layout, 2 ** 31 + 3, "cpu", torch.float32)
    c = weights.make_weights(layout, 2 ** 31 + 4, "cpu", torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.weight"], c["head.weight"])
    assert bool((a["levels.0.blocks.0.norm1.running_var"] >= 1).all())


def test_reference_imports_nothing_of_the_program():
    banned = ("fastervit_tpu_torch", "fastervit_tpu", "jax", "jaxlib",
              "flax", "h100bench")
    for path in (Path(reference.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, (path.name, m)
