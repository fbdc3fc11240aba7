"""Helpers for the tests that hold fastervit_tpu_torch against fastervit_tpu
on the CPU: random variables made with numpy from a seed, and their
conversion into the port's state_dict."""
from typing import Mapping, Optional

import numpy as np
import pytest
import torch

from fastervit_tpu_torch.utils.convert import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads while a module that imports this runs (the tests
    run in several processes at once); the previous count afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def random_variables(tree: Mapping, seed: int) -> dict:
    """A flax variable tree (arrays or ShapeDtypeStructs) with every leaf
    replaced by numpy random values of its shape, scaled by its role:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), BN running means
    N(0, 0.1²) and variances U(0.5, 1.5), biases N(0, 0.1²), layer-scale
    gammas 0.5 + N(0, 0.1²). Moved BN statistics and non-trivial gammas
    make a swap of any two of them show."""
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.randn(*shape) / np.sqrt(fan_in)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.randn(*shape)
        if name.startswith("gamma"):
            return 0.5 + 0.1 * rng.randn(*shape)
        return 0.1 * rng.randn(*shape)  # bias, mean

    def walk(t):
        return {k: walk(v) if isinstance(v, Mapping)
                else leaf(k, tuple(v.shape)).astype(np.float32)
                for k, v in t.items()}

    return walk(tree)


def port_state_dict(variables: Mapping, module: Optional[str] = None) -> dict:
    """The port's state_dict for JAX variables. `module` names the flax
    module the variables belong to (e.g. "blocks_0", "attn",
    "patch_embed"), for a layer tested alone: its torch name is stripped
    from the keys."""
    if module is None:
        return state_dict_from_jax(variables)
    nested = {col: {module: tree} for col, tree in variables.items()}
    head = module.replace("blocks_", "blocks.") + "."
    return {k[len(head):]: v for k, v in state_dict_from_jax(nested).items()}


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)
