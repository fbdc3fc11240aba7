"""Weights and inputs made from the seed, the same for the program and the
reference.

Every tensor of `reference.fastervit.parameter_layout` is cut from one
standard normal draw of a torch.Generator on the run's device: weight
matrices and kernels clamped to ±2 and scaled by fan_in^-1/2 (LeCun
normal, which keeps activations near unit scale through the depth), norm
scales 1 + 0.1·z, biases and BatchNorm means 0.1·z, BatchNorm variances
1 + 0.1·|z|, layer-scale gammas 0.5 + 0.1·z (the configured 1e-5 is an
initial value; a trained model's gammas are of order one, and at 1e-5 the
attention branches would not reach the logits). The values are rounded to
the served dtype once, and the reference gets that rounding in float32, so
both sides hold the same numbers.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Layout = Sequence[Tuple[str, tuple]]


def _rule(name: str, shape: tuple, z: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        return z.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(math.prod(shape[1:])))
    if leaf == "running_var":
        return z.abs_().mul_(0.1).add_(1.0)
    if leaf.startswith("gamma"):
        return z.mul_(0.1).add_(0.5)
    if leaf == "weight":
        return z.mul_(0.1).add_(1.0)
    return z.mul_(0.1)   # biases, running means


def make_weights(layout: Layout, seed: int, device,
                 dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor in `dtype`} for every entry of `layout`, from one
    normal draw seeded with `seed` on `device`."""
    sizes = [math.prod(shape) for _, shape in layout]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(layout, torch.split(z, sizes)):
        out[name] = _rule(name, shape, part.view(shape)).to(dtype)
    return out


def reference_weights(layout: Layout, seed: int, device,
                      served: torch.dtype) -> Dict[str, torch.Tensor]:
    """The served weights, in float32."""
    return {k: v.float() for k, v in
            make_weights(layout, seed, device, served).items()}


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]
              ) -> None:
    """Copy `weights` into the program's model by state_dict name; raise
    if a name or shape differs or if a parameter or float buffer of the
    state_dict is left without a value."""
    state = model.state_dict()
    filled = set()
    with torch.no_grad():
        for name, value in weights.items():
            if name not in state:
                raise KeyError(f"the program's model has no {name!r}")
            t = state[name]
            if tuple(t.shape) != tuple(value.shape):
                raise ValueError(f"{name}: the program holds {tuple(t.shape)}"
                                 f", the layout {tuple(value.shape)}")
            t.copy_(value)
            filled.add(t.data_ptr())
    left = [n for n, t in state.items()
            if t.is_floating_point() and t.data_ptr() not in filled]
    if left:
        raise ValueError(f"no value for the program's {left[:5]}")


def input_pool(seed: int, count: int, shape: Sequence[int], device,
               dtype: torch.dtype) -> torch.Tensor:
    """`count` distinct input batches of `shape`, standard normal (the
    scale of normalised images), drawn in float32 from a generator of its
    own and rounded to `dtype`."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return torch.randn((count, *shape), generator=gen,
                       device=device).to(dtype)
