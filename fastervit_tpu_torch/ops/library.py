"""The forward window-attention kernels as PyTorch operators, so that
torch.export records them as calls that a saved program makes again when it
is loaded, not as the Python that launches them:

    fastervit::window_mhsa_short(Tensor qkv, Tensor bias, int num_heads,
                                 float scale) -> Tensor        K1
    fastervit::window_mhsa_long(Tensor qkv, Tensor bias, int num_heads,
                                float scale) -> Tensor         K3

Each has three implementations: CUDA, the hand-written kernel's wrapper
(`cuda_attention.window_mhsa_cuda` / `window_mhsa_long_cuda`, looked up at
each call, so their launch counts and `last_plan` are kept as before, and
their refusals raise); CPU, the kernel's plain version
(`attention.window_mhsa_reference` / `window_mhsa_long_reference`); and a
fake one for tracing, (B, S, C) in qkv's dtype. A tensor on the card never
reaches the CPU implementation.

They are registered with the dispatcher's own `torch.library.Library`
(`define` / `impl` / `register_fake`) rather than the
`torch.library.custom_op` decorator, which adds Python work to every call
of an eager forward. Importing this module registers them, once a process:
`ops.attention` imports it, and `utils.export.load_program` does before it
loads a program. A process that loads a program without them raises.
"""
from __future__ import annotations

import torch

from fastervit_tpu_torch.ops import attention, cuda_attention

NAMESPACE = "fastervit"
_SCHEMA = "(Tensor qkv, Tensor bias, int num_heads, float scale) -> Tensor"

_lib = torch.library.Library(NAMESPACE, "DEF")


def _short_cuda(qkv, bias, num_heads, scale):
    return cuda_attention.window_mhsa_cuda(qkv, bias, num_heads, scale)


def _long_cuda(qkv, bias, num_heads, scale):
    return cuda_attention.window_mhsa_long_cuda(qkv, bias, num_heads, scale)


def _short_cpu(qkv, bias, num_heads, scale):
    with torch.autocast("cpu", enabled=False):
        return attention.window_mhsa_reference(qkv, bias, num_heads, scale)


def _long_cpu(qkv, bias, num_heads, scale):
    with torch.autocast("cpu", enabled=False):
        return attention.window_mhsa_long_reference(qkv, bias, num_heads,
                                                    scale)


def _fake(qkv, bias, num_heads, scale):
    b, s, c3 = qkv.shape
    return qkv.new_empty((b, s, c3 // 3))


for _name, _cuda, _cpu in (("window_mhsa_short", _short_cuda, _short_cpu),
                           ("window_mhsa_long", _long_cuda, _long_cpu)):
    _lib.define(_name + _SCHEMA)
    _lib.impl(_name, _cuda, "CUDA")
    _lib.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_lib)

window_mhsa_short = torch.ops.fastervit.window_mhsa_short
window_mhsa_long = torch.ops.fastervit.window_mhsa_long

# the op of each forward route of `attention.attention_route`
FORWARD_OPS = {"K1": window_mhsa_short, "K3": window_mhsa_long}
