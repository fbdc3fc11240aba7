"""The port's window / carrier-token layout ops equal fastervit_tpu's
exactly (they only move data)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu.ops import windows as jw
from fastervit_tpu_torch.ops import windows as tw


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _same(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w", [(14, 14), (14, 21)])
def test_window_partition(h, w):
    x = _rand(2, h, w, 5)
    _same(tw.window_partition(torch.from_numpy(x), 7),
          jw.window_partition(jnp.asarray(x), 7))


def test_window_reverse():
    x = _rand(2 * 6, 49, 5)
    _same(tw.window_reverse(torch.from_numpy(x), 7, 14, 21),
          jw.window_reverse(jnp.asarray(x), 7, 14, 21))


@pytest.mark.parametrize("op", ["ct_dewindow", "ct_window"])
def test_carrier_reorders(op):
    x = _rand(3, 4 * 6, 5)  # a 4x6 carrier grid, ct_size 2
    _same(getattr(tw, op)(torch.from_numpy(x), 4, 6, 2),
          getattr(jw, op)(jnp.asarray(x), 4, 6, 2))


def test_nearest_upsample_tokens():
    x = _rand(6, 4, 5)
    _same(tw.nearest_upsample_tokens(torch.from_numpy(x), 2, 7),
          jw.nearest_upsample_tokens(jnp.asarray(x), 2, 7))
