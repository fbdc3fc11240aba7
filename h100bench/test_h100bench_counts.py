"""The operation and byte counters of h100bench/counts against hand counts
at small shapes, and against the bounds that PERF.md's kernel table gives
at the main paths' shapes (K1 0.291 ms, K3 3.436 ms, K4 1.165 ms)."""
import pytest

from h100bench.counts import fastervit as F
from h100bench.counts import roofline as R

SMALL = {"depths": [1, 1, 1, 1], "num_heads": [1, 1, 2, 2],
         "window_size": [7, 7, 4, 2], "ct_size": 2, "dim": 8, "in_dim": 4,
         "mlp_ratio": 4.0, "resolution": 64, "in_chans": 3,
         "num_classes": 10, "hat": [False, False, False, False]}
FV0 = {"depths": [2, 3, 6, 5], "num_heads": [2, 4, 8, 16],
       "window_size": [7, 7, 7, 7], "ct_size": 2, "dim": 64, "in_dim": 64,
       "mlp_ratio": 4.0, "resolution": 224, "in_chans": 3,
       "num_classes": 1000, "hat": [False, False, True, False]}
K21 = {"depths": [3, 3, 12, 5], "num_heads": [4, 8, 16, 32],
       "window_size": [7, 7, 48, 24], "ct_size": 2, "dim": 196,
       "in_dim": 64, "mlp_ratio": 4.0, "resolution": 768, "in_chans": 3,
       "num_classes": 1000, "hat": [False] * 4}
K21_384 = dict(K21, window_size=[7, 7, 24, 12], resolution=384)


def test_forward_flops_by_hand():
    # stem 64 -> 32 -> 16; levels at 16, 8, 4 (one 4x4 window), 2 (2x2)
    stem = 2 * 9 * 3 * 4 * 32 ** 2 + 2 * 9 * 4 * 8 * 16 ** 2
    conv0 = 2 * (2 * 9 * 8 * 8 * 16 * 16) + 2 * 9 * 8 * 16 * 8 * 8
    conv1 = 2 * (2 * 9 * 16 * 16 * 8 * 8) + 2 * 9 * 16 * 32 * 4 * 4
    # tokens T, dim C, window S: 2T(4C²) + 4S²C + 2T(2C·4C)
    hat2 = (2 * 16 * 4 * 32 ** 2 + 4 * 16 ** 2 * 32
            + 2 * 16 * 2 * 32 * 128) + 2 * 9 * 32 * 64 * 2 * 2
    hat3 = 2 * 4 * 4 * 64 ** 2 + 4 * 4 ** 2 * 64 + 2 * 4 * 2 * 64 * 256
    head = 2 * 64 * 10
    want = stem + conv0 + conv1 + hat2 + hat3 + head
    assert want == 2815232
    assert F.forward_flops(SMALL) == want


def test_live_bias_adds_the_position_mlps():
    # per block: the absolute embedding over S tokens (2 -> 512 -> C) and
    # the CPB table over (2ws - 1)² offsets (2 -> 512 -> heads)
    extra = (2 * 16 * (2 * 512 + 512 * 32) + 2 * 49 * (2 * 512 + 512 * 2)
             + 2 * 4 * (2 * 512 + 512 * 64) + 2 * 9 * (2 * 512 + 512 * 2))
    assert F.forward_flops(SMALL, live_bias=True) \
        - F.forward_flops(SMALL) == extra


def test_attention_calls():
    assert F.attention_calls(SMALL, 2) == [(2, 16, 2, 16, 1),
                                           (2, 4, 2, 32, 1)]
    # FasterViT-0 at b256: the carriers' attention (a 4x4 grid), the joint
    # window + 4 carriers (4 windows an image), level 3
    assert F.attention_calls(FV0, 256) == [(256, 16, 8, 32, 6),
                                           (1024, 53, 8, 32, 6),
                                           (256, 49, 16, 32, 5)]
    assert F.attention_calls(K21, 16) == [(16, 2304, 16, 49, 12),
                                          (16, 576, 32, 49, 5)]


def test_attention_bytes_and_operations_by_hand():
    # 2 windows of 4 tokens, 1 head of 8: qkv 2*4*24, out 2*4*8, bias 16,
    # bf16; q kᵀ and p v 2*1*16*8 multiply-adds each
    assert R.attention_forward(2, 4, 1, 8) == (544, 1024.0)
    # backward: qkv read and written, g read, bias read and dbias written
    assert R.attention_backward(2, 4, 1, 8) == (2 * (384 + 64 + 32),
                                                2560.0)
    assert R.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert R.bound_s(0, 989e12) == pytest.approx(1.0)


@pytest.mark.parametrize("what, calls, bound_ms", [
    ("K1, fv0 b256 forward", F.attention_calls(FV0, 256), 0.291),
    ("K3, 21k-768 b16 forward", F.attention_calls(K21, 16), 3.436),
])
def test_forward_bounds_match_the_kernel_table(what, calls, bound_ms):
    assert round(1e3 * R.forward_bound_s(calls), 3) == bound_ms, what


def test_backward_bound_matches_the_kernel_table():
    # K4 over a 21k-384 b32 step
    calls = F.attention_calls(K21_384, 32)
    assert round(1e3 * R.backward_bound_s(calls), 3) == 1.165


def test_model_operations_near_the_published_counts():
    # FasterViT-0: 3.3 G multiply-adds (the README's "GFLOPs")
    assert F.forward_flops(FV0) / 2e9 == pytest.approx(3.3, rel=0.03)
