"""attn_roofline.train: the summed least time of the traced steps'
window-attention calls, forward and backward (each call's bytes or
operations at the card's peak, from its shapes: h100bench/counts), over
the summed device time of the kernels that computed them, matched by name
below (K1-K4, with the backward's dbias partial sums)."""
from h100bench.counts.roofline import backward_bound_s, forward_bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "train_img_per_s"
KERNELS = ("window_mhsa_kernel", "window_mhsa_tc_kernel",
           "window_mhsa_long_kernel", "window_mhsa_long_tc_kernel",
           "window_mhsa_bwd", "dbias_sum_kernel", "long_bwd_")


def read(record):
    trace = record.trace
    if record.kind != "train" or trace is None:
        return None
    spent = sum(t for name, t in trace.op_seconds().items()
                if any(k in name for k in KERNELS))
    if not spent:
        return None
    least = forward_bound_s(record.attention_forward) \
        + backward_bound_s(record.attention_backward)
    return 100.0 * trace.batches * least / spent
