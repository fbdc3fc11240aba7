"""attn_roofline.serve: the summed least time of the traced batches'
window-attention forward calls (each call's bytes or operations at the
card's peak, from its shapes: h100bench/counts), over the summed device
time of the kernels that computed them, matched by name below (K1 and K3,
the port's forward attention kernels)."""
from h100bench.counts.roofline import forward_bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "serve_img_per_s"
KERNELS = ("window_mhsa_kernel", "window_mhsa_tc_kernel",
           "window_mhsa_long_kernel", "window_mhsa_long_tc_kernel")


def read(record):
    trace = record.trace
    if record.kind != "serve" or trace is None:
        return None
    spent = sum(t for name, t in trace.op_seconds().items()
                if any(k in name for k in KERNELS))
    if not spent:
        return None
    return 100.0 * trace.batches * forward_bound_s(record.attention_forward) \
        / spent
