"""device_idle.serve: the share of the traced window in which no operation
ran on the card (the union of the profiler's device intervals)."""
LAYER = "device"
UNIT = "%"
MOVES = "serve_img_per_s"


def read(record):
    trace = record.trace
    if record.kind != "serve" or trace is None or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
