"""serve_batch_p95_ms: the 95th percentile, over every batch issued in the
window, of the host time from the forward call to the logits on the host
(statistics.quantiles, 100 parts, the exclusive method)."""
import statistics

LAYER = "loop (host)"
UNIT = "ms"
MOVES = None


def read(record):
    if record.kind != "serve" or len(record.batches) < 2:
        return None
    times = [b.done - b.issue for b in record.batches]
    return 1e3 * statistics.quantiles(times, n=100)[94]
