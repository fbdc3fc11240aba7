"""enqueue_ms.serve: the host's time in the forward call and the logits'
copy issue, with no synchronisation (the benchmark's `h100bench.enqueue`
span), as a mean over the window's batches."""
LAYER = "loop (host)"
UNIT = "ms"
MOVES = "serve_img_per_s"


def read(record):
    if record.kind != "serve" or not record.batches:
        return None
    return 1e3 * sum(b.enqueued - b.issue for b in record.batches) \
        / len(record.batches)
