"""enqueue_ms.train: the host's time in the train step call and the loss's
copy issue, with no synchronisation (the benchmark's `h100bench.enqueue`
span), as a mean over the window's steps."""
LAYER = "loop (host)"
UNIT = "ms"
MOVES = "train_img_per_s"


def read(record):
    if record.kind != "train" or not record.batches:
        return None
    return 1e3 * sum(b.enqueued - b.issue for b in record.batches) \
        / len(record.batches)
