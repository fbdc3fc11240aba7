"""setup_s: process start to the first timed batch or step (imports, the
kernel library's load or build, the model and its weights, the input pool,
the warm-up), by the host clock."""
LAYER = "loop (host)"
UNIT = "s"
MOVES = None


def read(record):
    return record.setup_s
