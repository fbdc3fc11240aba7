"""mfu.serve: model operations of an image (h100bench/counts/fastervit.py,
from the configuration's shapes) at the window's rate of completed images
(`Record.completed_rate`), as a share of the card's dense bf16 peak (989
TFLOP/s, h100bench/counts/roofline.py)."""
from h100bench.counts.roofline import BF16_FLOP_PER_S

LAYER = "model"
UNIT = "%"
MOVES = "serve_img_per_s"


def read(record):
    if record.kind != "serve" or not record.batches:
        return None
    rate = record.completed_rate()
    if rate is None:
        return None
    return 100.0 * record.flops_per_image * rate / BF16_FLOP_PER_S
