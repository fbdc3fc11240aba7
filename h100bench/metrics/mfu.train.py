"""mfu.train: model operations of the images whose steps completed in the
window, the forward and backward counted as 3x the forward with the
position-bias MLPs live (h100bench/counts/fastervit.py; recomputation not
counted), at the window's rate (`Record.completed_rate`), as a share of
the card's dense bf16 peak (989 TFLOP/s)."""
from h100bench.counts.roofline import BF16_FLOP_PER_S

LAYER = "model"
UNIT = "%"
MOVES = "train_img_per_s"


def read(record):
    if record.kind != "train" or not record.batches:
        return None
    rate = record.completed_rate()
    if rate is None:
        return None
    return 100.0 * record.flops_per_image * rate / BF16_FLOP_PER_S
