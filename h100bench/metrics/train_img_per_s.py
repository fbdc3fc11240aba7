"""train_img_per_s: images of the train steps whose loss reached the host
within the window, over the time from the window's start to the last of
them (`Record.completed_rate`)."""
LAYER = "loop (host)"
UNIT = "img/s"
MOVES = None


def read(record):
    if record.kind != "train":
        return None
    return record.completed_rate()
