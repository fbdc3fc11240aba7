"""serve_img_per_s: images whose logits reached the host within the
window, over the time from the window's start to the last of them
(`Record.completed_rate`)."""
LAYER = "loop (host)"
UNIT = "img/s"
MOVES = None


def read(record):
    if record.kind != "serve":
        return None
    return record.completed_rate()
