"""Tracking: run a detector's boxes through the runtime tracker and write
them as a MOT file (the port's copy of examples/track.py).

    python -m fastervit_tpu_torch.examples.track [--output DIR]

Numpy only: nothing of it runs on a device.
"""
import argparse
import os
import tempfile

import numpy as np

from fastervit_tpu_torch.tracking.mot_data import write_mot_file
from fastervit_tpu_torch.tracking.tracker import RuntimeTracker, track_sequence


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output", default=None,
                   help="directory for track_results.txt (default: a new "
                        "temporary directory)")
    args = p.parse_args(argv)
    out_dir = args.output or tempfile.mkdtemp(prefix="fvt_track_")
    os.makedirs(out_dir, exist_ok=True)

    # per-frame detections (e.g. from the DINO detector's postprocess)
    frames = [{"boxes": np.array([[10. + 3 * t, 10, 50 + 3 * t, 90]]),
               "scores": np.array([0.9]), "labels": np.array([0])}
              for t in range(10)]
    results = track_sequence(frames, RuntimeTracker(score_thresh=0.7))
    path = os.path.join(out_dir, "track_results.txt")
    write_mot_file(path, results)
    print("frames tracked:", len(results), "ids:", results[-1]["ids"])
    print("written:", path)
    return {"path": path, "frames": len(results),
            "ids": results[-1]["ids"].tolist()}


if __name__ == "__main__":
    main()
