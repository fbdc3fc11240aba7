"""'Real labels' ImageNet evaluation (Beyer et al. 2020), a copy of
fastervit_tpu/data/real_labels.py: timm RealLabelsImagenet semantics
(used by reference validate.py:264-267,316-317): a prediction is correct
if it is in the set of reassessed labels for the image; images with empty
label sets are skipped."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence


class RealLabels:
    def __init__(self, filenames: Sequence[str], real_json: str,
                 topk: Sequence[int] = (1, 5)):
        with open(real_json) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            self._labels: Dict[str, List[int]] = raw
        else:
            # the published real.json is a list indexed by val image number
            self._labels = {f"ILSVRC2012_val_{i + 1:08d}.JPEG": v
                            for i, v in enumerate(raw)}
        self.filenames = [os.path.basename(f) for f in filenames]
        self.topk = tuple(topk)
        self._correct = {k: 0 for k in self.topk}
        self._count = 0
        self._pos = 0

    def add_result(self, topk_indices) -> None:
        """topk_indices: (B, max(topk)) predicted class ids, batch-ordered to
        match the filenames sequence."""
        import numpy as np
        topk_indices = np.asarray(topk_indices)
        for row in topk_indices:
            fname = self.filenames[self._pos]
            self._pos += 1
            real = self._labels.get(fname)
            if not real:
                continue
            self._count += 1
            for k in self.topk:
                if any(int(c) in real for c in row[:k]):
                    self._correct[k] += 1

    def get_accuracy(self, k: int = 1) -> float:
        return 100.0 * self._correct[k] / max(1, self._count)
