"""Random data with the right shapes, for smoke runs and benchmarks: a copy
of fastervit_tpu/data/imagenet.py::SyntheticLoader (the same numpy draws,
NHWC images), which the port cannot import without jax."""
from __future__ import annotations

import numpy as np

from fastervit_tpu_torch.models.config import DataConfig


class SyntheticLoader:
    """`num_batches` batches of N(0, 1) NHWC images and uniform labels from
    numpy's RandomState(seed), the same on every pass."""

    def __init__(self, cfg: DataConfig, batch_size: int, num_batches: int = 16,
                 num_classes: int = 1000, seed: int = 0):
        self.cfg, self.batch_size = cfg, batch_size
        self.num_batches, self.num_classes = num_batches, num_classes
        self.seed = seed

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        h, w = self.cfg.input_size
        for _ in range(self.num_batches):
            yield {
                "image": rng.randn(self.batch_size, h, w,
                                   3).astype(np.float32),
                "label": rng.randint(0, self.num_classes,
                                     self.batch_size).astype(np.int32),
                "valid": np.ones((self.batch_size,), bool),
            }
