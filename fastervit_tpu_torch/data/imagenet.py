"""ImageNet-style input pipeline: a copy of fastervit_tpu/data/imagenet.py
(reference utils/datasets.py + timm create_loader).

An ImageFolder directory tree (class-per-subdir) is indexed once and may be
split across processes (`process_index`, `process_count`). Decode and
resize run in a thread pool, or in the native (C++) runtime where it built;
batches come out as numpy NHWC float32, which the caller moves to its
device. `SyntheticLoader` (data/synthetic.py) covers runs without data.
LMDB datasets are not ported: the `lmdb` package is on neither of the
port's machines.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from fastervit_tpu_torch.data.preprocess import eval_transform
from fastervit_tpu_torch.data.synthetic import SyntheticLoader
from fastervit_tpu_torch.models.config import DataConfig

__all__ = ["IMG_EXTENSIONS", "EvalLoader", "SyntheticLoader",
           "index_image_folder", "refuse_lmdb"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def refuse_lmdb(use_lmdb: bool) -> None:
    if use_lmdb:
        raise NotImplementedError(
            "LMDB datasets are not ported: the lmdb package is on neither "
            "machine (ROADMAP.md, 'Out of reach')")


def index_image_folder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """Walk a class-per-subdir tree -> (paths, labels, class_names)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(cdir, fname))
                labels.append(idx)
    return paths, labels, classes


class EvalLoader:
    """Deterministic eval loader over an image folder; the last partial
    batch is padded with zeros and masked through 'valid'.

    `class_to_idx` remaps folder class names to label ids, for
    ImageNet-A/R/V2 style subsets whose folders map into the 1k label
    space (reference README robustness table, README.md:286-367). `tta` 2
    yields each image and its horizontal flip, one after the other."""

    def __init__(self, root: str, cfg: DataConfig, batch_size: int,
                 num_workers: int = 16, process_index: int = 0,
                 process_count: int = 1, class_to_idx: Optional[dict] = None,
                 tta: int = 0, use_lmdb: bool = False,
                 use_native: str = "auto"):
        refuse_lmdb(use_lmdb)
        paths, labels, self.classes = index_image_folder(root)
        if class_to_idx is not None:
            remap = np.asarray([class_to_idx[c] for c in self.classes])
            labels = remap[np.asarray(labels)]
        self.paths = paths[process_index::process_count]
        self.labels = np.asarray(labels[process_index::process_count], np.int32)
        self.cfg = cfg
        self.batch_size = batch_size
        self.num_workers = num_workers
        if tta not in (0, 1, 2):
            raise ValueError("tta oversampling supports factor 2 (orig+hflip)")
        self.tta = tta
        if use_native == "auto":
            from fastervit_tpu_torch.data import native
            self.use_native = native.available()
        else:
            self.use_native = bool(use_native)

    def __len__(self):
        """The number of batches: with tta 2 each holds batch_size // 2
        images (the JAX loader counts batch_size, so its len is half the
        batches it yields)."""
        per_batch = self.batch_size // (self.tta if self.tta > 1 else 1)
        return (len(self.paths) + per_batch - 1) // per_batch

    def _native_chunk(self, chunk) -> list:
        """Decode+resize+crop+normalize a chunk through the native (C++)
        batch runtime; per-image fallback to the PIL path for images the
        native decoder declines (non-JPEG, CMYK)."""
        from fastervit_tpu_torch.data import native
        bufs = []
        for p in chunk:
            with open(p, "rb") as f:
                bufs.append(f.read())
        h, w = self.cfg.input_size
        out, ok = native.eval_batch(
            bufs, (h, w), self.cfg.crop_pct, self.cfg.crop_mode == "squash",
            self.cfg.mean, self.cfg.std, num_threads=self.num_workers)
        imgs = list(out)
        for i in np.nonzero(~ok)[0]:
            imgs[i] = eval_transform(chunk[i], self.cfg)
        return imgs

    def __iter__(self) -> Iterator[dict]:
        h, w = self.cfg.input_size
        factor = self.tta if self.tta > 1 else 1
        per_batch = self.batch_size // factor
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(self.paths), per_batch):
                chunk = self.paths[start:start + per_batch]
                if self.use_native:
                    imgs = self._native_chunk(chunk)
                else:
                    imgs = list(pool.map(
                        lambda p: eval_transform(p, self.cfg), chunk))
                if factor == 2:
                    imgs = [im for x in imgs for im in (x, x[:, ::-1])]
                n = len(imgs)
                batch = np.zeros((self.batch_size, h, w, 3), np.float32)
                batch[:n] = np.stack(imgs)
                labels = np.zeros((self.batch_size,), np.int32)
                labels[:n] = np.repeat(self.labels[start:start + len(chunk)],
                                       factor)
                valid = np.zeros((self.batch_size,), bool)
                valid[:n] = True
                yield {"image": batch, "label": labels, "valid": valid}
