"""Training input pipeline, a copy of fastervit_tpu/data/train_loader.py:
random-resized-crop + hflip + RandAugment + normalize + RandomErasing
(reference timm create_loader recipe,
train.py:624-669: RRC scale (0.08, 1.0), hflip 0.5, rand-m9-mstd0.5-inc1,
reprob 0.25 'pixel'). Mixup/CutMix runs in the train step
(train/mixup.py). With `use_lmdb` the images are read from the LMDB
database beside the root (data/lmdb_dataset.py)."""
from __future__ import annotations

import concurrent.futures as cf
import math
import random
from typing import Optional

import numpy as np
from PIL import Image

from fastervit_tpu_torch.data.imagenet import index_image_folder
from fastervit_tpu_torch.data.preprocess import load_image, normalize
from fastervit_tpu_torch.data.randaugment import create_randaugment
from fastervit_tpu_torch.models.config import DataConfig


def rrc_box(w: int, h: int, rng: random.Random, scale=(0.08, 1.0),
            ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop box selection -> (x0, y0, x1, y1)."""
    area = w * h
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(log_r)
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw)
            y = rng.randint(0, h - ch)
            return (x, y, x + cw, y + ch)
    # fallback: center crop
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x, y = (w - cw) // 2, (h - ch) // 2
    return (x, y, x + cw, y + ch)


def random_resized_crop(img: Image.Image, size, rng: random.Random,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop semantics (bicubic)."""
    w, h = img.size
    return img.resize(size[::-1], Image.BICUBIC,
                      box=rrc_box(w, h, rng, scale, ratio))


def random_erasing(x: np.ndarray, rng: random.Random, prob=0.25,
                   area_range=(0.02, 1 / 3), aspect_range=(0.3, 10 / 3),
                   count=1):
    """timm RandomErasing mode='pixel' on the normalized HWC tensor."""
    if rng.random() > prob:
        return x
    h, w, c = x.shape
    for _ in range(count):
        for _ in range(10):
            target = rng.uniform(*area_range) * h * w
            ar = math.exp(rng.uniform(math.log(aspect_range[0]),
                                      math.log(aspect_range[1])))
            eh = int(round(math.sqrt(target * ar)))
            ew = int(round(math.sqrt(target / ar)))
            if eh < h and ew < w:
                top = rng.randint(0, h - eh)
                left = rng.randint(0, w - ew)
                x[top:top + eh, left:left + ew] = np.random.RandomState(
                    rng.randint(0, 2 ** 31)).randn(eh, ew, c).astype(x.dtype)
                break
    return x


class TrainLoader:
    """Shuffled, host-sharded, multi-threaded training loader. Call
    set_epoch(e) for a deterministic reshuffle (reference
    sampler.set_epoch, train.py:741-742)."""

    def __init__(self, root: str, cfg: DataConfig, batch_size: int,
                 aa: Optional[str] = "rand-m9-mstd0.5-inc1",
                 hflip: float = 0.5, reprob: float = 0.25,
                 num_workers: int = 16, seed: int = 42,
                 process_index: int = 0, process_count: int = 1,
                 use_lmdb: bool = False, use_native: str = "auto"):
        if use_lmdb:
            # LMDB-backed ImageNet (reference utils/datasets.py:458-498)
            from fastervit_tpu_torch.data.lmdb_dataset import (
                LmdbImageReader, load_lmdb_index)
            paths, labels, self.classes = load_lmdb_index(root)
            self.reader = LmdbImageReader(root)
        else:
            paths, labels, self.classes = index_image_folder(root)
            self.reader = None
        self.paths = paths[process_index::process_count]
        self.labels = np.asarray(labels[process_index::process_count], np.int32)
        self.cfg = cfg
        self.batch_size = batch_size
        self.aa_spec = aa
        self.hflip = hflip
        self.reprob = reprob
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = 0
        if use_native == "auto":
            from fastervit_tpu_torch.data import native
            self.use_native = native.available()
        else:
            self.use_native = bool(use_native)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.paths) // self.batch_size

    def _read_bytes(self, path: str) -> bytes:
        if self.reader is not None:
            return self.reader.read_bytes(path)
        with open(path, "rb") as f:
            return f.read()

    def _finish_one(self, u8_img: np.ndarray, rng: random.Random) -> np.ndarray:
        """Post-RRC augmentation shared by both paths: RandAugment, normalize,
        RandomErasing — consuming `rng` in the same order as _load_one."""
        img = Image.fromarray(u8_img)
        if self.aa_spec:
            img = create_randaugment(self.aa_spec, seed=rng.randint(0, 2 ** 31))(img)
        x = normalize(np.asarray(img), self.cfg.mean, self.cfg.std)
        if self.reprob > 0:
            x = random_erasing(x, rng, prob=self.reprob)
        return x

    def _load_one(self, path: str, seed: int) -> np.ndarray:
        rng = random.Random(seed)
        img = load_image(self.reader.read(path) if self.reader else path)
        img = random_resized_crop(img, self.cfg.input_size, rng)
        if rng.random() < self.hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return self._finish_one(np.asarray(img), rng)

    def _native_batch(self, paths, seeds) -> list:
        """Batched native path: decode + RRC + hflip in C++ (identical rng
        draw order as _load_one, so both paths produce identical batches,
        as tests/test_torch_data.py checks); RandAugment/erasing follow
        in Python. Per-image fallback to the PIL path on decode failure."""
        from fastervit_tpu_torch.data import native
        bufs = [self._read_bytes(p) for p in paths]
        rngs = [random.Random(s) for s in seeds]
        n = len(bufs)
        boxes = np.zeros((n, 4), np.float64)
        flips = np.zeros((n,), np.uint8)
        bad = []
        for i, (buf, rng) in enumerate(zip(bufs, rngs)):
            dims = native.jpeg_dims(buf)
            if dims is None:
                bad.append(i)
                continue
            w, h = dims
            boxes[i] = rrc_box(w, h, rng)
            flips[i] = rng.random() < self.hflip
        u8, ok = native.rrc_batch(bufs, self.cfg.input_size, boxes, flips,
                                  num_threads=self.num_workers)
        out = []
        for i in range(n):
            if i in bad or not ok[i]:
                out.append(self._load_one(paths[i], seeds[i]))
            else:
                out.append(self._finish_one(u8[i], rngs[i]))
        return out

    def __iter__(self):
        order = np.random.RandomState(self.seed + self.epoch).permutation(
            len(self.paths))
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                idx = order[start:start + self.batch_size]
                seeds = [self.seed * 1_000_003 + self.epoch * 97 + int(i)
                         for i in idx]
                batch_paths = [self.paths[i] for i in idx]
                if self.use_native:
                    imgs = self._native_batch(batch_paths, seeds)
                else:
                    imgs = list(pool.map(self._load_one, batch_paths, seeds))
                yield {"image": np.stack(imgs),
                       "label": self.labels[idx],
                       "valid": np.ones((self.batch_size,), bool)}
