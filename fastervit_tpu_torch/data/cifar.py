"""CIFAR-10/100 loaders, a copy of fastervit_tpu/data/cifar.py (reference
utils/datasets.py:11-129 get_loaders and :405-419 my_random_split,
rebuilt): reads the standard python-pickle batch
files from a local directory (no download in this environment), provides
eval / search(train-val split) modes and the seeded deterministic split."""
from __future__ import annotations

import os
import pickle
from typing import Iterator, List, Optional, Tuple

import numpy as np

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_cifar(root: str, dataset: str = "cifar10", train: bool = True
               ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (images uint8 NHWC, labels int32). Accepts the extracted
    cifar-10-batches-py / cifar-100-python directory layouts."""
    if dataset == "cifar10":
        d = os.path.join(root, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train \
            else ["test_batch"]
        label_key = "labels"
    elif dataset == "cifar100":
        d = os.path.join(root, "cifar-100-python")
        files = ["train"] if train else ["test"]
        label_key = "fine_labels"
    else:
        raise ValueError(dataset)
    xs, ys = [], []
    for fname in files:
        batch = _load_pickle(os.path.join(d, fname))
        xs.append(np.asarray(batch["data"], np.uint8))
        ys.append(np.asarray(batch[label_key], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.concatenate(ys)


def my_random_split(n: int, lengths: List[int], seed: int = 0
                    ) -> List[np.ndarray]:
    """Seeded deterministic split of range(n) (reference
    datasets.py:405-419)."""
    assert sum(lengths) <= n
    perm = np.random.RandomState(seed).permutation(n)
    out, start = [], 0
    for ln in lengths:
        out.append(np.sort(perm[start:start + ln]))
        start += ln
    return out


class CifarLoader:
    """Batched loader with normalize (+ optional train-time crop/flip)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, train: bool = False, mean=CIFAR10_MEAN,
                 std=CIFAR10_STD, seed: int = 0):
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.train = train
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.images) // self.batch_size if self.train else \
            (len(self.images) + self.batch_size - 1) // self.batch_size

    def _augment(self, x: np.ndarray, rng: np.random.RandomState):
        # pad-4 random crop + hflip (the standard CIFAR recipe)
        out = np.empty_like(x)
        padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
        for i in range(len(x)):
            dy, dx = rng.randint(0, 9, 2)
            img = padded[i, dy:dy + 32, dx:dx + 32]
            if rng.rand() < 0.5:
                img = img[:, ::-1]
            out[i] = img
        return out

    def __iter__(self) -> Iterator[dict]:
        n = len(self.images)
        rng = np.random.RandomState(self.seed + self.epoch)
        order = rng.permutation(n) if self.train else np.arange(n)
        step = self.batch_size
        for start in range(0, n - (step - 1 if self.train else 0), step):
            idx = order[start:start + step]
            x = self.images[idx]
            if self.train:
                x = self._augment(x, rng)
            xf = (x.astype(np.float32) / 255.0 - self.mean) / self.std
            labels = np.zeros((step,), np.int32)
            labels[:len(idx)] = self.labels[idx]
            valid = np.zeros((step,), bool)
            valid[:len(idx)] = True
            batch = np.zeros((step, 32, 32, 3), np.float32)
            batch[:len(idx)] = xf
            yield {"image": batch, "label": labels, "valid": valid}


def get_loaders(root: str, dataset: str = "cifar10", batch_size: int = 128,
                mode: str = "eval", search_split: int = 45000, seed: int = 0):
    """Reference get_loaders semantics: 'eval' -> (train_loader over the full
    train set, test_loader); 'search' -> (train, val) from a deterministic
    split of the train set."""
    mean, std = (CIFAR10_MEAN, CIFAR10_STD) if dataset == "cifar10" else \
        (CIFAR100_MEAN, CIFAR100_STD)
    xtr, ytr = load_cifar(root, dataset, train=True)
    if mode == "eval":
        xte, yte = load_cifar(root, dataset, train=False)
        return (CifarLoader(xtr, ytr, batch_size, train=True, mean=mean,
                            std=std, seed=seed),
                CifarLoader(xte, yte, batch_size, mean=mean, std=std))
    if mode == "search":
        tr_idx, val_idx = my_random_split(
            len(xtr), [search_split, len(xtr) - search_split], seed=seed)
        return (CifarLoader(xtr[tr_idx], ytr[tr_idx], batch_size, train=True,
                            mean=mean, std=std, seed=seed),
                CifarLoader(xtr[val_idx], ytr[val_idx], batch_size,
                            mean=mean, std=std))
    raise ValueError(mode)
