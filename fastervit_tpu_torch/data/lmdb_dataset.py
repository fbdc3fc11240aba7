"""LMDB-backed ImageNet storage, a copy of fastervit_tpu/data/
lmdb_dataset.py (reference fastervit/utils/datasets.py:458-498
`imagenet_lmdb_dataset` / `lmdb_loader`).

The layout is the JAX package's, so a database that either package builds
is read by the other: `<root>_faster_imagefolder.lmdb` maps ascii image
paths to their raw encoded bytes, and a plain JSON index
`<root>_faster_imagefolder.lmdb.json` ({"samples": [[path, label], ...],
"classes": [...]}) lies beside it. Where only the reference's pickled
torchvision ImageFolder `<root>_faster_imagefolder.lmdb.pt` exists, the
index is read from that.

The `lmdb` package is imported on first use, and its absence raises an
ImportError that names it. `LmdbImageReader.read_bytes(path)` returns an
image's encoded bytes (the native decoder's input) and `read(path)` the
decoded RGB PIL image: the loaders' stand-ins for opening the file.
"""
from __future__ import annotations

import io
import json
import os
from typing import List, Tuple


def _require_lmdb():
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "the lmdb package is required for LMDB datasets "
            "(pip install lmdb); ImageFolder loading works without it"
        ) from e
    return lmdb


def lmdb_paths(root: str) -> Tuple[str, str, str]:
    """(database, JSON index, the reference's .pt index) beside `root`."""
    root = root.rstrip("/")
    return (root + "_faster_imagefolder.lmdb",
            root + "_faster_imagefolder.lmdb.json",
            root + "_faster_imagefolder.lmdb.pt")


def build_imagenet_lmdb(root: str, map_size: int = int(1e12)) -> str:
    """Index an ImageFolder tree and pack every image's raw bytes into LMDB
    (reference datasets.py:479-489), the JSON index beside it. Returns the
    database's path."""
    from fastervit_tpu_torch.data.imagenet import index_image_folder

    lmdb = _require_lmdb()
    lmdb_path, json_path, _ = lmdb_paths(root)
    paths, labels, classes = index_image_folder(root)
    env = lmdb.open(lmdb_path, map_size=map_size)
    with env.begin(write=True) as txn:
        for p in paths:
            with open(p, "rb") as f:
                txn.put(p.encode("ascii"), f.read())
    env.close()
    with open(json_path, "w") as f:
        json.dump({"samples": list(zip(paths, labels)),
                   "classes": classes}, f)
    return lmdb_path


def load_lmdb_index(root: str) -> Tuple[List[str], List[int], List[str]]:
    """(paths, labels, classes) from the JSON index, or from the
    reference's pickled ImageFolder (.pt) where only that exists."""
    _, json_path, pt_path = lmdb_paths(root)
    if os.path.isfile(json_path):
        with open(json_path) as f:
            idx = json.load(f)
        paths = [p for p, _ in idx["samples"]]
        labels = [int(label) for _, label in idx["samples"]]
        return paths, labels, idx.get("classes", [])
    if os.path.isfile(pt_path):
        import torch

        ds = torch.load(pt_path, map_location="cpu", weights_only=False)
        paths = [p for p, _ in ds.imgs]
        labels = [int(label) for _, label in ds.imgs]
        return paths, labels, list(getattr(ds, "classes", []))
    raise FileNotFoundError(f"no LMDB index next to {root!r} "
                            f"(looked for {json_path} and {pt_path})")


class LmdbImageReader:
    """The database beside `root`, opened once, read-only (reference
    lmdb_loader, datasets.py:458-463)."""

    def __init__(self, root: str):
        lmdb = _require_lmdb()
        lmdb_path, _, _ = lmdb_paths(root)
        if not os.path.isdir(lmdb_path):
            raise FileNotFoundError(lmdb_path)
        self.env = lmdb.open(lmdb_path, readonly=True, max_readers=1,
                             lock=False, readahead=False, meminit=False)

    def read_bytes(self, path: str) -> bytes:
        """The encoded bytes stored under `path`; KeyError where none are."""
        with self.env.begin(write=False, buffers=True) as txn:
            data = txn.get(path.encode("ascii"))
        if data is None:
            raise KeyError(path)
        return bytes(data)

    def read(self, path: str):
        """The image stored under `path`, decoded to RGB by PIL."""
        from PIL import Image

        return Image.open(io.BytesIO(self.read_bytes(path))).convert("RGB")

    def close(self):
        self.env.close()
