"""Helpers for the tests that hold fastervit_tpu_torch against fastervit_tpu
on the CPU: random variables made with numpy from a seed, and their
conversion into the port's state_dict."""
import json
import os
import sys
import types
from typing import Mapping, Optional

import numpy as np
import pytest
import torch

from fastervit_tpu_torch.utils.convert import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads while a module that imports this runs (the tests
    run in several processes at once); the previous count afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def random_variables(tree: Mapping, seed: int) -> dict:
    """A flax variable tree (arrays or ShapeDtypeStructs) with every leaf
    replaced by numpy random values of its shape, scaled by its role:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), BN running means
    N(0, 0.1²) and variances U(0.5, 1.5), biases N(0, 0.1²), layer-scale
    gammas 0.5 + N(0, 0.1²). Moved BN statistics and non-trivial gammas
    make a swap of any two of them show."""
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.randn(*shape) / np.sqrt(fan_in)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.randn(*shape)
        if name.startswith("gamma"):
            return 0.5 + 0.1 * rng.randn(*shape)
        return 0.1 * rng.randn(*shape)  # bias, mean

    def walk(t):
        return {k: walk(v) if isinstance(v, Mapping)
                else leaf(k, tuple(v.shape)).astype(np.float32)
                for k, v in t.items()}

    return walk(tree)


def port_state_dict(variables: Mapping, module: Optional[str] = None) -> dict:
    """The port's state_dict for JAX variables. `module` names the flax
    module the variables belong to (e.g. "blocks_0", "attn",
    "patch_embed"), for a layer tested alone: its torch name is stripped
    from the keys."""
    if module is None:
        return state_dict_from_jax(variables)
    nested = {col: {module: tree} for col, tree in variables.items()}
    head = module.replace("blocks_", "blocks.") + "."
    return {k[len(head):]: v for k, v in state_dict_from_jax(nested).items()}


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def random_pil(rng, w, h):
    """A PIL RGB image of uniform random bytes."""
    from PIL import Image
    return Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))


def write_coco(root, split: str, sizes, seed: int) -> None:
    """A COCO-format split under root: <split>2017/*.png and
    annotations/instances_<split>2017.json, with non-contiguous category
    ids, a crowd annotation (skipped by the reader) and an image with no
    annotation."""
    rng = np.random.RandomState(seed)
    (root / f"{split}2017").mkdir(parents=True, exist_ok=True)
    (root / "annotations").mkdir(exist_ok=True)
    images, anns = [], []
    for i, (w, h) in enumerate(sizes):
        name = f"{seed:03d}{i:03d}.png"
        random_pil(rng, w, h).save(root / f"{split}2017" / name)
        images.append({"id": 100 + i, "file_name": name, "width": w,
                       "height": h})
        for j in range(0 if i == len(sizes) - 1 else 3):
            x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": int(rng.choice([1, 3, 7])),
                         "bbox": [x0, y0, rng.uniform(2, w / 2),
                                  rng.uniform(2, h / 2)],
                         "iscrowd": int(j == 2 and i == 0)})
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": f"c{c}"} for c in (7, 1, 3)]}
    (root / "annotations" / f"instances_{split}2017.json").write_text(
        json.dumps(coco))


class _FakeTxn:
    def __init__(self, store, write):
        self.store, self.write = store, write

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def put(self, k, v):
        self.store[bytes(k)] = bytes(v)

    def get(self, k):
        return self.store.get(bytes(k))


class _FakeEnv:
    """An LMDB environment kept as one JSON file in its directory: the
    env/txn calls that the LMDB readers and writers make, no more."""

    def __init__(self, path):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._file = os.path.join(path, "data.json")
        self.store = {}
        if os.path.exists(self._file):
            with open(self._file) as f:
                self.store = {bytes.fromhex(k): bytes.fromhex(v)
                              for k, v in json.load(f).items()}

    def begin(self, write=False, buffers=False):
        return _FakeTxn(self.store, write)

    def close(self):
        with open(self._file, "w") as f:
            json.dump({k.hex(): v.hex() for k, v in self.store.items()}, f)


@pytest.fixture()
def fake_lmdb(monkeypatch):
    """An in-process stand-in for the `lmdb` package (a copy of
    tests/test_lmdb.py's stub), in sys.modules for the test's duration: a
    write open makes a new environment from the path's file, a read-only
    open reuses the path's last one."""
    mod = types.ModuleType("lmdb")
    envs = {}

    def open_(path, **kw):
        if path not in envs or not kw.get("readonly"):
            envs[path] = _FakeEnv(path)
        return envs[path]

    mod.open = open_
    monkeypatch.setitem(sys.modules, "lmdb", mod)
    return mod
