"""The port's input pipeline (fastervit_tpu_torch/data) against
fastervit_tpu/data on the CPU, on images and pickles the tests write: the
eval transform, EvalLoader (PIL and native paths, TTA, padded last batch),
TrainLoader (PIL and native paths, RandAugment, erasing), RandAugment
alone, CIFAR's loaders and split, and the native decoder and resampler.
Every batch bit-equal."""
import io
import pickle
import random

import numpy as np
import pytest
from PIL import Image

from fastervit_tpu.data import cifar as jcifar
from fastervit_tpu.data import imagenet as jimagenet
from fastervit_tpu.data import native as jnative
from fastervit_tpu.data import preprocess as jpre
from fastervit_tpu.data import randaugment as jra
from fastervit_tpu.data import train_loader as jtrain
from fastervit_tpu.models.config import DataConfig as JDataConfig
from fastervit_tpu_torch.data import cifar, imagenet, native, preprocess
from fastervit_tpu_torch.data import randaugment, train_loader
from fastervit_tpu_torch.models.config import DataConfig

NATIVE = native.available() and jnative.available()


def _cfgs(**kw):
    base = dict(input_size=(48, 48), crop_pct=0.875, crop_mode="center",
                interpolation="bicubic")
    base.update(kw)
    return JDataConfig(**base), DataConfig(**base)


def _img(w, h, seed):
    rng = np.random.RandomState(seed)
    return Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three classes of JPEGs at mixed sizes and one PNG (which the native
    decoder declines, so the loaders fall back to PIL for it): 11 images."""
    root = tmp_path_factory.mktemp("imgs")
    n = 0
    for c, cls in enumerate(("n01", "n02", "n03")):
        (root / cls).mkdir()
        for i in range(4 if c < 2 else 3):
            img = _img(50 + 13 * i + c, 40 + 7 * ((i + c) % 3), n)
            ext = ".png" if n == 5 else ".jpg"
            img.save(root / cls / f"{i}{ext}")
            n += 1
    return str(root)


def _batches(loader):
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("mode,size", [("center", (48, 48)),
                                       ("squash", (48, 48)),
                                       ("center", (40, 56))])
def test_eval_transform_matches_jax(mode, size):
    jc, pc = _cfgs(input_size=size, crop_mode=mode)
    for seed, (w, h) in enumerate([(90, 60), (61, 97)]):
        img = _img(w, h, seed)
        assert np.array_equal(preprocess.eval_transform(img, pc),
                              jpre.eval_transform(img, jc))


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
@pytest.mark.parametrize("tta", [0, 2])
def test_eval_loader_matches_jax(folder, use_native, tta):
    """Batches of 4 over 11 images: the last one padded and masked."""
    if use_native and not NATIVE:
        pytest.skip("the native runtime did not build here")
    jc, pc = _cfgs()
    want = _batches(jimagenet.EvalLoader(folder, jc, 4, num_workers=2,
                                         tta=tta, use_native=use_native))
    loader = imagenet.EvalLoader(folder, pc, 4, num_workers=2, tta=tta,
                                 use_native=use_native)
    got = _batches(loader)
    _assert_same_batches(got, want)
    assert len(loader) == len(got) and loader.classes == ["n01", "n02",
                                                          "n03"]
    assert sum(int(b["valid"].sum()) for b in got) == 11 * max(tta, 1)


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
def test_train_loader_matches_jax(folder, use_native):
    """Two epochs of random-resized crops, flips, RandAugment and erasing
    (reprob 1) from the same seeds."""
    if use_native and not NATIVE:
        pytest.skip("the native runtime did not build here")
    jc, pc = _cfgs()
    kw = dict(num_workers=2, seed=3, reprob=1.0, use_native=use_native)
    jl = jtrain.TrainLoader(folder, jc, 4, **kw)
    pl = train_loader.TrainLoader(folder, pc, 4, **kw)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        _assert_same_batches(_batches(pl), _batches(jl))
    assert len(pl) == 2


def test_train_loader_native_and_pil_paths_agree(folder):
    if not NATIVE:
        pytest.skip("the native runtime did not build here")
    _, pc = _cfgs()
    kw = dict(num_workers=2, seed=5)
    _assert_same_batches(
        _batches(train_loader.TrainLoader(folder, pc, 4, use_native=True,
                                          **kw)),
        _batches(train_loader.TrainLoader(folder, pc, 4, use_native=False,
                                          **kw)))


@pytest.mark.parametrize("spec", ["rand-m9-mstd0.5-inc1",
                                  "rand-m7-n3-mstd1.0-inc0"])
def test_randaugment_matches_jax(spec):
    img = _img(64, 48, 9)
    for seed in range(6):
        got = randaugment.create_randaugment(spec, seed=seed)(img)
        want = jra.create_randaugment(spec, seed=seed)(img)
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_crop_and_erasing_draws_match_jax():
    for seed in range(8):
        assert train_loader.rrc_box(90, 61, random.Random(seed)) == \
            jtrain.rrc_box(90, 61, random.Random(seed))
        x = np.random.RandomState(seed).randn(24, 24, 3).astype(np.float32)
        got = train_loader.random_erasing(x.copy(), random.Random(seed),
                                          prob=0.7)
        want = jtrain.random_erasing(x.copy(), random.Random(seed), prob=0.7)
        assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    """cifar-10-batches-py with five train batches of 12 images and a test
    batch of 10, in the published pickle layout."""
    root = tmp_path_factory.mktemp("cifar")
    d = root / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.RandomState(11)
    for name, n in [(f"data_batch_{i}", 12) for i in range(1, 6)] + \
            [("test_batch", 10)]:
        with open(d / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072), np.uint8),
                         "labels": rng.randint(0, 10, n).tolist()}, f)
    return str(root)


@pytest.mark.parametrize("mode", ["eval", "search"])
def test_cifar_loaders_match_jax(cifar_root, mode):
    kw = dict(batch_size=8, mode=mode, search_split=40, seed=2)
    got = cifar.get_loaders(cifar_root, **kw)
    want = jcifar.get_loaders(cifar_root, **kw)
    for g, w in zip(got, want):
        for epoch in (0, 1):
            g.set_epoch(epoch)
            w.set_epoch(epoch)
            _assert_same_batches(_batches(g), _batches(w))
    assert np.array_equal(np.concatenate(cifar.my_random_split(60, [40, 20],
                                                               2)),
                          np.concatenate(jcifar.my_random_split(60, [40, 20],
                                                                2)))


def test_native_decode_and_resize_match_jax():
    if not NATIVE:
        pytest.skip("the native runtime did not build here")
    rng = np.random.RandomState(12)
    for shape in [(64, 48), (123, 77)]:
        b = io.BytesIO()
        Image.fromarray(rng.randint(0, 256, shape + (3,), np.uint8)).save(
            b, "JPEG", quality=90)
        buf = b.getvalue()
        got = native.decode_jpeg(buf)
        assert np.array_equal(got, jnative.decode_jpeg(buf))
        assert np.array_equal(got, np.asarray(Image.open(io.BytesIO(buf))))
        assert native.jpeg_dims(buf) == (shape[1], shape[0])
        for size, box in [((17, 29), None), ((40, 40), (3.5, 2.25, 40, 30))]:
            assert np.array_equal(native.resize_bicubic(got, size, box),
                                  jnative.resize_bicubic(got, size, box))
    assert native.library_path().parent.name == "_build"
