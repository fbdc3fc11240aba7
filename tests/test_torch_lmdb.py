"""LMDB ImageNet storage in the port (fastervit_tpu_torch/data/
lmdb_dataset.py) on the CPU, under an in-process stand-in for the `lmdb`
package (`torch_parity.fake_lmdb`, a copy of tests/test_lmdb.py's stub;
the package is on neither machine): the build/read round trip and the
missing-package message; a database built by the JAX package's
`build_imagenet_lmdb` read by the port, and the reverse; the port's
EvalLoader and TrainLoader over the database against the same loaders
over the folder (PIL and native paths), every batch bit-equal; the
validate and train CLIs with --lmdb-dataset against the same runs over
the folder; the validate CLI's refusal of --lmdb-dataset with
--imagenet-v2, as JAX's."""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from fastervit_tpu.data import lmdb_dataset as jlmdb
from fastervit_tpu_torch import validate
from fastervit_tpu_torch.data import imagenet, lmdb_dataset, native
from fastervit_tpu_torch.data import train_loader
from fastervit_tpu_torch.models.config import DataConfig
from torch_parity import fake_lmdb, few_torch_threads  # noqa: F401

NATIVE = native.available()
TINY = ('{"depths": [1, 1, 1, 1], "num_heads": [1, 2, 4, 8], "dim": 16, '
        '"in_dim": 8, "resolution": 112}')


def _make_imagefolder(root, classes=("cat", "dog", "eel"), per_class=3):
    """JPEGs of random pixels at mixed sizes, one PNG (which the native
    decoder declines)."""
    rng = np.random.RandomState(0)
    for ci, cls in enumerate(classes):
        d = os.path.join(root, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rng.randint(0, 256, (30 + 7 * i, 40 + 5 * ci, 3), np.uint8)
            ext = ".png" if (ci, i) == (1, 1) else ".jpg"
            Image.fromarray(arr).save(os.path.join(d, f"{i}{ext}"))


@pytest.fixture()
def tree(tmp_path, fake_lmdb):
    root = str(tmp_path / "train")
    _make_imagefolder(root)
    return root


def _file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_build_and_read_roundtrip(tree):
    path = lmdb_dataset.build_imagenet_lmdb(tree)
    assert path == tree + "_faster_imagefolder.lmdb"
    paths, labels, classes = lmdb_dataset.load_lmdb_index(tree)
    assert (paths, labels, classes) == imagenet.index_image_folder(tree)
    reader = lmdb_dataset.LmdbImageReader(tree)
    for p in paths:
        assert reader.read_bytes(p) == _file_bytes(p)
    img = reader.read(paths[0])
    assert img.size == (40, 30) and img.mode == "RGB"
    with pytest.raises(KeyError):
        reader.read("missing.jpg")
    reader.close()


def test_missing_index_and_database_raise(tmp_path, fake_lmdb):
    root = str(tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="no LMDB index"):
        lmdb_dataset.load_lmdb_index(root)
    with pytest.raises(FileNotFoundError, match="_faster_imagefolder.lmdb"):
        lmdb_dataset.LmdbImageReader(root)


def test_missing_lmdb_package_message(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="lmdb package is required"):
        lmdb_dataset.LmdbImageReader(str(tmp_path))
    with pytest.raises(ImportError, match="lmdb package is required"):
        lmdb_dataset.build_imagenet_lmdb(str(tmp_path))


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_database_built_by_one_package_reads_in_the_other(tree, written_by):
    """Index, labels, classes and every image's bytes alike."""
    build, read = ((jlmdb, lmdb_dataset) if written_by == "jax"
                   else (lmdb_dataset, jlmdb))
    assert build.build_imagenet_lmdb(tree) == read.lmdb_paths(tree)[0]
    want = imagenet.index_image_folder(tree)
    assert tuple(read.load_lmdb_index(tree)) == want
    reader = read.LmdbImageReader(tree)
    assert all(reader.read_bytes(p) == _file_bytes(p) for p in want[0])


def _cfg():
    return DataConfig(input_size=(48, 48), crop_pct=0.875,
                      crop_mode="center", interpolation="bicubic")


def _batches(loader):
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
def test_eval_loader_over_lmdb_equals_the_folder(tree, use_native):
    """Batches of 4 over 9 images, with TTA: the last one padded."""
    if use_native and not NATIVE:
        pytest.skip("the native runtime did not build here")
    lmdb_dataset.build_imagenet_lmdb(tree)
    kw = dict(num_workers=2, tta=2, use_native=use_native)
    over_lmdb = imagenet.EvalLoader(tree, _cfg(), 4, use_lmdb=True, **kw)
    assert over_lmdb.reader is not None
    _assert_same_batches(_batches(over_lmdb),
                         _batches(imagenet.EvalLoader(tree, _cfg(), 4,
                                                      **kw)))
    assert over_lmdb.classes == ["cat", "dog", "eel"]


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
def test_train_loader_over_lmdb_equals_the_folder(tree, use_native):
    """Two epochs of one seed: crops, flips, RandAugment and erasing."""
    if use_native and not NATIVE:
        pytest.skip("the native runtime did not build here")
    lmdb_dataset.build_imagenet_lmdb(tree)
    kw = dict(num_workers=2, seed=3, reprob=1.0, use_native=use_native)
    over_lmdb = train_loader.TrainLoader(tree, _cfg(), 4, use_lmdb=True, **kw)
    folder = train_loader.TrainLoader(tree, _cfg(), 4, **kw)
    for epoch in (0, 1):
        over_lmdb.set_epoch(epoch)
        folder.set_epoch(epoch)
        _assert_same_batches(_batches(over_lmdb), _batches(folder))


def test_validate_refuses_lmdb_with_imagenet_v2(tree, capsys):
    """JAX's validate refuses the pair (validate.py:213-216): argparse's
    error, exit code 2."""
    src = Path(jlmdb.__file__).parent.parent / "validate.py"
    message = "--imagenet-v2 reads the folder layout"
    assert message in src.read_text()
    with pytest.raises(SystemExit) as e:
        validate.main(["--data-dir", tree, "--lmdb-dataset",
                       "--imagenet-v2", "--device", "cpu",
                       "--batch-size", "2"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_validate_cli_over_lmdb_equals_the_folder(tree, capsys):
    """fv0's random weights (seed 0) on the CPU: the same metrics."""
    lmdb_dataset.build_imagenet_lmdb(tree)
    argv = ["--data-dir", tree, "--device", "cpu", "--batch-size", "4"]
    over_lmdb = validate.main(argv + ["--lmdb-dataset"])
    folder = validate.main(argv)
    assert over_lmdb[0]["count"] == 9
    for key in ("top1", "top5", "loss", "count"):
        assert over_lmdb[0][key] == folder[0][key], key


def test_train_cli_over_lmdb_equals_the_folder(tmp_path, fake_lmdb):
    """Two steps of a tiny model from --data-dir, with and without
    --lmdb-dataset: the same losses and eval metric."""
    from fastervit_tpu_torch.train import train
    for split in ("train", "val"):
        _make_imagefolder(str(tmp_path / "data" / split), per_class=3)
        lmdb_dataset.build_imagenet_lmdb(str(tmp_path / "data" / split))
    argv = ["--device", "cpu", "--data-dir", str(tmp_path / "data"),
            "--model-kwargs", TINY, "--num-classes", "3", "-b", "4",
            "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs",
            "0", "--data-len", "8", "--log-interval", "1"]
    over_lmdb = train.main(argv + ["--lmdb-dataset", "--output",
                                   str(tmp_path / "lmdb")])
    folder = train.main(argv + ["--output", str(tmp_path / "folder")])
    assert len(over_lmdb["train_losses"]) == 2
    assert over_lmdb["train_losses"] == folder["train_losses"]
    assert over_lmdb["best_top1"] == folder["best_top1"]
