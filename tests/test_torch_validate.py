"""The port's validation (fastervit_tpu_torch/validate.py) against
fastervit_tpu/validate.py on the CPU, over image folders the tests write and
a tiny model with bridged weights: count, top-1 and top-5 equal and the loss
within 1e-5, plain, with TTA 2, with a subset logit mask, with ImageNet-V2
labels and with ReaL labels; the batch decay on running out of memory; the
CLI, plain and --int8, on --synthetic and on a folder."""
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fastervit_tpu import create_model as jax_create_model
from fastervit_tpu import validate as jval
from fastervit_tpu.data import imagenet as jimagenet
from fastervit_tpu.data import real_labels as jreal
from fastervit_tpu_torch import create_model, validate as pval
from fastervit_tpu_torch.data import imagenet, real_labels
from torch_parity import (few_torch_threads, port_state_dict,  # noqa: F401
                          random_variables)

TINY = dict(depths=[1, 1, 1, 1], dim=32, in_dim=16, num_heads=[1, 2, 4, 4],
            resolution=64, num_classes=12)
BATCH = 8  # JAX's validate shards the batch over the 8 CPU devices


def _write_folder(root, classes, per_class, seed):
    rng = np.random.RandomState(seed)
    names = []
    for c, cls in enumerate(classes):
        (root / cls).mkdir(parents=True)
        for i in range(per_class[c]):
            w, h = 60 + 11 * i, 50 + 9 * ((i + c) % 3)
            name = f"{cls}_{i}.jpg"
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                root / cls / name)
            names.append(name)
    return str(root)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny model in both packages on the same random weights, a folder
    of 3 classes (11 images: the last batch padded) and an ImageNet-V2
    layout folder ("10" sorts before "2")."""
    tmp = tmp_path_factory.mktemp("val")
    jm = jax_create_model("faster_vit_0_224", **TINY)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    variables = random_variables(shapes, 21)
    tm = create_model("faster_vit_0_224", device="cpu", **TINY)
    tm.load_state_dict(port_state_dict(variables), strict=True)
    folder = _write_folder(tmp / "val", ["n03", "n07", "n11"], [4, 4, 3], 1)
    v2 = _write_folder(tmp / "v2", ["2", "10", "11"], [3, 2, 3], 2)
    return {"jm": jm, "variables": variables, "tm": tm.eval(),
            "folder": folder, "v2": v2, "tmp": tmp}


def _loaders(s, root, batch=BATCH, **kw):
    return (jimagenet.EvalLoader(root, s["jm"].cfg.data, batch, num_workers=2,
                                 use_native=False, **kw),
            imagenet.EvalLoader(root, s["tm"].cfg.data, batch, num_workers=2,
                                use_native=False, **kw))


def _check(got, want, n):
    """Equal counts and accuracies, the loss to 1e-5; a rate wherever
    there was a batch after the first (which the rate leaves out)."""
    assert got["count"] == want["count"] == n
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])
    assert abs(got["loss"] - want["loss"]) <= 1e-5
    assert (got["img_s"] > 0) == (want["img_s"] > 0)


def test_validate_matches_jax_with_real_labels(setup):
    s = setup
    jl, pl = _loaders(s, s["folder"])
    files = [p for p in pl.paths]
    rng = np.random.RandomState(3)
    real = {p.rsplit("/", 1)[1]: ([] if i % 4 == 0 else
                                   sorted(set(rng.randint(0, 12, 3).tolist())))
            for i, p in enumerate(files)}
    path = s["tmp"] / "real.json"
    path.write_text(json.dumps(real))
    jr = jreal.RealLabels(files, str(path))
    pr = real_labels.RealLabels(files, str(path))
    want = jval.validate(s["jm"], s["variables"], jl, real_labels=jr)
    got = pval.validate(s["tm"], pl, real_labels=pr)
    _check(got, want, 11)
    for k in (1, 5):
        assert pr.get_accuracy(k) == jr.get_accuracy(k)
    assert pr._count == jr._count == 8


def test_validate_tta_matches_jax(setup):
    s = setup
    # 16 rows a batch: 8 images, each with its flip (JAX shards the 8
    # images' labels over its 8 devices)
    jl, pl = _loaders(s, s["folder"], batch=2 * BATCH, tta=2)
    want = jval.validate(s["jm"], s["variables"], jl, tta=2)
    got = pval.validate(s["tm"], pl, tta=2)
    _check(got, want, 11)


def test_validate_subset_mask_matches_jax(setup):
    """ImageNet-A/R style: the folder's wnids among a 12-class index file
    (in another order); the other classes' logits masked to -inf."""
    s = setup
    index = s["tmp"] / "classes.txt"
    wnids = [f"n{i:02d}" for i in (5, 11, 0, 3, 9, 1, 7, 2, 4, 6, 8, 10)]
    index.write_text("\n".join(wnids) + "\n")
    classes = imagenet.index_image_folder(s["folder"])[2]
    jmask, jidx = jval.subset_logit_mask(classes, str(index), 12)
    mask, idx = pval.subset_logit_mask(classes, str(index), 12)
    assert idx == jidx and np.array_equal(mask.numpy(), np.asarray(jmask))
    jl, pl = _loaders(s, s["folder"], class_to_idx=idx)
    want = jval.validate(s["jm"], s["variables"], jl, logit_mask=jmask)
    got = pval.validate(s["tm"], pl, logit_mask=mask)
    _check(got, want, 11)


def test_validate_imagenet_v2_labels_match_jax(setup):
    s = setup
    classes = imagenet.index_image_folder(s["v2"])[2]
    assert classes == ["10", "11", "2"]
    idx = pval.imagenet_v2_class_to_idx(classes)
    assert idx == jval.imagenet_v2_class_to_idx(classes) == \
        {"10": 10, "11": 11, "2": 2}
    jl, pl = _loaders(s, s["v2"], class_to_idx=idx)
    assert list(pl.labels) == [10, 10, 11, 11, 11, 2, 2, 2]
    want = jval.validate(s["jm"], s["variables"], jl)
    got = pval.validate(s["tm"], pl)
    _check(got, want, 8)


class _OomOnce:
    """A loader that runs out of device memory at its first batch."""

    def __iter__(self):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")


def test_batch_decay_halves_the_batch_on_out_of_memory(setup):
    s = setup
    sizes = []

    def make_loader(bs):
        sizes.append(bs)
        if len(sizes) == 1:
            return _OomOnce()
        return imagenet.EvalLoader(s["folder"], s["tm"].cfg.data, bs,
                                   num_workers=2, use_native=False)

    got = pval.validate_with_batch_decay(make_loader, s["tm"], BATCH)
    assert sizes == [BATCH, BATCH // 2] and got["count"] == 11
    want = pval.validate(s["tm"], imagenet.EvalLoader(
        s["folder"], s["tm"].cfg.data, BATCH // 2, num_workers=2,
        use_native=False))
    assert (got["top1"], got["top5"], got["loss"]) == (
        want["top1"], want["top5"], want["loss"])

    def always(bs):
        sizes.append(bs)
        return _OomOnce()

    with pytest.raises(torch.cuda.OutOfMemoryError):
        pval.validate_with_batch_decay(always, s["tm"], BATCH, retries=1)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_cli_on_a_folder_and_synthetic(setup, int8, capsys):
    """python -m fastervit_tpu_torch.validate on the CPU, float and --int8:
    a folder of 11 images at batch 4 (its last batch padded), then
    --synthetic (8 batches); each prints one JSON line."""
    s = setup
    flags = ["--model", "faster_vit_0_224", "--device", "cpu",
             "--batch-size", "4"] + (["--int8"] if int8 else [])
    with pytest.MonkeyPatch.context() as mp:
        # the CLI builds the model by name: narrow it to the tiny config
        real = pval.create_model
        mp.setattr(pval, "create_model",
                   lambda name, **kw: real(name, **{**kw, **TINY}))
        res = pval.main(flags + ["--data-dir", s["folder"]])[0]
        syn = pval.main(flags + ["--synthetic"])[0]
    assert res["count"] == 11 and 0 <= res["top1"] <= res["top5"] <= 100
    assert syn["count"] == 32 and np.isfinite(syn["loss"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [l["count"] for l in lines] == [11, 32]
