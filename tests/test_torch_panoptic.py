"""Detection's last modules against the JAX package on the CPU: the
panoptic loader and post-processing, the visualizer (on tests/
test_panoptic.py's fixtures; exact), stage freezing against
`frozen_param_labels`, and the port's detect and track examples run as a
user runs them."""
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

from fastervit_tpu import create_model as jax_create_model
from fastervit_tpu.detection import panoptic as jpan
from fastervit_tpu.detection import visualizer as jvis
from fastervit_tpu.models.fastervit import frozen_param_labels
from fastervit_tpu_torch import create_model, freeze_stages
from fastervit_tpu_torch.detection import panoptic, visualizer
from fastervit_tpu_torch.utils.convert import torch_key_for_path

REPO = Path(__file__).resolve().parent.parent


def test_ids_and_boxes_match_jax():
    ids = np.asarray([[0, 1, 255], [256, 70000, 16777215]], np.uint32)
    assert np.array_equal(panoptic.id2rgb(ids), jpan.id2rgb(ids))
    rgb = jpan.id2rgb(ids)
    assert np.array_equal(panoptic.rgb2id(rgb), jpan.rgb2id(rgb))
    m = np.zeros((3, 10, 12), np.uint8)
    m[0, 2:5, 3:9] = 1
    m[2, 9, 0] = 1
    assert np.array_equal(panoptic.masks_to_boxes(m), jpan.masks_to_boxes(m))


@pytest.fixture
def panoptic_dir(tmp_path):
    """tests/test_panoptic.py's fixture: segment ids 7 (left half) and 9
    (right half) of a 20x30 image."""
    img_dir, ann_dir = tmp_path / "imgs", tmp_path / "anns"
    img_dir.mkdir()
    ann_dir.mkdir()
    h, w = 20, 30
    id_map = np.full((h, w), 7, np.uint32)
    id_map[:, w // 2:] = 9
    Image.fromarray(jpan.id2rgb(id_map)).save(ann_dir / "000001.png")
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(
        img_dir / "000001.jpg")
    ann = {"images": [{"id": 1, "file_name": "000001.png",
                       "height": h, "width": w}],
           "annotations": [{"image_id": 1, "file_name": "000001.png",
                            "segments_info": [
                                {"id": 7, "category_id": 1, "iscrowd": 0,
                                 "area": h * w // 2},
                                {"id": 9, "category_id": 5, "iscrowd": 0,
                                 "area": h * w // 2}]}]}
    ann_file = tmp_path / "panoptic.json"
    ann_file.write_text(json.dumps(ann))
    return str(img_dir), str(ann_dir), str(ann_file)


def test_panoptic_dataset_matches_jax(panoptic_dir):
    got, want = (panoptic.CocoPanopticDataset(*panoptic_dir),
                 jpan.CocoPanopticDataset(*panoptic_dir))
    assert len(got) == len(want) == 1
    assert got.get_height_and_width(0) == want.get_height_and_width(0)
    (gi, gt), (wi, wt) = got[0], want[0]
    assert np.array_equal(gi, wi) and set(gt) == set(wt)
    for k in wt:
        assert np.array_equal(gt[k], wt[k]) and \
            np.asarray(gt[k]).dtype == np.asarray(wt[k]).dtype, k


def _panoptic_cases():
    q, c, h, w = 4, 6, 16, 16
    logits = np.full((q, c + 1), -5.0)
    logits[0, 2] = logits[1, 3] = logits[2, 3] = 8.0
    logits[3, c] = 8.0
    masks = np.full((q, h, w), -10.0)
    masks[0, :, :8] = 10.0
    masks[1, :8, 8:] = 10.0
    masks[2, 8:, 8:] = 10.0
    rng = np.random.RandomState(0)
    empty = np.full((3, 5), -5.0)
    empty[:, 4] = 5.0
    return [
        # test_panoptic.py's: stuff merged, a small segment dropped
        (logits, masks, {2: True, 3: False}, (h, w), None, 0.5),
        # upsampled masks (bilinear) and a resize to another target size
        (logits, masks[:, ::2, ::2], {2: True, 3: False}, (h, w), (24, 20),
         0.5),
        # random logits and masks
        (rng.randn(6, 8) * 4, rng.randn(6, 12, 10), {1: False, 2: True},
         (12, 10), None, 0.3),
        # every query no-object
        (empty, np.zeros((3, 8, 8)), {}, (8, 8), None, 0.5),
    ]


@pytest.mark.parametrize("case", range(4))
def test_postprocess_panoptic_matches_jax(case):
    logits, masks, things, size, target, thr = _panoptic_cases()[case]
    got = panoptic.postprocess_panoptic(logits, masks, things, size, target,
                                        threshold=thr)
    want = jpan.postprocess_panoptic(logits, masks, things, size, target,
                                     threshold=thr)
    assert got["segments_info"] == want["segments_info"]
    assert got["png_string"] == want["png_string"]
    seg = np.asarray(Image.open(io.BytesIO(got["png_string"])))
    assert seg.shape[:2] == (target or size)


def test_visualizer_matches_jax(tmp_path):
    """The same PNG bytes from the same seed, image and boxes; renorm of
    both layouts equal."""
    img = np.random.RandomState(1).randn(32, 48, 3).astype(np.float32)
    tgt = {"boxes": np.asarray([[0.5, 0.5, 0.4, 0.6], [0.2, 0.3, 0.1, 0.2]]),
           "size": (32, 48), "box_label": ["cat", "dog"], "image_id": 3,
           "caption": "two boxes"}
    got = visualizer.COCOVisualizer(seed=2).visualize(
        img, tgt, caption="demo", savedir=str(tmp_path / "port"))
    want = jvis.COCOVisualizer(seed=2).visualize(
        img, tgt, caption="demo", savedir=str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == "demo-3.png"
    assert Path(got).read_bytes() == Path(want).read_bytes()
    for x in (img, img.transpose(2, 0, 1)):
        assert np.array_equal(visualizer.renorm(x), jvis.renorm(x))


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("frozen_stages", [-1, 0, 2, 3])
def test_freeze_stages_matches_frozen_param_labels(frozen_stages):
    """The parameters freeze_stages stops are those frozen_param_labels
    labels 'frozen', through torch_key_for_path; the others keep their
    gradients."""
    kw = dict(depths=[1, 1, 1, 1], dim=16, in_dim=8, num_heads=[1, 1, 2, 2],
              resolution=64)
    jm = jax_create_model("faster_vit_0_224", **kw)
    params = jax.eval_shape(lambda: jm.module.init(
        jax.random.PRNGKey(0), jm.dummy_input()))["params"]
    labels = frozen_param_labels(jax.tree_util.tree_map(lambda s: 0, params),
                                 frozen_stages)
    want = {torch_key_for_path(p) for p, label in _leaf_paths(labels)
            if label == "frozen"}
    tm = freeze_stages(create_model("faster_vit_0_224", device="meta", **kw),
                       frozen_stages)
    got = {n for n, p in tm.named_parameters() if not p.requires_grad}
    assert got == want
    assert (len(got) > 0) == (frozen_stages >= 0)
    trainable = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert trainable and not trainable & got


@pytest.mark.parametrize("name,flags", [
    ("detect", ["--device", "cpu"]), ("track", ["--output", "{tmp}"])])
def test_examples_run(name, flags, tmp_path):
    """The example run as `python -m fastervit_tpu_torch.examples.<name>`
    runs it (runpy, as __main__), in a process of its own with two torch
    threads, which then holds no jax, flax or fastervit_tpu module."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    argv = [name] + [f.format(tmp=tmp_path) for f in flags]
    code = ("import runpy, sys; sys.argv = %r; runpy.run_module("
            "'fastervit_tpu_torch.examples.%s', run_name='__main__'); "
            "print('LOADED', sorted(k for k in sys.modules if k.split('.')[0]"
            " in ('jax', 'jaxlib', 'flax', 'fastervit_tpu')))" % (argv, name))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    if name == "detect":
        assert "boxes: (2, 100, 4)" in out.stdout
        loss = float(out.stdout.split("detection loss:")[1].split()[0])
        assert np.isfinite(loss)
    else:
        assert "frames tracked: 10 ids: [0]" in out.stdout
        rows = (tmp_path / "track_results.txt").read_text().splitlines()
        assert len(rows) == 10
