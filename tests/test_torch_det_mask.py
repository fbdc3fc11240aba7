"""The port's padding masks and COCO data against fastervit_tpu's on the CPU:
the canvas mask's downsampling to each level (cell for cell against
jax.image.resize(..., "nearest"), at DINO-4scale's 800x1333 levels and at
small canvases); the masked encoder tables (valid ratios, reference points,
position embedding, proposals; at DINO-4scale's four level shapes and tiny
ones, on random top-left valid rectangles); MSDeformAttnModule with a
value mask, forward and gradients; the tiny detector (JAX's
tests/test_detection.py one) on a padded batch; the detection transforms
and the COCO reader on images and an instances json written to tmp_path.

Tolerances: the tables ≤ 1e-6 (f32, one rounding of sin, cos or log
apart); the MSDA module ≤ 1e-5 of each output's largest entry; the
detector ≤ 5e-5 (PERF.md's detector bound, as tests/test_torch_dino.py);
the mask, pad_to_canvas, the transforms and the reader exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu import get_config as jax_get_config
from fastervit_tpu.detection import coco_data as jcoco
from fastervit_tpu.detection import transformer as jt
from fastervit_tpu.detection import transforms as jtr
from fastervit_tpu.detection.dino import DINODetector as JaxDINO
from fastervit_tpu.ops import msda as jmsda
from fastervit_tpu_torch import get_config
from fastervit_tpu_torch.detection import coco_data, transforms
from fastervit_tpu_torch.detection import transformer as tt
from fastervit_tpu_torch.detection.convert import dino_state_dict_from_jax
from fastervit_tpu_torch.detection.dino import (DINODetector,
                                                feature_shapes,
                                                level_padding_mask)
from fastervit_tpu_torch.ops.msda import MSDeformAttnModule
from torch_parity import (few_torch_threads, nchw,  # noqa: F401
                          random_pil, random_variables, write_coco)

DINO_CANVAS = (800, 1333)
DINO_LEVELS = ((100, 167), (50, 84), (25, 42), (13, 21))
# canvases and their levels: DINO-4scale's, the tiny detector's, a
# rectangular one, phase 19's 480x640
CANVASES = {"dino": (DINO_CANVAS, DINO_LEVELS),
            "tiny": ((128, 128), ((16, 16), (8, 8), (4, 4), (2, 2))),
            "rect": ((160, 288), ((20, 36), (10, 18), (5, 9), (3, 5))),
            "480x640": ((480, 640), ((60, 80), (30, 40), (15, 20), (8, 10)))}
TABLE_TOL = 1e-6
MSDA_TOL = 1e-5
DET_TOL = 5e-5
TINY_BACKBONE = dict(depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8], dim=32,
                     in_dim=16)
TINY_HEAD = dict(num_classes=7, dim=64, num_queries=20, enc_layers=1,
                 dec_layers=2)


def canvas_mask(canvas, valid) -> np.ndarray:
    """(B, H, W) bool, True outside each image's top-left valid (h, w)."""
    mask = np.ones((len(valid), *canvas), bool)
    for i, (h, w) in enumerate(valid):
        mask[i, :h, :w] = False
    return mask


def random_valid(canvas, n, seed):
    """The full canvas, then n - 1 random top-left valid rectangles of at
    least a third of each side."""
    rng = np.random.RandomState(seed)
    h, w = canvas
    return [canvas] + [(rng.randint(h // 3, h + 1), rng.randint(w // 3, w + 1))
                       for _ in range(n - 1)]


def jax_level_masks(mask: np.ndarray, levels) -> np.ndarray:
    """The JAX detector's downsampling (dino.py:64-71), flattened and
    concatenated: (B, S)."""
    b = mask.shape[0]
    return np.concatenate([np.asarray(jax.image.resize(
        jnp.asarray(mask, jnp.float32), (b, h, w), "nearest") > 0.5).reshape(
            b, h * w) for h, w in levels], 1)


@pytest.mark.parametrize("name", sorted(CANVASES))
def test_mask_downsampling_matches_jax_cell_for_cell(name):
    canvas, levels = CANVASES[name]
    valid = random_valid(canvas, 6, seed=len(name))
    if name == "dino":   # a 4:3 COCO image at short side 800, and 600x1000
        valid += [(800, 1066), (600, 1000)]
    mask = canvas_mask(canvas, valid)
    got = level_padding_mask(torch.from_numpy(mask), levels).numpy()
    want = jax_level_masks(mask, levels)
    assert got.shape == want.shape
    bad = np.argwhere(got != want)
    assert not len(bad), f"{len(bad)} cells differ, first {bad[:5].tolist()}"


def test_detector_levels_are_the_tables_levels():
    """The levels the tests above use are the detector's own."""
    for canvas, levels in CANVASES.values():
        assert feature_shapes(*canvas, (1, 2, 3), 4) == levels


@pytest.mark.parametrize("name", ["dino", "tiny", "rect"])
def test_masked_tables_match_jax(name):
    canvas, levels = CANVASES[name]
    mask = jax_level_masks(canvas_mask(canvas, random_valid(canvas, 3, 7)),
                           levels)
    tm = torch.from_numpy(mask)

    def jax_tables(m):
        jvr = jt.valid_ratios_from_mask(m, levels)
        return (jvr, jt.encoder_reference_points_masked(levels, jvr),
                jt.position_embedding_sine_hw_masked(m, levels, 32),
                *jt.output_proposals_masked(m, levels, jvr))

    jvr, jref, jpos, jlogit, jvalid = jax.jit(jax_tables)(mask)
    vr = tt.valid_ratios_from_mask(tm, levels)
    np.testing.assert_allclose(vr.numpy(), np.asarray(jvr), atol=TABLE_TOL,
                               rtol=TABLE_TOL)
    assert vr.dtype == torch.float32 and (vr[0] == 1).all()
    logit, valid = tt.output_proposals_masked(tm, levels, vr)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    pairs = [
        ("reference points", tt.encoder_reference_points_masked(levels, vr),
         jref),
        ("position embedding",
         tt.position_embedding_sine_hw_masked(tm, levels, 32), jpos),
        ("proposals", logit, jlogit)]
    for what, got, want in pairs:
        assert got.dtype == torch.float32, what
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TABLE_TOL, rtol=TABLE_TOL,
                                   err_msg=what)


def test_unpadded_mask_gives_the_constant_tables():
    """An all-False mask: the masked tables equal the unmasked constants
    (up to the order of the position embedding's f32 and f64 sums)."""
    levels = CANVASES["rect"][1]
    s = sum(h * w for h, w in levels)
    mask = torch.zeros(2, s, dtype=torch.bool)
    vr = tt.valid_ratios_from_mask(mask, levels)
    assert (vr == 1).all()
    np.testing.assert_array_equal(
        tt.encoder_reference_points_masked(levels, vr)[1].numpy(),
        tt.encoder_reference_points(levels))
    np.testing.assert_allclose(
        tt.position_embedding_sine_hw_masked(mask, levels, 32)[1].numpy(),
        tt.position_embedding_sine_hw(levels, 32), atol=TABLE_TOL)
    logit, valid = tt.output_proposals_masked(mask, levels, vr)
    want_logit, want_valid = tt.output_proposals(levels)
    np.testing.assert_array_equal(valid[1].numpy(), want_valid)
    np.testing.assert_allclose(logit[1].numpy(), want_logit, atol=TABLE_TOL)


def _module_params(rng, d_model, m, nl, p):
    def dense(i, o):
        return {"kernel": (rng.randn(i, o) / np.sqrt(i)).astype(np.float32),
                "bias": (0.1 * rng.randn(o)).astype(np.float32)}
    return {"value_proj": dense(d_model, d_model),
            "sampling_offsets": dense(d_model, m * nl * p * 2),
            "attention_weights": dense(d_model, m * nl * p),
            "output_proj": dense(d_model, d_model)}


def _close_to_largest(got: np.ndarray, want: np.ndarray, tol: float,
                      what: str) -> None:
    err = np.abs(got - np.asarray(want)).max()
    scale = np.abs(np.asarray(want)).max()
    assert err <= tol * scale, f"{what}: {err} against {tol} x {scale}"


@pytest.mark.parametrize("coords", [2, 4])
def test_msda_module_with_mask_matches_jax(coords):
    """Forward and gradients (query, reference points, features and every
    parameter) with a value mask; the padded rows' feature gradient is
    zero."""
    d_model, m, p = 32, 4, 3
    levels = ((6, 7), (3, 4), (1, 1))
    nl, s = len(levels), sum(h * w for h, w in levels)
    rng = np.random.RandomState(coords + 10)
    params = _module_params(rng, d_model, m, nl, p)
    query = rng.randn(2, 15, d_model).astype(np.float32)
    feats = rng.randn(2, s, d_model).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (2, 15, nl, coords)).astype(np.float32)
    mask = rng.rand(2, s) < 0.3
    g = rng.randn(2, 15, d_model).astype(np.float32)
    jm = jmsda.MSDeformAttnModule(d_model, nl, m, p)

    def loss(prm, q, r, f):
        out = jm.apply({"params": prm}, q, r, f, levels, jnp.asarray(mask))
        return (out * g).sum(), out

    (_, want), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(params, query, ref, feats)
    tm = MSDeformAttnModule(d_model, nl, m, p)
    tm.load_state_dict({f"{name}.{leaf}": torch.from_numpy(
        np.ascontiguousarray(v[k].T if k == "kernel" else v[k]))
        for name, v in params.items()
        for k, leaf in (("kernel", "weight"), ("bias", "bias"))})
    tq, tr, tf = (torch.from_numpy(a).requires_grad_()
                  for a in (query, ref, feats))
    got = tm(tq, tr, tf, levels, torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    _close_to_largest(got.detach().numpy(), want, MSDA_TOL, "output")
    for what, t, w in (("query", tq, grads[1]), ("reference points", tr,
                                                 grads[2]),
                       ("features", tf, grads[3])):
        _close_to_largest(t.grad.numpy(), w, MSDA_TOL, f"d{what}")
    for name, v in params.items():
        layer = getattr(tm, name)
        _close_to_largest(layer.weight.grad.numpy().T,
                          grads[0][name]["kernel"], MSDA_TOL,
                          f"d{name}.weight")
        _close_to_largest(layer.bias.grad.numpy(), grads[0][name]["bias"],
                          MSDA_TOL, f"d{name}.bias")
    assert not tf.grad[torch.from_numpy(mask)].any()


def _jax_tiny():
    cfg = jax_get_config("faster_vit_0_224", resolution=128, **TINY_BACKBONE)
    return JaxDINO(backbone_cfg=cfg, **TINY_HEAD)


def _port_tiny(**kw):
    cfg = get_config("faster_vit_0_224", resolution=(128, 128),
                     **TINY_BACKBONE)
    with torch.device("cpu"):
        return DINODetector(cfg, **TINY_HEAD, **kw)


def same_selection(got: np.ndarray, want: np.ndarray, scores: np.ndarray,
                   tol: float, what: str) -> None:
    """Selected indices (B, k), best first, equal unless the scores where
    they differ tie within tol (the padded rows' scores tie exactly)."""
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        gap = np.abs(scores[b][got[b][diff]] - scores[b][want[b][diff]])
        assert not len(diff) or gap.max() <= tol, (
            f"{what}[{b}] differs at {diff.tolist()}, score gaps "
            f"{gap.tolist()}")


def test_detector_on_a_padded_batch_matches_jax():
    """The tiny detector on a batch of a full 128x128 image and a 96x80 one
    padded onto the canvas: the encoder's outputs, the selection (up to
    ties) and every decoder layer on JAX's selection."""
    jdet = _jax_tiny()
    x0 = np.zeros((1, 128, 128, 3), np.float32)
    variables = random_variables(jax.eval_shape(
        lambda: jdet.init(jax.random.PRNGKey(0), x0)), seed=51)
    imgs = np.random.RandomState(52).randn(2, 128, 128, 3).astype(np.float32)
    x, mask = transforms.pad_to_canvas([imgs[0], imgs[1][:96, :80]],
                                       (128, 128))
    want = jax.jit(lambda v, a, m: jdet.apply(v, a, pad_mask=m))(
        variables, x, mask)
    det = _port_tiny()
    det.load_state_dict(dino_state_dict_from_jax(variables), strict=True)
    det.eval()
    tmask = torch.from_numpy(mask)
    with torch.no_grad():
        flat = level_padding_mask(tmask, det.spatial_shapes)
        enc = det.transformer.encode(det.project(det.features(nchw(x))),
                                     flat)
        for key, got in (("enc_logits", enc["enc_logits"]),
                         ("enc_boxes", torch.sigmoid(enc["enc_unsig"]))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want[key]),
                                       atol=DET_TOL, rtol=DET_TOL,
                                       err_msg=key)
        scores = enc["enc_logits"].max(-1).values.numpy()
        jtopk = np.asarray(jax.lax.top_k(jnp.max(want["enc_logits"], -1),
                                         20)[1])
        same_selection(det.transformer.select(enc).numpy(), jtopk, scores,
                       DET_TOL, "selection")
        out = det.transformer.decode(enc, torch.from_numpy(jtopk))
        own = det.transformer.decode(enc, det.transformer.select(enc))
        full = det(nchw(x), pad_mask=tmask)
    for key in ("interm_logits", "interm_boxes", "init_proposals"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   atol=DET_TOL, rtol=DET_TOL, err_msg=key)
    for i in range(2):
        for key in ("logits", "boxes"):
            np.testing.assert_allclose(out[key][i].numpy(),
                                       np.asarray(want[key][i]),
                                       atol=DET_TOL, rtol=DET_TOL,
                                       err_msg=f"{key} {i}")
            # the forward downsamples the canvas mask itself
            assert torch.equal(full[key][i], own[key][i]), (key, i)
    assert (enc["valid_ratios"][1] < 1).all()


def _boxes(rng, w, h, n):
    x0, y0 = rng.uniform(0, w * 0.7, n), rng.uniform(0, h * 0.7, n)
    return np.stack([x0, y0, x0 + rng.uniform(2, w * 0.3, n),
                     y0 + rng.uniform(2, h * 0.3, n)], -1)


def test_pad_to_canvas_matches_jax_bit_for_bit():
    rng = np.random.RandomState(3)
    imgs = [rng.randn(h, w, 3).astype(np.float32)
            for h, w in ((10, 12), (8, 16), (14, 5))]
    for canvas in (None, (16, 16), (9, 11)):       # the last crops
        x, mask = transforms.pad_to_canvas(imgs, canvas)
        jx, jmask = jtr.pad_to_canvas(imgs, canvas)
        assert x.dtype == jx.dtype and mask.dtype == jmask.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(mask, jmask)


def _same_target(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=what)


def test_transforms_match_jax():
    """hflip, resize, crop, random_size_crop, the train and val pipelines
    and normalize_target: equal images and targets."""
    rng = np.random.RandomState(4)
    for trial in range(6):
        w, h = rng.randint(40, 90), rng.randint(40, 90)
        img = random_pil(rng, w, h)
        tgt = {"boxes": _boxes(rng, w, h, 3),
               "labels": rng.randint(0, 5, 3).astype(np.int32)}
        cases = [("hflip", transforms.hflip(img, tgt), jtr.hflip(img, tgt)),
                 ("resize", transforms.resize(img, tgt, 48, 70),
                  jtr.resize(img, tgt, 48, 70)),
                 ("crop", transforms.crop(img, tgt, (5, 7, 30, 25)),
                  jtr.crop(img, tgt, (5, 7, 30, 25))),
                 ("random_size_crop", transforms.random_size_crop(
                     img, tgt, 20, 35, np.random.RandomState(trial)),
                  jtr.random_size_crop(img, tgt, 20, 35,
                                       np.random.RandomState(trial)))]
        kw = dict(scales=(32, 48), max_size=80, scales2_resize=(40,),
                  scales2_crop=(24, 40))
        cases.append(("train", transforms.make_coco_train_transform(**kw)(
            img, tgt, np.random.RandomState(trial)),
            jtr.make_coco_train_transform(**kw)(
                img, tgt, np.random.RandomState(trial))))
        cases.append(("val", transforms.make_coco_val_transform(56, 80)(
            img, tgt), jtr.make_coco_val_transform(56, 80)(img, tgt)))
        for what, (gi, gt), (wi, wt) in cases:
            np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi),
                                          err_msg=what)
            _same_target(gt, wt, what)
            gx, gn = transforms.normalize_target(gi, gt)
            wx, wn = jtr.normalize_target(wi, wt)
            np.testing.assert_array_equal(gx, wx, err_msg=what)
            _same_target(gn, wn, f"normalize_target after {what}")


def test_transforms_import_without_pil():
    """transforms and pad_to_canvas need no PIL (the card's machine has
    none): the module imports and pads with PIL made unimportable."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    probe = ("import sys; sys.modules['PIL'] = None\n"
             "import numpy as np\n"
             "from fastervit_tpu_torch.detection import transforms\n"
             "x, m = transforms.pad_to_canvas([np.ones((3, 4, 3), "
             "np.float32)], (4, 5))\n"
             "assert m.sum() == 8 and x.sum() == 36\n"
             "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


def test_coco_reader_matches_jax(tmp_path):
    write_coco(tmp_path, "val", [(40, 30), (33, 52), (48, 48)], seed=1)
    args = (str(tmp_path / "val2017"),
            str(tmp_path / "annotations" / "instances_val2017.json"))
    ds = coco_data.CocoDetectionDataset(*args, image_size=(32, 24))
    jds = jcoco.CocoDetectionDataset(*args, image_size=(32, 24))
    assert len(ds) == len(jds) == 3 and ds.cat_to_label == jds.cat_to_label
    for i in range(len(ds)):
        (x, t), (jx, jtg) = ds[i], jds[i]
        assert x.shape == (32, 24, 3) and x.dtype == np.float32
        np.testing.assert_array_equal(x, jx)
        _same_target(t, jtg, f"item {i}")
    assert len(ds[0][1]["labels"]) == 2 and len(ds[2][1]["labels"]) == 0
    got, want = list(ds.batches(2)), list(jds.batches(2))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0][0], want[0][0])
    for g, w in zip(coco_data.targets_to_eval_gt(got[0][1]),
                    jcoco.targets_to_eval_gt(want[0][1])):
        _same_target(g, w, "eval gt")
