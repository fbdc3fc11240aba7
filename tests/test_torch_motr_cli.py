"""The port's tracking CLI (fastervit_tpu_torch.tracking.submit) against the
JAX package's (fastervit_tpu.tracking.submit.main), both paths, on a
3-frame JPEG sequence and a proposal db the test writes, with the same
weights: the exact path from an upstream-layout .pth that both load
(--reference-checkpoint), the default path from a JAX pickle
(--checkpoint) and its bridge to the port's own .pth. Both write the same
MOT rows: equal frames and ids, boxes within PIXEL_TOL pixels, scores
within SCORE_TOL (the files keep 2 and 4 decimals).

The CLIs build faster_vit_0_any_res at its full width, here at 64x96 with
a 64-wide transformer of one encoder and one decoder layer. The class
heads' kernels are scaled x4 so that scores spread over (0, 1), and the
exact detector's anchors and box heads are set so that its boxes keep a
size the area filter passes; the rows
must match exactly, so a score at a threshold would show as a failure,
never pass unseen."""
import json
import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fastervit_tpu import get_config as jax_get_config
from fastervit_tpu.tracking import motr as jm
from fastervit_tpu.tracking import motr_exact as jx
from fastervit_tpu.tracking import submit as jax_submit
from fastervit_tpu_torch.tracking import submit
from fastervit_tpu_torch.tracking.convert import (
    motr_detector_state_dict_from_jax, motr_state_dict_from_jax)
from fastervit_tpu_torch.tracking.mot_data import load_mot_file
from torch_parity import few_torch_threads, random_variables  # noqa: F401

H, W, DIM = 64, 96, 64
PIXEL_TOL = 0.02      # 2 decimals written, each side may round apart
SCORE_TOL = 2e-4      # 4 decimals
COMMON = ["--split", "val", "--img-height", str(H), "--img-width", str(W),
          "--dim", str(DIM), "--num-proposals", "2", "--enc-layers", "1",
          "--dec-layers", "1", "--backbone", "faster_vit_0_any_res",
          "--det-db", "det_db.json"]


@pytest.fixture(scope="module")
def mot_root(tmp_path_factory):
    """val/seq01/img1 with three 144x216 JPEG frames (resized to 64x96 by
    both loaders; at that size the area filter, 100 px, keeps most boxes)
    and a proposal db of three boxes a frame."""
    root = tmp_path_factory.mktemp("mot")
    img_dir = root / "val" / "seq01" / "img1"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    db = {}
    for f in range(1, 4):
        Image.fromarray(rng.randint(0, 255, (144, 216, 3), np.uint8)).save(
            img_dir / f"{f:08d}.jpg")
        db[f"val/seq01/img1/{f:08d}.txt"] = [
            f"{12 + 9 * f + 36 * i},{18 + 24 * i},60,72,{0.9 - 0.2 * i:.1f}"
            for i in range(3)]
    (root / "det_db.json").write_text(json.dumps(db))
    return root


def _rows(path):
    return load_mot_file(str(path))


def _same_rows(got, want):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for f in want:
        np.testing.assert_array_equal(got[f]["ids"], want[f]["ids"],
                                      err_msg=f"frame {f} ids")
        np.testing.assert_allclose(got[f]["boxes"], want[f]["boxes"],
                                   atol=PIXEL_TOL, err_msg=f"frame {f}")
        np.testing.assert_allclose(got[f]["conf"], want[f]["conf"],
                                   atol=SCORE_TOL, err_msg=f"frame {f}")
    assert sum(len(r["ids"]) for r in want.values()), "no row written"


def test_exact_path_writes_jax_rows(mot_root, tmp_path):
    """--exact from one upstream-layout .pth: the JAX CLI converts it with
    convert_motr_checkpoint, the port's loads it with
    load_motr_checkpoint."""
    cfg = jax_get_config("faster_vit_0_any_res", resolution=[H, W])
    nq, total = 3, 3 + 2 + 4
    det = jx.MOTRDetectorExact(backbone_cfg=cfg, dim=DIM, num_queries=nq,
                               enc_layers=1, dec_layers=1)
    qim = jx.QIMv2(dim=DIM)
    x0 = np.zeros((1, H, W, 3), np.float32)
    qp0, rp0 = np.zeros((1, total, DIM)), np.full((1, total, 4), 0.5)
    variables = random_variables(jax.eval_shape(lambda: det.init(
        jax.random.PRNGKey(0), x0, qp0, rp0)), seed=1)
    params = variables["params"]
    params["class_embed_0"]["kernel"] *= 4.0
    # anchors inside the frame and box heads that move them a little (the
    # JAX init's position is uniform(0, 1)), so boxes pass the area filter
    params["position"] = np.random.RandomState(4).uniform(
        0.3, 0.7, params["position"].shape).astype(np.float32)
    params["transformer"]["bbox_embed_0"]["layer_2"]["kernel"] *= 0.1
    vq = random_variables(jax.eval_shape(lambda: qim.init(
        jax.random.PRNGKey(1), qp0, qp0, rp0, np.zeros((1, total)),
        np.ones((1, total), bool))), seed=2)
    ckpt = tmp_path / "motrv2.pth"
    torch.save({"model": motr_state_dict_from_jax(
        {**variables, "params": {**variables["params"],
                                 "qim": vq["params"]}})}, ckpt)
    args = COMMON + ["--mot-path", str(mot_root), "--num-queries", str(nq),
                     "--exact", "--track-capacity", "4",
                     "--reference-checkpoint", str(ckpt)]
    jax_submit.main(args + ["--output", str(tmp_path / "jax")])
    submit.main(args + ["--device", "cpu", "--output", str(tmp_path / "port")])
    _same_rows(_rows(tmp_path / "port" / "seq01.txt"),
               _rows(tmp_path / "jax" / "seq01.txt"))


def test_default_path_writes_jax_rows(mot_root, tmp_path):
    """The default path: the JAX CLI from a pickle of its MOTRDetector's
    variables, the port's from their bridge saved as its own .pth."""
    cfg = jax_get_config("faster_vit_0_any_res", resolution=[H, W])
    nq = 4
    det = jm.MOTRDetector(backbone_cfg=cfg, dim=DIM, num_detect_queries=nq,
                          num_track_queries=nq, num_proposal_queries=2,
                          enc_layers=1, dec_layers=1)
    variables = random_variables(jax.eval_shape(lambda: det.init(
        jax.random.PRNGKey(0), np.zeros((1, H, W, 3), np.float32))), seed=3)
    tr = variables["params"]["transformer"]
    for name in ("class_embed", "enc_out_class_embed"):
        tr[name]["kernel"] *= 4.0
    with open(tmp_path / "motr.pkl", "wb") as f:
        pickle.dump(variables, f)
    torch.save(motr_detector_state_dict_from_jax(variables),
               tmp_path / "motr.pth")
    args = COMMON + ["--mot-path", str(mot_root), "--num-queries", str(nq),
                     "--score-thresh", "0.3"]
    jax_submit.main(args + ["--checkpoint", str(tmp_path / "motr.pkl"),
                            "--output", str(tmp_path / "jax")])
    submit.main(args + ["--checkpoint", str(tmp_path / "motr.pth"),
                        "--device", "cpu", "--output", str(tmp_path / "port")])
    _same_rows(_rows(tmp_path / "port" / "seq01.txt"),
               _rows(tmp_path / "jax" / "seq01.txt"))


def test_cli_needs_the_card_unless_told(mot_root, tmp_path, monkeypatch):
    """Without a card and without --device cpu the CLI raises; it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        submit.main(COMMON + ["--mot-path", str(mot_root), "--exact",
                              "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
