"""The port's detection CLI on the CPU: `--eval --synthetic --device cpu`
builds DINO-4scale with a narrow FasterViT-0 backbone at a small canvas,
loads a reference-layout checkpoint, evaluates two synthetic batches and
writes eval.json; without `--eval` it trains one synthetic epoch with
either matcher, evaluates and writes best.pth; any run on COCO data
(`--coco-path`, or no `--synthetic`) raises."""
import json

import pytest
import torch

from fastervit_tpu_torch.detection import main as cli
from fastervit_tpu_torch.detection.dino import build_dino_from_config
from fastervit_tpu_torch.utils.pyconfig import PyConfig
from torch_parity import few_torch_threads  # noqa: F401

CONFIG = "configs/dino/dino_4scale_faster_vit_0_224.py"
OPTIONS = ['backbone_overrides={"depths": [1, 1, 2, 1], "dim": 32, '
           '"in_dim": 16, "num_heads": [1, 2, 4, 8]}',
           "hidden_dim=64", "num_queries=20", "enc_layers=1",
           "dec_layers=1", "num_select=10"]


def _argv(tmp_path, *extra):
    return ["--config", CONFIG, "--options", *OPTIONS, "--eval",
            "--synthetic", "--device", "cpu", "--image-size", "128",
            "--batch-size", "2", "--output", str(tmp_path / "out"), *extra]


def test_eval_synthetic_writes_eval_json(tmp_path):
    cfg = PyConfig.fromfile(CONFIG)
    cfg.merge_from_list(OPTIONS)
    src = build_dino_from_config(cfg, resolution=(128, 128), device="cpu",
                                 generator=torch.Generator().manual_seed(5))
    sd = {k: v for k, v in src.state_dict().items()
          if not k.startswith("transformer.decoder.class_embed")}
    torch.save({"model": sd}, tmp_path / "dino.pth")
    stats = cli.main(_argv(tmp_path, "--checkpoint",
                           str(tmp_path / "dino.pth")))
    written = json.loads((tmp_path / "out" / "eval.json").read_text())
    assert json.dumps(written) == json.dumps(stats)   # NaN where no gt
    assert {"mAP", "AP50", "AP75", "APs", "AR100"} <= set(written)
    assert all(0.0 <= v <= 1.0 for v in written.values() if v == v)


@pytest.mark.parametrize("extra,match", [
    ((), None), (("--epochs", "2"), "--epochs"),
    (("--matcher", "host"), "--matcher"),
    (("--coco-path", "/data/coco"), "COCO")],
    ids=["no_eval", "epochs", "matcher", "coco_path"])
def test_training_and_coco_raise(tmp_path, extra, match):
    """Training and evaluation on COCO data raise until the COCO loader is
    ported: a training run (no --eval, --epochs, --matcher) without
    --synthetic, and any run with --coco-path, name COCO."""
    argv = _argv(tmp_path, *extra)
    if match != "COCO":
        argv.remove("--synthetic")
    if not extra:
        argv.remove("--eval")
    with pytest.raises(NotImplementedError, match="COCO"):
        cli.main(argv)


@pytest.mark.parametrize("matcher", ["host", "auction"])
def test_training_one_synthetic_epoch_writes_best(tmp_path, matcher):
    argv = _argv(tmp_path, "--epochs", "1", "--matcher", matcher,
                 "--max-targets", "4")
    argv.remove("--eval")
    result = cli.main(argv)
    assert result["loss"] == result["loss"] and result["loss"] > 0
    sd = torch.load(tmp_path / "out" / "best.pth")
    cfg = PyConfig.fromfile(CONFIG)
    cfg.merge_from_list(OPTIONS)
    det = build_dino_from_config(cfg, resolution=(128, 128), device="cpu")
    det.load_state_dict(sd, strict=True)
    # the weights moved from their seed-0 init
    init = build_dino_from_config(cfg, resolution=(128, 128), device="cpu")
    assert not torch.equal(sd["transformer.level_embed"],
                           init.state_dict()["transformer.level_embed"])


def test_coco_eval_matches_jax_and_counts_unmatched_classes():
    """The port's evaluator gives the JAX copy's numbers where that copy
    runs, and counts a detection in an image with no ground truth of its
    class as a false positive, where the JAX copy raises IndexError."""
    import numpy as np

    from fastervit_tpu.detection.coco_eval import \
        evaluate_detections as jax_eval
    from fastervit_tpu_torch.detection.coco_eval import evaluate_detections

    rng = np.random.RandomState(0)
    gts, preds = [], []
    for _ in range(3):
        xy = rng.uniform(0, 200, (4, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(10, 120, (4, 2))], 1)
        gts.append({"boxes": boxes, "labels": np.array([1, 1, 2, 2])})
        preds.append({"boxes": boxes + rng.uniform(-8, 8, boxes.shape),
                      "labels": np.array([1, 1, 2, 2]),
                      "scores": rng.rand(4)})
    # NaN where an area range holds no ground truth, on both sides
    np.testing.assert_equal(evaluate_detections(preds, gts,
                                                full_breakdown=True),
                            jax_eval(preds, gts, full_breakdown=True))
    box = np.array([[0.0, 0.0, 10.0, 10.0]])
    gt = [{"boxes": box, "labels": np.array([1])},
          {"boxes": box, "labels": np.array([2])}]
    pred = [{"boxes": box, "labels": np.array([1]), "scores": np.array([.9])},
            {"boxes": box, "labels": np.array([1]), "scores": np.array([.8])}]
    with pytest.raises(IndexError):
        jax_eval(pred, gt)
    # class 1: a hit, then a false positive in the second image: AP 1;
    # class 2: no detection: AP 0
    assert evaluate_detections(pred, gt) == {"mAP": 0.5, "AP50": 0.5,
                                             "AP75": 0.5}
