"""The port's detection CLI on the CPU: `--eval --synthetic --device cpu`
builds DINO-4scale with a narrow FasterViT-0 backbone at a small canvas,
loads a reference-layout checkpoint, evaluates two synthetic batches and
writes eval.json; without `--eval` it trains one synthetic epoch with
either matcher, evaluates and writes best.pth; `--coco-path` trains and
evaluates on a COCO-format directory the test writes; a run with neither
`--synthetic` nor `--coco-path`, or on a root without COCO, raises."""
import json

import pytest
import torch

from fastervit_tpu_torch.detection import main as cli
from fastervit_tpu_torch.detection.dino import build_dino_from_config
from fastervit_tpu_torch.utils.pyconfig import PyConfig
from torch_parity import few_torch_threads, write_coco  # noqa: F401

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


@pytest.mark.parametrize("extra,error,match", [
    ((), ValueError, "--coco-path"),
    (("--epochs", "2"), ValueError, "--coco-path"),
    (("--matcher", "host"), ValueError, "--coco-path"),
    (("--coco-path", "no_coco"), FileNotFoundError, "instances_val2017")],
    ids=["no_eval", "epochs", "matcher", "coco_path"])
def test_training_and_coco_raise(tmp_path, extra, error, match):
    """A run without data raises: a training run (no --eval, --epochs,
    --matcher) with neither --synthetic nor --coco-path names --coco-path,
    and an evaluation on a root that holds no COCO names the annotation
    file it lacks."""
    argv = _argv(tmp_path, *extra)
    argv.remove("--synthetic")
    if not extra:
        argv.remove("--eval")
    if error is FileNotFoundError:
        argv[argv.index("no_coco")] = str(tmp_path / "no_coco")
    with pytest.raises(error, match=match):
        cli.main(argv)


def test_coco_path_trains_and_evaluates(tmp_path):
    """--coco-path on a COCO-format root (train2017 and val2017 images of
    mixed sizes, squashed to the canvas): one training epoch of one batch,
    its evaluation, best.pth; then --eval from that root."""
    root = tmp_path / "coco"
    write_coco(root, "train", [(150, 110), (96, 140), (128, 128)], seed=2)
    write_coco(root, "val", [(120, 90), (100, 130)], seed=3)
    argv = _argv(tmp_path, "--epochs", "1", "--max-targets", "4",
                 "--coco-path", str(root))
    argv.remove("--synthetic")
    argv.remove("--eval")
    result = cli.main(argv)
    assert result["loss"] == result["loss"] and result["loss"] > 0
    assert (tmp_path / "out" / "best.pth").exists()
    argv = _argv(tmp_path, "--coco-path", str(root))
    argv.remove("--synthetic")
    stats = cli.main(argv)
    written = json.loads((tmp_path / "out" / "eval.json").read_text())
    assert json.dumps(written) == json.dumps(stats)
    assert {"mAP", "AP50", "AR100"} <= set(written)


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
