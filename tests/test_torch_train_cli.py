"""The port's training CLI on the CPU: a few steps of a tiny model with the
fv0 recipe from configs/faster_vit_0_224_1k.yaml, the flat-YAML reader
against PyYAML on every config, the logging flags, and the flag whose
machinery is not ported, which raises. (Checkpoints, resume and warm
start: tests/test_torch_checkpoint.py.)"""
import csv
import math
from pathlib import Path

import pytest
import yaml

from fastervit_tpu_torch.train import train
from torch_parity import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs" / "faster_vit_0_224_1k.yaml")
TINY = ('{"depths": [1, 1, 1, 1], "num_heads": [1, 2, 4, 8], "dim": 16, '
        '"in_dim": 8, "resolution": 112}')


def test_cli_trains_and_writes_a_finite_summary(tmp_path):
    out = tmp_path / "run"
    result = train.main([
        "--config", CONFIG, "--device", "cpu", "--synthetic",
        "--model-kwargs", TINY, "--num-classes", "10", "-b", "4",
        "--epochs", "2", "--warmup-epochs", "1", "--cooldown-epochs", "0",
        "--data-len", "8", "--mixup-off-epoch", "1", "--mesa", "0.5",
        "--output", str(out)])
    rows = list(csv.DictReader(open(out / "summary.csv")))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    for r in rows:
        for key in ("train_loss", "eval_loss", "eval_top1", "eval_top5"):
            assert math.isfinite(float(r[key])), (key, r)
    assert math.isfinite(result["best_top1"])
    assert (out / "code_copy" / "train" / "steps.py").exists()


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_flat_yaml_reader_matches_pyyaml(path):
    assert train.read_flat_yaml(str(path)) == yaml.safe_load(open(path))


def test_config_sets_defaults_and_command_line_overrides():
    args = train.parse_args(["--config", CONFIG, "--lr", "0.1"])
    assert (args.lr, args.dtype, args.model_ema_decay, args.clip_grad) == \
        (0.1, "bfloat16", 0.9998, 5.0)


def test_flat_yaml_reader_refuses_nested_yaml(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("model: x\nopt:\n  name: adamw\n")
    with pytest.raises(ValueError, match="flat"):
        train.read_flat_yaml(str(bad))


@pytest.mark.parametrize("flags", [
    ["--data-dir", "/nonexistent", "--lmdb-dataset"],
    ["--synthetic", "--lmdb-dataset"]])
def test_unported_flags_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(flags + ["--device", "cpu", "--output", str(tmp_path)])


@pytest.mark.parametrize("flag", ["--tensorboard", "--log-wandb"])
def test_logging_flags_train_and_log(flag, tmp_path, caplog):
    """--tensorboard writes event files under <output>/tb/<experiment>;
    --log-wandb without the wandb package warns once and trains on."""
    out = tmp_path / "run"
    result = train.main([
        "--device", "cpu", "--synthetic", "--model-kwargs", TINY,
        "--num-classes", "10", "-b", "4", "--epochs", "1",
        "--warmup-epochs", "0", "--cooldown-epochs", "0", "--data-len", "8",
        "--log-interval", "1", "--experiment", "tiny", flag,
        "--output", str(out)])
    assert len(result["train_losses"]) == 2
    assert all(math.isfinite(v) for v in result["train_losses"])
    if flag == "--tensorboard":
        assert list((out / "tb" / "tiny").glob("events.out.tfevents.*"))
    else:
        try:
            import wandb  # noqa: F401
        except ImportError:
            assert "wandb requested but not installed" in caplog.text


def test_a_card_it_cannot_see_raises(tmp_path):
    with pytest.raises(RuntimeError, match="--device cuda:99"):
        train.main(["--synthetic", "--device", "cuda:99",
                    "--output", str(tmp_path)])
