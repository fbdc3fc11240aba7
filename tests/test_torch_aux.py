"""The port's small helpers on the CPU: utils/timing.py (TimeCounter,
time_function, timing_report, torch_trace), utils/plot.py
(plot_summaries, plot_precision_recall), models/registry.py::is_model
against the JAX package's, and utils/metrics.py's loggers
(TensorboardLogger's event files where tensorboard imports; WandbLogger
without wandb)."""
import json
import logging
import time

import numpy as np
import pytest
import torch

from fastervit_tpu import models as jax_models
from fastervit_tpu_torch.models.registry import is_model, list_models
from fastervit_tpu_torch.utils import plot, timing
from fastervit_tpu_torch.utils.metrics import (TensorboardLogger, WandbLogger,
                                               update_summary)
from torch_parity import few_torch_threads  # noqa: F401


def test_time_counter_sums_its_sections():
    tc = timing.TimeCounter()
    for _ in range(2):
        with tc.timeit("a"):
            time.sleep(0.01)
    tc.tock("b")
    assert list(tc.timedict) == ["a", "b"]
    assert tc.timedict["a"] >= 0.02 and tc.timedict["b"] >= tc.timedict["a"]
    assert str(tc).startswith("a:") and "%" in str(tc)
    tc.clear()
    assert not tc.timedict


def test_time_function_counts_only_when_on(monkeypatch):
    timing.reset_timing()

    @timing.time_function
    def work(x):
        return x + 1

    assert work(1) == 2 and timing.timing_report() == ""
    monkeypatch.setattr(timing, "DO_TIMING", True)
    work(1), work(2)
    assert "over 2 calls" in timing.timing_report()
    assert "work" in timing.timing_report()
    timing.reset_timing()
    assert timing.timing_report() == ""


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with timing.torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with timing.torch_trace(None) as prof:
        pass
    assert prof is None


def test_is_model_agrees_with_jax():
    names = list_models() + ["faster_vit_9_224", ""]
    assert len(list_models()) == 22
    assert [is_model(n) for n in names] == \
        [jax_models.registry.is_model(n) for n in names]


def test_plot_summaries_and_precision_recall(tmp_path):
    pytest.importorskip("matplotlib")
    for run in ("a", "b"):
        path = tmp_path / run / "summary.csv"
        path.parent.mkdir()
        for epoch in range(3):
            update_summary(epoch, {"loss": 2.0 - epoch},
                           {"top1": 10.0 * epoch}, str(path),
                           write_header=epoch == 0)
    fig = plot.plot_summaries([str(tmp_path / r / "summary.csv")
                               for r in ("a", "b")],
                              output=str(tmp_path / "curves.png"))
    assert len(fig.axes) == 2 and (tmp_path / "curves.png").stat().st_size
    assert [len(ax.lines) for ax in fig.axes] == [2, 2]
    precision = np.random.RandomState(0).uniform(size=(10, 101, 3, 4, 3))
    fig = plot.plot_precision_recall(precision,
                                     output=str(tmp_path / "pr.png"))
    assert (tmp_path / "pr.png").stat().st_size and len(fig.axes) == 1


def test_tensorboard_logger_writes_event_files(tmp_path):
    pytest.importorskip("tensorboard")
    tb = TensorboardLogger(str(tmp_path / "tb"), run_name="exp")
    assert tb.active
    for step in range(3):
        tb.log_scalar("train/loss", 1.0 / (step + 1), step)
    tb.flush()
    tb.close()
    events = list((tmp_path / "tb" / "exp").glob("events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(tmp_path / "tb" / "exp"))
    acc.Reload()
    assert [e.value for e in acc.Scalars("train/loss")] == \
        pytest.approx([1.0, 0.5, 1 / 3])
    assert not TensorboardLogger(None).active


def test_wandb_logger_without_wandb_warns_and_does_nothing(caplog):
    try:
        import wandb  # noqa: F401
        pytest.skip("wandb is installed")
    except ImportError:
        pass
    with caplog.at_level(logging.WARNING):
        log = WandbLogger(True, run_name="x")
    assert "wandb requested but not installed" in caplog.text
    log.log({"a": 1.0}, step=0)
    log.finish()


def test_memorize_probe_runs_on_the_cpu():
    from fastervit_tpu_torch.probes import memorize
    tiny = {"depths": [1, 1, 1, 1], "num_heads": [1, 2, 4, 8], "dim": 16,
            "in_dim": 8, "resolution": 64, "num_classes": 10}
    out = memorize.main(["--device", "cpu", "--images", "4", "--batch", "2",
                         "--steps", "2", "--every", "1", "--warmup-epochs",
                         "1", "--dtypes", "float32", "--model-kwargs",
                         json.dumps(tiny)])
    run = out["runs"]["float32"]
    assert run["steps"] == [1, 2] and all(np.isfinite(run["loss"]))
    assert all(0.0 <= t <= 100.0 for t in run["top1"])
    assert out["lr"] == 5e-3 * 2 / 4096 and out["card"] == "cpu"


def test_the_memorisation_record_reaches_full_train_accuracy():
    """docs/memorize_fv0.json, the probe's run on the card: both dtypes'
    curves end at 100% train top-1 with the loss below its start."""
    from pathlib import Path
    rec = json.loads((Path(__file__).resolve().parent.parent / "docs"
                      / "memorize_fv0.json").read_text())
    assert "H100" in rec["card"] and rec["steps"] == 300
    for name in ("bfloat16", "float32"):
        run = rec["runs"][name]
        assert run["steps"][-1] == 300 and run["top1"][-1] == 100.0
        assert run["loss"][-1] < run["loss"][0] / 2
