"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the tiny cells run on the CPU) and
the program is broken in place, once for each fault a cell can have.
Serving: an answer altered where it is produced, and half of the batch
left out (its rows answered from the other half). Training: a step that
leaves its state unchanged, the loss's mean taken over half of the batch,
and an answer (a row of logits) altered where it is produced; and the
control, the reference in the program's place in float8. The exchange
between chips does not apply to one-chip cells, and a serving cell holds
no state that a step could leave unchanged."""
import time

import pytest
import torch

from fastervit_tpu_torch.models.fastervit import FasterViT
from h100bench import faults, harness

FORWARD = FasterViT.forward


def altered_answer(self, x):
    out = FORWARD(self, x).clone()
    out[0] = out[-1]          # the first image gets the last one's logits
    return out


def half_batch(self, x):
    half = FORWARD(self, x[: (x.shape[0] + 1) // 2])
    return torch.cat([half, half])[: x.shape[0]]


@pytest.mark.parametrize("fault", [altered_answer, half_batch])
def test_a_broken_forward_is_not_correct(checkout, monkeypatch, fault,
                                         cpu_threads):
    monkeypatch.setattr(FasterViT, "forward", fault)
    cell = harness.load_cell(checkout, "tiny_fv0.tiny_serve", 2 ** 31 + 9,
                             0.2, False, "cpu", time.perf_counter())
    result = harness.run_cell(cell)
    (check,) = result["checks"].values()
    assert result["correct"] is False
    assert check["value"] > 100 * check["limit"]


def test_the_unbroken_forward_is_correct(checkout, cpu_threads):
    cell = harness.load_cell(checkout, "tiny_fv0.tiny_serve", 2 ** 31 + 9,
                             0.2, False, "cpu", time.perf_counter())
    assert harness.run_cell(cell)["correct"] is True


@pytest.mark.parametrize("fault", [faults.unchanged_state, faults.half_batch,
                                   faults.altered_answer],
                         ids=lambda f: f.__name__)
def test_a_broken_train_step_is_not_correct(checkout, fault, cpu_threads):
    cell = harness.load_cell(checkout, "tiny_fv0.tiny_train", 2 ** 31 + 21,
                             0.0, False, "cpu", time.perf_counter())
    record = harness.mode_module(checkout, "train").run(cell, fault=fault)
    assert not harness.verdict(record)
    assert max(c["value"] / c["limit"] for c in record.checks.values()) > 10


def test_the_control_precision_is_not_correct(checkout, cpu_threads):
    # the reference in the program's place, its products in float8
    cell = harness.load_cell(checkout, "tiny_fv0.tiny_train", 2 ** 31 + 21,
                             0.0, False, "cpu", time.perf_counter())
    record = harness.mode_module(checkout, "train").run(cell,
                                                         cast=faults.fp8)
    assert not harness.verdict(record)
