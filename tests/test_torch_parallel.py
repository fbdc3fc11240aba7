"""The port's data parallelism (fastervit_tpu_torch/parallel/) on the CPU:

- `parallel/dryrun.py` over a 2-process gloo group, spawned, against the
  same steps in one process on the same global batch (4 images, 2 a
  process): an eval step, then two classification steps with mixup (its
  partners the flipped global batch's, `mirrored_flip`) and
  SyncBatchNorm, the statistics read after the first; DINO's two-phase
  step and MOTR's clip step, the losses over the group's targets
  (`global_num_boxes`). Loss, gradient norm, BatchNorm running statistics
  and eval sums within 1e-6 (relative; absolute for the statistics), the
  sums taken in another order; both ranks report the same, and hold the
  same parameters after the steps;
- DINO's step again on global batches of one target and of none (fewer
  targets than processes: a process holds none): loss, gradient norm and
  every gradient of the 2-process step equal the one-process step's, the
  losses' divisor max(1, N) over the group (`global_num_boxes`), as in
  the JAX criterion;
- `distributed.resolve` against the JAX package's `initialize`, which
  hands jax.distributed what it resolves, on SLURM's and torchrun's
  variables, and `initialize` with none of them (no group).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastervit_tpu_torch.parallel import data_parallel, distributed, dryrun
from torch_parity import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-6


def _run(world, tmp_path, *flags):
    out = tmp_path / f"w{world}.json"
    res = subprocess.run(
        [sys.executable, "-m", "fastervit_tpu_torch.parallel.dryrun",
         "--world-size", str(world), "--device", "cpu", "--out", str(out),
         *flags],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    import json
    return json.loads(out.read_text())["ranks"]


FEW_TARGETS = (1, 0)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The dry run in one process and in two, DINO's step run again on
    FEW_TARGETS targets in all, its gradients saved in tmp/w<world>."""
    tmp = tmp_path_factory.mktemp("dryrun")
    (tmp / "w1").mkdir()
    (tmp / "w2").mkdir()
    one = dryrun.dryrun(1, "cpu", det_targets=FEW_TARGETS,
                        grads_dir=str(tmp / "w1"))
    two = _run(2, tmp, "--det-targets", *map(str, FEW_TARGETS),
               "--grads", str(tmp / "w2"))
    return {1: one, 2: two, "grads": tmp}


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=TOL, atol=0, err_msg=what)


@pytest.mark.parametrize("path", ["classification", "detection", "tracking"])
def test_two_processes_equal_one_on_the_global_batch(worlds, path):
    one, (r0, r1) = worlds[1][0][path], worlds[2]
    for key in ("loss", "grad_norm"):
        _close(r0[path][key], one[key], f"{path} {key}")
        assert r0[path][key] == r1[path][key], (path, key)


@pytest.mark.parametrize("targets", FEW_TARGETS)
def test_fewer_targets_than_processes_divide_as_one_process(worlds,
                                                            targets):
    """A global batch of `targets` targets over 2 processes: the step's
    loss, gradient norm and every gradient (within TOL of the largest
    gradient entry) equal the one-process step's. A divisor of
    max(1, N / world) would scale the 2-process loss by 1 / 2."""
    key = f"detection_{targets}_targets"
    one, two = worlds[1], worlds[2]
    dir1, dir2 = worlds["grads"] / "w1", worlds["grads"] / "w2"
    for k in ("loss", "grad_norm"):
        _close(two[0][key][k], one[0][key][k], f"{key} {k}")
        assert two[0][key][k] == two[1][key][k], (key, k)
    want = torch.load(dir1 / f"{key}_rank0.pt")
    largest = max(float(g.abs().max()) for g in want.values())
    assert largest > 0
    for rank in (0, 1):
        got = torch.load(dir2 / f"{key}_rank{rank}.pt")
        assert set(got) == set(want)
        for name, g in want.items():
            err = float((got[name] - g).abs().max())
            assert err <= TOL * largest, (key, rank, name, err, largest)


def test_batchnorm_statistics_and_eval_sums_are_global(worlds):
    one, (r0, r1) = worlds[1][0]["classification"], worlds[2]
    got = np.asarray(r0["classification"]["bn_running"])
    np.testing.assert_allclose(got, one["bn_running"], rtol=0, atol=TOL)
    assert got.tolist() == r1["classification"]["bn_running"]
    assert r0["classification"]["eval"]["count"] == 4
    for key, want in one["eval"].items():
        _close(r0["classification"]["eval"][key], want, key)
        assert r1["classification"]["eval"][key] == \
            r0["classification"]["eval"][key]


def test_ranks_hold_the_same_weights_after_the_steps(worlds):
    r0, r1 = worlds[2]
    assert r0["classification"]["params"] == r1["classification"]["params"]


def test_local_slice_takes_contiguous_rows():
    batch = {"image": np.arange(8), "label": torch.arange(8)}
    got = data_parallel.local_slice(batch, 1, 4)
    assert got["image"].tolist() == [2, 3] and got["label"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not split"):
        data_parallel.local_slice({"image": np.arange(6)}, 0, 4)


def test_without_a_group_the_helpers_are_the_one_process_ones():
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(data_parallel.mirrored_flip(x), x.flip(0))
    mask = torch.tensor([[True, False], [False, False]])
    assert int(data_parallel.global_num_boxes(mask)) == 1
    assert int(data_parallel.global_num_boxes(mask & False)) == 1
    assert data_parallel.wrap_model(torch.nn.Linear(2, 2),
                                    torch.device("cpu")) is None


ENVS = {
    "slurm": {"SLURM_NTASKS": "4", "SLURM_PROCID": "3",
              "SLURM_LOCALID": "1",
              "SLURM_STEP_NODELIST": "node7,node8"},
    "slurm_bracket": {"SLURM_NTASKS": "2", "SLURM_PROCID": "0",
                      "SLURM_STEP_NODELIST": "gpu[01-02]",
                      "MASTER_PORT": "29500"},
    "torchrun": {"MASTER_ADDR": "10.0.0.5", "MASTER_PORT": "29501",
                 "RANK": "2", "WORLD_SIZE": "8", "LOCAL_RANK": "2"},
    "torchrun_default_port": {"MASTER_ADDR": "host", "RANK": "0",
                              "WORLD_SIZE": "2"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_rendezvous_resolves_as_jax_does(name, monkeypatch):
    import jax
    from fastervit_tpu.parallel import distributed as jax_distributed
    for key in ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
                "SLURM_STEP_NODELIST", "MASTER_ADDR", "MASTER_PORT", "RANK",
                "WORLD_SIZE", "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in ENVS[name].items():
        monkeypatch.setenv(key, value)
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    jax_distributed.initialize()
    got = distributed.resolve()
    assert (got.num_processes, got.process_id) == \
        (seen["num_processes"], seen["process_id"])
    # JAX hands SLURM's host without a port (jax picks its own); the
    # port's group meets at MASTER_PORT, or JAX's default port
    host = seen["coordinator_address"]
    assert got.address == (host if ":" in host else
                            f"{host}:{ENVS[name].get('MASTER_PORT', '8476')}")
    assert got.local_rank == int(ENVS[name].get(
        "LOCAL_RANK", ENVS[name].get("SLURM_LOCALID", 0)))


def test_initialize_without_a_cluster_joins_no_group(monkeypatch):
    for key in ("SLURM_NTASKS", "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    got = distributed.initialize(device="cpu")
    assert got == {"process_index": 0, "process_count": 1,
                   "device": torch.device("cpu")}
    assert not torch.distributed.is_initialized()
