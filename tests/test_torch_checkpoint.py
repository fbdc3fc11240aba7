"""Checkpoints in the port, on the CPU: the lenient reference-checkpoint
loader against the JAX package's `load_pytorch_checkpoint` on the same
file, `create_model(checkpoint_path=)`, the CheckpointManager's retention
against the orbax manager's, save/restore/resume bit for bit, the
preemption latch and requeue exit, and the training CLI's warm start,
checkpoint, auto-resume and --resume."""
import copy
import json
import logging
import os
import re
import signal

import jax
import numpy as np
import pytest
import torch

import fastervit_tpu as jfvt
from fastervit_tpu.utils.checkpoint import \
    CheckpointManager as OrbaxCheckpointManager
from fastervit_tpu.utils.convert import export_state_dict
from fastervit_tpu.utils.convert import \
    load_pytorch_checkpoint as jax_load_pytorch_checkpoint
from fastervit_tpu.utils.convert import \
    normalize_state_dict as jax_normalize_state_dict
import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.train import train
from fastervit_tpu_torch.train.mixup import MixupConfig
from fastervit_tpu_torch.train.steps import (TrainConfig, create_train_state,
                                             make_train_step)
from fastervit_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                  restore_variables,
                                                  save_variables)
from fastervit_tpu_torch.utils.convert import (load_checkpoint,
                                               load_state_dict_lenient,
                                               normalize_state_dict)
from fastervit_tpu_torch.utils.preemption import (REQUEUE_EXIT_CODE,
                                                  PreemptionHandler,
                                                  maybe_auto_resume)
from torch_parity import (few_torch_threads,  # noqa: F401
                          nchw, port_state_dict, random_variables)

# the 21k family narrowed: windows and resolutions kept, widths and depths
# cut
NARROW = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=32,
              in_dim=16)
NARROW_JSON = json.dumps(NARROW)
TINY = dict(depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8], dim=16, in_dim=8,
            resolution=112, num_classes=10)


def _warnings(caplog, logger):
    """{'missing': [...], 'shape-mismatched': [...], 'unexpected': [...]}
    from the loaders' warnings, keys only, the tokenizer conv under one
    name."""
    out = {"missing": set(), "shape-mismatched": set(), "unexpected": set()}
    for rec in caplog.records:
        if rec.name != logger:
            continue
        msg = rec.getMessage()
        for kind in out:
            if msg.startswith(kind):
                body = msg.split(": ", 1)[1]
                keys = (re.findall(r"([\w.]+) \(", body)
                        if kind == "shape-mismatched" else body.split(", "))
                out[kind].update(k.replace("to_global_feature.pos",
                                           "pos_embed") for k in keys)
    return out


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """A narrow faster_vit_4_21k_224 (21841 classes) with random variables,
    exported by the JAX package and saved as a reference .pth.tar
    ({"state_dict": {"module." + key: tensor}})."""
    jm = jfvt.create_model("faster_vit_4_21k_224", num_classes=21841,
                           **NARROW)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    sd = export_state_dict(random_variables(shapes, 21))
    path = tmp_path_factory.mktemp("ref") / "fv4_21k_224.pth.tar"
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v)
                               for k, v in sd.items()}, "epoch": 7}, path)
    return path, sd


def test_load_checkpoint_matches_jax_loader(reference_file, caplog):
    """The 21k-224 file into a narrow 21k-384 with 10 classes: both loaders
    load the same keys and keep the same keys at init (the head, 21841
    classes against 10), and with the head set equal the logits agree."""
    path, sd = reference_file
    jm = jfvt.create_model("faster_vit_4_21k_384", num_classes=10, **NARROW)
    with caplog.at_level(logging.WARNING):
        jvars = jax_load_pytorch_checkpoint(jm, str(path))
        model = fvt.create_model("faster_vit_4_21k_384", device="cpu",
                                 num_classes=10, **NARROW).eval()
        result = load_checkpoint(model, str(path))
    want = _warnings(caplog, "fastervit_tpu.utils.convert")
    got = _warnings(caplog, "fastervit_tpu_torch.utils.convert")
    assert got == want
    assert want["shape-mismatched"] == {"head.weight", "head.bias"}
    assert sorted(k for k, _, _ in result.mismatched_keys) == [
        "head.bias", "head.weight"]
    assert result.missing_keys == [] and result.unexpected_keys == []
    # every loaded key holds the file's value on both sides
    mine = model.state_dict()
    theirs = port_state_dict(jax.device_get(jvars))
    for key, value in sd.items():
        if key.startswith("head."):
            continue
        assert np.array_equal(mine[key].numpy(), value), key
        assert np.array_equal(theirs[key].numpy(), value), key
    with torch.no_grad():
        model.head.weight.copy_(theirs["head.weight"])
        model.head.bias.copy_(theirs["head.bias"])
    x = np.random.RandomState(22).randn(1, 384, 384, 3).astype(np.float32)
    want_logits = np.asarray(jm.apply(jvars, x))
    with torch.no_grad():
        got_logits = model(nchw(x)).numpy()
    # f32 through a 4-level model on both sides
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4, rtol=1e-4)


def test_create_model_with_checkpoint_path(reference_file):
    path, _ = reference_file
    model = fvt.create_model("faster_vit_4_21k_384", device="cpu",
                             checkpoint_path=str(path), num_classes=10,
                             dtype=torch.bfloat16, **NARROW)
    assert isinstance(model, torch.nn.Module)
    plain = fvt.create_model("faster_vit_4_21k_384", device="cpu",
                             num_classes=10, **NARROW)
    load_checkpoint(plain, str(path))
    for (k, a), b in zip(model.state_dict().items(),
                         plain.state_dict().values()):
        assert torch.equal(a, b.to(a.dtype)), k
    with pytest.raises(ValueError, match="checkpoint_path"):
        fvt.create_model("faster_vit_0_224", device="cpu", pretrained=True)


@pytest.mark.parametrize("wrap", ["bare", "state_dict", "model", "ema",
                                  "module_prefix", "encoder_prefix"])
def test_normalize_state_dict_matches_jax(wrap):
    sd = {"a.weight": np.ones(2), "b.bias": np.zeros(3)}
    ckpt = {
        "bare": sd,
        "state_dict": {"state_dict": sd, "epoch": 3},
        "model": {"model": sd},
        "ema": {"state_dict_ema": {k: v + 1 for k, v in sd.items()},
                "state_dict": sd},
        "module_prefix": {"state_dict": {"module." + k: v
                                         for k, v in sd.items()}},
        "encoder_prefix": {"encoder." + k: v for k, v in sd.items()}
        | {"decoder.x": np.ones(1)},
    }[wrap]
    for use_ema in (False, True):
        got = normalize_state_dict(ckpt, use_ema=use_ema)
        want = jax_normalize_state_dict(ckpt, use_ema=use_ema)
        assert list(got) == list(want)
        assert all(np.array_equal(got[k], want[k]) for k in got)


def test_tokenizer_conv_loads_from_either_name():
    """faster_vit_0_224 has carrier tokens at level 2: its tokenizer conv
    is registered as pos_embed and as to_global_feature.pos; a file with
    only one of the names loads both."""
    src = fvt.create_model("faster_vit_0_224", device="cpu", **TINY,
                           generator=torch.Generator().manual_seed(1))
    for drop in ("pos_embed", "to_global_feature.pos"):
        sd = {k: v for k, v in src.state_dict().items()
              if f"global_tokenizer.{drop}." not in k}
        dst = fvt.create_model("faster_vit_0_224", device="cpu", **TINY)
        result = load_state_dict_lenient(dst, sd)
        assert result.missing_keys == [] and result.unexpected_keys == []
        for k, v in src.state_dict().items():
            assert torch.equal(dst.state_dict()[k], v), k


# --- CheckpointManager --------------------------------------------------

SAVES = [(1, 0.5), (2, 0.7), (3, 0.7), (4, 0.1), (5, 0.9), (6, 0.0),
         (7, 0.9)]


def _tiny_state():
    model = torch.nn.Sequential(torch.nn.Linear(3, 2),
                                torch.nn.BatchNorm1d(2))
    return create_train_state(model, TrainConfig())


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("hist", [1, 2, 3])
def test_retention_matches_orbax(tmp_path, hist, mode):
    orbax = OrbaxCheckpointManager(str(tmp_path / "orbax"), max_history=hist,
                                   metric_mode=mode)
    mine = CheckpointManager(str(tmp_path / "port"), max_history=hist,
                             metric_mode=mode)
    state = _tiny_state()
    for step, metric in SAVES:
        orbax.save(step, {"w": np.zeros(2, np.float32)}, metric=metric)
        orbax.wait()
        mine.save(step, state, metric=metric)
        assert mine.all_steps() == list(orbax._mngr.all_steps()), step
        assert mine.latest_step() == orbax.latest_step()
    orbax.close()


def _train(state, steps_fn, batches):
    return [steps_fn(state, b)["loss"].item() for b in batches]


def _flat(state):
    """Everything a checkpoint restores, as one dict of tensors."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v
                for k, v in state.ema_model.state_dict().items()})
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": torch.as_tensor(v) for k, v in s.items()})
    return out


def test_resume_continues_bit_for_bit(tmp_path):
    """4 steps in one run equal 2 steps, a save, a restore into a model
    with other random weights, and 2 more steps: losses, parameters, BN
    statistics, EMA and Adam's moments, on the CPU."""
    cfg = TrainConfig(mixup=MixupConfig(num_classes=10))
    rng = np.random.RandomState(5)
    batches = [{"image": rng.randn(4, 112, 112, 3).astype(np.float32),
                "label": rng.randint(0, 10, 4).astype(np.int32)}
               for _ in range(4)]
    sched = lambda t: 1e-3 * (t + 1)
    model = fvt.create_model("faster_vit_0_224", device="cpu", **TINY,
                             drop_path_rate=0.2)
    fresh = copy.deepcopy(model)
    step = make_train_step(cfg, sched, seed=6)
    whole = create_train_state(model, cfg)
    losses = _train(whole, step, batches)

    first = create_train_state(copy.deepcopy(fresh), cfg)
    losses_a = _train(first, step, batches[:2])
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(first.step, first, metric=1.0)
    other = fvt.create_model("faster_vit_0_224", device="cpu", **TINY,
                             drop_path_rate=0.2,
                             generator=torch.Generator().manual_seed(9))
    second, resumed = maybe_auto_resume(ckpt, create_train_state(other, cfg))
    assert resumed == 2 and second.step == 2
    losses_b = _train(second, step, batches[2:])
    assert losses_a + losses_b == losses
    a, b = _flat(whole), _flat(second)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_save_leaves_no_partial_file(tmp_path, monkeypatch):
    """A save that dies while writing leaves the previous checkpoints as
    they were and no file under a checkpoint's name."""
    ckpt = CheckpointManager(str(tmp_path), max_history=2)
    state = _tiny_state()
    ckpt.save(1, state, metric=1.0)

    def dying_save(obj, f, *a, **k):
        open(f, "wb").write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(OSError):
        ckpt.save(2, state, metric=2.0)
    assert ckpt.all_steps() == [1]
    assert not (tmp_path / "2.pt").exists()


def test_restore_without_checkpoint_returns_none(tmp_path):
    state = _tiny_state()
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_step() is None and ckpt.restore(state) is None
    same, step = maybe_auto_resume(ckpt, state)
    assert same is state and step is None


def test_auto_resume_disabled_leaves_state(tmp_path):
    state = _tiny_state()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(7, state)
    same, step = maybe_auto_resume(ckpt, state, enabled=False)
    assert same is state and step is None and state.step == 0


def test_recovery_interval(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), max_history=10,
                             recovery_interval=3)
    state = _tiny_state()
    for step in range(1, 8):
        ckpt.maybe_save_recovery(step, state)
    assert ckpt.all_steps() == [3, 6]


def test_save_and_restore_variables(tmp_path):
    src = fvt.create_model("faster_vit_0_224", device="cpu", **TINY,
                           generator=torch.Generator().manual_seed(3))
    save_variables(str(tmp_path / "w" / "fv0.pt"), src)
    dst = restore_variables(str(tmp_path / "w" / "fv0.pt"),
                            fvt.create_model("faster_vit_0_224",
                                             device="cpu", **TINY))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


# --- preemption ---------------------------------------------------------

def test_handler_latches_signal():
    h = PreemptionHandler(signals=(signal.SIGUSR1,)).install()
    try:
        assert not h.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.preempted
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGUSR1) is not h._on_signal


def test_checkpoint_and_exit_saves_then_exits_75(tmp_path):
    state = _tiny_state()
    state.step = 11
    ckpt = CheckpointManager(str(tmp_path))
    with pytest.raises(SystemExit) as exc:
        PreemptionHandler().checkpoint_and_exit(ckpt, state.step, state)
    assert exc.value.code == REQUEUE_EXIT_CODE == 75
    assert ckpt.latest_step() == 11


# --- the CLI ------------------------------------------------------------

def _cli(out, *extra):
    return train.main([
        "--model", "faster_vit_4_21k_384", "--model-kwargs", NARROW_JSON,
        "--device", "cpu", "--synthetic", "--num-classes", "10", "-b", "2",
        "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs", "0",
        "--data-len", "4", "--drop-path", "0.42", "--output", str(out),
        *extra])


def test_cli_fine_tunes_from_a_reference_checkpoint_and_resumes(
        reference_file, tmp_path, caplog):
    """--loadcheckpoint warm-starts (the 21841-class head kept at init with
    a warning), an epoch writes a checkpoint, and the same command run
    again restores it."""
    path, sd = reference_file
    out = tmp_path / "run"
    with caplog.at_level(logging.INFO):
        _cli(out, "--loadcheckpoint", str(path))
    assert re.search(r"shape-mismatched keys kept at init: head\.weight "
                     r"\(21841, 256\)->\(10, 256\)", caplog.text)
    ckpt = CheckpointManager(str(out / "checkpoints"))
    assert ckpt.all_steps() == [2]
    # the EMA copy is taken after the warm start: two steps at decay
    # 0.9998 leave it at the file's weights, not at the random init
    ema = torch.load(out / "checkpoints" / "2.pt",
                     weights_only=True)["ema_model"]
    for key in ("levels.2.blocks.0.attn.qkv.weight", "levels.0.blocks.0."
                "conv1.weight", "patch_embed.conv_down.0.weight"):
        np.testing.assert_allclose(ema[key].numpy(), sd[key], atol=1e-4,
                                   err_msg=key)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        _cli(out, "--loadcheckpoint", str(path), "--grad-checkpointing",
             "--checkpoint-hist", "2")
    assert "auto-resumed from checkpoint at step 2" in caplog.text
    assert ckpt.all_steps() == [2, 4]


def test_cli_resume_flag_restores_another_directory(tmp_path, caplog):
    first = tmp_path / "first"
    _cli(first)
    with caplog.at_level(logging.INFO):
        _cli(tmp_path / "second", "--resume", str(first / "checkpoints"))
    assert "resumed at step 2" in caplog.text
    assert CheckpointManager(str(tmp_path / "second" / "checkpoints")
                             ).all_steps() == [4]


def test_cli_no_auto_resume_starts_at_step_0(tmp_path, caplog):
    out = tmp_path / "run"
    _cli(out)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        _cli(out, "--no-auto-resume")
    assert "resumed" not in caplog.text
    assert CheckpointManager(str(out / "checkpoints")).all_steps() == [2]
