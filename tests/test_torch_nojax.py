"""The port runs where jax is not installed: importing it, building a model,
running it live and baked and through the fused HAT block (ops.hat_block,
ops.cuda_hat_block), a long-window attention call, the weights bridge,
a train step with gradient checkpointing, a checkpoint saved and restored,
the detection modules (a tiny DINO detector built from a config file, run
and post-processed, the MSDA and box ops, the evaluator, the weights bridge
and the CLI), the long-window attention probes (ops.attention_probes and
both probe modules, run with --device cpu), the MSDA gather probes
(ops.msda_probes with P4b-d, msda_pallas_probe, msda_packed_probe and
msda_packed_probe2, run with --device cpu), the turns probes of K6 and
of the MSDA gather probes' kernels (probes/hat_turns, msda_probe_turns,
imported) and chip_smoke.py load no jax,
jaxlib, flax or fastervit_tpu module."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import sys, tempfile, numpy as np, torch
import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.utils.checkpoint import CheckpointManager
from fastervit_tpu_torch.utils.preemption import PreemptionHandler
from fastervit_tpu_torch.ops.attention import bias_attention, window_mhsa
from fastervit_tpu_torch.utils.convert import (baked_from_jax, load_baked,
                                               state_dict_from_jax)
from fastervit_tpu_torch.train import train
from fastervit_tpu_torch.train.mixup import MixupConfig
from fastervit_tpu_torch.train.steps import (TrainConfig, create_train_state,
                                             make_train_step)
torch.set_num_threads(1)
m = fvt.create_model("faster_vit_0_224", device="cpu", depths=[1, 1, 1, 1],
                     dim=16, in_dim=8, num_heads=[1, 1, 2, 2], resolution=64,
                     num_classes=10).eval()
with torch.no_grad():
    assert m(torch.zeros(1, 3, 64, 64)).shape == (1, 10)
    assert fvt.bake_posemb(m)(torch.zeros(1, 3, 64, 64)).shape == (1, 10)
    from fastervit_tpu_torch.ops import cuda_hat_block, hat_block
    prev = fvt.set_fused_hat(True)
    assert m(torch.zeros(1, 3, 64, 64)).shape == (1, 10)
    fvt.set_fused_hat(prev)
    assert window_mhsa(torch.zeros(1, 144, 3 * 98), torch.zeros(2, 144, 144),
                       2, 0.1).shape == (1, 144, 98)
    q = torch.zeros(1, 2, 144, 49)
    assert bias_attention(q, q, q, torch.zeros(2, 144, 144), 0.1).shape == \
        q.shape
assert baked_from_jax({"params": {}}) == {}
cfg = TrainConfig(mixup=MixupConfig(num_classes=10), grad_checkpoint=True)
step = make_train_step(cfg, lambda t: 1e-3)
batch = {"image": np.zeros((2, 64, 64, 3), np.float32),
         "label": np.array([1, 2], np.int32)}
state = create_train_state(m, cfg)
assert np.isfinite(step(state, batch)["loss"].item())
with tempfile.TemporaryDirectory() as d:
    CheckpointManager(d).save(state.step, state, metric=1.0)
    assert CheckpointManager(d).restore(state) is state and state.step == 1
assert not PreemptionHandler().preempted
import chip_smoke
from fastervit_tpu_torch.probes import hat_turns, msda_probe_turns
from fastervit_tpu_torch.detection import (coco_eval, convert, dino,
                                           transformer)
from fastervit_tpu_torch.detection import main as detection_cli
from fastervit_tpu_torch.ops import boxes, msda
from fastervit_tpu_torch.utils.pyconfig import PyConfig
cfg = PyConfig.fromfile("configs/dino/dino_4scale_faster_vit_0_224.py")
cfg.merge_from_dict({"backbone_overrides": {"depths": [1, 1, 1, 1],
                                            "dim": 16, "in_dim": 8,
                                            "num_heads": [1, 1, 2, 2]},
                     "hidden_dim": 64, "num_queries": 5, "enc_layers": 1,
                     "dec_layers": 1})
det = dino.build_dino_from_config(cfg, resolution=(64, 64),
                                  device="cpu").eval()
with torch.no_grad():
    post = dino.postprocess(det(torch.zeros(1, 3, 64, 64)),
                            torch.tensor([[64, 64]]), num_select=5)
assert post["boxes"].shape == (1, 5, 4)
assert boxes.box_iou(post["boxes"][0], post["boxes"][0])[0].shape == (5, 5)
assert detection_cli.parse_args(["--config", "c.py", "--eval"]).eval
from fastervit_tpu_torch.ops import attention_probes
from fastervit_tpu_torch.probes import attn_online_probe, attn_vpu_probe
q = torch.zeros(1, 2, 32, 8)
assert attention_probes.online_attention(q, q, q, torch.zeros(2, 32, 32), 0.1,
                                         4).shape == q.shape
tiny = ["--device", "cpu", "--batch", "2", "--seq", "32", "--heads", "2"]
assert attn_online_probe.main(tiny)["online_c2"]["maxdiff_vs_shipped"] < 1e-2
assert attn_vpu_probe.main(tiny)["flash_nobias"]["ms"] is None
from fastervit_tpu_torch.ops import msda_probes
from fastervit_tpu_torch.probes import msda_packed_probe, msda_pallas_probe
case = msda_probes.sample_case(5, 6, 8, 2, 4, torch.Generator(), "cpu")
assert msda_probes.fused_gather_p4(*case, 4).shape == (2, 2, 4)
from fastervit_tpu_torch.probes import msda_packed_probe2
assert msda_probes.pair_staticr(case[0].bfloat16(), *case[1:], 4).shape == \
    (2, 2, 4)
pm, fl = msda_probes.pack_corners(case[0]), case[1] * 5 + case[2]
assert msda_probes.packed_coeff(pm, fl, *msda_probes.coeff_scalars(
    *case[3:]), 4).shape == (2, 2, 4)
assert msda_probes.packed_wide(pm, fl, msda_probes.coeff_wide(*case[3:], 4),
                               4).shape == (2, 2, 16)
for probe in (msda_pallas_probe, msda_packed_probe, msda_packed_probe2):
    assert max(probe.main(["--device", "cpu"])[
        "correctness_max_err"].values()) < 1e-4
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "fastervit_tpu"))
print("LOADED", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_fused_hat_block_off_the_cpu_never_takes_the_plain_version(
        monkeypatch):
    """A tensor that is not on the CPU never reaches hat_block_reference:
    on the card it launches K6 (tests/test_torch_cuda_hat_block.py), on
    any other device it raises."""
    import pytest
    import torch
    from fastervit_tpu_torch.ops import hat_block

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(hat_block, "hat_block_reference", refuse)
    c = 8
    params = {k: torch.zeros((3 * c, c) if k == "qkv_w" else (3 * c,)
                             if k == "qkv_b" else (c, c) if k in (
                                 "proj_w", "fc1_w", "fc2_w") else (c,),
                             device="meta") for k in hat_block.PARAM_ORDER}
    x = torch.zeros(2, 4, c, device="meta")
    with pytest.raises(NotImplementedError, match="no path"):
        hat_block.fused_hat_block(x, params, torch.zeros(1, 4, 4), 1, 0.1)

