"""The port runs where jax is not installed: importing it, building a model,
running it live and baked, a long-window attention call, the weights bridge
and a train step load no jax, jaxlib or flax module."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import sys, numpy as np, torch
import fastervit_tpu_torch as fvt
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
    assert window_mhsa(torch.zeros(1, 144, 3 * 98), torch.zeros(2, 144, 144),
                       2, 0.1).shape == (1, 144, 98)
    q = torch.zeros(1, 2, 144, 49)
    assert bias_attention(q, q, q, torch.zeros(2, 144, 144), 0.1).shape == \
        q.shape
assert baked_from_jax({"params": {}}) == {}
cfg = TrainConfig(mixup=MixupConfig(num_classes=10))
step = make_train_step(cfg, lambda t: 1e-3)
batch = {"image": np.zeros((2, 64, 64, 3), np.float32),
         "label": np.array([1, 2], np.int32)}
assert np.isfinite(step(create_train_state(m, cfg), batch)["loss"].item())
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
