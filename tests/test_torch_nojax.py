"""The port runs where jax is not installed: importing it, building a model
and running it load no jax, jaxlib or flax module."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import sys, torch
import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.utils.convert import state_dict_from_jax
torch.set_num_threads(1)
m = fvt.create_model("faster_vit_0_224", depths=[1, 1, 1, 1], dim=16,
                     in_dim=8, num_heads=[1, 1, 2, 2], resolution=64,
                     num_classes=10).eval()
with torch.no_grad():
    assert m(torch.zeros(1, 3, 64, 64)).shape == (1, 10)
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
