"""Fixtures of the benchmark's own tests: a throwaway checkout in a
temporary directory that holds the harness, a small configuration, a
traffic mix, a cell and a per-layer metric of its own, run on the CPU.

Run them with `python -m pytest h100bench -q`; the tests marked `cuda`
need a card and skip without one."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# FasterViT-0's layout at small widths: carriers at level 2 (a 14x14 map
# in 7x7 windows), depth 2 there so carriers pass between blocks
TINY_CONFIG = {
    "name": "tiny_fv0", "source": "test", "registry_name": "faster_vit_0_224",
    "depths": [1, 1, 2, 1], "num_heads": [1, 2, 2, 4],
    "window_size": [7, 7, 7, 7], "ct_size": 2, "dim": 16, "in_dim": 8,
    "mlp_ratio": 4.0, "resolution": 224, "drop_path_rate": 0.2,
    "in_chans": 3, "num_classes": 10, "qkv_bias": True, "qk_scale": None,
    "drop_rate": 0.0, "attn_drop_rate": 0.0, "layer_scale": 1e-5,
    "layer_scale_conv": None, "layer_norm_last": False,
    "hat": [False, False, True, False], "do_propagation": True,
    "reduced": [], "assumed": []}
TINY_TRAFFIC = {"mode": "serve", "why": "test", "dtype": "float32",
                "baked": True, "batch": 3, "in_flight": 2, "pool": 2,
                "warmup_batches": 1, "trace_batches": 2,
                "reference_rows": 2}
TINY_TRAIN = {"mode": "train", "why": "test", "dtype": "float32",
              "batch": 4, "in_flight": 2, "pool": 4, "compared_steps": 3,
              "trace_batches": 1, "lr": 1e-3, "weight_decay": 0.05,
              "clip_grad": 5.0, "ema_decay": 0.9998}
# float32 on both sides on the CPU: only the order of sums differs
TINY_LIMIT = 1e-4
TINY_TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "delta_gap": 1e-3}
TINY_METRIC = '''"""batches_done: batches that finished in the window."""
LAYER = "loop (host)"
UNIT = "batches"
MOVES = "serve_img_per_s"


def read(record):
    return float(len(record.batches))
'''


def make_checkout(tmp: Path) -> Path:
    """A copy of the harness with a new configuration, traffic mix, cell
    and per-layer metric, added as files and BENCHMARK.json entries."""
    shutil.copytree(REPO / "h100bench", tmp / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    b = tmp / "h100bench"
    (b / "configs" / "tiny_fv0.json").write_text(json.dumps(TINY_CONFIG))
    (b / "traffic" / "tiny_serve.json").write_text(json.dumps(TINY_TRAFFIC))
    (b / "workloads" / "tiny_fv0.tiny_serve.json").write_text(
        json.dumps({"limits": {"logit_gap": TINY_LIMIT}}))
    (b / "metrics" / "batches_done.serve.py").write_text(TINY_METRIC)
    (b / "traffic" / "tiny_train.json").write_text(json.dumps(TINY_TRAIN))
    (b / "workloads" / "tiny_fv0.tiny_train.json").write_text(
        json.dumps({"limits": TINY_TRAIN_LIMITS}))
    bench["configs"].append({"name": "tiny_fv0", "source": "test",
                             "file": "h100bench/configs/tiny_fv0.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_fv0.tiny_serve",
                               "config": "tiny_fv0", "traffic": "tiny_serve",
                               "chips": 1, "why": "test"})
    bench["workloads"].append({"name": "tiny_fv0.tiny_train",
                               "config": "tiny_fv0", "traffic": "tiny_train",
                               "chips": 1, "why": "test"})
    # the new cells join the metrics of their kind of loop
    for m in bench["end_to_end"] + bench["per_layer"]:
        for kind in ("serve", "train"):
            if "workloads" in m and kind in m["name"]:
                m["workloads"].append(f"tiny_fv0.tiny_{kind}")
    bench["per_layer"].append({"name": "batches_done.serve",
                               "unit": "batches", "better": "higher",
                               "source": "program_counter",
                               "layer": "loop (host)",
                               "moves": "serve_img_per_s"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path)


@pytest.fixture
def cpu_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
