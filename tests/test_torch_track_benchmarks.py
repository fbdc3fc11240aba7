"""The port's TrackEval benchmark adapters (fastervit_tpu_torch/tracking/
benchmarks.py, mots.py, davis.py, robmots.py, tao.py, vis.py) against
their JAX-package originals over the fixture trees under tests/data/*_mini:
every adapter's whole result tree, the detailed CSVs it writes, its
per-sequence data, and the golden CSV of the MOT fixture.

Tolerance: rtol 1e-12, atol 0 (tests/track_parity.py): both sides run the
same numpy code, so equality is expected; the written CSVs are compared
byte for byte. The golden CSV holds 6 decimals, so it is held to 1e-4 as
tests/test_benchmarks.py holds the JAX adapter."""
import importlib
import os

import numpy as np
import pytest

from track_parity import assert_tree_equal

DATA = os.path.join(os.path.dirname(__file__), "data")


def _p(*parts):
    return os.path.join(DATA, *parts)


# (id, module, class, positional args, keyword args): every adapter over
# the fixture trees, as tests/test_*benchmark*.py build them
CASES = [
    ("mot", "benchmarks", "MOTChallengeDataset",
     (_p("mot_mini", "gt", "mot_challenge"),
      _p("mot_mini", "trackers", "mot_challenge")),
     {"benchmark": "MINI", "split": "train"}),
    ("mot_no_preproc", "benchmarks", "MOTChallengeDataset",
     (_p("mot_mini", "gt", "mot_challenge"),
      _p("mot_mini", "trackers", "mot_challenge")),
     {"benchmark": "MINI", "split": "train", "do_preproc": False}),
    ("dancetrack", "benchmarks", "DanceTrackDataset",
     (_p("mot_mini", "gt", "mot_challenge"),
      _p("mot_mini", "trackers", "mot_challenge")),
     {"benchmark": "MINI", "split": "train",
      "seq_info": {"seq01": None, "seq02": 15}}),
    ("head", "benchmarks", "HeadTrackingDataset",
     (_p("ht_mini", "gt", "mot_challenge"),
      _p("ht_mini", "trackers", "mot_challenge")), {"split": "train"}),
    ("kitti", "benchmarks", "KITTI2DBoxDataset",
     (_p("kitti_mini", "gt"), _p("kitti_mini", "trackers")), {}),
    ("bdd", "benchmarks", "BDD100KDataset",
     (_p("bdd_mini", "gt"), _p("bdd_mini", "trackers")),
     {"classes": ("car", "pedestrian", "rider")}),
    ("mots", "mots", "MOTSChallengeDataset",
     (_p("mots_mini", "gt", "mot_challenge"),
      _p("mots_mini", "trackers", "mot_challenge")), {"split": "train"}),
    ("kitti_mots", "mots", "KITTIMOTSDataset",
     (_p("kitti_mots_mini", "gt"), _p("kitti_mots_mini", "trackers")), {}),
    ("davis", "davis", "DAVISDataset",
     (_p("davis_mini", "gt"), _p("davis_mini", "trackers")), {}),
    ("robmots_mots", "robmots", "RobMOTSDataset",
     (_p("robmots_mini", "gt"), _p("robmots_mini", "trackers"),
      "mots_challenge"), {}),
    ("robmots_tao", "robmots", "RobMOTSDataset",
     (_p("robmots_mini", "gt"), _p("robmots_mini", "trackers"), "tao"), {}),
    ("tao", "tao", "TAODataset",
     (_p("tao_mini", "gt"), _p("tao_mini", "trackers")), {}),
    ("ytvis", "vis", "YouTubeVISDataset",
     (_p("ytvis_mini", "gt"), _p("ytvis_mini", "trackers")), {}),
]


def build(package: str, case):
    _, module, cls, args, kwargs = case
    mod = importlib.import_module(f"{package}.tracking.{module}")
    return getattr(mod, cls)(*args, **kwargs)


def files(folder):
    return {n: open(os.path.join(folder, n), "rb").read()
            for n in sorted(os.listdir(folder))}


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """Each case's JAX result tree and the files its evaluate writes, once
    for the module."""
    out = {}
    for case in CASES:
        folder = str(tmp_path_factory.mktemp(f"jax_{case[0]}"))
        res = build("fastervit_tpu", case).evaluate(output_folder=folder)
        out[case[0]] = (res, files(folder))
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_adapter_matches_jax(case, jax_results, tmp_path):
    ds = build("fastervit_tpu_torch", case)
    assert type(ds).__module__.startswith("fastervit_tpu_torch.")
    res = ds.evaluate(output_folder=str(tmp_path))
    want, want_files = jax_results[case[0]]
    assert_tree_equal(res, want, case[0])
    got_files = files(str(tmp_path))
    assert got_files == want_files and got_files


@pytest.mark.parametrize("case", [c for c in CASES if c[2] in (
    "MOTChallengeDataset", "DanceTrackDataset", "HeadTrackingDataset")],
    ids=lambda c: c[0])
def test_mot_family_sequence_data_matches_jax(case):
    ds, ref = build("fastervit_tpu_torch", case), build("fastervit_tpu", case)
    assert ds.seq_list == ref.seq_list and ds.seq_lengths == ref.seq_lengths
    for tracker in ds.tracker_list:
        for seq in ds.seq_list:
            assert_tree_equal(ds.sequence_data(tracker, seq),
                              ref.sequence_data(tracker, seq), seq)


def test_mot_adapter_reproduces_golden_csv():
    from fastervit_tpu_torch.tracking.benchmarks import (MOTChallengeDataset,
                                                         read_detailed_csv)
    case = CASES[0]
    res = MOTChallengeDataset(*case[3], **case[4]).evaluate()["minitracker"]
    golden = read_detailed_csv(_p("mot_mini", "golden_mini_detailed.csv"))
    assert set(golden) == {"seq01", "seq02", "COMBINED_SEQ"}
    checked = 0
    for seq, want in golden.items():
        for field, val in want.items():
            assert abs(float(res[seq][field]) - val) < 1e-4, (seq, field)
            checked += 1
    assert checked >= 3 * 18
    assert abs(res["COMBINED_SEQ"]["HOTA"] - 0.613790) < 1e-5


def test_combine_and_class_average_match_jax():
    from fastervit_tpu.tracking import benchmarks as jax_b
    from fastervit_tpu_torch.tracking import benchmarks as b
    rng = np.random.RandomState(0)
    seqs = []
    for k in range(3):
        n = rng.randint(1, 4)
        seqs.append({"num_gt_ids": n, "num_tracker_ids": n + 1,
                     "num_gt_dets": 2 * n, "num_tracker_dets": 2 * n + 2,
                     "gt_ids": [np.arange(n)] * 2,
                     "tracker_ids": [np.arange(n + 1)] * 2,
                     "similarity_scores": [rng.rand(n, n + 1)] * 2})
    assert_tree_equal(b.combine_sequence_data(seqs),
                      jax_b.combine_sequence_data(seqs))
    per_cls = {c: {"COMBINED_SEQ": {"HOTA": rng.rand(), "MOTA": rng.rand()}}
               for c in ("car", "pedestrian", "rider")}
    for classes in (None, ("car", "rider", "bus")):
        assert_tree_equal(b.class_averaged(per_cls, classes=classes),
                          jax_b.class_averaged(per_cls, classes=classes))


def test_detailed_csv_round_trips_across_packages(tmp_path):
    from fastervit_tpu.tracking import benchmarks as jax_b
    from fastervit_tpu_torch.tracking import benchmarks as b
    per_seq = {"s1": {"HOTA": 0.25, "IDSW": 3}, "COMBINED_SEQ":
               {"HOTA": 1 / 3, "IDSW": 7}}
    b.write_detailed_csv(str(tmp_path / "port.csv"), per_seq)
    jax_b.write_detailed_csv(str(tmp_path / "jax.csv"), per_seq)
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())
    assert (b.read_detailed_csv(str(tmp_path / "jax.csv"))
            == jax_b.read_detailed_csv(str(tmp_path / "port.csv")))


def test_davis_max_det_refuses_as_jax():
    from fastervit_tpu.tracking.davis import DAVISDataset as JaxDAVIS
    from fastervit_tpu_torch.tracking.davis import DAVISDataset
    args = (_p("davis_mini", "gt"), _p("davis_mini", "trackers"))
    msgs = []
    for cls in (DAVISDataset, JaxDAVIS):
        with pytest.raises(ValueError, match="MAX_DETECTIONS") as err:
            cls(*args, max_det=1).evaluate()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("module,fn", [("davis", "seg2bmap"),
                                       ("davis", "boundary_f")])
def test_davis_boundary_helpers_match_jax(module, fn):
    port = getattr(importlib.import_module(
        f"fastervit_tpu_torch.tracking.{module}"), fn)
    ref = getattr(importlib.import_module(
        f"fastervit_tpu.tracking.{module}"), fn)
    rng = np.random.RandomState(3)
    for _ in range(3):
        a = rng.rand(30, 41) < 0.4
        b = np.roll(a, 2, axis=1) | (rng.rand(30, 41) < 0.05)
        if fn == "seg2bmap":
            np.testing.assert_array_equal(port(a), ref(a))
        else:
            assert port(a, b) == ref(a, b)
