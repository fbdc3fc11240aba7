"""The port's TrackEval-style Evaluator and its CLI (fastervit_tpu_torch/
tracking/evaluator.py) and the tracking tools (tracking/tools.py) against
their JAX-package originals: the Evaluator, serial and over a process
pool, over the MOT, KITTI and DAVIS fixtures; the output tree it writes;
error isolation; the CLI in a subprocess on mot_mini against JAX's
evaluator.main in this process; merge_tracklets, build_det_db and
visualize_tracks.

Tolerance: rtol 1e-12, atol 0 (tests/track_parity.py): both sides run the
same numpy code, so equality is expected; written files (summary.json, the
detailed CSVs, stitched tracklets, JPEG frames) are compared byte for
byte."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from fastervit_tpu.tracking import evaluator as jax_evaluator
from fastervit_tpu.tracking import tools as jax_tools
from fastervit_tpu_torch.tracking import evaluator, tools
from track_parity import assert_tree_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
MOT_GT = os.path.join(DATA, "mot_mini", "gt", "mot_challenge")
MOT_TRK = os.path.join(DATA, "mot_mini", "trackers", "mot_challenge")
KITTI = os.path.join(DATA, "kitti_mini")
DAVIS = os.path.join(DATA, "davis_mini")
SPECS = [
    ("MOT-MINI", "mot", {"gt_folder": MOT_GT, "trackers_folder": MOT_TRK,
                         "benchmark": "MINI", "split": "train"}),
    ("KITTI-MINI", "kitti", {"gt_folder": os.path.join(KITTI, "gt"),
                             "trackers_folder": os.path.join(KITTI,
                                                             "trackers")}),
    ("DAVIS-MINI", "davis", {"gt_folder": os.path.join(DAVIS, "gt"),
                             "trackers_folder": os.path.join(DAVIS,
                                                             "trackers")}),
]


def datasets(module):
    return [(name, module.make_dataset(kind, **kw))
            for name, kind, kw in SPECS]


def quiet(module, **kw):
    return module.EvalConfig(print_results=False, time_progress=False, **kw)


def tree_files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.fixture(scope="module")
def jax_sweep(tmp_path_factory):
    """JAX's serial sweep over the three fixtures: (results, messages,
    the output tree's files)."""
    out = str(tmp_path_factory.mktemp("jax_sweep"))
    res, msgs = jax_evaluator.Evaluator(quiet(
        jax_evaluator, use_parallel=False, output_folder=out)).evaluate(
        datasets(jax_evaluator))
    return res, msgs, tree_files(out)


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["serial", "parallel"])
def test_sweep_matches_jax(parallel, jax_sweep, tmp_path):
    sets = datasets(evaluator)
    assert all(type(ds).__module__.startswith("fastervit_tpu_torch.")
               for _, ds in sets)
    res, msgs = evaluator.Evaluator(quiet(
        evaluator, use_parallel=parallel, num_parallel_cores=2,
        output_folder=str(tmp_path))).evaluate(sets)
    want, want_msgs, want_files = jax_sweep
    assert msgs == want_msgs
    assert_tree_equal(res, want)
    got_files = tree_files(str(tmp_path))
    assert set(got_files) == set(want_files)
    assert "MOT-MINI/minitracker_detailed.csv" in got_files
    for name in got_files:
        assert got_files[name] == want_files[name], name


def test_error_isolation_matches_jax():
    got = evaluator.Evaluator(quiet(
        evaluator, break_on_error=False)).evaluate(
        datasets(evaluator), trackers=["minitracker", "missing"])
    want = jax_evaluator.Evaluator(quiet(
        jax_evaluator, break_on_error=False)).evaluate(
        datasets(jax_evaluator), trackers=["minitracker", "missing"])
    assert got[1] == want[1]
    for name, _, _ in SPECS:
        assert got[1][name]["minitracker"] == "Success"
        assert got[1][name]["missing"] != "Success"
        assert got[0][name]["missing"] is None
    assert_tree_equal(got[0], want[0])
    with pytest.raises(FileNotFoundError):
        evaluator.Evaluator(quiet(evaluator)).evaluate(
            datasets(evaluator)[:1], trackers=["missing"])


def test_make_dataset_covers_every_kind():
    kinds = set(evaluator.DATASET_KINDS) | set(evaluator._lazy_kinds())
    assert kinds == {"mot", "dancetrack", "head", "kitti", "bdd", "mots",
                     "kitti_mots", "tao", "ytvis", "davis", "robmots"}
    for kind, cls in evaluator._lazy_kinds().items():
        assert cls.__module__.startswith("fastervit_tpu_torch.tracking."), \
            kind
    with pytest.raises(KeyError, match="unknown dataset kind"):
        evaluator.make_dataset("nope")


def test_cli_matches_jax_main(tmp_path, capsys):
    spec = (f"kind=mot,name=MOT-MINI,benchmark=MINI,split=train,"
            f"gt_folder={MOT_GT},trackers_folder={MOT_TRK}")
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    proc = subprocess.run(
        [sys.executable, "-m", "fastervit_tpu_torch.tracking.evaluator",
         "--dataset", spec, "--output", str(port_out)], cwd=REPO,
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert jax_evaluator.main(["--dataset", spec, "--output",
                               str(jax_out)]) == 0
    want_stdout = capsys.readouterr().out
    # the summary lines; the progress lines carry each run's own seconds
    summary = [line for line in want_stdout.splitlines()
               if not line.startswith("[")]
    assert [line for line in proc.stdout.splitlines()
            if not line.startswith("[")] == summary
    assert "HOTA=" in proc.stdout
    assert tree_files(str(port_out)) == tree_files(str(jax_out))
    assert set(tree_files(str(port_out))) == {
        "MOT-MINI/summary.json", "MOT-MINI/minitracker_detailed.csv"}
    summary_json = json.loads((port_out / "MOT-MINI" /
                               "summary.json").read_text())
    assert abs(summary_json["minitracker"]["COMBINED_SEQ"]["HOTA"]
               - 0.613790) < 1e-5


def _row(frame, tid, x=10.0, y=10.0, w=5.0, h=5.0):
    return f"{frame},{tid},{x},{y},{w},{h},1,-1,-1,-1\n"


MERGE_CASES = {
    "gap_merged": [_row(t, 1) for t in range(1, 11)]
    + [_row(t, 2) for t in range(60, 70)],
    "gap_below_t_min": [_row(t, 1) for t in range(1, 11)]
    + [_row(t, 2) for t in range(15, 25)],
    "gap_above_t_max": [_row(t, 1) for t in range(1, 11)]
    + [_row(t, 2) for t in range(510, 520)],
    "ambiguous": [_row(t, 1) for t in range(1, 11)]
    + [_row(t, 3) for t in range(1, 13)]
    + [_row(t, 2) for t in range(60, 70)],
    "chain": [_row(t, 4) for t in range(1, 6)]
    + [_row(t, 5) for t in range(40, 45)]
    + [_row(t, 6) for t in range(80, 90)],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_tracklets_matches_jax(case):
    lines = MERGE_CASES[case]
    got = tools.merge_tracklets(lines)
    assert got == jax_tools.merge_tracklets(lines)
    assert len(got) == len(lines)
    assert (tools.merge_tracklets(lines, t_min=2, t_max=30)
            == jax_tools.merge_tracklets(lines, t_min=2, t_max=30))


def test_merge_dir_and_det_db_match_jax(tmp_path):
    res = tmp_path / "results"
    res.mkdir()
    for name, lines in MERGE_CASES.items():
        (res / f"{name}.txt").write_text("".join(lines))
    tools.merge_tracklet_dir(str(res), str(tmp_path / "port"))
    jax_tools.merge_tracklet_dir(str(res), str(tmp_path / "jax"))
    got = tree_files(str(tmp_path / "port"))
    assert got == tree_files(str(tmp_path / "jax")) and len(got) == 5

    d = tmp_path / "props" / "val" / "seq01" / "img1"
    d.mkdir(parents=True)
    (d / "00000001.txt").write_text("1,2,3,4,0.9\n")
    (d / "00000002.txt").write_text("5,6,7,8,0.8\n2,3,4,5,0.7\n")
    (d / "notes.md").write_text("skipped\n")
    root = [str(tmp_path / "props")]
    db = tools.build_det_db(root, output=str(tmp_path / "port.json"))
    assert db == jax_tools.build_det_db(root,
                                        output=str(tmp_path / "jax.json"))
    assert len(db) == 2
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())


def test_visualize_tracks_writes_the_same_jpegs(tmp_path):
    rng = np.random.RandomState(0)
    frames = []
    for i in range(1, 4):
        p = tmp_path / f"frame{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (64, 96, 3), np.uint8)).save(p)
        frames.append(str(p))
    trk = tmp_path / "trk.txt"
    trk.write_text("".join([_row(1, 3, 10, 10, 30, 30),
                            _row(2, 3, 14, 12, 30, 30),
                            _row(2, 8, 50, 20, 20, 25),
                            _row(3, 3, 18, 14, 30, 30)]))
    det_db = {os.path.splitext(frames[1])[0] + ".txt": ["40,5,20,20,0.9\n"]}
    got = tools.visualize_tracks(str(trk), frames, str(tmp_path / "port"),
                                 det_db=det_db)
    want = jax_tools.visualize_tracks(str(trk), frames,
                                      str(tmp_path / "jax"), det_db=det_db)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] and len(got) == 3
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    drawn = np.asarray(Image.open(got[1]), float)
    plain = np.asarray(Image.open(frames[1]), float)
    assert np.abs(drawn - plain).max() > 50          # boxes were drawn
