"""The port runs where jax is not installed: importing it, building a model,
running it live and baked and through the fused HAT block (ops.hat_block,
ops.cuda_hat_block), a long-window attention call, the weights bridge,
a train step with gradient checkpointing, a checkpoint saved and restored,
the detection modules (a tiny DINO detector built from a config file, run
and post-processed, the MSDA and box ops with the MSDA backward, the
evaluator, the weights bridge, the CLI, and detection training: the
engine's two-phase and fused steps with remat, the auction matcher and the
criterion; contrastive denoising and a padding mask through the
detector, the detection transforms, the COCO reader's modules), the
long-window attention probes (ops.attention_probes and
both probe modules, run with --device cpu), the MSDA gather probes
(ops.msda_probes with P4b-d, msda_pallas_probe, msda_packed_probe and
msda_packed_probe2, run with --device cpu), the turns probes of K6 and
of the MSDA gather probes' kernels (probes/hat_turns, msda_probe_turns,
imported), the tracking modules (fastervit_tpu_torch.tracking.*: one
tiny frame of the exact MOTRv2 loop, the submit CLI's arguments; the
training CLI and the DanceTrack and joint readers imported, one tiny clip
step through motr_clip_train_epoch; the tracking evaluation suite: every
benchmark adapter run through the Evaluator over the fixture trees under
tests/data, the runtime tracker, MOT-file evaluation and the tracking
tools), int8 serving (ops.quant, a quantised model run), the input
pipeline (data.imagenet, train_loader, cifar, randaugment, real_labels,
native), the validate CLI on --synthetic --device cpu with --int8, the
panoptic post-processing, the visualizer and the examples (detect
imported, track run), export (ops.library's operators; utils.export: a
program exported, saved and loaded, an ONNX graph run by
utils.onnx_eval, the export CLI on --device cpu; classify imported), data
parallelism (parallel.distributed, data_parallel, dryrun), a train step
with dropout, utils.timing (torch_trace) and utils.plot and chip_smoke.py
load no jax, jaxlib, flax or fastervit_tpu module; no module of the port
names the JAX package in an import."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import os, sys, tempfile, numpy as np, torch
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
from fastervit_tpu_torch.detection import engine, matcher_device
cfg.merge_from_dict({"use_checkpoint": True})
det = dino.build_dino_from_config(cfg, resolution=(64, 64), device="cpu")
assert det.transformer.use_checkpoint
state = engine.DetectionTrainState(det, engine.create_detection_optimizer(
    det, linear_proj_names=("sampling_offsets",), drop_step=1))
tgt = engine.targets_on(engine.pad_targets(
    [{"labels": [1], "boxes": [[0.5, 0.5, 0.2, 0.2]]}], 2), "cpu")
for make in (engine.make_detection_train_step,
             engine.make_fused_detection_train_step):
    m = make(ema_decay=0.9)(state, torch.zeros(1, 3, 64, 64), tgt)
    assert np.isfinite(m["loss"].item()) and state.ema_model is not None
assert state.step == 2
assert dino.criterion(det.eval()(torch.zeros(1, 3, 64, 64)),
                      [{"labels": [1], "boxes": [[0.5, 0.5, 0.2, 0.2]]}],
                      det.num_classes)["loss"].item() > 0
assert matcher_device.auction_match(torch.rand(5, 3),
                                    torch.ones(3, dtype=torch.bool)).shape == (3,)
from fastervit_tpu_torch.data import preprocess
from fastervit_tpu_torch.detection import coco_data, transforms
det = dino.build_dino_from_config(cfg, resolution=(64, 64), device="cpu",
                                  dn_labelbook_size=91).eval()
dn, meta = dino.prepare_cdn(torch.Generator().manual_seed(0), tgt,
                            det.num_classes, 5, dn_number=4)
x, pad = transforms.pad_to_canvas([np.zeros((64, 48, 3), np.float32)],
                                  (64, 64))
out = det(torch.from_numpy(x).permute(0, 3, 1, 2), dn=dn,
          pad_mask=torch.from_numpy(pad))
assert out["logits"][-1].shape[1] == meta["n_dn"] + 5
assert np.isfinite(dino.cdn_loss(out, tgt, meta,
                                 det.num_classes)["loss_dn"].item())
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
from fastervit_tpu_torch.tracking import (convert as motr_convert, mot_data,
                                          motr, motr_exact, submit)
from fastervit_tpu_torch.tracking import transformer as motr_transformer
mcfg = fvt.get_config("faster_vit_0_any_res", resolution=(64, 96),
                      depths=[1, 1, 1, 1], dim=16, in_dim=8,
                      num_heads=[1, 1, 2, 2])
mdet = motr_exact.MOTRDetectorExact(mcfg, dim=64, num_queries=2,
                                    enc_layers=1, dec_layers=1, ffn_dim=32)
mqim = motr_exact.QIMv2(64, 32)
motr_exact.init_weights(mdet, mqim, torch.Generator().manual_seed(0))
res = motr_exact.exact_inference_sequence(
    mdet.eval(), mqim.eval(), [np.zeros((64, 96, 3), np.float32)], 2, 64,
    [np.full((1, 5), 0.5, np.float32)], num_proposals=1, track_capacity=2,
    score_thresh=0.0)
assert len(res) == 1 and len(res[0]["ids"]) == 3
assert submit.parse_args(["--mot-path", "x"]).device == "cuda"
assert motr_convert.split_motr_state_dict({"track_embed.a": 1}) == ({},
                                                                   {"a": 1})
from fastervit_tpu_torch.tracking import dance_data, joint_data
from fastervit_tpu_torch.tracking import main as motr_cli
mdet = motr.MOTRDetector(mcfg, dim=64, num_detect_queries=2,
                         num_track_queries=2, num_proposal_queries=1,
                         enc_layers=1, dec_layers=1)
motr.init_weights(mdet, torch.Generator().manual_seed(0))
mstate = engine.DetectionTrainState(mdet, motr.create_motr_optimizer(mdet))
clip = next(motr_cli._synthetic_clips(1, 2, 64, 96, 1))
assert np.isfinite(motr.motr_clip_train_epoch(mstate, [clip])["loss"])
assert mstate.step == 1 and motr_cli.parse_args([]).device == "cuda"
assert dance_data.ID_OFFSET_PER_VIDEO == 100000 and joint_data.JointClips
from fastervit_tpu_torch.tracking import (benchmarks, davis, evaluator,
                                          metrics as track_metrics, mots,
                                          robmots, tao, tools, tracker, vis)
from fastervit_tpu_torch.utils import rle
D = "tests/data/"
specs = [("mot", "mot_mini/gt/mot_challenge",
          "mot_mini/trackers/mot_challenge",
          {"benchmark": "MINI", "split": "train"}),
         ("dancetrack", "mot_mini/gt/mot_challenge",
          "mot_mini/trackers/mot_challenge",
          {"benchmark": "MINI", "split": "train",
           "seq_info": {"seq01": None}}),
         ("head", "ht_mini/gt/mot_challenge", "ht_mini/trackers/mot_challenge",
          {"split": "train"}),
         ("kitti", "kitti_mini/gt", "kitti_mini/trackers", {}),
         ("bdd", "bdd_mini/gt", "bdd_mini/trackers", {}),
         ("mots", "mots_mini/gt/mot_challenge",
          "mots_mini/trackers/mot_challenge", {"split": "train"}),
         ("kitti_mots", "kitti_mots_mini/gt", "kitti_mots_mini/trackers", {}),
         ("davis", "davis_mini/gt", "davis_mini/trackers", {}),
         ("robmots", "robmots_mini/gt", "robmots_mini/trackers",
          {"sub_benchmark": "mots_challenge"}),
         ("robmots", "robmots_mini/gt", "robmots_mini/trackers",
          {"sub_benchmark": "tao"}),
         ("tao", "tao_mini/gt", "tao_mini/trackers", {}),
         ("ytvis", "ytvis_mini/gt", "ytvis_mini/trackers", {})]
sets = [(f"{k}{i}", evaluator.make_dataset(k, gt_folder=D + g,
                                           trackers_folder=D + t, **kw))
        for i, (k, g, t, kw) in enumerate(specs)]
with tempfile.TemporaryDirectory() as d:
    res, msgs = evaluator.Evaluator(evaluator.EvalConfig(
        print_results=False, time_progress=False,
        output_folder=d)).evaluate(sets)
assert all(m == "Success" for per in msgs.values() for m in per.values())
assert 0 < res["mot0"]["minitracker"]["COMBINED_SEQ"]["HOTA"] < 1
assert 0 <= res["davis7"]["minitracker"]["COMBINED_SEQ"]["J&F"] <= 1
frames = [{"boxes": np.asarray([[t, 0, t + 10, 10.]]),
           "scores": np.asarray([0.9]), "labels": np.zeros(1, int)}
          for t in range(3)]
out = tracker.track_sequence(frames)
assert [o["ids"].tolist() for o in out] == [[0], [0], [0]]
with tempfile.TemporaryDirectory() as d:
    mot_data.write_mot_file(d + "/t.txt", out)
    assert mot_data.evaluate_mot_files(d + "/t.txt", d + "/t.txt")[
        "HOTA"] > 0.99
    assert len(tools.merge_tracklets(open(d + "/t.txt").readlines())) == 3
    assert tools.build_det_db([d]) and rle.rle_encode(np.eye(3))
from fastervit_tpu_torch import validate
from fastervit_tpu_torch.ops import quant
from fastervit_tpu_torch.data import (cifar, imagenet, native, randaugment,
                                      real_labels, train_loader)
from fastervit_tpu_torch.detection import panoptic, visualizer
from fastervit_tpu_torch.examples import detect as detect_example
from fastervit_tpu_torch.examples import track as track_example
qm = fvt.create_model("faster_vit_0_224", device="cpu", depths=[1, 1, 1, 1],
                      dim=36, in_dim=20, num_heads=[2, 2, 4, 4],
                      resolution=64, num_classes=10, quantized=True).eval()
assert len(quant.int8_layers(qm)) > 10
with torch.no_grad():
    assert qm(torch.zeros(1, 3, 64, 64)).shape == (1, 10)
assert float(quant.quantile(torch.arange(5.0), 0.5)) == 2.0
assert fvt.freeze_stages(qm, 2) is qm
from PIL import Image
with tempfile.TemporaryDirectory() as d:
    os.makedirs(d + "/a")
    Image.fromarray(np.zeros((40, 50, 3), np.uint8)).save(d + "/a/0.jpg")
    cfg64 = fvt.get_config("faster_vit_0_224", resolution=64).data
    assert next(iter(imagenet.EvalLoader(d, cfg64, 2)))["valid"].sum() == 1
    assert next(iter(train_loader.TrainLoader(d, cfg64, 1)))[
        "image"].shape == (1, 64, 64, 3)
    res = validate.main(["--synthetic", "--device", "cpu", "--batch-size",
                         "2", "--int8", "--dtype", "float32"])
    assert res[0]["count"] == 16
    pan = panoptic.postprocess_panoptic(np.zeros((2, 3)), np.zeros((2, 4, 4)),
                                        {}, (4, 4))
    assert pan["png_string"].startswith(b"\\x89PNG")
    assert visualizer.COCOVisualizer().visualize(
        np.zeros((8, 8, 3), np.float32),
        {"boxes": np.asarray([[0.5, 0.5, 0.2, 0.2]]), "size": (8, 8)},
        savedir=d).endswith(".png")
    assert track_example.main(["--output", d])["frames"] == 10
from fastervit_tpu_torch.ops import library
from fastervit_tpu_torch.utils import export, onnx_eval, plot, timing
from fastervit_tpu_torch.parallel import data_parallel, distributed, dryrun
from fastervit_tpu_torch.examples import classify
from fastervit_tpu_torch.utils.metrics import update_summary
tm = fvt.create_model("faster_vit_0_224", device="cpu", depths=[1, 1, 1, 1],
                      dim=16, in_dim=8, num_heads=[1, 1, 2, 2], resolution=64,
                      num_classes=10, drop_rate=0.1, attn_drop_rate=0.1)
dcfg = TrainConfig(mixup=MixupConfig(num_classes=10))
dstate = create_train_state(tm, dcfg)
assert np.isfinite(make_train_step(dcfg, lambda t: 1e-3)(dstate, {
    "image": np.zeros((2, 64, 64, 3), np.float32),
    "label": np.array([1, 2], np.int32)})["loss"].item())
tm.eval()
x = torch.randn(3, 3, 64, 64)
with tempfile.TemporaryDirectory() as d, torch.no_grad():
    program = export.export_program(tm)
    assert str(library.window_mhsa_short.default) in str(program.graph)
    path = export.save_program(program, d + "/p.pt2")
    assert torch.equal(export.load_program(path).module()(x), tm(x))
    graph = export.export_onnx(tm, d + "/m.onnx")
    got = onnx_eval.run_onnx(graph, {"input": x.numpy()})["output"]
    assert np.abs(got - tm(x).numpy()).max() < 1e-4
    export.main(["--model", "faster_vit_0_224", "--format", "program",
                 "--batch", "1", "--device", "cpu", "--out", d + "/fv0.pt2"])
    with timing.torch_trace(d + "/trace"):
        tm(x)
    assert os.path.exists(d + "/trace/trace.json")
    update_summary(0, {"loss": 1.0}, {"top1": 2.0}, d + "/s.csv", True)
    plot.plot_summaries([d + "/s.csv"], output=d + "/s.png")
assert distributed.initialize(device="cpu")["process_count"] == 1
assert data_parallel.local_slice({"a": np.arange(4)}, 1, 2)["a"].tolist() == \
    [2, 3]
assert dryrun.GLOBAL_BATCH and classify.main
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


def test_port_sources_import_nothing_of_the_jax_package():
    """An import of the JAX package hidden in a function body loads jax
    only when that function runs; no source of the port, nor
    chip_smoke.py, has one."""
    import re
    pattern = re.compile(r"^\s*(from|import)\s+(fastervit_tpu|jax|jaxlib|"
                         r"flax)(\.|\s|$)", re.M)
    sources = sorted((REPO / "fastervit_tpu_torch").rglob("*.py"))
    assert len(sources) > 50
    for path in sources + [REPO / "chip_smoke.py"]:
        hits = [m.group(0).strip() for m in pattern.finditer(
            path.read_text())]
        assert not hits, (path, hits)


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



def test_msda_off_the_cpu_never_takes_the_plain_backward(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain MSDA
    backward: on the card the autograd function's backward launches K7
    (tests/test_torch_cuda_msda_bwd.py), on any other device it raises."""
    import pytest
    import torch
    from fastervit_tpu_torch.ops import msda

    def refuse(*args, **kwargs):
        raise AssertionError("the plain backward ran off the CPU")

    monkeypatch.setattr(msda, "msda_backward_reference", refuse)
    monkeypatch.setattr(msda, "msda_reference", refuse)
    shapes = ((2, 3),)
    value = torch.zeros(1, 6, 2, 4, device="meta")
    loc = torch.zeros(1, 5, 2, 1, 2, 2, device="meta")
    w = torch.zeros(1, 5, 2, 1, 2, device="meta")

    class Ctx:
        saved_tensors = (value, loc, w)

    Ctx.shapes = shapes
    with pytest.raises(NotImplementedError, match="no path"):
        msda.MSDeformAttnFunction.backward(
            Ctx(), torch.zeros(1, 5, 8, device="meta"))
    with pytest.raises(NotImplementedError, match="no path"):
        msda.ms_deform_attn(value.requires_grad_(), shapes, loc, w)
