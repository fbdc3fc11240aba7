"""The port's MOTR clip training against fastervit_tpu's on the CPU, on the
JAX package's own MOTRDetector at test_torch_motr.py's narrow widths
(faster_vit_0_any_res with depths [1, 1, 1, 1], dim 32, at 64x96; a
64-wide transformer of 1 encoder and 2 decoder layers; 3 track, 2
proposal and 4 detect queries) on the same random weights:

- a 2-frame clip with proposals and fixed assignments through JAX's
  public motr_clip_forward and detection_loss, composed as motr.py:279-291
  composes them, under one module-scoped jitted jax.value_and_grad: each
  frame's logits, boxes and query_embed, the loss, and every gradient
  (through tracking/convert.py's key map), the QIM's, yolox_embed's and
  the backbone's among them, and the zeros of the parameters the loss
  does not reach;
- the optimizer on JAX's gradients, given to both sides, against optax's
  chain(clip_by_global_norm(0.1), adamw(2e-4, weight_decay=1e-4)) over 3
  updates, and the train step's loss and norm on the fixed assignments;
- the two-stage selection on tied bf16 scores against lax.top_k;
- the clip-consistent matching (clip_assignments, clip_matcher_loss) on a
  hand-built 3-frame clip against JAX's clip_matcher_loss: an identity
  that leaves and returns, new ones, more identities than max_targets;
- the epoch (port only): BatchNorm's buffers bit-identical after it, the
  loss falling over 3 epochs on one clip.

Tolerances: f32 throughout, the sums in another order. Outputs within
TOL; the loss within 1e-5 of JAX's, relative; each gradient within
GRAD_TOL of its tensor's largest entry, floored at 1e-5 of the largest
entry of all (the DINO train test's bound); the parameters after each
update within 1e-6 of their tensor's largest entry. A top-k near-tie in
the two-stage selection, or a near-tie in a Hungarian cost, would flip a
discrete choice: the tests assert a margin for each instead of picking
seeds silently."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastervit_tpu import get_config as jax_get_config
from fastervit_tpu.detection import engine as je
from fastervit_tpu.tracking import motr as jm
from fastervit_tpu_torch import get_config
from fastervit_tpu_torch.detection import engine
from fastervit_tpu_torch.tracking import motr as pm
from fastervit_tpu_torch.tracking.convert import \
    motr_detector_state_dict_from_jax
from torch_parity import few_torch_threads, random_variables  # noqa: F401

BACKBONE = dict(depths=[1, 1, 1, 1], dim=32, in_dim=16,
                num_heads=[1, 2, 4, 8])
CANVAS = (64, 96)
DIM = 64
NT, NPROP, NDET = 3, 2, 4           # track, proposal, detect slots
KW = dict(num_classes=1, dim=DIM, num_detect_queries=NDET,
          num_track_queries=NT, num_proposal_queries=NPROP, enc_layers=1,
          dec_layers=2)
FRAMES, T = 2, 3                    # clip length, padded targets a frame
TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
UPDATE_TOL = 1e-6
MARGIN = 1e-4
# the clip's identities and their fixed slots: id 1 leaves after frame
# 0, id 3 arrives in frame 1 in a track slot, id 2 keeps its detect slot
TRACK_IDS = ([1, 2], [2, 3])
ASSIGNMENT = np.asarray([[[3, 6, -1]], [[6, 0, -1]]], np.int32)


def _configs():
    return (jax_get_config("faster_vit_0_any_res", resolution=list(CANVAS),
                           **BACKBONE),
            get_config("faster_vit_0_any_res", resolution=CANVAS, **BACKBONE))


def _clip():
    """Frames (F, 1, H, W, 3), proposals (F, 1, P, 5) and each frame's
    targets, from numpy."""
    rng = np.random.RandomState(60)
    frames = rng.randn(FRAMES, 1, *CANVAS, 3).astype(np.float32)
    props = np.concatenate([rng.uniform(0.2, 0.8, (FRAMES, 1, NPROP, 2)),
                            rng.uniform(0.05, 0.3, (FRAMES, 1, NPROP, 2)),
                            rng.uniform(0.3, 0.95, (FRAMES, 1, NPROP, 1))],
                           -1).astype(np.float32)
    targets = []
    for ids in TRACK_IDS:
        n = len(ids)
        boxes = np.concatenate([rng.uniform(0.25, 0.75, (n, 2)),
                                rng.uniform(0.1, 0.3, (n, 2))], -1)
        targets.append([{"labels": np.zeros(n, np.int32),
                         "boxes": boxes.astype(np.float32),
                         "track_ids": np.asarray(ids)}])
    return frames, props, targets


def _enc_margin(enc_logits) -> float:
    s = np.sort(np.asarray(enc_logits, np.float32).max(-1)[0])[::-1]
    return float(s[NDET - 1] - s[NDET])


def _port_detector(variables):
    det = pm.MOTRDetector(_configs()[1], **KW)
    det.load_state_dict(motr_detector_state_dict_from_jax(variables),
                        strict=True)
    return det.eval()


def _frames_t(frames):
    return torch.from_numpy(np.ascontiguousarray(
        frames.transpose(0, 1, 4, 2, 3)))


@pytest.fixture(scope="module")
def jax_clip():
    """JAX's clip loss, outputs and gradients on random variables (the
    class heads' kernels x4, so that scores spread)."""
    jdet = jm.MOTRDetector(backbone_cfg=_configs()[0], **KW)
    x0 = np.zeros((1, *CANVAS, 3), np.float32)
    variables = random_variables(jax.eval_shape(lambda: jdet.init(
        jax.random.PRNGKey(0), x0)), seed=61)
    tr = variables["params"]["transformer"]
    for name in ("class_embed", "enc_out_class_embed"):
        tr[name]["kernel"] *= 4.0
    frames, props, targets = _clip()
    tgt = [je.pad_targets(tf, T) for tf in targets]
    stats = variables["batch_stats"]

    def clip_loss(params):
        outs = jm.motr_clip_forward(jdet, params, stats, frames,
                                    proposals=props)
        total = 0.0
        for f, out in enumerate(outs):
            loss, _ = je.detection_loss(
                {"logits": [out["logits"]], "boxes": [out["boxes"]]},
                {k: jnp.asarray(v) for k, v in tgt[f].items()},
                jnp.asarray(ASSIGNMENT[f])[None], 1)
            total = total + loss
        keep = [{"logits": o["logits"], "boxes": o["boxes"],
                 "query_embed": o["query_embed"],
                 "enc_logits": o["aux"]["enc_logits"]} for o in outs]
        return total / len(outs), keep

    grad_fn = jax.jit(jax.value_and_grad(clip_loss, has_aux=True))
    (loss, outs), grads = grad_fn(variables["params"])
    grads = jax.tree.map(np.asarray, grads)
    return dict(variables=variables, loss=float(loss),
                outs=jax.tree.map(np.asarray, outs), grads=grads,
                frames=frames, props=props, targets=targets)


@pytest.fixture(scope="module")
def port_clip(jax_clip):
    """The port's clip forward, loss and gradients on the same weights."""
    j = jax_clip
    det = _port_detector(j["variables"])
    outs = pm.motr_clip_forward(det, _frames_t(j["frames"]),
                                torch.from_numpy(j["props"]))
    tgt = pm.clip_targets(j["targets"], T, "cpu")
    loss = pm.motr_clip_loss(outs, tgt, torch.from_numpy(ASSIGNMENT))
    loss.backward()
    grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in det.named_parameters()}
    return dict(det=det, outs=outs, loss=loss.item(), grads=grads)


def _want_grads(j):
    """JAX's gradients as the port's state_dict, every parameter's."""
    return motr_detector_state_dict_from_jax(
        {"params": j["grads"], "batch_stats": j["variables"]["batch_stats"]})


def test_clip_forward_matches_jax(jax_clip, port_clip):
    margins = [_enc_margin(o["enc_logits"]) for o in jax_clip["outs"]]
    print(f"two-stage margins a frame {margins}")
    assert min(margins) > MARGIN, "a near-tie at a frame's top-k"
    for f, (got, want) in enumerate(zip(port_clip["outs"],
                                        jax_clip["outs"])):
        assert got["logits"].shape == (1, NT + NPROP + NDET, 1)
        for key in ("logits", "boxes", "query_embed"):
            np.testing.assert_allclose(got[key].detach().numpy(), want[key],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"frame {f} {key}")


def test_clip_loss_matches_jax(jax_clip, port_clip):
    want, got = jax_clip["loss"], port_clip["loss"]
    print(f"clip loss: port {got:.7f}, JAX {want:.7f}")
    assert abs(got - want) <= LOSS_TOL * abs(want)


def test_clip_gradients_match_jax(jax_clip, port_clip):
    want, got = _want_grads(jax_clip), port_clip["grads"]
    floor = TOL * max(float(g.abs().max()) for g in want.values())
    worst, zeros = 0.0, []
    for name, g in got.items():
        ref = want[name]
        if not ref.abs().max():
            zeros.append(name)
            assert not g.abs().max(), f"{name}: JAX's gradient is zero"
            continue
        err = float((g - ref).abs().max())
        bound = max(GRAD_TOL * float(ref.abs().max()), floor)
        assert err <= bound, (name, err, bound)
        worst = max(worst, err / bound)
    print(f"worst gradient error {worst:.3f} of its bound; zero on both "
          f"sides: {zeros}")
    # the track queries' path: frame 0's QIM feeds frame 1's track slots
    for name in ("qim.linear1.weight", "qim.self_attn.in_proj_weight",
                 "yolox_embed", "backbone.0.patch_embed.conv_down.0.weight"):
        matches = [n for n in got if n.startswith(name)]
        assert matches, name
        assert all(got[n].abs().max() > 0 for n in matches), name
    # the two-stage selection's encoder heads get none through the top-k
    assert any("enc_out_class_embed" in n for n in zeros), zeros


def test_optimizer_matches_optax(jax_clip):
    """JAX's gradients, scaled by (1, 3, 0.01) at the three updates, given
    to the port's optimizer and to optax's chain: the parameters after
    each update."""
    j = jax_clip
    det = _port_detector(j["variables"])
    opt = pm.create_motr_optimizer(det, lr=2e-4, weight_decay=1e-4,
                                   clip_max_norm=0.1)
    assert len(opt.optimizer.param_groups) == len(opt.names)
    assert set(opt.lrs(0)) == {2e-4}
    tx = optax.chain(optax.clip_by_global_norm(0.1),
                     optax.adamw(2e-4, weight_decay=1e-4))
    params = jax.tree.map(jnp.asarray, j["variables"]["params"])
    state = tx.init(params)
    update = jax.jit(tx.update)
    stats = j["variables"]["batch_stats"]
    named = dict(det.named_parameters())
    for step, scale in enumerate((1.0, 3.0, 0.01)):
        grads = jax.tree.map(lambda g: g * np.float32(scale), j["grads"])
        want = motr_detector_state_dict_from_jax(
            {"params": grads, "batch_stats": stats})
        for name, p in named.items():
            p.grad = want[name].clone()
        norm = float(opt.step(step))
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        jsd = motr_detector_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, params),
             "batch_stats": stats})
        worst = 0.0
        for name, p in named.items():
            err = float((p.detach() - jsd[name]).abs().max())
            bound = UPDATE_TOL * float(jsd[name].abs().max())
            assert err <= bound, (step, name, err, bound)
            worst = max(worst, err / bound)
        print(f"update {step}: global norm {norm:.4f} (clip 0.1), worst "
              f"parameter error {worst:.3f} of its bound")


def test_train_step_on_fixed_assignments_matches_jax(jax_clip):
    """The port's train step given the assignments: JAX's loss and the
    global norm of JAX's gradients; no matching pass runs."""
    j = jax_clip
    det = _port_detector(j["variables"])
    state = engine.DetectionTrainState(det, pm.create_motr_optimizer(det))
    m = pm.make_motr_clip_train_step()(
        state, _frames_t(j["frames"]), j["targets"],
        torch.from_numpy(j["props"]), ASSIGNMENT)
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in jax.tree.leaves(j["grads"]))))
    assert abs(float(m["loss"]) - j["loss"]) <= LOSS_TOL * abs(j["loss"])
    assert abs(float(m["grad_norm"]) - norm) <= 1e-4 * norm
    assert m["match_logits"] is None and state.step == 1
    np.testing.assert_array_equal(m["assignment"], ASSIGNMENT)


def test_selection_breaks_ties_as_lax_top_k():
    """The two-stage selection on bf16-rounded scores with ties at the
    k-th place and inside the top k: the indices of jax.lax.top_k, the
    lower index first among equal scores, and the same over repeated
    calls."""
    rng = np.random.RandomState(64)
    scores = np.round(rng.randn(2, 400) * 4) / 4          # many exact ties
    logits = torch.from_numpy(scores.astype(np.float32))[..., None]
    det = pm.MOTRDetector(_configs()[1], **KW)
    for k in (1, 7, 60):
        det.transformer.num_queries = k
        got = det.transformer.select({"enc_logits": logits.bfloat16()})
        want = np.asarray(jax.lax.top_k(jnp.asarray(scores, jnp.bfloat16),
                                        k)[1])
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k {k}")
        assert torch.equal(det.transformer.select(
            {"enc_logits": logits.bfloat16()}), got)
        kth = np.sort(scores, 1)[:, ::-1][:, k - 1]
        assert ((scores == kth[:, None]).sum(1) > 1).any(), "no tie at k"


# ----------------------------- the matching --------------------------------

Q = 8
MAX_TARGETS = 3
# frame 0: ids 1, 2; frame 1: 1 leaves, 3, 5 and 6 arrive (6 past
# max_targets: matched, not written); frame 2: 6 first, 1 returns
MATCH_IDS = ([1, 2], [2, 3, 5, 6], [6, 1, 2, 3])


def _matching_case():
    rng = np.random.RandomState(62)
    outs, targets = [], []
    for ids in MATCH_IDS:
        n = len(ids)
        outs.append({
            "logits": rng.randn(1, Q, 1).astype(np.float32) * 2,
            "boxes": np.concatenate([rng.uniform(0.2, 0.8, (1, Q, 2)),
                                     rng.uniform(0.05, 0.3, (1, Q, 2))],
                                    -1).astype(np.float32)})
        targets.append({
            "labels": np.zeros(n, np.int32),
            "boxes": np.concatenate([rng.uniform(0.2, 0.8, (n, 2)),
                                     rng.uniform(0.05, 0.3, (n, 2))],
                                    -1).astype(np.float32),
            "track_ids": np.asarray(ids)})
    return outs, targets


def _second_best_gap(cost: np.ndarray) -> float:
    """The Hungarian optimum's lead over the next-best assignment of the
    columns to distinct rows (brute force: the matrices are small)."""
    rows, cols = cost.shape
    totals = sorted(sum(cost[r, c] for c, r in enumerate(perm))
                    for perm in itertools.permutations(range(rows), cols))
    return float(totals[1] - totals[0])


class _Record:
    """hungarian_match wrapped: each call's cost matrix and result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, cost):
        r, c = self.fn(cost)
        self.calls.append((np.asarray(cost, np.float32), np.asarray(r),
                           np.asarray(c)))
        return r, c


def test_clip_matching_matches_jax(monkeypatch):
    outs, targets = _matching_case()
    jrec, prec = _Record(jm.hungarian_match), _Record(pm.hungarian_match)
    monkeypatch.setattr(jm, "hungarian_match", jrec)
    monkeypatch.setattr(pm, "hungarian_match", prec)
    want = jm.clip_matcher_loss(
        [{k: jnp.asarray(v) for k, v in o.items()} for o in outs], targets)
    touts = [{k: torch.from_numpy(v) for k, v in o.items()} for o in outs]
    got = pm.clip_matcher_loss(touts, targets)
    for key in ("loss_ce", "loss_bbox", "loss_giou", "loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    per_frame = [[t] for t in targets]
    assignment = pm.clip_assignments(touts, per_frame, MAX_TARGETS)
    full = pm.clip_assignments(touts, per_frame, 4)
    # two matchings each time, frames 0 and 1 (frame 2 has no new id: 1
    # returns to its slot, 6 keeps the one it took in frame 1)
    assert len(jrec.calls) == 2 and len(prec.calls) == 3 * 2
    for calls in (prec.calls[:2], prec.calls[2:4], prec.calls[4:]):
        for (jc, jr, jcol), (pc, pr, pcol) in zip(jrec.calls, calls):
            np.testing.assert_allclose(pc, jc, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(pr, jr)
            np.testing.assert_array_equal(pcol, jcol)
    gaps = [_second_best_gap(c) for c, _, _ in jrec.calls]
    print(f"Hungarian margins {gaps}; assignment {assignment[:, 0].tolist()}")
    assert min(gaps) > MARGIN, "a near-tie in a Hungarian cost"
    np.testing.assert_array_equal(assignment, full[:, :, :MAX_TARGETS])
    slots = full[:, 0]
    assert slots[2, 1] == slots[0, 0]          # id 1 back in its slot
    assert slots[2, 0] == slots[1, 3]          # id 6 keeps frame 1's
    assert slots[1, 0] == slots[0, 1] == slots[2, 2]   # id 2 throughout
    assert assignment[0, 0, 2] == -1 and (assignment[1:] >= 0).all()
    for f, ids in enumerate(MATCH_IDS):
        assert len(set(full[f, 0, :len(ids)])) == len(ids)


# ------------------------------- the epoch ---------------------------------

def test_epoch_keeps_batchnorm_and_loss_falls():
    """Three epochs on one 2-frame clip of the JAX CLI's synthetic kind:
    BatchNorm's running statistics bit-identical after them (the clip runs
    in eval mode), the loss lower in the third than in the first."""
    from fastervit_tpu_torch.tracking import main as cli
    det = pm.MOTRDetector(_configs()[1], **KW)
    pm.init_weights(det, torch.Generator().manual_seed(63))
    det.eval()
    buffers = {n: b.clone() for n, b in det.named_buffers()
               if "running" in n}
    assert buffers
    state = engine.DetectionTrainState(det, pm.create_motr_optimizer(det))
    clip = next(cli._synthetic_clips(1, FRAMES, *CANVAS, NPROP, seed=0))
    losses = [pm.motr_clip_train_epoch(state, [clip])["loss"]
              for _ in range(3)]
    print(f"epoch losses {losses}")
    assert state.step == 3 and all(np.isfinite(losses))
    assert losses[2] < losses[0]
    for n, b in det.named_buffers():
        if n in buffers:
            assert torch.equal(b, buffers[n]), n
