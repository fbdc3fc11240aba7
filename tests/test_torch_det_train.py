"""The port's detection training against fastervit_tpu's on the CPU: the
box functions, the focal loss and the set criterion; pad_targets,
compute_costs and solve_assignments; the auction matcher (JAX's
assignments, within Σvalid·eps of the Hungarian optimum, with all-invalid
and masked targets); the parameter groups against detection_param_labels
through the weights bridge; the optimizer (clip, AdamW, lr_drop) against
optax; a 2-step DINO train step against JAX's make_detection_train_step
and make_fused_detection_train_step on the same weights, batch and
assignments, with EMA; and remat against no remat.

Tolerances: f32 throughout, the sums in another order. The step's loss
within 1e-5 of JAX's, relative to the loss; each gradient within 2e-4 of
its tensor's largest entry (floor: 1e-5 of the largest entry of all, for
the tensors whose gradient is noise on both sides); the parameters after
two steps only where every step's gradient is clear of that tolerance,
since Adam moves a weight by ±lr for any nonzero gradient, whatever its
size, and a noise-sized gradient may differ in sign."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from fastervit_tpu import get_config as jax_get_config
from fastervit_tpu.detection import dino as jdino
from fastervit_tpu.detection import engine as je
from fastervit_tpu.detection import matcher_device as jmd
from fastervit_tpu.ops import boxes as jboxes
from fastervit_tpu.train.ema import ema_update as jax_ema_update
from fastervit_tpu_torch import get_config
from fastervit_tpu_torch.detection import engine, matcher_device
from fastervit_tpu_torch.detection.convert import dino_state_dict_from_jax
from fastervit_tpu_torch.detection.dino import (DINODetector, criterion,
                                                sigmoid_focal_loss)
from fastervit_tpu_torch.ops import boxes
from torch_parity import few_torch_threads, nchw, random_variables  # noqa: F401

BACKBONE = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=32,
                in_dim=16)
CANVAS = (128, 128)
HEAD = dict(num_classes=7, dim=64, num_queries=20, enc_layers=1,
            dec_layers=2)
PROJ = ("reference_points", "sampling_offsets")
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
TOL = 1e-5


def _np(t):
    return np.asarray(t, np.float32)


def _outputs(seed, b=2, q=20, k=7, layers=2):
    """Random decoder outputs: logits N(0, 2), boxes sigmoid of N(0, 1)."""
    rng = np.random.RandomState(seed)
    out = {"logits": [2 * rng.randn(b, q, k).astype(np.float32)
                      for _ in range(layers)],
           "boxes": [1 / (1 + np.exp(-rng.randn(b, q, 4))).astype(np.float32)
                     for _ in range(layers)]}
    out["interm_logits"] = 2 * rng.randn(b, q, k).astype(np.float32)
    out["interm_boxes"] = (1 / (1 + np.exp(-rng.randn(b, q, 4)))).astype(
        np.float32)
    return out


def _targets(seed, b=2, k=7, most=5):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(b):
        n = rng.randint(1, most + 1) if i else 0 if seed % 2 else 3
        out.append({"boxes": np.stack([rng.uniform(0.2, 0.8, n),
                                       rng.uniform(0.2, 0.8, n),
                                       rng.uniform(0.05, 0.3, n),
                                       rng.uniform(0.05, 0.3, n)],
                                      -1).astype(np.float32),
                    "labels": rng.randint(0, k, n).astype(np.int32)})
    return out


def _torch_outputs(out):
    return {k: ([torch.from_numpy(t) for t in v] if isinstance(v, list)
                else torch.from_numpy(v)) for k, v in out.items()}


def test_box_functions_match_jax():
    rng = np.random.RandomState(0)
    logits = 2 * rng.randn(2, 11, 7).astype(np.float32)
    pred = (1 / (1 + np.exp(-rng.randn(2, 11, 4)))).astype(np.float32)
    labels = rng.randint(0, 7, (2, 5))
    tgt = rng.uniform(0.1, 0.6, (2, 5, 4)).astype(np.float32)
    got = boxes.hungarian_cost_matrix(*map(torch.from_numpy,
                                           (logits, pred, labels, tgt)))
    cost_fn = jax.jit(jax.vmap(jboxes.hungarian_cost_matrix))
    wants = cost_fn(logits, pred, labels, tgt)
    for b in range(2):
        want = wants[b]
        np.testing.assert_allclose(got[b].numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)
        rows, cols = boxes.hungarian_match(got[b])
        want_rows, want_cols = jboxes.hungarian_match(np.asarray(want))
        np.testing.assert_array_equal(rows, want_rows)
        np.testing.assert_array_equal(cols, want_cols)
    a, c = rng.randn(2, 9, 4).astype(np.float32), rng.randn(2, 9, 4).astype(
        np.float32)
    for fn, jfn in ((boxes.ciou_loss, jboxes.ciou_loss),
                    (boxes.diou_loss, jboxes.diou_loss)):
        ta = torch.from_numpy(a).requires_grad_()
        val = fn(ta, torch.from_numpy(c))
        val.sum().backward()
        want, wgrad = jax.jit(lambda x: (jfn(x, c), jax.grad(
            lambda y: jfn(y, c).sum())(x)))(a)
        np.testing.assert_allclose(val.detach().numpy(), _np(want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ta.grad.numpy(), _np(wgrad), rtol=1e-4,
                                   atol=1e-6)
    xy = torch.from_numpy(pred[0])
    giou = boxes.generalized_box_iou(boxes.box_cxcywh_to_xyxy(xy),
                                     boxes.box_cxcywh_to_xyxy(xy.flip(0)))
    assert torch.allclose(torch.diagonal(giou), boxes.aligned_generalized_box_iou(
        boxes.box_cxcywh_to_xyxy(xy), boxes.box_cxcywh_to_xyxy(xy.flip(0))))


def test_focal_loss_and_criterion_match_jax():
    out = _outputs(1)
    t = np.random.RandomState(2).rand(2, 20, 7).astype(np.float32) > 0.8
    np.testing.assert_allclose(
        sigmoid_focal_loss(torch.from_numpy(out["logits"][0]),
                           torch.from_numpy(t.astype(np.float32))).numpy(),
        _np(jdino.sigmoid_focal_loss(out["logits"][0], t.astype(np.float32))),
        rtol=1e-5, atol=1e-7)
    for seed in (3, 4):
        targets = _targets(seed)
        got = criterion(_torch_outputs(out), targets, 7)
        want = jdino.criterion(out, targets, 7)
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)


def test_pad_targets_costs_and_assignments_match_jax():
    out = _outputs(5)
    targets = _targets(6, most=8)
    want_tgt = je.pad_targets(targets, 6)
    got_tgt = engine.pad_targets(targets, 6)
    for key in want_tgt:
        np.testing.assert_array_equal(got_tgt[key], want_tgt[key])
    tgt = engine.targets_on(got_tgt, "cpu")
    got = engine.compute_costs(_torch_outputs(out), tgt, 3)
    want = je.compute_costs(out, {k: jnp.asarray(v)
                                  for k, v in want_tgt.items()}, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        engine.solve_assignments(got, tgt["mask"]),
        je.solve_assignments(want, want_tgt["mask"]))


def _costs(seed, shape):
    return np.random.RandomState(seed).uniform(0, 10, shape).astype(
        np.float32)


@pytest.mark.parametrize("case", ["random", "masked", "all_invalid"])
def test_auction_matches_jax_and_is_near_optimal(case):
    cost = _costs(7, (3, 20, 8))
    valid = np.ones((3, 8), bool)
    if case == "masked":
        valid[:, 5:] = False
        valid[1, :2] = False
    elif case == "all_invalid":
        valid[:] = False
    got = matcher_device.auction_match(torch.from_numpy(cost),
                                       torch.from_numpy(valid)).numpy()
    want = np.stack([np.asarray(jmd.auction_match(jnp.asarray(c),
                                                  jnp.asarray(v)))
                     for c, v in zip(cost, valid)])
    np.testing.assert_array_equal(got, want)
    for c, v, a in zip(cost, valid, got):
        assert (a[~v] == -1).all()
        taken = a[v]
        assert len(set(taken.tolist())) == len(taken) and (taken >= 0).all()
        if v.any():
            rows, cols = boxes.hungarian_match(c[:, v])
            best = float(c[:, v][rows, cols].sum())
            assert matcher_device.assignment_cost(c, a) <= \
                best + v.sum() * 1e-3 + 1e-4
    # every layer at once, as the fused step solves them
    mask = torch.from_numpy(valid[:2])
    costs = [torch.from_numpy(cost[:2]), torch.from_numpy(cost[1:])]
    dev = matcher_device.solve_assignments_device(costs, mask).numpy()
    np.testing.assert_array_equal(
        dev, np.asarray(jmd.solve_assignments_device(
            [jnp.asarray(c.numpy()) for c in costs], jnp.asarray(valid[:2]))))


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.Linear(3, 4)
        self.sampling_offsets = nn.Linear(4, 2)
        self.head = nn.Linear(4, 5)


def test_optimizer_step_with_clip_and_lr_drop_matches_optax():
    model = _Tiny()
    rng = np.random.RandomState(8)
    params = {name: {"kernel": rng.randn(m.in_features,
                                         m.out_features).astype(np.float32),
                     "bias": rng.randn(m.out_features).astype(np.float32)}
              for name, m in model.named_children()}
    with torch.no_grad():
        for name, m in model.named_children():
            m.weight.copy_(torch.from_numpy(params[name]["kernel"].T))
            m.bias.copy_(torch.from_numpy(params[name]["bias"]))
    sched = lambda base: optax.piecewise_constant_schedule(base, {1: 0.1})
    tx = je.create_detection_optimizer(
        params, lr=sched(1e-2), lr_backbone=sched(1e-3), weight_decay=1e-2,
        clip_norm=0.5, lr_linear_proj_mult=0.1, linear_proj_names=PROJ)
    opt = engine.create_detection_optimizer(
        model, lr=1e-2, lr_backbone=1e-3, weight_decay=1e-2, clip_norm=0.5,
        lr_linear_proj_mult=0.1, linear_proj_names=PROJ, drop_step=1)
    assert opt.names == ["main", "backbone", "linear_proj"]
    jparams, state = jax.tree.map(jnp.asarray, params), tx.init(params)
    update = jax.jit(tx.update)
    for step in range(3):
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(
            np.float32) * 2, params)
        for name, m in model.named_children():
            m.weight.grad = torch.from_numpy(grads[name]["kernel"].T.copy())
            m.bias.grad = torch.from_numpy(grads[name]["bias"].copy())
        norm = opt.step(step)
        assert float(norm) > 0.5     # clipped
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, m in model.named_children():
            np.testing.assert_allclose(m.weight.detach().numpy(),
                                       _np(jparams[name]["kernel"]).T,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(m.bias.detach().numpy(),
                                       _np(jparams[name]["bias"]),
                                       rtol=1e-6, atol=1e-7)


def _jax_detector(**kw):
    cfg = jax_get_config("faster_vit_0_224", resolution=list(CANVAS),
                         **BACKBONE)
    return jdino.DINODetector(backbone_cfg=cfg, **HEAD, **kw)


def _port_detector(**kw):
    cfg = get_config("faster_vit_0_224", resolution=CANVAS, **BACKBONE)
    with torch.device("cpu"):
        return DINODetector(cfg, **HEAD, **kw)


@pytest.fixture(scope="module")
def setup():
    """The JAX detector, its random variables (BN statistics included),
    an input batch and its padded targets."""
    jdet = _jax_detector()
    x0 = np.zeros((1, *CANVAS, 3), np.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), x0))
    variables = random_variables(shapes, seed=31)
    x = np.random.RandomState(32).randn(2, *CANVAS, 3).astype(np.float32)
    tgt = je.pad_targets(_targets(33), 5)
    return jdet, variables, x, tgt


def test_param_groups_match_jax_labels(setup):
    jdet, variables, _, _ = setup
    labels = je.detection_param_labels(variables["params"],
                                       linear_proj_names=PROJ)
    code = {"main": 0.0, "backbone": 1.0, "linear_proj": 2.0}
    coded = jax.tree.map(lambda p, lab: np.full(p.shape, code[lab],
                                                np.float32),
                         variables["params"], labels)
    sd = dino_state_dict_from_jax({"params": coded,
                                   "batch_stats": variables["batch_stats"]})
    det = _port_detector()
    groups = engine.detection_param_groups(det, linear_proj_names=PROJ)
    seen = 0
    for label, members in groups.items():
        for name, p in members:
            assert torch.all(sd[name] == code[label]), (name, label)
            seen += 1
    assert seen == len(list(det.parameters())) and all(groups.values())


def _port_grads(det):
    """Each parameter's gradient; zeros where the loss does not reach it
    (the pyramid's unused level-0 norm), as JAX's gradient has them."""
    return {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for n, p in det.named_parameters()}


def _check_grads(got, want, what):
    floor = TOL * max(float(g.abs().max()) for g in want.values())
    worst = 0.0
    for name, g in got.items():
        ref = want[name]
        err = float((g - ref).abs().max())
        bound = max(GRAD_TOL * float(ref.abs().max()), floor)
        assert err <= bound, (what, name, err, bound)
        worst = max(worst, err / bound)
    print(f"{what}: worst gradient error {worst:.3f} of its bound")


def test_train_steps_match_jax(setup):
    """Two steps of the port's make_detection_train_step against JAX's on
    the same weights, batch and assignments (solved once from JAX's
    costs; the port's own costs give the same assignments), with the
    lr_drop at the second step and EMA; then the fused step (the auction)
    against JAX's fused step."""
    jdet, variables, x, tgt_np = setup
    k = HEAD["num_classes"]
    tgt = {key: jnp.asarray(v) for key, v in tgt_np.items()}
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    sched = lambda base: optax.piecewise_constant_schedule(base, {1: 0.1})

    def jax_tx():
        return je.create_detection_optimizer(
            params, lr=sched(1e-4), lr_backbone=sched(1e-5),
            weight_decay=1e-4, clip_norm=0.1, lr_linear_proj_mult=0.1,
            linear_proj_names=PROJ)

    def port_state():
        det = _port_detector()
        det.load_state_dict(dino_state_dict_from_jax(variables), strict=True)
        return engine.DetectionTrainState(det, engine.create_detection_optimizer(
            det, lr=1e-4, lr_backbone=1e-5, weight_decay=1e-4,
            clip_norm=0.1, lr_linear_proj_mult=0.1, linear_proj_names=PROJ,
            drop_step=1))

    images = nchw(x)
    ptgt = engine.targets_on(tgt_np, "cpu")
    state = port_state()
    with torch.no_grad():
        pout = state.model.eval()(images)
    layers = len(engine.loss_layers(pout)[0])
    pcosts = engine.compute_costs(pout, ptgt, layers)
    # one assignment for both sides and both steps; JAX's costs on the same
    # weights (from the first gradient's forward) give the same one
    assignment = engine.solve_assignments(pcosts, ptgt["mask"])

    def loss_fn(p, a):
        o = jdet.apply({"params": p, "batch_stats": stats}, x,
                       training=False)
        return je.detection_loss(o, tgt, a, k)[0], je.compute_costs(
            jax.lax.stop_gradient(o), tgt, layers)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = jax_tx()
    jstep = je.make_detection_train_step(jdet, tx, ema_decay=0.5)
    opt_state, ema = tx.init(params), params
    step = engine.make_detection_train_step(ema_decay=0.5)
    jp = params
    masks = {}
    for i in range(2):
        (jloss, jcosts), jgrads = grad_fn(jp, jnp.asarray(assignment))
        if i == 0:
            for pc, jc in zip(pcosts, jcosts):
                np.testing.assert_allclose(pc.numpy(), _np(jc), rtol=1e-4,
                                           atol=1e-4)
            np.testing.assert_array_equal(
                je.solve_assignments(jcosts, tgt_np["mask"]), assignment)
            auction = jmd.solve_assignments_device(jcosts, tgt["mask"])
        jgrads = jax.tree.map(np.asarray, jgrads)
        norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                 for g in jax.tree.leaves(jgrads))))
        scale = 0.1 / max(norm, 0.1)     # clip_by_global_norm(0.1)
        want = dino_state_dict_from_jax(
            {"params": jax.tree.map(lambda g: g * scale, jgrads),
             "batch_stats": variables["batch_stats"]})
        jp, opt_state, jm, ema = jstep(jp, stats, opt_state, x, tgt,
                                       jnp.asarray(assignment), ema)
        m = step(state, images, ptgt, assignment)
        got_loss = float(m["loss"])
        assert abs(got_loss - float(jm["loss"])) <= LOSS_TOL * abs(
            float(jm["loss"])), (i, got_loss, float(jm["loss"]))
        assert abs(float(jloss) - float(jm["loss"])) <= 1e-6 * abs(got_loss)
        assert abs(float(m["grad_norm"]) - norm) <= 1e-4 * norm
        got = _port_grads(state.model)
        _check_grads(got, want, f"step {i}")
        floor = TOL * max(float(g.abs().max()) for g in want.values())
        for name, g in want.items():
            if name in got:
                clear = g.abs() > 2 * max(GRAD_TOL * float(g.abs().max()),
                                          floor)
                masks[name] = clear & masks.get(name, clear)
    jsd = dino_state_dict_from_jax({"params": jp, "batch_stats": stats})
    esd = dino_state_dict_from_jax({"params": ema, "batch_stats": stats})
    checked = 0
    for name, p in state.model.named_parameters():
        mask = masks[name]
        np.testing.assert_allclose(p.detach()[mask].numpy(),
                                   jsd[name][mask].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        checked += int(mask.sum())
        ema_p = dict(state.ema_model.named_parameters())[name]
        np.testing.assert_allclose(ema_p.detach()[mask].numpy(),
                                   esd[name][mask].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"EMA {name}")
    print(f"parameters after two steps checked at {checked} of "
          f"{sum(p.numel() for p in state.model.parameters())} entries")
    assert checked > 0.1 * sum(p.numel() for p in state.model.parameters())

    # the fused step: costs, the auction and the loss in one step
    tx = jax_tx()
    fused = je.make_fused_detection_train_step(jdet, tx, layers)
    _, _, jm, _ = fused(params, stats, tx.init(params), x, tgt)
    state = port_state()
    m = engine.make_fused_detection_train_step()(state, images, ptgt)
    np.testing.assert_array_equal(m["assignment"].numpy(),
                                  np.asarray(auction))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL * abs(
        float(jm["loss"]))


def test_remat_gives_the_gradients_of_no_remat(setup):
    _, variables, x, tgt_np = setup
    sd = dino_state_dict_from_jax(variables)
    tgt = engine.targets_on(tgt_np, "cpu")
    grads = []
    for remat in (False, True):
        det = _port_detector(use_checkpoint=remat)
        det.load_state_dict(sd, strict=True)
        out = det.eval()(nchw(x))
        layers = len(engine.loss_layers(out)[0])
        assignment = torch.as_tensor(engine.solve_assignments(
            engine.compute_costs(out, tgt, layers), tgt["mask"]))
        engine.detection_loss(out, tgt, assignment, 7)[0].backward()
        grads.append(_port_grads(det))
    for name, g in grads[0].items():
        assert torch.equal(grads[1][name], g), name


def test_ema_matches_jax():
    from fastervit_tpu_torch.train.ema import create_ema_model, ema_update
    model = _Tiny()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    ema = create_ema_model(model)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    want = jax_ema_update(
        {n: p.detach().numpy() for n, p in ema.named_parameters()},
        {n: p.detach().numpy() for n, p in model.named_parameters()}, 0.9)
    ema_update(ema, model, 0.9)
    # e·0.9 + p·0.1 in f32 on both sides, rounded at other places: an ulp
    for n, p in ema.named_parameters():
        np.testing.assert_allclose(p.numpy(), _np(want[n]), rtol=1e-6,
                                   atol=1e-7)
