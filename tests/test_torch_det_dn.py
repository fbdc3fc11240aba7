"""The port's contrastive denoising (DINO's CDN) against fastervit_tpu's on
the CPU: prepare_cdn on JAX's own draws (the same jax.random calls as JAX's
dino.py:157-176, fed through the port's cdn_from_draws), and on the port's
generator (shapes, bounds, the group formula, reproducible draws);
cdn_loss on the same outputs and JAX's exact-positives case; label_enc
across the weights bridge and from a reference checkpoint; the tiny
detector (JAX's tests/test_detection.py one) with dn queries and a padding
mask; and two train steps of the composition JAX's test composes (the
matching loss with given assignments on the last Q slots plus cdn_loss,
clip and AdamW) on the same weights, batch, dn queries and assignments.

Tolerances: prepare_cdn's labels equal, its boxes and mask ≤ 1e-6;
cdn_loss ≤ 1e-6 relative; the detector ≤ 5e-5 (PERF.md's detector bound);
the steps' loss ≤ 1e-5 relative and each gradient ≤ 2e-4 of its tensor's
largest entry (floor: 1e-5 of the largest of all), the bounds of
tests/test_torch_det_train.py."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastervit_tpu import get_config as jax_get_config
from fastervit_tpu.detection import dino as jdino
from fastervit_tpu.detection import engine as je
from fastervit_tpu.detection.convert import convert_dino_state_dict
from fastervit_tpu_torch import get_config
from fastervit_tpu_torch.detection import engine
from fastervit_tpu_torch.detection.convert import (dino_state_dict_from_jax,
                                                   load_dino_checkpoint)
from fastervit_tpu_torch.detection.dino import (DINODetector, cdn_draws,
                                                cdn_from_draws, cdn_groups,
                                                cdn_loss, prepare_cdn)
from fastervit_tpu_torch.detection.transforms import pad_to_canvas
from torch_parity import few_torch_threads, nchw, random_variables  # noqa: F401

BACKBONE = dict(depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8], dim=32,
                in_dim=16)
HEAD = dict(num_classes=7, dim=64, num_queries=20, enc_layers=1,
            dec_layers=2)
K = HEAD["num_classes"]
CDN_TOL = 1e-6
DET_TOL = 5e-5
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
FLOOR = 1e-5
# the config's label noise and box noise (configs/dino/
# dino_4scale_faster_vit_4_21k_224.py:61-65), and the reference's defaults
NOISE = [(0.5, 0.4), (1.0, 1.0)]


def _targets(seed, b=2, most=5):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(b):
        n = rng.randint(1, most + 1) if i else 3
        out.append({"boxes": np.stack([rng.uniform(0.2, 0.8, n),
                                       rng.uniform(0.2, 0.8, n),
                                       rng.uniform(0.05, 0.3, n),
                                       rng.uniform(0.05, 0.3, n)],
                                      -1).astype(np.float32),
                    "labels": rng.randint(0, K, n).astype(np.int32)})
    return out


def _jax_draws(key, b, g, t):
    """JAX prepare_cdn's draws (dino.py:157-176) in cdn_draws' layout."""
    r_lbl, r_flip, r_sign, r_part = jax.random.split(key, 4)
    shape = (b, g, 2, t)
    return {"rand_labels": jax.random.randint(r_lbl, shape, 0, K),
            "flip": jax.random.uniform(r_flip, shape),
            "signs": jax.random.randint(r_sign, shape + (4,), 0, 2),
            "parts": jax.random.uniform(r_part, shape + (4,))}


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("noise", NOISE, ids=["config", "defaults"])
@pytest.mark.parametrize("groups", [None, 3], ids=["adaptive", "given"])
def test_prepare_cdn_on_jax_draws_matches_jax(noise, groups):
    label_noise, box_noise = noise
    tgt = je.pad_targets(_targets(5), 4)
    key = jax.random.PRNGKey(17)
    dn_number = 10
    jdn, jmeta = jax.jit(lambda k, t: jdino.prepare_cdn(
        k, t, K, 20, dn_number=dn_number, label_noise_ratio=label_noise,
        box_noise_scale=box_noise, dn_groups=groups))(key, tgt)
    g = cdn_groups(4, dn_number, groups)
    draws = _torch_tree(jax.jit(_jax_draws, static_argnums=(1, 2, 3))(
        key, 2, g, 4))
    dn, meta = cdn_from_draws(draws, engine.targets_on(tgt, "cpu"), K, 20,
                              label_noise, box_noise)
    assert meta == {k: int(v) for k, v in jmeta.items()}
    np.testing.assert_array_equal(dn["labels"].numpy(),
                                  np.asarray(jdn["labels"]))
    np.testing.assert_allclose(dn["boxes"].numpy(), np.asarray(jdn["boxes"]),
                               atol=CDN_TOL, rtol=CDN_TOL)
    np.testing.assert_array_equal(dn["attn_mask"].numpy(),
                                  np.asarray(jdn["attn_mask"]))
    assert dn["labels"].dtype == torch.long
    assert dn["boxes"].dtype == torch.float32
    # some labels were flipped, and padded slots are 'no object'
    lbl = dn["labels"].reshape(2, g, 2, 4)
    assert (lbl[0, :, :, 3] == K).all()


def test_prepare_cdn_on_the_generator():
    tgt = engine.targets_on(engine.pad_targets(_targets(6), 5), "cpu")
    runs = [prepare_cdn(torch.Generator().manual_seed(s), tgt, K, 20,
                        dn_number=100, label_noise_ratio=0.5,
                        box_noise_scale=0.4) for s in (3, 3, 4)]
    (dn, meta), (dn2, _), (dn3, _) = runs
    # 100 // 5 padded slots, as JAX's test_cdn_adaptive_groups has it
    assert meta == {"n_dn": 200, "groups": 20, "t": 5}
    assert dn["labels"].shape == (2, 200) and dn["boxes"].shape == (2, 200, 4)
    assert dn["attn_mask"].shape == (220, 220)
    assert ((dn["boxes"] >= 0) & (dn["boxes"] <= 1)).all()
    assert ((dn["labels"] >= 0) & (dn["labels"] <= K)).all()
    for key in dn:
        assert torch.equal(dn[key], dn2[key]), key
    assert not torch.equal(dn["boxes"], dn3["boxes"])
    allow = dn["attn_mask"]
    assert not allow[200:, :200].any() and allow[:200, 200:].all()
    assert not allow[:10, 10:200].any() and allow[:10, :10].all()
    draws = cdn_draws(torch.Generator().manual_seed(3), 2, 20, 5, K)
    assert set(draws) == {"rand_labels", "flip", "signs", "parts"}
    assert torch.equal(cdn_from_draws(draws, tgt, K, 20, 0.5, 0.4)[0]["boxes"],
                       dn["boxes"])


def _outputs(seed, n, layers=2, b=2):
    rng = np.random.RandomState(seed)
    return {"logits": [2 * rng.randn(b, n, K).astype(np.float32)
                       for _ in range(layers)],
            "boxes": [(1 / (1 + np.exp(-rng.randn(b, n, 4)))).astype(
                np.float32) for _ in range(layers)]}


def test_cdn_loss_matches_jax():
    tgt = je.pad_targets(_targets(7), 4)
    meta = {"n_dn": 3 * 2 * 4, "groups": 3, "t": 4}
    out = _outputs(8, meta["n_dn"] + 20)
    got = cdn_loss({k: [torch.from_numpy(t) for t in v]
                    for k, v in out.items()},
                   engine.targets_on(tgt, "cpu"), meta, K)
    want = jdino.cdn_loss(out, tgt, meta, K)
    for key in ("loss_ce_dn", "loss_bbox_dn", "loss_giou_dn", "loss_dn"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=CDN_TOL, err_msg=key)


def test_cdn_loss_zero_box_for_exact_positives():
    """JAX's test_cdn_loss_zero_box_for_exact_positives on the port."""
    tgt = engine.targets_on(engine.pad_targets(
        [{"labels": np.array([1]),
          "boxes": np.array([[0.5, 0.5, 0.2, 0.2]])}], 1), "cpu")
    meta = {"n_dn": 2, "groups": 1, "t": 1}
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.2], [0.9, 0.9, 0.05, 0.05]]])
    logits = torch.full((1, 2, 4), -8.0)
    logits[0, 0, 1] = 8.0
    losses = cdn_loss({"logits": [logits], "boxes": [boxes]}, tgt, meta, 4)
    assert float(losses["loss_bbox_dn"]) < 1e-6
    assert float(losses["loss_giou_dn"]) < 1e-5
    assert float(losses["loss_ce_dn"]) < 1e-2


def _jax_detector():
    cfg = jax_get_config("faster_vit_0_224", resolution=128, **BACKBONE)
    return jdino.DINODetector(backbone_cfg=cfg, **HEAD)


def _port_detector():
    cfg = get_config("faster_vit_0_224", resolution=(128, 128), **BACKBONE)
    with torch.device("cpu"):
        return DINODetector(cfg, **HEAD, dn_labelbook_size=91)


@pytest.fixture(scope="module")
def setup():
    """The JAX detector, random variables with label_enc, a padded batch
    (a full image and a 96x80 one on the 128x128 canvas), its padded
    targets and dn queries (JAX's, at the config's noise)."""
    jdet = _jax_detector()
    tgt = je.pad_targets(_targets(9), 4)
    jdn, meta = jdino.prepare_cdn(jax.random.PRNGKey(5), tgt, K,
                                  HEAD["num_queries"], dn_number=8,
                                  label_noise_ratio=0.5, box_noise_scale=0.4)
    x0 = np.zeros((1, 128, 128, 3), np.float32)
    dn0 = {k: v[:1] if k != "attn_mask" else v for k, v in jdn.items()}
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), x0,
                                              dn=dn0))
    variables = random_variables(shapes, seed=61)
    imgs = np.random.RandomState(62).randn(2, 128, 128, 3).astype(np.float32)
    x, mask = pad_to_canvas([imgs[0], imgs[1][:96, :80]], (128, 128))
    return jdet, variables, x, mask, tgt, jdn, meta


def _port_dn(jdn):
    return {"labels": torch.from_numpy(np.array(jdn["labels"])),
            "boxes": torch.from_numpy(np.array(jdn["boxes"])),
            "attn_mask": torch.from_numpy(np.array(jdn["attn_mask"]))}


def test_label_enc_crosses_the_bridge(setup, tmp_path):
    """JAX's transformer/label_enc is upstream's label_enc.weight (and the
    port's transformer.label_enc.weight), untransposed, both ways: the
    port's state_dict from JAX's variables, and a reference state_dict
    holding the key loaded as convert_dino_state_dict loads it."""
    jdet, variables, *_ = setup
    table = variables["params"]["transformer"]["label_enc"]["embedding"]
    assert table.shape == (92, HEAD["dim"])
    sd = dino_state_dict_from_jax(variables)
    for key in ("label_enc.weight", "transformer.label_enc.weight"):
        np.testing.assert_array_equal(sd[key].numpy(), table)
    det = _port_detector()
    det.load_state_dict(sd, strict=True)
    assert det.label_enc is det.transformer.label_enc

    source = {k: v for k, v in dino_state_dict_from_jax(
        random_variables(jax.eval_shape(lambda: variables), seed=63)).items()
        if k != "transformer.label_enc.weight"}
    converted = convert_dino_state_dict(source, variables)
    np.testing.assert_array_equal(
        np.asarray(converted["params"]["transformer"]["label_enc"][
            "embedding"]), source["label_enc.weight"].numpy())
    path = tmp_path / "dino.pth"
    torch.save({"model": source}, path)
    result = load_dino_checkpoint(det, str(path))
    assert not result.missing_keys and not result.unexpected_keys
    got = det.state_dict()
    for key in ("label_enc.weight", "transformer.label_enc.weight"):
        assert torch.equal(got[key], source["label_enc.weight"]), key
    # a detector built without dn_labelbook_size reports and skips it
    cfg = get_config("faster_vit_0_224", resolution=(128, 128), **BACKBONE)
    with torch.device("cpu"):
        plain = DINODetector(cfg, **HEAD)
    assert plain.label_enc is None
    assert load_dino_checkpoint(plain, str(path)).unexpected_keys == [
        "label_enc.weight"]


def test_detector_with_dn_and_mask_matches_jax(setup):
    """The dn queries in front of the matching queries, on a padded batch:
    the encoder's outputs, then every decoder layer on JAX's selection
    (the dn slots and the matching ones)."""
    jdet, variables, x, mask, _, jdn, meta = setup
    want = jax.jit(lambda v, a, m, d: jdet.apply(v, a, dn=d, pad_mask=m))(
        variables, x, mask, jdn)
    det = _port_detector()
    det.load_state_dict(dino_state_dict_from_jax(variables), strict=True)
    jtopk = torch.from_numpy(np.array(jax.lax.top_k(
        jnp.max(want["enc_logits"], -1), HEAD["num_queries"])[1]))
    det.transformer.select = lambda enc: jtopk
    with torch.no_grad():
        out = det.eval()(nchw(x), dn=_port_dn(jdn),
                         pad_mask=torch.from_numpy(mask))
    q = meta["n_dn"] + HEAD["num_queries"]
    assert out["logits"][-1].shape == (2, q, K)
    for key in ("enc_logits", "enc_boxes", "interm_logits", "interm_boxes",
                "init_proposals"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   atol=DET_TOL, rtol=DET_TOL, err_msg=key)
    for i in range(HEAD["dec_layers"]):
        for key in ("logits", "boxes"):
            np.testing.assert_allclose(out[key][i].numpy(),
                                       np.asarray(want[key][i]),
                                       atol=DET_TOL, rtol=DET_TOL,
                                       err_msg=f"{key} {i}")


def _main_slots(out, n_dn):
    """The matching queries' outputs (the last Q slots) and the interm
    layer, for detection_loss."""
    return {"logits": [t[:, n_dn:] for t in out["logits"]],
            "boxes": [t[:, n_dn:] for t in out["boxes"]],
            "interm_logits": out["interm_logits"],
            "interm_boxes": out["interm_boxes"]}


def _check_grads(got, want, what):
    floor = FLOOR * max(float(g.abs().max()) for g in want.values())
    worst = 0.0
    for name, g in got.items():
        ref = want[name]
        err = float((g - ref).abs().max())
        bound = max(GRAD_TOL * float(ref.abs().max()), floor)
        assert err <= bound, (what, name, err, bound)
        worst = max(worst, err / bound)
    print(f"{what}: worst gradient error {worst:.3f} of its bound")


def test_cdn_train_steps_match_jax(setup):
    """Two steps of detection_loss (given assignments, the last Q slots)
    plus cdn_loss, the global-norm clip and AdamW, on a padded batch, both
    sides on JAX's two-stage selection of each step; label_enc's
    gradient included."""
    jdet, variables, x, mask, tgt_np, jdn, meta = setup
    n_dn = meta["n_dn"]
    tgt = {k: jnp.asarray(v) for k, v in tgt_np.items()}
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    tx = je.create_detection_optimizer(params, lr=1e-4, lr_backbone=1e-5,
                                       weight_decay=1e-4, clip_norm=0.1)
    opt_state = tx.init(params)

    def jax_loss(p, a):
        o = jdet.apply({"params": p, "batch_stats": stats}, x, dn=jdn,
                       pad_mask=mask)
        return (je.detection_loss(_main_slots(o, n_dn), tgt, a, K)[0]
                + jdino.cdn_loss(o, tgt, meta, K)["loss_dn"]), o

    grad_fn = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    det = _port_detector()
    det.load_state_dict(dino_state_dict_from_jax(variables), strict=True)
    optimizer = engine.create_detection_optimizer(
        det, lr=1e-4, lr_backbone=1e-5, weight_decay=1e-4, clip_norm=0.1)
    ptgt = engine.targets_on(tgt_np, "cpu")
    dn, tmask, images = _port_dn(jdn), torch.from_numpy(mask), nchw(x)
    # the assignment, solved once from JAX's first forward (its loss
    # gradient at no assignment is not used)
    _, o = grad_fn(params, -jnp.ones((3, 2, 4), jnp.int32))[0]
    main = {k: ([torch.from_numpy(np.array(t)) for t in v]
                if isinstance(v, list) else torch.from_numpy(np.array(v)))
            for k, v in _main_slots(o, n_dn).items()}
    assignment = engine.solve_assignments(engine.compute_costs(
        main, ptgt, len(engine.loss_layers(main)[0])), ptgt["mask"])
    jp = params
    for i in range(2):
        (jloss, o), jgrads = grad_fn(jp, jnp.asarray(assignment))
        # JAX's selection at this step's weights, for both sides
        jtopk = torch.from_numpy(np.array(jax.lax.top_k(
            jnp.max(o["enc_logits"], -1), HEAD["num_queries"])[1]))
        det.transformer.select = lambda enc, t=jtopk: t
        det.eval()
        optimizer.zero_grad()
        out = det(images, dn=dn, pad_mask=tmask)
        loss = (engine.detection_loss(_main_slots(out, n_dn), ptgt,
                                      torch.as_tensor(assignment), K)[0]
                + cdn_loss(out, ptgt, meta, K)["loss_dn"])
        loss.backward()
        assert abs(loss.item() - float(jloss)) <= LOSS_TOL * abs(
            float(jloss)), (i, loss.item(), float(jloss))
        want = dino_state_dict_from_jax({"params": jax.tree.map(
            np.array, jgrads), "batch_stats": variables["batch_stats"]})
        got = {n: p.grad.clone() if p.grad is not None
               else torch.zeros_like(p) for n, p in det.named_parameters()}
        assert float(got["transformer.label_enc.weight"].abs().max()) > 0
        _check_grads(got, want, f"step {i}")
        optimizer.step(i)
        updates, opt_state = tx.update(jgrads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
