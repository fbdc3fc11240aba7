"""The port's MOTRv2 serving path against fastervit_tpu's on the CPU, on the
same random weights: pos2posemb, the DETR sine table and MOTR's encoder
grid; MOTRTransformer (no mask, a blocked-slot mask, the lite encoder);
QIMv2 with an active mask; the checkpoint-exact detector (fp32 and bf16)
and the JAX package's own MOTRDetector with track and proposal queries,
both on a narrow faster_vit_0_any_res pyramid (depths [1, 1, 1, 1], dim
32, in_dim 16) at 64x96; three frames of each streaming loop (equal ids,
boxes and scores to TOL); the weights bridge (a strict load, and an
upstream-layout .pth through load_motr_checkpoint, which JAX's
convert_motr_checkpoint reads back into the variables it came from, and
which refuses, when asked to, a file built for another model).

Every JAX reference is computed once a module (module-scoped fixtures,
one jit a function and dtype). Thresholds are a trap for the loops: a
score within rounding of one flips a birth or a death, and every later
frame differs. So the tests assert that no score of the port's run lies
within MARGIN of a threshold they use, and the MOTRDetector's that no
two-stage selection has a near-tie, instead of picking seeds silently.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu import get_config as jax_get_config
from fastervit_tpu.tracking import motr as jm
from fastervit_tpu.tracking import motr_exact as jx
from fastervit_tpu.tracking import transformer as jtr
from fastervit_tpu.tracking.convert import convert_motr_checkpoint
from fastervit_tpu_torch import get_config
from fastervit_tpu_torch.tracking import convert as pc
from fastervit_tpu_torch.tracking import motr as pm
from fastervit_tpu_torch.tracking import motr_exact as px
from fastervit_tpu_torch.tracking import transformer as ptr
from torch_parity import few_torch_threads, nchw, random_variables  # noqa: F401

BACKBONE = dict(depths=[1, 1, 1, 1], dim=32, in_dim=16,
                num_heads=[1, 2, 4, 8])
CANVAS = (64, 96)
DIM = 64                       # 8 heads of 8 channels, GroupNorm(32)
# f32 through the backbone and 1-2 encoder and decoder layers, sums in
# another order: hidden states of ~1 differ by ~1e-6
TOL = 1e-5
BF16_TOL = 5e-2                # bf16 port vs bf16 JAX, norm-relative
MARGIN = 1e-4                  # least distance of a score from a threshold
NQ, NPROP, CAP = 3, 2, 5       # the exact loop: 3 + 2 fresh, 5 track slots
TOTAL = NQ + NPROP + CAP
FRAMES = 3
# births at 0.3 (the proposal slots reach it), coasting tracks written
# from 0.02, so that a track is born, carried, missed and killed in 3 frames
EXACT_LOOP = dict(score_thresh=0.3, filter_score_thresh=0.25,
                  miss_tolerance=2, prob_threshold=0.02)
MOTR_LOOP = dict(score_thresh=0.3, filter_thresh=0.2, miss_tolerance=2)
# the JAX MOTRDetector's slots: 3 track, 2 proposal, 4 detect queries
NT, NDET = 3, 4


def _configs():
    return (jax_get_config("faster_vit_0_any_res", resolution=list(CANVAS),
                           **BACKBONE),
            get_config("faster_vit_0_any_res", resolution=CANVAS, **BACKBONE))


def _close(got, want, what: str, tol: float = TOL) -> None:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.linalg.norm(got.float().numpy() - want)
                 / np.linalg.norm(want))


def _frames():
    rng = np.random.RandomState(20)
    return [rng.randn(*CANVAS, 3).astype(np.float32) for _ in range(FRAMES)]


def _proposals():
    rng = np.random.RandomState(21)
    return [np.concatenate([rng.uniform(0.2, 0.8, (NPROP, 2)),
                            rng.uniform(0.05, 0.3, (NPROP, 2)),
                            rng.uniform(0.3, 0.95, (NPROP, 1))],
                           -1).astype(np.float32) for _ in range(FRAMES)]


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _assert_margins(scores, thresholds, what):
    scores = np.concatenate([np.ravel(s) for s in scores])
    gap = min(np.abs(scores - t).min() for t in thresholds)
    print(f"{what}: nearest score to a threshold {gap:.3e}")
    assert gap > MARGIN, f"{what}: a score within {gap} of a threshold"


# ----------------------------- helpers ------------------------------------

def test_embeddings_match_jax():
    rng = np.random.RandomState(0)
    pos = rng.uniform(-0.1, 1.1, (3, 7, 4)).astype(np.float32)
    for feats in (16, 64, 256):
        _close(pm.pos2posemb(torch.from_numpy(pos), feats),
               jm.pos2posemb(jnp.asarray(pos), feats),
               f"pos2posemb {feats}", 1e-5)
    got = pm.pos2posemb(torch.from_numpy(pos).bfloat16(), 32)
    want = jm.pos2posemb(jnp.asarray(pos, jnp.bfloat16), 32)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, "pos2posemb of bf16 coordinates", 1e-5)
    for h, w, f in ((5, 9, 16), (16, 24, 32), (25, 48, 128)):
        np.testing.assert_array_equal(px.sine_position_embedding(h, w, f),
                                      jx.sine_position_embedding(h, w, f))
    shapes = ((16, 24), (8, 12), (4, 6), (2, 3))
    np.testing.assert_array_equal(ptr.encoder_reference_points(shapes),
                                  jtr.encoder_reference_points(shapes))


# --------------------------- MOTRTransformer ------------------------------

TR_SHAPES = ((8, 12), (4, 6), (2, 3))
TR_CASES = ("plain", "masked", "lite")


@pytest.fixture(scope="module", params=TR_CASES)
def transformer_pair(request):
    """(case, port outputs, JAX outputs) of MOTRTransformer (dim 64, 2
    encoder and 2 decoder layers) on the same weights and inputs."""
    lite = request.param == "lite"
    kw = dict(dim=DIM, enc_layers=2, dec_layers=2, ffn_dim=96)
    jtrans = jtr.MOTRTransformer(**kw, lite_encoder=lite)
    s = sum(h * w for h, w in TR_SHAPES)
    q = 9
    rng = np.random.RandomState(1)
    srcs = rng.randn(1, s, DIM).astype(np.float32)
    pos = np.concatenate([jx.sine_position_embedding(h, w, DIM // 2).reshape(
        h * w, DIM) for h, w in TR_SHAPES])[None]
    tgt = rng.randn(1, q, DIM).astype(np.float32)
    ref = np.concatenate([rng.uniform(0.1, 0.9, (1, q, 2)),
                          rng.uniform(0.05, 0.4, (1, q, 2))],
                         -1).astype(np.float32)
    mask = None
    if request.param == "masked":
        mask = np.zeros((q, q), bool)
        mask[:, 6:] = True                  # the last 3 slots padded
        np.fill_diagonal(mask, False)
    shapes = jax.eval_shape(lambda: jtrans.init(
        jax.random.PRNGKey(0), srcs, TR_SHAPES, pos, tgt, ref, mask))
    variables = random_variables(shapes, seed=2)
    want = jtrans.apply(variables, srcs, TR_SHAPES, pos, tgt, ref, mask)
    port = ptr.MOTRTransformer(TR_SHAPES, **kw, lite_encoder=lite)
    sd = pc.motr_state_dict_from_jax({"params": {"transformer":
                                                 variables["params"]}})
    port.load_state_dict(_strip(sd, "transformer."), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(srcs), torch.from_numpy(pos),
                   torch.from_numpy(tgt), torch.from_numpy(ref),
                   None if mask is None else torch.from_numpy(mask))
    return request.param, got, want


def test_motr_transformer_matches_jax(transformer_pair):
    case, got, want = transformer_pair
    for i in range(2):
        _close(got["hidden"][i], want["hidden"][i], f"{case} hidden {i}")
        _close(got["refs"][i], want["refs"][i], f"{case} refs {i}")
    _close(got["init_ref"], want["init_ref"], f"{case} init_ref")


# ------------------------------- QIMv2 ------------------------------------

def test_qimv2_matches_jax_with_an_active_mask():
    t = 8
    rng = np.random.RandomState(3)
    emb = rng.randn(1, t, DIM).astype(np.float32)
    feat = rng.randn(1, t, DIM).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (1, t, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (1, t)).astype(np.float32)
    active = np.array([[1, 1, 0, 1, 0, 0, 1, 1]], bool)
    _assert_margins(scores, (0.5,), "QIMv2 scores")
    jq = jx.QIMv2(dim=DIM, hidden=96)
    variables = random_variables(jax.eval_shape(lambda: jq.init(
        jax.random.PRNGKey(0), emb, feat, ref, scores, active)), seed=4)
    sd = pc.motr_state_dict_from_jax({"params": {"qim":
                                                 variables["params"]}})
    qim = px.QIMv2(DIM, 96)
    qim.load_state_dict(_strip(sd, "track_embed."), strict=True)
    args = [torch.from_numpy(a) for a in (emb, feat, ref, scores, active)]
    with torch.no_grad():
        for m in (active, None):
            got = qim(*args[:4], None if m is None else args[4])
            want = jq.apply(variables, emb, feat, ref, scores, m)
            _close(got, want, f"QIMv2, active mask {m is not None}")
        # a bf16 output embedding is widened, as JAX promotes it
        got = qim(args[0].bfloat16(), *args[1:])
        want = jq.apply(variables, jnp.asarray(emb, jnp.bfloat16), feat, ref,
                        scores, active)
        _close(got, want, "QIMv2 on a bf16 output embedding")


# ------------------------ the checkpoint-exact detector -------------------

@pytest.fixture(scope="module")
def exact_pair():
    """JAX's exact detector and QIMv2 on random variables (the class heads'
    kernels scaled x2, so that scores spread over (0, 1)), their jitted
    applies, and the port's pair on the same weights."""
    jcfg, cfg = _configs()
    kw = dict(num_classes=1, dim=DIM, num_queries=NQ, enc_layers=1,
              dec_layers=2, ffn_dim=96)
    jdet = jx.MOTRDetectorExact(backbone_cfg=jcfg, **kw)
    jqim = jx.QIMv2(dim=DIM, hidden=96)
    x0 = np.zeros((1, *CANVAS, 3), np.float32)
    qp0, rp0 = np.zeros((1, TOTAL, DIM), np.float32), np.full(
        (1, TOTAL, 4), 0.5, np.float32)
    variables = random_variables(jax.eval_shape(lambda: jdet.init(
        jax.random.PRNGKey(0), x0, qp0, rp0)), seed=5)
    for i in range(2):
        variables["params"][f"class_embed_{i}"]["kernel"] *= 2.0
    vq = random_variables(jax.eval_shape(lambda: jqim.init(
        jax.random.PRNGKey(1), qp0, qp0, rp0, np.zeros((1, TOTAL)),
        np.ones((1, TOTAL), bool))), seed=6)
    sd = pc.motr_state_dict_from_jax({**variables, "params": {
        **variables["params"], "qim": vq["params"]}})
    det_sd, qim_sd = pc.split_motr_state_dict(sd)
    det = px.MOTRDetectorExact(cfg, **kw)
    det.load_state_dict(det_sd, strict=True)
    qim = px.QIMv2(DIM, 96)
    qim.load_state_dict(qim_sd, strict=True)
    apply = jax.jit(lambda v, img, qp, rp, m: jdet.apply(v, img, qp, rp, m))
    qim_fn = jax.jit(lambda oe, qf, rp, s, am: jqim.apply(vq, oe, qf, rp, s,
                                                          am))
    return dict(jdet=jdet, variables=variables, vq=vq, apply=apply,
                qim_fn=qim_fn, det=det.eval(), qim=qim.eval(), sd=sd, kw=kw)


def _exact_inputs():
    rng = np.random.RandomState(7)
    x = rng.randn(1, *CANVAS, 3).astype(np.float32)
    qp = rng.randn(1, TOTAL, DIM).astype(np.float32)
    rp = rng.uniform(0.1, 0.9, (1, TOTAL, 4)).astype(np.float32)
    mask = np.zeros((TOTAL, TOTAL), bool)
    mask[:, TOTAL - 2:] = True               # two padded track slots
    np.fill_diagonal(mask, False)
    return x, qp, rp, mask


def test_motr_detector_exact_matches_jax(exact_pair):
    p = exact_pair
    x, qp, rp, mask = _exact_inputs()
    want = p["apply"](p["variables"], x, qp, rp, mask)
    with torch.no_grad():
        got = p["det"](nchw(x), torch.from_numpy(qp), torch.from_numpy(rp),
                       torch.from_numpy(mask))
    for i in range(2):
        for key in ("logits", "boxes", "hidden"):
            _close(got[key][i], want[key][i], f"{key} {i}")


def test_motr_detector_exact_bf16_matches_jax(exact_pair):
    """bf16 against JAX's bf16 (jdet with dtype bfloat16) on the same
    weights: both round every stored activation to bf16, in another order,
    so they agree to BF16_TOL of each output's norm; the tables, the query
    tables and level_embed stay f32 in the port as in JAX."""
    p = exact_pair
    x, qp, rp, mask = _exact_inputs()
    jdet16 = p["jdet"].clone(dtype=jnp.bfloat16)
    want = jax.jit(jdet16.apply)(p["variables"], x, qp, rp, mask)
    det16 = px.MOTRDetectorExact(_configs()[1], **p["kw"])
    det16.load_state_dict(p["det"].state_dict())
    det16 = det16.to(torch.bfloat16).eval()
    assert det16.query_embed.weight.dtype == torch.float32
    assert det16.transformer.level_embed.dtype == torch.float32
    assert det16.transformer.ref_grid.dtype == torch.bfloat16
    with torch.no_grad():
        got = det16(nchw(x).bfloat16(), torch.from_numpy(qp),
                    torch.from_numpy(rp), torch.from_numpy(mask))
    for key in ("hidden", "boxes", "logits"):
        assert got[key][-1].dtype == torch.bfloat16
        rel = _rel(got[key][-1], want[key][-1])
        print(f"bf16 {key}: ||port - JAX|| / ||JAX|| {rel:.3e}")
        assert rel <= BF16_TOL, f"bf16 {key} off JAX's by {rel}"


class _Recorder:
    """A forward hook keeping what a detector output each call."""

    def __init__(self, module, pick):
        self.seen, self.pick = [], pick
        self.handle = module.register_forward_hook(
            lambda m, args, out: self.seen.append(self.pick(out)))


def _same_results(got, want, what):
    for f, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["ids"], w["ids"],
                                      err_msg=f"{what} frame {f} ids")
        _close(g["boxes"].astype(np.float32), w["boxes"],
               f"{what} frame {f} boxes")
        _close(np.asarray(g["scores"], np.float32), w["scores"],
               f"{what} frame {f} scores")


def test_exact_streaming_matches_jax(exact_pair):
    p = exact_pair
    frames, props = _frames(), _proposals()
    want = jx.exact_inference_sequence(
        p["apply"], p["qim_fn"], p["variables"], frames, num_queries=NQ,
        dim=DIM, proposals_per_frame=props, num_proposals=NPROP,
        track_capacity=CAP, **EXACT_LOOP)
    rec = _Recorder(p["det"], lambda out: torch.sigmoid(
        out["logits"][-1].float()).numpy())
    got = px.exact_inference_sequence(
        p["det"], p["qim"], frames, num_queries=NQ, dim=DIM,
        proposals_per_frame=props, num_proposals=NPROP, track_capacity=CAP,
        **EXACT_LOOP)
    rec.handle.remove()
    _assert_margins(rec.seen, (0.3, 0.25, 0.5, 0.02), "exact loop scores")
    _same_results(got, want, "exact loop")
    print("exact loop ids:", [r["ids"].tolist() for r in got])
    assert len(np.unique(np.concatenate([r["ids"] for r in got]))) >= 2, \
        "no track born: the loop ran none of its tracker paths"
    assert any(len(set(got[f]["ids"]) & set(got[f + 1]["ids"]))
               for f in range(FRAMES - 1)), "no track carried to a frame"


# ------------------------ the JAX package's MOTRDetector ------------------

@pytest.fixture(scope="module")
def motr_pair():
    jcfg, cfg = _configs()
    kw = dict(num_classes=1, dim=DIM, num_detect_queries=NDET,
              num_track_queries=NT, num_proposal_queries=NPROP,
              enc_layers=1, dec_layers=2)
    jdet = jm.MOTRDetector(backbone_cfg=jcfg, **kw)
    x0 = np.zeros((1, *CANVAS, 3), np.float32)
    variables = random_variables(jax.eval_shape(lambda: jdet.init(
        jax.random.PRNGKey(0), x0)), seed=8)
    tr = variables["params"]["transformer"]
    for name in ("class_embed", "enc_out_class_embed"):
        tr[name]["kernel"] *= 4.0
    det = pm.MOTRDetector(cfg, **kw)
    det.load_state_dict(pc.motr_detector_state_dict_from_jax(variables),
                        strict=True)
    apply = jax.jit(lambda v, img, te, tb, pr: jdet.apply(
        v, img, track_embed=te, track_boxes=tb, proposals=pr))
    return dict(variables=variables, apply=apply, det=det.eval(), kw=kw)


def _enc_margin(enc_logits: np.ndarray, k: int) -> float:
    s = np.sort(enc_logits.max(-1)[0])[::-1]
    return float(s[k - 1] - s[k])


def test_motr_detector_matches_jax(motr_pair):
    p = motr_pair
    rng = np.random.RandomState(9)
    x = rng.randn(1, *CANVAS, 3).astype(np.float32)
    te = rng.randn(1, NT, DIM).astype(np.float32)
    tb = rng.uniform(0.1, 0.9, (1, NT, 4)).astype(np.float32)
    props = _proposals()[0][None]
    want = p["apply"](p["variables"], x, te, tb, props)
    with torch.no_grad():
        got = p["det"](nchw(x), *map(torch.from_numpy, (te, tb, props)))
    _close(got["aux"]["enc_logits"], want["aux"]["enc_logits"], "enc_logits")
    margin = _enc_margin(np.asarray(want["aux"]["enc_logits"]), NDET)
    print(f"two-stage margin {margin:.3e}")
    assert margin > MARGIN, "a near-tie at the top-k"
    assert got["logits"].shape == (1, NT + NPROP + NDET, 1)
    for key in ("logits", "boxes", "query_embed"):
        _close(got[key], want[key], key)
    for i in range(2):
        _close(got["aux"]["hidden"][i], want["aux"]["hidden"][i],
               f"hidden {i}")


def test_motr_streaming_matches_jax(motr_pair):
    p = motr_pair
    frames, props = _frames(), _proposals()

    def apply_fn(v, image, track_embed, track_boxes, proposals):
        return p["apply"](v, image, track_embed, track_boxes, proposals)

    want = jm.motr_inference_sequence(
        apply_fn, p["variables"], frames, num_track_slots=NT, dim=DIM,
        proposals_per_frame=props, **MOTR_LOOP)
    rec = _Recorder(p["det"], lambda out: (
        torch.sigmoid(out["logits"].float()).numpy(),
        out["aux"]["enc_logits"].float().numpy()))
    got = pm.motr_inference_sequence(
        p["det"], frames, num_track_slots=NT, dim=DIM,
        proposals_per_frame=props, **MOTR_LOOP)
    rec.handle.remove()
    _assert_margins([s for s, _ in rec.seen], (0.3, 0.2),
                    "MOTRDetector loop scores")
    margins = [_enc_margin(e, NDET) for _, e in rec.seen]
    print(f"two-stage margins {margins}")
    assert min(margins) > MARGIN, "a near-tie at a frame's top-k"
    _same_results(got, want, "MOTRDetector loop")
    print("MOTRDetector loop ids:", [r["ids"].tolist() for r in got])
    assert len(np.unique(np.concatenate([r["ids"] for r in got]))) >= 2, \
        "no track born: the loop ran none of its tracker paths"
    assert any(len(set(got[f]["ids"]) & set(got[f + 1]["ids"]))
               for f in range(FRAMES - 1)), "no track carried to a frame"


# ------------------------------ the bridge --------------------------------

def test_upstream_checkpoint_loads_as_jax_converts_it(exact_pair, tmp_path):
    """An upstream-layout .pth (the bridge's state_dict, under 'model',
    with a key the port has no use for and without the top-level box-head
    names) loads into a freshly initialised port pair with nothing missing
    and the stray key reported; the port then equals the strictly loaded
    one bit for bit. JAX's convert_motr_checkpoint reads the same file's
    dict back into the variables the bridge was given."""
    p = exact_pair
    sd = {k: v for k, v in p["sd"].items() if not k.startswith("bbox_embed.")}
    sd["transformer.reference_points.weight"] = torch.zeros(2, DIM)
    path = tmp_path / "motrv2.pth"
    torch.save({"model": sd, "args": None}, path)

    det = px.MOTRDetectorExact(_configs()[1], **p["kw"])
    qim = px.QIMv2(DIM, 96)
    px.init_weights(det, qim, torch.Generator().manual_seed(99))
    res_det, res_qim = pc.load_motr_checkpoint(det, qim, str(path))
    assert not res_det.missing_keys and not res_det.mismatched_keys
    assert res_det.unexpected_keys == ["transformer.reference_points.weight"]
    assert not res_qim.missing_keys and not res_qim.unexpected_keys
    own = {**p["det"].state_dict(),
           **{"qim." + k: v for k, v in p["qim"].state_dict().items()}}
    new = {**det.state_dict(),
           **{"qim." + k: v for k, v in qim.state_dict().items()}}
    for k, v in own.items():
        assert torch.equal(new[k], v), k

    # JAX's converter, from variables of another init, reads them back
    vars0 = p["variables"]
    other = random_variables(vars0, 17)
    merged = {**other, "params": {**other["params"],
                                  "qim": random_variables(p["vq"], 18)[
                                      "params"]}}
    back = convert_motr_checkpoint(torch.load(path)["model"], merged)
    want = {**vars0, "params": {**vars0["params"],
                                "qim": p["vq"]["params"]}}
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path_, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        np.testing.assert_array_equal(np.asarray(leaf), flat_w[path_],
                                      err_msg=jax.tree_util.keystr(path_))


MISFITS = {
    "queries": (lambda sd: sd, dict(num_queries=NQ + 1),
                r"query_embed\.weight: \(3, 64\) in the file, \(4, 64\)"),
    "a layer the model lacks": (
        lambda sd: {**sd, **{k.replace("layers.1.", "layers.2."): v
                             for k, v in sd.items()
                             if k.startswith("transformer.decoder.layers.1.")}},
        {}, r"transformer\.decoder\.layers\.2\.\S+: not in the model"),
    "a layer the file lacks": (lambda sd: sd, dict(dec_layers=3),
                               r"transformer\.decoder\.layers\.2\.\S+: "
                               "not in the file"),
}


@pytest.mark.parametrize("misfit", list(MISFITS))
def test_checkpoint_for_another_model_is_refused(exact_pair, tmp_path,
                                                 misfit):
    """With fit=True (build_motr_exact's, so the submit CLI's) a file built
    for another query count or depth raises, naming what does not fit,
    where the lenient load would keep those weights random or drop them;
    the file that fits loads with fit=True."""
    p = exact_pair
    edit, kw, named = MISFITS[misfit]
    path = tmp_path / "motrv2.pth"
    torch.save({"model": edit(p["sd"])}, path)
    det = px.MOTRDetectorExact(_configs()[1], **{**p["kw"], **kw})
    qim = px.QIMv2(DIM, 96)
    with pytest.raises(ValueError, match="built for another model") as err:
        pc.load_motr_checkpoint(det, qim, str(path), fit=True)
    assert re.search(named, str(err.value)), str(err.value)
    res_det, _ = pc.load_motr_checkpoint(det, qim, str(path))
    assert res_det.mismatched_keys or res_det.missing_keys \
        or res_det.unexpected_keys
    torch.save({"model": p["sd"]}, path)
    fitting = px.MOTRDetectorExact(_configs()[1], **p["kw"])
    res_det, res_qim = pc.load_motr_checkpoint(fitting, qim, str(path),
                                               fit=True)
    assert not res_det.missing_keys and not res_det.mismatched_keys


def test_motr_detector_bridge_round_trip(motr_pair, tmp_path):
    """The port's own checkpoint of a MOTRDetector (what the submit CLI's
    --checkpoint reads) loads strictly into a fresh detector."""
    det = motr_pair["det"]
    path = tmp_path / "motr.pth"
    torch.save({"model": det.state_dict()}, path)
    fresh = pm.MOTRDetector(_configs()[1], **motr_pair["kw"])
    from fastervit_tpu_torch.utils.convert import normalize_state_dict
    fresh.load_state_dict(normalize_state_dict(torch.load(
        path, weights_only=True)), strict=True)
    for k, v in det.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
