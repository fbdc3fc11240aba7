"""The port's DINO detector against fastervit_tpu's on the CPU, on the same
random weights: the transformer's helpers; the whole detector in fp32 (a
narrow FasterViT-0 pyramid on a rectangular canvas with a 4x6 carrier
grid, hidden 64, 20 queries), in 4-scale and 5-scale: the encoder's
proposals before the top-k, the selected queries, each decoder layer, the
interm outputs and `postprocess`; the weights bridge (strict load); and a
reference-layout checkpoint loaded as the JAX converter loads it.

Top-k selection is a trap for parity: at a near-tie a 1e-6 difference
swaps two queries, and every decoder output then differs. So the encoder's
outputs are compared before the selection, the selected indices must be
equal unless the scores they disagree on lie within the tolerance of each
other (the margin is printed), and the port's decoder then runs on JAX's
selection."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu import get_config as jax_get_config
from fastervit_tpu.detection import transformer as jt
from fastervit_tpu.detection.convert import convert_dino_state_dict
from fastervit_tpu.detection.dino import DINODetector as JaxDINO
from fastervit_tpu.detection.dino import postprocess as jax_postprocess
from fastervit_tpu_torch import get_config
from fastervit_tpu_torch.detection import transformer as tt
from fastervit_tpu_torch.detection.convert import (dino_state_dict_from_jax,
                                                   load_dino_checkpoint)
from fastervit_tpu_torch.detection.dino import DINODetector, postprocess
from torch_parity import few_torch_threads, nchw, random_variables  # noqa: F401

BACKBONE = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=32,
                in_dim=16)
CANVAS = (160, 288)   # level 2 pads 10x18 to 14x21: 2x3 windows, 4x6 carriers
HEAD = dict(num_classes=7, dim=64, num_queries=20)
# f32 through the backbone, 1-2 encoder and 1-2 decoder layers, the sums
# in another order: logits of up to ~4 differ by ~1e-5, boxes by ~1e-6
TOL = 5e-5
BF16_TOL = 5e-2    # bf16 port vs bf16 JAX, norm-relative; see the test
SCALES = {"4scale": dict(enc_layers=2, dec_layers=2, num_feature_levels=4,
                         return_interm_indices=(1, 2, 3)),
          "5scale": dict(enc_layers=1, dec_layers=1, num_feature_levels=5,
                         return_interm_indices=(0, 1, 2, 3))}


def _jax_detector(**kw):
    cfg = jax_get_config("faster_vit_0_224", resolution=list(CANVAS),
                         **BACKBONE)
    return JaxDINO(backbone_cfg=cfg, **HEAD, **kw)


def _port_detector(**kw):
    cfg = get_config("faster_vit_0_224", resolution=CANVAS, **BACKBONE)
    with torch.device("cpu"):
        return DINODetector(cfg, **HEAD, **kw)


def _variable_shapes(jdet):
    x0 = np.zeros((1, *CANVAS, 3), np.float32)
    return jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), x0))


@pytest.fixture(scope="module", params=sorted(SCALES))
def pair(request):
    """(scale, JAX detector, its random variables, the port's detector on
    them, input, JAX outputs)."""
    kw = SCALES[request.param]
    jdet = _jax_detector(**kw)
    variables = random_variables(_variable_shapes(jdet), seed=11)
    det = _port_detector(**kw)
    det.load_state_dict(dino_state_dict_from_jax(variables), strict=True)
    x = np.random.RandomState(12).randn(2, *CANVAS, 3).astype(np.float32)
    want = jax.jit(jdet.apply)(variables, x)
    return request.param, jdet, variables, det.eval(), x, want


def _close(got: torch.Tensor, want, what: str, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=what)


def _same_selection(got: np.ndarray, want: np.ndarray, scores: np.ndarray,
                    what: str) -> None:
    """Selected indices (B, k), best first, must be equal, unless the
    scores at each position where they differ lie within TOL of each
    other; the margin between the k-th and (k+1)-th score is printed."""
    k = want.shape[1]
    for b in range(want.shape[0]):
        s = np.sort(scores[b])[::-1]
        margin = s[k - 1] - s[k] if len(s) > k else np.inf
        print(f"{what}[{b}]: margin between the {k}-th and {k + 1}-th "
              f"score {margin:.3e}")
        diff = np.nonzero(got[b] != want[b])[0]
        gap = np.abs(scores[b][got[b][diff]] - scores[b][want[b][diff]])
        assert not len(diff) or gap.max() <= TOL, (
            f"{what}[{b}] differs at {diff.tolist()} with score gaps "
            f"{gap.tolist()}")


def test_helpers_match_jax():
    shapes = ((5, 9), (3, 5), (1, 1))
    rng = np.random.RandomState(0)
    x = rng.uniform(-0.2, 1.2, (3, 7, 4)).astype(np.float32)
    _close(tt.inverse_sigmoid(torch.from_numpy(x)),
           jt.inverse_sigmoid(jnp.asarray(x)), "inverse_sigmoid", 1e-6)
    for n in (2, 4):
        _close(tt.gen_sineembed(torch.from_numpy(x[..., :n]), 32),
               jt.gen_sineembed(jnp.asarray(x[..., :n]), 32),
               f"gen_sineembed {n}", 1e-5)
    np.testing.assert_allclose(tt.position_embedding_sine_hw(shapes, 16),
                               jt.position_embedding_sine_hw(shapes, 16),
                               atol=1e-6)
    np.testing.assert_array_equal(tt.encoder_reference_points(shapes),
                                  np.asarray(jt.encoder_reference_points(
                                      shapes)))
    for got, want in zip(tt.output_proposals(shapes),
                         jt.output_proposals(shapes)):
        np.testing.assert_array_equal(got, want)
    # the masked tables of an unpadded batch are the constant ones
    mask = torch.zeros(1, sum(h * w for h, w in shapes), dtype=torch.bool)
    vr = tt.valid_ratios_from_mask(mask, shapes)
    np.testing.assert_array_equal(vr.numpy(), np.asarray(
        jt.valid_ratios_from_mask(jnp.asarray(mask.numpy()), shapes)))
    np.testing.assert_array_equal(
        tt.encoder_reference_points_masked(shapes, vr)[0].numpy(),
        tt.encoder_reference_points(shapes))


def test_detector_matches_jax(pair):
    scale, jdet, variables, det, x, want = pair
    with torch.no_grad():
        enc = det.transformer.encode(det.project(det.features(nchw(x))))
        got_enc = {"enc_logits": enc["enc_logits"],
                   "enc_boxes": torch.sigmoid(enc["enc_unsig"])}
        for key, t in got_enc.items():
            _close(t, want[key], f"{scale} {key}")
        scores = enc["enc_logits"].max(-1).values.numpy()
        jax_topk = np.asarray(jax.lax.top_k(
            jnp.max(want["enc_logits"], -1), HEAD["num_queries"])[1])
        _same_selection(det.transformer.select(enc).numpy(), jax_topk,
                        scores, f"{scale} two-stage selection")
        out = det.transformer.decode(enc, torch.tensor(jax_topk))
    for key in ("interm_logits", "interm_boxes", "init_proposals"):
        _close(out[key], want[key], f"{scale} {key}")
    assert len(out["logits"]) == len(want["logits"]) == SCALES[scale][
        "dec_layers"]
    for i in range(len(want["logits"])):
        _close(out["logits"][i], want["logits"][i], f"{scale} logits {i}")
        _close(out["boxes"][i], want["boxes"][i], f"{scale} boxes {i}")
    sizes = np.array([[160, 288], [200, 100]], np.int32)
    prob = torch.sigmoid(out["logits"][-1]).reshape(2, -1)
    got_sel = prob.topk(10, dim=1).indices.numpy()
    want_sel = np.asarray(jax.lax.top_k(jax.nn.sigmoid(
        want["logits"][-1]).reshape(2, -1), 10)[1])
    _same_selection(got_sel, want_sel, prob.numpy(), f"{scale} postprocess")
    got_post = postprocess(out, torch.from_numpy(sizes), num_select=10)
    want_post = jax_postprocess(want, jnp.asarray(sizes), num_select=10)
    _close(got_post["scores"], want_post["scores"], f"{scale} scores")
    if (got_sel == want_sel).all():
        np.testing.assert_array_equal(got_post["labels"].numpy(),
                                      np.asarray(want_post["labels"]))
        # pixel coordinates up to 288: TOL relative
        _close(got_post["boxes"], want_post["boxes"],
               f"{scale} postprocess boxes")


def _rel(got: torch.Tensor, want) -> float:
    """||got - want|| / ||want||, in f64."""
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - w)
                 / np.linalg.norm(w))


def test_bf16_detector_dtypes_and_outputs_match_jax():
    """The bf16 detector returns JAX's dtype for every output (f32 boxes,
    bf16 logits and hidden states), keeps its constant tables f32 under
    any later cast, and lies within BF16_TOL of JAX's bf16 detector on the
    same weights (the decoder on JAX's selection)."""
    kw = SCALES["4scale"]
    jdet = JaxDINO(backbone_cfg=jax_get_config(
        "faster_vit_0_224", resolution=list(CANVAS), **BACKBONE), **HEAD,
        dtype=jnp.bfloat16, **kw)
    variables = random_variables(_variable_shapes(_jax_detector(**kw)),
                                 seed=13)
    det = _port_detector(**kw)
    det.load_state_dict(dino_state_dict_from_jax(variables), strict=True)
    det = det.eval().to(torch.bfloat16).to("cpu")
    tr = det.transformer
    for name in tr._F32_TENSORS:
        assert getattr(tr, name).dtype == torch.float32, name
    assert tr.enc_output.weight.dtype == torch.bfloat16
    x = np.random.RandomState(14).randn(2, *CANVAS, 3).astype(np.float32)
    want = jax.jit(jdet.apply)(variables, x.astype(jnp.bfloat16))
    with torch.no_grad():
        enc = tr.encode(det.project(det.features(nchw(x).bfloat16())))
        jax_topk = np.asarray(jax.lax.top_k(
            jnp.max(want["enc_logits"].astype(jnp.float32), -1),
            HEAD["num_queries"])[1])
        out = tr.decode(enc, torch.tensor(jax_topk))
    got = {k: out[k] for k in ("enc_logits", "enc_boxes", "interm_logits",
                               "interm_boxes", "init_proposals")}
    for key in ("logits", "boxes", "hidden"):
        for i, t in enumerate(out[key]):
            got[f"{key} {i}"] = t
            want[f"{key} {i}"] = want[key][i]
    errs = {}
    for key, t in got.items():
        assert str(t.dtype).split(".")[-1] == str(want[key].dtype), (
            key, t.dtype, want[key].dtype)
        errs[key] = _rel(t.float(), want[key].astype(jnp.float32))
    print("bf16 port vs bf16 JAX, ||got - want|| / ||want||:",
          ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    # the two bf16 detectors round at other places (the port's linears
    # round once after the f32 bias add, flax's too, but the backbone's
    # convolutions, norms and GELU round their f32 internals at other
    # points), each rounding 2^-9 relative: over 5 backbone blocks and 2 + 2
    # transformer layers that compounds to ~1e-2 on activations and logits;
    # the f32 boxes and proposals agree far closer
    for key, v in errs.items():
        assert v <= BF16_TOL, (key, v)
    assert errs["init_proposals"] == 0.0
    # the boxes are f32 sigmoids of a bf16 head output plus f32 reference
    # logits: they carry the head's bf16 error damped by the sigmoid
    # (observed 2.8e-3 to 4.1e-3), not a bf16 rounding of their own
    for key in ("enc_boxes", "interm_boxes", "boxes 0", "boxes 1"):
        assert errs[key] <= 1e-2, (key, errs[key])


def test_init_variables_load_strictly():
    """The bridge on what `init` really returns (BN statistics at their
    init values), and the port's state_dict names every key once per name
    upstream gives it: the shared heads under both prefixes, per layer."""
    jdet = _jax_detector(**SCALES["4scale"])
    x0 = np.zeros((1, *CANVAS, 3), np.float32)
    variables = jax.device_get(jax.jit(jdet.init)(jax.random.PRNGKey(3), x0))
    sd = dino_state_dict_from_jax(variables)
    det = _port_detector(**SCALES["4scale"])
    det.load_state_dict(sd, strict=True)
    assert set(sd) == set(det.state_dict())
    for i in range(2):
        for prefix in ("", "transformer.decoder."):
            assert f"{prefix}bbox_embed.{i}.layers.2.weight" in sd
            assert f"{prefix}class_embed.{i}.bias" in sd
    assert sd["transformer.decoder.layers.1.self_attn.in_proj_weight"].shape \
        == (3 * 64, 64)
    assert "backbone.0.norm0.running_var" in sd
    assert "input_proj.3.1.weight" in sd


def test_reference_checkpoint_loads_as_jax_converter(tmp_path):
    """A reference-layout DINO state_dict (COCO's 91-class heads, the
    denoising label embedding, the shared heads only under their top-level
    names, one encoder key missing) loads through load_dino_checkpoint,
    keeping and replacing what convert_dino_state_dict does."""
    kw = SCALES["4scale"]
    jdet = _jax_detector(**kw)
    shapes = _variable_shapes(jdet)
    start = random_variables(shapes, seed=21)
    source = dino_state_dict_from_jax(random_variables(shapes, seed=22))
    ref = {k: v for k, v in source.items()
           if not k.startswith("transformer.decoder.bbox_embed")
           and k != "transformer.encoder.layers.1.linear2.bias"}
    ref["label_enc.weight"] = torch.randn(92, 64)
    for key in ("transformer.enc_out_class_embed", "class_embed.0",
                "class_embed.1", "transformer.decoder.class_embed.0",
                "transformer.decoder.class_embed.1"):
        ref[f"{key}.weight"] = torch.randn(91, 64)
        ref[f"{key}.bias"] = torch.randn(91)
    path = tmp_path / "dino.pth"
    torch.save({"model": ref}, path)

    converted = convert_dino_state_dict(ref, start)
    want = dino_state_dict_from_jax(jax.device_get(converted))
    det = _port_detector(**kw)
    det.load_state_dict(dino_state_dict_from_jax(start), strict=True)
    result = load_dino_checkpoint(det, str(path))
    got = det.state_dict()
    for key, value in want.items():
        assert torch.equal(got[key], value.to(got[key].dtype)), key
    assert result.missing_keys == [
        "transformer.encoder.layers.1.linear2.bias"]
    assert {k for k, _, _ in result.mismatched_keys} >= {
        "transformer.enc_out_class_embed.weight", "class_embed.0.bias"}
    assert result.unexpected_keys == ["label_enc.weight"]
