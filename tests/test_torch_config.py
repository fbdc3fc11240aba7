"""The port's copy of the variant table, its registry and its parameter
counts, against fastervit_tpu's."""
import dataclasses

import pytest
import torch

from fastervit_tpu.models.config import VARIANTS as JAX_VARIANTS
from fastervit_tpu.models.registry import get_config as jax_get_config
from fastervit_tpu.models.registry import list_models as jax_list_models
from fastervit_tpu_torch import VARIANTS, create_model, get_config, list_models


@pytest.mark.parametrize("name", sorted(JAX_VARIANTS))
def test_variant_equals_jax(name):
    """Field by field, including the nested DataConfig."""
    assert [f.name for f in dataclasses.fields(VARIANTS[name])] == \
        [f.name for f in dataclasses.fields(JAX_VARIANTS[name])]
    assert dataclasses.asdict(VARIANTS[name]) == \
        dataclasses.asdict(JAX_VARIANTS[name])


def test_variant_tables_have_the_same_names():
    assert list(VARIANTS) == list(JAX_VARIANTS)
    assert len(VARIANTS) == 22


@pytest.mark.parametrize("pattern", ["", "faster_vit_*_any_res", "*21k*"])
def test_list_models_matches_jax(pattern):
    assert list_models(pattern) == jax_list_models(pattern)


def test_get_config_overrides_match_jax():
    kw = dict(depths=[1, 1, 2, 2], num_heads=[1, 2, 4, 8], dim=32,
              resolution=160, crop_pct=0.9)
    assert dataclasses.asdict(get_config("faster_vit_0_224", **kw)) == \
        dataclasses.asdict(jax_get_config("faster_vit_0_224", **kw))
    with pytest.raises(ValueError):
        get_config("faster_vit_0_224", no_such_field=1)
    with pytest.raises(KeyError):
        get_config("faster_vit_9_224")


# The pinned counts of tests/test_variants.py (upstream's code builds them).
EXPECTED_PARAMS = {
    "faster_vit_0_224": 31_404_840,
    "faster_vit_1_224": 53_366_696,
    "faster_vit_2_224": 75_923_816,
    "faster_vit_3_224": 159_547_944,
    "faster_vit_4_224": 365_555_712,
    "faster_vit_4_21k_224": 271_944_224,
    "faster_vit_4_21k_384": 271_944_224,
    "faster_vit_4_21k_512": 271_944_224,
    "faster_vit_4_21k_768": 271_944_224,
}


@pytest.mark.parametrize("name", sorted(EXPECTED_PARAMS))
def test_param_counts_match_reference(name):
    """Built on the meta device: no weights are allocated."""
    model = create_model(name, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == EXPECTED_PARAMS[name]


def test_create_model_dtype_and_seed():
    kw = dict(depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8], dim=16, in_dim=8,
              resolution=64, num_classes=10)
    a = create_model("faster_vit_0_224", device="cpu",
                     generator=torch.Generator().manual_seed(3), **kw)
    b = create_model("faster_vit_0_224", device="cpu",
                     generator=torch.Generator().manual_seed(3),
                     dtype=torch.bfloat16, **kw)
    assert b.head.weight.dtype == torch.bfloat16
    assert torch.equal(a.head.weight.bfloat16(), b.head.weight)
    assert a.training  # upstream convention: call .eval() for inference
