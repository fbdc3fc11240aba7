"""The system under test, as the benchmark drives it: the port's
`create_model` at the configuration file's sizes, the seed's weights
loaded into it, and for serving `bake_posemb` (deploy mode). This is the
only file of the harness that imports the port."""
from __future__ import annotations

from typing import Dict

import torch

from h100bench import weights
from h100bench.reference import fastervit as reference

# the configuration file's keys that create_model takes as overrides
ARCH_KEYS = ("depths", "num_heads", "window_size", "ct_size", "dim",
             "in_dim", "mlp_ratio", "resolution", "drop_path_rate",
             "in_chans", "num_classes", "qkv_bias", "qk_scale", "drop_rate",
             "attn_drop_rate", "layer_scale", "layer_scale_conv",
             "layer_norm_last", "hat", "do_propagation")


def build(config: Dict, seed: int, device: torch.device,
          dtype: torch.dtype, baked: bool,
          quantized: bool = False) -> torch.nn.Module:
    """The program's model in eval mode, with the seed's weights in
    `dtype`. `create_model` draws weights of its own from a generator on
    the device (the default device is set, so its draw runs there), which
    the seed's then replace. With `quantized`, the program's int8 serving
    path (`quantize_model` on the float32 weights, then `dtype`)."""
    import fastervit_tpu_torch as fvt
    arch = {k: config[k] for k in ARCH_KEYS if k in config}
    layout = reference.parameter_layout(config)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        model = fvt.create_model(config["registry_name"], device=device,
                                 generator=gen, **arch)
    weights.load_into(model, weights.reference_weights(layout, seed, device,
                                                       dtype))
    if quantized:
        fvt.quantize_model(model)
    model = model.to(dtype).eval()
    if baked:
        fvt.bake_posemb(model)
    return model
