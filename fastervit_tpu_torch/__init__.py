"""FasterViT in PyTorch: the CUDA port of fastervit_tpu.

    import torch, fastervit_tpu_torch as fvt
    model = fvt.create_model("faster_vit_0_224", dtype=torch.bfloat16,
                             device="cuda").eval()
    fvt.bake_posemb(model)          # optional deploy mode: biases stored
    fvt.set_fused_hat(True)         # optional: each HAT sub-block in one
                                    # launch of the fused kernel (K6)
    int8 = fvt.create_model("faster_vit_0_224", quantized=True,
                            dtype=torch.bfloat16).eval()   # int8 serving
    logits = model(images)          # images: (B, 3, 224, 224) on the card
    deploy = fvt.export_for_deploy(model, 256, torch.bfloat16)  # torch.export

On the card the window attention and the detectors' multi-scale
deformable attention run through hand-written CUDA kernels (csrc/*.cu,
built by nvcc at first use); on the CPU they run through their plain
PyTorch versions. DINO detection serving is in `fastervit_tpu_torch.
detection` (`dino.build_dino_from_config`). The package imports no jax.
"""
from fastervit_tpu_torch.models.config import (VARIANTS, DataConfig,
                                               FasterViTConfig)
from fastervit_tpu_torch.models.fastervit import freeze_stages
from fastervit_tpu_torch.models.layers import set_fused_hat
from fastervit_tpu_torch.models.registry import (bake_posemb, create_model,
                                                 export_for_deploy,
                                                 get_config, is_model,
                                                 list_models)
from fastervit_tpu_torch.ops.quant import (quantize_model,
                                           set_act_clip_percentile)

__all__ = ["VARIANTS", "DataConfig", "FasterViTConfig", "bake_posemb",
           "create_model", "export_for_deploy", "freeze_stages",
           "get_config", "is_model", "list_models",
           "quantize_model", "set_act_clip_percentile", "set_fused_hat"]
