"""FasterViT in PyTorch: the CUDA port of fastervit_tpu.

    import torch, fastervit_tpu_torch as fvt
    model = fvt.create_model("faster_vit_0_224", dtype=torch.bfloat16,
                             device="cuda").eval()
    fvt.bake_posemb(model)          # optional deploy mode: biases stored
    fvt.set_fused_hat(True)         # optional: each HAT sub-block in one
                                    # launch of the fused kernel (K6)
    logits = model(images)          # images: (B, 3, 224, 224) on the card

On the card the window attention and the detectors' multi-scale
deformable attention run through hand-written CUDA kernels (csrc/*.cu,
built by nvcc at first use); on the CPU they run through their plain
PyTorch versions. DINO detection serving is in `fastervit_tpu_torch.
detection` (`dino.build_dino_from_config`). The package imports no jax.
"""
from fastervit_tpu_torch.models.config import (VARIANTS, DataConfig,
                                               FasterViTConfig)
from fastervit_tpu_torch.models.layers import set_fused_hat
from fastervit_tpu_torch.models.registry import (bake_posemb, create_model,
                                                 get_config, list_models)

__all__ = ["VARIANTS", "DataConfig", "FasterViTConfig", "bake_posemb",
           "create_model", "get_config", "list_models", "set_fused_hat"]
