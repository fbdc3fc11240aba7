"""FasterViT in PyTorch: the CUDA port of fastervit_tpu.

    import torch, fastervit_tpu_torch as fvt
    model = fvt.create_model("faster_vit_0_224", dtype=torch.bfloat16,
                             device="cuda").eval()
    logits = model(images)          # images: (B, 3, 224, 224) on the card

On the card the window attention runs through a hand-written CUDA kernel
(csrc/window_mhsa.cu, built by nvcc at first use); on the CPU it runs through
its plain PyTorch version. The package imports no jax.
"""
from fastervit_tpu_torch.models.config import (VARIANTS, DataConfig,
                                               FasterViTConfig)
from fastervit_tpu_torch.models.registry import (create_model, get_config,
                                                 list_models)

__all__ = ["VARIANTS", "DataConfig", "FasterViTConfig", "create_model",
           "get_config", "list_models"]
