"""Window ops, the attention dispatch, the fused HAT sub-block and their
CUDA kernels."""
from fastervit_tpu_torch.ops.hat_block import (fused_block_supported,
                                               fused_hat_block,
                                               fused_hat_block_dp,
                                               hat_block_params,
                                               hat_block_reference)

__all__ = ["fused_block_supported", "fused_hat_block", "fused_hat_block_dp",
           "hat_block_params", "hat_block_reference"]
