"""Window / carrier-token layout transforms (PyTorch port of
fastervit_tpu/ops/windows.py).

The functions keep the JAX package's token-major layouts: images are NHWC
here, and the model permutes its NCHW feature maps into this layout before it
partitions them into windows.

Token orderings (must match the reference bit-for-bit for weight parity):

* window tokens:   windows are raster-ordered over the image (row-major over
  the (H/ws, W/ws) grid); tokens inside a window are raster-ordered too.
* carrier tokens, "window-grouped" order: all ct of window (0,0), then window
  (0,1), ... (window raster order; ct raster order inside each window).
* carrier tokens, "global raster" order: the (gh, gw) = (nWh*cs, nWw*cs)
  carrier-token grid flattened row-major.
"""
from __future__ import annotations

import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C). H and W must be multiples of
    window_size (pad first otherwise)."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int,
                   w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C). Inverse of window_partition."""
    ws = window_size
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def ct_dewindow(ct: torch.Tensor, grid_h: int, grid_w: int,
                ct_size: int) -> torch.Tensor:
    """Carrier tokens: window-grouped order -> global raster order.
    ct: (B, T, C) with T = grid_h*grid_w; grid_h = nWh*ct_size etc."""
    b, t, c = ct.shape
    cs = ct_size
    x = ct.reshape(b, grid_h // cs, grid_w // cs, cs, cs, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, nWh, cs, nWw, cs, C)
    return x.reshape(b, t, c)


def ct_window(ct: torch.Tensor, grid_h: int, grid_w: int,
              ct_size: int) -> torch.Tensor:
    """Carrier tokens: global raster order -> window-grouped order.
    Inverse of ct_dewindow."""
    b, t, c = ct.shape
    cs = ct_size
    x = ct.reshape(b, grid_h // cs, cs, grid_w // cs, cs, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, nWh, nWw, cs, cs, C)
    return x.reshape(b, t, c)


def nearest_upsample_tokens(x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """(N, src*src, C) -> (N, dst*dst, C) nearest-neighbour spatial upsample
    on a (src, src) grid (index = floor(i * src / dst), as
    nn.Upsample(size=dst, mode='nearest'))."""
    n, _, c = x.shape
    grid = x.reshape(n, src, src, c)
    idx = torch.arange(dst, device=x.device) * src // dst
    grid = grid[:, idx][:, :, idx]
    return grid.reshape(n, dst * dst, c)
