"""Int8 serving: weight-static, activation-dynamic quantisation (port of
fastervit_tpu/ops/quant.py).

Scheme (dynamic int8, no calibration data):
* weights: symmetric per-output-channel int8, quantised once from the f32
  weights (`quantize_kernel`), held as `weight_q` (int8, the layout of the
  float layer's weight: (O, I) or (O, I, kh, kw)) and `weight_scale` (f32,
  one per output channel);
* activations: symmetric, quantised at run time: one scale per token for a
  Linear's input, one per tensor for a Conv2d's, each max|x| / 127 or,
  with `act_clip_percentile`, that percentile of |x| / 127;
* the products in int32 (`torch._int_mm`, int8 x int8 -> int32; a conv
  as an int8 im2col and then `_int_mm`), dequantised in f32 as
  `y = acc · x_scale · w_scale + bias`, then cast to the input's dtype.

What is quantised: every nn.Linear and nn.Conv2d with a fan-in of at least
`MIN_FAN_IN` (64), except depthwise convs (the carrier tokenizer's
`pos_embed`), the position-bias MLPs (`pos_emb*`, `hat_pos_embed`) and
the heads (`head`, `ref_point_head`): JAX's `_eligible` (quant.py:67-79),
matched on the segments of the port's state_dict keys, which are
upstream's and the JAX paths' names. Attention itself (q kᵀ, p v) stays in
the model's dtype, through K1 on the card.

Where JAX intercepts flax's Dense and Conv calls, the port swaps the
modules: `quantize_model` replaces each eligible layer by an `Int8Linear` or
`Int8Conv2d` and marks every HAT block `quantized`, which routes its
sub-blocks through the composed path (K6 reads the raw float weights), as
JAX's `quantized` module flag does (layers.py:586-589).

The JAX package computes both products in XLA, outside any Pallas kernel,
so they run here as library calls (`torch._int_mm`). cuBLASLt's int8 GEMM
behind it on the card takes more than 16 rows and k and n that are
multiples of 8: `int_mm` pads the rows, k and n with zeros, which leaves
every int32 sum as it is. The plain version of each product is an int32
product of the same operands (`int_mm_reference`).
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fastervit_tpu_torch.detection.transformer import KeepF32

# Never-quantised layers, matched per key segment: exact names, then
# prefixes ("pos_emb" covers pos_embed and pos_emb_funct)
SKIP_SEGMENTS = ("head", "ref_point_head")
SKIP_SEGMENT_PREFIXES = ("pos_emb", "hat_pos_embed")
MIN_FAN_IN = 64
# cuBLASLt's int8 GEMM: rows > 16, k and n multiples of 8
MIN_ROWS = 17
ALIGN = 8

log = logging.getLogger(__name__)


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, correctly rounded on every device: divided by a tensor on
    t's device, since a division by a Python number runs on the card as a
    product with its rounded reciprocal, an ulp off the CPU's (and JAX's)
    quotient now and then."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a weight in the port's layout,
    output channels first: (O, ...) -> (int8 (O, ...), f32 (O,)), from the
    weight's f32 values: scale = max(max|w|, 1e-8) / 127, q = round(w /
    scale) clipped to ±127 (JAX quant.py:58-64, on the axes it reduces)."""
    w = weight.detach().float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = _over_127(amax.clamp_min(1e-8))
    view = (-1,) + (1,) * (w.dim() - 1)
    q = torch.clamp(torch.round(w / scale.view(view)), -127, 127)
    return q.to(torch.int8), scale


def quantile(x: torch.Tensor, q: float, dim: Optional[int] = None,
             keepdim: bool = False) -> torch.Tensor:
    """The q-quantile of x (over all of it, or along `dim`), by
    `jnp.quantile`'s default method, "linear", in its f32 arithmetic: the
    position q·(n - 1) in f32, the values at its floor and ceiling in sorted
    order, weighted by 1 - frac and frac. `torch.quantile` refuses inputs
    of more than 2^24 elements; this takes the two order statistics from a
    top-k of the tail they lie in, so it has no such limit."""
    x = x.float()
    if dim is None:
        flat = x.reshape(-1)
        out = quantile(flat, q, 0)
        return out.reshape((1,) * x.dim()) if keepdim else out
    dim = dim % x.dim()
    n = x.shape[dim]
    f32 = np.float32
    pos = f32(q) * (f32(n) - f32(1))
    low, high = np.floor(pos), np.ceil(pos)
    high_w = f32(pos - low)
    low_w = f32(f32(1) - high_w)
    low = int(min(max(low, 0), n - 1))
    high = int(min(max(high, 0), n - 1))
    if x.dim() == 1 and n > 1 << 16:
        # order statistics from the smaller tail: a top-k, not a sort
        if high >= n // 2:
            top = torch.topk(x, n - low, largest=True, sorted=True).values
            lo_v, hi_v = top[n - 1 - low], top[n - 1 - high]
        else:
            bottom = torch.topk(x, high + 1, largest=False,
                                sorted=True).values
            lo_v, hi_v = bottom[low], bottom[high]
    else:
        s = x.sort(dim=dim).values
        lo_v, hi_v = s.select(dim, low), s.select(dim, high)
    out = (lo_v * torch.tensor(low_w, device=x.device)
           + hi_v * torch.tensor(high_w, device=x.device))
    return out.unsqueeze(dim) if keepdim else out


def act_scale(absx: torch.Tensor, dim: Optional[int],
              clip_percentile: Optional[float]) -> torch.Tensor:
    """Symmetric activation scale, kept broadcastable to x: max|x| / 127
    over `dim` (None: the whole tensor), or the `clip_percentile`
    percentile of |x| / 127 (JAX `_act_scale`, quant.py:120-131)."""
    if clip_percentile is None:
        amax = (absx.amax() if dim is None
                else absx.amax(dim=dim, keepdim=True))
    else:
        amax = quantile(absx, clip_percentile / 100.0, dim, keepdim=True)
    return _over_127(amax.clamp_min(1e-8))


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 x -> int8 round(x / scale) clipped to ±127."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_padding(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """The (rows, k, n) `int_mm` hands `torch._int_mm` for an (m, k) x
    (k, n) product: rows at least MIN_ROWS, k and n multiples of ALIGN."""
    return (max(m, MIN_ROWS), _round_up(max(k, 1), ALIGN),
            _round_up(max(n, 1), ALIGN))


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) x int8 (k, n) -> int32 (m, n) through `torch._int_mm`,
    the operands padded with zeros to `int_mm_padding`'s shape where they
    fall short of it (exact: a zero adds nothing to an int32 sum). `b` is
    best a transposed view of an (n, k) weight, the column-major operand
    cuBLASLt's int8 GEMM takes without a copy."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = int_mm_padding(m, k, n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        # pad the (n, k) weight and view it transposed again
        b = F.pad(b.t(), (0, kp - k, 0, np_ - n)).t()
    out = torch._int_mm(a, b)
    if (mp, np_) != (m, n):
        out = out[:m, :n]
    return out


def int_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of `int_mm`: the exact int32 product of the same
    int8 operands, computed as an f64 matmul on their device (torch has no
    integer matmul on the card). Exact: every partial sum is an integer of
    at most 127² · k, below 2^53 for any k under 5 · 10^11."""
    return (a.double() @ b.double()).to(torch.int32)


def _dequant(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
             bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    y = acc.float() * xs * ws
    if bias is not None:
        y = y + bias
    return y.to(dtype)


def int8_dense_acc(x: torch.Tensor, weight_q: torch.Tensor,
                   act_clip_percentile: Optional[float] = None):
    """x (..., K) -> (int32 (..., O), f32 per-token scales (..., 1), and the
    int8 operand (M, K) that went into the product)."""
    xf = x.float()
    xs = act_scale(xf.abs(), -1, act_clip_percentile)
    xq = quantize_act(xf, xs).reshape(-1, x.shape[-1])
    acc = int_mm(xq, weight_q.t())
    return acc.reshape(*x.shape[:-1], weight_q.shape[0]), xs, xq


def int8_dense(x: torch.Tensor, weight_q: torch.Tensor,
               weight_scale: torch.Tensor, bias: Optional[torch.Tensor],
               act_clip_percentile: Optional[float] = None) -> torch.Tensor:
    """y = dequant(quant_token(x) @ weight_qᵀ) + bias, int32 accumulation
    (JAX `int8_dense`); weight_q is (O, K), as nn.Linear holds it."""
    acc, xs, _ = int8_dense_acc(x, weight_q, act_clip_percentile)
    return _dequant(acc, xs, weight_scale, bias, x.dtype)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def im2col_int8(xq: torch.Tensor, kernel: Tuple[int, int], stride,
                padding) -> Tuple[torch.Tensor, int, int]:
    """int8 (B, C, H, W) -> its patches (B·Ho·Wo, C·kh·kw), rows in (b, y,
    x) order, columns in the weight's (c, i, j) order, and (Ho, Wo): the
    zero-padded map viewed as windows (Tensor.unfold, no copy) and copied
    once into rows. (F.unfold has no int8 kernel, and on the card it
    launches one im2col a image.)"""
    (kh, kw), (sh, sw), (ph, pw) = kernel, _pair(stride), _pair(padding)
    if ph or pw:
        xq = F.pad(xq, (pw, pw, ph, ph))
    win = xq.unfold(2, kh, sh).unfold(3, kw, sw)     # (B, C, Ho, Wo, kh, kw)
    b, c, ho, wo = win.shape[:4]
    cols = win.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo, c * kh * kw)
    return cols, ho, wo


def int8_conv_acc(x: torch.Tensor, weight_q: torch.Tensor, stride, padding,
                  act_clip_percentile: Optional[float] = None):
    """x (B, C, H, W) -> (int32 (B, O, Ho, Wo), the per-tensor f32 scale,
    and the int8 patches (B·Ho·Wo, C·kh·kw) that went into the product)."""
    xf = x.float()
    xs = act_scale(xf.abs(), None, act_clip_percentile)
    xq = quantize_act(xf, xs)
    o, _, kh, kw = weight_q.shape
    cols, ho, wo = im2col_int8(xq, (kh, kw), stride, padding)
    acc = int_mm(cols, weight_q.reshape(o, -1).t())
    acc = acc.reshape(x.shape[0], ho, wo, o).permute(0, 3, 1, 2)
    return acc, xs, cols


def int8_conv(x: torch.Tensor, weight_q: torch.Tensor,
              weight_scale: torch.Tensor, bias: Optional[torch.Tensor],
              stride=1, padding=0,
              act_clip_percentile: Optional[float] = None) -> torch.Tensor:
    """NCHW conv with int8 operands, int32 accumulation and a per-tensor
    activation scale (JAX `int8_conv`); weight_q is (O, C, kh, kw), as
    nn.Conv2d holds it. No groups, no dilation."""
    acc, xs, _ = int8_conv_acc(x, weight_q, stride, padding,
                               act_clip_percentile)
    b = None if bias is None else bias.view(-1, 1, 1)
    return _dequant(acc, xs, weight_scale.view(-1, 1, 1), b, x.dtype)


class _Int8Layer(KeepF32):
    """weight_q (int8), weight_scale (f32) and bias (f32 or None) held as
    buffers: a serving layer has no gradient. weight_scale and bias stay
    f32 under any cast of the module, as JAX keeps `kernel_scale` and the
    bias in f32 and dequantises in f32."""

    _F32_TENSORS = ("weight_scale", "bias")
    act_clip_percentile: Optional[float] = None

    def _init_from(self, layer: nn.Module) -> None:
        q, s = quantize_kernel(layer.weight)
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", s)
        self.register_buffer("bias", None if layer.bias is None
                             else layer.bias.detach().float().clone())


class Int8Linear(_Int8Layer):
    """nn.Linear served in int8: per-token activation scales."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.in_features, self.out_features = (linear.in_features,
                                               linear.out_features)
        self._init_from(linear)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.weight_q, self.weight_scale, self.bias,
                          self.act_clip_percentile)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Int8Conv2d(_Int8Layer):
    """nn.Conv2d served in int8 (no groups, no dilation, zero padding): a
    per-tensor activation scale."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        if (conv.groups != 1 or _pair(conv.dilation) != (1, 1)
                or conv.padding_mode != "zeros"
                or isinstance(conv.padding, str)):
            raise NotImplementedError(
                "the int8 conv takes only groups 1, dilation 1 and explicit "
                f"zero padding; leave this layer out of quantisation: {conv}")
        self.in_channels, self.out_channels = (conv.in_channels,
                                               conv.out_channels)
        self.kernel_size = _pair(conv.kernel_size)
        self.stride, self.padding = _pair(conv.stride), _pair(conv.padding)
        self._init_from(conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv(x, self.weight_q, self.weight_scale, self.bias,
                         self.stride, self.padding, self.act_clip_percentile)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}, bias={self.bias is not None}")


def eligible(name: str, layer: nn.Module) -> bool:
    """Whether the layer at state_dict prefix `name` is quantised (JAX
    `_eligible`): no skipped segment, and a fan-in of at least MIN_FAN_IN
    (a conv's I/groups·kh·kw) on a conv that is not depthwise."""
    for seg in name.split("."):
        s = seg.lower()
        if s in SKIP_SEGMENTS or s.startswith(SKIP_SEGMENT_PREFIXES):
            return False
    if isinstance(layer, nn.Linear):
        return layer.in_features >= MIN_FAN_IN
    if isinstance(layer, nn.Conv2d):
        w = layer.weight
        if w.shape[1] == 1:  # depthwise
            return False
        return w[0].numel() >= MIN_FAN_IN
    return False


@torch.no_grad()
def quantize_model(model: nn.Module, verbose: bool = False) -> nn.Module:
    """Swap every eligible nn.Linear / nn.Conv2d of `model` for its int8
    layer, quantised from its f32 weights (quantise before any cast to
    bf16), and mark its HAT blocks `quantized`. A layer
    registered under two names is swapped under both. The layers left in
    full precision are logged (printed with `verbose`), as JAX
    `quantize_variables` does. Returns the model."""
    from fastervit_tpu_torch.models.layers import HAT

    swapped, skipped = {}, []
    for name, layer in model.named_modules(remove_duplicate=False):
        if type(layer) not in (nn.Linear, nn.Conv2d) or id(layer) in swapped:
            continue
        if eligible(name, layer):
            swapped[id(layer)] = (Int8Linear(layer)
                                  if isinstance(layer, nn.Linear)
                                  else Int8Conv2d(layer))
        else:
            skipped.append(name)
    for parent in list(model.modules()):
        for child_name, child in list(parent.named_children()):
            if id(child) in swapped:
                setattr(parent, child_name, swapped[id(child)])
    for m in model.modules():
        if isinstance(m, HAT):
            m.quantized = True
    if skipped:
        msg = ("int8: %d layers left in full precision: %s"
               % (len(skipped), ", ".join(skipped)))
        print(msg) if verbose else log.info(msg)
    return model


def set_act_clip_percentile(model: nn.Module,
                            percentile: Optional[float]) -> Optional[float]:
    """Set the activation scales of every int8 layer of `model` to max|x|
    (None) or to `percentile` of |x| (e.g. 99.9: JAX's
    `act_clip_percentile`, the fallback for activations with outlier
    channels). Returns the previous setting."""
    layers = [m for m in model.modules() if isinstance(m, _Int8Layer)]
    prev = layers[0].act_clip_percentile if layers else None
    for m in layers:
        m.act_clip_percentile = percentile
    return prev


def int8_layers(model: nn.Module) -> Sequence[Tuple[str, nn.Module]]:
    """(name, layer) of every int8 layer of `model`, in module order."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, _Int8Layer)]

