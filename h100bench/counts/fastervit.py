"""Operation counts of a FasterViT forward, from the configuration's shapes.

Counted are the multiply-adds of the convolutions, the linear layers, the
attention products and the position-bias MLPs, two operations each; norms,
activations and other elementwise work are left out, as model FLOP counts
for MFU leave them out. The geometry follows the published architecture:
a stride-4 stem, levels that halve the resolution, windows of
`window_size[i]` tokens a side at the HAT levels (2 and 3), and carrier
tokens (`ct_size`² a window) where a HAT level's map holds more than one
window.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def _half(n: int) -> int:
    """Output size of a 3x3, stride-2, padding-1 convolution."""
    return (n + 1) // 2


def levels(cfg: Dict) -> List[Dict]:
    """Each level's geometry: dim, heads, head dim, window, input (h, w),
    padded (hp, wp), windows an image and carriers a window (HAT levels),
    and the carrier grid."""
    res = cfg["resolution"]
    h = w = _half(_half(res))
    out = []
    for i, depth in enumerate(cfg["depths"]):
        dim = cfg["dim"] * 2 ** i
        heads = cfg["num_heads"][i]
        ws = cfg["window_size"][i]
        lvl = {"dim": dim, "heads": heads, "head_dim": dim // heads,
               "depth": depth, "window": ws, "hw": (h, w), "conv": i < 2,
               "downsample": i < len(cfg["depths"]) - 1}
        if i >= 2:
            hp, wp = h + (-h) % ws, w + (-w) % ws
            sr = (hp // ws, wp // ws) if cfg["hat"][i] else (1, 1)
            carriers = sr != (1, 1)
            cs = cfg["ct_size"]
            lvl.update(padded=(hp, wp), windows=(hp // ws) * (wp // ws),
                       carriers=cs * cs if carriers else 0,
                       grid=(cs * sr[0], cs * sr[1]) if carriers else None)
        out.append(lvl)
        h, w = _half(h), _half(w)
    return out


def attention_calls(cfg: Dict, batch: int) -> List[Tuple[int, int, int,
                                                         int, int]]:
    """The window-attention calls of one forward at `batch` images, as
    (windows, tokens S, heads, head dim, calls): at each HAT level the
    carriers' own attention (where the level has carriers), then the joint
    window attention, once a block each."""
    calls = []
    for lvl in levels(cfg):
        if lvl["conv"]:
            continue
        h, d, depth = lvl["heads"], lvl["head_dim"], lvl["depth"]
        if lvl["carriers"]:
            gh, gw = lvl["grid"]
            calls.append((batch, gh * gw, h, d, depth))
        calls.append((batch * lvl["windows"],
                      lvl["window"] ** 2 + lvl["carriers"], h, d, depth))
    return calls


def _mlp_flops(tokens: int, dim: int, ratio: float) -> float:
    hidden = int(dim * ratio)
    return 2.0 * tokens * 2 * dim * hidden


def _block_flops(tokens: int, windows: int, s: int, dim: int,
                 ratio: float) -> float:
    """One attention + MLP sub-block over `windows` windows of `s` tokens
    (tokens = windows * s): qkv and proj, q kᵀ and p v, the MLP."""
    linear = 2.0 * tokens * (3 * dim * dim + dim * dim)
    attention = 4.0 * windows * s * s * dim
    return linear + attention + _mlp_flops(tokens, dim, ratio)


def _cpb_flops(rows: int, out: int) -> float:
    """A position-bias MLP (2 -> 512 -> out) over `rows` coordinates."""
    return 2.0 * rows * (2 * 512 + 512 * out)


def forward_flops(cfg: Dict, live_bias: bool = False) -> float:
    """Operations of one image's forward. With `live_bias` the position
    MLPs run (training, or serving without baked biases); baked, they are
    stored tensors and cost nothing."""
    c_in, c0, c1 = cfg["in_chans"], cfg["in_dim"], cfg["dim"]
    res = cfg["resolution"]
    r1, r2 = _half(res), _half(_half(res))
    total = 2.0 * 9 * c_in * c0 * r1 * r1 + 2.0 * 9 * c0 * c1 * r2 * r2
    ratio = cfg["mlp_ratio"]
    for lvl in levels(cfg):
        dim, (h, w) = lvl["dim"], lvl["hw"]
        if lvl["conv"]:
            total += lvl["depth"] * 2 * (2.0 * 9 * dim * dim * h * w)
        else:
            ws, nw, cr = lvl["window"], lvl["windows"], lvl["carriers"]
            s = ws * ws + cr
            per_block = _block_flops(nw * s, nw, s, dim, ratio)
            if cr:
                gh, gw = lvl["grid"]
                t = gh * gw
                per_block += _block_flops(t, 1, t, dim, ratio)
                hp, wp = lvl["padded"]
                total += 2.0 * 9 * dim * hp * wp   # the tokenizer's conv
            if live_bias:
                per_block += _cpb_flops(ws * ws, dim)
                per_block += _cpb_flops((2 * ws - 1) ** 2, lvl["heads"])
                if cr:
                    gh, gw = lvl["grid"]
                    per_block += _cpb_flops(gh * gw, dim)
                    per_block += _cpb_flops((2 * gh - 1) * (2 * gw - 1),
                                            lvl["heads"])
            total += lvl["depth"] * per_block
        if lvl["downsample"]:
            total += 2.0 * 9 * dim * 2 * dim * _half(h) * _half(w)
    total += 2.0 * cfg["dim"] * 2 ** (len(cfg["depths"]) - 1) \
        * cfg["num_classes"]
    return total
