"""FasterViT's forward in plain PyTorch, float32, the benchmark's reference.

It follows the published architecture (Hatamizadeh et al., "FasterViT:
Fast Vision Transformers with Hierarchical Attention", ICLR 2024, and the
NVlabs/FasterViT reference code) and imports nothing of the program under
test. The weights are a dict keyed by the reference code's state_dict
names (`parameter_layout`); every derived table (position coordinates,
the relative-position index, the dense attention bias) is worked out here
from them. In evaluation BatchNorm uses its running statistics; in
training (`Mode`) the batch's, with stochastic depth from given masks.

The model: a stride-4 stem (two 3x3 stride-2 convolutions, each with
BatchNorm, eps 1e-4, and ReLU); levels 0-1 of residual conv blocks (3x3
conv, BatchNorm, exact GELU, 3x3 conv, BatchNorm, optional layer scale);
levels 2-3 of hierarchical-attention (HAT) blocks over windows of
window_size² tokens, with ct_size² carrier tokens a window where the map
holds more than one window; a LayerNorm (eps 1e-6) and a 3x3 stride-2
convolution between levels; a BatchNorm (eps 1e-5) or LayerNorm, a mean
pool and a linear head. Attention is softmax(q kᵀ·hd^-0.5 + bias) v with
SwinV2's continuous position bias: log-spaced relative offsets through a
2-512-heads MLP, 16·sigmoid, the carrier rows and columns zero. Each HAT
block first adds an absolute position embedding (a 2-512-dim MLP over the
normalised token grid).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Params = Dict[str, torch.Tensor]


def _half(n: int) -> int:
    return (n + 1) // 2


def _hat_geometry(cfg: Dict, i: int, h: int, w: int):
    """(padded h, padded w, sr ratio) of HAT level i at an (h, w) input."""
    ws = cfg["window_size"][i]
    hp, wp = h + (-h) % ws, w + (-w) % ws
    sr = (hp // ws, wp // ws) if cfg["hat"][i] else (1, 1)
    return hp, wp, sr


def _bn(name: str, c: int) -> List[Tuple[str, tuple]]:
    return [(f"{name}.{k}", (c,)) for k in
            ("weight", "bias", "running_mean", "running_var")]


def _ln(name: str, c: int) -> List[Tuple[str, tuple]]:
    return [(f"{name}.weight", (c,)), (f"{name}.bias", (c,))]


def _linear(name: str, fan_in: int, out: int, bias: bool = True):
    return [(f"{name}.weight", (out, fan_in))] + (
        [(f"{name}.bias", (out,))] if bias else [])


def _mlp_pos(name: str, out: int):
    return (_linear(f"{name}.cpb_mlp.0", 2, 512)
            + _linear(f"{name}.cpb_mlp.2", 512, out, bias=False))


def _attention(name: str, dim: int, heads: int, qkv_bias: bool):
    return (_linear(f"{name}.qkv", dim, 3 * dim, qkv_bias)
            + _linear(f"{name}.proj", dim, dim)
            + _mlp_pos(f"{name}.pos_emb_funct", heads))


def parameter_layout(cfg: Dict) -> List[Tuple[str, tuple]]:
    """Every weight and BatchNorm statistic of the model, (name, shape), in
    the reference code's state_dict names and order (the tokenizer's conv,
    which that state_dict also holds under `to_global_feature.pos`, once)."""
    c_in, c0, c1 = cfg["in_chans"], cfg["in_dim"], cfg["dim"]
    out = [("patch_embed.conv_down.0.weight", (c0, c_in, 3, 3))]
    out += _bn("patch_embed.conv_down.1", c0)
    out += [("patch_embed.conv_down.3.weight", (c1, c0, 3, 3))]
    out += _bn("patch_embed.conv_down.4", c1)
    h = w = _half(_half(cfg["resolution"]))
    n_levels = len(cfg["depths"])
    ratio = cfg["mlp_ratio"]
    for i, depth in enumerate(cfg["depths"]):
        dim = c1 * 2 ** i
        heads = cfg["num_heads"][i]
        hidden = int(dim * ratio)
        pre = f"levels.{i}"
        for j in range(depth):
            b = f"{pre}.blocks.{j}"
            if i < 2:
                out += [(f"{b}.conv1.weight", (dim, dim, 3, 3)),
                        (f"{b}.conv1.bias", (dim,))] + _bn(f"{b}.norm1", dim)
                out += [(f"{b}.conv2.weight", (dim, dim, 3, 3)),
                        (f"{b}.conv2.bias", (dim,))] + _bn(f"{b}.norm2", dim)
                if cfg.get("layer_scale_conv") is not None:
                    out += [(f"{b}.gamma", (dim,))]
                continue
            _, _, sr = _hat_geometry(cfg, i, h, w)
            out += _mlp_pos(f"{b}.pos_embed", dim)
            out += _ln(f"{b}.norm1", dim)
            out += _attention(f"{b}.attn", dim, heads, cfg["qkv_bias"])
            out += _ln(f"{b}.norm2", dim)
            out += (_linear(f"{b}.mlp.fc1", dim, hidden)
                    + _linear(f"{b}.mlp.fc2", hidden, dim))
            if cfg.get("layer_scale") is not None:
                out += [(f"{b}.gamma3", (dim,)), (f"{b}.gamma4", (dim,))]
            if sr != (1, 1):
                out += _ln(f"{b}.hat_norm1", dim)
                out += _attention(f"{b}.hat_attn", dim, heads,
                                  cfg["qkv_bias"])
                out += _ln(f"{b}.hat_norm2", dim)
                out += (_linear(f"{b}.hat_mlp.fc1", dim, hidden)
                        + _linear(f"{b}.hat_mlp.fc2", hidden, dim))
                if sr[0] == sr[1]:
                    out += _mlp_pos(f"{b}.hat_pos_embed", dim)
                if cfg.get("layer_scale") is not None:
                    out += [(f"{b}.gamma1", (dim,)), (f"{b}.gamma2", (dim,))]
        if i >= 2 and _hat_geometry(cfg, i, h, w)[2] != (1, 1):
            out += [(f"{pre}.global_tokenizer.pos_embed.weight",
                     (dim, 1, 3, 3)),
                    (f"{pre}.global_tokenizer.pos_embed.bias", (dim,))]
        if i < n_levels - 1:
            out += _ln(f"{pre}.downsample.norm", dim)
            out += [(f"{pre}.downsample.reduction.0.weight",
                     (2 * dim, dim, 3, 3))]
            h, w = _half(h), _half(w)
    feats = c1 * 2 ** (n_levels - 1)
    out += (_ln("norm", feats) if cfg.get("layer_norm_last")
            else _bn("norm", feats))
    out += _linear("head", feats, cfg["num_classes"])
    return out


# ---- how a forward runs -------------------------------------------------

@dataclasses.dataclass
class Mode:
    """train: BatchNorm on the batch's statistics, and stochastic depth
    from `masks`, one (rows,) tensor of 0/1 a drop-path site whose rate is
    above 0, in the order the forward meets them (`drop_path_sites`), each
    with its rate; checkpoint: each block's activations recomputed in the
    backward (the same masks); cast: applied to both operands of every
    convolution, linear layer and attention product (None: float32)."""
    train: bool = False
    masks: Optional[List[Tuple[torch.Tensor, float]]] = None
    checkpoint: bool = False
    cast: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __post_init__(self):
        self._next = 0

    def c(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.cast is None else self.cast(t)

    def take(self, n: int) -> list:
        """The next n sites' masks (None where the forward has none)."""
        if self.masks is None:
            return [None] * n
        out = self.masks[self._next:self._next + n]
        self._next += n
        return out


EVAL = Mode()


def drop_path_sites(cfg: Dict, batch: int) -> List[Tuple[int, float]]:
    """(rows, rate) of each stochastic-depth draw of a training forward at
    `batch` images, in order: a rate for each block, rising linearly from 0
    to drop_path_rate over all blocks; a conv block draws once (a row an
    image), a HAT block twice for its carriers (a row an image, where the
    level has carriers) and twice for its windows (a row a window); a site
    whose rate is 0 draws nothing."""
    sites, k = [], 0
    h = w = _half(_half(cfg["resolution"]))
    for i, depth in enumerate(cfg["depths"]):
        if i >= 2:
            ws = cfg["window_size"][i]
            hp, wp, sr = _hat_geometry(cfg, i, h, w)
            windows = (hp // ws) * (wp // ws)
        for _ in range(depth):
            r = _rate(cfg, k)
            k += 1
            if r == 0.0:
                continue
            if i < 2:
                sites.append((batch, r))
            else:
                if sr != (1, 1):
                    sites += [(batch, r)] * 2
                sites += [(batch * windows, r)] * 2
        h, w = _half(h), _half(w)
    return sites


# ---- layers ------------------------------------------------------------

def _batch_norm(p: Params, name: str, x: torch.Tensor, eps: float,
                m: Mode) -> torch.Tensor:
    if m.train:
        return F.batch_norm(x, None, None, p[f"{name}.weight"],
                            p[f"{name}.bias"], True, 0.0, eps)
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], False, 0.0, eps)


def _layer_norm(p: Params, name: str, x: torch.Tensor, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def _layer_norm_2d(p: Params, name: str, x: torch.Tensor, eps: float):
    return _layer_norm(p, name, x.permute(0, 2, 3, 1), eps).permute(0, 3, 1, 2)


def _linear_fn(p: Params, name: str, x: torch.Tensor, m: Mode = EVAL):
    return F.linear(m.c(x), m.c(p[f"{name}.weight"]), p.get(f"{name}.bias"))


def _conv(p: Params, name: str, x: torch.Tensor, m: Mode, **kw):
    return F.conv2d(m.c(x), m.c(p[f"{name}.weight"]), p.get(f"{name}.bias"),
                    **kw)


def _cpb(p: Params, name: str, coords: torch.Tensor,
         m: Mode = EVAL) -> torch.Tensor:
    hidden = torch.relu(_linear_fn(p, f"{name}.cpb_mlp.0", coords, m))
    return _linear_fn(p, f"{name}.cpb_mlp.2", hidden, m)


def grid_coords(n: int, device) -> torch.Tensor:
    """The absolute embedding's grid: an n-token square of side g, each
    coordinate (i - g//2) / (g//2), row first, raster order. (n, 2)."""
    g = int(math.isqrt(n))
    a = (torch.arange(g, dtype=torch.float32, device=device) - g // 2) \
        / (g // 2)
    ii, jj = torch.meshgrid(a, a, indexing="ij")
    return torch.stack([ii.reshape(-1), jj.reshape(-1)], 1)


def log_offsets(ws: int, device) -> torch.Tensor:
    """SwinV2's log-spaced relative offsets of a ws x ws window:
    ((2ws-1)², 2), row offset first, each offset / (ws - 1), times 8, then
    sign · log2(1 + |t|) / log2(8)."""
    r = torch.arange(-(ws - 1), ws, dtype=torch.float32, device=device) \
        / (ws - 1) * 8.0
    dh, dw = torch.meshgrid(r, r, indexing="ij")
    t = torch.stack([dh.reshape(-1), dw.reshape(-1)], 1)
    return torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8.0)


def relative_index(ws: int, device) -> torch.Tensor:
    """(S, S) row of the offset table for each query p and key q of a
    ws x ws window: (rp - rq + ws - 1)·(2ws - 1) + (cp - cq + ws - 1)."""
    r = torch.arange(ws, device=device)
    rows = r.repeat_interleave(ws)
    cols = r.repeat(ws)
    dr = rows[:, None] - rows[None, :] + ws - 1
    dc = cols[:, None] - cols[None, :] + ws - 1
    return dr * (2 * ws - 1) + dc


def attention_bias(p: Params, name: str, ws: int, heads: int,
                   carriers: int, device, m: Mode = EVAL) -> torch.Tensor:
    """The dense (heads, S, S) bias of a window of ws² tokens with
    `carriers` carrier tokens in front, whose rows and columns are zero."""
    table = 16.0 * torch.sigmoid(_cpb(p, name, log_offsets(ws, device), m))
    bias = table[relative_index(ws, device)].permute(2, 0, 1)
    return F.pad(bias, (carriers, 0, carriers, 0))


def window_attention(p: Params, name: str, x: torch.Tensor, heads: int,
                     bias: torch.Tensor, m: Mode = EVAL) -> torch.Tensor:
    """x (N, S, C) -> (N, S, C): qkv, softmax(q kᵀ·hd^-0.5 + bias) v,
    proj."""
    n, s, c = x.shape
    hd = c // heads
    qkv = _linear_fn(p, f"{name}.qkv", x, m).reshape(n, s, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    logits = torch.matmul(m.c(q), m.c(k).transpose(-1, -2)) * hd ** -0.5
    ctx = torch.matmul(m.c(torch.softmax(logits + bias, -1)), m.c(v))
    return _linear_fn(p, f"{name}.proj", ctx.transpose(1, 2).reshape(n, s, c),
                      m)


def _mlp(p: Params, name: str, x: torch.Tensor, m: Mode) -> torch.Tensor:
    return _linear_fn(p, f"{name}.fc2",
                      F.gelu(_linear_fn(p, f"{name}.fc1", x, m)), m)


def _branch(p: Params, gamma: str, y: torch.Tensor, drop) -> torch.Tensor:
    """Layer scale, then stochastic depth: y·mask/(1 - rate) a row."""
    g = p.get(gamma)
    y = y if g is None else g * y
    if drop is None:
        return y
    mask, rate = drop
    return y * (mask / (1.0 - rate)).reshape((-1,) + (1,) * (y.ndim - 1))


def _sub_block(p, b, pre, x, heads, bias, g_attn, g_mlp, m, drops):
    """Pre-norm attention, then pre-norm MLP, each a residual."""
    x = x + _branch(p, g_attn, window_attention(
        p, f"{b}.{pre}attn", _layer_norm(p, f"{b}.{pre}norm1", x, 1e-5),
        heads, bias, m), drops[0])
    return x + _branch(p, g_mlp, _mlp(
        p, f"{b}.{pre}mlp", _layer_norm(p, f"{b}.{pre}norm2", x, 1e-5), m),
        drops[1])


def _to_windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, C, H, W) -> (B·nW, ws², C), windows and their tokens in raster
    order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // ws, ws, w // ws, ws)
    return x.permute(0, 2, 4, 3, 5, 1).reshape(-1, ws * ws, c)


def _from_windows(x: torch.Tensor, ws: int, b: int, h: int,
                  w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 5, 1, 3, 2, 4).reshape(b, c, h, w)


def _carriers(p: Params, pre: str, x: torch.Tensor, ws: int, cs: int,
              m: Mode):
    """The carrier tokens of a (B, C, hp, wp) map: a depthwise 3x3 conv,
    then an average pool to a (cs·hp/ws, cs·wp/ws) grid (stride
    floor(hp / out), kernel hp - (out - 1)·stride), as a (B, gh, gw, C)
    grid."""
    x = _conv(p, f"{pre}.global_tokenizer.pos_embed", x, m, padding=1,
              groups=x.shape[1])
    kernel, stride = [], []
    for r in x.shape[2:]:
        out = int(cs * r / ws)
        stride.append(int(r / out))
        kernel.append(r - (out - 1) * stride[-1])
    return F.avg_pool2d(x, kernel, stride).permute(0, 2, 3, 1)


def _run(m: Mode, fn, *args):
    if m.checkpoint and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _hat_block(p, cfg, i, j, tokens, ct, m, drops):
    """One HAT block: the absolute embedding, the carriers' own sub-block
    and the joint sub-block of each window with its carriers in front."""
    b = ct.shape[0] if ct is not None else None
    c = tokens.shape[-1]
    ws, cs, heads = cfg["window_size"][i], cfg["ct_size"], cfg["num_heads"][i]
    blk = f"levels.{i}.blocks.{j}"
    dev = tokens.device
    n_ct = cs * cs if ct is not None else 0
    tokens = tokens + _cpb(p, f"{blk}.pos_embed", grid_coords(ws * ws, dev), m)
    if n_ct:
        gh, gw = ct.shape[1:3]
        g = ct.reshape(b, gh * gw, c)
        if f"{blk}.hat_pos_embed.cpb_mlp.0.weight" in p:
            g = g + _cpb(p, f"{blk}.hat_pos_embed", grid_coords(gh * gw, dev),
                         m)
        g_bias = attention_bias(p, f"{blk}.hat_attn.pos_emb_funct",
                                int(math.isqrt(gh * gw)), heads, 0, dev, m)
        g = _sub_block(p, blk, "hat_", g, heads, g_bias, f"{blk}.gamma1",
                       f"{blk}.gamma2", m, drops[:2])
        ct = g.reshape(b, gh, gw, c)
        # each window's cs x cs patch of the carrier grid, in front of its
        # tokens
        win_ct = ct.reshape(b, gh // cs, cs, gw // cs, cs, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, n_ct, c)
        tokens = torch.cat([win_ct, tokens], 1)
    bias = attention_bias(p, f"{blk}.attn.pos_emb_funct", ws, heads, n_ct,
                          dev, m)
    tokens = _sub_block(p, blk, "", tokens, heads, bias, f"{blk}.gamma3",
                        f"{blk}.gamma4", m, drops[-2:])
    if n_ct:
        win_ct, tokens = tokens[:, :n_ct], tokens[:, n_ct:]
        gh, gw = ct.shape[1:3]
        ct = win_ct.reshape(b, gh // cs, gw // cs, cs, cs, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, gh, gw, c)
        if j == cfg["depths"][i] - 1 and cfg.get("do_propagation"):
            # each window's carriers upsampled (nearest) onto its tokens
            idx = torch.arange(ws, device=dev) * cs // ws
            up = win_ct.reshape(-1, cs, cs, c)[:, idx][:, :, idx]
            tokens = tokens + _branch(p, f"{blk}.gamma1",
                                      up.reshape(-1, ws * ws, c), None)
    return tokens, ct


def _rate(cfg: Dict, k: int) -> float:
    """The stochastic-depth rate of block k of all the model's blocks."""
    total = sum(cfg["depths"])
    return cfg.get("drop_path_rate", 0.0) * k / max(total - 1, 1)


def _hat_level(p: Params, cfg: Dict, i: int, x: torch.Tensor, m: Mode,
               k: int) -> torch.Tensor:
    b, c, h, w = x.shape
    ws = cfg["window_size"][i]
    hp, wp, sr = _hat_geometry(cfg, i, h, w)
    x = F.pad(x, (0, wp - w, 0, hp - h))
    ct = (_carriers(p, f"levels.{i}", x, ws, cfg["ct_size"], m)
          if sr != (1, 1) else None)
    tokens = _to_windows(x, ws)
    for j in range(cfg["depths"][i]):
        drops = ([None] * 4 if not m.train or _rate(cfg, k + j) == 0
                 else m.take(4 if ct is not None else 2))
        tokens, ct = _run(m, lambda t, g, d=drops, j=j: _hat_block(
            p, cfg, i, j, t, g, m, d), tokens, ct)
    x = _from_windows(tokens, ws, b, hp, wp)
    return x[:, :, :h, :w]


def _conv_block(p, b, x, m, drop):
    y = _conv(p, f"{b}.conv1", x, m, padding=1)
    y = F.gelu(_batch_norm(p, f"{b}.norm1", y, 1e-5, m))
    y = _conv(p, f"{b}.conv2", y, m, padding=1)
    y = _batch_norm(p, f"{b}.norm2", y, 1e-5, m)
    g = p.get(f"{b}.gamma")
    y = y if g is None else g[:, None, None] * y
    if drop is not None:
        mask, rate = drop
        y = y * (mask / (1.0 - rate)).reshape(-1, 1, 1, 1)
    return x + y


def forward(p: Params, x: torch.Tensor, cfg: Dict,
            m: Mode = EVAL) -> torch.Tensor:
    """Logits (B, num_classes) of images x (B, 3, H, W), float32."""
    x = _conv(p, "patch_embed.conv_down.0", x, m, stride=2, padding=1)
    x = torch.relu(_batch_norm(p, "patch_embed.conv_down.1", x, 1e-4, m))
    x = _conv(p, "patch_embed.conv_down.3", x, m, stride=2, padding=1)
    x = torch.relu(_batch_norm(p, "patch_embed.conv_down.4", x, 1e-4, m))
    n_levels = len(cfg["depths"])
    k = 0
    for i in range(n_levels):
        pre = f"levels.{i}"
        if i < 2:
            for j in range(cfg["depths"][i]):
                drop = (m.take(1)[0] if m.train and _rate(cfg, k + j) > 0
                        else None)
                x = _run(m, lambda t, name=f"{pre}.blocks.{j}", d=drop:
                         _conv_block(p, name, t, m, d), x)
        else:
            x = _hat_level(p, cfg, i, x, m, k)
        k += cfg["depths"][i]
        if i < n_levels - 1:
            x = _layer_norm_2d(p, f"{pre}.downsample.norm", x, 1e-6)
            x = _conv(p, f"{pre}.downsample.reduction.0", x, m, stride=2,
                      padding=1)
    x = (_layer_norm_2d(p, "norm", x, 1e-6) if cfg.get("layer_norm_last")
         else _batch_norm(p, "norm", x, 1e-5, m))
    return _linear_fn(p, "head", x.mean(dim=(2, 3)), m)
