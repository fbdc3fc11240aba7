"""Building blocks of FasterViT in PyTorch (port of
fastervit_tpu/models/layers.py).

Convolutions run on NCHW feature maps; attention runs on token-major
(B*nW, S, C) windows. Module and parameter names follow the upstream
FasterViT state_dict, so an upstream checkpoint, or JAX variables through
`fastervit_tpu_torch.utils.convert.state_dict_from_jax`, load as they are.
The constant tables (CPB log coordinates, relative-position index, the
ct_correct index, rank-1 and rank-2 coordinate grids) are non-persistent
buffers, made with torch.as_tensor on the default device, which
`create_model` sets to the device it builds on.

Deploy mode (upstream's switch_to_deploy, the JAX package's
`Model.bake_posemb`): each position-embedding module has a non-persistent
`relative_bias` buffer, None until `registry.bake_posemb` stores the module's
tensor there; a module that holds one returns it instead of running its MLP.

Numerics notes (as in the JAX package):
* GELU is the exact-erf form (nn.GELU()).
* BatchNorm eps is 1e-4 in the stem and 1e-5 elsewhere; LayerNorm eps is
  1e-6 in Downsample (timm LayerNorm2d) and 1e-5 in the HAT blocks.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from fastervit_tpu_torch.ops.attention import window_mhsa
from fastervit_tpu_torch.ops.hat_block import (compute_dtype,
                                               fused_block_supported,
                                               fused_hat_block,
                                               hat_block_params)
from fastervit_tpu_torch.ops.windows import (ct_dewindow, ct_window,
                                             nearest_upsample_tokens)

# Route every eligible HAT sub-block of an eval-mode forward through the
# fused block, K6 on the card (the JAX package's switch, layers.py:199-213).
# Off by default, as in JAX, where the reason was a TPU measurement; on this
# card whether it wins is measured by chip_smoke.py. Read at every call.
_FUSED_HAT = False


def set_fused_hat(on: bool) -> bool:
    """Turn the fused HAT block on or off for eval-mode forwards; returns
    the previous setting. The port is eager, so the next forward reads it."""
    global _FUSED_HAT
    prev, _FUSED_HAT = _FUSED_HAT, bool(on)
    return prev


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath, scale_by_keep=True);
    the identity in eval mode. The mask is per entry of dim 0, which inside
    a HAT block is per window, as in the JAX package.

    Its bits come from `generator`, a torch.Generator on the input's device
    that the train step hands to the model for each step
    (`set_drop_path_generator`); training with rate > 0 and no generator
    raises."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath in training mode needs a generator: "
                               "call set_drop_path_generator(model, gen)")
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0],) + (1,) * (x.ndim - 1),
                           dtype=x.dtype, device=x.device)
        mask.bernoulli_(keep, generator=self.generator)
        return x * mask / keep


class Dropout(nn.Module):
    """Element dropout, the function of flax's nn.Dropout (JAX layers.py:
    64-69, 423-424): in training, where(keep, x / (1 - rate), 0) with keep
    drawn with probability 1 - rate; the identity in eval mode or at rate
    0. Its bits come from `generator` where one is set
    (`set_drop_path_generator`), else from torch's default generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.rate,
                                              generator=self.generator)
        return torch.where(keep.bool(), x / (1.0 - self.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def _draws(model: nn.Module):
    """The modules of `model` that draw random bits in training: DropPath,
    Dropout and attention with dropout (WindowAttention)."""
    return [m for m in model.modules()
            if isinstance(m, (DropPath, Dropout, WindowAttention))]


def set_drop_path_generator(model: nn.Module,
                            generator: Optional[torch.Generator]) -> None:
    """Hand `generator` to every module of `model` that draws random bits
    in training: DropPath, Dropout and the attention dropout."""
    for m in _draws(model):
        m.generator = generator


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with flax's running-statistics update: in training mode it
    normalises with the batch statistics and sets
    running_mean = 0.9·running_mean + 0.1·mean and
    running_var = 0.9·running_var + 0.1·var, with the *biased* batch
    variance, which flax's BatchNorm(momentum=0.9) uses (torch's own layer
    takes the unbiased one). The statistics are reduced in f32. Evaluation
    and the state_dict keys are torch's. With `update_stats` False (while
    gradient checkpointing recomputes a block) it normalises alike and
    leaves the statistics as they are."""

    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def _replay_context(block: nn.Module):
    """torch.utils.checkpoint's context_fn for `block`: the recompute in
    the backward must draw the DropPath and dropout masks of the forward
    and must not
    update the BatchNorm statistics a second time. The checkpoint restores
    the default generators only, and DropPath draws from its own, so the
    forward's context records that generator's state and the recompute's
    sets it (and puts back the state it found after), with update_stats
    off on the block's BatchNorms."""
    gens = list({id(m.generator): m.generator for m in _draws(block)
                 if m.generator is not None}.values())
    norms = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
    states = []

    @contextlib.contextmanager
    def forward():
        states[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        found = [g.get_state() for g in gens]
        for g, state in zip(gens, states):
            g.set_state(state)
        for m in norms:
            m.update_stats = False
        try:
            yield
        finally:
            for m in norms:
                m.update_stats = True
            for g, state in zip(gens, found):
                g.set_state(state)

    return forward(), recompute()


def checkpointed(block: nn.Module, *args):
    """block(*args) with its activations recomputed in the backward
    (torch.utils.checkpoint, non-reentrant): the same values and gradients,
    and the same DropPath masks and BatchNorm statistics, as block(*args)."""
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False,
        context_fn=lambda: _replay_context(block))


class Mlp(nn.Module):
    """fc1 -> GELU (exact erf) -> dropout -> fc2 -> dropout (JAX
    layers.py:55-69; the dropouts are identities at drop 0)."""

    def __init__(self, in_features: int, hidden_features: int,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.act = nn.GELU()
        self.drop1 = Dropout(drop)
        self.fc2 = nn.Linear(hidden_features, in_features)
        self.drop2 = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop2(self.fc2(self.drop1(self.act(self.fc1(x)))))


def _rank2_coords(seq_length: int) -> np.ndarray:
    """Normalized square grid for PosEmbMLPSwinv1D rank 2 (the reference's
    integer-division normalization, g // 2, is kept)."""
    g = int(seq_length ** 0.5)
    coords = np.arange(g, dtype=np.float32)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"))  # (2, g, g)
    table -= g // 2
    table /= g // 2
    return table.reshape(2, -1).T  # (g*g, 2), raster order


def _rank1_coords(seq_length: int) -> np.ndarray:
    """Normalized 1-D grid for PosEmbMLPSwinv1D rank 1 (the reference's
    integer-division normalization, seq_length // 2)."""
    coords = np.arange(seq_length, dtype=np.float32)
    coords -= seq_length // 2
    coords /= seq_length // 2
    return coords[:, None]  # (seq, 1)


def _rank2_coords_dynamic(grid_h: int, grid_w: int) -> np.ndarray:
    """The detection backbones' runtime-dynamic variant (fastervit_tpu/
    models/layers.py::_rank2_coords_dynamic): a (grid_h, grid_w) grid
    normalized by the *total* token count // 2, not the edge // 2."""
    seq = grid_h * grid_w
    table = np.stack(np.meshgrid(np.arange(grid_h, dtype=np.float32),
                                 np.arange(grid_w, dtype=np.float32),
                                 indexing="ij"))
    table -= seq // 2
    table /= seq // 2
    return table.reshape(2, -1).T


class PosEmbMLPSwinv1D(nn.Module):
    """Absolute position embedding: normalized grid -> MLP(rank -> 512 ->
    dim), added to the tokens. In deploy mode the (seq_length, dim)
    embedding is read from `relative_bias`.

    At `rank` 2 the grid is the square of seq_length's tokens; at rank 1
    it is the line of them (`_rank1_coords`), and `grid` and `norm_by_seq`
    do not apply to it, as in the JAX package (layers.py:126-127). With
    `norm_by_seq` (the detection backbones' dynamic mode) the rank-2 grid
    is `grid`'s (H, W), normalized by the token count; such a site is never
    baked, as in the JAX package (layers.py:124), so `bake_posemb` leaves
    it live."""

    def __init__(self, dim: int, seq_length: int,
                 grid: Optional[Tuple[int, int]] = None,
                 norm_by_seq: bool = False, rank: int = 2):
        super().__init__()
        if rank not in (1, 2):
            raise ValueError(f"PosEmbMLPSwinv1D rank {rank}: 1 or 2")
        self.norm_by_seq = norm_by_seq
        self.cpb_mlp = nn.Sequential(nn.Linear(rank, 512), nn.ReLU(),
                                     nn.Linear(512, dim, bias=False))
        if rank == 1:
            coords = _rank1_coords(seq_length)
        elif norm_by_seq:
            gh, gw = grid or (int(seq_length ** 0.5),) * 2
            coords = _rank2_coords_dynamic(gh, gw)
        else:
            coords = _rank2_coords(seq_length)
        self.register_buffer("relative_coords_table", torch.as_tensor(coords),
                             persistent=False)
        self.register_buffer("relative_bias", None, persistent=False)

    def compute(self) -> torch.Tensor:
        """The (seq_length, dim) embedding, from the parameters."""
        return self.cpb_mlp(self.relative_coords_table)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = (self.relative_bias if self.relative_bias is not None
               else self.compute())
        return x + pos[None]


def _pair(size) -> Tuple[int, int]:
    """An int or an (h, w) pair -> (h, w)."""
    if isinstance(size, int):
        return size, size
    h, w = size
    return int(h), int(w)


def _log_cpb_table(window_size: Tuple[int, int],
                   pretrained_window_size: Tuple[int, int],
                   no_log: bool) -> np.ndarray:
    """Relative-coordinate table of a (wh, ww) window (SwinV2 CPB, JAX
    layers.py:147-166): the offsets over the pretrained window's extent
    less one (the window's where that is 0), then log-spaced unless
    `no_log`. ((2wh-1)(2ww-1), 2), row offset first."""
    wh, ww = window_size
    rel_h = np.arange(-(wh - 1), wh, dtype=np.float32)
    rel_w = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(rel_h, rel_w, indexing="ij"), axis=-1)
    pwh, pww = pretrained_window_size
    if pwh > 0:
        table[..., 0] /= (pwh - 1)
        table[..., 1] /= (pww - 1)
    else:
        table[..., 0] /= (wh - 1)
        table[..., 1] /= (ww - 1)
    if not no_log:
        table *= 8.0
        table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


def _relative_position_index(window_size: Tuple[int, int]) -> np.ndarray:
    """(S, S) index into the CPB table, S = wh·ww."""
    wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, S, S)
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def _ct_correct_indices(window_size: int, n_global: int) -> list:
    """The window tokens whose bias rows and columns the carrier tokens
    take in the ct_correct mode (reference faster_vit.py:283-295; JAX
    layers.py:182-189)."""
    step = window_size / (n_global ** 0.5 + 1)
    g = int(n_global ** 0.5)
    return [int((i + 1) * step * window_size + (j + 1) * step)
            for i in range(g) for j in range(g)]


# How PosEmbMLPSwinv2D expands its CPB table into the dense (H, S, S) bias,
# as in the JAX package: 'auto' takes the separable one-hot product for
# windows of _SEPARABLE_MIN_S tokens or more and the gather below that.
# Both select single table entries, so they give the same values (with
# f32 matmuls in full f32, PyTorch's default).
_BIAS_EXPAND = "auto"      # 'auto' | 'gather' | 'separable'
_SEPARABLE_MIN_S = 1024


def set_bias_expand(mode: str) -> str:
    """Select how PosEmbMLPSwinv2D expands its CPB table into the dense
    (H, S, S) bias; returns the previous mode. Read at every forward."""
    global _BIAS_EXPAND
    if mode not in ("auto", "gather", "separable"):
        raise ValueError(f"bias expansion {mode!r}: 'auto', 'gather' or "
                         "'separable'")
    prev, _BIAS_EXPAND = _BIAS_EXPAND, mode
    return prev


def _delta_onehot(n: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """(n, n, 2n-1) constant with [p, q, a] = 1 iff p - q + n - 1 == a."""
    i = torch.arange(n, device=device)
    a = torch.arange(2 * n - 1, device=device)
    return (i[:, None, None] - i[None, :, None] + n - 1 == a).to(dtype)


class PosEmbMLPSwinv2D(nn.Module):
    """SwinV2-style continuous relative position bias, returned as a dense
    (num_heads, seq_length, seq_length) tensor for the attention kernel.

    `window_size` is an int or (wh, ww); the table's coordinates are
    spread over `pretrained_window_size` (default: the window) and
    log-spaced unless `no_log`. 16·sigmoid is applied to the small table
    before the expansion (the two commute). The carrier tokens are the
    seq_length - wh·ww first ones: their rows and columns are zero, or,
    with `ct_correct`, the bias rows and columns of the window tokens at
    `_ct_correct_indices` (JAX layers.py:314-326), the window block then
    zero. The (S², ) gather index is kept only for windows that 'auto'
    expands by gather: at S = 2304 it would take 42.5 MB a module. In
    deploy mode the bias is read from `relative_bias`."""

    def __init__(self, window_size, num_heads: int, seq_length: int,
                 pretrained_window_size=None, no_log: bool = False,
                 ct_correct: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = _pair(window_size)
        pretrained = _pair(window_size if pretrained_window_size is None
                           else pretrained_window_size)
        self.window_tokens = self.window_size[0] * self.window_size[1]
        self.seq_length = seq_length
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.register_buffer(
            "relative_coords_table",
            torch.as_tensor(_log_cpb_table(self.window_size, pretrained,
                                           no_log)),
            persistent=False)
        index = None
        if self.window_tokens < _SEPARABLE_MIN_S:
            index = torch.as_tensor(
                _relative_position_index(self.window_size).reshape(-1))
        self.register_buffer("relative_position_index", index,
                             persistent=False)
        n_global = seq_length - self.window_tokens
        self.ct_correct = ct_correct and n_global > 0
        self.register_buffer(
            "ct_correct_index",
            torch.as_tensor(_ct_correct_indices(self.window_size[0],
                                                n_global))
            if self.ct_correct else None, persistent=False)
        self.register_buffer("relative_bias", None, persistent=False)

    def _expand_gather(self, table: torch.Tensor) -> torch.Tensor:
        index = self.relative_position_index
        if index is None:
            index = torch.as_tensor(
                _relative_position_index(self.window_size).reshape(-1),
                device=table.device)
        s = self.window_tokens
        return table[index].reshape(s, s, self.num_heads).permute(2, 0, 1)

    def _expand_separable(self, table: torch.Tensor) -> torch.Tensor:
        # bias[h, (rp, cp), (rq, cq)] = T[rp - rq + wh - 1, cp - cq + ww - 1, h]
        # is block-Toeplitz in the 2D offsets, so the S²-row gather factors
        # into two one-hot contractions that write the (H, S, S) layout
        (wh, ww), s = self.window_size, self.window_tokens
        t3 = table.reshape(2 * wh - 1, 2 * ww - 1, self.num_heads)
        m1 = torch.einsum("pqa,abh->pqbh",
                          _delta_onehot(wh, table.dtype, table.device), t3)
        bias = torch.einsum("xyb,pqbh->hpxqy",
                            _delta_onehot(ww, table.dtype, table.device), m1)
        return bias.reshape(self.num_heads, s, s)

    def _ct_corrected(self, bias: torch.Tensor) -> torch.Tensor:
        """The (H, S, S) bias of the ct_correct mode from the window's
        (H, s, s): [[bias[idx, idx], bias[idx, :]], [bias[:, idx], 0]]."""
        idx, s = self.ct_correct_index, self.window_tokens
        rows = bias[:, idx]                                   # (H, n, s)
        top = torch.cat([rows[:, :, idx], rows], 2)           # (H, n, S)
        bottom = torch.cat([bias[:, :, idx], bias.new_zeros(
            self.num_heads, s, s)], 2)                        # (H, s, S)
        return torch.cat([top, bottom], 1)

    def compute(self) -> torch.Tensor:
        """The dense (num_heads, seq_length, seq_length) bias, from the
        parameters."""
        table = 16.0 * torch.sigmoid(self.cpb_mlp(self.relative_coords_table))
        mode = _BIAS_EXPAND
        if mode == "auto":
            mode = ("separable" if self.window_tokens >= _SEPARABLE_MIN_S
                    else "gather")
        bias = (self._expand_separable(table) if mode == "separable"
                else self._expand_gather(table))
        n_global = self.seq_length - self.window_tokens
        if self.ct_correct:
            bias = self._ct_corrected(bias)
        elif n_global > 0:
            bias = F.pad(bias, (n_global, 0, n_global, 0))
        return bias.contiguous()

    def forward(self) -> torch.Tensor:
        if self.relative_bias is not None:
            return self.relative_bias
        return self.compute()


def is_bakeable(module: nn.Module) -> bool:
    """Whether deploy mode stores `module`'s tensor: every position
    embedding but a dynamic-mode (`norm_by_seq`) one."""
    return (isinstance(module, PosEmbMLPSwinv2D)
            or (isinstance(module, PosEmbMLPSwinv1D)
                and not module.norm_by_seq))


class WindowAttention(nn.Module):
    """MHSA over a window (plus the carrier tokens in front of it) with the
    CPB bias: qkv -> bias -> window attention kernel -> proj -> dropout.

    With attention dropout (attn_drop > 0) in training, `window_mhsa`
    routes it to `ops.attention.dropout_window_mhsa`, the plain version
    with the dropout, its mask drawn from `generator`
    (`set_drop_path_generator`; torch's default generator if None): the
    JAX package's route for it (ops/attention.py:64-70), since the kernels
    compute no dropout. In eval mode the kernels run as without dropout.

    `ct_correct` is the bias's carrier-token mode (`PosEmbMLPSwinv2D`);
    the kernels read the dense bias either way."""

    def __init__(self, dim: int, num_heads: int, resolution: int,
                 seq_length: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, ct_correct: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop = attn_drop
        self.generator: Optional[torch.Generator] = None
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)
        self.pos_emb_funct = PosEmbMLPSwinv2D(resolution, num_heads,
                                              seq_length,
                                              ct_correct=ct_correct)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = window_mhsa(self.qkv(x), self.pos_emb_funct(), self.num_heads,
                          self.scale, self.attn_drop if self.training else 0.0,
                          self.generator)
        return self.proj_drop(self.proj(ctx))


class PatchEmbed(nn.Module):
    """Stride-4 conv stem: (conv3x3 s2 -> BN eps 1e-4 -> ReLU) x 2."""

    def __init__(self, in_chans: int, in_dim: int, dim: int):
        super().__init__()
        self.conv_down = nn.Sequential(
            nn.Conv2d(in_chans, in_dim, 3, 2, 1, bias=False),
            BatchNorm2d(in_dim, eps=1e-4), nn.ReLU(),
            nn.Conv2d(in_dim, dim, 3, 2, 1, bias=False),
            BatchNorm2d(dim, eps=1e-4), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_down(x)


class ConvBlock(nn.Module):
    """Residual conv block: conv3x3 -> BN -> GELU -> conv3x3 -> BN, optional
    layer scale, DropPath."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale: Optional[float] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, 1, 1)
        self.norm1 = BatchNorm2d(dim, eps=1e-5)
        self.act1 = nn.GELU()
        self.conv2 = nn.Conv2d(dim, dim, 3, 1, 1)
        self.norm2 = BatchNorm2d(dim, eps=1e-5)
        self.gamma = (nn.Parameter(torch.full((dim,), float(layer_scale)))
                      if layer_scale is not None else None)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm2(self.conv2(self.act1(self.norm1(self.conv1(x)))))
        if self.gamma is not None:
            y = y * self.gamma[:, None, None]
        return x + self.drop_path(y)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (timm LayerNorm2d)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class Downsample(nn.Module):
    """LayerNorm2d (eps 1e-6) -> conv3x3 stride 2 (dim -> 2*dim, no bias)."""

    def __init__(self, dim: int, keep_dim: bool = False):
        super().__init__()
        self.norm = LayerNorm2d(dim, eps=1e-6)
        out = dim if keep_dim else 2 * dim
        self.reduction = nn.Sequential(nn.Conv2d(dim, out, 3, 2, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduction(self.norm(x))


class TokenInitializer(nn.Module):
    """Carrier-token initializer: depthwise conv position embedding, then an
    average pool to a (ct*srH, ct*srW) grid, then a window-grouped flatten.

    The pool's kernel and stride are integer math on the padded resolution
    (for FasterViT-0 level 2: kernel 5, stride 3 on 14x14). The conv is
    registered under two names, `pos_embed` and `to_global_feature.pos`, as
    upstream registers it.

    With `raster_output` (the detection backbones' dynamic mode,
    layers.py:516-525) the pooled grid is padded to a ct_size multiple and
    flattened in raster order instead."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 window_size: int, ct_size: int = 1,
                 raster_output: bool = False):
        super().__init__()
        self.ct_size = ct_size
        self.raster_output = raster_output
        kernel, stride = [], []
        for r in input_resolution:
            out = int(ct_size * r / window_size)
            stride.append(int(r / out))
            kernel.append(r - (out - 1) * stride[-1])
        self.pos_embed = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.to_global_feature = nn.Sequential()
        self.to_global_feature.add_module("pos", self.pos_embed)
        self.to_global_feature.add_module(
            "pool", nn.AvgPool2d(tuple(kernel), tuple(stride)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, hc*wc, C) carrier tokens, window-grouped."""
        x = self.to_global_feature(x)
        cs = self.ct_size
        if self.raster_output:
            pad_b, pad_r = (-x.shape[2]) % cs, (-x.shape[3]) % cs
            if pad_b or pad_r:
                x = F.pad(x, (0, pad_r, 0, pad_b))
            return x.flatten(2).transpose(1, 2)
        x = x.permute(0, 2, 3, 1)  # (B, hc, wc, C)
        b, hc, wc, c = x.shape
        ct = x.reshape(b, hc // cs, cs, wc // cs, cs, c)
        ct = ct.permute(0, 1, 3, 2, 4, 5)  # (B, nWh, nWw, cs, cs, C)
        return ct.reshape(b, hc * wc, c)


class HAT(nn.Module):
    """Hierarchical-attention block.

    Carrier tokens run a global MHSA in raster order, are re-grouped per
    window and concatenated in front of the window tokens for a joint
    windowed MHSA, then split back; the last block of a level can propagate
    the carriers into the window tokens.

    `dynamic_mode` is the detection backbones' variant (fastervit_tpu/
    models/layers.py:657-705): both position embeddings normalize their
    grid by the token count (`norm_by_seq`), and the carriers get theirs
    on rectangular grids too."""

    # set by ops.quant.quantize_model: int8 layers route every sub-block
    # through the composed path, as JAX's `quantized` flag does
    quantized = False

    def __init__(self, dim: int, num_heads: int, sr_ratio: Tuple[int, int],
                 window_size: int, ct_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path: float = 0.0, layer_scale: Optional[float] = None,
                 last: bool = False, do_propagation: bool = False,
                 dynamic_mode: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        ws, cs = window_size, ct_size
        # the fused block computes no dropout (JAX layers.py:588-589)
        self.dropout = drop > 0.0 or attn_drop > 0.0
        self.window_size, self.ct_size = ws, cs
        self.do_sr_hat = sr_ratio[0] > 1 or sr_ratio[1] > 1
        self.propagate = last and do_propagation and self.do_sr_hat
        self.cr_per_window = cs * cs if self.do_sr_hat else 0
        self.grid = (cs * sr_ratio[0], cs * sr_ratio[1])
        hidden = int(dim * mlp_ratio)

        def gamma():
            return (nn.Parameter(torch.full((dim,), float(layer_scale)))
                    if layer_scale is not None else None)

        self.pos_embed = PosEmbMLPSwinv1D(dim, seq_length=ws * ws,
                                          grid=(ws, ws),
                                          norm_by_seq=dynamic_mode)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, resolution=ws,
                                    seq_length=ws * ws + self.cr_per_window,
                                    qkv_bias=qkv_bias, qk_scale=qk_scale,
                                    attn_drop=attn_drop, proj_drop=drop)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, hidden, drop)
        self.gamma3, self.gamma4 = gamma(), gamma()
        if self.do_sr_hat:
            cr_total = self.grid[0] * self.grid[1]
            self.hat_norm1 = nn.LayerNorm(dim, eps=1e-5)
            self.hat_attn = WindowAttention(
                dim, num_heads, resolution=int(cr_total ** 0.5),
                seq_length=cr_total, qkv_bias=qkv_bias, qk_scale=qk_scale,
                attn_drop=attn_drop, proj_drop=drop)
            self.hat_drop_path = DropPath(drop_path)
            self.hat_norm2 = nn.LayerNorm(dim, eps=1e-5)
            self.hat_mlp = Mlp(dim, hidden, drop)
            self.hat_pos_embed = (
                PosEmbMLPSwinv1D(dim, seq_length=cr_total, grid=self.grid,
                                 norm_by_seq=dynamic_mode)
                if sr_ratio[0] == sr_ratio[1] or dynamic_mode else None)
            self.gamma1, self.gamma2 = gamma(), gamma()

    def _sub_block(self, x, norm1, attn, norm2, mlp, g_attn, g_mlp,
                   drop_path):
        """One pre-LN attention + MLP residual pair: through the fused HAT
        block (K6 on the card) when `set_fused_hat` is on, the module is in
        eval mode, not quantised, has no dropout and K6 takes the shape (JAX
        layers.py:586-631); else composed."""
        hidden = mlp.fc1.out_features
        if (_FUSED_HAT and not self.training and not self.quantized
                and not self.dropout
                and attn.qkv.bias is not None
                and fused_block_supported(x.shape, x.shape[-1], hidden,
                                          attn.num_heads)):
            params = hat_block_params(norm1, attn, norm2, mlp, g_attn, g_mlp,
                                      compute_dtype(x))
            return fused_hat_block(x, params, attn.pos_emb_funct(),
                                   attn.num_heads, attn.scale)
        y = attn(norm1(x))
        x = x + drop_path(y if g_attn is None else g_attn * y)
        y = mlp(norm2(x))
        return x + drop_path(y if g_mlp is None else g_mlp * y)

    def forward(self, x: torch.Tensor, ct: Optional[torch.Tensor]):
        """x: (B*nW, ws*ws, C) window tokens; ct: (B, nW*cs*cs, C) carrier
        tokens in window-grouped order, or None without carriers."""
        b, _, c = x.shape
        x = self.pos_embed(x)
        if self.do_sr_hat:
            gh, gw = self.grid
            ct_shape = ct.shape
            ct = ct_dewindow(ct, gh, gw, self.ct_size)
            if self.hat_pos_embed is not None:
                ct = self.hat_pos_embed(ct)
            ct = self._sub_block(ct, self.hat_norm1, self.hat_attn,
                                 self.hat_norm2, self.hat_mlp, self.gamma1,
                                 self.gamma2, self.hat_drop_path)
            ct = ct_window(ct, gh, gw, self.ct_size)
            x = torch.cat([ct.reshape(b, self.cr_per_window, c), x], dim=1)

        x = self._sub_block(x, self.norm1, self.attn, self.norm2, self.mlp,
                            self.gamma3, self.gamma4, self.drop_path)

        if self.do_sr_hat:
            ctr, x = x[:, :self.cr_per_window], x[:, self.cr_per_window:]
            ct = ctr.reshape(ct_shape)
            if self.propagate:
                # upsample each window's carrier patch into its tokens, in
                # f32 as the reference does
                up = nearest_upsample_tokens(ctr.float(), self.ct_size,
                                             self.window_size).to(x.dtype)
                x = x + (up if self.gamma1 is None else self.gamma1 * up)
        return x, ct
