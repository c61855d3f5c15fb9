"""Poseidon's scOT operator (ScOT2d, a hierarchical SwinV2 encoder/decoder)
and a shifted-window transformer operator (SwinOperator2d), both with
lead-time conditioning.

Counterpart of resolution_pde_tpu/models/poseidon.py. Both take (B, C_in,
H, W) and a time (a scalar or (B,)) and return {'output': (B, C_out, H,
W)}, the reference's calling convention (train/training.py:33-34); inside
they run channels-last, (B, H, W, C), as the JAX package does.

SwinOperator2d: a patch conv, a sinusoidal time embedding through an MLP,
blocks of windowed attention with a learned (heads, T, T) bias, every
second block on windows rolled by half a window, each block's LayerNorm
scaled by (1 + Dense(time)), then a transposed conv back to the grid, GELU
and a 1x1 conv.

ScOT2d: SwinV2 blocks (cosine attention, exp of the clamped learned logit
scale, the 16·sigmoid(CPB-MLP) continuous position bias, the additive
mask of shifted windows, post-norm residuals), the window clamped to the
grid and the shift dropped where the window covers it; patch merging
down, patch expanding up, ConvNeXt blocks on the skips, a Dense fusing
each skip; the LayerNorms conditioned on the raw time (LN(x)·(1 + a(t)) +
b(t)); pixel-shuffle patch recovery and a 1x1 head; ``learn_residual``
adds the input.

The bare LayerNorms of SwinOperator2d are flax's ``nn.LayerNorm()``,
epsilon 1e-6; ScOT's take ``layer_norm_eps``. The normalised q and k are
JAX's q / (|q| + 1e-12), not ``F.normalize``'s max(|q|, eps). The shift
masks, relative-position indices and CPB tables are made once per window
shape on the device (``_device_constant``): made per call, each would be
a copy from the host inside a captured CUDA graph, which capture refuses.
Kernels are initialised as flax's (lecun normal), biases zero, from
``generator`` on the CPU, then moved to ``device``.
``utils.jax_bridge.swin_operator2d_state_dict`` / ``scot2d_state_dict``
map the JAX package's parameters onto these names.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from resolution_pde_tpu_torch.models.layers import gelu
from resolution_pde_tpu_torch.models.norms import lecun_normal_, linear

# flax's nn.LayerNorm() default epsilon
FLAX_LN_EPS = 1e-6


def load_pretrained_poseidon(model_name: str = "camlab-ethz/Poseidon-B",
                             **config_overrides):
    """The reference's path: ScOT.from_pretrained (main_1d.py:107-110),
    through the external scOT package."""
    try:
        from scOT.model import ScOT, ScOTConfig  # type: ignore
    except ImportError as e:
        raise ImportError(
            "the scOT package is not installed; use "
            "resolution_pde_tpu_torch.models.poseidon.ScOT2d for the "
            "architecture, or install scOT to load pretrained Poseidon "
            "checkpoints") from e
    config = ScOTConfig(**config_overrides)
    return ScOT.from_pretrained(model_name, config=config,
                                ignore_mismatched_sizes=True)


_CONSTANTS: dict = {}


def _device_constant(key: tuple, build, device) -> torch.Tensor:
    """``build()`` (a numpy array) on ``device``, made once per key and
    device and kept: the first call must run outside graph capture (the
    serving engine runs a bucket once eagerly before it captures it). It
    is made as a normal tensor even under inference mode, so that a
    constant first made in an evaluation serves training later."""
    k = key + (str(device),)
    t = _CONSTANTS.get(k)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(build()).to(device)
        _CONSTANTS[k] = t
    return t


def _patch_conv(in_channels: int, out_channels: int, p: int,
                generator) -> nn.Conv2d:
    """flax's nn.Conv(out, (p, p), strides=(p, p)), lecun normal."""
    m = nn.Conv2d(in_channels, out_channels, p, stride=p)
    lecun_normal_(m.weight, in_channels * p * p, generator)
    nn.init.zeros_(m.bias)
    return m


def _same_pad(x, p: int):
    """flax's SAME padding of a kernel-p stride-p conv on NCHW x: none
    where p divides the grid, else the lower half of the pad before."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // p) - 1) * p + p - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _time_vector(time, b: int, like: torch.Tensor) -> torch.Tensor:
    """(b,) f32 on x's device: a scalar filled on the device, a tensor
    broadcast (a scalar as a host tensor would be a copy from the host)."""
    if isinstance(time, torch.Tensor):
        t = time.to(device=like.device, dtype=torch.float32).reshape(-1)
        return t.expand(b) if t.numel() == 1 else t[:b]
    return torch.full((b,), float(time), dtype=torch.float32,
                      device=like.device)


def _window_partition(x, ws: int):
    """(B, H, W, C) -> (B*nH*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _window_merge(windows, ws: int, h: int, w: int):
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class _WindowAttention(nn.Module):
    """Softmax attention on (nW, T, C) windows with a learned (heads, T, T)
    bias, T = window_size²."""

    def __init__(self, dim: int, n_heads: int, window_size: int,
                 generator=None):
        super().__init__()
        self.n_heads = n_heads
        t = window_size * window_size
        self.qkv = linear(dim, 3 * dim, generator=generator)
        self.rel_bias = nn.Parameter(
            0.02 * torch.randn(n_heads, t, t, generator=generator))
        self.proj = linear(dim, dim, generator=generator)

    def forward(self, x):
        nw, t, c = x.shape
        hs = c // self.n_heads
        qkv = self.qkv(x).reshape(nw, t, 3, self.n_heads, hs)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.einsum("nhtd,nhsd->nhts", q, k) / np.sqrt(hs)
        attn = torch.softmax(attn + self.rel_bias[None], dim=-1)
        out = torch.einsum("nhts,nhsd->nhtd", attn, v)
        return self.proj(out.transpose(1, 2).reshape(nw, t, c))


class _SwinBlock(nn.Module):
    """LN(x)·(1 + Dense(t)) -> (rolled) window attention -> residual;
    LN -> Dense(4c) -> GELU -> Dense(c) -> residual."""

    def __init__(self, dim: int, n_heads: int, window_size: int,
                 shift: bool, generator=None):
        super().__init__()
        g = generator
        self.window_size, self.shift = window_size, shift
        self.time_scale = linear(dim, dim, generator=g)
        self.norm1 = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.attn = _WindowAttention(dim, n_heads, window_size, g)
        self.norm2 = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.fc1 = linear(dim, 4 * dim, generator=g)
        self.fc2 = linear(4 * dim, dim, generator=g)

    def forward(self, x, t_embed):
        """x: (B, H, W, C); t_embed: (B, C)."""
        b, h, w, c = x.shape
        ws = self.window_size
        scale = self.time_scale(t_embed)[:, None, None, :]
        shortcut = x
        x = self.norm1(x) * (1 + scale)
        if self.shift:
            x = torch.roll(x, (-(ws // 2), -(ws // 2)), dims=(1, 2))
        x = _window_merge(self.attn(_window_partition(x, ws)), ws, h, w)
        if self.shift:
            x = torch.roll(x, (ws // 2, ws // 2), dims=(1, 2))
        x = shortcut + x
        return x + self.fc2(gelu(self.fc1(self.norm2(x))))


class SwinOperator2d(nn.Module):
    """Shifted-window transformer operator with lead-time conditioning.

    Input (B, C_in, H, W), time (B,) or scalar -> {'output':
    (B, C_out, H, W)}.
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 embed_dim: int = 48, depths: Sequence[int] = (2, 2),
                 n_heads: int = 4, window_size: int = 8,
                 patch_size: int = 4, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g, p, e = generator, patch_size, embed_dim
        self.patch_size, self.embed_dim = p, e
        self.patch_embed = _patch_conv(in_channels, e, p, g)
        half = e // 2
        self.time_mlp0 = linear(2 * half, e, generator=g)
        self.time_mlp1 = linear(e, e, generator=g)
        self.blocks = nn.ModuleList(
            _SwinBlock(e, n_heads, window_size, shift=bool(i % 2),
                       generator=g)
            for d in depths for i in range(d))
        self.de_embed = nn.ConvTranspose2d(e, e, p, stride=p)
        # flax's ConvTranspose init: lecun normal over its (p, p, in) fan
        lecun_normal_(self.de_embed.weight, e * p * p, g)
        nn.init.zeros_(self.de_embed.bias)
        self.head = nn.Conv2d(e, out_channels, 1)
        lecun_normal_(self.head.weight, e, g)
        nn.init.zeros_(self.head.bias)
        if device is not None:
            self.to(device)

    def forward(self, x, time=1.0):
        b, _, h0, w0 = x.shape
        p = self.patch_size
        x = self.patch_embed(_same_pad(x, p)).permute(0, 2, 3, 1)
        t = _time_vector(time, b, x)
        half = self.embed_dim // 2
        freqs = torch.exp(-math.log(1e4) * torch.arange(
            half, dtype=torch.float32, device=x.device) / max(half - 1, 1))
        temb = torch.cat([torch.sin(t[:, None] * freqs),
                          torch.cos(t[:, None] * freqs)], dim=-1)
        temb = self.time_mlp1(gelu(self.time_mlp0(temb)))
        for block in self.blocks:
            x = block(x, temb)
        x = gelu(self.de_embed(x.permute(0, 3, 1, 2)))
        x = self.head(x)
        return {"output": x[:, :, :h0, :w0]}


# ---------------------------------------------------------------------------
# ScOT (Poseidon): hierarchical SwinV2 encoder/decoder
# ---------------------------------------------------------------------------


def _log_cpb_table(ws: int):
    """SwinV2 log-spaced relative-coords table, (1, 2ws-1, 2ws-1, 2)."""
    rel = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(rel, rel, indexing="ij"), axis=-1)[None]
    if ws > 1:
        table = table / (ws - 1)
    table = table * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.astype(np.float32)


def _rel_position_index(ws: int):
    """(ws*ws, ws*ws) index into the flattened (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attention_mask(h: int, w: int, ws: int, shift: int):
    """Additive mask (n_windows_per_image, T, T) of shifted windows
    (Swinv2Layer.get_attn_mask)."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class Swinv2WindowAttention(nn.Module):
    """SwinV2 self-attention on windows (modeling_swinv2.
    Swinv2SelfAttention + Swinv2SelfOutput). The window is the forward's
    (the block clamps it to the grid); the parameters do not depend on
    it."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 generator=None):
        super().__init__()
        g = generator
        self.num_heads = num_heads
        self.query = linear(dim, dim, bias=qkv_bias, generator=g)
        self.key = linear(dim, dim, bias=False, generator=g)
        self.value = linear(dim, dim, bias=qkv_bias, generator=g)
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp0 = linear(2, 512, generator=g)
        self.cpb_mlp1 = linear(512, num_heads, bias=False, generator=g)
        self.proj = linear(dim, dim, generator=g)

    def position_bias(self, ws: int, device) -> torch.Tensor:
        """16·sigmoid of the CPB-MLP's table, (heads, T, T)."""
        nh, t = self.num_heads, ws * ws
        table = _device_constant(("cpb", ws), lambda: _log_cpb_table(ws),
                                 device)
        idx = _device_constant(
            ("rel_index", ws),
            lambda: _rel_position_index(ws).reshape(-1).astype(np.int64),
            device)
        bias_table = self.cpb_mlp1(F.relu(self.cpb_mlp0(table)))
        bias = bias_table.reshape(-1, nh)[idx].reshape(t, t, nh)
        return 16.0 * torch.sigmoid(bias.permute(2, 0, 1))

    def forward(self, x, ws: int, mask=None):
        """x: (nW, T, C); mask: (n_regions, T, T) additive or None."""
        nw, t, c = x.shape
        nh = self.num_heads
        hs = c // nh
        q, k, v = (a.reshape(nw, t, nh, hs).transpose(1, 2)
                   for a in (self.query(x), self.key(x), self.value(x)))
        qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        kn = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        attn = torch.einsum("nhtd,nhsd->nhts", qn, kn)
        attn = attn * torch.exp(torch.clamp(self.logit_scale,
                                            max=math.log(100.0)))
        attn = attn + self.position_bias(ws, x.device)[None]
        if mask is not None:
            nr = mask.shape[0]
            attn = attn.reshape(nw // nr, nr, nh, t, t) + mask[None, :, None]
            attn = attn.reshape(nw, nh, t, t)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("nhts,nhsd->nhtd", attn, v)
        return self.proj(out.transpose(1, 2).reshape(nw, t, c))


class CondLayerNorm(nn.Module):
    """Lead-time-conditioned LayerNorm (Poseidon): LN(x)·(1 + a(t)) + b(t),
    a and b zero-initialised so conditioning starts as the identity."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 use_conditioning: bool = True):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=eps)
        self.use_conditioning = use_conditioning
        if use_conditioning:
            self.alpha = nn.Linear(1, dim)
            self.beta = nn.Linear(1, dim)
            for m in (self.alpha, self.beta):
                nn.init.zeros_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x, temb):
        y = self.norm(x)
        if not self.use_conditioning or temb is None:
            return y
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        return (y * (1.0 + self.alpha(temb).reshape(shape))
                + self.beta(temb).reshape(shape))


class Swinv2Block(nn.Module):
    """One SwinV2 layer, post-norm (Swinv2Layer.forward): x = x +
    CLN(attn(x)); x = x + CLN(mlp(x))."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, layer_norm_eps: float = 1e-5,
                 use_conditioning: bool = True, generator=None):
        super().__init__()
        g = generator
        self.window_size, self.shift = window_size, shift
        self.attention = Swinv2WindowAttention(dim, num_heads, qkv_bias, g)
        self.layernorm_before = CondLayerNorm(dim, layer_norm_eps,
                                              use_conditioning)
        hidden = int(mlp_ratio * dim)
        self.intermediate = linear(dim, hidden, generator=g)
        self.output = linear(hidden, dim, generator=g)
        self.layernorm_after = CondLayerNorm(dim, layer_norm_eps,
                                             use_conditioning)

    def forward(self, x, temb):
        """x: (B, H, W, C)."""
        b, h, w, c = x.shape
        # Swinv2Layer._compute_window_shift: the window clamped to the grid,
        # no shift where the window covers it
        ws = min(self.window_size, h, w)
        shift = 0 if min(h, w) <= self.window_size else self.shift
        if h % ws or w % ws:
            raise ValueError(f"grid ({h},{w}) must be divisible by window "
                             f"{ws}")
        if shift > 0:
            xs = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _device_constant(
                ("shift_mask", h, w, ws, shift),
                lambda: _shift_attention_mask(h, w, ws, shift), x.device)
        else:
            xs, mask = x, None
        wins = self.attention(_window_partition(xs, ws), ws, mask)
        xs = _window_merge(wins, ws, h, w)
        if shift > 0:
            xs = torch.roll(xs, (shift, shift), dims=(1, 2))
        x = x + self.layernorm_before(xs, temb)
        y = self.output(gelu(self.intermediate(x)))
        return x + self.layernorm_after(y, temb)


class PatchMerging(nn.Module):
    """SwinV2 patch merging: 4-corner concat -> Linear(4C->2C, no bias) ->
    LN (Swinv2PatchMerging.forward)."""

    def __init__(self, dim: int, layer_norm_eps: float = 1e-5,
                 generator=None):
        super().__init__()
        self.reduction = linear(4 * dim, 2 * dim, bias=False,
                                generator=generator)
        self.norm = nn.LayerNorm(2 * dim, eps=layer_norm_eps)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.norm(self.reduction(x))


class PatchExpanding(nn.Module):
    """Decoder upsample, the inverse of patch merging: Linear(C->2C, no
    bias) -> pixel-shuffle 2x to C/2 channels -> LN."""

    def __init__(self, dim: int, layer_norm_eps: float = 1e-5,
                 generator=None):
        super().__init__()
        self.expansion = linear(dim, 2 * dim, bias=False,
                                generator=generator)
        self.norm = nn.LayerNorm(dim // 2, eps=layer_norm_eps)

    def forward(self, x):
        b, h, w, c = x.shape
        x = self.expansion(x).reshape(b, h, w, 2, 2, c // 2)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c // 2)
        return self.norm(x)


class ConvNeXtBlock(nn.Module):
    """ConvNeXt block of the skip connections: depthwise 7x7 conv (SAME)
    -> CLN -> Linear(4x) -> GELU -> Linear -> layer-scale residual."""

    def __init__(self, dim: int, layer_norm_eps: float = 1e-5,
                 use_conditioning: bool = True, generator=None):
        super().__init__()
        g = generator
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        lecun_normal_(self.dwconv.weight, 49, g)
        nn.init.zeros_(self.dwconv.bias)
        self.norm = CondLayerNorm(dim, layer_norm_eps, use_conditioning)
        self.pwconv1 = linear(dim, 4 * dim, generator=g)
        self.pwconv2 = linear(4 * dim, dim, generator=g)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x, temb=None):
        y = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.pwconv2(gelu(self.pwconv1(self.norm(y, temb))))
        return x + self.gamma * y


class ScOT2d(nn.Module):
    """Poseidon's scOT operator: hierarchical SwinV2 encoder/decoder with
    lead-time conditioning and ConvNeXt skip blocks. The arguments are
    pos.yaml's. Input (B, num_channels, H, W) + time -> {'output':
    (B, num_out_channels, H, W)}; H and W divisible by patch_size and the
    grid at every level by its window."""

    def __init__(self, num_channels: int = 3, num_out_channels: int = 3,
                 patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (8, 8, 8, 8),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 skip_connections: Sequence[int] = (2, 2, 2, 0),
                 window_size: int = 16, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, layer_norm_eps: float = 1e-5,
                 use_conditioning: bool = True, learn_residual: bool = False,
                 residual_model: str = "convnext", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g, p, eps = generator, patch_size, layer_norm_eps
        self.patch_size, self.num_out_channels = p, num_out_channels
        self.use_conditioning = use_conditioning
        self.learn_residual = learn_residual
        n = len(depths)
        dims = [embed_dim * 2 ** level for level in range(n)]
        self.patch_embed = _patch_conv(num_channels, embed_dim, p, g)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=eps)

        def stage(level):
            return nn.ModuleList(
                Swinv2Block(dims[level], num_heads[level], window_size,
                            shift=(window_size // 2) if j % 2 else 0,
                            mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                            layer_norm_eps=eps,
                            use_conditioning=use_conditioning, generator=g)
                for j in range(depths[level]))

        self.encoder = nn.ModuleList(stage(level) for level in range(n))
        self.merge = nn.ModuleList(PatchMerging(dims[level], eps, g)
                                   for level in range(n - 1))
        self.expand = nn.ModuleList(PatchExpanding(dims[level + 1], eps, g)
                                    for level in range(n - 1))
        n_skip = [skip_connections[level]
                  if residual_model == "convnext" else 0
                  for level in range(n - 1)]
        self.skip = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(dims[level], eps, use_conditioning,
                                        g) for _ in range(n_skip[level]))
            for level in range(n - 1))
        self.fuse = nn.ModuleList(linear(2 * dims[level], dims[level],
                                         generator=g)
                                  for level in range(n - 1))
        self.decoder = nn.ModuleList(stage(level) for level in range(n - 1))
        self.final_expand = linear(embed_dim, p * p * embed_dim, bias=False,
                                   generator=g)
        self.final_norm = nn.LayerNorm(embed_dim, eps=eps)
        self.head = nn.Conv2d(embed_dim, num_out_channels, 1)
        lecun_normal_(self.head.weight, embed_dim, g)
        nn.init.zeros_(self.head.bias)
        if device is not None:
            self.to(device)

    def forward(self, x, time=1.0):
        b, _, h0, w0 = x.shape
        x_in = x
        p = self.patch_size
        x = self.patch_embed(_same_pad(x, p)).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        # the lead-time embedding is the raw time, (B, 1); the conditioned
        # LayerNorms learn their own affine maps of it
        temb = (_time_vector(time, b, x)[:, None]
                if self.use_conditioning else None)

        def run(blocks, x):
            for block in blocks:
                x = block(x, temb)
            return x

        skips = []
        for level, merge in enumerate(self.merge):
            x = run(self.encoder[level], x)
            skips.append(x)
            x = merge(x)
        x = run(self.encoder[-1], x)  # bottleneck
        for level in range(len(self.merge) - 1, -1, -1):
            x = self.expand[level](x)
            skip = skips[level]
            for block in self.skip[level]:
                skip = block(skip, temb)
            x = self.fuse[level](torch.cat([x, skip], dim=-1))
            x = run(self.decoder[level], x)
        c = x.shape[-1]
        x = self.final_expand(x).reshape(b, h0 // p, w0 // p, p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h0, w0, c)
        x = self.final_norm(x)
        out = self.head(x.permute(0, 3, 1, 2))
        if self.learn_residual and self.num_out_channels == x_in.shape[1]:
            out = out + x_in
        return {"output": out}
