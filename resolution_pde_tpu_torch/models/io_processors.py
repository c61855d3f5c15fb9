"""Input/output processors of the configurable S4 models: reshapes and
concatenations between the datasets' layouts (B, T, Sx, [Sy], H) and the
backbones' (batch, sequence, hidden).

Counterpart of resolution_pde_tpu/models/io_processors.py (the reference's
models/custom_layer.py:144-437): the same functions on torch tensors,
under the same registry names. Only ``BatchSpaceConv`` holds parameters.
"""

from __future__ import annotations

import torch
from einops import rearrange, repeat
from torch import nn

from resolution_pde_tpu_torch.models.norms import lecun_normal_


# ---- grid input processors (custom_layer.py:223-277) ----

def concat(x, grid):
    """(B, S..., H) + (B, S..., 1) -> concat on channels."""
    return torch.cat([x, grid], dim=-1)


def concat_nd(x, grid):
    """(B, S, H): unsqueeze features and attach grid per feature."""
    h = x.shape[-1]
    return torch.cat([x[..., None], repeat(grid, "b s g -> b s c g", c=h)],
                     dim=-1)


def concat_trans_squeeze_1d(x, grid):
    """(B, S, 1) + (B, S, 1) -> (B, 2S)."""
    return torch.cat([x[..., 0], grid[..., 0]], dim=-1)


def concat_flat_trans(x, grid):
    """(B, S, T, H) + (B, S, 1) -> (B, T, S*H + S)."""
    t = x.shape[2]
    x = rearrange(x, "b s t h -> b t (s h)")
    grid = repeat(rearrange(grid, "b s h -> b (s h)"), "b h -> b t h", t=t)
    return torch.cat([x, grid], dim=-1)


def concat_trans(x, grid):
    """(B, S..., T, H) + (B, S..., 1) -> (B, T, S..., H+1)."""
    t = x.shape[-2]
    x = rearrange(x, "b ... t h -> b t ... h")
    grid = repeat(grid, "b ... h -> b t ... h", t=t)
    return torch.cat([x, grid], dim=-1)


GRID_INPUT_REGISTRY = {
    "Concat": concat,
    "ConcatND": concat_nd,
    "ConcatTransSqueeze1D": concat_trans_squeeze_1d,
    "ConcatFlatTrans": concat_flat_trans,
    "ConcatTrans": concat_trans,
}


# ---- input processors (custom_layer.py:280-338, 378-409) ----

def input_id(x):
    return x


def batch_time(x):
    """(B, T, S..., H) -> ((B T), S..., H)."""
    return rearrange(x, "b t ... h -> (b t) ... h")


def batch_space(x):
    """(B, T, S..., H) -> ((B S...), T, H)."""
    return rearrange(x, "b t ... h -> (b ...) t h")


def space_to_hidden(x):
    """(B, T, S, H) -> (B, T, (S H))."""
    return rearrange(x, "b t s h -> b t (s h)")


INPUT_REGISTRY = {
    "identity": input_id,
    "BatchTime": batch_time,
    "BatchSpace": batch_space,
    "SpaceToHidden": space_to_hidden,
}


class BatchSpaceConv(nn.Module):
    """A spatial convolution (SAME padding, flax's conv init) over each
    frame, then the batch-space reshape (custom_layer.py:
    388-409): (B, T, S..., H) -> ((B S...), T, d_model). Torch needs the
    input features (``in_features``), which flax infers."""

    def __init__(self, in_features: int, d_model: int = 128,
                 kernel_size: int = 3, dim: int = 1, *, generator=None):
        super().__init__()
        # torch's 'same' pads as lax's SAME: an even kernel one more high
        self.conv = (nn.Conv1d, nn.Conv2d, nn.Conv3d)[dim - 1](
            in_features, d_model, kernel_size, padding="same")
        lecun_normal_(self.conv.weight, in_features * kernel_size ** dim,
                      generator)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x):
        b, t = x.shape[:2]
        xs = rearrange(x, "b t ... h -> (b t) h ...")
        xs = rearrange(self.conv(xs), "(b t) h ... -> b t ... h", b=b, t=t)
        return rearrange(xs, "b t ... h -> (b ...) t h")


# ---- output processors (custom_layer.py:169-203, 293-349) ----

def out_id(x, input_shape):
    return x


def squeeze(x, input_shape):
    if x.shape[-1] != 1:
        raise ValueError(f"Squeeze needs a last axis of 1, got {x.shape}")
    return x[..., 0]


def unsqueeze(x, input_shape):
    return x[..., None]


def unflat_trans(x, input_shape):
    """(B, T, (S D)) -> (B, S, T, D)."""
    d = input_shape[-1]
    return rearrange(x, "b t (s d) -> b s t d", s=x.shape[-1] // d, d=d)


def trans(x, input_shape):
    """(B, T, S..., H) -> (B, S..., T, H)."""
    return rearrange(x, "b t ... h -> b ... t h")


def unbatch_time(x, input_shape):
    b, t = input_shape[0], input_shape[1]
    return rearrange(x, "(b t) ... h -> b t ... h", b=b, t=t)


def unbatch_space(x, input_shape):
    """((B S...), T, H) -> (B, T, S..., H)."""
    b = input_shape[0]
    spatial = tuple(input_shape[2:-1])
    names = ["sx", "sy", "sz"][:len(spatial)]
    pattern = " ".join(names)
    return rearrange(x, f"(b {pattern}) t h -> b t {pattern} h", b=b,
                     **dict(zip(names, spatial)))


def space_from_hidden(x, input_shape):
    b, t, s, h = input_shape
    return rearrange(x, "b t (s h) -> b t s h", s=s, h=h)


OUTPUT_REGISTRY = {
    "identity": out_id,
    "Squeeze": squeeze,
    "Unsqueeze": unsqueeze,
    "UnflatTrans": unflat_trans,
    "UnbatchTime": unbatch_time,
    "UnbatchSpace": unbatch_space,
    "SpaceFromHidden": space_from_hidden,
    "Trans": trans,
}
