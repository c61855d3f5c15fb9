"""Shared layers: torch-default initialisers, weight-normed linear, the FFNO
FeedForward.

Counterpart of resolution_pde_tpu/models/layers.py. Parameters use the
reference PyTorch code's names and layouts (``weight`` (out, in),
``weight_v``/``weight_g``, ``layers.{j}.0`` and ``.3`` in FeedForward), so
``resolution_pde_tpu.utils.torch_import`` reads a state_dict of this package
unchanged. The forward passes keep the JAX package's rounding points.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from resolution_pde_tpu_torch.ops.kernels.fused_ff import fused_feedforward


def torch_kernel_init(shape, generator=None) -> torch.Tensor:
    """U(-sqrt(1/fan_in), sqrt(1/fan_in)) for an (out, in) weight: the
    torch.nn.Linear default (kaiming_uniform_ with a=sqrt(5))."""
    bound = math.sqrt(1.0 / shape[-1])
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def torch_bias_init(n: int, fan_in: int, generator=None) -> torch.Tensor:
    bound = math.sqrt(1.0 / fan_in)
    return torch.empty(n).uniform_(-bound, bound, generator=generator)


def xavier_normal_init(shape, generator=None) -> torch.Tensor:
    """torch.nn.init.xavier_normal_ on a (d_out, d_in, ...) weight, with the
    fans over the first two axes times the product of the rest."""
    receptive = math.prod(shape[2:])
    std = math.sqrt(2.0 / (shape[1] * receptive + shape[0] * receptive))
    return std * torch.randn(shape, generator=generator)


def gelu(x):
    """Exact (erf-based) GELU."""
    return F.gelu(x)


ACTIVATIONS = {
    "gelu": gelu,
    "relu": F.relu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def _dense(x, weight, bias, cd):
    """``x @ weight.T`` with inputs rounded to ``cd``, products in f32 (exact
    for bf16 inputs) and the result rounded to ``cd``; then ``+ bias`` in
    ``cd``. Weight is (out, in)."""
    y = (x.to(cd).float() @ weight.to(cd).float().t()).to(cd)
    return y + bias.to(cd) if bias is not None else y


class TorchLinear(nn.Module):
    """Linear layer with torch.nn.Linear default init; parameters in f32,
    computation in ``dtype`` (None: x's dtype)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch_kernel_init((features, in_features),
                                                     generator))
        self.bias = (nn.Parameter(torch_bias_init(features, in_features,
                                                  generator))
                     if use_bias else None)

    def forward(self, x):
        return _dense(x, self.weight, self.bias, self.dtype or x.dtype)


class WNDense(nn.Module):
    """Linear layer with optional weight normalization over output rows.

    With wnorm the parameters are ``weight_v`` (out, in), ``weight_g``
    (out, 1) and ``bias``, and the forward computes
    ``weight = v * g / (||v||_row + 1e-12)`` in f32 on every call (not torch's
    epsilon-free weight_norm); ``g`` starts at ``||v||_row``. Without wnorm
    it is a TorchLinear with ``weight`` and ``bias``.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 wnorm: bool = False, dtype=None, generator=None):
        super().__init__()
        self.wnorm = wnorm
        self.dtype = dtype
        v = torch_kernel_init((features, in_features), generator)
        if wnorm:
            self.weight_v = nn.Parameter(v)
            self.weight_g = nn.Parameter(
                torch.linalg.vector_norm(v, dim=1, keepdim=True))
        else:
            self.weight = nn.Parameter(v)
        self.bias = (nn.Parameter(torch_bias_init(features, in_features,
                                                  generator))
                     if use_bias else None)

    def forward(self, x):
        if self.wnorm:
            v = self.weight_v.float()
            norm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
            weight = v * (self.weight_g.float() / (norm + 1e-12))
        else:
            weight = self.weight
        return _dense(x, weight, self.bias, self.dtype or x.dtype)


class Dropout(nn.Module):
    """Dropout whose mask is drawn from ``generator`` (a ``torch.Generator``
    on the activations' device, set by the trainer), or from torch's
    default generator while it is None: the training run's random stream is
    then one object that a checkpoint saves and restores."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device,
                          generator=self.generator) >= self.p
        return x * keep / (1.0 - self.p)


FF_IMPLS = ("dense", "fused", "fused_saved")


class FeedForward(nn.Module):
    """FFNO feed-forward: n_layers linear layers with ``factor`` expansion.

    Layer j is ``layers[j]`` = Sequential(Linear, Dropout, GELU (not last) /
    Identity, [LayerNorm (last, with layer_norm)]), named as in the
    reference. Like the reference, it ignores ``ff_weight_norm``.

    ff_impl 'fused' runs the chain (and the residual add) in the fused
    kernels when dropout is 0, recomputing the hidden activations in the
    backward; 'fused_saved' saves the pre-activations in the forward
    instead. Otherwise the dense path runs, adding the bias in the compute
    dtype and the residual outside. The paths round at different points,
    as in the JAX package.
    """

    def __init__(self, dim: int, factor: int = 4, n_layers: int = 2,
                 ff_weight_norm: bool = False, layer_norm: bool = False,
                 dropout: float = 0.0, dtype=None, approx_gelu: bool = False,
                 ff_impl: str = "dense", generator=None):
        super().__init__()
        if ff_impl not in FF_IMPLS:
            raise ValueError(f"unknown ff_impl {ff_impl!r}; expected one of "
                             f"{', '.join(FF_IMPLS)}")
        self.dropout = dropout
        self.dtype = dtype
        self.approx_gelu = approx_gelu
        self.ff_impl = ff_impl
        self.layer_norm = layer_norm
        layers = []
        for j in range(n_layers):
            in_dim = dim if j == 0 else dim * factor
            out_dim = dim if j == n_layers - 1 else dim * factor
            mods = [TorchLinear(in_dim, out_dim, dtype=dtype,
                                generator=generator),
                    Dropout(dropout),
                    nn.GELU("tanh" if approx_gelu else "none")
                    if j < n_layers - 1 else nn.Identity()]
            if layer_norm and j == n_layers - 1:
                mods.append(nn.LayerNorm(out_dim, eps=1e-5))
            layers.append(nn.Sequential(*mods))
        self.layers = nn.ModuleList(layers)

    @property
    def fused(self) -> bool:
        return self.ff_impl != "dense" and self.dropout == 0.0

    def forward(self, x, residual=None):
        """x: (..., dim). residual: optional tensor added to the output."""
        if self.fused:
            cd = self.dtype if self.dtype is not None else x.dtype
            kernels = [seq[0].weight.t() for seq in self.layers]
            biases = [seq[0].bias for seq in self.layers]
            ln = ((self.layers[-1][3].weight, self.layers[-1][3].bias)
                  if self.layer_norm else None)
            # the kernels read rows in place: a transposed view (FFNO1D's
            # spectral output) is copied once here
            return fused_feedforward(x.contiguous(), kernels, biases, ln,
                                     residual,
                                     approx_gelu=self.approx_gelu,
                                     compute_dtype=cd,
                                     save_acts=self.ff_impl == "fused_saved")
        n = len(self.layers)
        for j, seq in enumerate(self.layers):
            x = seq[1](seq[0](x))  # linear, dropout
            if j < n - 1:
                x = seq[2](x)      # GELU
            elif self.layer_norm:
                x = seq[3](x.float()).to(x.dtype)
        return residual + x if residual is not None else x
