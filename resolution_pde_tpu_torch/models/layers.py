"""Shared layers: torch-default initialisers, weight-normed linear, the FFNO
FeedForward, FNO's pointwise projection.

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
from resolution_pde_tpu_torch.parallel.collectives import (
    copy_to_group, gather_from_group, reduce_from_group)


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


class PointwiseMLP(nn.Module):
    """FNO's projection: two pointwise linear layers (the reference's 1x1
    convs ``mlp1`` and ``mlp2``) with the exact GELU between,
    channels-last."""

    def __init__(self, in_features: int, out_features: int,
                 mid_features: int, generator=None):
        super().__init__()
        self.mlp1 = TorchLinear(in_features, mid_features,
                                generator=generator)
        self.mlp2 = TorchLinear(mid_features, out_features,
                                generator=generator)

    def forward(self, x):
        return self.mlp2(gelu(self.mlp1(x)))


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

    Tensor parallelism (``enable_tensor_parallel``, parallel/tp.py) runs
    the dense path on this rank's slices: layer 0 column-parallel, layer 1
    row-parallel with one all-reduce of its partial products (in f32,
    before the rounding to the compute dtype and the bias).
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
        self.tp_group = None

    @property
    def fused(self) -> bool:
        return self.ff_impl != "dense" and self.dropout == 0.0

    def enable_tensor_parallel(self, group, dims: dict) -> None:
        """Run on the slices of a "model" group (parallel/shard.py calls
        this before slicing). dims: {parameter name: sharded dimension};
        only layer 0's weight (dim 0) and bias (dim 0) and layer 1's
        weight (dim 1) may be sharded, as ``ffno_tp_specs`` does."""
        if self.fused:
            raise ValueError(
                f"FeedForward(ff_impl={self.ff_impl!r}) cannot run tensor "
                "parallel: a chain whose hidden features are sharded over "
                "'model' is not one fused-kernel launch; build the model "
                "with ff_impl='dense' for a 'model' extent above 1")
        allowed = {("0", "weight"): 0, ("0", "bias"): 0, ("1", "weight"): 1}
        got = {}
        for name, dim in dims.items():
            j, _, leaf = name.split("layers.")[-1].split(".")
            if allowed.get((j, leaf)) != dim:
                raise ValueError(
                    f"{name}: tensor parallelism shards layer 0 by output "
                    "rows and layer 1 by input columns only")
            got[(j, leaf)] = dim
        if ("0", "weight") not in got or (len(self.layers) > 1
                                          and ("1", "weight") not in got):
            raise ValueError("tensor parallelism shards layer 0's weight "
                             "and layer 1's together")
        if self.layers[0][0].bias is not None and ("0", "bias") not in got:
            raise ValueError("a column-parallel layer 0 shards its bias")
        self.tp_group = group

    def _layer(self, j: int, x):
        """Layer j after its linear: dropout, then GELU or the LayerNorm."""
        seq = self.layers[j]
        x = seq[1](x)
        if j < len(self.layers) - 1:
            return seq[2](x)
        if self.layer_norm:
            return seq[3](x.float()).to(x.dtype)
        return x

    def _tp_forward(self, x):
        group = self.tp_group
        x = self.layers[0][0](copy_to_group(x, group))
        if len(self.layers) == 1:
            return self._layer(0, gather_from_group(x, group, -1))
        x = self._layer(0, x)
        lin = self.layers[1][0]
        cd = lin.dtype or x.dtype
        part = x.to(cd).float() @ lin.weight.to(cd).float().t()
        y = reduce_from_group(part, group).to(cd)
        if lin.bias is not None:
            y = y + lin.bias.to(cd)
        x = self._layer(1, y)
        for j in range(2, len(self.layers)):
            x = self._layer(j, self.layers[j][0](x))
        return x

    def forward(self, x, residual=None):
        """x: (..., dim). residual: optional tensor added to the output."""
        if self.tp_group is not None:
            x = self._tp_forward(x)
            return residual + x if residual is not None else x
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
        for j, seq in enumerate(self.layers):
            x = self._layer(j, seq[0](x))
        return residual + x if residual is not None else x
