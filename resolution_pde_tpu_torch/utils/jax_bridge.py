"""JAX parameter trees -> state_dicts of the port.

The JAX package's ``FFNO2D`` parameters are a nested dict (numpy arrays at
the leaves; a tree of JAX arrays works too, read through ``np.asarray``):

    {WNDense_0: {v (in, out), g (out,), bias} | {TorchLinear_0: {kernel, bias}},
     FSpectralConv2d_i: {fourier_weight_y, fourier_weight_x (C, C, modes, 2),
                         FeedForward_0: {WNDense_j: {TorchLinear_0: {kernel,
                                                                     bias}},
                                         LayerNorm_0: {scale, bias}}},
     WNDense_1: {...}}

``ffno2d_state_dict`` maps it to the port's parameter names, which are the
reference PyTorch code's, so ``resolution_pde_tpu.utils.torch_import.
import_ffno2d`` maps the result back. A gradient tree from ``jax.grad`` has
the params' structure, so it maps the same way, onto the names of
``model.named_parameters()``. ``ffno1d_state_dict`` does the same for
``FFNO1D``, whose layers ``FSpectralConv1d_i`` hold one
``fourier_weight`` (-> ``fourier_layers.{i}.fourier_weight.0``, as
``import_ffno1d`` reads it) beside ``FeedForward_0``.

The JAX ``FNO1d`` and ``FNO2d`` trees

    {TorchLinear_0, FNOBlock{1,2}d_i: {SpectralConv{1,2}dLayer_0: {weights1
     [, weights2]}, TorchLinear_0}, PointwiseMLP_0: {TorchLinear_0,
     TorchLinear_1}}

map to ``lifting``, ``fno_blocks.{i}.spectral_conv.weights1`` /
``weights2``, ``fno_blocks.{i}.bypass_conv`` and ``projection.mlp1`` /
``mlp2`` (``fno1d_state_dict``, ``fno2d_state_dict``), the names
``resolution_pde_tpu.utils.torch_import.import_fno1d`` reads.

The JAX ``S4Model`` tree

    {Dense_0, [LayerNorm_i,] S4Block_i: {FFTConvLayer_0: {DPLRKernelLayer_0
     | S4DKernelLayer_0: {...}, D}, Dense_0, [input_gate, input_linear,
     output_gate]}, Dense_1}

maps to ``encoder``, ``norms.{i}``, ``s4_layers.{i}.layer.kernel.*``,
``s4_layers.{i}.layer.D``, ``s4_layers.{i}.output_linear`` and ``decoder``
(``s4_model_state_dict``); the kernel parameters keep their JAX names and
shapes. No JAX import is needed here.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def _dense(p: dict, prefix: str) -> dict:
    """flax Dense {kernel (in, out), bias} -> Linear weight (out, in), bias."""
    out = {f"{prefix}.weight": _t(p["kernel"], True)}
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])
    return out


def _wn_dense(p: dict, prefix: str) -> dict:
    if "v" not in p:
        return _dense(p["TorchLinear_0"], prefix)
    out = {f"{prefix}.weight_v": _t(p["v"], True),
           f"{prefix}.weight_g": _t(np.asarray(p["g"]).reshape(-1, 1))}
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])
    return out


def _index(key: str, stem: str) -> int:
    m = re.fullmatch(rf"{stem}_(\d+)", key)
    if m is None:
        raise KeyError(f"unexpected parameter group {key!r}")
    return int(m.group(1))


def _feedforward(ff: dict, prefix: str) -> dict:
    """JAX ``FeedForward`` params -> the port's, under ``prefix``."""
    sd = {}
    dense = sorted(_index(k, "WNDense") for k in ff if k != "LayerNorm_0")
    for j in dense:
        sd.update(_dense(ff[f"WNDense_{j}"]["TorchLinear_0"],
                         f"{prefix}.layers.{j}.0"))
    if "LayerNorm_0" in ff:
        pre = f"{prefix}.layers.{dense[-1]}.3"
        sd[f"{pre}.weight"] = _t(ff["LayerNorm_0"]["scale"])
        sd[f"{pre}.bias"] = _t(ff["LayerNorm_0"]["bias"])
    return sd


def _ffno_state_dict(params: dict, stem: str, weights: dict) -> dict:
    """An FFNO's params -> the port's state_dict: the projections, and per
    layer ``{stem}_i`` its Fourier weights (JAX name -> the index in
    ``fourier_weight``) and its FeedForward."""
    params = params.get("params", params)
    sd = {}
    sd.update(_wn_dense(params["WNDense_0"], "in_proj"))
    sd.update(_wn_dense(params["WNDense_1"], "out_proj"))
    for key in (k for k in params if k.startswith(f"{stem}_")):
        p = params[key]
        base = f"fourier_layers.{_index(key, stem)}"
        for name, j in weights.items():
            if name in p:
                sd[f"{base}.fourier_weight.{j}"] = _t(p[name])
        sd.update(_feedforward(p["FeedForward_0"], f"{base}.backcast_ff"))
    return sd


def ffno2d_state_dict(params: dict) -> dict:
    """JAX ``FFNO2D`` params (the ``params`` collection, or the variables
    dict holding it) -> the port's ``FFNO2D`` state_dict (f32 tensors)."""
    return _ffno_state_dict(params, "FSpectralConv2d",
                            {"fourier_weight_y": 0, "fourier_weight_x": 1})


def ffno1d_state_dict(params: dict) -> dict:
    """JAX ``FFNO1D`` params (the ``params`` collection, or the variables
    dict holding it) -> the port's ``FFNO1D`` state_dict (f32 tensors)."""
    return _ffno_state_dict(params, "FSpectralConv1d", {"fourier_weight": 0})


def _fno_state_dict(params: dict, ndim: int) -> dict:
    params = params.get("params", params)
    sd = _dense(params["TorchLinear_0"], "lifting")
    mlp = params["PointwiseMLP_0"]
    sd.update(_dense(mlp["TorchLinear_0"], "projection.mlp1"))
    sd.update(_dense(mlp["TorchLinear_1"], "projection.mlp2"))
    stem = f"FNOBlock{ndim}d"
    for key in (k for k in params if k.startswith(f"{stem}_")):
        p, base = params[key], f"fno_blocks.{_index(key, stem)}"
        for name, w in p[f"SpectralConv{ndim}dLayer_0"].items():
            sd[f"{base}.spectral_conv.{name}"] = _t(w)
        sd.update(_dense(p["TorchLinear_0"], f"{base}.bypass_conv"))
    return sd


def fno1d_state_dict(params: dict) -> dict:
    """JAX ``FNO1d`` params (the ``params`` collection, or the variables
    dict holding it) -> the port's ``FNO1d`` state_dict (f32 tensors)."""
    return _fno_state_dict(params, 1)


def fno2d_state_dict(params: dict) -> dict:
    """JAX ``FNO2d`` params -> the port's ``FNO2d`` state_dict."""
    return _fno_state_dict(params, 2)


def fftconv_state_dict(p: dict, prefix: str = "") -> dict:
    """JAX ``FFTConvLayer`` params -> the port's, under ``prefix``."""
    pre = f"{prefix}." if prefix else ""
    kernel = p.get("DPLRKernelLayer_0", p.get("S4DKernelLayer_0"))
    if kernel is None:
        raise KeyError(f"no kernel layer among {sorted(p)}")
    sd = {f"{pre}kernel.{k}": _t(v) for k, v in kernel.items()}
    sd[f"{pre}D"] = _t(p["D"])
    return sd


def s4_block_state_dict(p: dict, prefix: str = "") -> dict:
    """JAX ``S4Block`` or ``S4D`` params -> the port's, under ``prefix``:
    FFTConvLayer_0 -> layer, the final Dense_0 -> output_linear, the gate
    and bottleneck Denses under their own names."""
    pre = f"{prefix}." if prefix else ""
    sd = fftconv_state_dict(p["FFTConvLayer_0"], f"{pre}layer")
    if "Dense_0" in p:
        sd.update(_dense(p["Dense_0"], f"{pre}output_linear"))
    for name in ("input_gate", "input_linear", "output_gate"):
        if name in p:
            sd.update(_dense(p[name], f"{pre}{name}"))
    return sd


def s4_model_state_dict(params: dict) -> dict:
    """JAX ``S4Model`` params (the ``params`` collection, or the variables
    dict holding it) -> the port's ``S4Model`` state_dict (f32 tensors)."""
    params = params.get("params", params)
    sd = {}
    sd.update(_dense(params["Dense_0"], "encoder"))
    sd.update(_dense(params["Dense_1"], "decoder"))
    for key, p in params.items():
        if key.startswith("S4Block_"):
            i = _index(key, "S4Block")
            sd.update(s4_block_state_dict(p, f"s4_layers.{i}"))
        elif key.startswith("LayerNorm_"):
            i = _index(key, "LayerNorm")
            sd[f"norms.{i}.weight"] = _t(p["scale"])
            sd[f"norms.{i}.bias"] = _t(p["bias"])
    return sd
