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
import_ffno2d`` maps the result back. No JAX import is needed here.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def _wn_dense(p: dict, prefix: str) -> dict:
    if "v" in p:
        out = {f"{prefix}.weight_v": _t(p["v"], True),
               f"{prefix}.weight_g": _t(np.asarray(p["g"]).reshape(-1, 1))}
    else:
        p = p["TorchLinear_0"]
        out = {f"{prefix}.weight": _t(p["kernel"], True)}
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])
    return out


def _index(key: str, stem: str) -> int:
    m = re.fullmatch(rf"{stem}_(\d+)", key)
    if m is None:
        raise KeyError(f"unexpected parameter group {key!r}")
    return int(m.group(1))


def ffno2d_state_dict(params: dict) -> dict:
    """JAX ``FFNO2D`` params (the ``params`` collection, or the variables
    dict holding it) -> the port's ``FFNO2D`` state_dict (f32 tensors)."""
    params = params.get("params", params)
    sd = {}
    sd.update(_wn_dense(params["WNDense_0"], "in_proj"))
    sd.update(_wn_dense(params["WNDense_1"], "out_proj"))
    layers = [k for k in params if k.startswith("FSpectralConv2d_")]
    for key in layers:
        i = _index(key, "FSpectralConv2d")
        p = params[key]
        base = f"fourier_layers.{i}"
        if "fourier_weight_y" in p:
            sd[f"{base}.fourier_weight.0"] = _t(p["fourier_weight_y"])
            sd[f"{base}.fourier_weight.1"] = _t(p["fourier_weight_x"])
        ff = p["FeedForward_0"]
        dense = sorted(_index(k, "WNDense") for k in ff if k != "LayerNorm_0")
        for j in dense:
            lin = ff[f"WNDense_{j}"]["TorchLinear_0"]
            pre = f"{base}.backcast_ff.layers.{j}.0"
            sd[f"{pre}.weight"] = _t(lin["kernel"], True)
            sd[f"{pre}.bias"] = _t(lin["bias"])
        if "LayerNorm_0" in ff:
            pre = f"{base}.backcast_ff.layers.{dense[-1]}.3"
            sd[f"{pre}.weight"] = _t(ff["LayerNorm_0"]["scale"])
            sd[f"{pre}.bias"] = _t(ff["LayerNorm_0"]["bias"])
    return sd
