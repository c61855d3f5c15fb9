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
shapes. ``S4NDModel`` (``{Dense_0, S4ND2dLayer_i: {kernel_x, kernel_y,
D, Dense_0}, LayerNorm_i, Dense_1}``) maps the same way, each layer's
kernels under their own names (``s4nd_model_state_dict``,
``s4nd_layer_state_dict``), and the base and sequence models of
``models.s4_base`` through ``s4_base_state_dict``, which reads the layout
off the port's module of the same configuration.

The BatchNorm models take the whole variables dict, ``params`` and
``batch_stats``, and fill the buffers too (flax ``scale`` / ``bias`` ->
``weight`` / ``bias``, ``mean`` / ``var`` -> ``running_mean`` /
``running_var``); conv kernels (*k, in, out) become (out, in, *k). The
JAX ``CNO1d`` / ``CNO2d`` tree ``{_CNO_0: {LiftProjectBlock_{0,1},
CNOBlock_k, ResidualBlock_j}}`` names its blocks in forward order, so
``CNOBlock_k`` interleaves (``cno1d_state_dict``, ``cno2d_state_dict``;
the inverse of ``torch_import.import_cno``):

    k < nl          -> encoder.k
    k = nl + 2j     -> ED_expansion.{nl - j}
    k = nl + 2j + 1 -> decoder.j
    k = 3 nl        -> ED_expansion.0

and ``ResidualBlock_j`` runs the levels' ResNets, ``n_res`` each, then the
neck's. ``CNO2dOriginal`` (``_LiftProject_{0,1}``, ``_Block_k``,
``_ResBlock_j``) maps the same way onto the port's names
(``cno2d_original_state_dict``). The JAX ``UNet1d`` / ``UNet2d`` tree
``{_UNet_0: {_DoubleConv_i, ConvTranspose_i, Conv_0}}`` maps to
``encoder1-4``, ``bottleneck``, ``decoder4-1``, ``upconv4-1`` and ``conv``
(``unet1d_state_dict``, ``unet2d_state_dict``), the transposed convs'
taps flipped: flax's ConvTranspose correlates where torch's convolves.

The transformer operators: ``mgpt_state_dict`` (``MoEGPTNO``, both
expert layouts) and ``gnot_state_dict`` (``GNOTOperator``), by the gate's
and the bare LayerNorms' creation order; ``swin_operator2d_state_dict``
(its de-embedding a ConvTranspose, flipped likewise);
``scot2d_state_dict``, whose JAX modules are named
(``enc{l}_block{j}``, ``skip{l}_res{r}``, ``merge{l}`` ...), and the
block-level maps it uses (``swinv2_block_state_dict``,
``convnext_block_state_dict``). No JAX import is needed here.
"""

from __future__ import annotations

import re
from typing import Optional

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


def s4nd_layer_state_dict(p: dict, prefix: str = "") -> dict:
    """JAX ``S4NDLayer`` / ``S4ND2dLayer`` params -> the port's, under
    ``prefix``: the per-axis kernels (``kernel_x``, ``kernel_y`` or
    ``kernel_ax{i}``) under their names, ``D``, and the GLU's Dense_0 ->
    ``output_linear``."""
    pre = f"{prefix}." if prefix else ""
    sd = {f"{pre}D": _t(p["D"])}
    for name, kernel in p.items():
        if name.startswith("kernel_"):
            sd.update({f"{pre}{name}.{k}": _t(v) for k, v in kernel.items()})
    if "Dense_0" in p:
        sd.update(_dense(p["Dense_0"], f"{pre}output_linear"))
    return sd


def s4nd_model_state_dict(params: dict) -> dict:
    """JAX ``S4NDModel`` params -> the port's state_dict: Dense_0 ->
    ``encoder``, S4ND2dLayer_i -> ``s4_layers.{i}``, LayerNorm_i ->
    ``norms.{i}`` (one a layer, pre- or post-norm), Dense_1 ->
    ``decoder``."""
    params = params.get("params", params)
    sd = {}
    sd.update(_dense(params["Dense_0"], "encoder"))
    sd.update(_dense(params["Dense_1"], "decoder"))
    for key, p in params.items():
        if key.startswith("S4ND2dLayer_"):
            i = _index(key, "S4ND2dLayer")
            sd.update(s4nd_layer_state_dict(p, f"s4_layers.{i}"))
        elif key.startswith("LayerNorm_"):
            i = _index(key, "LayerNorm")
            sd[f"norms.{i}.weight"] = _t(p["scale"])
            sd[f"norms.{i}.bias"] = _t(p["bias"])
    return sd


def _s4_base_model(p: dict, model, pre: str) -> dict:
    """``S4BaseModel``: its LayerNorms are numbered in creation order, which
    the port model's flags give (a layer's norm, then its ffn's)."""
    n = len(model.s4_layers)
    sd = _dense(p["Dense_0"], f"{pre}encoder")
    ln, ff = 0, 0

    def norm(name):
        nonlocal ln
        q = p[f"LayerNorm_{ln}"]
        ln += 1
        return {f"{pre}{name}.weight": _t(q["scale"]),
                f"{pre}{name}.bias": _t(q["bias"])}

    for i in range(n):
        if model.prenorm and model.layer_norm[i]:
            sd.update(norm(f"norms.{i}"))
        sd.update(s4_block_state_dict(p[f"S4Block_{i}"],
                                      f"{pre}s4_layers.{i}"))
        res = p.get(f"_Residual_{i}", {})
        if "Dense_0" in res:
            sd.update(_dense(res["Dense_0"], f"{pre}residuals.{i}.dense"))
        if not model.prenorm and model.layer_norm[i]:
            sd.update(norm(f"norms.{i}"))
        if model.with_ffn[i]:
            if model.prenorm:
                sd.update(norm(f"ffn_norms.{i}"))
            sd.update(_feedforward(p[f"FeedForward_{ff}"],
                                   f"{pre}ffns.{i}"))
            ff += 1
            if not model.prenorm:
                sd.update(norm(f"ffn_norms.{i}"))
    if hasattr(model, "decoder_hidden"):
        sd.update(_dense(p["Dense_1"], f"{pre}decoder_hidden"))
        sd.update(_dense(p["Dense_2"], f"{pre}decoder"))
    else:
        sd.update(_dense(p["Dense_1"], f"{pre}decoder"))
    return sd


def s4_base_state_dict(params: dict, model, prefix: str = "") -> dict:
    """JAX params of an S4 base or sequence model (``models.s4_base``) ->
    the state_dict of ``model``, the port's module of the same
    configuration, whose type and flags give the layout: S4BaseModel
    (above), OneToSeqModel (S4BaseModel_0 -> ``inner``), the sequence
    models (Dense_0 -> ``encoder``, S4Block_i -> ``s4_layers.{i}``,
    Dense_1 -> ``decoder``), SeqAdd (``model1``, ``model2``) and
    ChainModel (``model``)."""
    from resolution_pde_tpu_torch.models import s4_base

    p = params.get("params", params)
    pre = f"{prefix}." if prefix else ""
    if isinstance(model, s4_base.S4BaseModel):
        return _s4_base_model(p, model, pre)
    if isinstance(model, s4_base.OneToSeqModel):
        return _s4_base_model(p["S4BaseModel_0"], model.inner,
                              f"{pre}inner.")
    if isinstance(model, s4_base.SeqAdd):
        return {**s4_base_state_dict(p["model1"], model.model1,
                                     f"{pre}model1"),
                **s4_base_state_dict(p["model2"], model.model2,
                                     f"{pre}model2")}
    if isinstance(model, s4_base.ChainModel):
        return s4_base_state_dict(p["model"], model.model, f"{pre}model")
    sd = _dense(p["Dense_0"], f"{pre}encoder")
    sd.update(_dense(p["Dense_1"], f"{pre}decoder"))
    for i in range(len(model.s4_layers)):
        sd.update(s4_block_state_dict(p[f"S4Block_{i}"],
                                      f"{pre}s4_layers.{i}"))
    return sd


def _conv(p: dict, prefix: str) -> dict:
    """flax Conv {kernel (*k, in, out)[, bias]} -> torch (out, in, *k)."""
    k = np.asarray(p["kernel"], dtype=np.float32)
    nd = k.ndim - 2
    out = {f"{prefix}.weight": _t(k.transpose(nd + 1, nd, *range(nd)))}
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])
    return out


def _conv_transpose(p: dict, prefix: str) -> dict:
    """flax ConvTranspose {kernel (*k, in, out), bias} -> torch
    ConvTranspose (in, out, *k): flax correlates where torch convolves,
    so the taps are flipped along every spatial axis."""
    k = np.asarray(p["kernel"], dtype=np.float32)
    nd = k.ndim - 2
    flipped = np.flip(k, axis=tuple(range(nd)))
    return {f"{prefix}.weight": _t(flipped.transpose(nd, nd + 1,
                                                     *range(nd))),
            f"{prefix}.bias": _t(p["bias"])}


def _norm(p: dict, stats: Optional[dict], prefix: str) -> dict:
    """flax BatchNorm / GroupNorm / LayerNorm (params, batch stats or
    None)."""
    out = {f"{prefix}.weight": _t(p["scale"]),
           f"{prefix}.bias": _t(p["bias"])}
    if stats is not None:
        out[f"{prefix}.running_mean"] = _t(stats["mean"])
        out[f"{prefix}.running_var"] = _t(stats["var"])
    return out


def _split(variables: dict, top: Optional[str] = None) -> tuple:
    """(params, batch_stats), under the model's inner scope ``top`` where
    it has one; a bare params tree is taken as params with no stats."""
    if "params" in variables:
        params = variables["params"]
        stats = variables.get("batch_stats", {})
    else:
        params, stats = variables, {}
    if top is None:
        return params, stats
    return params[top], stats.get(top, {})


def _conv_norm(p: dict, s: dict, prefix: str, convs: dict) -> dict:
    """Convs ``{flax name: port name}`` and the BatchNorms beside them
    (``BatchNorm_i`` -> ``batch_norm``, or ``batch_norm{i+1}`` where there
    are two) of one block."""
    sd = {}
    for name, port in convs.items():
        sd.update(_conv(p[name], f"{prefix}.{port}"))
    norms = sorted(k for k in p if k.startswith("BatchNorm_"))
    for k in norms:
        i = _index(k, "BatchNorm")
        port = "batch_norm" if len(norms) == 1 else f"batch_norm{i + 1}"
        sd.update(_norm(p[k], s.get(k), f"{prefix}.{port}"))
    return sd


def _cno_block_names(params: dict, stem: str, res_stem: str,
                     n_res: int) -> dict:
    """{flax block name: port prefix} of a CNO tree (the module
    docstring's interleave)."""
    n_blocks = sum(1 for k in params if k.startswith(f"{stem}_"))
    nl = (n_blocks - 1) // 3
    names = {f"{stem}_{k}": f"encoder.{k}" for k in range(nl)}
    for j in range(nl):
        names[f"{stem}_{nl + 2 * j}"] = f"ED_expansion.{nl - j}"
        names[f"{stem}_{nl + 2 * j + 1}"] = f"decoder.{j}"
    names[f"{stem}_{3 * nl}"] = "ED_expansion.0"
    n_resblocks = sum(1 for k in params if k.startswith(f"{res_stem}_"))
    for j in range(n_resblocks):
        names[f"{res_stem}_{j}"] = (
            f"res_nets.{j // n_res}.res_nets.{j % n_res}"
            if j < nl * n_res else f"res_net_neck.res_nets.{j - nl * n_res}")
    return names


def _cno_state_dict(variables: dict, n_res: int) -> dict:
    params, stats = _split(variables, "_CNO_0")
    sd = {}
    for key, port in (("LiftProjectBlock_0", "lift"),
                      ("LiftProjectBlock_1", "project")):
        p = params[key]
        sd.update(_conv(p["CNOBlock_0"]["Conv_0"],
                        f"{port}.inter_CNOBlock.convolution"))
        sd.update(_conv(p["Conv_0"], f"{port}.convolution"))
    for key, port in _cno_block_names(params, "CNOBlock", "ResidualBlock",
                                      n_res).items():
        convs = ({"Conv_0": "convolution"} if key.startswith("CNOBlock")
                 else {"Conv_0": "convolution1", "Conv_1": "convolution2"})
        sd.update(_conv_norm(params[key], stats.get(key, {}), port, convs))
    return sd


def cno1d_state_dict(variables: dict, n_res: int) -> dict:
    """JAX ``CNO1d`` variables ({'params', 'batch_stats'}; ``n_res``, the
    config's N_res) -> the port's ``CNO1d`` state_dict."""
    return _cno_state_dict(variables, n_res)


def cno2d_state_dict(variables: dict, n_res: int) -> dict:
    """JAX ``CNO2d`` variables -> the port's ``CNO2d`` state_dict."""
    return _cno_state_dict(variables, n_res)


def cno2d_original_state_dict(variables: dict, n_res: int) -> dict:
    """JAX ``CNO2dOriginal`` variables ({'params', 'batch_stats'}, whose
    top scope is the model's own) -> the port's state_dict."""
    params, stats = _split(variables)
    sd = {}
    for key, port in (("_LiftProject_0", "lift"),
                      ("_LiftProject_1", "project")):
        sd.update(_conv_norm(params[key], {}, port,
                             {"Conv_0": "convolution1",
                              "Conv_1": "convolution2"}))
    for key, port in _cno_block_names(params, "_Block", "_ResBlock",
                                      n_res).items():
        p, s = params[key], stats.get(key, {})
        if key.startswith("_ResBlock"):
            sd.update(_conv_norm(p["_Block_0"], s.get("_Block_0", {}),
                                 f"{port}.block", {"Conv_0": "convolution"}))
            p = {k: v for k, v in p.items() if k != "_Block_0"}
        sd.update(_conv_norm(p, s, port, {"Conv_0": "convolution"}))
    return sd


_UNET_BLOCKS = [("encoder1", "enc1"), ("encoder2", "enc2"),
                ("encoder3", "enc3"), ("encoder4", "enc4"),
                ("bottleneck", "bottleneck"), ("decoder4", "dec4"),
                ("decoder3", "dec3"), ("decoder2", "dec2"),
                ("decoder1", "dec1")]


def _unet_state_dict(variables: dict) -> dict:
    params, stats = _split(variables, "_UNet_0")
    sd = {}
    for i, (name, short) in enumerate(_UNET_BLOCKS):
        p = params[f"_DoubleConv_{i}"]
        s = stats.get(f"_DoubleConv_{i}", {})
        pre = f"{name}.{short}"
        for j in (1, 2):
            sd.update(_conv(p[f"Conv_{j - 1}"], f"{pre}conv{j}"))
            norm = p.get(f"BatchNorm_{j - 1}", p.get(f"GroupNorm_{j - 1}"))
            sd.update(_norm(norm, s.get(f"BatchNorm_{j - 1}"),
                            f"{pre}norm{j}"))
    for i, up in enumerate(("upconv4", "upconv3", "upconv2", "upconv1")):
        sd.update(_conv_transpose(params[f"ConvTranspose_{i}"], up))
    sd.update(_conv(params["Conv_0"], "conv"))
    return sd


def unet1d_state_dict(variables: dict) -> dict:
    """JAX ``UNet1d`` variables ({'params', 'batch_stats'}; GroupNorm
    models have no batch stats) -> the port's ``UNet1d`` state_dict."""
    return _unet_state_dict(variables)


def unet2d_state_dict(variables: dict) -> dict:
    """JAX ``UNet2d`` variables -> the port's ``UNet2d`` state_dict."""
    return _unet_state_dict(variables)


def _mlp(p: dict, prefix: str) -> dict:
    sd = {}
    for j in range(len(p)):
        sd.update(_dense(p[f"Dense_{j}"], f"{prefix}.layers.{j}"))
    return sd


# MoECrossAttentionBlock's bare LayerNorms in creation order
_MOE_NORMS = ("norm_x", "norm_y", "norm_moe1", "norm_self", "norm_moe2")


def _moe_block(p: dict, prefix: str) -> dict:
    sd = {}
    for j in range(3):
        sd.update(_dense(p[f"Dense_{j}"], f"{prefix}.gate{j}"))
    for j, name in enumerate(_MOE_NORMS):
        sd.update(_norm(p[f"LayerNorm_{j}"], None, f"{prefix}.{name}"))
    for attn in ("crossattn", "selfattn"):
        for name in ("query", "key", "value", "proj"):
            sd.update(_dense(p[attn][name], f"{prefix}.{attn}.{name}"))
    for moe in ("moe1", "moe2"):
        if f"{moe}_stacked" in p:
            for name, v in p[f"{moe}_stacked"].items():
                sd[f"{prefix}.{moe}.{name}"] = _t(v)
            continue
        i = 0
        while f"{moe}_{i}" in p:
            e = p[f"{moe}_{i}"]
            sd.update(_dense(e["Dense_0"], f"{prefix}.{moe}.{i}.fc1"))
            sd.update(_dense(e["Dense_1"], f"{prefix}.{moe}.{i}.fc2"))
            i += 1
    return sd


def mgpt_state_dict(params: dict, prefix: str = "") -> dict:
    """JAX ``MoEGPTNO`` params -> the port's ``MoEGPTNO`` state_dict,
    either expert layout: ``moe{1,2}_{i}`` (``'loop'``) -> ``moe{1,2}.{i}
    .fc1`` / ``.fc2``, ``moe{1,2}_stacked`` {w1 (m, c, i), b1, w2, b2}
    (``'stacked'``) -> ``moe{1,2}.w1`` ... as they are; the gate's
    ``Dense_{0,1,2}`` -> ``gate{0,1,2}``, ``LayerNorm_{0-4}`` -> ``norm_x``,
    ``norm_y``, ``norm_moe1``, ``norm_self``, ``norm_moe2``."""
    params = params.get("params", params)
    sd = {}
    for name in ("trunk_mlp", "branch_mlp", "out_mlp"):
        sd.update(_mlp(params[name], f"{prefix}{name}"))
    i = 0
    while f"block_{i}" in params:
        sd.update(_moe_block(params[f"block_{i}"], f"{prefix}blocks.{i}"))
        i += 1
    return sd


def gnot_state_dict(params: dict) -> dict:
    """JAX ``GNOTOperator`` params ({MoEGPTNO_0: ...}) -> the port's
    ``GNOTOperator`` state_dict (``net.*``)."""
    params = params.get("params", params)
    return mgpt_state_dict(params["MoEGPTNO_0"], prefix="net.")


def swin_operator2d_state_dict(params: dict) -> dict:
    """JAX ``SwinOperator2d`` params -> the port's state_dict: ``Conv_0``
    -> ``patch_embed``; the time MLP's outer ``Dense_0`` -> ``time_mlp1``
    and inner ``Dense_1`` -> ``time_mlp0`` (flax names the outer Dense
    first: it is built before its argument); ``_SwinBlock_i`` {Dense_0
    (the time scale), LayerNorm_{0,1}, _WindowAttention_0 {Dense_0 (qkv),
    rel_bias, Dense_1 (proj)}, Dense_{1,2}} -> ``blocks.i.time_scale``,
    ``norm1`` / ``norm2``, ``attn.qkv`` / ``rel_bias`` / ``proj``, ``fc1``
    / ``fc2``; ``ConvTranspose_0`` -> ``de_embed`` (flipped taps);
    ``Conv_1`` -> ``head``."""
    params = params.get("params", params)
    sd = {}
    sd.update(_conv(params["Conv_0"], "patch_embed"))
    sd.update(_dense(params["Dense_1"], "time_mlp0"))
    sd.update(_dense(params["Dense_0"], "time_mlp1"))
    i = 0
    while f"_SwinBlock_{i}" in params:
        p, pre = params[f"_SwinBlock_{i}"], f"blocks.{i}"
        sd.update(_dense(p["Dense_0"], f"{pre}.time_scale"))
        sd.update(_norm(p["LayerNorm_0"], None, f"{pre}.norm1"))
        sd.update(_norm(p["LayerNorm_1"], None, f"{pre}.norm2"))
        a = p["_WindowAttention_0"]
        sd.update(_dense(a["Dense_0"], f"{pre}.attn.qkv"))
        sd[f"{pre}.attn.rel_bias"] = _t(a["rel_bias"])
        sd.update(_dense(a["Dense_1"], f"{pre}.attn.proj"))
        sd.update(_dense(p["Dense_1"], f"{pre}.fc1"))
        sd.update(_dense(p["Dense_2"], f"{pre}.fc2"))
        i += 1
    sd.update(_conv_transpose(params["ConvTranspose_0"], "de_embed"))
    sd.update(_conv(params["Conv_1"], "head"))
    return sd


def _cond_layer_norm(p: dict, prefix: str) -> dict:
    """CondLayerNorm {LayerNorm_0[, alpha, beta]} -> ``norm``[, ``alpha``,
    ``beta``]."""
    sd = _norm(p["LayerNorm_0"], None, f"{prefix}.norm")
    for name in ("alpha", "beta"):
        if name in p:
            sd.update(_dense(p[name], f"{prefix}.{name}"))
    return sd


def swinv2_attention_state_dict(p: dict, prefix: str) -> dict:
    """Swinv2WindowAttention {query, key, value, logit_scale, cpb_mlp0,
    cpb_mlp1, proj}: the same names."""
    sd = {f"{prefix}.logit_scale": _t(p["logit_scale"])}
    for name in ("query", "key", "value", "cpb_mlp0", "cpb_mlp1", "proj"):
        sd.update(_dense(p[name], f"{prefix}.{name}"))
    return sd


def swinv2_block_state_dict(p: dict, prefix: str = "") -> dict:
    """Swinv2Block {attention, layernorm_before, intermediate, output,
    layernorm_after}: the same names."""
    pre = f"{prefix}." if prefix else ""
    sd = swinv2_attention_state_dict(p["attention"], f"{pre}attention")
    for name in ("layernorm_before", "layernorm_after"):
        sd.update(_cond_layer_norm(p[name], f"{pre}{name}"))
    for name in ("intermediate", "output"):
        sd.update(_dense(p[name], f"{pre}{name}"))
    return sd


def convnext_block_state_dict(p: dict, prefix: str = "") -> dict:
    """ConvNeXtBlock {dwconv (7, 7, 1, C), norm, pwconv1, pwconv2,
    gamma}: the depthwise kernel -> (C, 1, 7, 7)."""
    pre = f"{prefix}." if prefix else ""
    sd = _conv(p["dwconv"], f"{pre}dwconv")
    sd.update(_cond_layer_norm(p["norm"], f"{pre}norm"))
    sd.update(_dense(p["pwconv1"], f"{pre}pwconv1"))
    sd.update(_dense(p["pwconv2"], f"{pre}pwconv2"))
    sd[f"{pre}gamma"] = _t(p["gamma"])
    return sd


def scot2d_state_dict(params: dict) -> dict:
    """JAX ``ScOT2d`` params -> the port's ``ScOT2d`` state_dict:
    ``enc{l}_block{j}`` -> ``encoder.l.j``, ``dec{l}_block{j}`` ->
    ``decoder.l.j``, ``merge{l}`` / ``expand{l}`` / ``fuse{l}`` ->
    ``merge.l`` / ``expand.l`` / ``fuse.l``, ``skip{l}_res{r}`` ->
    ``skip.l.r``; ``patch_embed``, ``patch_norm``, ``final_expand``,
    ``final_norm`` and ``head`` keep their names."""
    params = params.get("params", params)
    sd = {}
    sd.update(_conv(params["patch_embed"], "patch_embed"))
    sd.update(_norm(params["patch_norm"], None, "patch_norm"))
    for name, p in params.items():
        m = re.fullmatch(r"(enc|dec)(\d+)_block(\d+)", name)
        if m:
            stack = "encoder" if m[1] == "enc" else "decoder"
            sd.update(swinv2_block_state_dict(p, f"{stack}.{m[2]}.{m[3]}"))
            continue
        m = re.fullmatch(r"skip(\d+)_res(\d+)", name)
        if m:
            sd.update(convnext_block_state_dict(p, f"skip.{m[1]}.{m[2]}"))
            continue
        m = re.fullmatch(r"(merge|expand|fuse)(\d+)", name)
        if m and m[1] == "fuse":
            sd.update(_dense(p, f"fuse.{m[2]}"))
        elif m:
            lin = "reduction" if m[1] == "merge" else "expansion"
            sd.update(_dense(p[lin], f"{m[1]}.{m[2]}.{lin}"))
            sd.update(_norm(p["norm"], None, f"{m[1]}.{m[2]}.norm"))
    sd.update(_dense(params["final_expand"], "final_expand"))
    sd.update(_norm(params["final_norm"], None, "final_norm"))
    sd.update(_conv(params["head"], "head"))
    return sd
