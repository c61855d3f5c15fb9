"""Plain PyTorch FFNO2D in float32: the reference the FFNO cells judge by.

The factorized Fourier neural operator of Tran et al., "Factorized Fourier
Neural Operators" (ICLR 2023), as their code writes the 2D model: a grid of
linspace(0, 1) per axis appended to the input, a weight-normed lift, then
per layer x + FF(S(x)), S the sum of two truncated spectral passes (along W
with weight 0, along H with weight 1; orthonormal rfft, the first
min(n_modes, n // 2 + 1) modes mixed by a complex weight, zero-padded, the
DC bin read as real by the inverse), FF a chain of n_ff_layers linear
layers widened by ``factor`` with GELU between (tanh form where the
configuration says ``approx_gelu``) and a LayerNorm at its end, then a
weight-normed projection. Dropout is 0 in the configuration.

``make_weights`` draws the parameters from the seed on the device, by the
model's own rules (torch.nn.Linear's uniform, xavier normal for the
spectral weights, g of a weight norm the row norms of v, LayerNorm at
ones and zeros), under the state_dict names the program loads them by.
``q`` rounds every product's operands (the controls, precision.py).
"""

from __future__ import annotations

import math

import torch

from benchmark import costs
from benchmark.reference.precision import exact


def _shapes(m: dict) -> list:
    """[(name, shape, rule)] in draw order; rule: 'uniform' (bound
    1/sqrt(fan_in)), 'xavier', 'norm_of' (g of the v before it), 'ones',
    'zeros'."""
    w, c_in = m["width"], m["in_channels"] + (2 if m["use_grid"] else 0)
    out = [("in_proj.weight_v", (w, c_in), "uniform"),
           ("in_proj.weight_g", (w, 1), "norm_of"),
           ("in_proj.bias", (w,), "uniform")]
    for i in range(m["n_layers"]):
        p = f"fourier_layers.{i}."
        for j in range(2):
            out.append((f"{p}fourier_weight.{j}",
                        (w, w, m["n_modes"], 2), "xavier"))
        for j in range(m["n_ff_layers"]):
            d_in = w if j == 0 else w * m["factor"]
            d_out = w if j == m["n_ff_layers"] - 1 else w * m["factor"]
            out.append((f"{p}backcast_ff.layers.{j}.0.weight", (d_out, d_in),
                        "uniform"))
            out.append((f"{p}backcast_ff.layers.{j}.0.bias", (d_out,),
                        "uniform"))
        if m["layer_norm"]:
            last = f"{p}backcast_ff.layers.{m['n_ff_layers'] - 1}.3."
            out.append((last + "weight", (w,), "ones"))
            out.append((last + "bias", (w,), "zeros"))
    out += [("out_proj.weight_v", (m["out_channels"], w), "uniform"),
            ("out_proj.weight_g", (m["out_channels"], 1), "norm_of"),
            ("out_proj.bias", (m["out_channels"],), "uniform")]
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The parameters from ``seed``, made on ``device`` in two draws (one
    uniform, one normal), f32."""
    shapes = _shapes(cfg["model"])
    n_u = sum(math.prod(s) for _, s, r in shapes if r == "uniform")
    n_n = sum(math.prod(s) for _, s, r in shapes if r == "xavier")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(n_u, generator=gen, device=device)
    z = torch.randn(n_n, generator=gen, device=device)
    out, iu, iz, fan_in, last_v = {}, 0, 0, {}, None
    for name, shape, rule in shapes:
        n = math.prod(shape)
        if rule == "uniform":
            # a bias's fan-in is its layer's weight's
            base = name.rsplit(".", 1)[0]
            fan = shape[1] if len(shape) == 2 else fan_in[base]
            fan_in[base] = fan
            bound = 1.0 / math.sqrt(fan)
            out[name] = (u[iu:iu + n].reshape(shape) * 2.0 - 1.0) * bound
            iu += n
            if name.endswith("weight_v"):
                last_v = out[name]
        elif rule == "xavier":
            rec = math.prod(shape[2:])
            std = math.sqrt(2.0 / (shape[1] * rec + shape[0] * rec))
            out[name] = z[iz:iz + n].reshape(shape) * std
            iz += n
        elif rule == "norm_of":
            out[name] = last_v.norm(dim=1, keepdim=True)
        elif rule == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return {k: v.contiguous() for k, v in out.items()}


def _wn(w: dict, p: str) -> torch.Tensor:
    v = w[p + "weight_v"]
    return v * (w[p + "weight_g"] / (v.norm(dim=1, keepdim=True) + 1e-12))


def _dense(x, weight, bias, q):
    return q(x) @ q(weight).t() + bias


def _axis_pass(x, weight, n_modes: int, dim: int, q):
    """One truncated spectral pass of (B, C, H, W) along ``dim``."""
    n = x.shape[dim]
    m = min(n_modes, n // 2 + 1)
    xf = torch.fft.rfft(q(x), dim=dim, norm="ortho").narrow(dim, 0, m)
    xf = torch.complex(q(xf.real), q(xf.imag))
    wc = torch.complex(q(weight[:, :, :m, 0]), q(weight[:, :, :m, 1]))
    sub = "bixy,ioy->boxy" if dim == 3 else "bixy,iox->boxy"
    of = torch.einsum(sub, xf, wc)
    of = torch.complex(q(of.real), q(of.imag))
    pad = [0, 0, 0, 0]
    pad[1 if dim == 3 else 3] = n // 2 + 1 - m
    of = torch.nn.functional.pad(of, pad)
    # the DC bin (and a kept Nyquist bin) of a mixed spectrum is complex;
    # the inverse of a real signal reads it as real
    keep = torch.ones(n // 2 + 1, device=x.device)
    keep[0] = 0.0
    if n % 2 == 0 and m == n // 2 + 1:
        keep[-1] = 0.0
    shape = [1, 1, 1, 1]
    shape[dim] = n // 2 + 1
    of = torch.complex(of.real, of.imag * keep.reshape(shape))
    return torch.fft.irfft(of, n=n, dim=dim, norm="ortho")


def _gelu(x, approx: bool):
    return torch.nn.functional.gelu(x,
                                    approximate="tanh" if approx else "none")


def forward(w: dict, x: torch.Tensor, cfg: dict, q=exact) -> torch.Tensor:
    """(B, C_in, H, W) float32 -> (B, C_out, H, W) float32."""
    m = cfg["model"]
    h = x.float().permute(0, 2, 3, 1)
    b, hh, ww, _ = h.shape
    if m["use_grid"]:
        gx = torch.linspace(0.0, 1.0, hh, dtype=torch.float64,
                            device=x.device).float()
        gy = torch.linspace(0.0, 1.0, ww, dtype=torch.float64,
                            device=x.device).float()
        h = torch.cat([h, gx[None, :, None, None].expand(b, hh, ww, 1),
                       gy[None, None, :, None].expand(b, hh, ww, 1)], -1)
    h = _dense(h, _wn(w, "in_proj."), w["in_proj.bias"], q)
    approx = m.get("approx_gelu", False)
    n_ff = m["n_ff_layers"]
    for i in range(m["n_layers"]):
        p = f"fourier_layers.{i}."
        hc = h.permute(0, 3, 1, 2)
        s = (_axis_pass(hc, w[p + "fourier_weight.0"], m["n_modes"], 3, q)
             + _axis_pass(hc, w[p + "fourier_weight.1"], m["n_modes"], 2, q))
        z = s.permute(0, 2, 3, 1)
        for j in range(n_ff):
            f = f"{p}backcast_ff.layers.{j}."
            z = _dense(z, w[f + "0.weight"], w[f + "0.bias"], q)
            if j < n_ff - 1:
                z = _gelu(z, approx)
            elif m["layer_norm"]:
                z = torch.nn.functional.layer_norm(
                    z, (z.shape[-1],), w[f + "3.weight"], w[f + "3.bias"],
                    1e-5)
        h = h + z
    out = _dense(h, _wn(w, "out_proj."), w["out_proj.bias"], q)
    return out.permute(0, 3, 1, 2)


def flops(cfg: dict, rows: int, grid: tuple) -> float:
    """The model's forward operations for ``rows`` samples on ``grid``: the
    products (2 a multiply-add) of the lift, the FeedForward chains and the
    projection, and the spectral passes as ``costs.spectral_pass`` counts
    them."""
    m = cfg["model"]
    h, w = grid
    pts = rows * h * w
    c_in = m["in_channels"] + (2 if m["use_grid"] else 0)
    width = m["width"]
    dims = ([width] + [width * m["factor"]] * (m["n_ff_layers"] - 1)
            + [width])
    per_layer = costs.ff_forward(pts, dims, 2)[0]
    for n, n_rows in ((w, rows * h), (h, rows * w)):
        mm = min(m["n_modes"], n // 2 + 1)
        per_layer += costs.spectral_pass(n_rows, n, width, width, mm, 2)[0]
    return (2.0 * pts * (c_in * width + width * m["out_channels"])
            + m["n_layers"] * per_layer)
