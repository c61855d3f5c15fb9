"""Plain PyTorch S4NDModel in float32: the reference the S4ND cells judge by.

S4ND (Nguyen et al., "S4ND: Modeling Images and Videos as Multidimensional
Signals Using State Spaces", NeurIPS 2022) as the 2D PDE model of the
configuration writes it: the input with a linspace(0, 1) grid per axis, a
dense lift, then per layer LayerNorm(x + S4ND(x)) (post-norm, eps 1e-6),
then a dense projection. An S4ND layer convolves each channel over the grid
with the outer product of one S4D kernel per axis (zero-order hold,
K_l = 2 Re sum_n C_n (e^{dt A_n} - 1) / A_n e^{dt A_n l}, A_n = -e^{log_A_real}
+ i A_imag, dt = e^{log_dt}), causally, through an FFT of twice each axis,
adds D x, and then applies GELU and a gated linear unit (a dense layer to 2
d_model, the first half times the sigmoid of the second). Dropout is 0 in
the configuration.

``make_weights`` draws the parameters from the seed on the device by the
model's own rules (log-uniform dt in [1e-3, 1e-1], S4D-Lin's A, standard
normal C and D, flax's truncated lecun normal dense weights with zero
biases, LayerNorm at ones and zeros), under the state_dict names the
program loads them by. ``q`` rounds every product's operands (the
controls, precision.py); the FFTs are left exact, as a TF32 product leaves
them.
"""

from __future__ import annotations

import math

import torch

from benchmark import costs
from benchmark.reference.precision import exact

_TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2
DT_MIN, DT_MAX = 1e-3, 1e-1


def _shapes(m: dict) -> list:
    """[(name, shape, rule)] in draw order."""
    d, n2 = m["d_model"], m["d_state"] // 2
    out = [("encoder.weight", (d, m["d_input"] + 2), "lecun"),
           ("encoder.bias", (d,), "zeros")]
    for i in range(m["n_layers"]):
        p = f"s4_layers.{i}."
        out.append((p + "D", (d,), "normal"))
        for ax in ("kernel_x", "kernel_y"):
            out += [(f"{p}{ax}.log_dt", (d,), "log_dt"),
                    (f"{p}{ax}.log_A_real", (d, n2), "log_half"),
                    (f"{p}{ax}.A_imag", (d, n2), "pi_n"),
                    (f"{p}{ax}.C", (1, d, n2, 2), "normal")]
        out += [(p + "output_linear.weight", (2 * d, d), "lecun"),
                (p + "output_linear.bias", (2 * d,), "zeros"),
                (f"norms.{i}.weight", (d,), "ones"),
                (f"norms.{i}.bias", (d,), "zeros")]
    out += [("decoder.weight", (m["d_output"], d), "lecun"),
            ("decoder.bias", (m["d_output"],), "zeros")]
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The parameters from ``seed``, made on ``device`` in two draws (one
    uniform, one normal), f32."""
    shapes = _shapes(cfg["model"])
    n_u = sum(math.prod(s) for _, s, r in shapes if r in ("lecun", "log_dt"))
    n_n = sum(math.prod(s) for _, s, r in shapes if r == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(n_u, generator=gen, device=device, dtype=torch.float64)
    z = torch.randn(n_n, generator=gen, device=device)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Phi(-2)
    out, iu, iz = {}, 0, 0
    for name, shape, rule in shapes:
        n = math.prod(shape)
        if rule == "lecun":
            std = math.sqrt(1.0 / shape[1]) / _TRUNC
            p = lo + u[iu:iu + n] * (1.0 - 2.0 * lo)
            t = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
            out[name] = (t.clamp(-2.0, 2.0) * std).float().reshape(shape)
            iu += n
        elif rule == "log_dt":
            a, b = math.log(DT_MIN), math.log(DT_MAX)
            out[name] = (u[iu:iu + n] * (b - a) + a).float().reshape(shape)
            iu += n
        elif rule == "normal":
            out[name] = z[iz:iz + n].reshape(shape)
            iz += n
        elif rule == "log_half":
            out[name] = torch.full(shape, math.log(0.5), device=device)
        elif rule == "pi_n":
            out[name] = (math.pi * torch.arange(
                shape[1], device=device, dtype=torch.float32)).expand(
                    shape).contiguous()
        elif rule == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return {k: v.contiguous() for k, v in out.items()}


def _dense(x, weight, bias, q):
    return q(x) @ q(weight).t() + bias


def s4d_kernel(w: dict, p: str, L: int, q) -> torch.Tensor:
    """The S4D kernel of the layer with prefix ``p``: (channels, d, L)."""
    dt = torch.exp(w[p + "log_dt"])                       # (d,)
    a = torch.complex(-torch.exp(w[p + "log_A_real"]), w[p + "A_imag"])
    c = torch.complex(w[p + "C"][..., 0], w[p + "C"][..., 1])
    dta = a * dt[:, None]                                 # (d, n)
    cp = c * (torch.exp(dta) - 1.0) / a                   # (ch, d, n)
    pos = torch.arange(L, device=a.device, dtype=dt.dtype)
    powers = torch.exp(dta[..., None] * pos)              # (d, n, L)
    k = (torch.einsum("chn,hnl->chl", q(cp.real), q(powers.real))
         - torch.einsum("chn,hnl->chl", q(cp.imag), q(powers.imag)))
    return 2.0 * k


def _s4nd_layer(w: dict, p: str, x: torch.Tensor, q) -> torch.Tensor:
    """x (B, H, W, d) -> (B, H, W, d)."""
    b, lh, lw, d = x.shape
    xt = x.movedim(-1, 1)                                 # (B, d, H, W)
    kx = s4d_kernel(w, p + "kernel_x.", lh, q)[0]         # (d, H)
    ky = s4d_kernel(w, p + "kernel_y.", lw, q)[0]         # (d, W)
    kf = (torch.fft.fft(kx, n=2 * lh)[:, :, None]
          * torch.fft.rfft(ky, n=2 * lw)[:, None, :])     # (d, 2H, W + 1)
    xf = torch.fft.rfft2(xt, s=(2 * lh, 2 * lw))
    yf = torch.fft.ifft(xf * kf, dim=-2)
    # the last axis's DC and Nyquist bins are read as real, as numpy does
    keep = torch.ones(lw + 1, device=x.device, dtype=x.dtype)
    keep[0] = keep[-1] = 0.0
    yf = torch.complex(yf.real, yf.imag * keep)
    y = torch.fft.irfft(yf, n=2 * lw, dim=-1)[..., :lh, :lw]
    y = (y + xt * w[p + "D"][:, None, None]).movedim(1, -1)
    z = _dense(torch.nn.functional.gelu(y), w[p + "output_linear.weight"],
               w[p + "output_linear.bias"], q)
    return z[..., :d] * torch.sigmoid(z[..., d:])


def forward(w: dict, x: torch.Tensor, cfg: dict, q=exact) -> torch.Tensor:
    """(B, d_input, H, W) -> (B, d_output, H, W) in the weights' dtype
    (float32; float64 to look at float32's own rounding)."""
    m = cfg["model"]
    dtype = w["encoder.weight"].dtype
    h = x.to(dtype).movedim(1, -1)
    b, lh, lw, _ = h.shape
    gx = torch.linspace(0.0, 1.0, lh, dtype=torch.float64,
                        device=x.device).to(dtype)
    gy = torch.linspace(0.0, 1.0, lw, dtype=torch.float64,
                        device=x.device).to(dtype)
    h = torch.cat([h, gx[None, :, None, None].expand(b, lh, lw, 1),
                   gy[None, None, :, None].expand(b, lh, lw, 1)], -1)
    h = _dense(h, w["encoder.weight"], w["encoder.bias"], q)
    for i in range(m["n_layers"]):
        y = _s4nd_layer(w, f"s4_layers.{i}.", h, q) + h
        h = torch.nn.functional.layer_norm(
            y, (y.shape[-1],), w[f"norms.{i}.weight"], w[f"norms.{i}.bias"],
            1e-6)
    return _dense(h, w["decoder.weight"], w["decoder.bias"], q).movedim(-1, 1)


def flops(cfg: dict, rows: int, grid: tuple) -> float:
    """The model's forward operations for ``rows`` samples on ``grid``: the
    dense products (2 a multiply-add), each layer's FFT convolution (the
    real 2D transform of the zero-padded (2H, 2W) grid and its inverse at
    2.5 N log2 N a channel, the spectra's complex product at 6 a bin, the
    D skip at 2 a point) and its two axis kernels (``costs.vandermonde``).
    LayerNorm, GELU and the gate are not counted."""
    m = cfg["model"]
    h, w = grid
    d, pts = m["d_model"], rows * h * w
    big = 4 * h * w
    per_layer = (2.0 * 2.5 * big * math.log2(big) * d * rows
                 + 6.0 * d * 2 * h * (w + 1) * rows + 2.0 * d * pts
                 + 2.0 * pts * d * 2 * d
                 + sum(costs.vandermonde(d, d, m["d_state"] // 2, n)[0]
                       for n in (h, w)))
    return (2.0 * pts * ((m["d_input"] + 2) * d + d * m["d_output"])
            + m["n_layers"] * per_layer)
