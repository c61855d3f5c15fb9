"""The general generator of the benchmark's inputs: fields and targets made
on the device from a seed, by the parameters a traffic file gives.

``fields``: Gaussian random fields on the periodic grid with covariance
proportional to (-Laplacian + tau^2)^(-alpha) (the initial vorticity of the
Navier-Stokes data of Li et al.'s FNO, alpha 2.5 and tau 7):
u = real(ifft2(sqrt_eig (xr + i xi))), sqrt_eig = N sqrt(2) sigma (4 pi^2
|k|^2 + tau^2)^(-alpha / 2), sigma = tau^(alpha - 1), the mean mode zero.
``target``: the field carried by the linear advection-diffusion u_t + c .
grad u = nu Laplacian u over a time t, exactly in Fourier space, a stand-in
for the solver's next frame that the benchmark can make in one transform.
"""

from __future__ import annotations

import math

import torch


def _wavenumbers(n: int, device) -> torch.Tensor:
    return torch.fft.fftfreq(n, d=1.0 / n, device=device, dtype=torch.float64)


def fields(gen: torch.Generator, rows: int, channels: int, grid: tuple,
           spec: dict, device) -> torch.Tensor:
    """(rows, channels, H, W) float32 fields from ``gen``: spec {"alpha",
    "tau"}, and optionally "amplitude": [lo, hi], each row scaled by a
    factor log-uniform in it (fields from all along a decaying trajectory).
    Square or not, each axis has its own wavenumbers."""
    h, w = grid
    alpha, tau = float(spec["alpha"]), float(spec["tau"])
    sigma = tau ** (alpha - 1.0)
    kh, kw = _wavenumbers(h, device), _wavenumbers(w, device)
    ksq = kh[:, None] ** 2 + kw[None, :] ** 2
    eig = (h * w) * math.sqrt(2.0) * sigma * (
        4.0 * math.pi ** 2 * ksq + tau ** 2) ** (-alpha / 2.0)
    eig[0, 0] = 0.0
    eig = eig.float()
    xr = torch.randn((rows, channels, h, w), generator=gen, device=device)
    xi = torch.randn((rows, channels, h, w), generator=gen, device=device)
    coeff = torch.complex(eig * xr, eig * xi)
    u = torch.fft.ifft2(coeff).real
    if "amplitude" in spec:
        lo, hi = (math.log(float(a)) for a in spec["amplitude"])
        r = torch.rand((rows, 1, 1, 1), generator=gen, device=device)
        u = u * torch.exp(lo + (hi - lo) * r)
    return u.contiguous()


def target(x: torch.Tensor, spec: dict) -> torch.Tensor:
    """x carried over time t by u_t + c . grad u = nu Laplacian u on the unit
    torus: spec {"nu", "t", "shift": [c_h t, c_w t]}."""
    h, w = x.shape[-2:]
    kh, kw = _wavenumbers(h, x.device), _wavenumbers(w, x.device)
    sh, sw = spec["shift"]
    ksq = kh[:, None] ** 2 + kw[None, :] ** 2
    decay = torch.exp(-float(spec["nu"]) * 4.0 * math.pi ** 2 * ksq
                      * float(spec["t"]))
    phase = -2.0 * math.pi * (kh[:, None] * sh + kw[None, :] * sw)
    mult = torch.polar(decay, phase).to(torch.complex64)
    return torch.fft.ifft2(torch.fft.fft2(x) * mult).real.contiguous()


def pool(seed: int, traffic: dict, device, with_target: bool) -> list:
    """The traffic's pool of batches from ``seed``: [x] or [(x, y)], each
    (rows, channels, H, W) float32 on the host, every row a draw of its
    own."""
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    grid = tuple(traffic["grid"])
    out = []
    for _ in range(traffic["pool"]):
        x = fields(gen, traffic["rows"], traffic["channels"], grid,
                   traffic["fields"], device)
        if with_target:
            out.append((x.cpu(), target(x, traffic["target"]).cpu()))
        else:
            out.append(x.cpu())
    return out
