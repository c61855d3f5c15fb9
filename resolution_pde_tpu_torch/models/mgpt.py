"""MoE-GPT neural operator and its point-cloud adapter (GNOT): linear
cross- and self-attention blocks with position-gated mixture-of-experts
MLPs.

Counterpart of resolution_pde_tpu/models/mgpt.py (reference models/mgpt.py:
31-330). ``LinearAttention`` is the 'l1' type: softmax over the head dim
of q and of k, the context k^T v, the q-context product scaled by
1 / (q . sum_t k), plus q. ``MoECrossAttentionBlock``: cross-attention,
a gated MoE, self-attention, a second gated MoE (its own experts, where
the reference reuses the first set), each MoE output LayerNormed into the
residual; the gate is softmax(MLP(pos)) over the experts. The experts are
separate MLPs (``expert_impl='loop'``) or one stacked tensor with the
expert dim leading (``'stacked'``, weights (m, c, i) and (m, i, o), the
expert-parallel layout), the same function. ``MoEGPTNO``: trunk and
branch MLP encoders, the blocks, an output MLP, an optional horizontal
Fourier embedding. ``GNOTOperator`` feeds (B, T, c + space_dim) rows of
[node features | positions] to MoEGPTNO as query and branch, the
positions to the gates; flax infers c from the input, the port takes it
as ``in_features`` (1 for the NS vorticity point clouds).

The bare LayerNorms are flax's ``nn.LayerNorm()``, epsilon 1e-6 (torch's
default is 1e-5). Kernels are initialised as flax's (lecun normal), biases
zero, from ``generator`` on the CPU, then moved to ``device``.
``utils.jax_bridge.mgpt_state_dict`` / ``gnot_state_dict`` map the JAX
package's parameters onto these names.
"""

from __future__ import annotations

import torch
from torch import nn

from resolution_pde_tpu_torch.models.layers import ACTIVATIONS
from resolution_pde_tpu_torch.models.norms import lecun_normal_, linear
from resolution_pde_tpu_torch.parallel.collectives import (copy_to_group,
                                                            reduce_from_group)

# flax's nn.LayerNorm() default epsilon
FLAX_LN_EPS = 1e-6


class LinearAttention(nn.Module):
    """O(T) linear attention, 'l1' type (mgpt.py:31-90)."""

    def __init__(self, n_embd: int, n_head: int = 1, attn_pdrop: float = 0.0,
                 generator=None):
        super().__init__()
        self.n_head = n_head
        for name in ("query", "key", "value", "proj"):
            setattr(self, name, linear(n_embd, n_embd, generator=generator))
        self.attn_drop = nn.Dropout(attn_pdrop)

    def forward(self, x, y=None):
        y = x if y is None else y
        b, t1, c = x.shape
        t2 = y.shape[1]
        hs = c // self.n_head

        def heads(z, t):
            return z.reshape(b, t, self.n_head, hs).transpose(1, 2)

        q = torch.softmax(heads(self.query(x), t1), dim=-1)
        k = torch.softmax(heads(self.key(y), t2), dim=-1)
        v = heads(self.value(y), t2)
        k_cumsum = k.sum(dim=-2, keepdim=True)
        d_inv = 1.0 / (q * k_cumsum).sum(dim=-1, keepdim=True)
        context = torch.einsum("bhtd,bhte->bhde", k, v)
        out = torch.einsum("bhtd,bhde->bhte", q, context) * d_inv + q
        out = self.attn_drop(out)
        out = out.transpose(1, 2).reshape(b, t1, c)
        return self.proj(out)


class _ExpertMLP(nn.Module):
    def __init__(self, n_embd: int, n_inner: int, act: str = "gelu",
                 generator=None):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.fc1 = linear(n_embd, n_inner, generator=generator)
        self.fc2 = linear(n_inner, n_embd, generator=generator)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _StackedExpertMLP(nn.Module):
    """All experts' weights in one tensor with a leading expert dim (the
    expert-parallel layout); the same function as n_experts _ExpertMLPs.
    Returns (m, B, T, C)."""

    def __init__(self, n_embd: int, n_inner: int, n_experts: int,
                 act: str = "gelu", generator=None):
        super().__init__()
        m, c, i = n_experts, n_embd, n_inner
        self.act = ACTIVATIONS[act]
        # per expert lecun_normal, fan_in its own input width
        self.w1 = nn.Parameter(lecun_normal_(torch.empty(m, c, i), c,
                                             generator))
        self.b1 = nn.Parameter(torch.zeros(m, i))
        self.w2 = nn.Parameter(lecun_normal_(torch.empty(m, i, n_embd), i,
                                             generator))
        self.b2 = nn.Parameter(torch.zeros(m, n_embd))
        self.ep_group = None

    def enable_expert_parallel(self, group, dims: dict) -> None:
        """Hold this rank's experts of an "expert" group (parallel/shard.py
        calls this before slicing): every expert tensor sharded on its
        expert dimension 0."""
        leaves = {name.rsplit(".", 1)[-1]: d for name, d in dims.items()}
        if leaves != {"w1": 0, "b1": 0, "w2": 0, "b2": 0}:
            raise ValueError("expert parallelism shards w1, b1, w2 and b2 "
                             f"together on dimension 0, got {dims}")
        self.ep_group = group

    def combine(self, z, gate):
        """sum_m gate[..., m] * expert_m(z): (B, T, C). Under expert
        parallelism this rank's experts' share, summed over the group."""
        group = self.ep_group
        if group is None:
            return torch.einsum("mbtc,btm->btc", self(z), gate)
        m = self.w1.shape[0]
        r = torch.distributed.get_rank(group)
        z = copy_to_group(z, group)
        gate = copy_to_group(gate, group)[..., r * m:(r + 1) * m]
        return reduce_from_group(
            torch.einsum("mbtc,btm->btc", self(z), gate), group)

    def forward(self, z):
        h = torch.einsum("btc,mci->mbti", z, self.w1) + self.b1[:, None, None]
        h = self.act(h)
        return torch.einsum("mbti,mio->mbto", h, self.w2) + self.b2[:, None,
                                                                    None]


class MoECrossAttentionBlock(nn.Module):
    """mgpt.py:140-205: x + crossattn(LN x, LN y); x + LN(moe1(x));
    x + selfattn(LN x); x + LN(moe2(x))."""

    def __init__(self, n_embd: int, n_inner: int, n_head: int = 1,
                 n_experts: int = 2, space_dim: int = 2, act: str = "gelu",
                 resid_pdrop: float = 0.0, attn_pdrop: float = 0.0,
                 expert_impl: str = "loop", generator=None):
        super().__init__()
        if expert_impl not in ("loop", "stacked"):
            raise ValueError(f"expert_impl must be 'loop' or 'stacked', "
                             f"got {expert_impl!r}")
        g = generator
        self.act = ACTIVATIONS[act]
        self.expert_impl = expert_impl
        self.gate0 = linear(space_dim, n_inner, generator=g)
        self.gate1 = linear(n_inner, n_inner, generator=g)
        self.gate2 = linear(n_inner, n_experts, generator=g)
        self.crossattn = LinearAttention(n_embd, n_head, attn_pdrop, g)
        self.selfattn = LinearAttention(n_embd, n_head, attn_pdrop, g)
        for name in ("norm_x", "norm_y", "norm_moe1", "norm_self",
                     "norm_moe2"):
            setattr(self, name, nn.LayerNorm(n_embd, eps=FLAX_LN_EPS))
        for name in ("moe1", "moe2"):
            if expert_impl == "stacked":
                experts = _StackedExpertMLP(n_embd, n_inner, n_experts, act,
                                            g)
            else:
                experts = nn.ModuleList(
                    _ExpertMLP(n_embd, n_inner, act, g)
                    for _ in range(n_experts))
            setattr(self, name, experts)
        self.resid_drop = nn.Dropout(resid_pdrop)

    def _moe(self, experts, z, gate):
        if self.expert_impl == "stacked":
            return experts.combine(z, gate)
        stacked = torch.stack([e(z) for e in experts], dim=-1)  # (B,T,C,m)
        return torch.sum(gate[:, :, None, :] * stacked, dim=-1)

    def forward(self, x, y, pos):
        g = self.act(self.gate1(self.act(self.gate0(pos))))
        gate = torch.softmax(self.gate2(g), dim=-1)  # (B, T1, m)
        x = x + self.resid_drop(self.crossattn(self.norm_x(x),
                                               self.norm_y(y)))
        x = x + self.norm_moe1(self._moe(self.moe1, x, gate))
        x = x + self.resid_drop(self.selfattn(self.norm_self(x)))
        return x + self.norm_moe2(self._moe(self.moe2, x, gate))


def horizontal_fourier_embedding(x, n: int = 3):
    """(B, T, C) -> (B, T, C*(4n+3)) fourier features (mgpt.py:126-133)."""
    # made on the device (no copy from the host, which graph capture
    # refuses); the exponents are the integers -n..n, so exact
    freqs = 2.0 ** torch.linspace(-n, n, 2 * n + 1, dtype=x.dtype,
                                  device=x.device)
    xe = x[..., None]
    out = torch.cat([xe, torch.cos(freqs * xe), torch.sin(freqs * xe)],
                    dim=-1)
    return out.reshape(x.shape[0], x.shape[1], -1)


class _MLP(nn.Module):
    def __init__(self, n_in: int, n_hidden: int, n_out: int,
                 n_layers: int = 2, act: str = "gelu", generator=None):
        super().__init__()
        self.act = ACTIVATIONS[act]
        widths = [n_in] + [n_hidden] * (n_layers - 1) + [n_out]
        self.layers = nn.ModuleList(
            linear(a, b, generator=generator)
            for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        return self.layers[-1](x)


class MoEGPTNO(nn.Module):
    """Cross-attention GPT neural operator (mgpt.py:223-330).

    forward(g_query (B, T1, trunk_size), u_branch (B, T2, branch_size),
    pos (B, T1, space_dim)) -> (B, T1, output_size).
    """

    def __init__(self, trunk_size: int = 2, branch_size: int = 2,
                 space_dim: int = 2, output_size: int = 3,
                 n_layers: int = 2, n_hidden: int = 64, n_head: int = 1,
                 n_experts: int = 2, mlp_layers: int = 2, act: str = "gelu",
                 ffn_dropout: float = 0.0, attn_dropout: float = 0.0,
                 horiz_fourier_dim: int = 0, expert_impl: str = "loop", *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.horiz_fourier_dim = horiz_fourier_dim
        grow = 4 * horiz_fourier_dim + 3 if horiz_fourier_dim > 0 else 1
        self.trunk_mlp = _MLP(trunk_size * grow, n_hidden, n_hidden,
                              mlp_layers, act, g)
        self.branch_mlp = _MLP(branch_size * grow, n_hidden, n_hidden,
                               mlp_layers, act, g)
        self.blocks = nn.ModuleList(
            MoECrossAttentionBlock(n_hidden, n_hidden, n_head, n_experts,
                                   space_dim, act, ffn_dropout, attn_dropout,
                                   expert_impl, g)
            for _ in range(n_layers))
        # the JAX out_mlp takes the default activation, not ``act``
        self.out_mlp = _MLP(n_hidden, n_hidden, output_size, mlp_layers,
                            generator=g)
        if device is not None:
            self.to(device)

    def forward(self, g, u, pos):
        if self.horiz_fourier_dim > 0:
            g = horizontal_fourier_embedding(g, self.horiz_fourier_dim)
            u = horizontal_fourier_embedding(u, self.horiz_fourier_dim)
        x = self.trunk_mlp(g)
        y = self.branch_mlp(u)
        for block in self.blocks:
            x = block(x, y, pos)
        return self.out_mlp(x)


class GNOTOperator(nn.Module):
    """Standard-pipeline adapter for MoEGPTNO: x (B, T, in_features +
    space_dim) rows of [node features | positions]; query and branch both
    read the whole row, the gates the positions. Output (B, T,
    output_size)."""

    def __init__(self, space_dim: int = 2, output_size: int = 1,
                 n_layers: int = 2, n_hidden: int = 64, n_head: int = 1,
                 n_experts: int = 2, mlp_layers: int = 2, act: str = "gelu",
                 in_features: int = 1, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.space_dim = space_dim
        width = in_features + space_dim
        self.net = MoEGPTNO(
            trunk_size=width, branch_size=width, space_dim=space_dim,
            output_size=output_size, n_layers=n_layers, n_hidden=n_hidden,
            n_head=n_head, n_experts=n_experts, mlp_layers=mlp_layers,
            act=act, generator=generator)
        if device is not None:
            self.to(device)

    def forward(self, x):
        pos = x[..., -self.space_dim:]
        g = torch.cat([x[..., :-self.space_dim], pos], dim=-1)
        return self.net(g, g, pos)
