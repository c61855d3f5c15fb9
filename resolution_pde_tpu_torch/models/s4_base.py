"""Configurable S4 base and sequence models.

Counterpart of resolution_pde_tpu/models/s4_base.py (the reference's
models/s4_model.py:105-279 and models/s4seq_model.py:22-546):

  - ``S4BaseModel``: a grid-input processor, the encoder, per-layer
    (norm, dropout, residual, ffn) choices around S4Blocks, pre- or
    post-norm, an interlayer activation, the decoder and an output
    processor; ``OneToSeqModel`` re-applies one to a trajectory, and
    ``predict_chunked`` rolls out long horizons window by window;
  - the sequence models over time, ``S4SeqModel`` and ``S4BaseSeqModel``
    (space flattened into the batch, causal S4 over time),
    ``S4DualSeqModel`` (layers alternating over space and time),
    ``SeqAdd`` and ``ChainModel`` (temporal super-resolution);
  - their recurrent forms, ``s4seq_recurrent_fns``,
    ``s4dualseq_recurrent_fns`` and ``chain_predict``, on top of the
    kernel layers' step functions (``models.s4``).

The registries' semantics are the reference's (models/custom_layer.py:
118-142): residual in {weighted, identity, zero}, norm in {LayerNorm,
identity}, ffn in {ffn, zero}; 'ffn' is the port's ``FeedForward(d_model,
factor=4, n_layers=2)`` on its dense route. Torch builds its layers before
the first call, so the encoders' input width is a constructor argument
where flax infers it: ``S4BaseModel`` reads ``d_input`` features after
its input processor (the reference's convention), the sequence models
``d_input + 1`` (the variables and a one-feature grid); an input of
another width raises. LayerNorms take flax's eps 1e-6. The recurrent
builders take the port's model or its state_dict where JAX takes a
parameter tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from resolution_pde_tpu_torch.models import io_processors as iop
from resolution_pde_tpu_torch.models.layers import (ACTIVATIONS, Dropout,
                                                    FeedForward, gelu)
from resolution_pde_tpu_torch.models.s4 import (S4Block, dense,
                                                dplr_recurrent_step_fn,
                                                s4d_recurrent_step_fn)

RESIDUALS = ("identity", "zero", "weighted")
LAYER_PROCESSORS = ("BatchTime", "BatchSpace")


def _extend(value, n):
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{len(value)} per-layer values for {n} layers")
        return list(value)
    return [value] * n


def _check_width(x, want: int, what: str) -> None:
    if x.shape[-1] != want:
        raise ValueError(f"{what}: the encoder reads {want} features, the "
                         f"input has {x.shape[-1]}")


def _layer_norm(d_model: int, on: bool) -> nn.Module:
    return nn.LayerNorm(d_model, eps=1e-6) if on else nn.Identity()


class _Residual(nn.Module):
    """The residual branch: x, 0, or a Dense (``dense``)."""

    def __init__(self, kind: str, d_model: int, *, generator=None):
        super().__init__()
        if kind not in RESIDUALS:
            raise ValueError(f"unknown residual {kind!r}")
        self.kind = kind
        if kind == "weighted":
            self.dense = dense(d_model, d_model, generator)

    def forward(self, x):
        if self.kind == "identity":
            return x
        if self.kind == "zero":
            return x * 0.0
        return self.dense(x)


class S4BaseModel(nn.Module):
    """x (B, S, [T,] V) + grid (B, S, 1) -> the output processor's layout.
    The encoder reads ``d_input`` features after the input processor
    (Concat: the variables and the grid). Modules: ``encoder``,
    ``s4_layers.{i}`` (S4Blocks), ``norms.{i}``, ``residuals.{i}``,
    ``ffns.{i}`` with ``ffn_norms.{i}``, and ``decoder`` (after
    ``decoder_hidden`` and a GELU with final_mlp_hidden_expansion)."""

    def __init__(self, d_input: int, d_output: int = 10, d_model: int = 256,
                 n_layers: int = 4, exo_dropout: float = 0.0,
                 prenorm: bool = False, interlayer_act: Optional[str] = None,
                 input_processor: str = "Concat",
                 output_processor: str = "identity",
                 residual_type="identity", norm_type="LayerNorm",
                 ffn_type="zero", mode: str = "diag",
                 bidirectional: bool = False, s4_dropout: float = 0.0,
                 final_mlp_hidden_expansion: Optional[int] = None,
                 kernel_args: Optional[dict] = None, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.d_input, self.prenorm = d_input, prenorm
        self.interlayer_act = interlayer_act
        self.input_processor = iop.GRID_INPUT_REGISTRY[input_processor]
        self.output_processor = iop.OUTPUT_REGISTRY[output_processor]
        self.layer_norm = [n == "LayerNorm"
                           for n in _extend(norm_type, n_layers)]
        self.with_ffn = [f == "ffn" for f in _extend(ffn_type, n_layers)]
        self.encoder = dense(d_input, d_model, g)
        self.s4_layers = nn.ModuleList([
            S4Block(d_model, mode=mode, bidirectional=bidirectional,
                    dropout=s4_dropout, kernel_args=kernel_args, generator=g)
            for _ in range(n_layers)])
        self.exo_dropouts = nn.ModuleList([Dropout(exo_dropout)
                                           for _ in range(n_layers)])
        self.residuals = nn.ModuleList([
            _Residual(r, d_model, generator=g)
            for r in _extend(residual_type, n_layers)])
        self.norms = nn.ModuleList([_layer_norm(d_model, on)
                                    for on in self.layer_norm])
        self.ffns = nn.ModuleList([
            FeedForward(d_model, factor=4, n_layers=2, generator=g) if on
            else nn.Identity() for on in self.with_ffn])
        self.ffn_norms = nn.ModuleList([_layer_norm(d_model, on)
                                        for on in self.with_ffn])
        if final_mlp_hidden_expansion is not None:
            width = final_mlp_hidden_expansion * d_model
            self.decoder_hidden = dense(d_model, width, g)
            self.decoder = dense(width, d_output, g)
        else:
            self.decoder = dense(d_model, d_output, g)
        if device is not None:
            self.to(device)

    def forward(self, x, grid):
        input_shape = x.shape
        x = self.input_processor(x, grid)
        _check_width(x, self.d_input, "S4BaseModel")
        x = self.encoder(x)
        for i, block in enumerate(self.s4_layers):
            z = x
            if self.prenorm and self.layer_norm[i]:
                z = self.norms[i](z)
            z = self.exo_dropouts[i](block(z))
            x = z + self.residuals[i](x)
            if not self.prenorm and self.layer_norm[i]:
                x = self.norms[i](x)
            if self.with_ffn[i]:
                if self.prenorm:
                    x = self.ffn_norms[i](x)
                x = self.ffns[i](x) + x
                if not self.prenorm:
                    x = self.ffn_norms[i](x)
            if self.interlayer_act:
                x = ACTIVATIONS[self.interlayer_act](x)
        if hasattr(self, "decoder_hidden"):
            x = gelu(self.decoder_hidden(x))
        return self.output_processor(self.decoder(x), input_shape)


def _with_grid(x, grid):
    """(B, T, S, V) with the grid (B, S, 1) attached at every time."""
    b, t, s = x.shape[:3]
    return torch.cat([x, grid[:, None].expand(b, t, s, grid.shape[-1])],
                     dim=-1)


class S4SeqModel(nn.Module):
    """Sequence to sequence over time: x (B, T, S, V) + grid (B, S, 1) ->
    (B, T, S, d_output), space flattened into the batch
    (s4seq_model.py:115 through BatchSpace / UnbatchSpace). The encoder
    reads d_input + 1."""

    def __init__(self, d_input: int, d_output: int = 1, d_model: int = 128,
                 n_layers: int = 4, dropout: float = 0.0, mode: str = "diag",
                 kernel_args: Optional[dict] = None, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.d_in = d_input + 1
        self.encoder = dense(self.d_in, d_model, g)
        self.s4_layers = nn.ModuleList([
            S4Block(d_model, mode=mode, dropout=dropout,
                    kernel_args=kernel_args, generator=g)
            for _ in range(n_layers)])
        self.decoder = dense(d_model, d_output, g)
        if device is not None:
            self.to(device)

    def forward(self, x, grid):
        input_shape = x.shape
        x = _with_grid(x, grid)
        _check_width(x, self.d_in, "S4SeqModel")
        x = self.encoder(iop.batch_space(x))           # ((B S), T, D)
        for block in self.s4_layers:
            x = block(x) + x
        return iop.unbatch_space(self.decoder(x), input_shape)


class OneToSeqModel(nn.Module):
    """A single state -> a trajectory (s4seq_model.py:384): one
    ``S4BaseModel`` (``inner``, Concat in, identity out) applied
    ``n_timesteps`` times to its own output. x0 (B, S, V) ->
    (B, n_timesteps, S, d_output)."""

    def __init__(self, d_input: int, d_output: int = 1, d_model: int = 64,
                 n_layers: int = 2, n_timesteps: int = 10,
                 mode: str = "diag", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_timesteps = n_timesteps
        self.inner = S4BaseModel(
            d_input=d_input, d_output=d_output, d_model=d_model,
            n_layers=n_layers, mode=mode, input_processor="Concat",
            output_processor="identity", generator=generator)
        if device is not None:
            self.to(device)

    def forward(self, x0, grid):
        outs, state = [], x0
        for _ in range(self.n_timesteps):
            state = self.inner(state, grid)
            outs.append(state)
        return torch.stack(outs, dim=1)


def predict_chunked(apply_fn, x0, grid, n_timesteps: int,
                    train_timesteps: int, lg_length: Optional[int] = None):
    """Long-horizon rollout in windows of ``train_timesteps``, each re-seeded
    from the last prediction (s4_model.py:261-279). apply_fn(x0, grid,
    steps) -> (B, steps, ...)."""
    if lg_length is None:
        lg_length = train_timesteps
    y = apply_fn(x0, grid, min(train_timesteps, n_timesteps))
    while y.shape[1] < n_timesteps:
        t_i = -train_timesteps + lg_length - 1 + y.shape[1]
        pred_steps = min(train_timesteps, n_timesteps - t_i - 1)
        y_new = apply_fn(y[:, t_i], grid, pred_steps)[:, -lg_length:]
        y = torch.cat([y, y_new], dim=1)
    return y[:, :n_timesteps]


class S4BaseSeqModel(nn.Module):
    """Sequence in, sequence out (s4seq_model.py:22-113): x (B, T, S, V) +
    grid (B, S, 1) -> (B, T, S, d_output); space flattened into the batch,
    causal S4Blocks over time, each with a residual, exo dropout and the
    interlayer activation. The encoder reads d_input + 1. The recurrent
    form is ``s4seq_recurrent_fns``."""

    def __init__(self, d_input: int, d_output: int = 1, d_model: int = 128,
                 n_layers: int = 4, exo_dropout: float = 0.0,
                 interlayer_act: Optional[str] = None, mode: str = "diag",
                 kernel_args: Optional[dict] = None, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.d_model, self.n_layers, self.mode = d_model, n_layers, mode
        self.interlayer_act, self.kernel_args = interlayer_act, kernel_args
        self.d_in = d_input + 1
        self.encoder = dense(self.d_in, d_model, g)
        self.s4_layers = nn.ModuleList([
            S4Block(d_model, mode=mode, kernel_args=kernel_args, generator=g)
            for _ in range(n_layers)])
        self.exo_dropouts = nn.ModuleList([Dropout(exo_dropout)
                                           for _ in range(n_layers)])
        self.decoder = dense(d_model, d_output, g)
        if device is not None:
            self.to(device)

    def forward(self, x, grid):
        input_shape = x.shape
        x = _with_grid(x, grid)
        _check_width(x, self.d_in, "S4BaseSeqModel")
        x = self.encoder(iop.batch_space(x))           # ((B S), T, D)
        for block, drop in zip(self.s4_layers, self.exo_dropouts):
            x = drop(block(x)) + x
            if self.interlayer_act:
                x = ACTIVATIONS[self.interlayer_act](x)
        return iop.unbatch_space(self.decoder(x), input_shape)


class S4DualSeqModel(nn.Module):
    """Layers alternating over space and time (s4seq_model.py:156-331): a
    'BatchTime' layer flattens time into the batch and runs S4 over space
    (bidirectional with bidirectional_space), a 'BatchSpace' layer
    flattens space into the batch and runs causal S4 over time. x (B, T,
    S, V) + grid (B, S, 1) -> (B, T, S, d_output); the encoder reads
    d_input + 1. The recurrent form is ``s4dualseq_recurrent_fns``."""

    def __init__(self, d_input: int, d_output: int = 1, d_model: int = 128,
                 n_layers: int = 4,
                 layer_processors: Sequence[str] = LAYER_PROCESSORS,
                 bidirectional_space: bool = True, mode: str = "diag",
                 exo_dropout: float = 0.0,
                 kernel_args: Optional[dict] = None, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.d_model, self.n_layers, self.mode = d_model, n_layers, mode
        self.kernel_args = kernel_args
        self.processors = [layer_processors[i % len(layer_processors)]
                           for i in range(n_layers)]
        bad = sorted(set(self.processors) - set(LAYER_PROCESSORS))
        if bad:
            raise ValueError(f"unknown layer processor {bad[0]!r}")
        self.d_in = d_input + 1
        self.encoder = dense(self.d_in, d_model, g)
        self.s4_layers = nn.ModuleList([
            S4Block(d_model, mode=mode,
                    bidirectional=(bidirectional_space
                                   and proc == "BatchTime"),
                    kernel_args=kernel_args, generator=g)
            for proc in self.processors])
        self.exo_dropouts = nn.ModuleList([Dropout(exo_dropout)
                                           for _ in range(n_layers)])
        self.decoder = dense(d_model, d_output, g)
        if device is not None:
            self.to(device)

    def forward(self, x, grid):
        b, t, s = x.shape[:3]
        x = _with_grid(x, grid)
        _check_width(x, self.d_in, "S4DualSeqModel")
        x = self.encoder(x)
        d = x.shape[-1]
        for proc, block, drop in zip(self.processors, self.s4_layers,
                                     self.exo_dropouts):
            if proc == "BatchTime":                    # S4 over space
                z = block(x.reshape(b * t, s, d)).reshape(b, t, s, d)
            else:                                      # causal S4 over time
                z = block(x.movedim(1, 2).reshape(b * s, t, d))
                z = z.reshape(b, s, t, d).movedim(2, 1)
            x = drop(z) + x
        return self.decoder(x)


class SeqAdd(nn.Module):
    """The sum of two sequence models (s4seq_model.py:333-352)."""

    def __init__(self, model1: nn.Module, model2: nn.Module):
        super().__init__()
        self.model1, self.model2 = model1, model2

    def forward(self, x, grid):
        return self.model1(x, grid) + self.model2(x, grid)


class ChainModel(nn.Module):
    """Temporal super-resolution (s4seq_model.py:495-527): chain_length - 1
    zero frames between the input's, the inner sequence model on the fine
    time grid, every chain_length-th output read. x (B, T, S, V)."""

    def __init__(self, model: nn.Module, chain_length: int = 2):
        super().__init__()
        self.model, self.chain_length = model, chain_length

    def forward(self, x, grid):
        b, t = x.shape[:2]
        cl = self.chain_length
        inp = x.new_zeros((b, t * cl) + tuple(x.shape[2:]))
        inp[:, ::cl] = x
        return self.model(inp, grid)[:, cl - 1::cl]


# ---------------------------------------------------------------------------
# Recurrent forms (models/s4_base.py:316-515)
# ---------------------------------------------------------------------------

def _recurrent_step_options(kernel_args, mode: str):
    """A layer's kernel_args as (disc, the step builder's keywords): only
    the options that change how parameters resolve (dt_tie and n_ssm are
    read from the stored shapes)."""
    ka = dict(kernel_args or {})
    disc = ka.get("disc", "zoh")
    keys = (("dt_transform", "dt_fast", "real_transform", "imag_transform",
             "is_real", "bandlimit") if mode == "diag"
            else ("dt_transform", "dt_fast", "real_transform", "bandlimit"))
    return disc, {k: ka[k] for k in keys if k in ka}


def _state(params) -> dict:
    return params.state_dict() if isinstance(params, nn.Module) else params


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _time_layer(sd, i, mode, L_train, disc, step_kw):
    """Block i's recurrent pieces: (init_state, kernel step, D, GLU weight,
    GLU bias)."""
    pre = f"s4_layers.{i}."
    kernel = _sub(sd, pre + "layer.kernel.")
    if mode == "diag":
        init_s, kstep = s4d_recurrent_step_fn(kernel, disc=disc, **step_kw)
    else:
        init_s, kstep = dplr_recurrent_step_fn(kernel, L_train, **step_kw)
    return (init_s, kstep, sd[pre + "layer.D"][0],
            sd[pre + "output_linear.weight"], sd[pre + "output_linear.bias"])


def _block_step(layer, state, h, d_model: int):
    """One S4Block step in recurrent form: the SSM, the D bypass, GELU and
    the GLU. Returns (new state, the block's output)."""
    _, kstep, D, glu_w, glu_b = layer
    state, y = kstep(state, h)
    y = F.linear(gelu(y + D * h), glu_w, glu_b)
    return state, y[..., :d_model] * torch.sigmoid(y[..., d_model:])


def s4seq_recurrent_fns(params, d_model: int, n_layers: int, mode: str,
                        L_train: int, interlayer_act: Optional[str] = None,
                        kernel_args: Optional[dict] = None):
    """The recurrent (init_state, step) pair of an ``S4BaseSeqModel`` or
    ``S4SeqModel`` (the model, or its state_dict): the reference's
    setup_step / default_state / step (s4seq_model.py:58-113).

    step(state, x_t (B_, V), grid (B_, G)) -> (y_t (B_, d_output), state),
    B_ = batch x space, equal to the causal convolutional forward up to
    roundoff. interlayer_act and kernel_args must be the model's; L_train
    is the DPLR kernels' length (the sequence length trained at)."""
    sd = _state(params)
    disc, step_kw = _recurrent_step_options(kernel_args, mode)
    layers = [_time_layer(sd, i, mode, L_train, disc, step_kw)
              for i in range(n_layers)]

    def init_state(batch: int):
        return [layer[0](batch) for layer in layers]

    def step(state, x_t, grid):
        h = F.linear(torch.cat([x_t, grid], dim=-1), sd["encoder.weight"],
                     sd["encoder.bias"])
        new_states = []
        for layer, s in zip(layers, state):
            s2, y = _block_step(layer, s, h, d_model)
            h = y + h
            if interlayer_act:
                h = ACTIVATIONS[interlayer_act](h)
            new_states.append(s2)
        return F.linear(h, sd["decoder.weight"], sd["decoder.bias"]), \
            new_states

    return init_state, step


def s4dualseq_recurrent_fns(params, model: S4DualSeqModel, L_train: int,
                            kernel_args: Optional[dict] = None):
    """The recurrent (init_state, step) pair of an ``S4DualSeqModel``
    (s4seq_model.py:245-331); ``params`` is the model or its state_dict.
    'BatchSpace' (time) layers step their SSM state per spatial point;
    'BatchTime' (space) layers apply their whole convolution to the
    current frame (they act per time step in the convolution too).

    step(state, x_t (B, S, V), grid (B, S, G)) -> (y_t (B, S, d_output),
    state)."""
    if kernel_args is None:
        kernel_args = model.kernel_args
    sd = _state(params)
    disc, step_kw = _recurrent_step_options(kernel_args, model.mode)
    d = model.d_model
    layers = []
    for i, proc in enumerate(model.processors):
        if proc == "BatchTime":
            layers.append(("space", model.s4_layers[i],
                           _sub(sd, f"s4_layers.{i}.")))
        else:
            layers.append(("time", _time_layer(sd, i, model.mode, L_train,
                                               disc, step_kw), None))

    def init_state(batch_times_space: int):
        return [obj[0](batch_times_space) if kind == "time" else None
                for kind, obj, _ in layers]

    def step(state, x_t, grid):
        b, s_pts = x_t.shape[:2]
        h = F.linear(torch.cat([x_t, grid], dim=-1), sd["encoder.weight"],
                     sd["encoder.bias"])
        new_states = []
        for (kind, obj, block_sd), st in zip(layers, state):
            if kind == "space":
                z = torch.func.functional_call(obj, block_sd, (h,))
                new_states.append(None)
            else:
                st, y = _block_step(obj, st, h.reshape(b * s_pts, d), d)
                z = y.reshape(b, s_pts, d)
                new_states.append(st)
            h = z + h
        return F.linear(h, sd["decoder.weight"], sd["decoder.bias"]), \
            new_states

    return init_state, step


def chain_predict(params, inner_model: S4BaseSeqModel, x0, grid,
                  n_timesteps: int, train_timesteps: int,
                  chain_length: int = 2, lg_length: Optional[int] = None):
    """ChainModel's recurrent long-horizon rollout (s4seq_model.py:514-546
    _predict_inL / predict): the inner sequence model stepped on the fine
    time grid, its prediction fed back every chain_length steps and zeros
    in between, in windows of train_timesteps outputs, each re-seeded from
    the last prediction.

    params: the ChainModel, its state_dict, or the inner model's state_dict;
    inner_model: the S4BaseSeqModel. x0 (B, S, V); grid (B, S, G). Returns
    (B, n_timesteps, S, d_output)."""
    sd = _state(params)
    if any(k.startswith("model.") for k in sd):       # a ChainModel's
        sd = _sub(sd, "model.")
    init_state, step = s4seq_recurrent_fns(
        sd, inner_model.d_model, inner_model.n_layers, inner_model.mode,
        L_train=train_timesteps * chain_length,
        interlayer_act=inner_model.interlayer_act,
        kernel_args=inner_model.kernel_args)
    b, s_pts, v = x0.shape
    gf = grid.reshape(b * s_pts, -1)

    def window(x_seed):
        """train_timesteps outputs of one recurrent window, (T, B, S, d)."""
        state, inp, ys = init_state(b * s_pts), x_seed, []
        for k in range(train_timesteps * chain_length):
            y, state = step(state, inp.reshape(b * s_pts, v), gf)
            y = y.reshape(b, s_pts, -1)
            inp = y if (k + 1) % chain_length == 0 else torch.zeros_like(y)
            ys.append(y)
        return torch.stack(ys)[chain_length - 1::chain_length]

    if lg_length is None:
        lg_length = train_timesteps
    y = window(x0)
    while y.shape[0] < n_timesteps:
        y_new = window(y[-train_timesteps + lg_length - 1])[-lg_length:]
        y = torch.cat([y, y_new], dim=0)
    return y[:n_timesteps].movedim(0, 1)
