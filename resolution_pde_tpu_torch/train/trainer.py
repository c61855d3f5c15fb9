"""Training and evaluation harness.

Counterpart of resolution_pde_tpu/train/trainer.py (reference semantics of
train/training.py:19-147):
  - per batch: forward, the y-normalizer's decode of prediction AND target
    before the loss (with ``use_normalizer``), relative L2 (weighted batch
    mean), one AdamW step;
  - ``accum_steps`` > 1: the batch split into that many microbatches, a
    batch that does not divide padded with zero-weight rows, each
    microbatch's loss and gradient weighted by its count of real rows, one
    optimizer step;
  - BatchNorm models (CNO, UNet): each microbatch's forward runs in
    train mode, so the running statistics (buffers, not parameters: no
    weight decay, as flax's ``batch_stats``; the norms' weight and bias
    are decayed, as flax's scale and bias) move once a microbatch, in the
    microbatches' order, as JAX threads ``batch_stats`` through its scan;
    the zero-weight rows padding a straggler batch enter that
    microbatch's statistics in both. JAX's ``straggler="replicate"``
    (placing an indivisible batch whole on every device of its mesh) is
    the identity on one device, so there is nothing to port;
  - per epoch: the mean of the batch losses (one host sync per epoch), a
    validation pass with the same decode, the scheduler stepped once after
    the epoch (ReduceLROnPlateau sees the validation loss), then
    ``epoch_callback``;
  - ``evaluate``: per-batch mean relative L2 averaged over batches.

The optimizer is the JAX package's optax chain (clip_by_global_norm,
scale_by_adam, add_decayed_weights(1e-4) masked off the S4 state-space
parameters (``models.s4.SSM_PARAM_NAMES``), scale by -lr): that is
``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8)`` over two groups,
``weight_decay`` for the others and 0 for those (an empty group is left
out, so a model without them has one group), with
the clip written out as optax writes it (scale by c / ||g|| when
||g|| >= c; ``clip_grad_norm_`` would add 1e-6 to the norm). With
``ssm_lr`` the state-space group trains at ``ratio * lr``, ratio =
min(ssm_lr, lr) / lr, which optax writes as ``scale(ratio)`` masked to
those parameters inside one injected rate: ``set_lr`` keeps the ratio, so
they anneal with the main rate. Dropout draws
from one ``torch.Generator`` on the device, seeded with ``seed + 1``, which
the checkpoint saves. Batches are staged in pinned host memory and copied
with ``non_blocking``, one batch ahead of the step that uses them.

``profile_step`` traces steps with ``torch.profiler`` where JAX uses
``jax.profiler``. Not ported (JAX-only or later slices): ``mesh`` and
``param_specs`` (data and tensor parallelism) and ``auto_layout`` (an XLA
layout tool).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from resolution_pde_tpu_torch.models.layers import Dropout
from resolution_pde_tpu_torch.models.registry import unwrap_output
from resolution_pde_tpu_torch.models.s4 import SSM_PARAM_NAMES
from resolution_pde_tpu_torch.ops.losses import relative_l2
from resolution_pde_tpu_torch.train.schedules import ReduceLROnPlateau


@dataclass
class TrainState:
    """What a training run carries from step to step: the model (whose
    parameters are the JAX state's ``params``), the AdamW optimizer
    (``opt_state``), the step count and the dropout generator
    (``dropout_key``). The trainer updates it in place and returns it, so
    call sites read as the JAX package's."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    dropout_generator: torch.Generator


@dataclass
class History:
    train_loss: list = field(default_factory=list)
    val_loss: list = field(default_factory=list)
    lr: list = field(default_factory=list)
    epoch_time_s: list = field(default_factory=list)


def _ssm_ids(model: nn.Module) -> set:
    """ids of the model's state-space parameters (``SSM_PARAM_NAMES``)."""
    return {id(p) for name, p in model.named_parameters()
            if name.rsplit(".", 1)[-1] in SSM_PARAM_NAMES}


class Trainer:
    """Runs train and eval steps of ``model`` on ``device``, the card unless
    the caller asks for the CPU; the model is moved there, and a CUDA
    device raises when CUDA is not available. ``model(x)`` returns a
    prediction with the layout of y (or {'output': prediction})."""

    def __init__(self, model: nn.Module, learning_rate: float = 1e-3,
                 weight_decay: float = 1e-4, use_normalizer: bool = False,
                 y_normalizer=None, grad_clip: Optional[float] = None,
                 ssm_lr: Optional[float] = None, seed: int = 0,
                 accum_steps: int = 1, device="cuda"):
        """ssm_lr: the S4 family's state-space parameters
        (``SSM_PARAM_NAMES``) train at min(ssm_lr, learning_rate), with no
        weight decay, and anneal in proportion with the main rate (JAX
        Trainer, the reference's ``_optim`` attributes)."""
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Trainer(device={str(device)!r}): CUDA is "
                               "not available")
        self.device = device
        self.model = model.to(device)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.use_normalizer = use_normalizer
        self.y_normalizer = (y_normalizer.to(self.device)
                             if y_normalizer is not None else None)
        self.grad_clip = grad_clip
        self.seed = seed
        self.accum_steps = int(accum_steps)
        self.ssm_ratio = (min(ssm_lr, learning_rate) / learning_rate
                          if ssm_lr is not None else 1.0)

    # -- state ----------------------------------------------------------
    def init(self) -> TrainState:
        """A fresh optimizer over the model's current parameters, step 0,
        and the dropout generator, which every Dropout of the model then
        draws from."""
        ssm_ids = _ssm_ids(self.model)
        decayed = [p for p in self.model.parameters()
                   if id(p) not in ssm_ids]
        ssm = [p for p in self.model.parameters() if id(p) in ssm_ids]
        groups = [g for g in (
            dict(params=decayed, weight_decay=self.weight_decay),
            dict(params=ssm, weight_decay=0.0,
                 lr=self.ssm_ratio * self.learning_rate))
            if g["params"]]
        opt = torch.optim.AdamW(groups, lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = gen
        return TrainState(model=self.model, optimizer=opt, step=0,
                          dropout_generator=gen)

    def set_lr(self, state: TrainState, lr: float) -> TrainState:
        """The main rate ``lr``; the state-space group's ``ratio * lr``."""
        ssm_ids = _ssm_ids(state.model)
        for group in state.optimizer.param_groups:
            is_ssm = id(group["params"][0]) in ssm_ids
            group["lr"] = self.ssm_ratio * lr if is_ssm else lr
        return state

    def current_lr(self, state: TrainState) -> float:
        """The main rate (the state-space group's over the ratio where the
        model has no other parameter)."""
        group = state.optimizer.param_groups[0]
        if id(group["params"][0]) in _ssm_ids(state.model):
            return float(group["lr"]) / self.ssm_ratio
        return float(group["lr"])

    # -- steps ----------------------------------------------------------
    def _to_device(self, a) -> torch.Tensor:
        """Host array or tensor -> tensor on the device; float64 becomes
        float32, as JAX's arrays do. From the host the copy goes through
        pinned memory without blocking the host."""
        t = torch.as_tensor(a)
        if t.dtype == torch.float64:
            t = t.float()
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _decode_for_loss(self, pred, y, y_normalizer):
        if self.use_normalizer and y_normalizer is not None:
            pred = y_normalizer.decode(pred)
            y = y_normalizer.decode(y)
        return pred, y

    def _loss(self, model, x, y, weights, y_normalizer):
        pred = unwrap_output(model(x))
        pred, target = self._decode_for_loss(pred, y, y_normalizer)
        return relative_l2(pred, target, weights=weights)

    def _clip_grads(self, params) -> None:
        """optax.clip_by_global_norm: g -> g / ||g|| * c when ||g|| >= c,
        decided on the device (no host sync)."""
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
        c = self.grad_clip
        for g in grads:
            g.copy_(torch.where(norm < c, g, g / norm * c))

    def train_step(self, state: TrainState, x, y, weights=None) -> tuple:
        """One optimizer step on the batch (x, y); weights: optional (B,)
        per-sample loss weights. Returns (state, loss) with the loss a
        0-dim tensor on the device."""
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        x, y = self._to_device(x), self._to_device(y)
        if weights is not None:
            weights = self._to_device(weights).float()
        accum = self.accum_steps
        if accum > 1:
            b = x.shape[0]
            pad = (-b) % accum
            if pad:
                # pad with copies of row 0 that weigh nothing (they still
                # enter a BatchNorm's statistics, as in JAX)
                if weights is None:
                    weights = torch.ones(b, device=self.device)
                x = torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
                y = torch.cat([y, y[:1].expand(pad, *y.shape[1:])])
                weights = torch.cat([weights,
                                     torch.zeros(pad, device=self.device)])
                b += pad
            mb = b // accum
            wm = (weights.reshape(accum, mb) if weights is not None
                  else torch.ones((accum, mb), device=self.device))
            denom = torch.clamp(wm.sum(), min=1.0)
            loss = torch.zeros((), device=self.device)
            for i in range(accum):
                part = slice(i * mb, (i + 1) * mb)
                li = self._loss(model, x[part], y[part], wm[i],
                                self.y_normalizer)
                # each microbatch weighs its count of real rows, so a
                # padded batch reproduces the weighted mean of accum = 1
                wsum = wm[i].sum()
                (li * (wsum / denom)).backward()
                loss = loss + li.detach() * wsum
            loss = loss / denom
        else:
            loss = self._loss(model, x, y, weights, self.y_normalizer)
            loss.backward()
            loss = loss.detach()
        if self.grad_clip:
            self._clip_grads(model.parameters())
        opt.step()
        state.step += 1
        return state, loss

    @torch.no_grad()
    def eval_step(self, state: TrainState, x, y,
                  y_normalizer="trainer") -> torch.Tensor:
        if y_normalizer == "trainer":
            y_normalizer = self.y_normalizer
        state.model.eval()
        x, y = self._to_device(x), self._to_device(y)
        return self._loss(state.model, x, y, None, y_normalizer)

    def profile_step(self, state: TrainState, x, y, trace_dir: str,
                     n_steps: int = 5) -> tuple:
        """Trace ``n_steps`` train steps on (x, y), after one to warm up,
        with torch.profiler (CPU activity, and CUDA's on the card); the
        Chrome trace goes into ``trace_dir``. Returns (state,
        trace_dir)."""
        state, loss = self.train_step(state, x, y)
        float(loss)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n_steps):
                state, loss = self.train_step(state, x, y)
            float(loss)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"train_step_{state.step}.pt.trace.json"))
        return state, trace_dir

    # -- loops ----------------------------------------------------------
    def _prefetch(self, loader: Iterable):
        """Start each batch's host-to-device copy before the step on the
        batch ahead of it runs, so copy and step overlap."""
        pending = None
        for batch in loader:
            nxt = tuple(self._to_device(a) for a in batch)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def train_epoch(self, state: TrainState, loader: Iterable) -> tuple:
        """One pass over ``loader`` (an iterable of (x, y) batches).
        Returns (state, mean batch loss as a float)."""
        losses = []
        for x, y in self._prefetch(loader):
            state, loss = self.train_step(state, x, y)
            losses.append(loss)
        # one host sync per epoch, not per batch
        total = float(torch.stack(losses).sum()) if losses else 0.0
        return state, total / max(len(losses), 1)

    def evaluate(self, state: TrainState, loader: Iterable,
                 y_normalizer="trainer") -> float:
        """Average per-batch mean relative L2 (reference evaluate(),
        train/training.py:105-146)."""
        losses = [self.eval_step(state, x, y, y_normalizer)
                  for x, y in self._prefetch(loader)]
        if not losses:
            return 0.0
        return float(torch.stack(losses).sum()) / len(losses)

    def fit(self, state: TrainState,
            train_loader_fn: Callable[[], Iterable] | Iterable,
            val_loader_fn: Callable[[], Iterable] | Iterable | None = None,
            epochs: int = 1,
            schedule: Callable[[int], float] | ReduceLROnPlateau | None = None,
            log_fn: Callable[[dict], None] | None = None,
            epoch_callback: Callable[[int, TrainState, History], None]
            | None = None) -> tuple:
        """Epoch loop with the scheduler stepped after each epoch.

        Loaders may be factories (called each epoch, so a shuffling
        pipeline draws anew) or re-iterable objects. epoch_callback(epoch,
        state, history_so_far) runs after each epoch's scheduler step and
        logging: the periodic-checkpoint hook.
        """
        history = History()
        for epoch in range(epochs):
            t0 = time.perf_counter()
            loader = (train_loader_fn() if callable(train_loader_fn)
                      else train_loader_fn)
            state, train_loss = self.train_epoch(state, loader)
            history.train_loss.append(train_loss)

            val_loss = float("nan")
            if val_loader_fn is not None:
                vloader = (val_loader_fn() if callable(val_loader_fn)
                           else val_loader_fn)
                val_loss = self.evaluate(state, vloader)
            history.val_loss.append(val_loss)

            # scheduler: stepped AFTER the epoch, plateau sees val loss
            if isinstance(schedule, ReduceLROnPlateau):
                state = self.set_lr(state, schedule.step(val_loss))
            elif schedule is not None:
                state = self.set_lr(state, schedule(epoch + 1))
            history.lr.append(self.current_lr(state))
            history.epoch_time_s.append(time.perf_counter() - t0)

            if log_fn is not None:
                log_fn({"epoch": epoch, "train_loss": train_loss,
                        "val_loss": val_loss, "lr": history.lr[-1],
                        "epoch_time_s": history.epoch_time_s[-1]})
            if epoch_callback is not None:
                epoch_callback(epoch, state, history)
        return state, history

