"""Faults planted under the timed path, for the checks that ``correct``
comes out false when the program is wrong: each a context manager that
patches the program's class for its duration.

- ``unchanged_state``: a train step returns its state unchanged (the loss
  of the batch is still computed and returned);
- ``half_batch``: a train step leaves out the second half of the batch and
  takes the mean over the rest;
- ``flipped_update``: a train step applies its update with the wrong sign
  (the gradient, the optimizer's state and the update's norm all right);
- ``altered_answer``: a served answer's first row comes back transposed
  (its grid's axes swapped, as a layout slip would leave it).
"""

from __future__ import annotations

import contextlib

import torch

from resolution_pde_tpu_torch.deploy import ServingEngine
from resolution_pde_tpu_torch.train import Trainer


@contextlib.contextmanager
def _patched(cls, name: str, make):
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def unchanged_state():
    def make(orig):
        def train_step(self, state, x, y, weights=None):
            return state, self.eval_step(state, x, y)
        return train_step
    return _patched(Trainer, "train_step", make)


def half_batch():
    def make(orig):
        def train_step(self, state, x, y, weights=None):
            n = x.shape[0] // 2
            return orig(self, state, x[:n], y[:n])
        return train_step
    return _patched(Trainer, "train_step", make)


def flipped_update():
    def make(orig):
        def train_step(self, state, x, y, weights=None):
            before = [p.detach().clone() for p in state.model.parameters()]
            out = orig(self, state, x, y)
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(2 * b - p)
            return out
        return train_step
    return _patched(Trainer, "train_step", make)


def altered_answer():
    def make(orig):
        def predict(self, x):
            out = orig(self, x)
            out[0] = out[0].swapaxes(-1, -2).copy()
            return out
        return predict
    return _patched(ServingEngine, "predict", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "flipped_update": flipped_update, "altered_answer": altered_answer}
