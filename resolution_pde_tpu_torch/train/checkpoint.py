"""Checkpoints with ``torch.save``: exact resume of a training run.

Counterpart of resolution_pde_tpu/train/checkpoint.py. A checkpoint is a
directory holding ``state.pt`` (the parameters, the optimizer state, the
step, the dropout generator's state, and optionally the epoch history and
a free-form ``extra`` payload such as ``ReduceLROnPlateau.state_dict()``)
and ``manifest.json``, the named structure of the parameters, which makes a
restore into a mismatched model fail loudly.

A sharded model (parallel/shard.py) saves its full state: every rank
calls ``save_checkpoint`` (the shards and their moments are gathered, a
collective), and only rank 0 writes. A restore reads the full state on
every rank and slices each rank's shards from it, so a checkpoint moves
between layouts and world sizes.

``block=False`` saves asynchronously, as the JAX package's Orbax saver
does: the state is copied to host memory on the caller's thread (the next
optimizer step updates the live tensors in place, so the copy shares no
storage with them), then written, with its manifest, by one background
writer shared by every save. ``wait_for_checkpoints()`` drains it, and
runs at exit.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch

from resolution_pde_tpu_torch.parallel.mesh import is_lead
from resolution_pde_tpu_torch.parallel.shard import (
    full_optimizer_state_dict, full_shapes, full_state_dict,
    load_full_optimizer_state_dict, load_full_state_dict)

# bump when the checkpoint payload layout changes
CHECKPOINT_FORMAT_VERSION = 1
_PAYLOAD = "state.pt"
_MANIFEST = "manifest.json"


def _manifest(model) -> list:
    """[name, full shape] of every entry of the model's state_dict."""
    return [[k, shape] for k, shape in full_shapes(model).items()]


# one writer for every asynchronous save, so saves land in the order they
# were issued and wait_for_checkpoints() can drain them all
_WRITER: Optional[ThreadPoolExecutor] = None
_PENDING: list = []
_LOCK = threading.Lock()


def _host_copy(obj):
    """A copy of a nest of dicts, lists and tensors with every tensor
    copied to host memory: storage of its own, complete on return."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _write(path: str, payload: dict, manifest: dict) -> None:
    """The payload to a temporary file renamed into place, then the
    manifest."""
    tmp = os.path.join(path, _PAYLOAD + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _PAYLOAD))
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f)


def wait_for_checkpoints() -> None:
    """Block until every asynchronous save issued so far is on disk with
    its manifest; raises the first save's error. Runs at exit (atexit
    below); call it before reading a checkpoint back."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    error = None
    for fut in pending:
        try:
            fut.result()
        except Exception as e:  # read every future, raise the first
            error = error or e
    if error is not None:
        raise error


# a clean exit drains the asynchronous saves
atexit.register(wait_for_checkpoints)


def save_checkpoint(path: str, state, history: Optional[dict] = None,
                    extra: Optional[dict] = None,
                    block: bool = True) -> None:
    """Save a TrainState (+ scalar history) to ``path`` (a directory).
    history: e.g. ``dataclasses.asdict(History)``; empty series are left
    out. The payload is written to a temporary file and renamed into place,
    so a crash never leaves half a checkpoint under the name.

    block=False returns once the state is copied to host memory and leaves
    the writing to the background writer: the training loop goes on while
    the file is written. Call ``wait_for_checkpoints()`` before relying on
    the files. A blocking save first waits for the saves in flight, so a
    late asynchronous write cannot land over it."""
    global _WRITER
    path = os.path.abspath(path)
    payload = {
        "format_version": CHECKPOINT_FORMAT_VERSION,
        "params": full_state_dict(state.model),
        "opt_state": full_optimizer_state_dict(state.model, state.optimizer),
        "step": int(state.step),
        "dropout_generator": state.dropout_generator.get_state(),
    }
    if history is not None:
        payload["history"] = {k: [float(a) for a in v]
                              for k, v in history.items() if v}
    if extra is not None:
        payload["extra"] = extra
    manifest = {"format_version": CHECKPOINT_FORMAT_VERSION,
                "params": _manifest(state.model)}
    if not is_lead():
        return
    os.makedirs(path, exist_ok=True)
    if block:
        wait_for_checkpoints()
        _write(path, payload, manifest)
        return
    snapshot = _host_copy(payload)
    with _LOCK:
        if _WRITER is None:
            _WRITER = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="checkpoint")
        fut: Future = _WRITER.submit(_write, path, snapshot, manifest)
        _PENDING.append(fut)


def restore_checkpoint(path: str, state, with_extra: bool = False):
    """Restore into ``state`` (a TrainState of the same model), in place.

    Returns (state, history_dict_or_None), or with ``with_extra=True``
    (state, history, extra_dict_or_None).
    """
    path = os.path.abspath(path)
    manifest_path = os.path.join(path, _MANIFEST)
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        want = _manifest(state.model)
        got = [list(g) for g in manifest.get("params", [])]
        if got != want:
            missing = [w[0] for w in want
                       if w[0] not in {g[0] for g in got}]
            extra_keys = [g[0] for g in got
                          if g[0] not in {w[0] for w in want}]
            shape_diffs = [
                (w[0], g[1], w[1])
                for w, g in zip(want, got) if w[0] == g[0] and w[1] != g[1]]
            raise ValueError(
                "checkpoint param structure does not match the model: "
                f"missing={missing[:5]} unexpected={extra_keys[:5]} "
                f"shape_mismatches={shape_diffs[:5]} "
                f"(checkpoint format v{manifest.get('format_version')})")
    payload = torch.load(os.path.join(path, _PAYLOAD), map_location="cpu",
                         weights_only=True)
    load_full_state_dict(state.model, payload["params"])
    load_full_optimizer_state_dict(state.model, state.optimizer,
                                   payload["opt_state"])
    state.step = int(payload["step"])
    state.dropout_generator.set_state(payload["dropout_generator"])
    if with_extra:
        return state, payload.get("history"), payload.get("extra")
    return state, payload.get("history")
