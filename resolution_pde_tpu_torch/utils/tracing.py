"""Spans of the program, on the clock of the profiler that records them.

``span(name)`` is a ``torch.profiler.record_function`` range while a torch
profiler records (``torch.autograd.profiler._is_profiler_enabled``, which
``torch.profiler.profile`` sets on start and clears on stop, for every
thread); otherwise it is one shared null context, so no profiler op is
entered. A profile then holds the program's spans beside the kernels they
launch, on one clock, and on the card the profiler adds a device-side range
for each span over the kernels launched inside it. Tracing is on exactly
while a profiler records: there is no other switch. ``Trainer.profile_step``
is the port's exporter of such a profile.

Names start with ``rpde.``, the kernels' C++ namespace, then the layer
(``train``, ``serve``, ``spectral``) and the phase. A span opened inside
another on the same host thread is its child.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler range ``name`` while a profiler
    records, the shared null context otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
