"""Model registry: short names and the reference's ``_target_`` dotted
paths to the port's modules.

Counterpart of resolution_pde_tpu/models/registry.py; FFNO1D, FFNO2D and
the 1D S4 family (S4Model, S4Block, S4D) are ported so far.
"""

from __future__ import annotations

from resolution_pde_tpu_torch.models.ffno import FFNO1D, FFNO2D
from resolution_pde_tpu_torch.models.s4 import S4D, S4Block, S4Model

MODEL_REGISTRY = {
    "FFNO1D": FFNO1D,
    "models.ffno.FFNO1D": FFNO1D,
    "FFNO2D": FFNO2D,
    "models.ffno.FFNO2D": FFNO2D,
    "S4Model": S4Model,
    "models.s4_1d.S4Model": S4Model,
    "S4Block": S4Block,
    "S4D": S4D,
    "models.s4d.S4D": S4D,
}


def unwrap_output(pred):
    """A model's prediction as a tensor: models that return
    {'output': tensor} are unwrapped, others pass through."""
    return pred["output"] if isinstance(pred, dict) else pred


def get_model(name: str):
    """Look up by short name or reference ``_target_`` dotted path."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    short = name.rsplit(".", 1)[-1]
    if short in MODEL_REGISTRY:
        return MODEL_REGISTRY[short]
    raise KeyError(f"unknown model {name!r}; available: "
                   f"{sorted(MODEL_REGISTRY)}")
