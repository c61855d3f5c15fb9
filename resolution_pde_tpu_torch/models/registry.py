"""Model registry: short names and the reference's ``_target_`` dotted
paths to the port's modules.

Counterpart of resolution_pde_tpu/models/registry.py: every model of the
JAX registry, under the same short names and dotted paths, and
``register`` to add one (a decorator or a direct call). A model of the JAX
registry that is not ported raises a KeyError naming the ROADMAP item
(section 1) that ports it (``NOT_PORTED``, empty since item 5).
"""

from __future__ import annotations

from resolution_pde_tpu_torch.models.cno import CNO1d, CNO2d
from resolution_pde_tpu_torch.models.cno_original import CNO2dOriginal
from resolution_pde_tpu_torch.models.ffno import FFNO1D, FFNO2D
from resolution_pde_tpu_torch.models.fno import FNO1d, FNO2d
from resolution_pde_tpu_torch.models.mgpt import GNOTOperator, MoEGPTNO
from resolution_pde_tpu_torch.models.poseidon import ScOT2d, SwinOperator2d
from resolution_pde_tpu_torch.models.s4 import S4D, S4Block, S4Model, S4NDModel
from resolution_pde_tpu_torch.models.s4_base import (ChainModel, OneToSeqModel,
                                                     S4BaseModel,
                                                     S4BaseSeqModel,
                                                     S4DualSeqModel,
                                                     S4SeqModel, SeqAdd)
from resolution_pde_tpu_torch.models.unet import UNet1d, UNet2d

MODEL_REGISTRY = {
    "FNO1d": FNO1d,
    "models.fno.FNO1d": FNO1d,
    "FNO2d": FNO2d,
    "models.fno.FNO2d": FNO2d,
    "FFNO1D": FFNO1D,
    "models.ffno.FFNO1D": FFNO1D,
    "FFNO2D": FFNO2D,
    "models.ffno.FFNO2D": FFNO2D,
    "S4Model": S4Model,
    "models.s4_1d.S4Model": S4Model,
    "S4Block": S4Block,
    "S4D": S4D,
    "models.s4d.S4D": S4D,
    "S4NDModel": S4NDModel,
    "models.s4_2d.S4NDModel": S4NDModel,
    "S4BaseModel": S4BaseModel,
    "models.s4_model.S4BaseModel": S4BaseModel,
    "S4SeqModel": S4SeqModel,
    "models.s4seq_model.S4SeqModel": S4SeqModel,
    "OneToSeqModel": OneToSeqModel,
    "models.s4seq_model.OneToSeqModel": OneToSeqModel,
    "S4BaseSeqModel": S4BaseSeqModel,
    "models.s4seq_model.S4BaseSeqModel": S4BaseSeqModel,
    "S4DualSeqModel": S4DualSeqModel,
    "models.s4seq_model.S4DualSeqModel": S4DualSeqModel,
    "SeqAdd": SeqAdd,
    "models.s4seq_model.SeqAdd": SeqAdd,
    "ChainModel": ChainModel,
    "models.s4seq_model.ChainModel": ChainModel,
    "UNet1d": UNet1d,
    "models.unet.UNet1d": UNet1d,
    "UNet2d": UNet2d,
    "models.unet.UNet2d": UNet2d,
    "CNO1d": CNO1d,
    "models.CNO1d.CNO1d": CNO1d,
    "CNO2d": CNO2d,
    "models.CNO2d.CNO2d": CNO2d,
    "CNO2dOriginal": CNO2dOriginal,
    # the reference's cno_2d_original.yaml target
    "CNO.CNO2d_original_version.CNOModule.CNO": CNO2dOriginal,
    "MoEGPTNO": MoEGPTNO,
    "models.mgpt.MoEGPTNO": MoEGPTNO,
    "GNOTOperator": GNOTOperator,
    "SwinOperator2d": SwinOperator2d,
    # 'pos' is the hierarchical ScOT (conf/model/pos)
    "ScOT2d": ScOT2d,
    "pos": ScOT2d,
    "scOT.model.ScOT": ScOT2d,
}


def unwrap_output(pred):
    """A model's prediction as a tensor: models that return
    {'output': tensor} are unwrapped, others pass through."""
    return pred["output"] if isinstance(pred, dict) else pred


# the JAX registry's models not ported yet (short names), by the ROADMAP
# item (section 1) that ports them: none since item 5
NOT_PORTED: dict = {}


def register(name: str, cls=None):
    """Register a model class under ``name``: ``register(name, cls)``, or
    ``@register(name)`` on the class. Returns the class."""

    def wrap(c):
        MODEL_REGISTRY[name] = c
        return c

    return wrap(cls) if cls is not None else wrap


def get_model(name: str):
    """Look up by short name or reference ``_target_`` dotted path."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    short = name.rsplit(".", 1)[-1]
    if short in MODEL_REGISTRY:
        return MODEL_REGISTRY[short]
    if short in NOT_PORTED:
        raise KeyError(
            f"model {name!r} is not ported to resolution_pde_tpu_torch yet: "
            f"ROADMAP.md section 1, item {NOT_PORTED[short]}")
    raise KeyError(f"unknown model {name!r}; available: "
                   f"{sorted(MODEL_REGISTRY)}")
