"""Import of HF-named SwinV2 / ScOT (Poseidon) state dicts.

Counterpart of the HF part of resolution_pde_tpu/utils/torch_import.py
(its lines 173-262): scOT's transformer blocks are ``transformers``'
SwinV2 blocks, so a Poseidon checkpoint names each encoder block as
``transformers.models.swinv2`` does. These functions map those names onto
the port's ``models.poseidon`` modules; the weights keep torch's (out, in)
layout, so nothing is transposed. The rest of the JAX module maps port
state dicts into flax parameters for its tests and has no counterpart
here. Loading ``camlab-ethz/Poseidon-B`` itself needs a download
(``models.poseidon.load_pretrained_poseidon``).
"""

from __future__ import annotations

import numpy as np
import torch

# HF Swinv2Layer module -> the port's Swinv2Block module, and whether a
# bias goes with the weight
_BLOCK = (
    ("attention.self.query", "attention.query", True),
    ("attention.self.key", "attention.key", False),
    ("attention.self.value", "attention.value", True),
    ("attention.self.continuous_position_bias_mlp.0", "attention.cpb_mlp0",
     True),
    ("attention.self.continuous_position_bias_mlp.2", "attention.cpb_mlp1",
     False),
    ("attention.output.dense", "attention.proj", True),
    ("layernorm_before", "layernorm_before.norm", True),
    ("layernorm_after", "layernorm_after.norm", True),
    ("intermediate.dense", "intermediate", True),
    ("output.dense", "output", True),
)


def _tensor(v) -> torch.Tensor:
    """A float32 tensor of its own from a tensor or an array."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32, copy=True)
    return torch.as_tensor(np.array(v, dtype=np.float32))


class _Reader:
    """Reads keys of an HF state dict, noting the missing ones."""

    def __init__(self, sd: dict):
        self.sd, self.missing = sd, []

    def __call__(self, key: str):
        if key not in self.sd:
            self.missing.append(key)
            return None
        return _tensor(self.sd[key])

    def check(self) -> None:
        if self.missing:
            raise KeyError(f"{len(self.missing)} key(s) missing from the "
                           f"state dict: {self.missing}")


def _block(read: _Reader, prefix: str, out: str) -> dict:
    sd = {}
    for hf, port, bias in _BLOCK:
        sd[f"{out}{port}.weight"] = read(f"{prefix}.{hf}.weight")
        if bias:
            sd[f"{out}{port}.bias"] = read(f"{prefix}.{hf}.bias")
    sd[f"{out}attention.logit_scale"] = read(
        f"{prefix}.attention.self.logit_scale")
    return sd


def swinv2_block_params_from_sd(sd: dict, prefix: str) -> dict:
    """One HF ``Swinv2Layer`` of a state dict (``{prefix}.attention.self.
    query.weight``, ... ``continuous_position_bias_mlp.{0,2}``,
    ``logit_scale``, ``layernorm_before/after``, ``intermediate.dense``,
    ``output.dense``) as a state dict of the port's ``Swinv2Block``
    (``use_conditioning=False``). A missing key raises a KeyError listing
    every missing one."""
    read = _Reader(sd)
    out = _block(read, prefix, "")
    read.check()
    return out


def import_scot_encoder(sd: dict, depths, base: str = "swinv2") -> dict:
    """An HF ``Swinv2Model``-style encoder (patch embedding, its norm,
    stages of blocks, the patch-merging downsamples) as a partial state
    dict of the port's ``ScOT2d``: ``patch_embed``, ``patch_norm``,
    ``encoder.{i}.{j}`` and ``merge.{i}`` (where the stage has a
    downsample). A Poseidon checkpoint carries more (decoder, conditioning,
    heads); a missing key raises a KeyError listing every missing one."""
    read = _Reader(sd)
    emb = f"{base}.embeddings"
    out = {"patch_embed.weight": read(f"{emb}.patch_embeddings.projection"
                                      ".weight"),
           "patch_embed.bias": read(f"{emb}.patch_embeddings.projection"
                                    ".bias"),
           "patch_norm.weight": read(f"{emb}.norm.weight"),
           "patch_norm.bias": read(f"{emb}.norm.bias")}
    for i, depth in enumerate(depths):
        layer = f"{base}.encoder.layers.{i}"
        for j in range(depth):
            out.update(_block(read, f"{layer}.blocks.{j}",
                              f"encoder.{i}.{j}."))
        if f"{layer}.downsample.reduction.weight" in sd:
            out[f"merge.{i}.reduction.weight"] = read(
                f"{layer}.downsample.reduction.weight")
            out[f"merge.{i}.norm.weight"] = read(
                f"{layer}.downsample.norm.weight")
            out[f"merge.{i}.norm.bias"] = read(
                f"{layer}.downsample.norm.bias")
    read.check()
    return out
