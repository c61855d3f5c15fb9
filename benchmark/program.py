"""The system under test, resolution_pde_tpu_torch, as the benchmark drives
it: a model from a configuration with the benchmark's weights loaded, the
Trainer, the ServingEngine. With ``faults.py``, which patches it for the
checks that faults are caught, the only module of the benchmark that
imports the program.
"""

from __future__ import annotations

import torch

from resolution_pde_tpu_torch.deploy import ServingEngine
from resolution_pde_tpu_torch.models.registry import get_model
from resolution_pde_tpu_torch.train import Trainer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model(cfg: dict, route: str, weights: dict, device) -> torch.nn.Module:
    """The configuration's model on its ``route`` ("train" or "serve"),
    built without drawing parameters (on the meta device) and then given
    ``weights`` by name: a name missing on either side raises."""
    prog = cfg["program"]
    kwargs = dict(prog["kwargs"], **prog.get("routes", {}).get(route, {}))
    for key, value in list(kwargs.items()):
        if key.endswith("dtype") and value is not None:
            kwargs[key] = _DTYPES[value]
    with torch.device("meta"):
        m = get_model(prog["model"])(**kwargs)
    m = m.to_empty(device=device)
    m.load_state_dict(weights, strict=True)
    return m


def trainer(cfg: dict, m: torch.nn.Module, seed: int, device) -> tuple:
    """A Trainer over ``m`` with the configuration's optimizer, and its
    state: (trainer, state)."""
    opt = cfg["optimizer"]
    tr = Trainer(m, learning_rate=opt["learning_rate"],
                 weight_decay=opt["weight_decay"], ssm_lr=opt.get("ssm_lr"),
                 seed=int(seed), device=device)
    return tr, tr.init()


def engine(m: torch.nn.Module, traffic: dict, device) -> ServingEngine:
    """A ServingEngine over ``m`` with the traffic's one bucket warmed (on
    the card, captured as a CUDA graph); a request outside it raises."""
    eng = ServingEngine(m, strict_buckets=True, device=device)
    eng.compile_bucket(tuple(traffic["grid"]), traffic["rows"],
                       in_channels=traffic["channels"])
    return eng


def first_moments(state) -> dict:
    """{parameter name: AdamW's first moment}, copied, from a Trainer state:
    after one step it is (1 - beta1) times the gradient the optimizer got."""
    opt = state.optimizer
    return {name: opt.state[p]["exp_avg"].detach().clone()
            for name, p in state.model.named_parameters()
            if p in opt.state}


def parameters(state) -> dict:
    """{parameter name: value}, copied."""
    return {name: p.detach().clone()
            for name, p in state.model.named_parameters()}
