"""Config composition: model x dataset x training, with hydra-style
overrides.

Counterpart of resolution_pde_tpu/configs/__init__.py (reference
conf/config.yaml:1-5, main_1d.py:68, 113-115). The yaml files are the JAX
package's, ``resolution_pde_tpu/configs/{model,dataset,training}``, read
by path as data: this module imports nothing of that package. Overrides
such as ``model=ffno_2d dataset=ns_naive training.epochs=50`` pick group
files and set dotted keys.

``instantiate_model`` builds the port's model from ``models.registry``;
``instantiate_dataset`` calls the port's dataset factories, which so far
are the Navier-Stokes, Kuramoto-Sivashinsky, Burgers, Darcy,
active-matter and point-cloud (GNOT) ones.
"""

from __future__ import annotations

import inspect
import logging
import os
from typing import Any, Dict, List, Optional

import torch
import yaml

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONF_DIR = os.path.join(_REPO, "resolution_pde_tpu", "configs")


class Config(dict):
    """dict with attribute access, nested."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj


def _load_group(group: str, name: str) -> dict:
    """Load e.g. group='model', name='ffno_1d/ffno_1d' (the reference's
    subdirectory form) or 'ffno_1d'."""
    for candidate in (name, name.split("/")[-1]):
        path = os.path.join(CONF_DIR, group, candidate + ".yaml")
        if os.path.exists(path):
            with open(path) as f:
                return yaml.safe_load(f) or {}
    raise FileNotFoundError(
        f"no config {name!r} in group {group!r} "
        f"(looked in {os.path.join(CONF_DIR, group)})")


def _set_dotted(cfg: dict, dotted: str, value):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = _parse_value(value)


def _parse_value(v):
    if not isinstance(v, str):
        return v
    parsed = yaml.safe_load(v)
    # YAML 1.1 reads "1e-3" as a string (its floats need "1.0e-3");
    # recover the number a CLI user means
    if isinstance(parsed, str):
        for cast in (int, float):
            try:
                return cast(parsed)
            except ValueError:
                pass
    return parsed


def load_config(model: str = "fno_1d", dataset: str = "burger_naive",
                training: str = "default",
                overrides: Optional[List[str]] = None) -> Config:
    """Compose the three groups plus dotted-path overrides."""
    cfg: Dict[str, Any] = {
        "model": _load_group("model", model),
        "dataset": _load_group("dataset", dataset),
        "training": _load_group("training", training),
    }
    cfg["model_name"] = model
    cfg["dataset_name"] = dataset
    cfg["project_name"] = f"{cfg['dataset'].get('pde', dataset)}_{model}"
    cfg["checkpoint_dir"] = "checkpoints"
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, value = ov.split("=", 1)
        _set_dotted(cfg, key, value)
    return Config.wrap(cfg)


def parse_cli(argv: List[str]) -> Config:
    """Hydra-style CLI: key=value tokens; ``model=``, ``dataset=`` and
    ``training=`` pick group files, any other key is a dotted override."""
    groups = {"model": "fno_1d", "dataset": "burger_naive",
              "training": "default"}
    overrides = []
    for tok in argv:
        if "=" not in tok:
            raise ValueError(f"argument {tok!r} is not key=value")
        key, value = tok.split("=", 1)
        if key in groups:
            groups[key] = value
        else:
            overrides.append(tok)
    return load_config(groups["model"], groups["dataset"],
                       groups["training"], overrides)


def _torch_dtype(value):
    """A config's compute_dtype ('bfloat16', a torch dtype, or None)."""
    if value is None or isinstance(value, torch.dtype):
        return value
    dtype = getattr(torch, str(value), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute_dtype {value!r}")
    return dtype


def model_kwargs(model_cfg: dict, **extra) -> tuple:
    """(model class, constructor kwargs) of a config with ``_target_``:
    the keys the class's ``__init__`` takes (as the JAX package keeps the
    flax dataclass's fields), ``compute_dtype`` as a torch dtype."""
    from resolution_pde_tpu_torch.models.registry import get_model

    cfg = dict(model_cfg)
    target = cfg.pop("_target_")
    cfg.update(extra)
    cls = get_model(target)
    valid = set(inspect.signature(cls.__init__).parameters) - {"self"}
    kwargs = {k: v for k, v in cfg.items() if k in valid}
    dropped = set(cfg) - set(kwargs)
    if dropped:
        logging.getLogger(__name__).debug(
            "dropping config keys not accepted by %s: %s", target, dropped)
    if "compute_dtype" in kwargs:
        kwargs["compute_dtype"] = _torch_dtype(kwargs["compute_dtype"])
    return cls, kwargs


def instantiate_model(model_cfg: dict, seed: int = 0, **extra):
    """Build the port's model from a config with ``_target_``; its
    parameters are drawn from a torch.Generator seeded with ``seed``."""
    cls, kwargs = model_kwargs(model_cfg, **extra)
    kwargs.setdefault("generator", torch.Generator().manual_seed(int(seed)))
    return cls(**kwargs)


def _dataset_factories() -> dict:
    from resolution_pde_tpu_torch.data import factories as f

    names = ("ns_markov_dataset", "ns_true_multires_markov_dataset",
             "ks_window_dataset", "ks_markov_dataset",
             "ks_true_multires_markov_dataset", "ks_multires_markov_dataset",
             "ks_resize_multires_markov_dataset", "ks_pino_markov_dataset",
             "burger_markov_dataset", "burger_true_multires_markov_dataset",
             "burger_multires_markov_dataset",
             "burger_resize_multires_markov_dataset",
             "burger_resize_true_multires_markov_dataset",
             "burger_window_dataset", "load_burger_data_from_mat",
             "darcy_dataset", "load_darcy_data_from_mat", "load_darcy_data",
             "active_matter_markov_dataset",
             "active_matter_all_markov_dataset",
             "multi_file_active_matter_markov_dataset",
             "point_cloud_markov_dataset")
    return {name: getattr(f, name) for name in names}


# the JAX package's factories that the port has not yet, by the ROADMAP
# item (section 1) that ports them
NOT_PORTED = {
    "ns_window_dataset": 5,
}

# the reference's dotted paths (conf/dataset/*/*.yaml `_target_`) -> the
# factory names (resolution_pde_tpu/configs/__init__.py:157-242)
ALIASES = {
    "dataloaders.ks_naive_markov.ks_markov_dataset": "ks_markov_dataset",
    "dataloaders.ks_resize_markov.ks_markov_dataset": "ks_markov_dataset",
    "dataloaders.ks_naive_true_multires.ks_true_multires_markov_dataset":
        "ks_true_multires_markov_dataset",
    "dataloaders.burger_naive_markov.burger_markov_dataset":
        "burger_markov_dataset",
    "dataloaders.burger_resize_markov.burger_markov_dataset":
        "burger_markov_dataset",
    "dataloaders.burger_naive_true_multires."
    "burger_true_multires_markov_dataset":
        "burger_true_multires_markov_dataset",
    "dataloaders.ns_naive_markov.ns_markov_dataset": "ns_markov_dataset",
    "dataloaders.ns_naive_old_markov.ns_markov_dataset": "ns_markov_dataset",
    "dataloaders.ns_resize_old_markov.ns_markov_dataset":
        "ns_markov_dataset",
    "dataloaders.ns_naive_true_multires.ns_true_multires_markov_dataset":
        "ns_true_multires_markov_dataset",
    "dataloaders.darcy_loader.get_darcy_dataset": "darcy_dataset",
    "dataloaders.burger_s4.burger_window_dataset": "burger_window_dataset",
    "dataloaders.ns_s4.ns_window_dataset": "ns_window_dataset",
    "dataloaders.active_matter_markov.active_matter_markov_dataset":
        "active_matter_markov_dataset",
    "dataloaders.load_data.load_burger_data_from_mat":
        "load_burger_data_from_mat",
    "dataloaders.load_data.load_darcy_data_from_mat":
        "load_darcy_data_from_mat",
    "dataloaders.load_data.load_darcy_data": "load_darcy_data",
    "dataloaders.ks_pino_resize_markov.ks_pino_markov_dataset":
        "ks_pino_markov_dataset",
    "dataloaders.active_matter_all_markov.active_matter_all_markov_dataset":
        "active_matter_all_markov_dataset",
    "dataloaders.active_matter_all_markov."
    "multi_file_active_matter_markov_dataset":
        "multi_file_active_matter_markov_dataset",
    "dataloaders.ks_naive_multires.ks_multires_markov_dataset":
        "ks_multires_markov_dataset",
    "dataloaders.ks_resize_multires.ks_multires_markov_dataset":
        "ks_resize_multires_markov_dataset",
    "dataloaders.burger_naive_multires.burger_multires_markov_dataset":
        "burger_multires_markov_dataset",
    "dataloaders.burger_resize_multires.burger_multires_markov_dataset":
        "burger_resize_multires_markov_dataset",
    "dataloaders.burger_resize_true_multires."
    "burger_true_multires_markov_dataset":
        "burger_resize_true_multires_markov_dataset",
    "dataloaders.cno_burger_markov.burger_markov_dataset":
        "burger_markov_dataset",
    "dataloaders.ks_pino_markov.ks_pino_markov_dataset":
        "ks_pino_markov_dataset",
    "dataloaders.burger_markov.burger_markov_dataset":
        "burger_markov_dataset",
    "dataloaders.dgl_data.FNODataset": "point_cloud_markov_dataset",
}


def dataset_factory(target: str):
    """The factory a ``_target_`` names: a factory name, a reference
    dotted path, or a dotted path ending in a factory name. A factory the
    port has not yet raises a KeyError naming its ROADMAP item."""
    factories = _dataset_factories()
    name = ALIASES.get(target, target)
    if name not in factories and name not in NOT_PORTED:
        name = name.rsplit(".", 1)[-1]
    if name in factories:
        return factories[name]
    if name in NOT_PORTED:
        raise KeyError(
            f"dataset factory {target!r} is not ported to "
            f"resolution_pde_tpu_torch yet: ROADMAP.md section 1, item "
            f"{NOT_PORTED[name]}")
    raise KeyError(f"unknown dataset factory {target!r}; known: "
                   f"{sorted(factories)}")


def instantiate_dataset(dataset_params: dict, **overrides):
    """Call the dataset factory named by ``_target_`` with the config's
    kwargs."""
    cfg = dict(dataset_params)
    target = cfg.pop("_target_")
    cfg.update(overrides)
    return dataset_factory(target)(**cfg)
