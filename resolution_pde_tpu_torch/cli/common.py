"""Shared driver logic of the command-line entry points.

Counterpart of resolution_pde_tpu/cli/common.py (reference
main_1d.py:33-310, main_2d.py:37-325): dataset factory -> (grouped)
loaders -> model -> AdamW and scheduler -> train and evaluate ->
checkpoint -> super-resolution sweep -> rollout -> tables.

Checkpoints are the port's own format (``train/checkpoint.py``); the
periodic ones are saved asynchronously, the run's last one blocks, as in
the JAX package. The JAX package's ``sample_input`` has no counterpart: a torch
model holds its parameters from construction, so ``Trainer.init`` takes
no sample batch.
"""

from __future__ import annotations

import inspect
import os

import numpy as np
import torch

from resolution_pde_tpu_torch.configs import (
    Config,
    dataset_factory,
    instantiate_dataset,
    instantiate_model,
)
from resolution_pde_tpu_torch.data.dataset import (MinMaxNormalizer,
                                                   MultiResDataset)
from resolution_pde_tpu_torch.data.loader import (Loader,
                                                  ResolutionBucketedLoader)
from resolution_pde_tpu_torch.train import Trainer
from resolution_pde_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                       save_checkpoint)
from resolution_pde_tpu_torch.train.schedules import (ReduceLROnPlateau,
                                                      get_schedule)


def unpack_data(data, normalization_type: str) -> dict:
    """The factory tuple as a dict (main_1d.py:70-83): train, val, test,
    rollout and the normalizers. A 7-tuple has no rollout slot
    (ks_pino_markov_dataset): its slots 3:7 are the minmax stats."""
    if len(data) == 7:
        train, val, test = data[:3]
        out = {"train": train, "val": val, "test": test, "rollout": None}
        stats = data[3:7]
        normalization_type = "minmax"
    else:
        train, val, test, rollout = data[:4]
        out = {"train": train, "val": val, "test": test, "rollout": rollout}
        stats = data[4:8]
    if normalization_type == "minmax":
        out.update(dict(zip(
            ("min_data", "max_data", "min_model", "max_model"), stats)))
        if out["min_data"] is None:
            # data_normalizer=false: no stats were fit
            out["x_normalizer"] = out["y_normalizer"] = None
            return out
        # minmax eval decodes with x*(max-min)+min (train/training.py:90-91)
        out["x_normalizer"] = MinMaxNormalizer(out["min_data"],
                                               out["max_data"])
        out["y_normalizer"] = MinMaxNormalizer(out["min_model"],
                                               out["max_model"])
    else:
        xn, yn = data[4:6]
        if isinstance(xn, (int, float)):
            raise ValueError(
                "factory returned minmax stats (scalars) where normalizer "
                "objects were expected, but the config declares "
                f"normalization_type={normalization_type!r}: set "
                "normalization_type: minmax in the dataset yaml")
        out["x_normalizer"], out["y_normalizer"] = xn, yn
    return out


def build_loaders(bundle, batch_size: int, train_mres: bool, seed: int = 0):
    if train_mres or isinstance(bundle["train"], MultiResDataset):
        return (
            ResolutionBucketedLoader(bundle["train"], batch_size,
                                     shuffle=True, seed=seed),
            ResolutionBucketedLoader(bundle["val"], batch_size,
                                     shuffle=False),
            ResolutionBucketedLoader(bundle["test"], batch_size,
                                     shuffle=False),
        )
    return (
        Loader(bundle["train"], batch_size, shuffle=True, seed=seed),
        Loader(bundle["val"], batch_size, shuffle=False),
        Loader(bundle["test"], batch_size, shuffle=False),
    )


def build_model(cfg: Config):
    """The config's model, its parameters drawn from ``training.seed``."""
    extra = {}
    if "CNO" in cfg.model.get("_target_", "") and "size" not in cfg.model:
        extra["size"] = cfg.dataset.get("cno_train_size",
                                        cfg.dataset.get("original_res"))
    return instantiate_model(cfg.model, seed=cfg.training.get("seed", 0),
                             **extra)


def build_trainer(cfg: Config, model, y_normalizer, device="cuda",
                  mesh=None) -> Trainer:
    tr = cfg.training
    is_s4 = "s4" in cfg.model.get("_target_", "").lower()
    return Trainer(
        model,
        learning_rate=tr.get("learning_rate", 1e-3),
        weight_decay=tr.get("weight_decay", 1e-4),
        use_normalizer=tr.get("use_normalizer", False),
        y_normalizer=y_normalizer,
        ssm_lr=1e-3 if is_s4 else None,
        seed=tr.get("seed", 0),
        accum_steps=tr.get("accum_steps", 1),
        device=device,
        mesh=mesh,
    )


def build_schedule(cfg: Config):
    tr = cfg.training
    return get_schedule(
        tr.get("scheduler", "cosine"),
        tr.get("learning_rate", 1e-3),
        tr.get("epochs", 100),
        t_max=tr.get("t_max", 100),
        eta_min=tr.get("eta_min", 1e-5),
        step_size=tr.get("step_size", 30),
        gamma=tr.get("gamma", 0.5),
    )


def eval_dataset_params(cfg: Config) -> dict:
    """Parameters that rebuild the test dataset at eval resolutions
    (naive_utils.py:69-93): ``_target_`` swapped to eval_dataset_target,
    eval_filename / eval_saved_folder when given, data_normalizer off. The
    eval_* keys may sit at the dataset's top level or inside
    dataset_params, as the reference nests them."""
    params = dict(cfg.dataset.dataset_params)
    ds = cfg.dataset

    def eval_key(name):
        if name in ds:
            return ds[name]
        return params.pop(name, None)

    target = eval_key("eval_dataset_target")
    if target is not None:
        params["_target_"] = target
    fname = eval_key("eval_filename")
    if fname is not None:
        params["filename"] = fname
    folder = eval_key("eval_saved_folder")
    if folder is not None:
        params["saved_folder"] = folder
    params["data_normalizer"] = False
    if target is not None:
        # the swap goes from a multires factory to a plain one with other
        # parameters; factories take no **kwargs, so keep what it takes
        params = _filter_to_factory_signature(params)
    return params


def _filter_to_factory_signature(params: dict) -> dict:
    """Drop, and name, the keys the ``_target_`` factory does not take."""
    try:
        fn = dataset_factory(params["_target_"])
    except KeyError:
        return params  # instantiate_dataset raises the real error
    accepted = set(inspect.signature(fn).parameters)
    dropped = sorted(k for k in params
                     if k != "_target_" and k not in accepted)
    if dropped:
        print(f"eval dataset swap to {params['_target_']}: dropping "
              f"inapplicable dataset_params {dropped}")
    return {k: v for k, v in params.items()
            if k == "_target_" or k in accepted}


def require_device(device, what: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device={str(device)!r}): CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


def target_spatial_ndim(cfg: Config, test) -> int:
    """1 or 2, from the test targets' layout ((N, C, X) or (N, C, H, W))
    rather than the pde's name; window (S4-family) targets carry no
    channel axis, (N, X) or (N, H, W) (JAX
    cli/frequency_evaluation.py:33-47)."""
    target = str(cfg.dataset.dataset_params.get("_target_", ""))
    if isinstance(test, MultiResDataset):
        test = test.buckets[test.resolutions[0]]
    sample_y = np.asarray(test.y[0])
    ndim = sample_y.ndim - (0 if "window" in target else 1)
    if ndim not in (1, 2):
        raise ValueError(
            f"cannot infer spatial ndim from target sample shape "
            f"{sample_y.shape} (factory {target!r}); pass spatial_ndim "
            "explicitly")
    return ndim


def rollout_window_size(cfg: Config) -> int:
    """The sliding-window rollout's window, for window (S4-family)
    datasets only: Markov configs carry a vestigial top-level
    ``window_size`` that must not reroute their rollout."""
    ds = cfg.dataset
    if "window" not in str(ds.dataset_params.get("_target_", "")):
        return 1
    w = ds.dataset_params.get("window_size", ds.get("window_size", 1))
    return int(w or 1)


def _make_eval_builder(cfg: Config, index: int):
    """builder(res) -> element ``index`` of the eval factory's tuple at
    that resolution (2: the raw test split, 3: rollout trajectories)."""
    base = eval_dataset_params(cfg)
    original_res = cfg.dataset.get("original_res")
    use_resize = cfg.dataset.get("evaluation_type") == "use_resize"

    def builder(res: int):
        params = dict(base)
        if use_resize:
            params["s"] = res
            params["reduced_resolution"] = 1
        else:
            params["reduced_resolution"] = max(original_res // res, 1)
            if "s" in params:
                # naive eval strides; a train-time resize target must not
                # leak into the sweep (naive_utils.py:90-91)
                params["s"] = None
        return instantiate_dataset(params)[index]

    return builder


def make_superres_builder(cfg: Config):
    """dataset_builder(res) -> the raw test ArrayDataset at ``res``."""
    return _make_eval_builder(cfg, 2)


def make_rollout_builder(cfg: Config, primary_rollout=None):
    """builder(res) -> rollout trajectories (N, T, *spatial) at ``res``:
    the training dataset's bucket stored at that resolution when it has
    one (true-multires files), else the eval dataset rebuilt at ``res``
    (autoregressive_step.py:75-116)."""
    fallback = _make_eval_builder(cfg, 3)
    if primary_rollout is None or not hasattr(primary_rollout, "at"):
        return fallback

    def builder(res: int):
        bucket = primary_rollout.at(res)
        if bucket is not None:
            print(f"rollout @ {res}: using trajectories stored at this "
                  "resolution (true-multires per-res files)")
            return bucket
        return fallback(res)

    return builder


def run_checkpoint_path(cfg: Config) -> str:
    model_type = cfg.model.get("_target_", "model").rsplit(".", 1)[-1].lower()
    job_id = os.environ.get("SLURM_JOB_ID", "local")
    return os.path.join(cfg.get("checkpoint_dir", "checkpoints"), model_type,
                        f"{cfg.dataset.get('pde', 'pde')}_{job_id}")


def _scheduler_extra(schedule) -> dict | None:
    if isinstance(schedule, ReduceLROnPlateau):
        return {"scheduler": schedule.state_dict()}
    return None


def save_run_checkpoint(cfg: Config, state, history, schedule=None,
                        block: bool = True) -> str:
    """Save the full resumable state to the run checkpoint path; with
    ``block`` it is on disk on return, else it is written in the
    background (``train.checkpoint.wait_for_checkpoints``)."""
    path = run_checkpoint_path(cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    hist = history if isinstance(history, dict) else {
        "train_loss": history.train_loss,
        "val_loss": history.val_loss,
        "lr": history.lr,
    }
    save_checkpoint(path, state, history=hist,
                    extra=_scheduler_extra(schedule), block=block)
    return path


def periodic_checkpointer(cfg: Config, schedule, prior_hist=None):
    """Epoch callback for Trainer.fit: every training.checkpoint_every
    epochs, save the full resumable state (step, optimizer, dropout
    generator, history, scheduler counters) to the run checkpoint path, so
    a killed run resumes exactly with training.resume_from. None when
    checkpoint_every is unset. The save is asynchronous: the epoch loop
    waits only for the state's copy to host memory.

    prior_hist: a resumed run's restored history, stitched in front of
    fit's (which holds only the resumed epochs), so a second resume counts
    every epoch done."""
    every = int(cfg.training.get("checkpoint_every", 0) or 0)
    if every <= 0:
        return None
    prior = {k: [float(v) for v in (prior_hist or {}).get(k, [])]
             for k in ("train_loss", "val_loss", "lr")}

    def callback(epoch, state, history):
        if (epoch + 1) % every == 0:
            stitched = {k: prior[k] + [float(v) for v in getattr(history, k)]
                        for k in prior}
            save_run_checkpoint(cfg, state, stitched, schedule,
                                block=False)

    return callback


def maybe_resume(cfg: Config, state, schedule, train_loader=None):
    """training.resume_from=<checkpoint dir>: restore the parameters,
    optimizer, step, dropout generator, prior history and scheduler
    counters, offset a stateless epoch schedule so the LR curve continues,
    and fast-forward the train loader's shuffle (set_epoch).

    Returns (state, prior_history_dict_or_None, epochs_done, schedule)."""
    ckpt = cfg.training.get("resume_from")
    if not ckpt:
        return state, None, 0, schedule
    state, history, extra = restore_checkpoint(ckpt, state, with_extra=True)
    done = (len(history["train_loss"])
            if history and "train_loss" in history else 0)
    if isinstance(schedule, ReduceLROnPlateau):
        if extra and "scheduler" in extra:
            schedule.load_state_dict(dict(extra["scheduler"]))
        elif done:
            print("WARNING: checkpoint carries no scheduler state; "
                  "ReduceLROnPlateau restarts from base_lr")
    elif schedule is not None and done:
        base = schedule
        schedule = lambda e, _b=base: _b(e + done)  # noqa: E731
    if done and train_loader is not None and hasattr(train_loader,
                                                     "set_epoch"):
        train_loader.set_epoch(done)
    print(f"Resumed from {ckpt}: {done} epochs done, step {int(state.step)}")
    return state, history, done, schedule


def maybe_warm_start(cfg: Config, trainer, state):
    """dataset.saved_checkpoint_path=<checkpoint dir>: start from that
    checkpoint's state (main_1d.py:127-132)."""
    ckpt = cfg.dataset.get("saved_checkpoint_path")
    if not ckpt:
        return state
    state, _ = restore_checkpoint(ckpt, state)
    print(f"Loaded model checkpoint: {ckpt}")
    return state


def rollout_resize_to_train(cfg: Config) -> bool:
    """The per-step resize round trip of the rollout, for fixed-size (CNO)
    models only; resolution-flexible models keep the reference's naive
    feedback (autoregressive_step.py:101)."""
    return "CNO" in cfg.model.get("_target_", "") and resize_trained(cfg)


def resize_trained(cfg: Config) -> bool:
    """True when the model trained at a fixed resize target: the dataset
    declares use_resize eval (resize_to_train), or the training loop
    resized batches (training.cno_resize_training)."""
    return bool(cfg.dataset.get("resize_to_train")
                or cfg.training.get("cno_resize_training"))


def eval_train_res(cfg: Config) -> int:
    """The resolution the model trained at: cno_train_size under resize
    training (resize_utils.py:216-233), else the dataset's original
    resolution."""
    ds = cfg.dataset
    if resize_trained(cfg) and ds.get("cno_train_size"):
        return ds["cno_train_size"]
    return ds.get("original_res")
