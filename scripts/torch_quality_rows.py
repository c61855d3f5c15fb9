#!/usr/bin/env python3
"""One quality row of the baseline family, reproduced by the PyTorch port
from data it generates itself.

    python3 scripts/torch_quality_rows.py leg=<name> [out=build/quality_rows]

Legs (the JAX package's rows are in runs/sweeps/baseline_1787270482, for
ffno2d_ns and cno2d_ns_resize in runs/sweeps/ns_models_1787155138, for
fno2d_darcy in runs/sweeps/darcy_1787187199; cno2d_original_ns's, 0.0153,
and the baseline's cno2d_ns_resize, test 0.0270, are in RESULTS.md's
prose, :899 and :909-913):
  fno1d_burger_naive   baseline family: fno_1d.yaml on burger_naive.yaml
  ffno1d_ks_true_mres  baseline family: ffno_1d.yaml on
                       ks_naive_true_mres1.yaml
  s4_ks_window         baseline family: s4_1d.yaml on ks_s4.yaml
  ffno2d_ns            ns_models family: ffno_2d.yaml on ns_naive.yaml,
                       trained at 128² (the 256² file strided by 2)
  ffno2d_ns_true_mres  baseline family: ffno_2d.yaml on
                       ns_naive_true_mres1.yaml, trained at 256²
  fno2d_darcy          darcy family: fno_2d.yaml on darcy.yaml
  ffno2d_darcy         darcy family: ffno_2d.yaml on darcy.yaml (the JAX
                       run of this leg has no row)
  cno2d_ns_resize      ns_models family: cno_2d.yaml on ns_naive.yaml,
                       resize training at 128² (the 256² file strided by
                       2), use_resize evaluation
  cno2d_original_ns    ns_models family: cno_2d_original.yaml on
                       ns_naive.yaml at 128², use_resize evaluation
  cno2d_ns_resize_256  baseline family's cno2d_ns_resize: cno_2d.yaml on
                       ns_naive.yaml with resize training at 256²; its
                       table row is named after this leg, so that a merge
                       keeps it beside the ns_models row of the same name
  pos_ns               ns_models family: pos.yaml (ScOT) at the family's
                       demo widths on ns_naive.yaml, trained at 128²
  gnot_ns_demo         scripts/integration_demo_gnot.py's steps (its JAX
                       row, test rel-L2 0.029, is in RESULTS.md:602-609):
                       mgpt.yaml (GNOTOperator, n_hidden 64, 2 layers) on
                       ns_gnot.yaml's point clouds of NS at 32² (1,024
                       nodes), the Trainer at lr 1e-3 (constant) for 15
                       epochs of batch 8, then the test split's rel-L2;
                       seed=<k> draws the model's weights, the dropout
                       and the batches' order from training seed k (0
                       by default; the data stay the demo's), its row
                       named gnot_ns_demo_seed<k>

The data are scripts/gen_baseline_data.sh's settings, and for Darcy
cli/sweep.py's, generated by the port on the device (``device``, the card
unless "cpu"):
  KS: n 512, resolutions [512, 256, 128, 64, 32], 51 snapshots,
      viscosity 0.075, seed 11 (cli.generate_data.generate_ks_arrays);
  Burgers: n 512, resolution 1024, 51 snapshots, viscosity 0.001, seed
      12 (generate_burgers_arrays);
  NS: n 128, resolution 256, 26 snapshots, viscosity 1e-03, seed 13
      (generate_ns_arrays), written as data/ns/ns_256_1e-03.mat (scipy:
      the card's machine has no h5py);
  Darcy: n 256, resolution 128, beta 0.01, seed 0 (generate_darcy_arrays;
      the CG iterations and largest residual of each batch are printed);
  GNOT: the demo's NS, n 24 at 32², viscosity 1e-3, T 1.0, dt 5e-4, 10
      recorded steps, seed 0 (datagen.generate_ns_dataset), held in memory
      under ns_gnot.yaml's file name (data.io.files_in_memory).
The NS data are solved a second time without the CUDA graph (timed; the
two must be equal bit for bit). The KS, Burgers and Darcy factories read
HDF5 files, so those legs read the arrays held in memory under the paths
generate_data would write (cli.generate_data.ks_in_memory,
burgers_in_memory, darcy_in_memory). Then the leg runs through cli.sweep
(``family=<its family> only=<leg> training.epochs=20 training.t_max=20``,
the epochs of the JAX rows) in a temporary working directory holding
data/ (the yaml files' relative data folders) and the sweep's runs/ and
checkpoints/; the NS legs' overrides name the .mat file. The yaml files
run as shipped otherwise. Prints the card's name and power limit, the
data's seconds, every epoch's losses, the sweep's table row (test,
super-resolution and rollout rel-L2 at every resolution, train seconds)
and, last, the row as JSON; copies sweep.csv and sweep.md to
``out``/quality_<leg>/.

Smaller runs, for a rehearsal on the CPU: ``n=``, ``res=`` (NS, Darcy,
GNOT), ``epochs=`` and any other ``key=value`` (passed to every leg as a
config override; to the GNOT leg's model) change the run and stamp its
table rehearsal=true.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

KS = dict(n=512, resolutions=[512, 256, 128, 64, 32], n_snapshots=51,
          viscosity=0.075, seed=11)
BURGERS = dict(n=512, resolutions=[1024], n_snapshots=51, viscosity=0.001,
               seed=12)
NS = dict(n=128, res=256, n_snapshots=26, viscosity="1e-03", seed=13)
DARCY = dict(n=256, res=128, seed=0)
# scripts/integration_demo_gnot.py's data and training
GNOT = dict(n=24, res=32, record_steps=10, viscosity=1e-3, T=1.0,
            delta_t=5e-4, seed=0, epochs=15, batch_size=8,
            learning_rate=1e-3, n_hidden=64, n_layers=2)
# leg -> (family, pde)
LEGS = {"fno1d_burger_naive": ("baseline", "burgers"),
        "ffno1d_ks_true_mres": ("baseline", "ks"),
        "s4_ks_window": ("baseline", "ks"),
        "ffno2d_ns": ("ns_models", "ns"),
        "ffno2d_ns_true_mres": ("baseline", "ns"),
        "fno2d_darcy": ("darcy", "darcy"),
        "ffno2d_darcy": ("darcy", "darcy"),
        "cno2d_ns_resize": ("ns_models", "ns"),
        "cno2d_original_ns": ("ns_models", "ns"),
        "cno2d_ns_resize_256": ("baseline", "ns"),
        "pos_ns": ("ns_models", "ns"),
        "gnot_ns_demo": ("gnot", "gnot")}
# the family's name of a leg named otherwise here
SWEEP_LEG = {"cno2d_ns_resize_256": "cno2d_ns_resize"}
# the NS legs that read the true multi-resolution files
NS_TRUE_MRES = ("ffno2d_ns_true_mres",)
EPOCHS = 20


def card() -> str:
    """nvidia-smi's name and power limit of the card, or 'cpu'."""
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def parse(argv) -> dict:
    opts = {"leg": None, "out": "build/quality_rows", "device": "cuda",
            "n": None, "res": None, "epochs": None, "seed": 0,
            "extras": []}
    for a in argv:
        k, sep, v = a.partition("=")
        if not sep:
            raise SystemExit(f"expected key=value, got {a!r}")
        if k in ("leg", "out", "device"):
            opts[k] = v
        elif k in ("n", "res", "epochs", "seed"):
            opts[k] = int(v)
        else:
            opts["extras"].append(a)
    if opts["leg"] not in LEGS:
        raise SystemExit(f"leg= one of {sorted(LEGS)}")
    if opts["seed"] and opts["leg"] != "gnot_ns_demo":
        raise SystemExit("seed= is the GNOT leg's; a sweep leg takes "
                         "training.seed=")
    default = GNOT["epochs"] if opts["leg"] == "gnot_ns_demo" else EPOCHS
    opts["rehearsal"] = bool(opts["n"] or opts["res"] or opts["extras"]
                             or opts["epochs"] not in (None, default))
    opts["epochs"] = opts["epochs"] or default
    return opts


def generate(pde: str, opts: dict, data_dir: str) -> tuple:
    """The leg's data on the device: (a context to run the leg in, the
    sweep overrides naming the data, a description, seconds)."""
    from resolution_pde_tpu_torch.cli import generate_data as gd

    if opts["device"] == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if pde == "ks":
        ks = dict(KS, n=opts["n"] or KS["n"])
        arrays = gd.generate_ks_arrays(
            ks["n"], ks["resolutions"], ks["n_snapshots"], ks["seed"],
            viscosity=ks["viscosity"], device=opts["device"])
        seconds = time.perf_counter() - t0
        # the yaml files' saved_folder is data/ks, relative to the sweep's
        # working directory
        context = gd.ks_in_memory(os.path.join(data_dir, "ks"), arrays,
                                  ks["n_snapshots"])
        return context, [], f"KS {ks} split {arrays['split_counts']}", \
            seconds
    if pde == "burgers":
        bu = dict(BURGERS, n=opts["n"] or BURGERS["n"])
        arrays = gd.generate_burgers_arrays(
            bu["n"], bu["resolutions"], bu["n_snapshots"], bu["seed"],
            viscosity=bu["viscosity"], device=opts["device"])
        seconds = time.perf_counter() - t0
        u = arrays["by_res"][max(bu["resolutions"])]
        if not bool(np.isfinite(u).all()):
            raise RuntimeError("generated Burgers: non-finite")
        # burger_naive.yaml's saved_folder is data/burgers
        return gd.burgers_in_memory(os.path.join(data_dir, "burgers"),
                                    arrays), [], \
            f"Burgers {bu} max|u| {float(abs(u).max()):.3f}", seconds
    if pde == "darcy":
        da = dict(DARCY, n=opts["n"] or DARCY["n"],
                  res=opts["res"] or DARCY["res"])
        arrays = gd.generate_darcy_arrays(da["n"], [da["res"]], da["seed"],
                                          device=opts["device"])
        seconds = time.perf_counter() - t0
        overrides = [f"dataset.original_res={da['res']}",
                     f"dataset.max_test_resolution={da['res']}"]
        # darcy.yaml's saved_folder is data/darcy, its file darcy_flow.h5
        return gd.darcy_in_memory(os.path.join(data_dir, "darcy"), arrays), \
            overrides if opts["res"] else [], \
            f"Darcy {da} beta {arrays['beta']} CG (iterations, largest " \
            f"residual) a batch {arrays['cg'][da['res']]}", seconds
    ns = dict(NS, n=opts["n"] or NS["n"], res=opts["res"] or NS["res"])
    arrays = gd.generate_ns_arrays(ns["n"], [ns["res"]], ns["n_snapshots"],
                                   ns["seed"], viscosity=ns["viscosity"],
                                   device=opts["device"])
    if opts["device"] == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    u = arrays["by_res"][ns["res"]]
    if not (u.shape == (ns["n"], ns["n_snapshots"], ns["res"], ns["res"])
            and bool(torch.isfinite(torch.as_tensor(u)).all())):
        raise RuntimeError(f"generated NS: shape {u.shape} or non-finite")
    eager_s = eager_ns(ns, u, opts["device"])
    [path] = gd.write_ns(os.path.join(data_dir, "ns"), arrays,
                         file_format="mat")
    name = os.path.basename(path)
    overrides = [f"dataset.dataset_params.filename={name}",
                 f"dataset.dataset_params.file_map={{{ns['res']}: {name}}}",
                 f"dataset.eval_filename={name}"]
    if opts["leg"] in NS_TRUE_MRES:
        overrides = overrides[1:]
    else:
        overrides = overrides[:1]  # ns_naive.yaml reads one file
    return contextlib.nullcontext(), overrides, \
        f"NS {ns} max|w| {float(abs(u).max()):.3f} eager_seconds " \
        f"{eager_s:.2f}", seconds


def eager_ns(ns: dict, u, device) -> float:
    """The same NS data solved again with every step launched on its own
    (no CUDA graph), timed; on the card it must equal the graphed solve
    bit for bit. Returns its seconds."""
    from resolution_pde_tpu_torch.datagen import (GaussianRF,
                                                  navier_stokes_2d,
                                                  ns_forcing)

    w0 = GaussianRF(2, ns["res"], alpha=2.5, tau=7.0).sample(
        torch.Generator().manual_seed(ns["seed"]), ns["n"], device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, _ = navier_stokes_2d(w0, ns_forcing(ns["res"]),
                              visc=float(ns["viscosity"]),
                              T=ns["n_snapshots"] * 0.1, delta_t=1e-3,
                              record_steps=ns["n_snapshots"], graph=False)
    eager = sol.permute(0, 3, 1, 2).contiguous().cpu().numpy()
    seconds = time.perf_counter() - t0
    if not np.array_equal(eager, u):
        raise RuntimeError("NS: the eager solve differs from the graphed one")
    return seconds


def row_name(opts: dict) -> str:
    """The leg's row name: the GNOT leg at a training seed other than 0
    gets its own row (gnot_ns_demo_seed<k>), so a merge keeps it beside
    seed 0's."""
    return (f"{opts['leg']}_seed{opts['seed']}" if opts["seed"]
            else opts["leg"])


def gnot_demo(opts: dict, out_dir: str) -> tuple:
    """scripts/integration_demo_gnot.py's steps on the port: NS generated
    on the device, held as ns_gnot.yaml's file; the point-cloud factory;
    GNOTOperator from mgpt.yaml (n_hidden, n_layers as the demo's); the
    Trainer at a constant lr for GNOT['epochs'] epochs of shuffled
    batches; the test split's rel-L2. Writes the row's sweep.csv and
    sweep.md to ``out_dir``. Returns (the row, its seconds)."""
    from resolution_pde_tpu_torch.cli import sweep
    from resolution_pde_tpu_torch.cli.main_1d import _platform
    from resolution_pde_tpu_torch.configs import (instantiate_dataset,
                                                  instantiate_model,
                                                  load_config)
    from resolution_pde_tpu_torch.data.io import files_in_memory
    from resolution_pde_tpu_torch.data.loader import Loader
    from resolution_pde_tpu_torch.datagen import generate_ns_dataset
    from resolution_pde_tpu_torch.train import Trainer

    g = dict(GNOT, n=opts["n"] or GNOT["n"], res=opts["res"] or GNOT["res"])
    device = opts["device"]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, u, _ = generate_ns_dataset(
        torch.Generator().manual_seed(g["seed"]), g["n"], s=g["res"],
        viscosity=g["viscosity"], T=g["T"], delta_t=g["delta_t"],
        record_steps=g["record_steps"], batch_size=g["n"], device=device)
    data_s = time.perf_counter() - t0
    u = np.ascontiguousarray(np.moveaxis(u, -1, 1))  # (n, t, s, s)
    if not bool(np.isfinite(u).all()):
        raise RuntimeError("generated NS: non-finite")
    ns = {k: g[k] for k in ("n", "res", "record_steps", "viscosity", "T",
                            "delta_t", "seed")}
    print(f"[quality] data: NS {ns} u {u.shape} max|w| "
          f"{float(abs(u).max()):.3f} seconds={data_s:.2f}", flush=True)

    cfg = load_config(model="mgpt", dataset="ns_gnot",
                      overrides=[f"model.n_hidden={g['n_hidden']}",
                                 f"model.n_layers={g['n_layers']}"]
                      + opts["extras"])
    fname = f"ns_{g['res']}_demo.h5"
    folder = os.path.abspath("data/ns")
    with files_in_memory({os.path.join(folder, fname): u}):
        data = instantiate_dataset(cfg.dataset.dataset_params,
                                   filename=fname, saved_folder=folder)
    train, test, y_norm = data[0], data[2], data[5]
    print(f"[quality] point cloud: x {train.x.shape} (features|positions), "
          f"y {train.y.shape}", flush=True)
    seed = opts["seed"]
    model = instantiate_model(cfg.model, seed=seed)
    trainer = Trainer(model, learning_rate=g["learning_rate"],
                      y_normalizer=y_norm, use_normalizer=False,
                      seed=seed, device=device)
    state = trainer.init()
    n_params = sum(p.numel() for p in state.model.parameters())
    loader = Loader(train, g["batch_size"], shuffle=True, seed=seed)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(opts["epochs"]):
        e0 = time.perf_counter()
        state, loss = trainer.train_epoch(state, loader)
        losses.append(float(loss))
        print(f"[quality] epoch {epoch + 1} train_loss={losses[-1]:.6f} "
              f"seconds={time.perf_counter() - e0:.2f}", flush=True)
    train_s = time.perf_counter() - t0
    test_loss = trainer.evaluate(state, Loader(test, g["batch_size"],
                                               shuffle=False))
    out = {"test_loss": float(test_loss), "n_params": n_params,
           "train_seconds": train_s,
           "provenance": {"platform": _platform(torch.device(device)),
                          "epochs": opts["epochs"], "dataset": fname}}
    os.makedirs(out_dir, exist_ok=True)
    sweep._write_tables(out_dir, "gnot_ns_demo",
                        [(row_name(opts), out, None)],
                        rehearsal=opts["rehearsal"])
    with open(os.path.join(out_dir, "sweep.csv"), newline="") as f:
        [row] = list(csv.DictReader(f))
    return row, {"data_seconds": data_s, "train_seconds": train_s,
                 "train_first": losses[0], "train_last": losses[-1]}


def main(argv=None) -> int:
    from resolution_pde_tpu_torch.cli import sweep

    opts = parse(list(argv if argv is not None else sys.argv[1:]))
    leg = opts["leg"]
    family, pde = LEGS[leg]
    sweep_leg = SWEEP_LEG.get(leg, leg)
    rehearsal = opts["rehearsal"]
    print(f"[quality] leg={leg} family={family} device={opts['device']} "
          f"rehearsal={str(rehearsal).lower()}", flush=True)
    print(card(), flush=True)
    out_dir = os.path.abspath(os.path.join(opts["out"],
                                           f"quality_{row_name(opts)}"))
    if pde == "gnot":
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                row, seconds = gnot_demo(opts, out_dir)
            finally:
                os.chdir(cwd)
        print(json.dumps({"leg": row_name(opts), **seconds, "card": card(),
                          **row}), flush=True)
        return 0
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            context, overrides, what, data_s = generate(
                pde, opts, os.path.join(tmp, "data"))
            print(f"[quality] data: {what} seconds={data_s:.2f}", flush=True)
            argv = ([f"family={family}", f"only={sweep_leg}",
                     f"training.epochs={opts['epochs']}",
                     f"training.t_max={opts['epochs']}"]
                    + overrides + opts["extras"]
                    + (["rehearsal=true"] if rehearsal else []))
            print(f"[quality] sweep {' '.join(argv)}", flush=True)
            t0 = time.perf_counter()
            with context:
                out = sweep.main(argv, device=opts["device"])[sweep_leg]
            sweep_s = time.perf_counter() - t0
            [run_dir] = [os.path.join("runs", "sweeps", d)
                         for d in os.listdir(os.path.join("runs", "sweeps"))]
            os.makedirs(out_dir, exist_ok=True)
            for name in ("sweep.csv", "sweep.md"):
                with open(os.path.join(run_dir, name)) as f:
                    text = f.read()
                # the row under this script's leg name
                text = text.replace(f"\n{sweep_leg},", f"\n{leg},").replace(
                    f"\n| {sweep_leg} |", f"\n| {leg} |")
                with open(os.path.join(out_dir, name), "w") as f:
                    f.write(text)
            with open(os.path.join(out_dir, "sweep.csv"), newline="") as f:
                [row] = list(csv.DictReader(f))
        finally:
            os.chdir(cwd)
    if out is not None:
        hist = out["history"]
        for e, (tl, vl, s) in enumerate(zip(hist.train_loss, hist.val_loss,
                                            hist.epoch_time_s)):
            print(f"[quality] epoch {e + 1} train_loss={tl:.6f} "
                  f"val_loss={vl:.6f} seconds={s:.2f}", flush=True)
    print(f"[quality] sweep seconds={sweep_s:.2f}", flush=True)
    seconds = {} if out is None else {
        "train_seconds": out["train_seconds"],
        "eval_seconds": out["eval_seconds"],
        "rollout_seconds": out["rollout_seconds"]}
    print(json.dumps({"leg": leg, "data_seconds": data_s,
                      "sweep_seconds": sweep_s, **seconds, "card": card(),
                      **row}), flush=True)
    return 0 if out is not None else 1


if __name__ == "__main__":
    sys.exit(main())
