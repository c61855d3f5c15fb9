"""Experiment sweeps: one command runs a family of legs (model x dataset
x overrides) through the drivers and writes their results as one table.

    python -m resolution_pde_tpu_torch.cli.sweep family=baseline \\
        isolate=true training.epochs=20 training.t_max=20
    python -m resolution_pde_tpu_torch.cli.sweep family=ns_models \\
        only=ffno2d_ns dataset.dataset_params.filename=ns_256_1e-03.mat
    python -m resolution_pde_tpu_torch.cli.sweep merge out=<dir> <d1> <d2>

Counterpart of resolution_pde_tpu/cli/sweep.py: the same families, leg
for leg, the same tables (``runs/sweeps/<family>_<time>/sweep.csv`` and
``sweep.md``: a row a leg, a column per evaluation resolution, provenance
and the error of a failed leg), rewritten after every leg, the
``.incomplete`` and ``.ok`` markers, ``only=``, ``rehearsal=``,
``isolate=`` and ``merge``. Extra ``key=value`` arguments apply to every
leg. Each leg runs ``main_1d`` or ``main_2d`` on the card (``device``,
the card unless the caller passes "cpu"); with ``isolate=true`` in a
fresh interpreter. A leg that fails, for instance on a model or dataset
factory not ported yet (whose error names its ROADMAP item), is recorded
in the table's error column and the others go on; the command exits
non-zero. The JAX package's TPU lock and backend probe have no
counterpart here.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

from resolution_pde_tpu_torch.cli.common import require_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (name, driver, overrides) per leg; drivers: '1d' -> main_1d, '2d' -> main_2d
FAMILIES = {
    # The five BASELINE.json canonical config families (BASELINE.md).
    "baseline": [
        ("fno1d_burger_naive", "1d",
         ["model=fno_1d", "dataset=burger_naive"]),
        ("ffno1d_ks_true_mres", "1d",
         ["model=ffno_1d", "dataset=ks_naive_true_mres1"]),
        ("ffno2d_ns_true_mres", "2d",
         ["model=ffno_2d", "dataset=ns_naive_true_mres1"]),
        ("cno2d_ns_resize", "2d",
         ["model=cno_2d", "dataset=ns_naive",
          "training.cno_resize_training=true"]),
        ("s4_ks_window", "1d", ["model=s4_1d", "dataset=ks_s4"]),
    ],
    # KS resolution-strategy ladder.
    "ks_ladder": [
        (f"ffno1d_{ds}", "1d", ["model=ffno_1d", f"dataset={ds}"])
        for ds in ("ks_naive", "ks_naive_mres", "ks_naive_true_mres1",
                   "ks_resize", "ks_resize_mres", "ks_pino")
    ],
    # Burgers strategy ladder.
    "burger_ladder": [
        (f"ffno1d_{ds}", "1d", ["model=ffno_1d", f"dataset={ds}"])
        for ds in ("burger_naive", "burger_naive_mres",
                   "burger_naive_true_mres", "burger_resize",
                   "burger_resize_mres", "burger_resize_true_mres")
    ],
    # Active-matter time-stride ladder (ns_active_t{2,4,8,16}).
    "ns_active_ladder": [
        (f"ffno2d_{ds}", "2d", ["model=ffno_2d", f"dataset={ds}"])
        for ds in ("ns_active_t2", "ns_active_t4", "ns_active_t8",
                   "ns_active_t16")
    ],
    # 2D models on one NS dataset, trained at 128^2 (the 256^2 file
    # strided by 2) and evaluated at 32..256; the fixed-size CNOs with
    # resize training and evaluation, pos at demo scale.
    "ns_models": [
        ("ffno2d_ns", "2d", ["model=ffno_2d", "dataset=ns_naive",
                             "dataset.dataset_params.reduced_resolution=2",
                             "dataset.rollout_steps=8"]),
        ("cno2d_ns_resize", "2d",
         ["model=cno_2d", "dataset=ns_naive",
          "dataset.dataset_params.reduced_resolution=2",
          "dataset.cno_train_size=128", "training.cno_resize_training=true",
          "dataset.evaluation_type=use_resize",
          "dataset.resize_to_train=true", "dataset.rollout_steps=8"]),
        ("cno2d_original_ns", "2d",
         ["model=cno_2d_original", "dataset=ns_naive",
          "dataset.dataset_params.reduced_resolution=2",
          "dataset.cno_train_size=128",
          "dataset.evaluation_type=use_resize",
          "dataset.resize_to_train=true", "dataset.rollout_steps=8"]),
        ("pos_ns", "2d",
         ["model=pos", "dataset=ns_naive",
          "dataset.dataset_params.reduced_resolution=2",
          "dataset.rollout_steps=8",
          "model.num_channels=1", "model.num_out_channels=1",
          "model.embed_dim=48", "model.depths=[2,2]",
          "model.num_heads=[3,6]", "model.skip_connections=[2,0]",
          "model.window_size=8"]),
    ],
    # Darcy steady state.
    "darcy": [
        ("fno2d_darcy", "2d", ["model=fno_2d", "dataset=darcy"]),
        ("ffno2d_darcy", "2d", ["model=ffno_2d", "dataset=darcy"]),
    ],
    # Models on one KS dataset; CNO, a fixed-size model, with use_resize
    # evaluation.
    "ks_models": [
        (f"{m}_ks_naive", "1d",
         [f"model={m}", "dataset=ks_naive"] + (
             ["dataset.evaluation_type=use_resize",
              "dataset.resize_to_train=true"] if m == "cno_1d" else []))
        for m in ("fno_1d", "ffno_1d", "cno_1d", "unet_1d")
    ],
}


def _run_one(driver: str, overrides, device="cuda") -> dict:
    if driver == "1d":
        from resolution_pde_tpu_torch.cli.main_1d import main as drv
    elif driver == "2d":
        from resolution_pde_tpu_torch.cli.main_2d import main as drv
    else:
        raise ValueError(f"unknown driver {driver!r}")
    return drv(list(overrides), device=device)


def _run_one_isolated(driver: str, overrides, device="cuda") -> dict:
    """``_run_one`` in a fresh interpreter (the repository on its
    PYTHONPATH), so that nothing of one leg's process state reaches the
    next. Returns the leg's dict without its history, with the int
    resolution keys that JSON turned into strings restored."""
    fd, out_path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    code = ("import json\n"
            "from resolution_pde_tpu_torch.cli.sweep import _run_one\n"
            f"out = _run_one({driver!r}, {list(overrides)!r}, "
            f"{str(device)!r})\n"
            "out.pop('history', None)\n"
            f"json.dump(out, open({out_path!r}, 'w'), default=float)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        r = subprocess.run([sys.executable, "-c", code], env=env)
        if r.returncode != 0:
            raise RuntimeError(f"isolated {driver} run exited {r.returncode}")
        with open(out_path) as f:
            out = json.load(f)
    finally:
        os.unlink(out_path)
    for k in ("super_resolution", "rollout", "eval_seconds",
              "rollout_seconds"):
        if isinstance(out.get(k), dict):
            out[k] = {int(res): v for res, v in out[k].items()}
    return out


def _git_sha() -> str:
    """The checkout's short commit, or "" outside a git checkout: stamped
    into every table, so a number maps to the code that produced it."""
    try:
        r = subprocess.run(["git", "-C", _REPO, "rev-parse", "--short",
                            "HEAD"], capture_output=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.decode().strip() if r.returncode == 0 else ""


def _write_tables(out_dir: str, family: str, rows, rehearsal: bool = False,
                  n_total: int = None):
    """rows: [(name, out_dict | None, error | None)]. Writes sweep.csv and
    sweep.md: a row a leg, a column per evaluation resolution (test
    rel-L2, super-resolution, rollout), then parameters, train seconds
    and the driver's provenance (platform, epochs, dataset), the
    checkpoint and the error; the CSV adds git sha, the rehearsal flag
    and the family's green legs to each row, the markdown (without the
    checkpoint column) states them in its heading."""
    resolutions = sorted({r for _, out, _ in rows if out
                          for r in out.get("super_resolution", {})})
    roll_res = sorted({r for _, out, _ in rows if out
                       for r in (out.get("rollout") or {})})
    header = (["run", "test_rel_l2"]
              + [f"superres@{r}" for r in resolutions]
              + [f"rollout@{r}" for r in roll_res]
              + ["params_m", "train_s", "platform", "epochs", "dataset",
                 "checkpoint", "error"])
    sha = _git_sha()

    def fmt(v):
        return f"{v:.6f}" if v == v else "nan"

    def cells(name, out, err):
        if out is None:
            return [name] + [""] * (len(header) - 3) + ["", err or ""]
        sr = out.get("super_resolution", {})
        ro = out.get("rollout") or {}
        prov = out.get("provenance") or {}
        return ([name, fmt(out["test_loss"])]
                + [fmt(sr[r]) if r in sr else "" for r in resolutions]
                + [fmt(ro[r]) if r in ro else "" for r in roll_res]
                + [f"{out['n_params'] / 1e6:.2f}"
                   if out.get("n_params") else "",
                   f"{out['train_seconds']:.0f}"
                   if out.get("train_seconds") else "",
                   str(prov.get("platform", "")),
                   str(prov.get("epochs", "")),
                   str(prov.get("dataset", "")),
                   str(out.get("checkpoint") or ""), ""])

    table = [cells(*row) for row in rows]
    n_green = sum(1 for _, out, _ in rows if out is not None)
    legs_green = f"{n_green}/{n_total if n_total is not None else len(rows)}"
    # a leg's own sha where it stamped one (a long sweep can span commits)
    row_shas = [((out or {}).get("provenance") or {}).get("git_sha") or sha
                for _, out, _ in rows]
    with open(os.path.join(out_dir, "sweep.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header + ["git_sha", "rehearsal", "legs_green"])
        w.writerows([row + [rsha, str(rehearsal).lower(), legs_green]
                     for row, rsha in zip(table, row_shas)])
    with open(os.path.join(out_dir, "sweep.md"), "w") as f:
        f.write(f"# Sweep: {family}\n\n")
        f.write(f"provenance: git={sha or 'unknown'} "
                f"rehearsal={str(rehearsal).lower()} "
                f"legs_green={legs_green}\n\n")
        md_header = header[:-2] + [header[-1]]
        f.write("| " + " | ".join(md_header) + " |\n")
        f.write("|" + "---|" * len(md_header) + "\n")
        for row in table:
            f.write("| " + " | ".join(row[:-2] + [row[-1]]) + " |\n")
    return header, table


def _write_health_marker(out_dir: str, family: str, n_green: int,
                         n_total: int, detail: str = ""):
    """``.incomplete`` in the run directory while any leg is not green
    (with ``detail``); removed once all are."""
    marker = os.path.join(out_dir, ".incomplete")
    if n_green < n_total:
        with open(marker, "w") as f:
            f.write(f"family={family} legs_green={n_green}/{n_total}\n")
            if detail:
                f.write(detail + "\n")
    elif os.path.exists(marker):
        os.unlink(marker)


def merge_tables(argv):
    """``sweep merge out=<dir> <dir1> <dir2> ...``: fold sweep tables into
    one without training, a later directory's row replacing an earlier
    one's of the same leg (whole rows, provenance included); the columns
    are the union of the tables' resolutions."""
    out_dir = None
    srcs = []
    for a in argv:
        if a.startswith("out="):
            out_dir = a.split("=", 1)[1]
        else:
            srcs.append(a)
    if out_dir is None or len(srcs) < 2:
        raise SystemExit(
            "usage: sweep merge out=<dir> <dir1> <dir2> ... "
            "(later dirs override earlier per leg name)")

    rows = {}  # leg name -> row, in first-seen order
    for src in srcs:
        with open(os.path.join(src, "sweep.csv"), newline="") as f:
            for r in csv.DictReader(f):
                r.pop("legs_green", None)  # recomputed for the merge
                rows[r["run"]] = dict(r)
    n_green = sum(1 for r in rows.values() if not r.get("error"))
    legs_green = f"{n_green}/{len(rows)}"
    for r in rows.values():
        r["legs_green"] = legs_green

    def res_cols(prefix):
        res = {int(k.split("@", 1)[1]) for r in rows.values() for k in r
               if k.startswith(prefix) and r[k]}
        return [f"{prefix}{n}" for n in sorted(res)]

    header = (["run", "test_rel_l2"] + res_cols("superres@")
              + res_cols("rollout@")
              + ["params_m", "train_s", "platform", "epochs", "dataset",
                 "checkpoint", "error", "git_sha", "rehearsal",
                 "legs_green"])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "sweep.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for r in rows.values():
            w.writerow([r.get(c) or "" for c in header])
    _write_health_marker(out_dir, "merged", n_green, len(rows),
                         detail="merged from: " + " ".join(srcs))
    with open(os.path.join(out_dir, "sweep.md"), "w") as f:
        f.write("# Sweep: merged\n\n")
        f.write(f"legs_green: {legs_green}\n\n")
        f.write("merged from: " + " ".join(srcs)
                + " (later override earlier per leg)\n\n")
        md_header = [c for c in header if c != "checkpoint"]
        f.write("| " + " | ".join(md_header) + " |\n")
        f.write("|" + "---|" * len(md_header) + "\n")
        for r in rows.values():
            f.write("| " + " | ".join(r.get(c) or "" for c in md_header)
                    + " |\n")
    print(f"merged {len(srcs)} tables ({len(rows)} legs) -> "
          f"{out_dir}/sweep.csv")
    return rows


def _flag(arg: str) -> bool:
    return arg.split("=", 1)[1].lower() in ("1", "true", "yes")


def main(argv=None, device="cuda"):
    """Run a family (``family=``, default baseline; ``only=`` a comma-
    separated subset of its legs); returns {leg: the driver's dict, or
    None where the leg failed}. ``rehearsal=true`` stamps the tables as a
    rehearsal; ``.ok`` is written only for a whole family, not a
    rehearsal, with every leg green."""
    argv = list(argv if argv is not None else sys.argv[1:])
    if argv and argv[0] == "merge":
        return merge_tables(argv[1:])
    family, isolate, rehearsal, only = "baseline", False, False, None
    extras = []
    for a in argv:
        if a.startswith("family="):
            family = a.split("=", 1)[1]
        elif a.startswith("isolate="):
            isolate = _flag(a)
        elif a.startswith("rehearsal="):
            rehearsal = _flag(a)
        elif a.startswith("only="):
            only = set(a.split("=", 1)[1].split(","))
        else:
            extras.append(a)
    if family not in FAMILIES:
        raise SystemExit(
            f"unknown family {family!r}; available: {sorted(FAMILIES)}")
    legs = FAMILIES[family]
    if only is not None:
        unknown = only - {name for name, _, _ in legs}
        if unknown:
            raise SystemExit(
                f"unknown legs {sorted(unknown)} for family {family!r}; "
                f"available: {[n for n, _, _ in legs]}")
        legs = [leg for leg in legs if leg[0] in only]
    device = require_device(device, "sweep")

    out_dir = os.path.join("runs", "sweeps", f"{family}_{int(time.time())}")
    os.makedirs(out_dir, exist_ok=True)
    run = _run_one_isolated if isolate else _run_one
    rows = []
    for name, driver, overrides in legs:
        print(f"=== sweep[{family}] run {name}: "
              f"{' '.join(overrides + extras)}", flush=True)
        # a checkpoint directory per leg (cli/common.run_checkpoint_path)
        os.environ["SLURM_JOB_ID"] = name
        try:
            rows.append((name, run(driver, overrides + extras, device),
                         None))
        except Exception as e:  # one failing leg must not end the family
            traceback.print_exc()
            rows.append((name, None, f"{type(e).__name__}: {e}"))
        # the tables after every leg: a sweep killed midway keeps the
        # legs it finished
        _write_tables(out_dir, family, rows, rehearsal=rehearsal,
                      n_total=len(legs))
        _write_health_marker(
            out_dir, family, sum(1 for _, o, _ in rows if o is not None),
            len(legs),
            detail="family still running; completed legs: " + " ".join(
                n for n, o, _ in rows if o is not None))

    header, table = _write_tables(out_dir, family, rows,
                                  rehearsal=rehearsal)
    _write_health_marker(
        out_dir, family, sum(1 for _, out, _ in rows if out is not None),
        len(rows), detail="failed legs: " + " ".join(
            n for n, out, _ in rows if out is None))
    if only is None and not rehearsal and all(out is not None
                                              for _, out, _ in rows):
        with open(os.path.join(out_dir, ".ok"), "w") as f:
            f.write(f"family={family} legs={len(rows)} "
                    f"sha={_git_sha()} extras={' '.join(extras)}\n")
    print(f"\nsweep results -> {out_dir}/sweep.csv")
    cols = list(range(len(header) - 2)) + [len(header) - 1]  # no ckpt path
    widths = [max(len(header[i]), max((len(r[i]) for r in table), default=0))
              for i in cols]
    print("  ".join(header[i].ljust(w) for i, w in zip(cols, widths)))
    for row in table:
        print("  ".join(row[i].ljust(w) for i, w in zip(cols, widths)))
    failed = [n for n, out, _ in rows if out is None]
    if failed:
        print(f"FAILED runs: {failed}")
    return {name: out for name, out, _ in rows}


if __name__ == "__main__":
    # non-zero when any leg failed; the tables are written either way
    results = main()
    sys.exit(0 if all(v is not None for v in results.values()) else 1)
