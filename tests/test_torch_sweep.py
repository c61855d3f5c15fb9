"""The port's sweep runner against the JAX package's: the families leg
for leg; the tables (sweep.csv, sweep.md) and a merge of them written
from the same rows, byte for byte with the same sha; a tiny family on the
CPU (a tiny FFNO1D leg on KS files, a leg whose model is unknown, whose
KeyError the table records, and a broken leg) with the
tables rewritten after every leg, the .incomplete and .ok markers,
``only=``, ``rehearsal=``, ``isolate=``, ``merge`` and the exit code;
dotted overrides of the NS legs' file names resolving as in JAX; and the
KS command line on trajectories held in memory
(cli.generate_data.ks_in_memory) equal to the same on written files.
"""

import contextlib
import csv
import glob
import os
import runpy
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

from resolution_pde_tpu.cli import sweep as jsweep  # noqa: E402
from resolution_pde_tpu.configs import load_config as jax_load  # noqa: E402
from resolution_pde_tpu_torch.cli import generate_data as tgen  # noqa: E402
from resolution_pde_tpu_torch.cli import sweep  # noqa: E402
from resolution_pde_tpu_torch.cli.main_1d import main as main_1d  # noqa: E402
from resolution_pde_tpu_torch.configs import load_config  # noqa: E402
from resolution_pde_tpu_torch.datagen import write_ks_file  # noqa: E402


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _ks(b, n, seed, t=6):
    rng = np.random.default_rng(seed)
    k = np.arange(n // 2 + 1)
    coef = (rng.standard_normal((b, k.size))
            + 1j * rng.standard_normal((b, k.size))) * (k < 6)
    step = np.exp(-0.3j * k - 0.01 * k ** 2)
    return np.stack([np.fft.irfft(coef * step ** i, n=n) for i in range(t)],
                    axis=1).astype(np.float32) * 3


@pytest.fixture(scope="module")
def ks_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ks_naive")
    for i, name in enumerate(("KS_train_2048.h5", "KS_valid.h5",
                              "KS_test.h5")):
        write_ks_file(str(d / name), _ks(12, 64, i))
    return d


def _tiny_leg(d, name="ffno_ks"):
    return (name, "1d",
            ["model=ffno_1d", "dataset=ks_naive", "model.width=8",
             "model.n_modes=8", "model.n_layers=1", "model.dropout=0",
             f"dataset.dataset_params.saved_folder={d}",
             "dataset.original_res=64", "dataset.max_test_resolution=64",
             "dataset.rollout_steps=2", "training.epochs=1",
             "training.batch_size=16"])


def _run_dirs(root, family):
    return sorted(glob.glob(str(root / "runs" / "sweeps" / f"{family}_*")))


def _csv(run_dir):
    with open(os.path.join(run_dir, "sweep.csv"), newline="") as f:
        return list(csv.DictReader(f))


def test_families_equal_jax():
    assert sweep.FAMILIES == jsweep.FAMILIES


def _out(test, sr, ro, platform="cuda(NVIDIA H100 80GB HBM3)"):
    return {"test_loss": test, "super_resolution": sr, "rollout": ro,
            "n_params": 4_590_000, "train_seconds": 530.4,
            "checkpoint": "checkpoints/ffno2d/ns_x",
            "provenance": {"platform": platform, "epochs": 20,
                           "dataset": "ns_256_1e-03.mat"}}


def test_tables_and_merge_equal_jax(tmp_path, monkeypatch):
    rows = [("ffno2d_ns", _out(0.011747, {32: 0.01308, 64: 0.01185,
                                          128: 0.011747, 256: 0.082164},
                               {32: 0.047, 256: 0.04}), None),
            ("cno2d_ns_resize", None,
             "NotImplementedError: training.cno_resize_training (CNO) is "
             "not ported: ROADMAP.md section 1, item 7"),
            ("pos_ns", _out(float("nan"), {512: 0.5}, {}, "cpu"), None)]
    for mod in (sweep, jsweep):
        monkeypatch.setattr(mod, "_git_sha", lambda: "0123abc")
    for rehearsal, n_total in ((False, None), (True, 5)):
        got, want = tmp_path / f"port{n_total}", tmp_path / f"jax{n_total}"
        got.mkdir()
        want.mkdir()
        sweep._write_tables(str(got), "ns_models", rows, rehearsal, n_total)
        jsweep._write_tables(str(want), "ns_models", rows, rehearsal,
                             n_total)
        for name in ("sweep.csv", "sweep.md"):
            assert (got / name).read_text() == (want / name).read_text()
    # a merge of the two tables: port and JAX the same
    srcs = [str(tmp_path / "portNone"), str(tmp_path / "port5")]
    sweep.merge_tables([f"out={tmp_path}/m_port"] + srcs)
    jsweep.merge_tables([f"out={tmp_path}/m_jax"] + srcs)
    for name in ("sweep.csv", "sweep.md", ".incomplete"):
        assert ((tmp_path / "m_port" / name).read_text()
                == (tmp_path / "m_jax" / name).read_text().replace(
                    "m_jax", "m_port"))


def test_tiny_family_on_the_cpu(ks_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    name, ndim, argv = _tiny_leg(ks_dir, "unknown_model")
    legs = [_tiny_leg(ks_dir),
            (name, ndim, argv + ["model._target_=models.nope.NoSuchModel"]),
            ("broken", "1d", ["model=ffno_1d", "dataset=does_not_exist"])]
    # a family name each run: a run directory is named by the second
    monkeypatch.setattr(sweep, "FAMILIES", {
        "tiny": legs, "subset": legs, "green": legs[:1],
        "rehearsed": legs[:1]})
    writes = []
    write_tables = sweep._write_tables

    def counted(out_dir, family, rows, *a, **kw):
        writes.append(len(rows))
        return write_tables(out_dir, family, rows, *a, **kw)

    monkeypatch.setattr(sweep, "_write_tables", counted)
    out = sweep.main(["family=tiny"], device="cpu")
    # rewritten after every leg, then once more
    assert writes == [1, 2, 3, 3]
    assert out["unknown_model"] is None and out["broken"] is None
    assert np.isfinite(out["ffno_ks"]["test_loss"])
    assert set(out["ffno_ks"]["super_resolution"]) == {32, 64}
    [run_dir] = _run_dirs(tmp_path, "tiny")
    rows = _csv(run_dir)
    assert [r["run"] for r in rows] == ["ffno_ks", "unknown_model", "broken"]
    assert rows[0]["platform"] == "cpu" and rows[0]["epochs"] == "1"
    assert all(r["legs_green"] == "1/3" and r["rehearsal"] == "false"
               for r in rows)
    assert rows[1]["error"].startswith(
        "KeyError: \"unknown model 'models.nope.NoSuchModel'")
    assert rows[2]["error"].startswith("FileNotFoundError")
    md = open(os.path.join(run_dir, "sweep.md")).read()
    assert "legs_green=1/3" in md and "NoSuchModel" in md
    marker = open(os.path.join(run_dir, ".incomplete")).read()
    assert "legs_green=1/3" in marker and "broken" in marker
    assert not os.path.exists(os.path.join(run_dir, ".ok"))

    # only=: no markers; a whole green family: .ok; a rehearsal: no .ok
    for argv, ok in ((["family=subset", "only=ffno_ks"], False),
                     (["family=green"], True),
                     (["family=rehearsed", "rehearsal=true"], False)):
        sweep.main(argv, device="cpu")
        [new] = _run_dirs(tmp_path, argv[0][7:])
        assert os.path.exists(os.path.join(new, ".ok")) == ok
        assert not os.path.exists(os.path.join(new, ".incomplete"))
        assert _csv(new)[0]["rehearsal"] == str("rehearsal=true"
                                                in argv).lower()
    with pytest.raises(SystemExit, match="unknown legs"):
        sweep.main(["family=tiny", "only=nope"], device="cpu")

    # merge: the refreshed leg's row over the family's
    [refresh] = _run_dirs(tmp_path, "subset")
    merged = sweep.main(["merge", f"out={tmp_path}/merged", run_dir,
                         refresh])
    assert list(merged) == ["ffno_ks", "unknown_model", "broken"]
    assert merged["ffno_ks"]["test_rel_l2"] == _csv(refresh)[0][
        "test_rel_l2"]
    assert "legs_green=1/3" in open(f"{tmp_path}/merged/.incomplete").read()


def test_isolated_legs_and_exit_code(ks_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sweep, "FAMILIES", {"tiny": [
        _tiny_leg(ks_dir),
        ("broken", "1d", ["model=ffno_1d", "dataset=does_not_exist"])]})
    out = sweep.main(["family=tiny", "isolate=true"], device="cpu")
    leg = out["ffno_ks"]
    assert "history" not in leg
    assert sorted(leg["super_resolution"]) == [32, 64]
    assert sorted(leg["rollout"]) == [32, 64]
    assert _csv(_run_dirs(tmp_path, "tiny")[0])[1]["error"] == (
        "RuntimeError: isolated 1d run exited 1")
    # python -m ...cli.sweep exits 1 when a leg failed (here a leg whose
    # data file is absent, which fails before it touches the device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(sys, "argv", ["sweep", "family=baseline",
                                      "only=cno2d_ns_resize"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(sweep.__file__, run_name="__main__")
    assert exc.value.code == 1


def test_sweep_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.main(["family=ns_models", "only=ffno2d_ns"])
    assert not os.path.exists(tmp_path / "runs")


@pytest.mark.parametrize("model,dataset,overrides", [
    ("ffno_2d", "ns_naive_true_mres1",
     ["dataset.dataset_params.file_map={256: ns_256_1e-03.mat}",
      "dataset.eval_filename=ns_256_1e-03.mat",
      "dataset.eval_saved_folder=/data/ns",
      "dataset.dataset_params.data_mres_size={256: -1}",
      "training.epochs=20", "training.t_max=20"]),
    ("ffno_2d", "ns_naive",
     ["dataset.dataset_params.filename=ns_256_1e-03.mat",
      "dataset.dataset_params.saved_folder=/data/ns",
      "dataset.dataset_params.reduced_resolution=2",
      "model.depths=[2,2]", "dataset.dataset_params.viscosity=1e-3"])])
def test_dotted_overrides_resolve_as_in_jax(model, dataset, overrides):
    got = load_config(model, dataset, overrides=overrides)
    assert got == jax_load(model, dataset, overrides=overrides)
    if "file_map" in overrides[0]:
        assert got.dataset.dataset_params.file_map == {
            256: "ns_256_1e-03.mat"}


def test_ks_in_memory_equals_written_files(tmp_path):
    """main_1d on ks_naive_true_mres1 (the tree's train file, the eval
    swap to its valid and test files) reads the same data from memory as
    from the files generate_data writes."""
    arrays = {"by_res": {64: _ks(20, 64, 0), 32: _ks(20, 32, 1)},
              "split_counts": (16, 2, 2), "snap_dt": 0.1, "visc": 0.075}
    written, held = str(tmp_path / "written"), str(tmp_path / "held")
    tgen.write_ks(written, arrays, n_snapshots=51)
    tree = "res_64/visc_0.075_L64.0_lmax8_et5.0_nte51_nt51"

    def argv(d):
        return ["model=ffno_1d", "dataset=ks_naive_true_mres1",
                f"dataset.dataset_params.saved_folder={d}",
                "dataset.dataset_params.data_mres_size={64: 16, 32: 16}",
                "dataset.dataset_params.downsample_from_res=64",
                f"dataset.eval_saved_folder={d}/{tree}",
                "dataset.original_res=64", "dataset.max_test_resolution=64",
                "dataset.rollout_steps=2", "model.width=8",
                "model.n_layers=1", "model.n_modes=8", "model.dropout=0",
                "training.epochs=1"]

    with _cwd(tmp_path / "a"):
        want = main_1d(argv(written), device="cpu")
    with _cwd(tmp_path / "b"), tgen.ks_in_memory(held, arrays, 51):
        got = main_1d(argv(held), device="cpu")
    assert not os.path.exists(held)
    assert got["history"].train_loss == want["history"].train_loss
    for key in ("test_loss", "super_resolution", "rollout"):
        assert got[key] == want[key]
    assert sorted(got["rollout"]) == [32, 64]
