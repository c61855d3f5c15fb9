"""The harness: the result line's schema, that cells, mixes and metrics are
found by name, that no JAX module is loaded, that the contract's limits on
BENCHMARK.json hold, and that a run without a card prints no result."""

import ast
import json
import re
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, make_tiny, workloads

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 17


def _line_ok(out: dict, cell: dict, bench: dict, trace: bool) -> None:
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert out["attempted"] > 0 and out["failed"] >= 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, check in out["checks"].items():
        assert set(check) == {"value", "limit"}, name
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for key in ("device_ops", "idle_gaps"):
            rows = out["breakdown"][key]
            assert len(rows) <= 10
            assert all(isinstance(n, str) and isinstance(v, float)
                       for n, v in rows)
        allowed = {m["name"] for m in bench["per_layer"]}
    else:
        allowed = {m["name"] for m in bench["end_to_end"]
                   if cell["name"] in m.get("workloads", [cell["name"]])}
        assert set(out["metrics"]) == allowed
    for name, m in out["metrics"].items():
        assert name in allowed and set(m) == {"value", "unit"}
        assert m["value"] == m["value"]  # not NaN


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", workloads())
def test_result_line(tiny_root, workload, trace):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    out = harness.run(tiny_root, workload, SEED, 0.4, trace, device="cpu")
    _line_ok(out, cell, bench, trace)
    assert out["correct"], out["checks"]
    json.dumps(out)


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as files and entries run with no edit to the harness."""
    root = make_tiny(tmp_path)
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "ffno2d_ns256.json").read_text())
    cfg["name"] = "ffno2d_added"
    (b / "configs" / "ffno2d_added.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "serve_b8.json").read_text())
    tr.update(rows=2, grid=[8, 8])
    (b / "traffic" / "serve_added.json").write_text(json.dumps(tr))
    (b / "metrics" / "added_metric.serve.py").write_text(
        "def read(r):\n    return float(r.traffic['rows'])\n")
    (b / "limits" / "ffno2d_added.serve_added.json").write_text(
        json.dumps({"out_gap_bf16": 7.0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="ffno2d_added",
                                 file="benchmark/configs/ffno2d_added.json"))
    bench["workloads"].append({"name": "ffno2d_added.serve_added",
                               "config": "ffno2d_added",
                               "traffic": "serve_added", "chips": 1,
                               "why": "added"})
    bench["per_layer"].append({
        "name": "added_metric.serve", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "predict_rows_per_s",
        "workloads": ["ffno2d_added.serve_added"]})
    for m in bench["end_to_end"]:
        if "predict" in m["name"]:
            m["workloads"].append("ffno2d_added.serve_added")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run(root, "ffno2d_added.serve_added", 5, 0.3, True,
                      device="cpu")
    assert out["metrics"]["added_metric.serve"]["value"] == 2.0
    assert out["correct"]


def test_no_jax_module_is_loaded(tiny_root):
    """A whole run in a fresh interpreter loads no module whose top-level
    name is jax, jaxlib, flax or resolution_pde_tpu (compared whole: the
    port's name begins with the JAX package's)."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark import harness\n"
            f"harness.run({str(tiny_root)!r}, 'ffno2d_ns256.train_b32', 3, "
            "0.3, True, device='cpu')\n"
            "harness.run(" f"{str(tiny_root)!r}, 's4nd_ns.serve_b8_256', 3, "
            "0.3, False, device='cpu')\n"
            "print(harness.forbidden_modules())\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "'resolution_pde_tpu_torch'))[:1])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    last = res.stdout.strip().splitlines()
    assert last[-2] == "[]"
    assert last[-1] == "['resolution_pde_tpu_torch']"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "resolution_pde_tpu_torch_x", object())
    assert "resolution_pde_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "resolution_pde_tpu.models", object())
    assert harness.forbidden_modules() == ["resolution_pde_tpu.models"]


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert len(files) >= 4
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in {"resolution_pde_tpu_torch",
                               "resolution_pde_tpu", "jax", "jaxlib",
                               "flax"}, (path.name, name)
            assert name not in {"benchmark.program", "benchmark.faults"}, (
                path.name, name)


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / bench["command"][1]).is_file()
    b = ROOT / "benchmark"
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == {"setup_s", "train_samples_per_s",
                        "predict_rows_per_s", "predict_p95_ms"}
    assert e2e["setup_s"]["bound"] == 0.25
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    cells = {w["name"]: w for w in bench["workloads"]}
    assert list(cells) == ["ffno2d_ns256.train_b32", "ffno2d_ns256.serve_b8",
                           "s4nd_ns.serve_b8_256", "s4nd_ns.train_b32_128"]
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (b / "traffic" / f"{w['traffic']}.json").is_file()
        assert (b / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert (b / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in cells:  # every cell: setup_s, one more end-to-end, a per-layer
        assert sum(w in m.get("workloads", cells)
                   for m in bench["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "ffno2d_ns256.serve_b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_run_with_only_the_benchmark_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, the
    program cannot be imported: the run fails before any result."""
    root = make_tiny(tmp_path)
    res = subprocess.run(
        [sys.executable, str(root / "benchmark" / "run.py"), "--workload",
         "ffno2d_ns256.serve_b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=root)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_cells_on_the_card(card):
    """Each cell, briefly, on the card: correct, with its metrics."""
    for w in workloads():
        res = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", w, "--seed",
             str(SEED), "--seconds", "3", "--trace", "0"],
            capture_output=True, text=True, timeout=1200, cwd=ROOT)
        assert res.returncode == 0, res.stderr[-2000:]
        assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
