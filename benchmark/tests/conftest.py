"""Fixtures of the benchmark's own tests: a small copy of the checkout whose
cells run on the CPU in a second or two (the configurations cut to widths
no deployment has, the traffic to 16^2 grids), and the card, for the tests
that need it.

    python -m pytest benchmark/tests -q

from the root of the checkout. These tests import neither JAX nor the JAX
package; the reference tests import the port beside the references.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"ffno2d_ns256": dict(width=8, n_modes=4, n_layers=2),
        "s4nd_ns": dict(d_model=16, n_layers=2)}


def make_tiny(dest: Path) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under ``dest`` with every
    configuration and traffic mix cut to a CPU test's size."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, cut in TINY.items():
        p = dest / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg["model"].update(cut)
        cfg["program"]["kwargs"].update(cut)
        p.write_text(json.dumps(cfg))
    for p in (dest / "benchmark" / "traffic").glob("*.json"):
        tr = json.loads(p.read_text())
        tr.update(rows=4, grid=[16, 16], check_block_rows=2, sample=4,
                  pool=4 if tr["driver"] == "train" else 3)
        p.write_text(json.dumps(tr))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def workloads() -> list:
    return [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
