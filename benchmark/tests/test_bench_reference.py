"""Each plain reference against the port's plain route at a small size on
the CPU: the forward, and one training step (loss, the gradient the
optimizer got, the parameters' change). Only this file imports both the
references and the program."""

import copy
import json

import pytest
import torch

from benchmark import program
from benchmark.reference import common, ffno2d, precision, s4nd
from benchmark.tests.conftest import ROOT

SMALL = {"ffno2d_ns256": dict(width=8, n_modes=5, n_layers=2),
         "s4nd_ns": dict(d_model=8, n_layers=2)}
# the routes compared: the port's plain f32 paths
PLAIN = {"ffno2d_ns256": dict(compute_dtype=None, spectral_impl="fft",
                              ff_impl="dense"),
         "s4nd_ns": dict(kernel_impl="jnp")}
REFS = {"ffno2d_ns256": ffno2d, "s4nd_ns": s4nd}


def _cfg(name, route_kwargs):
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      f"{name}.json").read_text())
    cfg["model"].update(SMALL[name])
    cfg["program"]["kwargs"].update(SMALL[name], **route_kwargs)
    cfg["program"].pop("routes", None)
    return cfg


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_forward_matches_the_plain_route(name):
    cfg = _cfg(name, PLAIN[name])
    ref = REFS[name]
    w = ref.make_weights(cfg, 11, "cpu")
    m = program.model(cfg, "train", w, "cpu").eval()
    x = torch.randn(3, 1, 16, 12, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert _rel(m(x).float(), ref.forward(w, x, cfg)) < 2e-6


def test_s4nd_kernel_route_matches():
    """The route served on the card (K4's plain version on the CPU)."""
    cfg = _cfg("s4nd_ns", dict(kernel_impl="pallas"))
    w = s4nd.make_weights(cfg, 12, "cpu")
    m = program.model(cfg, "serve", w, "cpu").eval()
    x = torch.randn(2, 1, 16, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert _rel(m(x), s4nd.forward(w, x, cfg)) < 2e-6


@pytest.mark.parametrize("name", sorted(SMALL))
def test_training_step_matches_the_plain_route(name):
    cfg = _cfg(name, PLAIN[name])
    ref = REFS[name]
    w = ref.make_weights(cfg, 13, "cpu")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 1, 16, 16, generator=gen)
    y = torch.randn(4, 1, 16, 16, generator=gen)
    m = program.model(cfg, "train", copy.deepcopy(w), "cpu")
    trainer, state = program.trainer(cfg, m, 0, "cpu")
    _, loss = trainer.train_step(state, x, y)
    moments = program.first_moments(state)
    after = program.parameters(state)
    got = common.train_steps(lambda ww, xx, q: ref.forward(ww, xx, cfg, q),
                             w, [(x, y)], cfg["optimizer"], 2,
                             precision.exact)
    assert abs(float(loss) - got["losses"][0]) < 2e-6 * got["losses"][0]
    beta1 = cfg["optimizer"]["betas"][0]
    for k, g in got["grads"].items():
        assert _rel(moments[k] / (1 - beta1), g) < 1e-4, k
    for k, d in got["change"].items():
        assert _rel(after[k] - w[k], d) < 1e-4, k
        assert torch.equal(got["update"][k], d), k  # one step: the same


def test_descent_gap_reads_direction():
    """An update of the wrong sign reads 2, none 1, the same 0; a norm of
    the update cannot tell the first from the reference."""
    gen = torch.Generator().manual_seed(3)
    g = {k: torch.randn(50, generator=gen) for k in "abc"}
    upd = {k: -1e-3 * torch.sign(v) for k, v in g.items()}
    keep = {k: True for k in g}
    flipped = {k: -v for k, v in upd.items()}
    zero = {k: 0 * v for k, v in upd.items()}
    assert common.descent_gap(upd, upd, g, keep) == 0.0
    assert common.descent_gap(flipped, upd, g, keep) == pytest.approx(2)
    assert common.descent_gap(zero, upd, g, keep) == pytest.approx(1)
    one = dict(upd, b=-upd["b"])  # one leaf of three flipped
    assert common.descent_gap(one, upd, g, keep) == pytest.approx(2 / 3,
                                                                  rel=0.3)
    assert common.leaf_gap(flipped, upd)[0] == 0.0
