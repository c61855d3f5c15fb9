"""The port's spans (utils/tracing.py) and the serving engine's counters:
with no profiler recording no profiler op is entered, a recording profiler
changes no result, the trainer's, the engine's and the spectral weight
gradient's spans are emitted and nested as documented, and ``stats()``
counts requests, rows, padded rows and bucket misses."""

import warnings

import numpy as np
import pytest
import torch

from resolution_pde_tpu_torch.deploy import ServingEngine
from resolution_pde_tpu_torch.models import FFNO2D
from resolution_pde_tpu_torch.ops.kernels import spectral_mix
from resolution_pde_tpu_torch.train import Trainer
from resolution_pde_tpu_torch.utils import tracing

CFG = dict(in_channels=1, out_channels=1, width=6, n_layers=2, n_modes=5,
           factor=2, ff_weight_norm=True, n_ff_layers=2, layer_norm=True,
           dropout=0.0, spectral_impl="pallas2", ff_impl="fused")
GRID = (12, 16)


def _model(seed: int = 0) -> FFNO2D:
    torch.manual_seed(seed)
    return FFNO2D(**CFG)


def _batch(rows: int = 3, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((rows, 1) + GRID, generator=g),
            torch.randn((rows, 1) + GRID, generator=g))


def _weight_grad_inputs():
    """x, g and the modes of a weight gradient along W."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, *GRID, 4, generator=g)
    gy = torch.randn(2, *GRID, 3, generator=g)
    return x, gy, 5


def _profiled(fn):
    """(fn's result, [(name, start_us, end_us)] of the rpde.* spans it
    opened under a CPU profile, in order of start)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("rpde.")),
                   key=lambda sp: sp[1])
    return out, spans


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _run_train_step(model):
    trainer = Trainer(model, device="cpu")
    state = trainer.init()
    _, loss = trainer.train_step(state, *_batch())
    return [loss] + [p.detach().clone() for p in model.parameters()]


def _run_predict(model):
    eng = ServingEngine(model, device="cpu")
    eng.compile_bucket(GRID, 4)
    return [eng.predict(_batch()[0].numpy())]


def _run_weight_grad(_model_unused):
    return [spectral_mix.spectral_weight_grad(*_weight_grad_inputs(), 2,
                                              "ortho", torch.float32)]


RUNS = {"train_step": _run_train_step, "predict": _run_predict,
        "spectral_weight_grad": _run_weight_grad}


def test_span_without_a_profiler_is_the_shared_null_context():
    assert tracing.span("rpde.a") is tracing.span("rpde.b")
    with tracing.span("rpde.a"):
        pass


@pytest.mark.parametrize("run", list(RUNS))
def test_no_profiler_op_without_a_profiler(run, monkeypatch):
    """torch's own ranges (the optimizer's) are left alone: no rpde.* range
    is entered."""
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    RUNS[run](_model())
    assert not [n for n in entered if n.startswith("rpde.")]
    _, spans = _profiled(lambda: RUNS[run](_model()))
    assert {n for n, _, _ in spans} <= {n for n in entered
                                        if n.startswith("rpde.")}


@pytest.mark.parametrize("run", list(RUNS))
def test_a_recording_profiler_changes_no_result(run):
    plain = RUNS[run](_model())
    traced, spans = _profiled(lambda: RUNS[run](_model()))
    assert spans
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert torch.equal(a, b)


def test_train_step_spans_nest():
    _, spans = _profiled(lambda: _run_train_step(_model()))
    names = [n for n, _, _ in spans]
    step = spans[0]
    assert step[0] == "rpde.train.step" and names.count(step[0]) == 1
    phases = [sp for sp in spans if sp[0] != "rpde.spectral.weight_grad"]
    assert [n for n, _, _ in phases] == [
        "rpde.train.step", "rpde.train.stage", "rpde.train.forward",
        "rpde.train.backward", "rpde.train.optimizer"]
    assert all(_inside(sp, step) for sp in spans)
    backward = phases[3]
    grads = [sp for sp in spans if sp[0] == "rpde.spectral.weight_grad"]
    # two axes a layer
    assert len(grads) == 2 * CFG["n_layers"]
    assert all(_inside(sp, backward) for sp in grads)


def test_train_epoch_opens_a_step_span_a_batch():
    model = _model()
    trainer = Trainer(model, device="cpu")
    state = trainer.init()
    loader = [_batch(seed=s) for s in range(3)]
    _, spans = _profiled(lambda: trainer.train_epoch(state, loader))
    steps = [sp for sp in spans if sp[0] == "rpde.train.step"]
    stages = [sp for sp in spans if sp[0] == "rpde.train.stage"]
    assert len(steps) == 3 and len(stages) == 3
    for name in ("rpde.train.forward", "rpde.train.backward",
                 "rpde.train.optimizer"):
        own = [sp for sp in spans if sp[0] == name]
        assert len(own) == 3
        assert all(any(_inside(sp, st) for st in steps) for sp in own)


def test_evaluation_opens_no_training_span():
    trainer = Trainer(_model(), device="cpu")
    state = trainer.init()
    loader = [_batch(seed=s) for s in range(2)]
    _, spans = _profiled(lambda: (trainer.eval_step(state, *_batch()),
                                  trainer.evaluate(state, loader)))
    assert not [sp for sp in spans if sp[0].startswith("rpde.train.")]


def test_predict_spans_nest_in_order():
    eng = ServingEngine(_model(), device="cpu")
    eng.compile_bucket(GRID, 4)
    x = _batch()[0].numpy()
    _, spans = _profiled(lambda: eng.predict(x))
    assert [n for n, _, _ in spans] == [
        "rpde.serve.predict", "rpde.serve.pad", "rpde.serve.copy_in",
        "rpde.serve.replay", "rpde.serve.copy_out"]
    assert all(_inside(sp, spans[0]) for sp in spans[1:])
    children = spans[1:]
    assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))


def test_forecast_and_a_warmed_miss_open_their_spans():
    eng = ServingEngine(_model(), device="cpu")
    x = _batch(rows=2)[0].numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _, spans = _profiled(lambda: eng.forecast(x, 2))
    names = [n for n, _, _ in spans]
    assert names[0] == "rpde.serve.forecast"
    assert names[1] == "rpde.serve.warm"
    assert names[-4:] == ["rpde.serve.pad", "rpde.serve.copy_in",
                          "rpde.serve.replay", "rpde.serve.copy_out"]
    assert all(_inside(sp, spans[0]) for sp in spans[1:])


def test_predict_device_opens_its_span():
    eng = ServingEngine(_model(), device="cpu")
    eng.compile_bucket(GRID, 4)
    _, spans = _profiled(lambda: eng.predict_device(_batch()[0].numpy()))
    assert [n for n, _, _ in spans] == [
        "rpde.serve.predict", "rpde.serve.pad", "rpde.serve.copy_in",
        "rpde.serve.replay"]


def test_spectral_weight_grad_emits_its_span():
    args = _weight_grad_inputs()
    _, spans = _profiled(lambda: spectral_mix.spectral_weight_grad(
        *args, 2, "ortho", torch.float32))
    assert [n for n, _, _ in spans] == ["rpde.spectral.weight_grad"]


def test_stats_count_padding_and_misses():
    eng = ServingEngine(_model(), device="cpu")
    eng.compile_bucket(GRID, 4)
    assert eng.stats() == dict(requests=0, rows=0, padded_rows=0,
                               bucket_misses=0)
    eng.predict(_batch(rows=3)[0].numpy())
    assert eng.stats() == dict(requests=1, rows=3, padded_rows=1,
                               bucket_misses=0)
    with pytest.warns(RuntimeWarning, match="bucket miss"):
        out = eng.predict(_batch(rows=5)[0].numpy())
    assert out.shape == (5, 1) + GRID
    assert eng.stats() == dict(requests=2, rows=8, padded_rows=1,
                               bucket_misses=1)
    stats = eng.stats()
    stats["rows"] = 0
    assert eng.stats()["rows"] == 8


def test_stats_count_a_strict_refusal_as_a_miss():
    eng = ServingEngine(_model(), strict_buckets=True, device="cpu")
    eng.compile_bucket(GRID, 2)
    with pytest.raises(LookupError):
        eng.predict(np.zeros((3, 1) + GRID, np.float32))
    assert eng.stats() == dict(requests=0, rows=0, padded_rows=0,
                               bucket_misses=1)
