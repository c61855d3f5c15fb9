"""The port's config loader (configs/) against the JAX package's: every
model, dataset and training yaml file composes to an equal dict, override
strings parse to the same values, ``instantiate_model`` builds FFNO2D with
the kwargs the JAX loader gives its model, an unported ``_target_``
raises a KeyError that names its ROADMAP item, and the active-matter
factories build from arrays held in memory.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from resolution_pde_tpu import configs as jcfg  # noqa: E402
from resolution_pde_tpu_torch import configs as tcfg  # noqa: E402
from resolution_pde_tpu_torch.models import FFNO2D  # noqa: E402


def _names(group):
    return sorted(f[:-5] for f in os.listdir(os.path.join(tcfg.CONF_DIR,
                                                          group))
                  if f.endswith(".yaml"))


def test_reads_the_jax_package_yaml_files():
    assert tcfg.CONF_DIR == os.path.dirname(os.path.abspath(jcfg.__file__))
    assert len(_names("model")) >= 10 and len(_names("dataset")) >= 20


@pytest.mark.parametrize("group", ["model", "dataset", "training"])
def test_every_yaml_file_loads_equal(group):
    for name in _names(group):
        kw = {group: name}
        got, want = tcfg.load_config(**kw), jcfg.load_config(**kw)
        assert got == want, name
        assert type(got.model) is tcfg.Config


OVERRIDES = [
    "training.learning_rate=1e-3", "training.weight_decay=1.0e-4",
    "model.dropout=0", "model.compute_dtype=bfloat16",
    "model.approx_gelu=true", "training.epochs=3", "dataset.add_res=[64,128]",
    "dataset.dataset_params.file_map={256: ns_256_1e-03.h5}",
    "training.resume_from=checkpoints/ffno2d/ns_local",
    "dataset.dataset_params.saved_folder=/data/ns", "training.eta_min=1e-5",
    "new.nested.key=null", "model.layer_norm=False",
]


def test_parse_cli_matches():
    argv = ["model=ffno_2d", "dataset=ns_naive_true_mres1"] + OVERRIDES
    got, want = tcfg.parse_cli(argv), jcfg.parse_cli(argv)
    assert got == want
    assert got.training.learning_rate == 1e-3
    assert got.model.dropout == 0 and got.model.approx_gelu is True
    assert got.dataset.add_res == [64, 128]
    assert got.project_name == "ns_ffno_2d"
    for bad in (["model"], ["training.epochs"]):
        with pytest.raises(ValueError):
            tcfg.parse_cli(bad)
        with pytest.raises(ValueError):
            jcfg.parse_cli(bad)


@pytest.mark.parametrize("extra", [[], ["model.compute_dtype=bfloat16",
                                        "model.spectral_impl=pallas2",
                                        "model.ff_impl=fused",
                                        "model.approx_gelu=true",
                                        "model.dropout=0"]])
def test_instantiate_model_passes_the_jax_kwargs(extra):
    argv = ["model=ffno_2d", "dataset=ns_naive", "model.width=8",
            "model.n_modes=4"] + extra
    tc, jc = tcfg.parse_cli(argv), jcfg.parse_cli(argv)
    cls, kwargs = tcfg.model_kwargs(tc.model)
    jmodel = jcfg.instantiate_model(jc.model)
    assert cls is FFNO2D
    assert set(kwargs) == set(jc.model) - {"_target_"}
    for k, v in kwargs.items():
        want = getattr(jmodel, k)
        if k == "compute_dtype":
            assert v is torch.bfloat16 and str(want) == "bfloat16"
        else:
            assert v == want, k
    a = tcfg.instantiate_model(tc.model, seed=3)
    b = tcfg.instantiate_model(tc.model, seed=3)
    c = tcfg.instantiate_model(tc.model, seed=4)
    assert isinstance(a, FFNO2D) and a.compute_dtype == kwargs.get(
        "compute_dtype")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)


@pytest.mark.parametrize("target,item", [
    ("dataloaders.ns_s4.ns_window_dataset", 5),
    ("ns_window_dataset", 5),
])
def test_unported_dataset_factory_raises(target, item):
    with pytest.raises(KeyError, match=f"ROADMAP.md section 1, item {item}"):
        tcfg.instantiate_dataset({"_target_": target})
    with pytest.raises(KeyError, match="unknown dataset factory"):
        tcfg.instantiate_dataset({"_target_": "no_such_dataset"})


@pytest.mark.parametrize("target,kw", [
    ("active_matter_markov_dataset", dict(filename="active_matter_0.hdf5")),
    ("dataloaders.active_matter_all_markov."
     "multi_file_active_matter_markov_dataset",
     dict(file_pattern="active_matter_*.hdf5")),
    ("dataloaders.active_matter_markov.active_matter_markov_dataset",
     dict(filename="active_matter_1.hdf5")),
])
def test_active_matter_factory_builds(target, kw, tmp_path):
    """The active-matter factories (ported with CNO) build from arrays
    held as the Well's files (cli.generate_data.active_in_memory)."""
    from resolution_pde_tpu_torch.cli.generate_data import active_in_memory

    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((b, 4, 8, 8)).astype(np.float32)
              for b in (5, 5)]
    with active_in_memory(str(tmp_path), arrays):
        out = tcfg.instantiate_dataset({"_target_": target,
                                        "saved_folder": str(tmp_path), **kw})
    train = out[0]
    assert train.x.shape[1:] == (1, 8, 8) and len(train.x) > 0
    assert np.isfinite(train.x).all()


@pytest.mark.parametrize("target", [
    "point_cloud_markov_dataset", "dataloaders.dgl_data.FNODataset"])
def test_point_cloud_factory_builds_from_arrays_in_memory(target, tmp_path):
    """The GNOT point-cloud factory (ported with the transformer
    operators) builds from NS arrays held as a file
    (data.io.files_in_memory): [features | positions] node rows."""
    from resolution_pde_tpu_torch.data.io import files_in_memory

    u = np.random.default_rng(0).standard_normal((5, 4, 8, 8)).astype(
        np.float32)
    path = str(tmp_path / "ns_64_demo.h5")
    with files_in_memory({path: u}):
        out = tcfg.instantiate_dataset({"_target_": target,
                                        "filename": "ns_64_demo.h5",
                                        "saved_folder": str(tmp_path),
                                        "data_normalizer": False})
    train, rollout = out[0], out[3]
    assert train.x.shape[1:] == (64, 3) and train.y.shape[1:] == (64, 1)
    assert len(out[0]) + len(out[1]) + len(out[2]) == 5 * 3
    assert rollout is None and np.isfinite(train.x).all()
    # unencoded: the positions span the unit square
    np.testing.assert_array_equal(train.x[0, :, 1:].min(0), [0, 0])
    np.testing.assert_array_equal(train.x[0, :, 1:].max(0), [1, 1])


def test_every_jax_factory_is_ported_or_queued():
    for name in jcfg.DATASET_FACTORIES:
        target = tcfg.ALIASES.get(name, name)
        short = target.rsplit(".", 1)[-1]
        assert (target in tcfg.NOT_PORTED or short in tcfg.NOT_PORTED
                or tcfg.dataset_factory(name) is not None), name


def test_ns_aliases_resolve_to_the_port_factories():
    from resolution_pde_tpu_torch.data import factories

    for target in ("ns_markov_dataset",
                   "dataloaders.ns_naive_markov.ns_markov_dataset",
                   "dataloaders.ns_resize_old_markov.ns_markov_dataset"):
        assert tcfg.dataset_factory(target) is factories.ns_markov_dataset
    assert (tcfg.dataset_factory(
        "dataloaders.ns_naive_true_multires.ns_true_multires_markov_dataset")
        is factories.ns_true_multires_markov_dataset)
