"""The port's active-matter factories against the JAX package's, on files
in the Well's layout that the port writes here
(cli.generate_data.write_active: three active_matter_{i}.hdf5 files of
4, 3 and 3 trajectories x 6 frames at 16², a concentration field and,
for the multi-channel case, a second one written beside it): each
factory with strides, an FFT resize, minmax and simple normalisation, and
without; the arrays held in memory (cli.generate_data.active_in_memory,
the glob included) give what the files give; the ns_active_t2 yaml
builds through the port as through JAX. Compared with
tests/test_torch_burgers_darcy_data.py's ``_check``: every split's
arrays, the rollout set and the normalizer statistics; exact where no FFT
or encoding is involved, else 1e-4 relative (atol 1e-5), the statistics
within 1e-6.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

from resolution_pde_tpu import configs as jcfg  # noqa: E402
from resolution_pde_tpu.data import factories as jfac  # noqa: E402
from resolution_pde_tpu_torch import configs as tcfg  # noqa: E402
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.cli import generate_data as tgen  # noqa: E402
from resolution_pde_tpu_torch.data import factories as tfac  # noqa: E402
from resolution_pde_tpu_torch.datagen.writers import (  # noqa: E402
    write_well_file)
from test_torch_burgers_darcy_data import _check  # noqa: E402


def _fields(b, seed, t=6, n=16):
    """Smooth periodic fields drifting a frame."""
    rng = np.random.default_rng(seed)
    f = np.fft.rfft2(rng.standard_normal((b, n, n)))
    f[:, 4:-4, :] = 0
    f[:, :, 4:] = 0
    base = np.fft.irfft2(f, s=(n, n))
    return np.stack([np.roll(base, i, axis=-1) for i in range(t)],
                    axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def arrays():
    return [_fields(b, i) for i, b in enumerate((4, 3, 3))]


@pytest.fixture(scope="module")
def well_dir(tmp_path_factory, arrays):
    d = tmp_path_factory.mktemp("well")
    tgen.write_active(str(d), arrays)
    # a second field beside the concentration, for the multi-channel case
    write_well_file(str(d / "two_fields.hdf5"), {
        "concentration": arrays[0], "D": 2.0 * arrays[0] + 1.0})
    return d


CASES = {
    "single_file": ("active_matter_markov_dataset",
                    dict(filename="active_matter_0.hdf5",
                         reduced_resolution_t=2), True),
    "single_file_two_fields_resized": (
        "active_matter_markov_dataset",
        dict(filename="two_fields.hdf5", fields=("concentration", "D"),
             s=8, normalization_type="minmax"), False),
    "all_files": ("active_matter_all_markov_dataset",
                  dict(pattern="active_matter_*.hdf5", reduced_resolution=2,
                       data_normalizer=False), True),
    "all_files_capped": ("active_matter_all_markov_dataset",
                         dict(pattern="active_matter_*.hdf5", max_files=2,
                              num_samples_max=5), True),
    "multi_file_minmax": ("multi_file_active_matter_markov_dataset",
                          dict(file_pattern="active_matter_*.hdf5",
                               reduced_resolution_t=2, s=16), False),
    "multi_file_simple": ("multi_file_active_matter_markov_dataset",
                          dict(file_pattern="active_matter_*.hdf5",
                               normalization_type="simple",
                               reduced_batch=2), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_factory_matches_jax(well_dir, case):
    name, kw, exact = CASES[case]
    got = getattr(tfac, name)(saved_folder=str(well_dir), **kw)
    want = getattr(jfac, name)(saved_folder=str(well_dir), **kw)
    _check(got, want, exact)


@pytest.mark.parametrize("name,kw", [
    ("multi_file_active_matter_markov_dataset",
     dict(file_pattern="active_matter_*.hdf5", reduced_resolution_t=2)),
    ("active_matter_markov_dataset", dict(filename="active_matter_1.hdf5"))])
def test_in_memory_equals_files(well_dir, arrays, tmp_path, name, kw):
    want = getattr(tfac, name)(saved_folder=str(well_dir), **kw)
    with tgen.active_in_memory(str(tmp_path / "held"), arrays):
        got = getattr(tfac, name)(saved_folder=str(tmp_path / "held"), **kw)
    _check(got, want, True)
    with pytest.raises(FileNotFoundError):
        getattr(tfac, name)(saved_folder=str(tmp_path / "held"), **kw)


def test_ns_active_yaml_builds_as_in_jax(well_dir):
    over = [f"dataset.dataset_params.saved_folder={well_dir}",
            "dataset.dataset_params.s=16"]
    tc = tcfg.load_config("ffno_2d", "ns_active_t2", overrides=over)
    jc = jcfg.load_config("ffno_2d", "ns_active_t2", overrides=over)
    got = tcfg.instantiate_dataset(tc.dataset.dataset_params)
    want = jcfg.instantiate_dataset(jc.dataset.dataset_params)
    _check(got, want, False)
    bundle = common.unpack_data(got, "minmax")
    assert bundle["x_normalizer"] is not None
    # 10 trajectories of 3 frames (t strided by 2), the NS pairing from
    # the second frame: 10 pairs, 8 of them train; 1 channel
    assert bundle["train"].x.shape == (8, 1, 16, 16)
    assert bundle["rollout"].u.shape == (1, 3, 1, 16, 16)
