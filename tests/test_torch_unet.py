"""The port's UNet1d and UNet2d against the JAX package's on the CPU (width
4, size 32: four levels down to 2 points): with BatchNorm, and UNet1d with
GroupNorm (flax's epsilon 1e-6), on the same variables carried over by
utils.jax_bridge.unet1d_state_dict / unet2d_state_dict (the transposed
convs' taps flipped): the forward in eval and in train mode, every
parameter's gradient and the running statistics after the train-mode
forward, by tests/test_torch_cno.py's ``check_against_jax`` (the same
tolerances, the train-mode references in float64); the round trip through
resolution_pde_tpu.utils.torch_import.import_unet1d/2d; the reference's
parameter names and the registry.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from resolution_pde_tpu.models.unet import UNet1d as JaxUNet1d  # noqa: E402
from resolution_pde_tpu.models.unet import UNet2d as JaxUNet2d  # noqa: E402
from resolution_pde_tpu.utils.torch_import import (import_unet1d,  # noqa: E402
                                                   import_unet2d)
from resolution_pde_tpu_torch.models import get_model  # noqa: E402
from resolution_pde_tpu_torch.models.unet import UNet1d, UNet2d  # noqa: E402
from resolution_pde_tpu_torch.utils import jax_bridge  # noqa: E402
from test_torch_cno import check_against_jax  # noqa: E402

CASES = {
    "unet1d_batchnorm": (UNet1d, JaxUNet1d, 1, False),
    "unet1d_groupnorm": (UNet1d, JaxUNet1d, 1, True),
    "unet2d_batchnorm": (UNet2d, JaxUNet2d, 2, False),
}


def _bridge(ndim):
    return (jax_bridge.unet1d_state_dict if ndim == 1
            else jax_bridge.unet2d_state_dict)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unet_matches_jax(case):
    cls, jcls, ndim, gn = CASES[case]
    model = cls(2, 1, 4, gn, generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(ndim).standard_normal(
        (3, 2) + (32,) * ndim).astype(np.float32)
    check_against_jax(jcls(2, 1, 4, gn), model, _bridge(ndim), x,
                      seed=len(case))


@pytest.mark.parametrize("ndim", [1, 2])
def test_bridge_round_trip_through_torch_import(ndim):
    cls = UNet1d if ndim == 1 else UNet2d
    imp = import_unet1d if ndim == 1 else import_unet2d
    model = cls(2, 1, 4, generator=torch.Generator().manual_seed(ndim))
    with torch.no_grad():
        for _, buf in model.named_buffers():
            buf.add_(torch.rand(buf.shape))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = _bridge(ndim)(imp(sd))
    assert set(back) == set(sd)
    for k, v in back.items():
        assert np.array_equal(v.numpy(), sd[k]), k


def test_names_and_registry():
    model = UNet2d(1, 1, 4)
    names = set(model.state_dict())
    for name in ("encoder1.enc1conv1.weight", "encoder4.enc4norm2.running_var",
                 "bottleneck.bottleneckconv2.weight", "upconv1.weight",
                 "decoder1.dec1norm1.weight", "conv.bias"):
        assert name in names, name
    assert "encoder1.enc1conv1.bias" not in names
    assert model.upconv4.weight.shape == (64, 32, 2, 2)
    gn = UNet1d(1, 1, 4, use_groupnorm=True).encoder1.enc1norm1
    assert isinstance(gn, torch.nn.GroupNorm) and gn.eps == 1e-6
    assert gn.num_groups == 4
    assert get_model("models.unet.UNet1d") is UNet1d
    assert get_model("UNet2d") is UNet2d
