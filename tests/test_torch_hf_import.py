"""The port's HF SwinV2 / ScOT state-dict import
(resolution_pde_tpu_torch/utils/torch_import.py) against ``transformers``
and against the JAX package's import on the CPU.

A seeded random ``Swinv2Layer`` (every parameter perturbed from its init)
goes through ``swinv2_block_params_from_sd`` into the port's
``Swinv2Block``, whose forward must match the HF layer's within 1e-5 (max
abs over max abs), unshifted and shifted; ``import_scot_encoder`` of a
small ``Swinv2Model``'s state dict must equal, tensor for tensor, JAX's
``import_scot_encoder`` of the same dict carried into the port's names by
``utils.jax_bridge.scot2d_state_dict``; a missing key raises a KeyError
that names it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402
from transformers.models.swinv2.modeling_swinv2 import (  # noqa: E402
    Swinv2Config, Swinv2Layer, Swinv2Model)

from resolution_pde_tpu.models import poseidon as jpos  # noqa: E402
from resolution_pde_tpu.utils import torch_import as jimport  # noqa: E402
from resolution_pde_tpu_torch.models.poseidon import Swinv2Block  # noqa: E402
from resolution_pde_tpu_torch.utils import jax_bridge  # noqa: E402
from resolution_pde_tpu_torch.utils.torch_import import (  # noqa: E402
    import_scot_encoder, swinv2_block_params_from_sd)


def _perturb(module, seed):
    """Every parameter moved off its init by a seeded 0.1 N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return module


@pytest.mark.parametrize("shift", [0, 2])
def test_swinv2_layer_through_the_importer_matches_transformers(shift):
    dim, heads, ws, h, w = 16, 4, 4, 8, 8
    cfg = Swinv2Config(embed_dim=dim, window_size=ws, qkv_bias=True,
                       mlp_ratio=4.0, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0, hidden_act="gelu",
                       layer_norm_eps=1e-5)
    torch.manual_seed(shift)
    ref = _perturb(Swinv2Layer(cfg, dim=dim, input_resolution=(h, w),
                               num_heads=heads, shift_size=shift),
                   seed=10 + shift).eval()
    sd = {f"layer.{k}": v for k, v in ref.state_dict().items()}
    block = Swinv2Block(dim, heads, ws, shift=shift, use_conditioning=False)
    block.load_state_dict(swinv2_block_params_from_sd(sd, "layer"))
    block.eval()
    x = torch.from_numpy(np.random.default_rng(shift).standard_normal(
        (2, h * w, dim)).astype(np.float32))
    with torch.no_grad():
        want = ref(x, (h, w))[0]
        got = block(x.reshape(2, h, w, dim), None).reshape(2, h * w, dim)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err


SCOT = dict(num_channels=1, num_out_channels=1, patch_size=2, embed_dim=8,
            depths=(2, 2), num_heads=(2, 2), skip_connections=(1, 0),
            window_size=4)


def _hf_encoder_sd():
    cfg = Swinv2Config(image_size=16, patch_size=2, num_channels=1,
                       embed_dim=8, depths=[2, 2], num_heads=[2, 2],
                       window_size=4)
    torch.manual_seed(0)
    model = _perturb(Swinv2Model(cfg), seed=3)
    return {f"swinv2.{k}": v for k, v in model.state_dict().items()}


def test_import_scot_encoder_equals_jax_import():
    sd = _hf_encoder_sd()
    got = import_scot_encoder(sd, SCOT["depths"])
    # JAX's import into a whole ScOT2d tree, carried to the port's names
    shapes = jax.eval_shape(jpos.ScOT2d(**SCOT).init, jax.random.key(0),
                            jnp.zeros((1, 1, 16, 16)), 1.0)["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    shapes)
    params.update(jimport.import_scot_encoder(
        {k: v.numpy() for k, v in sd.items()}, SCOT["depths"]))
    want = jax_bridge.scot2d_state_dict(params)
    assert {"merge.0.reduction.weight", "encoder.1.1.attention.query.weight",
            "patch_embed.weight"} <= set(got)
    assert "merge.1.reduction.weight" not in got  # the last stage: none
    for k, v in got.items():
        assert k in want, k
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_missing_keys_raise_and_are_listed():
    sd = _hf_encoder_sd()
    del sd["swinv2.embeddings.norm.bias"]
    del sd["swinv2.encoder.layers.1.blocks.0.output.dense.weight"]
    with pytest.raises(KeyError) as err:
        import_scot_encoder(sd, SCOT["depths"])
    assert "swinv2.embeddings.norm.bias" in str(err.value)
    assert "swinv2.encoder.layers.1.blocks.0.output.dense.weight" \
        in str(err.value)
    with pytest.raises(KeyError, match="logit_scale"):
        swinv2_block_params_from_sd(
            {k: v for k, v in sd.items() if "logit_scale" not in k},
            "swinv2.encoder.layers.0.blocks.0")
