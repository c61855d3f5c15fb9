"""Neural-operator models of the port."""

from resolution_pde_tpu_torch.models.ffno import FFNO2D, FSpectralConv2d
from resolution_pde_tpu_torch.models.registry import get_model, unwrap_output

__all__ = ["FFNO2D", "FSpectralConv2d", "get_model", "unwrap_output"]
