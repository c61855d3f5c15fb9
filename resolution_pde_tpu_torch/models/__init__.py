"""Neural-operator models of the port."""

from resolution_pde_tpu_torch.models.ffno import (FFNO1D, FFNO2D,
                                                  FSpectralConv1d,
                                                  FSpectralConv2d)
from resolution_pde_tpu_torch.models.fno import FNO1d, FNO2d
from resolution_pde_tpu_torch.models.registry import get_model, unwrap_output
from resolution_pde_tpu_torch.models.s4 import (DPLRKernelLayer, FFTConvLayer,
                                                S4D, S4Block,
                                                S4DKernelLayer, S4Model)

__all__ = ["DPLRKernelLayer", "FFNO1D", "FFNO2D", "FFTConvLayer",
           "FNO1d", "FNO2d", "FSpectralConv1d", "FSpectralConv2d",
           "S4Block", "S4D", "S4DKernelLayer", "S4Model", "get_model",
           "unwrap_output"]
