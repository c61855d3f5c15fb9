"""Neural-operator models of the port."""

from resolution_pde_tpu_torch.models.cno import CNO1d, CNO2d
from resolution_pde_tpu_torch.models.cno_original import CNO2dOriginal
from resolution_pde_tpu_torch.models.ffno import (FFNO1D, FFNO2D,
                                                  FSpectralConv1d,
                                                  FSpectralConv2d)
from resolution_pde_tpu_torch.models.fno import FNO1d, FNO2d
from resolution_pde_tpu_torch.models.registry import get_model, unwrap_output
from resolution_pde_tpu_torch.models.s4 import (DPLRKernelLayer, FFTConvLayer,
                                                S4D, S4Block,
                                                S4DKernelLayer, S4Model)
from resolution_pde_tpu_torch.models.unet import UNet1d, UNet2d

__all__ = ["CNO1d", "CNO2d", "CNO2dOriginal", "DPLRKernelLayer", "FFNO1D",
           "FFNO2D", "FFTConvLayer", "FNO1d", "FNO2d", "FSpectralConv1d",
           "FSpectralConv2d", "S4Block", "S4D", "S4DKernelLayer", "S4Model",
           "UNet1d", "UNet2d", "get_model", "unwrap_output"]
