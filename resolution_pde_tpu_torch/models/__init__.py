"""Neural-operator models of the port."""

from resolution_pde_tpu_torch.models.cno import CNO1d, CNO2d
from resolution_pde_tpu_torch.models.cno_original import CNO2dOriginal
from resolution_pde_tpu_torch.models.ffno import (FFNO1D, FFNO2D,
                                                  FSpectralConv1d,
                                                  FSpectralConv2d)
from resolution_pde_tpu_torch.models.fno import FNO1d, FNO2d
from resolution_pde_tpu_torch.models.mgpt import GNOTOperator, MoEGPTNO
from resolution_pde_tpu_torch.models.poseidon import ScOT2d, SwinOperator2d
from resolution_pde_tpu_torch.models.registry import get_model, unwrap_output
from resolution_pde_tpu_torch.models.s4 import (DPLRKernelLayer, FFTConvLayer,
                                                S4D, S4Block,
                                                S4DKernelLayer, S4Model)
from resolution_pde_tpu_torch.models.unet import UNet1d, UNet2d

__all__ = ["CNO1d", "CNO2d", "CNO2dOriginal", "DPLRKernelLayer", "FFNO1D",
           "FFNO2D", "FFTConvLayer", "FNO1d", "FNO2d", "FSpectralConv1d",
           "FSpectralConv2d", "GNOTOperator", "MoEGPTNO", "S4Block", "S4D",
           "S4DKernelLayer", "S4Model", "ScOT2d", "SwinOperator2d", "UNet1d",
           "UNet2d", "get_model", "unwrap_output"]
