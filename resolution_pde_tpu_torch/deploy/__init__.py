"""Serving."""

from resolution_pde_tpu_torch.deploy.serving import ServingEngine

__all__ = ["ServingEngine"]
