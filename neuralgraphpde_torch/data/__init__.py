from .pde import ConvectionDiffusionData, convection_diffusion_dataset
from .synthetic import NodeClassificationData, synthetic_cora

__all__ = ["ConvectionDiffusionData", "convection_diffusion_dataset",
           "NodeClassificationData", "synthetic_cora"]
