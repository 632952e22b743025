from .pde import (ConvectionDiffusionData, DarcyData,
                  convection_diffusion_dataset, darcy_dataset)
from .synthetic import NodeClassificationData, synthetic_cora

__all__ = ["ConvectionDiffusionData", "convection_diffusion_dataset",
           "DarcyData", "darcy_dataset",
           "NodeClassificationData", "synthetic_cora"]
