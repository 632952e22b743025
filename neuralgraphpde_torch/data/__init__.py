from .loaders import cora_dataset, load_cora
from .pde import (BurgersData, ConvectionDiffusionData, DarcyData,
                  burgers_dataset, convection_diffusion_dataset,
                  darcy_dataset)
from .synthetic import NodeClassificationData, synthetic_cora

__all__ = ["BurgersData", "burgers_dataset", "ConvectionDiffusionData",
           "convection_diffusion_dataset",
           "DarcyData", "darcy_dataset",
           "NodeClassificationData", "synthetic_cora", "cora_dataset",
           "load_cora"]
