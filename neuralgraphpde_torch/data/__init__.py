from .synthetic import NodeClassificationData, synthetic_cora

__all__ = ["NodeClassificationData", "synthetic_cora"]
