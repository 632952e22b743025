from .grand import grand_model

__all__ = ["grand_model"]
