from .stse import STSE, build_model

__all__ = ["STSE", "build_model"]
