from .stse import STSAE, STSE, STSVAE, build_model

__all__ = ["STSAE", "STSE", "STSVAE", "build_model"]
