from . import alphapose, normalize, transforms, windows

__all__ = ["alphapose", "normalize", "transforms", "windows"]
