from . import euclidean

__all__ = ["euclidean"]
