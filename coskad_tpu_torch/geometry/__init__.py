from . import euclidean, poincare

__all__ = ["euclidean", "poincare"]
