from . import euclidean, poincare, sphere

__all__ = ["euclidean", "poincare", "sphere"]
