from . import aggregate, auc, frames, masks, smoothing

__all__ = ["aggregate", "auc", "frames", "masks", "smoothing"]
