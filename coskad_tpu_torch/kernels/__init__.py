from .stse_fused import (
    fold_stse_params,
    fused_stse_forward,
    fused_stse_forward_reference,
    fused_stse_hidden,
)

__all__ = [
    "fold_stse_params",
    "fused_stse_forward",
    "fused_stse_forward_reference",
    "fused_stse_hidden",
]
