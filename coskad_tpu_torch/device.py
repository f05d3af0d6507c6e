"""Device selection: the port runs on CUDA unless the caller asks for the CPU.
In a process group (`parallel/mesh.py`) 'cuda' is the rank's own card."""

from __future__ import annotations

from typing import Union

import torch

from .parallel import mesh


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """torch.device for `device`; raises rather than falling back to the CPU
    when CUDA is asked for and missing. A bare 'cuda' in a process group
    is cuda:<the rank's device index>."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: coskad_tpu_torch runs on the GPU by default. "
            "Pass device='cpu' to run the plain PyTorch path on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    local = mesh.layout().local_device
    if dev.type == "cuda" and dev.index is None and local is not None:
        return torch.device("cuda", local)
    return dev
