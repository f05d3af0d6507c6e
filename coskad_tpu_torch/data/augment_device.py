"""Stochastic skeleton augmentations over batched [B, C, T, V] windows on
the device: the contrastive path's second, strongly augmented view.

Counterpart of `coskad_tpu/data/augment_device.py` (the same math as the
host `data/augment.py`, vectorized with per-sample randomness):
reflection-padded temporal crop, the pseudo-3D rotation (xy cycled to 3
channels, two axis rotations, xy kept), Gaussian noise, temporal Gaussian
blur with a per-sample sigma (the reference's unnormalized kernel, zero
padding), coordinate-axis masking and time flip.

Each op is split in two: `op(pose, draws)` is a function of explicit
per-sample draws, and `draw_op(generator, shape, device)` makes those draws
from a `torch.Generator`. The draws are what a caller may feed instead (the
tests feed the JAX package's own `jax.random` draws):

  crop   starts [B] int64 in [0, 2 * (T // padding_ratio)]
  rotate main_axis [B] int64 in {0, 1, 2}; big [2, B] degrees in [0, 30);
         small [2, B] degrees in [0, 1): the angle about axis a is big[a]
         where main_axis == a, else small[a]
  noise  u [B] uniform (applied where u < p); normal [B, C, T, V] N(0, 1)
  blur   u [B]; sigma [B] in sigma_range
  mask   u [B]; axis [B] int64 in {0, 1}
  flip   u [B]
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

Draws = Dict[str, torch.Tensor]


def _uniform(generator: Optional[torch.Generator], n, device, lo=0.0, hi=1.0) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=device)
    return u if (lo, hi) == (0.0, 1.0) else u * (hi - lo) + lo


def _ints(generator, n: int, hi: int, device) -> torch.Tensor:
    return torch.randint(0, hi, (n,), generator=generator, device=device)


def _apply(u: torch.Tensor, p: float) -> torch.Tensor:
    return (u < p)[:, None, None, None]


# ------------------------------------------------------------------ crop


def draw_temporal_crop(generator, shape: Sequence[int], device, padding_ratio: int = 6) -> Draws:
    pad = shape[2] // padding_ratio
    return {"starts": _ints(generator, shape[0], 2 * pad + 1, device)}


def random_temporal_crop(pose: torch.Tensor, draws: Draws, padding_ratio: int = 6
                         ) -> torch.Tensor:
    """Per-sample crop of the reflection-padded sequence."""
    b, c, t, v = pose.shape
    pad = t // padding_ratio
    padded = torch.cat([pose[:, :, :pad].flip(2), pose, pose[:, :, t - pad:].flip(2)], dim=2)
    idx = draws["starts"].long()[:, None] + torch.arange(t, device=pose.device)[None, :]
    return torch.gather(padded, 2, idx[:, None, :, None].expand(b, c, t, v))


# ---------------------------------------------------------------- rotate


def draw_rotate(generator, shape: Sequence[int], device) -> Draws:
    b = shape[0]
    return {"main_axis": _ints(generator, b, 3, device),
            "big": _uniform(generator, (2, b), device, 0.0, 30.0),
            "small": _uniform(generator, (2, b), device)}


def _rot_matrix(axis: int, angle: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 rotation about axis 0 (x) or 1 (y): [B] -> [B, 3, 3]."""
    ca, sa = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(ca), torch.ones_like(ca)
    if axis == 0:
        rows = [[ones, zeros, zeros], [zeros, ca, sa], [zeros, -sa, ca]]
    else:
        rows = [[ca, zeros, -sa], [zeros, ones, zeros], [sa, zeros, ca]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def random_rotate(pose: torch.Tensor, draws: Draws) -> torch.Tensor:
    """The reference's pseudo-3D rotation: xy cycled to 3 channels, rotated
    about axis 0 then axis 1 (by the drawn angles), xy kept after each."""
    c = pose.shape[1]
    seq = pose[:, :2].permute(0, 2, 3, 1)  # [B, T, V, 2]
    main = draws["main_axis"]
    for axis in (0, 1):
        deg = torch.where(main == axis, draws["big"][axis], draws["small"][axis])
        rot = _rot_matrix(axis, torch.deg2rad(deg)).transpose(-1, -2)  # the reference's R.T
        seq3 = torch.cat([seq, seq], dim=-1)[..., :3]
        seq = torch.einsum("btvk,bkj->btvj", seq3, rot)[..., :2]
    out = seq.permute(0, 3, 1, 2)
    if c > 2:
        out = torch.cat([out, pose[:, 2:]], dim=1)
    return out


# ----------------------------------------------------------------- noise


def draw_noise(generator, shape: Sequence[int], device) -> Draws:
    return {"u": _uniform(generator, shape[0], device),
            "normal": torch.randn(tuple(shape), generator=generator, device=device)}


def gaussian_noise(pose: torch.Tensor, draws: Draws, std: float = 0.01, p: float = 0.5
                   ) -> torch.Tensor:
    return torch.where(_apply(draws["u"], p), pose + std * draws["normal"], pose)


# ------------------------------------------------------------------ blur


def draw_blur(generator, shape: Sequence[int], device,
              sigma_range: Tuple[float, float] = (0.1, 2.0)) -> Draws:
    return {"u": _uniform(generator, shape[0], device),
            "sigma": _uniform(generator, shape[0], device, *sigma_range)}


def temporal_gaussian_blur(pose: torch.Tensor, draws: Draws, kernel: int = 15, p: float = 0.5
                           ) -> torch.Tensor:
    """Per-sample blur along T with the reference's unnormalized kernel
    exp(-k^2 / (2 sigma^2)) and zero padding."""
    t = pose.shape[2]
    radius = kernel // 2
    taps = torch.arange(-radius, radius + 1, dtype=torch.float32, device=pose.device)
    weights = torch.exp(-(taps[None, :] ** 2) / (2.0 * draws["sigma"][:, None] ** 2))  # [B, K]
    padded = torch.nn.functional.pad(pose, (0, 0, radius, radius))
    slides = torch.stack([padded[:, :, i:i + t] for i in range(kernel)], dim=0)  # [K, B, C, T, V]
    blurred = torch.einsum("bk,kbctv->bctv", weights, slides)
    return torch.where(_apply(draws["u"], p), blurred, pose)


# ------------------------------------------------------------ mask, flip


def draw_axis_mask(generator, shape: Sequence[int], device) -> Draws:
    return {"u": _uniform(generator, shape[0], device),
            "axis": _ints(generator, shape[0], 2, device)}


def axis_mask(pose: torch.Tensor, draws: Draws, p: float = 0.5) -> torch.Tensor:
    """Zero out x or y (the drawn axis) where the sample is drawn."""
    ch = torch.arange(pose.shape[1], device=pose.device)
    mask = (ch[None, :] == draws["axis"][:, None]) & (draws["u"] < p)[:, None]  # [B, C]
    return torch.where(mask[:, :, None, None], torch.zeros_like(pose), pose)


def draw_time_flip(generator, shape: Sequence[int], device) -> Draws:
    return {"u": _uniform(generator, shape[0], device)}


def random_time_flip(pose: torch.Tensor, draws: Draws, p: float = 0.5) -> torch.Tensor:
    return torch.where(_apply(draws["u"], p), pose.flip(2), pose)


# ---------------------------------------------------------------- chains


def weak_augment(pose: torch.Tensor, draws: Draws, padding_ratio: int = 6) -> torch.Tensor:
    """The reference's `_old_aug`: temporal crop only (`draw_temporal_crop`)."""
    return random_temporal_crop(pose, draws, padding_ratio)


STRONG_OPS = ("crop", "rotate", "noise", "blur", "mask", "flip")


def draw_strong_augment(generator, shape: Sequence[int], device, padding_ratio: int = 6
                        ) -> Dict[str, Draws]:
    """Every draw of `strong_augment`, keyed by op (STRONG_OPS)."""
    return {"crop": draw_temporal_crop(generator, shape, device, padding_ratio),
            "rotate": draw_rotate(generator, shape, device),
            "noise": draw_noise(generator, shape, device),
            "blur": draw_blur(generator, shape, device),
            "mask": draw_axis_mask(generator, shape, device),
            "flip": draw_time_flip(generator, shape, device)}


def strong_augment(pose: torch.Tensor, draws: Dict[str, Draws], padding_ratio: int = 6
                   ) -> torch.Tensor:
    """The reference's `_old_strong_aug` chain: crop, rotate, noise, blur,
    axis mask, time flip."""
    out = random_temporal_crop(pose, draws["crop"], padding_ratio)
    out = random_rotate(out, draws["rotate"])
    out = gaussian_noise(out, draws["noise"])
    out = temporal_gaussian_blur(out, draws["blur"])
    out = axis_mask(out, draws["mask"])
    return random_time_flip(out, draws["flip"])
