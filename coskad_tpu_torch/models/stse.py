"""STSE: the encoder-only COSKAD model (PyTorch).

Counterpart of `coskad_tpu/models/stse.py::STSE` with the `sts_gcn` encoder
and the linear or the MLP projector. I/O is the reference's NCTV layout
[B, C, T, V]; the projector reads the hidden state flattened in (T, V, C)
order.

The eval forward takes one of two routes by the input's device:
  * CUDA: the fused encoder kernel (`kernels/stse_fused.py`) on weights
    folded once and cached until a parameter or buffer changes, then the
    projector module (the linear one is one matmul, the MLP one runs in
    eval mode); the kernel has no backward, so this route raises where
    autograd would record it (`eval_uses_kernel`);
  * CPU: the plain module path, layer by layer.
The train forward (`train=True`) is the module path with live BatchNorm,
which updates the running statistics in place (see `stsgcn.py`), or with
running statistics under `frozen_bn`. The MLP head's BatchNorm is live in
every train forward, `frozen_bn` or not: the JAX model passes the head
`train` alone. The ghost-BN train path through the K2-K4 kernels is
`kernels/stse_train.py::fused_stse_apply` (linear projector only).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..kernels import stse_fused
from .stsgcn import _DROPOUT, Dense, MLPHead, STSGCNStack


def eval_uses_kernel(on_cuda: bool, tensors: Iterable[torch.Tensor]) -> bool:
    """The eval forward's route: True for K1 (x on the card), False for the
    plain module path (x on the CPU). K1 folds detached weights and writes a
    fresh tensor, so its latent carries no gradient; on the card, a call
    that autograd would record (grad mode on and x or a parameter requiring
    grad) raises rather than return a latent cut from the graph."""
    if not on_cuda:
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "STSE.forward(train=False) on a CUDA tensor runs the eval kernel, which has no "
            "backward: call it under torch.no_grad() or torch.inference_mode(), or use "
            "STSE.encode for a differentiable latent")
    return True


class LinearProjector(Dense):
    """Dense over the hidden state flattened in (T, V, C) order:
    kernel [T*V*C, latent], bias [latent]."""

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return super().forward(h.reshape(h.shape[0], -1))


class STSE(nn.Module):
    """Space-Time-Separable Graph Convolutional Encoder.

    forward: [B, C_in, T, V] -> latent [B, latent_dim]."""

    def __init__(
        self,
        input_dim: int = 2,
        layer_channels: Sequence[int] = (32, 16, 32),
        hidden_dimension: int = 64,
        latent_dim: int = 16,
        n_frames: int = 12,
        n_joints: int = 17,
        encoder_type: str = "sts_gcn",
        projector: str = "linear",
        projector_hidden_layers: Optional[Sequence[int]] = None,
        dropout: float = 0.0,
        use_bias: bool = True,
    ):
        super().__init__()
        if encoder_type.lower() != "sts_gcn":
            raise NotImplementedError(
                f"encoder {encoder_type!r} is not ported yet (ROADMAP.md, Queue 1 item 3)")
        self.encoder = STSGCNStack(
            input_dim, list(layer_channels) + [hidden_dimension], n_frames,
            n_joints, use_bias)
        flat = hidden_dimension * n_frames * n_joints
        proj = projector.lower()
        if proj == "linear":
            self.btlnk = LinearProjector(flat, latent_dim, use_bias)
        elif proj == "mlp":
            self.btlnk = MLPHead(flat, list(projector_hidden_layers or [latent_dim]),
                                 latent_dim, use_bias)
        else:
            raise ValueError(f"Unsupported projector {projector!r}")
        self.dropout = dropout
        self._fold_cache: Optional[Tuple[tuple, stse_fused.FoldedSTSE,
                                         stse_fused.PackedSTSE]] = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-draw every parameter (torch-default inits, as the JAX package
        uses) from `generator`, in module order; BN statistics reset."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def encode(self, x: torch.Tensor, train: bool = False,
               frozen_bn: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Plain path: [B, C, T, V] -> (latent [B, D], hidden [B, T, V, H])."""
        if train and self.dropout > 0:
            raise NotImplementedError(_DROPOUT)
        h = self.encoder(x.permute(0, 2, 3, 1), train=train, frozen_bn=frozen_bn)
        return self._project(h, train), h

    def _project(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        """The projector on the hidden state ([B, T, V, C] or [B, T*V, C])."""
        if isinstance(self.btlnk, MLPHead):
            return self.btlnk(h.reshape(h.shape[0], -1), train=train)
        return self.btlnk(h)

    def folded(self) -> Tuple[stse_fused.FoldedSTSE, stse_fused.PackedSTSE]:
        """The kernel's folded and packed weights, rebuilt only when a
        parameter or buffer was replaced or modified in place."""
        state = self.state_dict(keep_vars=True)
        key = tuple((t.data_ptr(), t._version) for t in state.values())
        if self._fold_cache is None or self._fold_cache[0] != key:
            with torch.no_grad():
                folded = stse_fused.fold_stse_params(
                    {k: t.detach() for k, t in state.items()})
                self._fold_cache = (key, folded, stse_fused.pack_folded(folded))
        return self._fold_cache[1], self._fold_cache[2]

    def forward(self, x: torch.Tensor, train: bool = False,
                frozen_bn: bool = False) -> torch.Tensor:
        if train:
            return self.encode(x, train=True, frozen_bn=frozen_bn)[0]
        if eval_uses_kernel(x.is_cuda, [x, *self.parameters()]):
            folded, packed = self.folded()
            return self._project(stse_fused.fused_stse_hidden(x.contiguous(), folded, packed),
                                 train=False)
        return self.encode(x)[0]


def build_model(use_decoder: bool = False, use_vae: bool = False, **kwargs) -> STSE:
    """Variant factory: the encoder-only variants (euclidean static /
    dynamic, hyperbolic) share STSE. The decoder variants are not ported
    yet."""
    if use_decoder or use_vae:
        raise NotImplementedError(
            "the autoencoder and VAE variants are not ported yet "
            "(ROADMAP.md, Queue 1 item 3)")
    for k in ("distribution", "kappa_floor", "decoder_channels"):
        kwargs.pop(k, None)
    return STSE(**kwargs)
