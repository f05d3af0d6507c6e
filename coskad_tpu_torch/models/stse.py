"""STSE: the encoder-only COSKAD model (PyTorch).

Counterpart of `coskad_tpu/models/stse.py::STSE` with the `sts_gcn` encoder
and the linear or the MLP projector. I/O is the reference's NCTV layout
[B, C, T, V]; the projector reads the hidden state flattened in (T, V, C)
order.

The eval forward takes one of two routes (`eval_uses_kernel`):
  * the fused encoder kernel K1 (`kernels/stse_fused.py`), for an input on
    the card, compute dtype float32 and a layout K1's planner takes
    (`STSE.kernel_takes`): weights folded once and cached until a parameter
    or buffer changes, then the projector module (the linear one is one
    matmul, the MLP one runs in eval mode); the kernel has no backward, so
    this route raises where autograd would record it;
  * the module path, layer by layer, everywhere else: on the CPU, at bf16
    (as JAX's eval is XLA over its modules; its K1 is float32 only), and on
    the card for a layout K1 refuses (more than 8 layers, more than 64
    channels a layer, activations past a block's shared memory).
The train forward (`train=True`) is the module path with live BatchNorm,
which updates the running statistics in place (see `stsgcn.py`), or with
running statistics under `frozen_bn`. The MLP head's BatchNorm is live in
every train forward, `frozen_bn` or not: the JAX model passes the head
`train` alone. The ghost-BN train path through the K2-K4 kernels is
`kernels/stse_train.py::fused_stse_apply` (linear projector only).

`dtype` is the JAX model's compute dtype (`models/stsgcn.py`): the encoder
and the linear projector round where JAX casts, the latent is float32; the
MLP head is built without it, as in JAX, and computes in float32 on the
encoder's float32 output.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..kernels import stse_fused
from .stsgcn import _DROPOUT, Dense, MLPHead, STSGCNStack


def eval_uses_kernel(for_kernel: bool, tensors: Iterable[torch.Tensor]) -> bool:
    """The eval forward's route: True for K1 (`for_kernel`: x on the card
    and a model K1 takes, `STSE.kernel_takes`), False for the module path (x
    on the CPU, or a compute dtype or layout K1 does not take). K1 folds
    detached weights and writes a fresh tensor, so its latent carries no
    gradient; a call bound for K1 that autograd would record (grad mode on
    and x or a parameter requiring grad) raises rather than return a latent
    cut from the graph. The module path stays differentiable."""
    if not for_kernel:
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "STSE.forward(train=False) on a CUDA tensor runs the eval kernel, which has no "
            "backward: call it under torch.no_grad() or torch.inference_mode(), or use "
            "STSE.encode for a differentiable latent")
    return True


class LinearProjector(Dense):
    """Dense over the hidden state flattened in (T, V, C) order:
    kernel [T*V*C, latent], bias [latent]; at a bf16 dtype rounded as
    `Dense` (JAX's `LinearProjector` dot without a preferred type)."""

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
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype} is neither float32 nor bfloat16")
        self.dtype = dtype
        if encoder_type.lower() != "sts_gcn":
            raise NotImplementedError(
                f"encoder {encoder_type!r} is not ported yet (ROADMAP.md, Queue 1 item 3c)")
        self.encoder = STSGCNStack(
            input_dim, list(layer_channels) + [hidden_dimension], n_frames,
            n_joints, use_bias, dtype)
        flat = hidden_dimension * n_frames * n_joints
        proj = projector.lower()
        if proj == "linear":
            self.btlnk = LinearProjector(flat, latent_dim, use_bias, dtype)
        elif proj == "mlp":
            self.btlnk = MLPHead(flat, list(projector_hidden_layers or [latent_dim]),
                                 latent_dim, use_bias)
        else:
            raise ValueError(f"Unsupported projector {projector!r}")
        self.dropout = dropout
        self._fold_cache: Optional[Tuple[tuple, stse_fused.FoldedSTSE,
                                         stse_fused.PackedSTSE]] = None
        self._kernel_takes: Optional[bool] = None

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
        """The projector on the hidden state ([B, T, V, C] or [B, T*V, C]).
        Its rounding points hold the latent in float32 at any dtype."""
        if isinstance(self.btlnk, MLPHead):
            return self.btlnk(h.reshape(h.shape[0], -1), train=train)
        return self.btlnk(h)

    def kernel_takes(self) -> bool:
        """Whether the eval forward on the card runs K1: compute dtype
        float32 and a layout K1's planner takes (`stse_fused.takes`, asked
        once; the layout is fixed at construction). K1 has no bf16 form, and
        JAX's bf16 eval is XLA over its modules."""
        if self._kernel_takes is None:
            self._kernel_takes = (self.dtype == torch.float32
                                  and stse_fused.takes(self.folded()[1]))
        return self._kernel_takes

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
        if eval_uses_kernel(x.is_cuda and self.kernel_takes(), [x, *self.parameters()]):
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
            "(ROADMAP.md, Queue 1 item 3a)")
    for k in ("distribution", "kappa_floor", "decoder_channels"):
        kwargs.pop(k, None)
    return STSE(**kwargs)
