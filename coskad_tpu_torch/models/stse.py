"""STSE / STSAE / STSVAE: the COSKAD model family (PyTorch).

Counterpart of `coskad_tpu/models/stse.py`, with every encoder of the
registry (`encoders.make_encoder`: `sts_gcn`, `st_gcn`, `learnable_gcn`,
`static_gcn`, `cnn`) and the linear or the MLP projector: `STSE` (encoder
and projector to the latent), `STSAE` (plus a mirrored STS-GCN decoder;
forward -> (latent, reconstruction)) and `STSVAE` (PowerSpherical or
diagonal-Normal latent heads on the hidden state, then the decoder; forward
-> (sample, reconstruction, (mean, var))); the decoder variants take the
`sts_gcn` encoder only, as in JAX. I/O is the reference's NCTV layout
[B, C, T, V]; the projector and the VAE heads read the hidden state
flattened in (T, V, C) order.

The eval forward takes the encoder's hidden state on one of two routes
(`eval_uses_kernel`):
  * the fused encoder kernel K1 (`kernels/stse_fused.py`), for an input on
    the card, the `sts_gcn` encoder and a layout the planner of the form of
    the model's compute dtype takes (`STSE.kernel_takes`): at float32 K1,
    at bf16 K1's bf16 form, which rounds where the module path rounds.
    Weights folded once into a launch plan a stack (`_Plan`: the packed
    operand and the op's arguments, kept until a tensor the fold reads
    changes, checked by storage and version), then the projector and the
    VAE heads as modules in eval mode; the decoder variants' reverse
    projector, then K1 again on the decoder's stack (`STSAE.decode`, its
    own plan and planner answer); the
    kernel has no backward, so this route raises where autograd would
    record it, at either dtype;
  * the module path, layer by layer, everywhere else: on the CPU, and on
    the card for the other encoders and for a layout the planner refuses
    (more than 8 layers, more than 64 channels a layer, activations past a
    block's shared memory).
The train forward (`train=True`) is the module path with live BatchNorm,
which updates the running statistics in place (see `stsgcn.py`), or with
running statistics under `frozen_bn`, in the decoder as in the encoder.
The MLP head's BatchNorm is live in every train forward, `frozen_bn` or
not: the JAX model passes the head `train` alone. Dropout (`dropout` > 0)
acts in every train forward, `frozen_bn` or not, in the encoder and the
decoder, with its masks drawn from `dropout_generator`; it is off in eval.
The ghost-BN train path through the K2-K4 kernels is
`kernels/stse_train.py::fused_stse_apply` (encoder-only, linear
projector, no dropout).

`dtype` is the JAX model's compute dtype (`models/stsgcn.py`): the `sts_gcn`
encoder, the linear projector, the reverse projector and the decoder round
where JAX casts, the latent is float32; the other encoders, the MLP head and
the VAE heads are built without it, as in JAX, and compute in float32.
"""

from __future__ import annotations

import math
import operator
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules import module as module_hooks

from ..geometry.sphere import PowerSpherical
from ..kernels import stse_fused
from ..parallel import mesh
from ..utils.profiling import span
from .encoders import make_encoder
from .stsgcn import Dense, MLPHead, STSGCNStack, _uniform_, rounded

# Registrations of a parameter, buffer or submodule on any module of the
# process, counted by torch.nn's global registration hooks from the first
# launch plan on (`_Plan`): a plan walks its stack again after one.
_registrations = 0
_watching = False


def _registered(*_) -> None:
    global _registrations
    _registrations += 1


def _watch_registrations() -> None:
    """Count registrations from now on; the hooks go in once a process."""
    global _watching
    if not _watching:
        for hook in (module_hooks.register_module_parameter_registration_hook,
                     module_hooks.register_module_buffer_registration_hook,
                     module_hooks.register_module_module_registration_hook):
            hook(_registered)
        _watching = True


def _slots(stack: Iterable[Tuple[str, nn.Module]]) -> list:
    """Where the tensors of the named modules live, in `state_dict` order:
    (state name, the owning module's parameter or buffer dict, the name in
    it) for every parameter and persistent buffer. A stack's fold reads
    these alone."""
    slots = []
    for prefix, root in stack:
        for path, m in root.named_modules(prefix=prefix[:-1], remove_duplicate=False):
            for tensors, skip in ((m._parameters, ()), (m._buffers, m._non_persistent_buffers_set)):
                slots += [(f"{path}.{k}", tensors, k) for k, t in tensors.items()
                          if t is not None and k not in skip]
    return slots


_version = operator.attrgetter("_version")


def _key(slots: list) -> list:
    """What a plan checks of its slots: each tensor's storage, then each
    one's in-place version (KeyError where one was deleted)."""
    held = [tensors[k] for _, tensors, k in slots]
    return list(map(torch.Tensor.data_ptr, held)) + list(map(_version, held))


class _Plan:
    """K1's launch plan for one stack of a model: the stack folded and
    packed (`packed` holds the op and its arguments), built from the
    tensors at `slots` and kept while `holds`: no tensor there replaced or
    modified in place (an optimizer step, a BatchNorm statistic,
    `load_state_dict`, `.to()`), and no registration (`_registrations`)
    that changed the stack's slots. A hit reads each slot's tensor from its
    dict and compares its storage and version: no `state_dict` walk.

    The first plan of a process installs torch.nn's global registration
    hooks, so `_registrations` counts what any module of the process
    registers, this model's or not. That is acceptable: modules register at
    construction and on a replaced tensor or submodule, not in a scoring
    loop, and a registration elsewhere costs a plan one walk of its stack
    (the slots compare equal and the plan holds), never a rebuild."""

    def __init__(self, stack: list, prefix: str, dtype: torch.dtype):
        _watch_registrations()
        self.slots, self.registrations = _slots(stack), _registrations
        self.key = _key(self.slots)
        with torch.no_grad(), span("k1.fold"):
            self.folded = stse_fused.fold_stse_params(
                {name: tensors[k].detach() for name, tensors, k in self.slots}, dtype, prefix)
            self.packed = stse_fused.pack_folded(self.folded)
        stse_fused.plan_builds.value += 1

    def holds(self, stack: Callable[[], list]) -> bool:
        """Whether the plan is still `stack()`'s, which is walked only after
        a registration."""
        if self.registrations != _registrations:
            slots = _slots(stack())
            if [(id(d), k) for _, d, k in slots] != [(id(d), k) for _, d, k in self.slots]:
                return False
            self.registrations = _registrations
        try:
            return _key(self.slots) == self.key
        except KeyError:
            return False


def _with_parameters(x: torch.Tensor, *modules: Optional[nn.Module]) -> Iterator[torch.Tensor]:
    """x, then the parameters of `modules`, read only as they are iterated."""
    yield x
    for m in modules:
        if m is not None:
            yield from m.parameters()


def eval_uses_kernel(for_kernel: bool, tensors: Iterable[torch.Tensor]) -> bool:
    """The eval forward's route: True for K1 (`for_kernel`: x on the card
    and a model K1 takes, `STSE.kernel_takes`), False for the module path (x
    on the CPU, or a layout K1 does not take). K1 folds
    detached weights and writes a fresh tensor, so its latent carries no
    gradient; a call bound for K1 that autograd would record (grad mode on
    and x or a parameter requiring grad) raises rather than return a latent
    cut from the graph. The module path stays differentiable. `tensors` (x
    and the parameters the route cuts, `_with_parameters`) is read only
    under grad mode: under `no_grad` or `inference_mode` nothing is."""
    if not for_kernel:
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "forward(train=False) on a CUDA tensor runs the eval kernel, which has no "
            "backward: call it under torch.no_grad() or torch.inference_mode(), or use "
            "encode for a differentiable latent")
    return True


class LinearProjector(Dense):
    """Dense over the hidden state flattened in (T, V, C) order:
    kernel [T*V*C, latent], bias [latent]; at a bf16 dtype rounded as
    `Dense` (JAX's `LinearProjector` dot without a preferred type)."""

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return super().forward(h.reshape(h.shape[0], -1))


class ReverseProjector(nn.Module):
    """The decoder's input: latent [B, L] -> hidden [B, T, V, H]. JAX's
    `ReverseProjector`: kernel [L, H*T*V] and bias [H*T*V] in the
    reference's channel-major flat order, the de-flatten and the transpose
    to (T, V, H) done on the weight. At a bf16 dtype the latent, the kernel,
    the product, the bias and the sum are rounded, as there. Split over a
    model axis (`split`, set by `mesh.shard_model`) the kernel is this
    rank's block of columns: the latent times it, the blocks gathered over
    the model group into the whole flat hidden, which is then de-flattened."""

    def __init__(self, hidden_dimension: int, n_frames: int, n_joints: int, latent_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shape = (hidden_dimension, n_frames, n_joints)
        flat = hidden_dimension * n_frames * n_joints
        self.kernel = nn.Parameter(torch.empty(latent_dim, flat))
        self.bias = nn.Parameter(torch.empty(flat))
        self.dtype = dtype
        self.split: Optional[mesh.Layout] = None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.kernel.shape[0])
        _uniform_(self.kernel, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h, t, v = self.shape
        if self.split is not None:
            part = rounded(mesh.model_copy(rounded(z, dt), self.split)
                           @ rounded(self.kernel, dt), dt)
            flat = mesh.model_gather(part, self.split)  # [B, H*T*V] channel-major
            flat = flat.reshape(-1, h, t, v).permute(0, 2, 3, 1).reshape(-1, t * v * h)
            b = rounded(self.bias, dt).reshape(h, t, v).permute(1, 2, 0).reshape(-1)
            return rounded(flat + b, dt).reshape(z.shape[0], t, v, h)
        w = rounded(self.kernel, dt).reshape(-1, h, t, v).permute(0, 2, 3, 1).reshape(-1, t * v * h)
        b = rounded(self.bias, dt).reshape(h, t, v).permute(1, 2, 0).reshape(-1)
        out = rounded(rounded(rounded(z, dt) @ w, dt) + b, dt)
        return out.reshape(z.shape[0], t, v, h)

    def channel_major(self, z: torch.Tensor) -> torch.Tensor:
        """The same hidden state in the reference's channel-major order, [B,
        H, T, V] contiguous: the latent times the kernel as it is stored,
        plus the bias, rounded as `forward` rounds, with no transpose (K1's
        input layout, for the decoder's eval route). Split over a model axis
        the blocks are gathered into the whole flat hidden first."""
        dt = self.dtype
        h, t, v = self.shape
        if self.split is not None:
            part = rounded(mesh.model_copy(rounded(z, dt), self.split)
                           @ rounded(self.kernel, dt), dt)
            flat = mesh.model_gather(part, self.split)
        else:
            flat = rounded(rounded(z, dt) @ rounded(self.kernel, dt), dt)
        return rounded(flat + rounded(self.bias, dt), dt).reshape(-1, h, t, v).contiguous()


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
        self.encoder_type = encoder_type
        # the shape arguments, as the flax module's fields (interop reads them)
        self.input_dim, self.layer_channels = input_dim, tuple(layer_channels)
        self.hidden_dimension, self.latent_dim = hidden_dimension, latent_dim
        self.n_frames, self.n_joints, self.projector = n_frames, n_joints, projector
        self.encoder = make_encoder(encoder_type, input_dim, layer_channels, hidden_dimension,
                                    n_frames, n_joints, dropout, use_bias, dtype)
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
        self._fold_cache: Optional[_Plan] = None  # the encoder's launch plan
        self._kernel_takes: Optional[bool] = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-draw every parameter (torch-default inits, as the JAX package
        uses) from `generator`, in module order; BN statistics reset."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def encode(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
               dropout_generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Plain path: [B, C, T, V] -> (latent [B, D], hidden [B, T, V, H])."""
        h = self._module_hidden(x, train, frozen_bn, dropout_generator)
        return self._project(h, train), h

    def _module_hidden(self, x: torch.Tensor, train: bool, frozen_bn: bool,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encoder(x.permute(0, 2, 3, 1), train=train, frozen_bn=frozen_bn,
                            generator=generator)

    def _project(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        """The projector on the hidden state ([B, T, V, C] or [B, T*V, C]).
        Its rounding points hold the latent in float32 at any dtype."""
        if isinstance(self.btlnk, MLPHead):
            return self.btlnk(h.reshape(h.shape[0], -1), train=train)
        return self.btlnk(h)

    def _hidden(self, x: torch.Tensor, train: bool, frozen_bn: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The encoder's hidden state on the forward's route: [B, T, V, H]
        from the module path, [B, T*V, H] from K1 (the same flatten)."""
        if not train and eval_uses_kernel(x.is_cuda and self.kernel_takes(),
                                          _with_parameters(x, self.encoder, self.btlnk)):
            plan = self._plan("_fold_cache", self._encoder_stack, "encoder.")
            return stse_fused.fused_stse_hidden(x.contiguous(), plan.folded, plan.packed)
        return self._module_hidden(x, train, frozen_bn, generator)

    def kernel_takes(self) -> bool:
        """Whether the eval forward on the card runs K1: the `sts_gcn`
        encoder (K1 is that stack; the other encoders, as in JAX, have no
        kernel) and a layout the planner of K1's form for the compute dtype
        takes (float32 or bf16, `stse_fused.takes`, asked once; the layout
        is fixed at construction)."""
        if self._kernel_takes is None:
            self._kernel_takes = (self.encoder_type.lower() == "sts_gcn"
                                  and stse_fused.takes(self.folded()[1]))
        return self._kernel_takes

    def folded(self) -> Tuple[stse_fused.FoldedSTSE, stse_fused.PackedSTSE]:
        """The kernel's folded and packed weights in the form of the compute
        dtype, from the encoder's launch plan: rebuilt only when a tensor the
        fold reads (`encoder.*`, `btlnk.*`) was replaced or modified in
        place, so a decoder or VAE head update keeps it."""
        plan = self._plan("_fold_cache", self._encoder_stack, "encoder.")
        return plan.folded, plan.packed

    def _plan(self, attr: str, stack: Callable[[], list], prefix: str) -> _Plan:
        """The launch plan of the stack `stack()` (`prefix`), kept at `attr`:
        the one there while it holds (`stse_fused.plan_hits`), else a new
        one in the compute dtype's form."""
        plan = getattr(self, attr)
        if plan is not None and plan.holds(stack):
            stse_fused.plan_hits.value += 1
            return plan
        plan = _Plan(stack(), prefix, self.dtype)
        setattr(self, attr, plan)
        return plan

    def _encoder_stack(self) -> list:
        """What K1's fold of the encoder reads (`stse_fused.fold_stse_params`)
        and its route cuts from autograd's graph: the encoder and the
        projector (none in a VAE that projects by the identity), by their
        state prefixes."""
        return [(k, m) for k, m in (("encoder.", self.encoder), ("btlnk.", self.btlnk))
                if m is not None]

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._project(self._hidden(x, train, frozen_bn, dropout_generator), train)


class STSAE(STSE):
    """STSE plus a mirrored STS-GCN decoder: forward -> (latent [B, D],
    reconstruction [B, C_in, T, V]). The decoder (`decoder`, its channels
    `decoder_channels` or the encoder's reversed, then C_in) reads the
    reverse projector's hidden state (`rev_btlnk`); it has the encoder's
    train, eval and `frozen_bn` semantics. Its eval forward takes the
    encoder's two routes: K1 on the decoder's stack (`decoder_kernel_takes`,
    `decoder_folded`), fed `rev_btlnk`'s channel-major hidden state, for a
    latent on the card; the modules elsewhere."""

    def __init__(self, input_dim: int = 2, layer_channels: Sequence[int] = (32, 16, 32),
                 hidden_dimension: int = 64, latent_dim: int = 16, n_frames: int = 12,
                 n_joints: int = 17, decoder_channels: Optional[Sequence[int]] = None,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(input_dim, layer_channels, hidden_dimension, latent_dim, n_frames,
                         n_joints, use_bias=use_bias, dtype=dtype, **kwargs)
        if self.encoder_type.lower() != "sts_gcn":
            raise ValueError(f"No decoder available for encoder type {self.encoder_type!r}")
        self.rev_btlnk = ReverseProjector(hidden_dimension, n_frames, n_joints, latent_dim,
                                          dtype)
        self.decoder_channels = decoder_channels
        channels = list(decoder_channels or list(layer_channels)[::-1]) + [input_dim]
        self.decoder = STSGCNStack(hidden_dimension, channels, n_frames, n_joints, use_bias,
                                   dtype, self.dropout)
        self._decoder_fold_cache: Optional[_Plan] = None  # the decoder's launch plan
        self._decoder_kernel_takes: Optional[bool] = None

    def decoder_folded(self) -> Tuple[stse_fused.FoldedSTSE, stse_fused.PackedSTSE]:
        """K1's folded and packed weights of the decoder's stack in the form
        of the compute dtype, from the decoder's launch plan: rebuilt only
        when a `decoder.*` tensor was replaced or modified in place, so an
        encoder, head or reverse projector update keeps it."""
        plan = self._plan("_decoder_fold_cache", self._decoder_stack, "decoder.")
        return plan.folded, plan.packed

    def _decoder_stack(self) -> list:
        return [("decoder.", self.decoder)]

    def decoder_kernel_takes(self) -> bool:
        """Whether the eval decode on the card runs K1: the planner of the
        form for the compute dtype takes the decoder's layout (asked once)."""
        if self._decoder_kernel_takes is None:
            self._decoder_kernel_takes = stse_fused.takes(self.decoder_folded()[1])
        return self._decoder_kernel_takes

    def k1_decode(self, z: torch.Tensor, packed: stse_fused.PackedSTSE) -> torch.Tensor:
        """The eval decode on K1: `rev_btlnk`'s channel-major hidden state
        through the decoder's packed stack (`decoder_folded`, or the scoring
        artifact's copy), the reconstruction [B, C_in, T, V] a view of the
        kernel's [B, T*V, C_in] output. `stse_fused.decoder_launches` adds
        the launches the op made (none for its CPU implementation)."""
        before = stse_fused.launches.value
        h = packed.op(self.rev_btlnk.channel_major(z), *packed.op_args)
        stse_fused.decoder_launches.value += stse_fused.launches.value - before
        return h.reshape(h.shape[0], self.n_frames, self.n_joints, h.shape[-1]).permute(
            0, 3, 1, 2)

    def decode(self, z: torch.Tensor, train: bool = False, frozen_bn: bool = False,
               dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """latent [B, D] -> reconstruction [B, C_in, T, V]. In eval under the
        `eval.decode` span, and on the card through K1, which raises where
        autograd would record it."""
        if train:
            return self.decoder(self.rev_btlnk(z), train=True, frozen_bn=frozen_bn,
                                generator=dropout_generator).permute(0, 3, 1, 2)
        with span("eval.decode", profiled=False):
            if eval_uses_kernel(z.is_cuda and self.decoder_kernel_takes(),
                                _with_parameters(z, self.rev_btlnk, self.decoder)):
                return self.k1_decode(z, self.decoder_folded()[1])
            return self.decoder(self.rev_btlnk(z)).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = super().forward(x, train, frozen_bn, dropout_generator)
        return z, self.decode(z, train, frozen_bn, dropout_generator)


class STSVAE(STSAE):
    """Variational STSAE: forward -> (z [B, D], reconstruction, (z_mean,
    z_var)). The heads `fc_mean` and `fc_var` stay float32 at any compute
    dtype: Dense layers on the MLP projector's latent, or, with the linear
    projector (the identity here, so the model has no `btlnk`), linear
    projectors contracting the hidden state. For `distribution='ps'` the
    mean is normalised and z_var [B, 1] is the PowerSpherical concentration
    softplus(fc_var) + kappa_floor; for 'normal' z_var [B, D] is the
    standard deviation.

    z is drawn from `generator` (`sample=True`, JAX's default), is the mean
    (`sample=False`), or comes from fed draws (`sample_draws`: (z01, v_raw)
    for 'ps', (eps,) for 'normal'; the lockstep hook). The decoder is
    STSAE's, on its routes."""

    def __init__(self, *args, distribution: str = "ps", kappa_floor: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        if distribution not in ("ps", "normal"):
            raise ValueError(f"Unsupported distribution {distribution!r}")
        self.distribution = distribution
        self.kappa_floor = kappa_floor
        latent = self.rev_btlnk.kernel.shape[0]
        var_out = 1 if distribution == "ps" else latent
        if isinstance(self.btlnk, MLPHead):
            self.fc_mean = Dense(latent, latent)
            self.fc_var = Dense(latent, var_out)
        else:
            flat = self.btlnk.kernel.shape[0]
            self.btlnk = None
            self.fc_mean = LinearProjector(flat, latent)
            self.fc_var = LinearProjector(flat, var_out)

    def _project(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        if self.btlnk is None:  # the identity projector
            return h.reshape(h.shape[0], -1)
        return super()._project(h, train)

    def encode_distribution(self, x: torch.Tensor, train: bool = False,
                            frozen_bn: bool = False,
                            dropout_generator: Optional[torch.Generator] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (z_mean [B, D], z_var [B, 1] for 'ps' or [B, D] for 'normal')."""
        return self.posterior(
            self._project(self._hidden(x, train, frozen_bn, dropout_generator), train))

    def posterior(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The heads on the projected hidden state: (z_mean, z_var)."""
        z_mean = self.fc_mean(feat)
        if self.distribution == "ps":
            z_mean = z_mean / torch.linalg.vector_norm(z_mean, dim=-1, keepdim=True)
        return z_mean, F.softplus(self.fc_var(feat)) + self.kappa_floor

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                sample: bool = True, sample_draws: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None):
        z_mean, z_var = self.encode_distribution(x, train, frozen_bn, dropout_generator)
        if sample_draws is not None:
            if self.distribution == "ps":
                z = PowerSpherical(z_mean, z_var.squeeze(-1)).sample_from_draws(*sample_draws)
            else:
                z = z_mean + z_var * sample_draws[0]
        elif sample:
            if generator is None:
                raise ValueError("STSVAE draws its sample from a torch.Generator: pass "
                                 "generator=, or sample=False for the mean")
            if self.distribution == "ps":
                z = PowerSpherical(z_mean, z_var.squeeze(-1)).rsample(generator)
            else:
                z = z_mean + z_var * mesh.local_draw(
                    lambda s: torch.randn(s, generator=generator, device=z_mean.device),
                    z_mean.shape)
        else:
            z = z_mean
        return z, self.decode(z, train, frozen_bn, dropout_generator), (z_mean, z_var)


def build_model(use_decoder: bool = False, use_vae: bool = False, **kwargs) -> STSE:
    """Variant factory, as JAX's: use_vae -> STSVAE, use_decoder -> STSAE,
    else STSE (the euclidean and hyperbolic variants share it)."""
    if use_vae:
        return STSVAE(**kwargs)
    kwargs.pop("distribution", None)
    kwargs.pop("kappa_floor", None)
    if use_decoder:
        return STSAE(**kwargs)
    kwargs.pop("decoder_channels", None)
    return STSE(**kwargs)
