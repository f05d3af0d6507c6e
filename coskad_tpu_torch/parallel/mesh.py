"""Data parallelism over `torch.distributed` (counterpart of
`coskad_tpu/parallel/mesh.py`).

The reference trains data-parallel under DDP over NCCL; the JAX package
shards every step's global batch over the 'data' axis of a (data, model)
mesh and keeps global semantics: every batch reduction (BatchNorm's
statistics, the loss means, the contrastive all-pairs matrix, the epoch
accumulators) is over the global batch. The port keeps those semantics
with one process a rank:

  * every rank holds the whole split on its own device, and every step's
    global batch is cut into `world` contiguous row blocks, one a rank
    (`Layout.rows`, JAX's `PartitionSpec(None, 'data')`);
  * every batch-global quantity goes through one collective whose backward
    sums the cotangents over the ranks (`all_sum`, `gather_rows`); each
    rank then takes the gradient of its own block's mean loss, and the
    parameter gradients summed over the ranks and divided by the world
    size are the gradient of the global batch's loss (`average_gradients`);
  * random draws (dropout masks, the VAE's samples, the contrastive view's
    augmentation) are drawn for the global batch from the one-process
    generator and each rank keeps its rows (`local_draw`), so a rank's
    rows draw what one process would draw for them.

The collectives are `all_reduce`, `all_gather` and `barrier`, which gloo
runs on CPU and CUDA tensors alike (`chip_smoke.py --only parallel` runs
two gloo ranks on CUDA tensors) and NCCL on CUDA tensors. There is no
`DistributedDataParallel`: its `broadcast_buffers` would overwrite the
BatchNorm running statistics, and its buckets reorder the sums. The
Trainer enters `sharded(layout)` around a sharded pass; outside it (and at
world size 1, as JAX at `n_data == 1`) no collective runs, and the
one-process path keeps its bits.

With `run.model_parallel` M > 1 the group is a (data, model) mesh, as
JAX's `create_mesh`: rank r sits at data index r // M and model index
r % M. The data axis is everything above, run over the data group (the
ranks of one model index); the M ranks of one data block take the same
rows and the same draws, so they hold the same loss and the same
replicated weights. The projector's wide kernels are split over the model
group (`split_dim`, JAX's `_param_spec`): each rank holds its block of
rows of the linear projector's and the MLP head's kernels and of columns
of the reverse projector's, and `shard_model` cuts them. The sharded
layers run as tensor parallelism (`model_slice`, `model_sum`,
`model_copy`, `model_gather`, whose backward passes are written for ranks
that share one loss); a gradient is averaged over the data group alone.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# How long a rank waits for the coordinator and for the group's other ranks.
INIT_TIMEOUT = datetime.timedelta(minutes=10)

# the rank's CUDA device index, set by initialize_distributed
_LOCAL_DEVICE: Optional[int] = None
# model_parallel -> (data groups, model groups) made for the live group
_GROUPS: dict = {}


class CoordinatorBindError(RuntimeError):
    """Rank 0 could not bind the coordinator's port: another process holds it."""


@dataclass(frozen=True)
class Layout:
    """The layout of this process: `world` ranks, this one `rank`, its
    CUDA device index `local_device` (None without CUDA), and the mesh's
    model axis of `model_world` ranks. Rank r is at data index r //
    model_world and model index r % model_world; `data_group` and
    `model_group` are its two process groups (None where the axis is the
    whole world or a single rank)."""

    world: int = 1
    rank: int = 0
    local_device: Optional[int] = None
    backend: Optional[str] = None
    model_world: int = 1
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)

    @property
    def data_world(self) -> int:
        return self.world // self.model_world

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_world

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_world

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n rows on the data axis (n a
        multiple of the data world)."""
        if n % self.data_world:
            raise ValueError(f"{n} rows do not split into {self.data_world} equal blocks")
        per = n // self.data_world
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of t along `dim` (the data axis)."""
        s = self.block(t.shape[dim])
        return t.narrow(dim, s.start, s.stop - s.start)


def layout() -> Layout:
    """The process's layout: the live process group's, else one rank (no
    model axis: `create_mesh` lays one over the group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return Layout()
    return Layout(world=dist.get_world_size(), rank=dist.get_rank(),
                  local_device=_LOCAL_DEVICE, backend=dist.get_backend())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda") -> Layout:
    """Join the process group: rank `process_id` of `num_processes`, with the
    coordinator (rank 0's TCP store) at 'host:port'. With no arguments the
    launcher's environment is read, torchrun's MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK and LOCAL_RANK. The backend is NCCL for a CUDA
    `device` and gloo for the CPU; `backend` names another (gloo on CUDA
    tensors runs several ranks on one card, which NCCL refuses). The rank's
    CUDA device is cuda:LOCAL_RANK under the launcher, else cuda:(process_id
    % device count). A failed join raises; rank 0 raises
    CoordinatorBindError when the port is taken."""
    global _LOCAL_DEVICE
    if coordinator_address is None and num_processes is None and process_id is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"--distributed auto reads the launcher's {', '.join(missing)}, "
                               "which are not set: launch with torchrun, or pass "
                               "'host:port,num_processes,process_id'")
        host, port = os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ["LOCAL_RANK"])
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("pass coordinator_address, num_processes and process_id together")
        host, port = coordinator_address.rsplit(":", 1)
        port, world, rank = int(port), int(num_processes), int(process_id)
        local = None
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is not a rank of a group of {world}")
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' for a gloo group on "
                               "the CPU")
        _LOCAL_DEVICE = local if local is not None else rank % torch.cuda.device_count()
        torch.cuda.set_device(_LOCAL_DEVICE)
    try:
        store = dist.TCPStore(host, port, world, rank == 0, timeout=INIT_TIMEOUT,
                              wait_for_workers=False)
    except RuntimeError as e:
        text = str(e).lower()
        if rank == 0 and ("eaddrinuse" in text or "address already in use" in text):
            raise CoordinatorBindError(f"coordinator port {host}:{port} is taken: {e}") from e
        raise
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=INIT_TIMEOUT)
    return layout()


def mesh_shape(world: int, data_parallel: int = -1, model_parallel: int = 1
               ) -> Tuple[int, int]:
    """(data, model) for run.data_parallel / run.model_parallel over a
    group of `world` ranks: model_parallel must divide the world, and the
    data axis is the rest (data_parallel -1 or world // model_parallel).
    JAX lays a smaller mesh over the first devices and leaves the others
    idle; here an idle rank would be a whole process with nothing to do, so
    data x model must be the world (ROADMAP.md, "Deliberate differences")."""
    m = model_parallel
    if m < 1 or world % m or data_parallel not in (-1, world // m):
        raise ValueError(
            f"run.data_parallel {data_parallel}, run.model_parallel {model_parallel}: the port "
            f"lays a (data, model) mesh over the process group's {world} rank(s), so "
            "model_parallel must divide the world and data_parallel be -1 or the world / "
            "model_parallel, every rank on the mesh (launch data x model ranks with "
            "--distributed or torchrun)")
    return world // m, m


def create_mesh(data_parallel: int = -1, model_parallel: int = 1) -> Layout:
    """The layout for run.data_parallel / run.model_parallel (`mesh_shape`)
    over the process group. A model axis makes the data and model groups
    (`dist.new_group`, every rank the same calls in the same order) once for
    the group; later calls reuse them."""
    lay = layout()
    _, m = mesh_shape(lay.world, data_parallel, model_parallel)
    if m == 1:
        return lay
    if m not in _GROUPS:
        _GROUPS[m] = ([dist.new_group(list(range(i, lay.world, m))) for i in range(m)],
                      [dist.new_group(list(range(d * m, (d + 1) * m)))
                       for d in range(lay.world // m)])
    data_groups, model_groups = _GROUPS[m]
    return dataclasses.replace(lay, model_world=m, data_group=data_groups[lay.rank % m],
                               model_group=model_groups[lay.rank // m])


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _LOCAL_DEVICE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_DEVICE = None
    _GROUPS.clear()


# ------------------------------------------------------------ batch layout


def train_batch(n: int, batch_size: int, world: int) -> int:
    """The step batch of n items: the config's, shrunk to the dataset and
    rounded to a multiple of the world (`coskad_tpu/train/loop.py:829-830`)."""
    return min(batch_size, max(n // world, 1) * world)


def eval_chunks(n: int, batch_size: int, world: int) -> Tuple[int, int]:
    """(chunk, chunks) of an eval pass over n items: one chunk of n where n
    is smaller than a batch, the chunk rounded up to a multiple of the world,
    the tail wrap-padded."""
    bs = -(-min(batch_size, n) // world) * world
    return bs, -(-n // bs)


# ------------------------------------------------------------- collectives
# The data-axis collectives take a `group` (None: the whole world, which is
# the data axis without a model axis); inside a sharded scope `all_sum` and
# `gather_rows` take the scope's data group.


def _barrier_kwargs() -> dict:
    if dist.get_backend() == "nccl" and _LOCAL_DEVICE is not None:
        return dict(device_ids=[_LOCAL_DEVICE])
    return {}


def barrier() -> None:
    """Every rank waits for the others (a no-op without a group)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier(**_barrier_kwargs())


def sum_across(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the group's ranks (a new tensor; no gradient)."""
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=group)
    return y


def sum_each(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each tensor summed over the group's ranks, by one all_reduce of their
    concatenation (one dtype; no gradient)."""
    flat = sum_across(torch.cat([t.detach().reshape(-1) for t in tensors]), group)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                tensors)]


def all_gather_rows(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's ranks' x concatenated along `dim`, in rank order (no
    gradient)."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _scope_group():
    lay = active()
    return None if lay is None else lay.data_group


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_across(x, group)

    @staticmethod
    def backward(ctx, g):
        return sum_across(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.group = x.shape[0], group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        return sum_across(g, ctx.group)[rank * ctx.rows:(rank + 1) * ctx.rows], None


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data axis's ranks; its backward sums the cotangents
    over them, so each rank's x gets the gradient of every block's loss."""
    return _AllSum.apply(x, _scope_group())


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows from each data rank's block x (rank-major);
    its backward sums the cotangents over the data ranks and keeps this
    rank's rows."""
    return _GatherRows.apply(x, _scope_group())


def average_gradients(params: Sequence[torch.nn.Parameter], world: int, group=None) -> None:
    """Every parameter's gradient summed over the group's ranks and divided
    by `world`, in place: one flat all_reduce, the same bits on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    for g, total in zip(grads, sum_each(grads, group) if grads else ()):
        g.copy_(total.div_(world))


# ------------------------------------------------------------ the model axis
# The M ranks of one data block carry the same loss, so a cotangent that
# reaches a model-group collective is already the same on each of them:
# unlike the data axis's, these backward passes never sum a cotangent that
# every rank holds whole.


def split_dim(name: str, ndim: int) -> Optional[int]:
    """The dim a parameter is split on over the model axis, None where it is
    replicated: JAX's `_param_spec` (`coskad_tpu/parallel/mesh.py:59-70`)
    by the parameter's name. Every 2-D kernel under `btlnk` (the linear
    projector's, the MLP head's `hidden_i` and `out`) splits its input rows
    (0), `rev_btlnk`'s kernel its output columns (1); biases, BatchNorm,
    the graph adjacencies and the VAE's heads are replicated."""
    if ndim != 2 or "btlnk" not in name:
        return None
    return 1 if "rev_btlnk" in name else 0


def local_block(lay: Optional[Layout], name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of the whole parameter `t` named `name` on the model
    axis of `lay` (t itself where it is replicated or there is no axis)."""
    dim = split_dim(name, t.dim())
    if lay is None or lay.model_world == 1 or dim is None:
        return t
    n = t.shape[dim]
    if n % lay.model_world:
        raise ValueError(f"{name}: {n} {'rows' if dim == 0 else 'columns'} do not split "
                         f"into {lay.model_world} equal blocks over the model axis")
    per = n // lay.model_world
    return t.narrow(dim, lay.model_rank * per, per)


def whole(lay: Optional[Layout], name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole parameter from each model rank's block `t` (a collective over
    the model group where `name` is split; t itself otherwise)."""
    dim = split_dim(name, t.dim())
    if lay is None or lay.model_world == 1 or dim is None:
        return t
    return all_gather_rows(t, lay.model_group, dim=dim)


def shard_model(model: torch.nn.Module, lay: Layout) -> torch.nn.Module:
    """Cut each split parameter of `model` (whole, the same on every rank) to
    this rank's block in place, and hand the layout to the layer that owns
    it (its `split` attribute), which then runs as tensor parallelism."""
    if lay.model_world == 1:
        return model
    for name, p in list(model.named_parameters()):
        if split_dim(name, p.dim()) is None:
            continue
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if not hasattr(owner, "split"):
            raise TypeError(f"{name}: {type(owner).__name__} cannot run split over a model axis")
        p.data = local_block(lay, name, p.data).clone()
        owner.split = lay
    return model


def model_layout(model: torch.nn.Module) -> Optional[Layout]:
    """The model axis `shard_model` laid on `model` (the `split` of its first
    split layer; the loaders slice by it), None for a whole model."""
    return next((m.split for m in model.modules() if getattr(m, "split", None) is not None),
                None)


class _ModelSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay = lay
        per = x.shape[-1] // lay.model_world
        return x.narrow(-1, lay.model_rank * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g, ctx.lay.model_group, dim=-1), None


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay):
        return sum_across(x, lay.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay = lay
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_across(g, ctx.lay.model_group), None


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay, ctx.cols = lay, x.shape[-1]
        return all_gather_rows(x, lay.model_group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.lay.model_rank * ctx.cols, ctx.cols).contiguous(), None


def model_slice(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """This model rank's block of x's last dim (the input of a row-split
    product); its backward gathers the blocks' cotangents, so the replicated
    layers below see the whole gradient."""
    return _ModelSlice.apply(x, lay)


def model_sum(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The model ranks' partial products summed; its backward passes the
    cotangent through (each rank's partial gets the loss's one gradient)."""
    return _ModelSum.apply(x, lay)


def model_copy(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """x as it is, entering a column-split product; its backward sums the
    model ranks' cotangents (each holds its columns' share)."""
    return _ModelCopy.apply(x, lay)


def model_gather(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The model ranks' column blocks concatenated along the last dim; its
    backward keeps this rank's columns of the cotangent."""
    return _ModelGather.apply(x, lay)


# ------------------------------------------------------- the sharded scope

_ACTIVE: contextvars.ContextVar[Optional[Layout]] = contextvars.ContextVar(
    "coskad_torch_sharded", default=None)


@contextlib.contextmanager
def sharded(lay: Optional[Layout]):
    """Within this scope a batch is this rank's block of a global batch
    under `lay`'s data axis: BatchNorm's statistics, K2's sums and the draws
    become global. A data axis of one rank (or None) enters no scope."""
    token = _ACTIVE.set(lay if lay is not None and lay.data_world > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Layout]:
    """The layout of the enclosing `sharded` scope, None outside one."""
    return _ACTIVE.get()


def local_draw(draw: Callable[[Tuple[int, ...]], torch.Tensor],
               shape: Sequence[int]) -> torch.Tensor:
    """draw(shape) where no sharded scope is active; inside one, this rank's
    rows of draw(the global batch's shape): the rows one process draws."""
    lay = active()
    shape = tuple(shape)
    if lay is None:
        return draw(shape)
    return lay.rows(draw((shape[0] * lay.data_world, *shape[1:])))
