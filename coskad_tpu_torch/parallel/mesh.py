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

Model parallelism (the projector sharded over a model group,
`coskad_tpu/parallel/mesh.py:58-71`) is not ported: ROADMAP.md, Queue 1
item 5b.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# How long a rank waits for the coordinator and for the group's other ranks.
INIT_TIMEOUT = datetime.timedelta(minutes=10)

# the rank's CUDA device index, set by initialize_distributed
_LOCAL_DEVICE: Optional[int] = None


class CoordinatorBindError(RuntimeError):
    """Rank 0 could not bind the coordinator's port: another process holds it."""


@dataclass(frozen=True)
class Layout:
    """The data-parallel layout of this process: `world` ranks, this one
    `rank`, its CUDA device index `local_device` (None without CUDA)."""

    world: int = 1
    rank: int = 0
    local_device: Optional[int] = None
    backend: Optional[str] = None

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n rows (n a multiple of world)."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split into {self.world} equal blocks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of t along `dim`."""
        s = self.block(t.shape[dim])
        return t.narrow(dim, s.start, s.stop - s.start)


def layout() -> Layout:
    """The process's layout: the live process group's, else one rank."""
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


def create_mesh(data_parallel: int = -1, model_parallel: int = 1) -> Layout:
    """The layout for run.data_parallel / run.model_parallel: the batch is
    sharded over every rank of the group (data_parallel -1 or the world
    size). model_parallel > 1 and a data axis other than the world are
    refused."""
    lay = layout()
    if data_parallel not in (-1, lay.world) or model_parallel != 1:
        raise ValueError(
            f"run.data_parallel {data_parallel}, run.model_parallel {model_parallel}: the port "
            f"shards the batch over the group's {lay.world} rank(s) (data_parallel -1 or "
            f"{lay.world}; launch more ranks with --distributed or torchrun); model_parallel > 1, "
            "the projector sharded over a model group, is not ported yet (ROADMAP.md, Queue 1 "
            "item 5b)")
    return lay


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _LOCAL_DEVICE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_DEVICE = None


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


def _barrier_kwargs() -> dict:
    if dist.get_backend() == "nccl" and _LOCAL_DEVICE is not None:
        return dict(device_ids=[_LOCAL_DEVICE])
    return {}


def barrier() -> None:
    """Every rank waits for the others (a no-op without a group)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier(**_barrier_kwargs())


def sum_across(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks (a new tensor; no gradient)."""
    y = x.detach().clone().contiguous()
    dist.all_reduce(y)
    return y


def sum_each(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, by one all_reduce of their
    concatenation (one dtype; no gradient)."""
    flat = sum_across(torch.cat([t.detach().reshape(-1) for t in tensors]))
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                tensors)]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' x concatenated along dim 0, rank-major (no gradient)."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return sum_across(x)

    @staticmethod
    def backward(ctx, g):
        return sum_across(g)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank()
        return sum_across(g)[rank * ctx.rows:(rank + 1) * ctx.rows]


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks; its backward sums the cotangents over the
    ranks, so each rank's x gets the gradient of every rank's loss."""
    return _AllSum.apply(x)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows from each rank's block x (rank-major); its
    backward sums the cotangents over the ranks and keeps this rank's rows."""
    return _GatherRows.apply(x)


def average_gradients(params: Sequence[torch.nn.Parameter], world: int) -> None:
    """Every parameter's gradient summed over the ranks and divided by
    `world`, in place: one flat all_reduce, the same bits on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    for g, total in zip(grads, sum_each(grads) if grads else ()):
        g.copy_(total.div_(world))


# ------------------------------------------------------- the sharded scope

_ACTIVE: contextvars.ContextVar[Optional[Layout]] = contextvars.ContextVar(
    "coskad_torch_sharded", default=None)


@contextlib.contextmanager
def sharded(lay: Optional[Layout]):
    """Within this scope a batch is this rank's block of a global batch
    under `lay`: BatchNorm's statistics, K2's sums and the draws become
    global. A layout of one rank (or None) enters no scope."""
    token = _ACTIVE.set(lay if lay is not None and lay.world > 1 else None)
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
    return lay.rows(draw((shape[0] * lay.world, *shape[1:])))
