"""Process groups and sharding helpers: one process per card under ``torchrun``.

Counterpart of ``agenda_tpu/parallel/mesh.py:31-83``. The JAX package spans
every attached device from one process with a (dp, fsdp) ``jax.sharding``
mesh, and XLA inserts the collectives. Here each rank is a process (launched
by ``torchrun``), the mesh is a record of the process group, and the
collectives are ``torch.distributed`` calls that the callers make
explicitly:

- ``make_mesh(dp=-1, fsdp=1)``: the rules of ``mesh.py:31-40`` (``dp = -1``
  takes ``world // fsdp``; ``dp x fsdp`` must be the world), the process
  group from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), the backend the caller
  names (``nccl`` for a card a rank and ``gloo`` for the CPU by default;
  never switched), and the rank's device: ``cuda:LOCAL_RANK``, the CPU when
  asked, or the card the caller names (several ranks on one card then share
  it, over ``gloo``). Rank ``r`` sits at ``(r // fsdp, r % fsdp)`` of the
  ``(dp, fsdp)`` grid, as ``mesh.py:38`` lays the devices out;
- ``shard_batch`` (``mesh.py:43-49``): this rank's rows of a global host
  batch. A batch that divides by the world is split over every rank, fsdp
  included: the JAX program splits it over ``dp`` and computes each dp row
  once on each of its fsdp devices, which gives the same numbers. A batch
  that does not (``Mesh.for_batch``) is split over ``dp`` alone, as JAX's
  ``P("dp")`` splits it: each fsdp rank of a dp row takes that row's
  samples, and the sums over the batch count each row once;
- ``replicate`` (``mesh.py:52-55``): tensors broadcast from rank 0 in place;
- ``param_sharding_rules`` (``mesh.py:58-77``): which leaves shard (the
  placement of a selected leaf is ``parallel/blocks.py``'s);
- ``batch_split``: within it, the loss and batch-norm code that reads a
  whole batch in the JAX package (normalizers, batch statistics, per-sample
  draws) sees the global batch through ``global_sum``, ``batch_mean`` and
  ``global_rows``.

At world 1 there is no process group and every helper is the identity, so
a single-card run makes no collective call.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import logging
import os
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from agenda_tpu_torch._device import resolve_device

log = logging.getLogger(__name__)

MIN_SHARD_SIZE = 2 ** 16  # param_sharding_rules' default (mesh.py:58)


@dataclasses.dataclass(eq=False)
class Mesh:
    """The (dp, fsdp) grid of the world's ranks, seen from one rank."""

    dp: int
    fsdp: int
    rank: int
    device: torch.device
    backend: Optional[str] = None  # None: no process group (world 1)
    dp_group: Any = None  # the ranks of this rank's fsdp column (None: this rank alone)
    fsdp_group: Any = None  # the ranks of this rank's dp row (None: this rank alone)
    # the global batch splits over every rank; False: over dp only, each row
    # held by its fsdp ranks (``for_batch``)
    fsdp_rows: bool = True

    @property
    def world(self) -> int:
        return self.dp * self.fsdp

    size = world  # jax.sharding.Mesh's name

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "fsdp": self.fsdp}

    @property
    def dp_index(self) -> int:
        return self.rank // self.fsdp

    @property
    def fsdp_index(self) -> int:
        return self.rank % self.fsdp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def fsdp_peer(self, j: int) -> int:
        """The global rank of fsdp index ``j`` in this rank's dp row."""
        return self.dp_index * self.fsdp + j

    @property
    def replicas(self) -> int:
        """How many ranks hold each row of the global batch."""
        return 1 if self.fsdp_rows else self.fsdp

    @property
    def shares(self) -> int:
        """How many distinct runs of rows the global batch splits into."""
        return self.world // self.replicas

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``: the ``rank``-th of
        ``world`` equal runs, or without ``fsdp_rows`` its dp row's run of
        ``dp``."""
        if n % self.shares:
            raise ValueError(f"a global batch of {n} does not split over {self.shares} "
                             f"{'ranks' if self.fsdp_rows else 'dp rows'}")
        b = n // self.shares
        i = self.rank if self.fsdp_rows else self.dp_index
        return slice(i * b, (i + 1) * b)

    def for_batch(self, n: int) -> "Mesh":
        """This mesh for a global batch of ``n``: split over every rank when
        ``n`` divides by the world, else over dp alone (``mesh.py:43-49``'s
        ``P("dp")``), each fsdp rank of a dp row taking the row's samples."""
        if n % self.world == 0:
            return self if self.fsdp_rows else dataclasses.replace(self, fsdp_rows=True)
        if n % self.dp:
            raise ValueError(f"a global batch of {n} does not split over {self.dp} dp rows")
        return dataclasses.replace(self, fsdp_rows=False)


def _rank_device(device, local_rank: int, world: int) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if world > 1 and (device is None or str(device) == "cuda"):
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank} but {torch.cuda.device_count()} "
                               "CUDA devices: one process a card")
        return resolve_device(torch.device("cuda", local_rank))
    return resolve_device(device)


def _group(ranks: List[int], world: int):
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(dp: int = -1, fsdp: int = 1, device: Any = None, backend: Optional[str] = None,
              timeout_s: Optional[float] = None) -> Mesh:
    """The (dp, fsdp) mesh of this process's world (``mesh.py:31-40``).

    The world is ``WORLD_SIZE`` (1 without it), or the process group's when
    one is initialized already. ``device``: None or "cuda" is
    ``cuda:LOCAL_RANK`` (the current card at world 1), "cpu" the CPU, and
    "cuda:k" card k for every rank. ``backend``: "nccl" (the default on the
    card) or "gloo" (the default on the CPU, and the only one that takes
    several ranks on one card); an initialized group is reused, and one of
    another backend than the one asked for raises.
    """
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = int(os.environ.get("WORLD_SIZE", "1")), int(os.environ.get("RANK", "0"))
    if fsdp < 1:
        raise ValueError(f"fsdp must be >= 1, got {fsdp}")
    if dp == -1:
        if world % fsdp:
            raise ValueError(f"fsdp {fsdp} does not divide the world of {world} ranks")
        dp = world // fsdp
    if dp * fsdp != world:
        raise ValueError(f"mesh {dp}x{fsdp} != {world} ranks")
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", "0")), world)
    if world == 1:
        return Mesh(dp=1, fsdp=1, rank=0, device=dev)
    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
        backend = dist.get_backend()
    else:
        if backend is None:
            backend = "gloo" if dev.type == "cpu" else "nccl"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, **kw)
    # every rank creates every group, in one order
    dp_group = fsdp_group = None
    for j in range(fsdp):
        g = _group([i * fsdp + j for i in range(dp)], world)
        if j == rank % fsdp:
            dp_group = g
    for i in range(dp):
        g = _group([i * fsdp + j for j in range(fsdp)], world)
        if i == rank // fsdp:
            fsdp_group = g
    mesh = Mesh(dp=dp, fsdp=fsdp, rank=rank, device=dev, backend=backend, dp_group=dp_group,
                fsdp_group=fsdp_group)
    log.info("process group %s: rank %d of %d, mesh dp %d x fsdp %d, device %s", backend, rank,
             world, dp, fsdp, dev)
    return mesh


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of every array of a global batch (``mesh.py:43-49``);
    0-d entries stay whole."""
    return {k: v[mesh.rows(len(v))] if np.ndim(v) >= 1 else v for k, v in batch.items()}


def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place (``mesh.py:52-55``)."""
    if mesh.world == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


def all_reduce_sum_(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor, a rank's share of a sum over the global batch, summed
    over the world in place. Where fsdp ranks hold the same rows
    (``mesh.replicas`` > 1) the sum is divided by them, so each row counts
    once: the sum over dp, the same on every rank."""
    if mesh.world == 1:
        return
    tensors = list(tensors)
    for t in tensors:
        dist.all_reduce(t)
    if mesh.replicas > 1:
        torch._foreach_mul_(tensors, 1.0 / mesh.replicas)


def all_gather_objects(obj: Any, mesh: Mesh) -> List[Any]:
    """Every rank's ``obj``, in rank order, on every rank."""
    if mesh.world == 1:
        return [obj]
    out: List[Any] = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        dist.barrier()


def param_sharding_rules(shapes: Mapping[str, Any], fsdp: int,
                         min_size: int = MIN_SHARD_SIZE) -> Dict[str, Optional[int]]:
    """For each leaf (a tensor or a shape), the axis ``mesh.py:58-77`` shards
    over fsdp (the largest divisible one, the last of equals), or None: a
    leaf shards iff fsdp > 1, it has at least ``min_size`` elements and one
    of its axes divides by fsdp."""
    out: Dict[str, Optional[int]] = {}
    for name, leaf in shapes.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        if fsdp == 1 or int(np.prod(shape, initial=1)) < min_size:
            out[name] = None
            continue
        cands = [(d, i) for i, d in enumerate(shape) if d % fsdp == 0]
        out[name] = max(cands)[1] if cands else None
    return out


# -- the global batch seen from one rank's loss ---------------------------------

_SPLIT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar("agenda_batch_split",
                                                                        default=None)


@contextlib.contextmanager
def batch_split(mesh: Optional[Mesh]):
    """Within: the batch the model and loss see is this rank's rows of a
    global batch split over ``mesh``'s world (nothing changes at world 1)."""
    token = _SPLIT.set(mesh if mesh is not None and mesh.world > 1 else None)
    try:
        yield
    finally:
        _SPLIT.reset(token)


def split_mesh() -> Optional[Mesh]:
    """The mesh of the active ``batch_split``, or None."""
    return _SPLIT.get()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the world over ``replicas``; each rank's input gets that of
    every rank's output gradient (the ranks' losses add up to the global
    loss, as ``all_reduce_sum_`` adds them)."""

    @staticmethod
    def forward(ctx, t, replicas: int):
        ctx.replicas = replicas
        out = t.clone()
        dist.all_reduce(out)
        return out / replicas if replicas > 1 else out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return (g / ctx.replicas if ctx.replicas > 1 else g), None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the global batch's shares under the active
    ``batch_split`` (``t`` itself without one); differentiable."""
    mesh = _SPLIT.get()
    return t if mesh is None else _AllReduceSum.apply(t, mesh.replicas)


def global_rows(b: int) -> Tuple[int, slice]:
    """(the global batch, this rank's rows of it) for a local batch of ``b``
    under the active ``batch_split``; (b, all rows) without one."""
    mesh = _SPLIT.get()
    if mesh is None:
        return b, slice(None)
    return b * mesh.shares, mesh.rows(b * mesh.shares)


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean over the global batch of per-sample
    values ``t`` (B, ...): the shares add up to it (``t.mean(0)`` without a
    ``batch_split``)."""
    if _SPLIT.get() is None:
        return t.mean(dim=0)
    return t.sum(dim=0) / global_rows(t.shape[0])[0]


def draw_rows(draw, b: int) -> torch.Tensor:
    """``draw(n)`` for the global batch n, then this rank's rows: a rank's
    per-sample draws are the ones a single process draws for those samples."""
    n, rows = global_rows(b)
    return draw(n)[rows]
