"""``--fsdp``: the optimizer state and EMA of each large leaf split over the
fsdp ranks in runs of whole 256-element quantization blocks.

Counterpart of ``agenda_tpu/parallel/mesh.py::shard_params_fsdp``
(``:80-83``). The leaves that shard are ``param_sharding_rules``' (at least
``2**16`` elements and an axis that divides by fsdp). Where the JAX package
shards the chosen axis, here a selected leaf's flat block range splits into
``fsdp`` contiguous runs of whole blocks (``_BLOCK``, the int8 moments' row of
``train/optim.py``): fsdp rank j owns blocks ``[j c, (j + 1) c)`` with c =
ceil(blocks / fsdp), clipped to the leaf. A rank keeps the int8 moments, their
absmax scales and the EMA of its runs only, and updates them with the same
AdamW (the fused kernel over views of its runs), block for block the update
one card makes, since every block is updated alone. The clip's global norm
sums every run once over the fsdp group and every replicated leaf once
locally. The updated runs are then broadcast from their owners into every
rank's full f32 parameters. Leaves under the rule stay replicated.

This is not ``torch.distributed.fsdp``: its dim-0 chunks do not start at
multiples of 256 elements for every leaf, and the int8 update would then
differ from one card's at the chunk edges. The parameters stay whole on
every rank (the forward reads them all), so what it saves is the moments',
the scales' and the EMA's ``(fsdp - 1) / fsdp``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from agenda_tpu_torch.kernels.fused_adamw import BLOCK
from agenda_tpu_torch.parallel.mesh import MIN_SHARD_SIZE, Mesh, param_sharding_rules

Tensors = Dict[str, torch.Tensor]


def block_runs(n: int, fsdp: int) -> List[Tuple[int, int]]:
    """The fsdp runs (first element, end element) of a leaf of ``n`` elements:
    contiguous, whole 256-element blocks but the leaf's last, in fsdp order
    (a run is empty when the leaf has fewer blocks than ranks)."""
    nb = -(-n // BLOCK)
    per = -(-nb // fsdp)
    out = []
    for j in range(fsdp):
        b0, b1 = min(j * per, nb), min((j + 1) * per, nb)
        out.append((min(b0 * BLOCK, n), min(b1 * BLOCK, n)))
    return out


class BlockRuns:
    """The placement of ``params``' leaves on one rank of ``mesh``."""

    def __init__(self, params: Mapping[str, torch.Tensor], mesh: Mesh,
                 min_size: int = MIN_SHARD_SIZE):
        self.mesh = mesh
        rules = param_sharding_rules(params, mesh.fsdp, min_size)
        self.sizes = {k: p.numel() for k, p in params.items()}
        self.runs = {k: block_runs(self.sizes[k], mesh.fsdp)
                     for k, axis in rules.items() if axis is not None}

    @property
    def sharded(self) -> List[str]:
        return list(self.runs)

    def own(self, name: str) -> Optional[Tuple[int, int]]:
        """This rank's run of a sharded leaf (None for an empty one)."""
        s, e = self.runs[name][self.mesh.fsdp_index]
        return (s, e) if e > s else None

    def local(self, tensors: Mapping[str, torch.Tensor]) -> Tensors:
        """Views of this rank's runs of the sharded leaves (flat; leaves whose
        run is empty are left out) and the replicated leaves whole."""
        out = {}
        for k, t in tensors.items():
            if k not in self.runs:
                out[k] = t
            elif self.own(k) is not None:
                s, e = self.own(k)
                out[k] = t.detach().reshape(-1)[s:e]
        return out

    def take(self, name: str, full: torch.Tensor, per_block: bool = False) -> torch.Tensor:
        """This rank's part of a one-card tensor of leaf ``name``: its run, or
        with ``per_block`` its run's rows of a per-block tensor (the int8
        moments' scales); the whole tensor for a replicated leaf."""
        if name not in self.runs:
            return full
        s, e = self.own(name)
        if per_block:
            return full.reshape(-1)[s // BLOCK: -(-e // BLOCK)]
        return full.reshape(-1)[s:e]

    def global_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares of the whole gradient, from this rank's
        ``local`` gradients: the runs summed over the fsdp group, each
        replicated leaf once."""
        runs = [g.float() for k, g in grads.items() if k in self.runs]
        rest = [g.float() for k, g in grads.items() if k not in self.runs]
        dev = next(iter(grads.values())).device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        sq = torch.stack([sum((torch.sum(g * g) for g in runs), zero),
                          sum((torch.sum(g * g) for g in rest), zero)])
        if self.mesh.fsdp_group is not None:
            part = sq[:1].clone()
            dist.all_reduce(part, group=self.mesh.fsdp_group)
            sq = torch.cat([part, sq[1:]])
        return torch.sqrt(sq.sum())

    @torch.no_grad()
    def gather_(self, tensors: Mapping[str, torch.Tensor]) -> None:
        """Every run of each sharded leaf of ``tensors`` (full tensors of the
        leaves' shapes) broadcast in place from the rank that owns it."""
        for k, t in tensors.items():
            if k in self.runs:
                self._fill(t.reshape(-1), self.runs[k])

    def _fill(self, flat: torch.Tensor, runs) -> None:
        for j, (s, e) in enumerate(runs):
            if e > s:
                dist.broadcast(flat[s:e], src=self.mesh.fsdp_peer(j), group=self.mesh.fsdp_group)

    @torch.no_grad()
    def full(self, name: str, part: Optional[torch.Tensor], shape, dtype: torch.dtype,
             per_block: bool = False) -> torch.Tensor:
        """The one-card tensor of leaf ``name`` (``shape``, ``dtype``) from every
        rank's ``part`` (its run, or with ``per_block`` its run's rows of a
        per-block tensor; None for an empty run), on every rank of the fsdp
        group."""
        runs = self.runs[name]
        if per_block:
            runs = [(s // BLOCK, -(-e // BLOCK)) if e > s else (0, 0) for s, e in runs]
        out = torch.empty(shape, dtype=dtype, device=self.mesh.device)
        flat = out.reshape(-1)
        if part is not None:
            s, e = runs[self.mesh.fsdp_index]
            flat[s:e] = part.reshape(-1)
        self._fill(flat, runs)
        return out
