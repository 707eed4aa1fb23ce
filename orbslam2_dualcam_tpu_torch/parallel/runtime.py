"""Mesh runtime: routes bundle adjustment to the distributed solver when a
mesh is attached and the problem is big enough.

Port of orbslam2_dualcam_tpu/parallel/runtime.py.  The reference attaches a
`jax.sharding.Mesh(devices, ("data",))` to the System; here a `Mesh` is a
tuple of torch devices, one per shard of the edge table, with an optional
`torch.distributed` process group across which the shards of several
processes are summed (the reference's multi-controller JAX).  A device may
repeat: shards on one device form a virtual mesh, the counterpart of the
reference's `--xla_force_host_platform_device_count` CPU mesh and the only
way to run more than one shard on one card.

Every global-BA call site goes through `solve_ba_auto`: small problems stay
on one device (the reductions would dominate), large ones shard their edge
table over the mesh (parallel/dist_ba.py).  The threshold is in EDGES, the
only O(n)-growing axis of BA.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from orbslam2_dualcam_tpu_torch.optim import ba
from orbslam2_dualcam_tpu_torch.optim.ba import BAProblem, BAResult
from orbslam2_dualcam_tpu_torch.parallel import dist_ba
from orbslam2_dualcam_tpu_torch.utils.config import BAConfig
from orbslam2_dualcam_tpu_torch.utils.device import resolve_device

# edges below this stay single-device: one LM step's reductions would cost
# more than the sharded edge work saves
DIST_EDGE_THRESHOLD = 16384


@dataclass(frozen=True)
class Mesh:
    """`devices`: one torch device per shard of this process (repeats make a
    virtual mesh).  `group`: a `torch.distributed` process group whose every
    rank holds a mesh of as many shards and calls the solver on the
    identical problem; None for one process.  Shard g of `size` takes edge
    rows [g E/size, (g+1) E/size); this process holds shards
    rank * len(devices) onwards."""

    devices: tuple
    group: Optional[object] = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a Mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(resolve_device(d) for d in self.devices))

    @property
    def n_ranks(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        rank = 0 if self.group is None else dist.get_rank(self.group)
        return rank * len(self.devices)

    @property
    def size(self) -> int:
        """The shard count over all processes."""
        return len(self.devices) * self.n_ranks

    def all_reduce(self, partials: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over every shard of the mesh of one partial per local
        shard, returned once per local shard.  The local partials are summed
        in shard order on the first shard's device, that total is summed
        across the group's ranks (each rank receives the same reduced
        buffer), and one copy goes to each distinct device: every shard
        holds identical bits, so state updated from it stays replicated.
        `partials[0]` may be overwritten."""
        total = partials[0]
        for p in partials[1:]:
            total = total + p.to(total.device)
        if self.group is not None:
            dist.all_reduce(total, group=self.group)
        on = {total.device: total}
        for d in self.devices:
            if d not in on:
                on[d] = total.to(d)
        return [on[d] for d in self.devices]

    def concat(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        """One equal-sized block per local shard -> their concatenation in
        shard order over the whole mesh, on the first shard's device.
        Across the group this is an all-reduce of a zero-filled tensor that
        holds each rank's own blocks (gloo cannot all-gather CUDA
        tensors)."""
        local = torch.cat([b.to(self.devices[0]) for b in blocks])
        if self.group is None:
            return local
        start = self.first_shard * blocks[0].shape[0]
        full = local.new_zeros((self.size * blocks[0].shape[0],
                                *local.shape[1:]))
        full[start:start + local.shape[0]] = local
        dist.all_reduce(full, group=self.group)
        return full

    def check_same_problem(self, *shape: int) -> None:
        """Across the group's ranks, raise if any rank was handed another
        problem shape (an all-reduce of different shapes would hang)."""
        if self.group is None:
            return
        dev = (self.devices[0] if dist.get_backend(self.group) == "nccl"
               else torch.device("cpu"))
        v = torch.tensor((*shape, self.size), dtype=torch.int64)
        both = torch.cat([v, -v]).to(dev)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        hi, lo = both[:len(v)].tolist(), (-both[len(v):]).tolist()
        if hi != lo:
            raise ValueError(
                f"distributed BA: the ranks were handed different problems "
                f"(max {hi}, min {lo} of {v.tolist()}, the (K, M, E, size) "
                f"of this rank)")


def default_mesh() -> Optional[Mesh]:
    """A mesh over every local CUDA device (None below two devices)."""
    n = torch.cuda.device_count()
    if n < 2:
        return None
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def solve_ba_auto(prob: BAProblem, T_sc, adj_sc, Ks, iters: int,
                  mesh: Optional[Mesh] = None,
                  cfg: BAConfig = BAConfig(),
                  cg_iters: int = 24, robust: bool = True,
                  dist_edge_threshold: int = DIST_EDGE_THRESHOLD) -> BAResult:
    """Single-device or mesh-distributed BA, chosen by problem size.

    Used by every global-BA call site in the pipeline (loop closing's GBA,
    the dual bootstrap's metric GBA), so the same code path serves a small
    map and a large one."""
    E = prob.edges.kf.shape[0]
    if mesh is not None and E >= dist_edge_threshold:
        if E % mesh.size == 0:
            return dist_ba.solve_ba_distributed(
                prob, T_sc, adj_sc, Ks, mesh, iters=iters,
                cg_iters=cg_iters, cfg=cfg, robust=robust)
        # never silent: edge buckets are powers of two, so this can only
        # trip on a mesh whose size is not a power of two
        logging.getLogger(__name__).warning(
            "solve_ba_auto: E=%d not divisible by mesh size %d — "
            "falling back to single-device BA (pad the edge bucket)",
            E, mesh.size)
    return ba.solve_ba(prob, T_sc, adj_sc, Ks, iters=iters, cfg=cfg,
                       cg_iters=cg_iters, robust=robust)
