"""The mesh of shards the multi-device layer runs on (port of the JAX
`parallel/mesh.py`).

The JAX package lays a 1-D `jax.sharding.Mesh` over its devices: a `dp`
axis (fleet parallelism: sequences or robots, no collective in the steady
state) or an `sp` axis (the map, or the brute-force candidate grid, split
into shards whose per-point winners are min-combined with one all-gather).
A device holds a contiguous block of the sharded axis.

The port's `Mesh` carries the same: `n_shards` shards on an axis, held by
the processes of a `torch.distributed` group, each process a contiguous
block of `n_shards / world_size` shards on its own device, run one after
another (as a JAX device maps its block with `lax.map`). With no group one
process holds every shard: on one card all shards run in turn on it. The
code path is the same for world size 1 or n, and so are the results, bit
for bit: each shard's work does not depend on where it runs, and the
combine gathers the shards in shard order before it reduces them.

`make_mesh` refuses a mesh the world does not fit (JAX's raises past its
device count, mesh.py:28-29): a shard count the world size does not divide,
an NCCL group on CPU tensors or whose ranks share a card, or no group at
all. The one-process form, which runs every shard here, is asked for by
name (`single_process=True`), so a process of a group never runs the whole
mesh by default; no card count is assumed.

Backends: NCCL on cards. Gloo's `all_gather` takes CPU tensors only, so a
gloo group that carries card tensors (several ranks on one card, where NCCL
refuses) stages each gather through the host explicitly (`Mesh.gather`).
"""

from __future__ import annotations

import dataclasses
import socket
import zlib

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`n_shards` shards on `axis`, this process's block of them on
    `device`; `group` is the torch.distributed group of the processes that
    hold the shards, or None when this process holds them all."""

    n_shards: int
    axis: str
    device: torch.device
    group: object | None = None

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def local_shards(self) -> range:
        """The contiguous block of shard indices this process holds."""
        per = self.n_shards // self.world_size
        return range(self.rank * per, (self.rank + 1) * per)

    def local_block(self, n: int) -> slice:
        """This process's block of a leading axis of `n` rows split evenly
        over the shards (a batch of sequences, a sharded map)."""
        if n % self.n_shards:
            raise ValueError(f"batch {n} not a multiple of mesh size {self.n_shards}")
        per = n // self.n_shards
        r = self.local_shards
        return slice(r.start * per, r.stop * per)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """All-gather this process's block (leading axis: its shards, in
        order) into the whole mesh's (n_shards, ...) on `device`, in shard
        order. With no group it is `local`. A gloo group gathers CPU
        tensors: card tensors are staged through the host and back."""
        if self.group is None:
            return local
        staged = dist.get_backend(self.group) == "gloo" and local.is_cuda
        x = (local.cpu() if staged else local).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts).to(local.device)

    def gather_tree(self, local):
        """`gather` over every tensor of a (nested) NamedTuple whose leading
        axis is this process's block; None and Python scalars are kept."""
        return tree_map(self.gather, local)

    def combine_winners(
        self, d2s: list[torch.Tensor], payloads: list[torch.Tensor]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The per-point winners over every shard of the mesh from this
        process's shards' (d2 (nSt, 1, TM), payload (nSt, C, TM)), listed in
        shard order: gather both over the group, then the first argmin over
        the shard axis, so an exact tie keeps the earlier shard
        (`jnp.argmin`'s rule)."""
        return first_argmin(self.gather(torch.stack(d2s)), self.gather(torch.stack(payloads)))

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A () bool flag OR-ed over the group's processes."""
        return self.gather(flag.reshape(1)).any()


def first_argmin(d2_all: torch.Tensor, payload_all: torch.Tensor):
    """(d2, payload) of each point's first argmin over the leading shard
    axis of d2_all (n, nSt, 1, TM) and payload_all (n, nSt, C, TM)."""
    win = torch.argmin(d2_all, dim=0, keepdim=True)  # (1, nSt, 1, TM)
    d2 = torch.gather(d2_all, 0, win)[0]
    payload = torch.gather(payload_all, 0, win.expand(1, *payload_all.shape[1:]))[0]
    return d2, payload


def tree_map(fn, *trees):
    """`fn` over the tensors of matching (nested) NamedTuples; None and
    Python scalars are taken from the first tree."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[tree_map(fn, *xs) for xs in zip(*trees)])
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return first


def tree_index(tree, b: int):
    """Row `b` of every tensor of a batched tree (one sequence or robot)."""
    return tree_map(lambda x: x[b], tree)


def tree_stack(items):
    """Trees stacked tensor by tensor along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *items)


def make_mesh(
    n_shards: int,
    axis: str = "dp",
    device: torch.device | str = torch.device("cuda"),
    group=None,
    single_process: bool = False,
) -> Mesh:
    """A mesh of `n_shards` shards on `axis` ("dp" or "sp").

    `single_process=True`: this process holds every shard on `device` (the
    one-card form; `group` must be None). Otherwise the shards are split
    over `group` (the default group when None; torch.distributed must then
    be initialised), each rank a contiguous block on its own `device`.
    Raises where the world does not fit the mesh."""
    if n_shards < 1:
        raise ValueError(f"make_mesh: {n_shards} shards")
    dev = torch.device(device)
    if single_process:
        if group is not None:
            raise ValueError("make_mesh: single_process=True takes no process group")
        return Mesh(n_shards, axis, dev)
    if group is None:
        if not dist.is_initialized():
            raise ValueError(
                "make_mesh: torch.distributed is not initialised; pass a group, or "
                "single_process=True to hold every shard in this process"
            )
        group = dist.group.WORLD
    world = dist.get_world_size(group)
    if n_shards % world:
        raise ValueError(f"make_mesh: {n_shards} shards do not split over {world} ranks")
    backend = dist.get_backend(group)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"make_mesh: an NCCL group needs card tensors, not {dev}")
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        me = torch.tensor([zlib.crc32(socket.gethostname().encode()), index], device=dev)
        ids = [torch.zeros_like(me) for _ in range(world)]
        dist.all_gather(ids, me, group=group)
        if len({tuple(i.tolist()) for i in ids}) != world:
            raise ValueError("make_mesh: ranks of an NCCL group share a card (NCCL refuses it)")
    return Mesh(n_shards, axis, dev, group)


def batch_sharding(mesh: Mesh):
    """The placement of a tensor whose leading (batch) axis is split over
    the mesh (JAX's `NamedSharding(mesh, P(axis))`): checks that the axis
    splits evenly, and moves the tensor to this process's device; each
    process then takes its block (`Mesh.local_block`)."""

    def place(x: torch.Tensor) -> torch.Tensor:
        mesh.local_block(x.shape[0])
        return x.to(mesh.device)

    return place


def replicated(mesh: Mesh):
    """The placement of a tensor every shard reads whole (JAX's
    `NamedSharding(mesh, P())`): on this process's device."""
    return lambda x: x.to(mesh.device)
