"""The fogs' wire: one fog partition per ``torch.distributed`` rank.

The paper's runtime (§III-E) runs every fog as its own machine; in each
BSP superstep the fogs swap boundary rows over the network. With a process
group, ``runtime.bsp`` runs shard ``r`` on rank ``r`` and its per-layer
exchange is a list-form ``torch.distributed.all_gather`` of each rank's
rows (``gather_rows``): the f32 boundary rows, or on the DAQ wire their
uint8 codes, scales and mins, one ``all_gather`` each. Every sync's bytes
land in ``WIRE``, a plain counter beside the kernel wrappers' ``launches``.
The gather of the last layer's rows (every rank returns the whole result)
is not a BSP sync and is not counted.

A plan's fogs need not be the whole world: after ``Engine.fail_nodes`` the
survivors' fogs keep their processes, and the plan records which world
rank holds each fog (``Plan.fog_ranks``). ``group_of`` gives the process
group of those ranks (``FogGroup``), made once per set of ranks and cached
(the world's own set is the default group). Making a group is collective
over the whole world: every rank calls ``group_of`` for the same sets in
the same order, members or not, which the executor does where every rank
binds a plan. A rank outside the group holds no shard, enters no BSP sync
and receives the result from the group's first member (``share``, one
broadcast over the world, not a sync either).

The collectives take whatever backend the group has; ``spawn``'s groups
are gloo. On one card several ranks share the device and NCCL refuses
that, so they run on gloo, which
takes CUDA tensors and stages them through host memory: that staging is
the wire between the fogs, as a fog LAN is, and the layers' arithmetic
stays on the card.

``spawn`` starts ``world`` ranks with ``torch.multiprocessing.spawn``
(start method ``spawn``, ``join=True``): each rank joins the group by a
``file://`` rendezvous with a timeout, runs ``fn(rank, *args)`` and leaves
the group; if any rank raises, the parent raises and the other ranks are
ended.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: Seconds a rank waits in a collective before the group gives up.
TIMEOUT_S = 60


class Wire:
    """What this process's BSP syncs put on the wire since ``reset``.

    ``bytes`` sums every sync's gathered payload (each rank's rows times
    the world size, as ``bsp.exchange_bytes`` prices one sync),
    ``sync_bytes`` lists it per sync in order. With ``timed`` set, each
    sync waits for the device before and after its ``all_gather`` calls
    and ``seconds`` lists their wall time per sync.
    """

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.bytes = 0
        self.sync_bytes: List[int] = []
        self.seconds: List[float] = []


WIRE = Wire()


def _synchronize(tensors) -> None:
    for t in tensors:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def gather_rows(tensors: Sequence[torch.Tensor], dims: Sequence[int], group,
                sync: bool = True) -> List[torch.Tensor]:
    """Every rank's ``tensors``, concatenated in rank order along ``dims``
    (one list-form ``all_gather`` per tensor). ``sync`` marks a BSP sync,
    whose bytes and (when timed) seconds ``WIRE`` counts."""
    world = dist.get_world_size(group)
    timed = sync and WIRE.timed
    if timed:
        _synchronize(tensors)
        t0 = time.perf_counter()
    out = []
    for t, dim in zip(tensors, dims):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        out.append(torch.cat(parts, dim))
    if sync:
        moved = world * sum(t.numel() * t.element_size() for t in tensors)
        WIRE.bytes += moved
        WIRE.sync_bytes.append(moved)
        if timed:
            _synchronize(out)
            WIRE.seconds.append(time.perf_counter() - t0)
    return out


@dataclasses.dataclass(frozen=True)
class FogGroup:
    """The processes of a plan's fogs: fog ``p`` runs on world rank
    ``ranks[p]`` (increasing), all of them in ``group``; the result
    reaches every rank of ``over`` (a superset of ``group``)."""
    ranks: Tuple[int, ...]
    group: object     # GroupMember.NON_GROUP_MEMBER on a rank outside it
    over: object

    @property
    def shard(self) -> int:
        """This process's fog (its rank in ``group``), -1 outside it."""
        return dist.get_rank(self.group)

    @property
    def whole(self) -> bool:
        """Whether every rank of ``over`` holds a fog."""
        return len(self.ranks) == dist.get_world_size(self.over)


#: The groups this process made, by their world ranks, in the order made,
#: under the default group ``_made_under``.
_made: Dict[Tuple[int, ...], object] = {}
_made_under = None


def _groups() -> Dict[Tuple[int, ...], object]:
    global _made, _made_under
    if _made_under is not dist.group.WORLD:
        _made, _made_under = {}, dist.group.WORLD
    return _made


def group_of(ranks: Sequence[int]) -> FogGroup:
    """The fogs on world ranks ``ranks`` (increasing, distinct). The first
    call for a set makes its group (``dist.new_group``), which is
    collective over the world: every rank must make the same calls in the
    same order. The whole world's set is the default group."""
    ranks = tuple(int(r) for r in ranks)
    world = dist.get_world_size()
    if (not ranks or list(ranks) != sorted(set(ranks)) or ranks[0] < 0
            or ranks[-1] >= world):
        raise ValueError(f"fog ranks must be distinct increasing ranks of "
                         f"the world of {world}, got {ranks}")
    made = _groups()
    if ranks not in made:
        made[ranks] = (dist.group.WORLD if len(ranks) == world else
                       dist.new_group(list(ranks),
                                      timeout=timedelta(seconds=TIMEOUT_S)))
    return FogGroup(ranks, made[ranks], dist.group.WORLD)


def groups_made() -> List[Tuple[int, ...]]:
    """The rank sets whose groups this process made, in order."""
    return list(_groups())


def as_fog_group(group) -> FogGroup:
    """``group`` itself if a ``FogGroup``; a process group of this rank
    holds one fog on each of its ranks, and the result stays in it."""
    if isinstance(group, FogGroup):
        return group
    return FogGroup(tuple(dist.get_process_group_ranks(group)), group, group)


#: int64 slots of ``share``'s header: the table count, then per table
#: its rank and its sizes.
_HEADER = 32


def share(tensors: Optional[Sequence[torch.Tensor]], fogs: FogGroup,
          device) -> List[torch.Tensor]:
    """The fogs' f32 result tables on every rank of ``fogs.over``: the
    group's first member broadcasts a header of their shapes, then each
    table. A rank outside the group passes None and gets tables on
    ``device``; a member passes its tables (all members hold the same).
    Not a BSP sync: ``WIRE`` does not count it."""
    if fogs.whole:
        return list(tensors)
    src = fogs.ranks[0]
    header = torch.zeros(_HEADER, dtype=torch.int64)
    if tensors is not None:
        dims = [len(tensors)]
        for t in tensors:
            if t.dtype != torch.float32:
                raise TypeError(f"share sends f32 tables, got {t.dtype}")
            dims += [t.ndim, *t.shape]
        if len(dims) > _HEADER:
            raise ValueError(f"share's header holds {_HEADER} sizes, the "
                             f"tables need {len(dims)}")
        header[:len(dims)] = torch.tensor(dims)
    dist.broadcast(header, src, group=fogs.over)
    if tensors is None:
        dims, tensors, i = header.tolist(), [], 1
        for _ in range(dims[0]):
            nd = dims[i]
            tensors.append(torch.empty(dims[i + 1:i + 1 + nd],
                                       dtype=torch.float32, device=device))
            i += 1 + nd
    tensors = [t.contiguous() for t in tensors]
    for t in tensors:
        dist.broadcast(t, src, group=fogs.over)
    return tensors


def check_same(digest: bytes, group, device, what: str) -> None:
    """Raise on every rank unless all ranks of ``group`` hold the same
    ``digest`` (an ``all_gather`` of it)."""
    mine = torch.tensor(np.frombuffer(digest, np.uint8), device=device)
    (every,) = gather_rows([mine], [0], group, sync=False)
    every = every.reshape(dist.get_world_size(group), -1).cpu()
    differ = [r for r in range(len(every))
              if not torch.equal(every[r], every[0])]
    if differ:
        raise RuntimeError(f"the ranks disagree on {what}: ranks {differ} "
                           f"differ from rank 0")


def digest(*arrays) -> bytes:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.digest()


def _rank_main(rank: int, fn: Callable, world: int, rendezvous: str,
               args) -> None:
    torch.set_num_threads(1)     # the ranks share the host's cores
    dist.init_process_group("gloo", init_method="file://" + rendezvous,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, rendezvous_dir: str, *args) -> None:
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks of one process group.

    ``fn`` must be importable by name (a module-level function). The ranks
    meet through a file under ``rendezvous_dir``, which must not hold one
    from an earlier group. Each rank runs one intra-op thread. Build the
    kernels (``kernels.build.build()``) before a CUDA spawn, so the ranks
    load them instead of each waiting on one build.
    """
    rendezvous = os.path.join(os.path.abspath(rendezvous_dir), "rendezvous")
    if os.path.exists(rendezvous):
        raise ValueError(f"{rendezvous} exists: a rendezvous file serves "
                         f"one group")
    torch.multiprocessing.spawn(
        _rank_main, args=(fn, world, rendezvous, args),
        nprocs=world, join=True, start_method="spawn")
