"""The candidate mesh: ranks over the candidate-subset axis, and their one
collective.

The port of the JAX package's ``parallel/mesh.py`` (``candidate_mesh``
``:33-48``, ``CANDIDATE_AXIS`` ``:30``).  JAX's mesh is one controller over
N devices; so is :class:`CandidateMesh`: one process drives its ranks (its
``devices``, in order), and a ``torch.distributed`` group joins several such
processes host-major, as ``distributed.global_candidate_mesh`` orders them.

A sweep program covers one contiguous index range, which :func:`card_shares`
cuts into one contiguous range a card: each process takes its ranks' part,
and each card of the process its own ranks' part of that.  (JAX's ranks
sweep sub-block ``r`` of every block instead; the indices covered, and so
their minimum, are the same.)  A program is then one launch a card
(``kernels/sweep_cuda.py`` :class:`MeshSweep`), the cards' minimum taken on
the home card's device, and the only communication left is
:func:`mesh_pmin`, the port's ``lax.pmin`` across processes: one int32 a
process and program.

A mesh may list one device several times: the ranks then share that card
(or the CPU), and its range covers all of theirs.  It is the port's
counterpart of the JAX tests' emulated host devices
(``--xla_force_host_platform_device_count=8``), reachable through
``candidate_mesh(devices=...)`` or, on the CPU, ``candidate_mesh(n,
device="cpu")``; a CUDA mesh built by count never repeats a card.

The frontier under a mesh needs a second collective, :func:`mesh_all_gather`,
the port's tiled ``lax.all_gather`` (JAX ``backends/tpu/frontier.py:361``):
every rank's stash share of an iteration reaches every rank's stash.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.kernels.sweep_cuda import INDEX_CEILING, KernelLimitError, Share

CANDIDATE_AXIS = "candidates"

# Ranks a CPU mesh may hold: the JAX tests' emulated host devices
# (tests/conftest.py, --xla_force_host_platform_device_count=8).
CPU_RANKS = 8


@dataclass(frozen=True)
class CandidateMesh:
    """This process's ranks over the candidate axis.

    ``devices`` are its ranks in order; ``process_index`` and
    ``process_count`` place it among the processes of ``group`` (a
    ``torch.distributed`` process group, None in a single process).  Every
    process holds the same number of ranks, and global rank ``g =
    process_index · len(devices) + local``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = CANDIDATE_AXIS
    process_index: int = 0
    process_count: int = 1
    group: Optional[object] = None

    @property
    def size(self) -> int:
        """Global ranks: local ranks × processes."""
        return len(self.devices) * self.process_count

    @property
    def home(self) -> torch.device:
        """Where the ranks' results meet: the first local device."""
        return self.devices[0]

    def global_rank(self, local: int) -> int:
        return self.process_index * len(self.devices) + local

    def describe(self) -> str:
        """``"cuda:0 x4"``-style summary of the local ranks, for stats."""
        names = [str(d) for d in self.devices]
        if len(set(names)) == 1:
            return f"{names[0]} x{len(names)}"
        return ",".join(names)


def _as_device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return resolve_device(dev)


def candidate_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axis_name: str = CANDIDATE_AXIS,
    device: DeviceLike = None,
) -> CandidateMesh:
    """1-D mesh over the candidate axis, in this process.

    With no ``devices``, every visible CUDA device; ``n_devices`` takes a
    prefix and raises where more are asked for than there are (the JAX
    text).  ``device="cpu"`` builds ``n_devices`` CPU ranks (at most
    :data:`CPU_RANKS`; one without a count: the CPU is one device).  A
    mesh never shrinks and never moves to the CPU unasked."""
    if devices is not None:
        devs = [_as_device(d) for d in devices]
    elif device is not None and resolve_device(device).type == "cpu":
        if n_devices is None:
            n_devices = 1
        if n_devices > CPU_RANKS:
            raise ValueError(f"requested {n_devices} devices, have {CPU_RANKS}")
        devs = [torch.device("cpu")] * n_devices
    else:
        resolve_device(device)  # CUDA without a card raises here
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a candidate mesh needs at least one device")
    return CandidateMesh(devices=tuple(devs), axis_name=axis_name)


def mesh_device(mesh: Optional[CandidateMesh], device: DeviceLike) -> torch.device:
    """The device a backend runs on: ``device`` without a mesh; under one,
    the mesh's home device, which a given ``device`` must equal (``"cuda"``
    without an index names no card and matches a CUDA home)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        dev = resolve_device(device)
        if dev.type != mesh.home.type or (dev.index is not None and dev.index != mesh.home.index):
            raise ValueError(f"mesh on {mesh.describe()} but device={device}")
    return mesh.home


def collective_of(mesh: CandidateMesh) -> str:
    """How :func:`mesh_pmin` combines across processes: ``"none"`` in one
    process, ``"nccl"``, or ``"gloo"`` (which reduces a host copy of a
    card's result)."""
    if mesh.process_count <= 1:
        return "none"
    import torch.distributed as dist

    return str(dist.get_backend(mesh.group)).lower()


def card_shares(mesh: CandidateMesh, per_dev: int, steps: int, start: int) -> List[Share]:
    """This process's cards' shares of the program ``[start, start + steps ·
    per_dev · mesh.size)``: ``(card, first index, rows)`` a distinct card of
    ``mesh.devices``, in the order of its first appearance (the home card
    first).  Process ``p`` of ``L`` local ranks takes the contiguous ``[start
    + p·L·per_dev·steps, + L·per_dev·steps)``, and within it each card ``k ·
    per_dev · steps`` rows, ``k`` its ranks.  Every process's shares tile the
    program once.  The whole program must lie below the kernel's 2^31 index
    ceiling (:class:`KernelLimitError` before any launch, on every process
    alike)."""
    rank_rows = per_dev * steps
    end = start + rank_rows * mesh.size
    if rank_rows < 1 or start < 0 or end > INDEX_CEILING:
        raise KernelLimitError(f"mesh program [{start}, {end}) is empty or crosses the 2^31 index ceiling")
    at = start + mesh.process_index * len(mesh.devices) * rank_rows
    shares = []
    for dev in dict.fromkeys(mesh.devices):
        rows = mesh.devices.count(dev) * rank_rows
        shares.append((dev, at, rows))
        at += rows
    return shares


def mesh_pmin(mesh: CandidateMesh, best: torch.Tensor) -> torch.Tensor:
    """The port's ``lax.pmin`` (JAX ``sweep.py:2249``) across processes:
    ``best``, this process's minimum (a 0-dim int32 on the mesh's home
    device, its cards' minimum already taken there), through one
    ``all_reduce(MIN)`` over the group; ``best`` itself in one process.
    ``nccl`` reduces on the card; ``gloo`` reduces a host copy of the result
    (which waits for this process's cards) and puts it back on the home
    device.  A failed collective raises: the solve fails."""
    if mesh.process_count <= 1:
        return best
    import torch.distributed as dist

    home = mesh.home
    if home.type == "cuda" and collective_of(mesh) == "gloo":
        host = best.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.MIN, group=mesh.group)
        return host.to(home)
    with torch.cuda.device(home) if home.type == "cuda" else nullcontext():
        dist.all_reduce(best, op=dist.ReduceOp.MIN, group=mesh.group)
    return best


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.device == b.device and a.data_ptr() == b.data_ptr() and a.numel() == b.numel()


def _ordered_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` on the card behind an event recorded on the stream
    of the card that wrote ``src``; nothing on the host waits."""
    if dst.device.type == "cuda" and src.device != dst.device:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        torch.cuda.current_stream(dst.device).wait_event(ready)
        with torch.cuda.device(dst.device):
            dst.copy_(src, non_blocking=True)
    else:
        dst.copy_(src)


def mesh_all_gather(mesh: CandidateMesh, per_rank: Sequence[torch.Tensor],
                    out: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """The port's tiled ``lax.all_gather`` (JAX ``frontier.py:361``): every
    global rank's share, in global rank order, on every local rank.

    ``per_rank[i]`` is local rank ``i``'s share, a contiguous 1-D tensor on
    ``mesh.devices[i]``, all of one length ``m`` and dtype; the result on
    each local rank is ``mesh.size · m`` long, written into ``out[i]`` where
    given (which may hold ``per_rank[i]`` at its own place: that share is
    then not copied).  In one process the shares meet in the home rank's
    result and the whole goes back to the other ranks, by device copies on
    the cards' current streams ordered by events: nothing on the host waits.
    Across processes the home rank's part of the whole goes through one
    ``all_gather`` over the group, as bytes: ``all_gather_into_tensor`` on
    the card under ``nccl``, a host copy under ``gloo`` (as
    :func:`mesh_pmin` reduces).  A failed collective raises: the solve
    fails."""
    L = len(mesh.devices)
    if len(per_rank) != L:
        raise ValueError(f"{len(per_rank)} shares for a mesh of {L} local ranks")
    m = per_rank[0].numel()
    if any(t.numel() != m or t.dtype != per_rank[0].dtype or t.dim() != 1 for t in per_rank):
        raise ValueError("mesh_all_gather takes 1-D shares of one length and dtype")
    n = mesh.size
    if out is None:
        outs = [torch.empty(n * m, dtype=per_rank[0].dtype, device=d) for d in mesh.devices]
    else:
        outs = list(out)
        if len(outs) != L or any(o.numel() != n * m or o.dim() != 1 for o in outs):
            raise ValueError(f"mesh_all_gather writes {L} 1-D results of {n * m} elements")
    home = outs[0]
    for i, t in enumerate(per_rank):
        g = mesh.global_rank(i)
        dst = home[g * m:(g + 1) * m]
        if not _same_memory(dst, t):
            _ordered_copy(dst, t)
    if mesh.process_count > 1:
        import torch.distributed as dist

        whole = home.view(torch.uint8)
        mine = home[mesh.process_index * L * m:(mesh.process_index + 1) * L * m].view(torch.uint8)
        if home.device.type == "cuda" and collective_of(mesh) != "gloo":
            with torch.cuda.device(home):
                dist.all_gather_into_tensor(whole, mine.clone(), group=mesh.group)
        else:
            host = mine.cpu()
            parts = [torch.empty_like(host) for _ in range(mesh.process_count)]
            dist.all_gather(parts, host, group=mesh.group)
            whole.copy_(torch.cat(parts))
    for o in outs[1:]:
        if not _same_memory(o, home):
            _ordered_copy(o, home)
    return outs
