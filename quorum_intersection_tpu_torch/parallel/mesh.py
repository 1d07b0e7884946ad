"""The candidate mesh: ranks over the candidate-subset axis, and their one
collective.

The port of the JAX package's ``parallel/mesh.py`` (``candidate_mesh``
``:33-48``, ``CANDIDATE_AXIS`` ``:30``).  JAX's mesh is one controller over
N devices; so is :class:`CandidateMesh`: one process drives its ranks (its
``devices``, in order), and a ``torch.distributed`` group joins several such
processes host-major, as ``distributed.global_candidate_mesh`` orders them.
Each rank sweeps its own sub-block of every block of a program (the sharded
instance of ``kernels/csrc/sweep.cu``); the only communication is
:func:`mesh_pmin`, the port's ``lax.pmin`` over the ranks' first-hit
indices: one int32 per rank and program.

A mesh may list one device several times: the ranks then share that card
(or the CPU), one after the other on its current stream.  It is the port's
counterpart of the JAX tests' emulated host devices
(``--xla_force_host_platform_device_count=8``), reachable through
``candidate_mesh(devices=...)`` or, on the CPU, ``candidate_mesh(n,
device="cpu")``; a CUDA mesh built by count never repeats a card.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device

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


def mesh_pmin(mesh: CandidateMesh, per_rank: Sequence[torch.Tensor]) -> torch.Tensor:
    """The port's ``lax.pmin`` (JAX ``sweep.py:2249``): the min of this
    process's ranks' 0-dim int32 results on the mesh's home device, then,
    across processes, one ``all_reduce(MIN)`` over the group.

    On the card each rank's result joins the home device's stream behind an
    event recorded on the stream of the card that computed it, so the min
    waits for every rank and nothing on the host does.  ``nccl`` reduces on
    the card; ``gloo`` reduces a host copy of the result (which waits for
    this process's ranks) and puts it back on the home device.  A failed
    collective raises: the solve fails."""
    home = mesh.home
    if home.type == "cuda":
        home_stream = torch.cuda.current_stream(home)
        gathered = []
        for t in per_rank:
            if t.device != home:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(t.device))
                home_stream.wait_event(ready)
                with torch.cuda.device(home):
                    t = t.to(home, non_blocking=True)
            gathered.append(t)
        with torch.cuda.device(home):
            best = torch.stack(gathered).min()
    else:
        best = torch.stack(list(per_rank)).min()
    if mesh.process_count > 1:
        import torch.distributed as dist

        if home.type == "cuda" and collective_of(mesh) == "gloo":
            host = best.cpu()
            dist.all_reduce(host, op=dist.ReduceOp.MIN, group=mesh.group)
            best = host.to(home)
        else:
            with torch.cuda.device(home) if home.type == "cuda" else nullcontext():
                dist.all_reduce(best, op=dist.ReduceOp.MIN, group=mesh.group)
    return best

