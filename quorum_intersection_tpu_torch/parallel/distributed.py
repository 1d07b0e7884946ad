"""Multi-process execution of the sharded sweep: ``torch.distributed`` under
the candidate mesh.

The port of the JAX package's ``parallel/distributed.py`` (``initialize``
``:81-191``, ``is_multihost`` ``:194``, ``global_candidate_mesh`` ``:200``,
``hybrid_candidate_mesh`` ``:213``).  Each process sweeps one contiguous
share of every program (:func:`..mesh.card_shares`), its cards' minimum
taken on its home card, and the sweep's one collective,
:func:`..mesh.mesh_pmin`, is one ``all_reduce(MIN)`` of an int32 a process
and program: NCCL between cards, gloo on the CPU.  Candidates never move
between processes; each card decodes its own indices.

SPMD contract of the sweep driver (the JAX module's, ``:17-25``, unchanged):
every process runs the same deterministic dispatch loop (same block
schedule, same ramp), enqueues the same programs in the same order, and
each program's result is the replicated min, so every process drains and
stops at the same program with no other coordination.  A process that
stopped early (a cancelled race arm) would leave the others waiting in a
collective: run multi-process meshes under ``gpu-sweep``, which does not
race.

Usage, one process per host or per card::

    from quorum_intersection_tpu_torch.parallel import distributed
    distributed.initialize("10.0.0.1:29500", num_processes=2, process_id=rank,
                           local_device_ids=[0, 1])
    mesh = distributed.global_candidate_mesh()
    backend = GpuSweepBackend(mesh=mesh)

Single-process runs are the degenerate case: ``initialize`` is a no-op and
the global mesh is the local one.  Where the JAX package reads a TPU pod's
environment to tell a multi-host job, the port reads torchrun's
(``WORLD_SIZE`` > 1, or ``MASTER_ADDR`` set), and takes the coordinator,
the process count and the rank from ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` where the caller gives none.
"""

from __future__ import annotations

import dataclasses
import os
import time
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import torch

from quorum_intersection_tpu_torch.parallel.mesh import CANDIDATE_AXIS, CandidateMesh, candidate_mesh
from quorum_intersection_tpu_torch.utils.env import qi_env_float
from quorum_intersection_tpu_torch.utils.faults import fault_point
from quorum_intersection_tpu_torch.utils.logging import get_logger
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

log = get_logger("parallel.distributed")

_initialized = False
# The local devices initialize() was given (local_device_ids), or None.
_local_devices: Optional[List[torch.device]] = None

# First-retry backoff of a failed join, doubled an attempt and capped, so the
# QI_DIST_INIT_TIMEOUT_S window is spent on retries (the JAX constants).
_INIT_BACKOFF_S = 0.5
_INIT_BACKOFF_CAP_S = 5.0

# Seam for tests: the retry backoff sleeps through this attribute.
_retry_sleep = time.sleep

# Failures no retry can mend in this process: the default group is already
# up (torch's "trying to initialize the default process group twice", a
# ValueError).  They degrade at once; anything else (a coordinator that is
# down or slow: DistNetworkError, DistStoreError, both RuntimeErrors) gets
# the bounded retries.
_UNRECOVERABLE_INIT_MARKERS = (
    "already initialized",
    "default process group twice",
)


def _torchrun_env() -> bool:
    """Whether the environment names a multi-process job (torchrun's)."""
    try:
        world = int(os.environ.get("WORLD_SIZE", "1") or "1")
    except ValueError:
        world = 1
    return world > 1 or "MASTER_ADDR" in os.environ


def _split_address(address: str) -> Tuple[str, int]:
    """``"host:port"`` or ``"tcp://host:port"`` → ``(host, port)``."""
    if address.startswith("tcp://"):
        address = address[len("tcp://"):]
    host, _, port = address.rpartition(":")
    return host or "localhost", int(port)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the multi-process runtime (idempotent): a ``torch.distributed``
    default group over a TCP store at ``coordinator_address`` (process 0
    serves it).

    ``local_device_ids`` are this process's cards (the ranks of
    :func:`global_candidate_mesh`).  ``backend`` None means ``nccl`` where
    the local devices are CUDA and ``gloo`` on the CPU.  A second call, or a
    call in a plainly single-process environment, is a no-op.

    A failed join (a dead or slow coordinator, the injected
    ``distributed.init`` fault) retries with exponential backoff under the
    ``QI_DIST_INIT_TIMEOUT_S`` budget, then degrades to single-process
    loudly: a warning plus a ``distributed.init_degraded`` event naming the
    cause and the attempts.
    """
    global _initialized, _local_devices
    if _initialized:
        return
    import torch.distributed as dist

    if local_device_ids is not None:
        _local_devices = [torch.device("cuda", int(i)) for i in local_device_ids]
    if dist.is_initialized():
        _initialized = True
        return
    if coordinator_address is None and num_processes is None and not _torchrun_env():
        log.debug("single-process environment; distributed init skipped")
        _initialized = True
        return
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1") or "1")
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0") or "0")
    if backend is None:
        cuda = local_device_ids is not None or torch.cuda.is_available()
        backend = "nccl" if cuda else "gloo"
    host, port = _split_address(coordinator_address)
    deadline = time.monotonic() + qi_env_float("QI_DIST_INIT_TIMEOUT_S", 20.0)
    attempt = 0
    rec = get_run_record()
    # One span over the whole join: every retry and the degrade land inside.
    with rec.span("distributed.init") as init_span:
        while True:
            attempt += 1
            try:
                fault_point("distributed.init")
                # The store's own wait is held to what is left of the budget;
                # the group's collectives keep torch's default timeout.
                left = max(deadline - time.monotonic(), 1.0)
                store = dist.TCPStore(host, port, num_processes, is_master=process_id == 0,
                                      timeout=timedelta(seconds=left))
                dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id)
                if attempt > 1:
                    log.info("distributed init succeeded on attempt %d", attempt)
                init_span.set(outcome="joined", backend=backend)
                break
            except (RuntimeError, ValueError) as exc:
                unrecoverable = any(marker in str(exc) for marker in _UNRECOVERABLE_INIT_MARKERS)
                delay = min(_INIT_BACKOFF_S * (2 ** (attempt - 1)), _INIT_BACKOFF_CAP_S)
                if not unrecoverable and time.monotonic() + delay < deadline:
                    log.info("distributed init failed (attempt %d: %s); retrying in %.1fs",
                             attempt, exc, delay)
                    _retry_sleep(delay)
                    continue
                log.warning("distributed init unavailable after %d attempt(s) (%s); "
                            "continuing single-process", attempt, exc)
                rec.event("distributed.init_degraded", cause=str(exc), attempts=attempt)
                init_span.set(outcome="degraded")
                break
        init_span.set(attempts=attempt)
    _initialized = True
    log.info("distributed runtime up: process %d/%d", process_index(), process_count())


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def is_multihost() -> bool:
    return process_count() > 1


def local_devices() -> List[torch.device]:
    """This process's cards: ``initialize``'s ``local_device_ids``, else
    every visible CUDA device."""
    if _local_devices is not None:
        return list(_local_devices)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_candidate_mesh(axis_name: str = CANDIDATE_AXIS,
                          devices: Optional[Sequence] = None) -> CandidateMesh:
    """The mesh over every process's local ranks, host-major: this
    process's ``devices`` (default :func:`local_devices`; a CPU or
    repeated-device list is taken as given) placed at its process index, so
    each process sweeps its own contiguous run of every block and only the
    final int32 crosses processes.  Every process must hold as many ranks."""
    import torch.distributed as dist

    local = candidate_mesh(devices=list(devices) if devices is not None else local_devices(),
                           axis_name=axis_name)
    if not dist.is_initialized():
        return local
    return dataclasses.replace(local, process_index=dist.get_rank(), process_count=dist.get_world_size(),
                               group=dist.group.WORLD)


def hybrid_candidate_mesh(axis_name: str = CANDIDATE_AXIS,
                          devices: Optional[Sequence] = None) -> CandidateMesh:
    """The JAX ``hybrid_candidate_mesh`` orders devices by slice topology
    (ICI within a slice, DCN across); CUDA gives no slice topology to order
    by, so this is :func:`global_candidate_mesh`, as the JAX function falls
    back to where topology metadata is absent."""
    log.debug("hybrid mesh unavailable (%s); using global mesh", "no slice topology on CUDA")
    return global_candidate_mesh(axis_name, devices)
