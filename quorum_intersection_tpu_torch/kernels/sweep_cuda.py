"""Wrapper of the fused CUDA sweep kernel (``csrc/sweep.cu``).

:class:`FusedSweep` holds one sweep problem's tables on its device and
:meth:`FusedSweep.program` evaluates ``steps × batch`` candidates from a start
index, returning the smallest hit index as a 0-dim int32 tensor
(``INT32_MAX`` on a clean miss) — the contract of the JAX package's
``sweep_program_factory`` programs.

On a CUDA device it launches the kernel (:func:`sweep_fused`, which counts
its launches) or raises; it never falls back.  On the CPU it runs the plain
version (:mod:`.sweep_ref`) — only because the tables lie on the CPU.

:class:`MeshSweep` runs a mesh program (the JAX package's sharded step
K11, ``TpuSweepBackend._build_sharded_step``,
``backends/tpu/sweep.py:2196-2261``) on the cards of one process: one
:class:`FusedSweep` a card, each card's contiguous range
(``parallel.mesh.card_shares``) in one launch of the same kernel, every
card's minimum taken straight into the home card's result slot
(:func:`sweep_mesh`, one C call a program, counted a card launch at a time
apart from :func:`sweep_fused`).

The kernel takes the votes as b1 and-popc tensor-core products, 16 rows a
warp (``csrc/warp_mma.cuh``).  :func:`plane_tables` lays the circuit out as
the kernel reads it (shared with the block guard, :mod:`.guard_cuda`, and
the frontier, :mod:`.frontier_cuda`): per 32-unit chunk, in the order a
fixpoint pass reads them, one 512-byte block of B fragments per member
bit-plane and node k-slab (128 node columns; two slabs only for the
frontier's rows past 128 nodes) and one per child bit-plane and child
k-slab (128 child columns) where the chunk has a nonzero column.  The host
picks the instance from the tables' size before any launch: resident in
shared memory, or streamed through it.

Kernel limits, checked before any launch (:class:`KernelLimitError`):
``n <= 64`` nodes (an availability row is two words of one 128-bit k-slab;
the sweep's 2^44 enumeration ceiling keeps a restricted SCC at 45), vote
counts below 2^8 (8 bit-planes; the encoder rejects larger counts),
candidate indices below 2^31, and a block's per-warp satisfaction slots
within the shared memory one block may take (about 100 child k-slabs: some
12 800 child units, where the encoder's circuits hold hundreds).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import INT32_MAX
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit, pack_mask_words
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.sweep_ref import SweepRef

MAX_NODES = 64
MAX_PLANES = 8
NODE_SLABS = 2  # node k-slabs the evaluator's rows span at most (warp_mma.cuh Warp's kNS)
INDEX_CEILING = 1 << 31
# Shared memory one block may opt into on Hopper (227 KB).
SMEM_LIMIT = 232448
# csrc/warp_mma.cuh: warps a block, cp.async ring depth, units a chunk,
# columns a k-slab, bytes of a table block, the four byte-indexed decode tables.
WARPS = 8
STAGES = 4
CHUNK = 32
SLAB = 128
BLOCK_BYTES = 512
DECODE_BYTES = 8 * 4 * 256


class KernelLimitError(ValueError):
    """The circuit or the launch exceeds what the kernel takes."""


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bit_planes(counts: np.ndarray, least: int = 1) -> np.ndarray:
    """(rows, cols) vote counts → (planes, rows, cols) 0/1: plane ``b`` is bit
    ``b`` of each count; at least ``least`` planes."""
    counts = np.asarray(counts)
    planes = max(least, int(counts.max(initial=0)).bit_length())
    if planes > MAX_PLANES:
        raise KernelLimitError(f"vote count {int(counts.max())} needs more than {MAX_PLANES} bit-planes")
    return np.stack([(counts >> b) & 1 for b in range(planes)] or [np.zeros_like(counts)])[:planes]


def frag_blocks(bits: np.ndarray) -> np.ndarray:
    """(units, 128) 0/1 of one k-slab, ``units`` a multiple of 32 →
    (units / 32, 32, 4) uint32 table blocks: lane ``4 g + q``'s word ``j`` of
    chunk ``c`` holds columns ``[32 q, 32 q + 32)`` of unit ``32 c + 8 j + g``
    (LSB first), the b1 B fragment of the chunk's n8 block ``j``."""
    words = pack_mask_words(bits, SLAB // 32)  # (units, 4): word q
    return np.ascontiguousarray(words.reshape(-1, 4, 8, 4).transpose(0, 2, 3, 1)).reshape(-1, 32, 4)


def smem_bytes(sweep: bool, stream: bool, nblocks: int, units: int, slabs: int) -> int:
    """Shared memory of one block: ``csrc/warp_mma.cuh`` ``make_layout``,
    term for term."""
    parts = (
        DECODE_BYTES if sweep else 0,
        0 if stream else BLOCK_BYTES * nblocks,
        0 if stream else 16 * (units // CHUNK),
        0 if stream else 4 * units,
        0 if stream or not sweep else 4 * units,
        BLOCK_BYTES * STAGES * WARPS if stream else 0,
        256 * slabs * WARPS if slabs > 1 else 0,
    )
    return sum(_round_up(x, 16) for x in parts)


@dataclass
class PlaneTables:
    """The circuit as the kernels read it.  ``chunks`` (units / 32, 4) int32:
    per chunk its first table block, its member blocks (0 or ``pm ·
    node_slabs``) and its child k-slabs ``[k0, k1)``; ``blocks`` (nblocks,
    32, 4): per chunk the member planes, highest first, each over the node
    slabs in order, then per child plane, highest first, the slabs ``k0 ..
    k1 - 1`` (:func:`frag_blocks`), as int32 bit patterns;
    ``neg_thresholds`` (units,) the signed thresholds negated (the kernel
    starts each vote sum there), -1 on padded units.  Child columns start
    at ``c0``, a multiple of 32, in ``slabs`` k-slabs."""

    n: int
    n_units: int
    units: int
    depth: int
    c0: int
    slabs: int
    pm: int
    pc: int
    stream: bool
    chunks: torch.Tensor
    blocks: torch.Tensor
    neg_thresholds: torch.Tensor

    @property
    def nblocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def node_slabs(self) -> int:
        """The 128-column node k-slabs a row of ``n`` nodes spans."""
        return max(1, -(-self.n // SLAB))


def upload_words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Unsigned word array → a tensor of the same bit patterns (int64 or
    int32, PyTorch having no wide unsigned arithmetic) on ``device``."""
    signed = {8: np.int64, 4: np.int32}[a.dtype.itemsize]
    return torch.from_numpy(np.ascontiguousarray(a).view(signed)).to(device)


def padded_thresholds(thresholds: np.ndarray, units: int) -> np.ndarray:
    out = np.ones(units, dtype=np.int32)
    out[: len(thresholds)] = thresholds
    return out


def plane_tables(circuit: Circuit, device: torch.device, sweep: bool = True,
                 stream: Optional[bool] = None, max_nodes: int = MAX_NODES) -> PlaneTables:
    """The tables of ``circuit`` for the sweep (``sweep``: decode tables and
    D thresholds beside them in shared memory) or the guard.  ``stream``
    None picks the instance from the size: resident where one block's shared
    memory holds the tables, streamed otherwise.  ``max_nodes``: the nodes
    the caller's kernel takes, at most two node k-slabs' 256 (the sweep's and
    the guard's 64, whose rows are one 64-bit word; the frontier's 256, whose
    rows past 128 nodes span two slabs).  Up to 128 nodes the tables are one
    slab's, whatever the limit."""
    n, u = circuit.n, circuit.n_units
    limit = min(max_nodes, NODE_SLABS * SLAB)
    if n > limit:
        raise KernelLimitError(f"circuit has {n} nodes; the kernel takes at most {limit}")
    ns = max(1, -(-n // SLAB))
    units = _round_up(max(u, n, 1), CHUNK)
    kids = np.nonzero(circuit.child.any(axis=0))[0]
    c0 = int(kids[0]) - int(kids[0]) % CHUNK if kids.size else units
    slabs = -(-(units - c0) // SLAB)
    members = np.zeros((units, ns * SLAB), dtype=np.uint8)
    members[:u, :n] = circuit.members
    child = np.zeros((units, slabs * SLAB), dtype=np.uint8)
    child[:u, : u - c0] = circuit.child[:, c0:]
    mplanes, cplanes = bit_planes(members), bit_planes(child, least=0)
    mblocks = [[frag_blocks(plane[:, x * SLAB:(x + 1) * SLAB]) for x in range(ns)] for plane in mplanes[::-1]]
    cblocks = [[frag_blocks(plane[:, x * SLAB:(x + 1) * SLAB]) for x in range(slabs)]
               for plane in cplanes[::-1]]
    blocks, chunks = [], []
    for c in range(units // CHUNK):
        rows = slice(CHUNK * c, CHUNK * (c + 1))
        m = len(mblocks) * ns if members[rows].any() else 0
        cols = np.nonzero(child[rows].any(axis=0))[0]
        k0, k1 = (int(cols[0]) // SLAB, int(cols[-1]) // SLAB + 1) if cols.size else (0, 0)
        chunks.append((len(blocks), m, k0, k1))
        if m:
            blocks += [slab[c] for plane in mblocks for slab in plane]
        blocks += [planes[x][c] for planes in cblocks for x in range(k0, k1)]
    if stream is None:
        stream = smem_bytes(sweep, False, len(blocks), units, slabs) > SMEM_LIMIT
    need = smem_bytes(sweep, stream, len(blocks), units, slabs)
    if need > SMEM_LIMIT:
        raise KernelLimitError(
            f"the kernel's per-block state for {slabs} child k-slabs needs {need} bytes of shared "
            f"memory; one block may take at most {SMEM_LIMIT}"
        )
    block_array = np.stack(blocks) if blocks else np.zeros((1, 32, 4), dtype=np.uint32)
    return PlaneTables(
        n=n, n_units=u, units=units, depth=circuit.depth if u > n else 0, c0=c0, slabs=slabs,
        pm=len(mblocks), pc=len(cblocks), stream=bool(stream),
        chunks=torch.from_numpy(np.asarray(chunks, dtype=np.int32).reshape(-1, 4)).to(device),
        blocks=upload_words(block_array, device),
        neg_thresholds=torch.from_numpy(-padded_thresholds(circuit.thresholds, units)).to(device),
    )


def mask_bits(row: Optional[np.ndarray]) -> int:
    """0/1 node row → the ``uint64_t`` availability word (0 for None)."""
    if row is None:
        return 0
    return sum(1 << int(v) for v in np.nonzero(np.asarray(row))[0])


def _bits_row(bits: int, n: int) -> np.ndarray:
    return np.array([(bits >> v) & 1 for v in range(n)], dtype=np.int32)


class FusedSweep:
    """One sweep problem on one device.

    ``circuit`` is the Q-side circuit; ``circuit_d`` (same members, child
    and units, other thresholds) the D-probe side of an SCC-restricted
    sweep, or None to probe under ``circuit`` with ``frozen``.
    ``lo_nodes[j]`` is the node that index bit ``j`` toggles.  ``stream``
    None picks the kernel instance from the tables' size (the tests force
    either).
    """

    def __init__(
        self,
        circuit: Circuit,
        lo_nodes: np.ndarray,
        scc_mask: np.ndarray,
        frozen: Optional[np.ndarray],
        batch: int,
        circuit_d: Optional[Circuit] = None,
        device: DeviceLike = None,
        stream: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        self.batch = int(batch)
        self.n = circuit.n
        lo_nodes = np.asarray(lo_nodes, dtype=np.int32)
        self.lo_bits = int(lo_nodes.shape[0])
        if circuit_d is not None and (
            circuit_d.n_units != circuit.n_units
            or not np.array_equal(circuit_d.members, circuit.members)
            or not np.array_equal(circuit_d.child, circuit.child)
        ):
            raise ValueError("circuit_d must share members, child and units with circuit")
        if self.device.type == "cpu":
            self.ref: Optional[SweepRef] = SweepRef(
                circuit, lo_nodes, scc_mask, frozen, batch, circuit_d, self.device
            )
            return
        self.ref = None
        if self.lo_bits >= 31:
            raise KernelLimitError(f"lo_bits={self.lo_bits}: indices must stay below 2^31")
        self.tables = plane_tables(circuit, self.device, stream=stream)
        thr_d = circuit.thresholds if circuit_d is None else circuit_d.thresholds
        self.neg_thr_d = torch.from_numpy(-padded_thresholds(thr_d, self.tables.units)).to(self.device)
        self.lo_nodes = torch.from_numpy(lo_nodes).to(self.device)
        self.scc_bits = mask_bits(scc_mask)
        self.frozen_bits = mask_bits(frozen)

    def program(self, start: int, steps: int, hi_mask: int = 0) -> torch.Tensor:
        """Min hit index over ``steps × batch`` candidates from ``start``;
        ``hi_mask`` is the wide decode's constant row as node bits."""
        if self.ref is not None:
            hi = None if not hi_mask else _bits_row(hi_mask, self.n)
            return self.ref.program(start, steps, hi)
        return sweep_fused(self, start, steps * self.batch, hi_mask)


def sweep_fused(sweep: FusedSweep, start: int, rows: int, hi_mask: int = 0) -> torch.Tensor:
    """Launch the fused kernel over ``rows`` candidates on the current
    stream; returns the 0-dim int32 result without synchronising."""
    if sweep.device.type != "cuda":
        raise ValueError(f"sweep_fused launches on CUDA only, got {sweep.device}")
    if start < 0 or start + rows > INDEX_CEILING:
        raise KernelLimitError(f"candidates [{start}, {start + rows}) cross the 2^31 index ceiling")
    t = sweep.tables
    lib = _library()
    out = torch.full((), INT32_MAX, dtype=torch.int32, device=sweep.device)
    stream = torch.cuda.current_stream(sweep.device).cuda_stream
    err = lib.qi_sweep_fused(
        t.blocks.data_ptr(), t.chunks.data_ptr(), t.neg_thresholds.data_ptr(), sweep.neg_thr_d.data_ptr(),
        sweep.lo_nodes.data_ptr(), sweep.lo_bits, hi_mask, sweep.scc_bits, sweep.frozen_bits,
        t.n, t.n_units, t.units, t.depth, t.c0, t.slabs, t.pc, t.nblocks, int(t.stream),
        start, rows, out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"qi_sweep_fused launch failed: {lib.qi_cuda_error_string(err).decode()}"
        )
    sweep_fused.launches += 1
    return out


sweep_fused.launches = 0  # type: ignore[attr-defined]


CUDA_ERROR_PEER_ACCESS_UNSUPPORTED = 217  # cudaErrorPeerAccessUnsupported


def enable_peer_access(dev: torch.device, peer: torch.device) -> None:
    """Peer access from card ``dev`` to card ``peer`` (the library's
    ``qi_sweep_enable_peer``, which enables it once a pair and process);
    :class:`KernelLimitError` naming peer access where the pair has none."""
    lib = _library()
    err = lib.qi_sweep_enable_peer(dev.index, peer.index)
    if err == CUDA_ERROR_PEER_ACCESS_UNSUPPORTED:
        raise KernelLimitError(f"mesh sweep: no peer access from {dev} to {peer} (cudaDeviceCanAccessPeer): "
                               f"a one-process mesh over these cards cannot take their minimum on the device")
    if err != 0:
        raise RuntimeError(f"enabling peer access from {dev} to {peer} failed: "
                           f"{lib.qi_cuda_error_string(err).decode()}")


# (card, first candidate index, rows): one card's share of a mesh program.
Share = Tuple[torch.device, int, int]


class MeshSweep:
    """One sweep problem on the cards of one process's mesh (K11):
    ``sweeps[c]`` holds card ``c``'s tables, ``sweeps[0]`` on the home card,
    where the cards' minimum lands.

    On the card, building it enables peer access from every other card to
    the home card (:class:`KernelLimitError` naming it where a pair has
    none) and creates one event a card, before any launch.  On the CPU (a
    single sweep: the CPU is one device) :meth:`program` is the plain
    version over the one range."""

    def __init__(self, sweeps: Sequence[FusedSweep]):
        self.sweeps: List[FusedSweep] = list(sweeps)
        self.devices = devices = [_card(s.device) for s in self.sweeps]
        if not devices or len(set(devices)) != len(devices):
            raise ValueError(f"a mesh sweep takes one sweep a card, got {devices}")
        self.home = devices[0]
        if any(d.type != self.home.type for d in devices):
            raise ValueError(f"a mesh sweep's cards are all CUDA devices or one CPU, got {devices}")
        if self.home.type != "cuda":
            return
        for dev in devices[1:]:
            enable_peer_access(dev, self.home)
        shape = [_table_shape(s) for s in self.sweeps]
        if any(x != shape[0] for x in shape):
            raise ValueError("a mesh sweep's cards must hold one problem's tables")
        lib = _library()
        self.events = []
        weakref.finalize(self, _destroy_events, self.events)
        for dev in devices:
            event = ctypes.c_void_p()
            err = lib.qi_sweep_event_create(dev.index, ctypes.byref(event))
            if err != 0:
                raise RuntimeError(f"creating an event on {dev} failed: {lib.qi_cuda_error_string(err).decode()}")
            self.events.append(event.value)
        n = len(devices)
        table = lambda attr: (ctypes.c_void_p * n)(*[attr(s).data_ptr() for s in self.sweeps])  # noqa: E731
        self._args = (
            n, (ctypes.c_int * n)(*[d.index for d in devices]),
            table(lambda s: s.tables.blocks), table(lambda s: s.tables.chunks),
            table(lambda s: s.tables.neg_thresholds), table(lambda s: s.neg_thr_d), table(lambda s: s.lo_nodes),
        )
        self._events = (ctypes.c_void_p * n)(*self.events)

    def program(self, shares: Sequence[Share], hi_mask: int = 0) -> torch.Tensor:
        """Min hit index over the cards' ranges ``shares`` (one a card, in
        the order of ``sweeps``), a 0-dim int32 on the home card."""
        if self.home.type != "cuda":
            if len(shares) != 1 or shares[0][0] != self.home:
                raise ValueError(f"a CPU mesh sweep takes one range, got {shares}")
            sweep, (_, start, rows) = self.sweeps[0], shares[0]
            return sweep.program(start, rows // sweep.batch, hi_mask)
        return sweep_mesh(self, shares, hi_mask)


def _card(dev: torch.device) -> torch.device:
    """``cuda`` without an index names the current card."""
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" and dev.index is None else dev


def _table_shape(s: FusedSweep) -> tuple:
    t = s.tables
    return (t.n, t.n_units, t.units, t.depth, t.c0, t.slabs, t.pc, t.nblocks, t.stream, s.lo_bits, s.scc_bits,
            s.frozen_bits)


def _destroy_events(events: List[int]) -> None:
    lib = _library()
    for event in events:
        lib.qi_sweep_event_destroy(event)


def sweep_mesh(mesh_sweep: MeshSweep, shares: Sequence[Share], hi_mask: int = 0) -> torch.Tensor:
    """Launch the kernel once on each card of ``mesh_sweep`` over its range
    in ``shares``, on the cards' current streams, all into one result slot
    on the home card (filled there first; the other cards wait on it and
    the home stream waits on them, by events); returns that 0-dim int32
    without synchronising.  Every range is checked before any launch."""
    sweeps, devices = mesh_sweep.sweeps, mesh_sweep.devices
    if mesh_sweep.home.type != "cuda":
        raise ValueError(f"sweep_mesh launches on CUDA only, got {mesh_sweep.home}")
    if [_card(dev) for dev, _, _ in shares] != devices:
        raise ValueError(f"one range a card of {[str(d) for d in devices]}, got {shares}")
    for dev, start, rows in shares:
        if rows < 1 or start < 0 or start + rows > INDEX_CEILING:
            raise KernelLimitError(f"{dev}'s candidates [{start}, {start + rows}) are empty or cross the 2^31 "
                                   f"index ceiling")
    n = len(sweeps)
    t, s0 = sweeps[0].tables, sweeps[0]
    out = torch.empty((), dtype=torch.int32, device=mesh_sweep.home)
    lib = _library()
    err = lib.qi_sweep_mesh(
        *mesh_sweep._args, s0.lo_bits, hi_mask, s0.scc_bits, s0.frozen_bits,
        t.n, t.n_units, t.units, t.depth, t.c0, t.slabs, t.pc, t.nblocks, int(t.stream),
        (ctypes.c_longlong * n)(*[start for _, start, _ in shares]),
        (ctypes.c_longlong * n)(*[rows for _, _, rows in shares]),
        (ctypes.c_void_p * n)(*[torch.cuda.current_stream(d).cuda_stream for d in devices]),
        mesh_sweep._events, out.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(f"qi_sweep_mesh launch failed: {lib.qi_cuda_error_string(err).decode()}")
    sweep_mesh.launches += n
    return out


sweep_mesh.launches = 0  # type: ignore[attr-defined]


def _library() -> ctypes.CDLL:
    lib = build.load("sweep")
    if not getattr(lib, "_qi_typed", False):
        p, i, u64, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_longlong
        lib.qi_sweep_fused.argtypes = [
            p, p, p, p, p, i, u64, u64, u64, i, i, i, i, i, i, i, i, i, i64, i64, p, p,
        ]
        lib.qi_sweep_fused.restype = i
        lib.qi_sweep_mesh.argtypes = [
            i, p, p, p, p, p, p, i, u64, u64, u64, i, i, i, i, i, i, i, i, i, p, p, p, p, p,
        ]
        lib.qi_sweep_mesh.restype = i
        lib.qi_sweep_enable_peer.argtypes = [i, i]
        lib.qi_sweep_enable_peer.restype = i
        lib.qi_sweep_event_create.argtypes = [i, p]
        lib.qi_sweep_event_create.restype = i
        lib.qi_sweep_event_destroy.argtypes = [p]
        lib.qi_sweep_event_destroy.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
