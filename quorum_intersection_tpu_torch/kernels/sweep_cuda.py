"""Wrapper of the fused CUDA sweep kernel (``csrc/sweep.cu``).

:class:`FusedSweep` holds one sweep problem's tables on its device and
:meth:`FusedSweep.program` evaluates ``steps × batch`` candidates from a start
index, returning the smallest hit index as a 0-dim int32 tensor
(``INT32_MAX`` on a clean miss) — the contract of the JAX package's
``sweep_program_factory`` programs.

On a CUDA device it launches the kernel (:func:`sweep_fused`, which counts
its launches) or raises; it never falls back.  On the CPU it runs the plain
version (:mod:`.sweep_ref`) — only because the tables lie on the CPU.

The kernel takes the votes as b1 and-popc tensor-core products, 16 rows a
warp (``csrc/warp_mma.cuh``).  :func:`plane_tables` lays the circuit out as
the kernel reads it (shared with the block guard, :mod:`.guard_cuda`): per
32-unit chunk, in the order a fixpoint pass reads them, one 512-byte block of
B fragments per member bit-plane and one per child bit-plane and child
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
from typing import Optional

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import INT32_MAX
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit, pack_mask_words
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.sweep_ref import SweepRef

MAX_NODES = 64
MAX_PLANES = 8
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
    per chunk its first table block, its member blocks (0 or ``pm``) and its
    child k-slabs ``[k0, k1)``; ``blocks`` (nblocks, 32, 4): per chunk the
    member planes, highest first, then per child plane, highest first, the
    slabs ``k0 .. k1 - 1`` (:func:`frag_blocks`), as int32 bit patterns;
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
                 stream: Optional[bool] = None) -> PlaneTables:
    """The tables of ``circuit`` for the sweep (``sweep``: decode tables and
    D thresholds beside them in shared memory) or the guard.  ``stream``
    None picks the instance from the size: resident where one block's shared
    memory holds the tables, streamed otherwise."""
    n, u = circuit.n, circuit.n_units
    if n > MAX_NODES:
        raise KernelLimitError(f"circuit has {n} nodes; the kernel takes at most {MAX_NODES}")
    units = _round_up(max(u, n, 1), CHUNK)
    kids = np.nonzero(circuit.child.any(axis=0))[0]
    c0 = int(kids[0]) - int(kids[0]) % CHUNK if kids.size else units
    slabs = -(-(units - c0) // SLAB)
    members = np.zeros((units, SLAB), dtype=np.uint8)
    members[:u, :n] = circuit.members
    child = np.zeros((units, slabs * SLAB), dtype=np.uint8)
    child[:u, : u - c0] = circuit.child[:, c0:]
    mplanes, cplanes = bit_planes(members), bit_planes(child, least=0)
    mblocks = [frag_blocks(plane) for plane in mplanes[::-1]]
    cblocks = [[frag_blocks(plane[:, x * SLAB:(x + 1) * SLAB]) for x in range(slabs)]
               for plane in cplanes[::-1]]
    blocks, chunks = [], []
    for c in range(units // CHUNK):
        rows = slice(CHUNK * c, CHUNK * (c + 1))
        m = len(mblocks) if members[rows].any() else 0
        cols = np.nonzero(child[rows].any(axis=0))[0]
        k0, k1 = (int(cols[0]) // SLAB, int(cols[-1]) // SLAB + 1) if cols.size else (0, 0)
        chunks.append((len(blocks), m, k0, k1))
        blocks += [mb[c] for mb in mblocks[:m]]
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


def _library() -> ctypes.CDLL:
    lib = build.load("sweep")
    if not getattr(lib, "_qi_typed", False):
        p, i, u64, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_longlong
        lib.qi_sweep_fused.argtypes = [
            p, p, p, p, p, i, u64, u64, u64, i, i, i, i, i, i, i, i, i, i64, i64, p, p,
        ]
        lib.qi_sweep_fused.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
