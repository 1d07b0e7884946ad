"""Wrapper of the fused CUDA sweep kernel (``csrc/sweep.cu``).

:class:`FusedSweep` holds one sweep problem's tables on its device and
:meth:`FusedSweep.program` evaluates ``steps × batch`` candidates from a start
index, returning the smallest hit index as a 0-dim int32 tensor
(``INT32_MAX`` on a clean miss) — the contract of the JAX package's
``sweep_program_factory`` programs.

On a CUDA device it launches the kernel (:func:`sweep_fused`, which counts
its launches) or raises; it never falls back.  On the CPU it runs the plain
version (:mod:`.sweep_ref`) — only because the tables lie on the CPU.

Kernel limits, checked before any launch (:class:`KernelLimitError`):
``n <= 64`` nodes (one ``uint64_t`` availability row; the sweep's 2^44
enumeration ceiling keeps a restricted SCC at 45), ``U <= 1024`` units (the
top ``PAD_LADDER`` rung; a child satisfaction mask of up to 16 words), vote
counts below 2^8 (8 bit-planes; the encoder rejects larger counts), tables
that fit the shared memory one block may take, and candidate indices below
2^31.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import INT32_MAX
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.sweep_ref import SweepRef

MAX_NODES = 64
MAX_UNITS = 1024
MAX_PLANES = 8
INDEX_CEILING = 1 << 31
# Shared memory one block may opt into on Hopper (227 KB).
SMEM_LIMIT = 232448
# Child satisfaction-mask widths, in 64-bit words, the kernel is built for.
CHILD_WORDS = (1, 2, 4, 8, 16)
DECODE_BYTES = 8 * 4 * 256  # the four byte-indexed decode tables


class KernelLimitError(ValueError):
    """The circuit or the launch exceeds what the fused kernel takes."""


def _bit_planes(counts: np.ndarray, words: int) -> np.ndarray:
    """(rows, cols) counts → (planes, rows, words) uint64: bit ``c`` of word
    ``c // 64`` in plane ``b`` is bit ``b`` of ``counts[row, c]``."""
    counts = np.asarray(counts, dtype=np.int64)
    rows, cols = counts.shape
    planes = max(1, int(counts.max(initial=0)).bit_length())
    if planes > MAX_PLANES:
        raise KernelLimitError(f"vote count {int(counts.max())} needs more than {MAX_PLANES} bit-planes")
    padded = np.zeros((rows, words * 64), dtype=np.uint64)
    shifts = np.arange(64, dtype=np.uint64)
    out = np.zeros((planes, rows, words), dtype=np.uint64)
    for b in range(planes):
        padded[:, :cols] = (counts >> b) & 1
        out[b] = (padded.reshape(rows, words, 64) << shifts).sum(axis=2, dtype=np.uint64)
    return out


def child_layout(circuit: Circuit, word_bits: int, widths) -> tuple:
    """``(c0, words)`` of the child satisfaction mask: it covers units
    ``[c0, U)``, ``c0`` the first unit that is anyone's child rounded down to
    a word, in the smallest of ``widths`` words that holds them."""
    kids = np.nonzero(circuit.child.any(axis=0))[0]
    first = int(kids[0]) if kids.size else circuit.n_units
    c0 = first - first % word_bits
    need = max(1, -(-(circuit.n_units - c0) // word_bits))
    words = next((w for w in widths if w >= need), None)
    if words is None:
        raise KernelLimitError(
            f"child mask needs {need} words of {word_bits} bits; the kernel takes at most {widths[-1]}"
        )
    return c0, words


def check_units(circuit: Circuit, kernel: str) -> None:
    if circuit.n_units > MAX_UNITS:
        raise KernelLimitError(
            f"circuit has {circuit.n_units} units; the {kernel} kernel takes at most {MAX_UNITS}"
        )


def check_smem(nbytes: int, kernel: str) -> None:
    if nbytes > SMEM_LIMIT:
        raise KernelLimitError(
            f"the {kernel} kernel's tables need {nbytes} bytes of shared memory; "
            f"one block may take at most {SMEM_LIMIT}"
        )


@dataclass
class PlaneTables:
    """The circuit as the kernel reads it: member bit-planes (pm, U) and
    child bit-planes (pc, U, words) over units ``[child_from, U)`` as int64
    bit patterns, signed thresholds (U,), and the number of child passes."""

    n: int
    n_units: int
    depth: int
    words: int
    child_from: int
    member_planes: torch.Tensor
    child_planes: torch.Tensor
    thresholds: torch.Tensor


def upload_words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Unsigned word array → a tensor of the same bit patterns (int64 or
    int32, PyTorch having no wide unsigned arithmetic) on ``device``."""
    signed = {8: np.int64, 4: np.int32}[a.dtype.itemsize]
    return torch.from_numpy(np.ascontiguousarray(a).view(signed)).to(device)


def plane_tables(circuit: Circuit, device: torch.device) -> PlaneTables:
    if circuit.n > MAX_NODES:
        raise KernelLimitError(f"circuit has {circuit.n} nodes; the fused kernel takes at most {MAX_NODES}")
    check_units(circuit, "fused")
    c0, words = child_layout(circuit, 64, CHILD_WORDS)
    member_planes = _bit_planes(circuit.members, 1)[:, :, 0]
    child_planes = _bit_planes(circuit.child[:, c0:], words)
    check_smem(
        DECODE_BYTES + 8 * (member_planes.size + child_planes.size) + 8 * circuit.n_units, "fused"
    )
    return PlaneTables(
        n=circuit.n,
        n_units=circuit.n_units,
        depth=circuit.depth if circuit.n_units > circuit.n else 0,
        words=words,
        child_from=c0,
        member_planes=upload_words(member_planes, device),
        child_planes=upload_words(child_planes, device),
        thresholds=torch.from_numpy(np.asarray(circuit.thresholds, dtype=np.int32)).to(device),
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
    ``lo_nodes[j]`` is the node that index bit ``j`` toggles.
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
        self.tables = plane_tables(circuit, self.device)
        thr_d = circuit.thresholds if circuit_d is None else circuit_d.thresholds
        self.thr_d = torch.from_numpy(np.asarray(thr_d, dtype=np.int32)).to(self.device)
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
        t.member_planes.data_ptr(), t.child_planes.data_ptr(),
        t.thresholds.data_ptr(), sweep.thr_d.data_ptr(), sweep.lo_nodes.data_ptr(),
        sweep.lo_bits, hi_mask, sweep.scc_bits, sweep.frozen_bits,
        t.n, t.n_units, t.words, t.child_from, t.member_planes.shape[0], t.child_planes.shape[0],
        t.depth, start, rows, out.data_ptr(), stream,
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
            p, p, p, p, p, i, u64, u64, u64, i, i, i, i, i, i, i, i64, i64, p, p,
        ]
        lib.qi_sweep_fused.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
