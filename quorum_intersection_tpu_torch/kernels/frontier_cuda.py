"""Wrappers of the frontier's CUDA kernels (``csrc/frontier.cu``): the chunk
loop (K9, :func:`frontier_chunk`), its two instances under a mesh — the
mesh-chunk instance of a one-process mesh (:func:`frontier_mesh_chunk`, one
cooperative launch a chunk and a card, the ranks of a card sharing one
:class:`CardState`) and the iteration instance of joined processes
(:func:`frontier_iteration`, driven a chunk at a time by :func:`mesh_chunk`)
— and the flag filter (K10, :func:`frontier_filter`).

:class:`FrontierKernels` holds one frontier problem's constants on its
device.  The arena lives in :class:`ArenaSet`\\ s: ``T``/``D`` ``(C, s)`` int8
0/1 rows, the flag buffer ``(flag_cap, s)`` and the counters ``(4,)`` int32
``[top, fcount, iters, popped]`` — on the device, so that a chunk chains onto
the previous one without a host round trip.  A chunk reads one set and
writes another (:func:`frontier_chunk`'s ``src``/``dst``): the drive
ping-pongs two sets, so the host can read a finished chunk's arena (to
spill or checkpoint it) while the next one runs.

On a CUDA tensor each wrapper launches its kernel on the current stream,
counts the launch in :data:`LAUNCHES` and does not synchronise, or raises;
it never falls back.
On a CPU tensor it runs the plain version (:mod:`.frontier_ref`) — only
because the tensors lie on the CPU.

Kernel limits, checked before any launch (:class:`KernelLimitError`): at
most :data:`MAX_LANES` (256) SCC lanes (a state is ``W`` = ⌈lanes / 64⌉
64-bit words, ``W`` 1 to 4, each kernel an instance a ``W``; past 128 lanes
a row spans the evaluator's two node k-slabs; the drive's pad ladder gives
8, 16, 24, 32, 48, 64, 96, 128, 192 or 256; the JAX program takes any
width, and so does the plain version).  The kernels move a row 8 lanes at a
time: a lane count off a multiple of 8 (the drive's ``pad_shapes=False``)
runs on the circuit grown by inert nodes to the next multiple, its rows
``pitch`` bytes apart in the arena sets :meth:`FrontierKernels.arena` makes,
which hold the ``s`` lanes as views.  Vote counts
below 2^8 (the evaluator's 8 bit-planes), in-degree counts below 2^16 (the
branch variable's bit-planes, :func:`indegree_planes`), at most
:data:`MAX_POP` states popped an iteration (the scan packs its counts in 16
bits), the evaluator's shared memory, and a grid the card holds at once
(the cooperative launch).  Both mesh instances add a pop block that
splits evenly over the ranks and at most :data:`MAX_SLOTS` stash slots a
half (the child map holds ``2 slot + 1`` in 16 bits); the mesh-chunk
instance at most :data:`MAX_CARDS` cards, with peer access between them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit, pad_circuit
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.frontier_ref import (
    ChunkShape,
    chunk_loop,
    filter_block,
    mesh_chunk_ref,
    share_iteration,
    share_slots,
    stash_half_bytes,
    state_words,
)
from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
    SMEM_LIMIT,
    KernelLimitError,
    padded_thresholds,
    plane_tables,
    smem_bytes,
)
from quorum_intersection_tpu_torch.kernels.sweep_ref import CircuitTables

MAX_LANES = 256
MAX_POP = 8192
MAX_PLANES = 16
WARPS = 8  # csrc/warp_mma.cuh kWarps
SETS = 8  # csrc/frontier.cu kSets: K10's flagged sets a warp
MAX_SLOTS = 32767  # the mesh instances' stash slots a half
MAX_CARDS = 16  # csrc/frontier.cu kMaxCards: cards of the mesh-chunk instance
# The mesh-chunk instance's bound on a wait for the other cards, in SM
# clock cycles (about 8.7 s at the H100's 1.98 GHz): a card that passes it
# leaves the chunk, and mesh_chunk_status raises.
SPIN_CYCLES = 1 << 34
# The mesh-chunk instance's sync[1] codes (csrc/frontier.cu).
SYNC_STATUS = {1: "spin timeout: a peer card did not arrive at an exchange within spin_cycles"}
# Iterations a rank the host enqueues under the iteration instance before it
# reads whether the chunk has ended (the home rank's loop state; a launch
# past the end only carries that state forward).
MESH_BATCH = 8

# Kernel launches since import (or since a caller reset them), by wrapper.
LAUNCHES = {"frontier_chunk": 0, "frontier_filter": 0, "frontier_iteration": 0, "frontier_mesh_chunk": 0}
# The parts of a K9 iteration that the timed instance (:func:`frontier_chunk_timed`)
# clocks, in ``csrc/frontier.cu``'s order.
TIMED_PHASES = ("scan and maps", "children and flags written", "pop loads", "fixpoint", "branch variable",
                "stash", "grid barrier")


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def stash_rows(K: int) -> int:
    """Rows of one stash half: the pop rounded up to 8 (16-byte code loads)."""
    return -(-K // 8) * 8


def chunk_extra_bytes(s: int, K: int, planes: int, rows: Optional[int] = None) -> int:
    """K9's shared memory beyond the evaluator's (``csrc/frontier.cu``
    ``chunk_extra_bytes``): the in-degree planes, the child and flag maps
    over ``rows`` stash entries (default: K9's, the pop rounded up to 8; the
    iteration instance's: its slots a half), the warp sums."""
    rows = stash_rows(K) if rows is None else rows
    return _round16(8 * planes * state_words(s) * s) + _round16(6 * rows) + _round16(4 * (WARPS + 1))


def filter_extra_bytes(s: int) -> int:
    """K10's shared memory beyond the evaluator's at ``s`` lanes: a warp's
    sets, per member index the sets with more members, its tile's slots and
    cursor (``csrc/frontier.cu`` ``filter_extra_bytes``)."""
    W = state_words(s)
    return WARPS * (8 * W * SETS + 2 * 64 * W + 2 * 16 + 16)


def indegree_planes(a_scc: np.ndarray) -> np.ndarray:
    """``a_scc``'s column bit-planes, ``(P, W, s)`` uint64: bit ``x`` of
    ``planes[b, j, w]`` is bit ``b`` of ``a_scc[64 j + x, w]``, ``P`` the
    bit length of its largest count, ``W`` the state's words; so ``f2 @
    a_scc`` at lane ``w`` is ``sum_b sum_j popcount(f2_j & planes[b, j, w])
    << b`` for a 0/1 row ``f2`` packed as words (K9's branch variable)."""
    a = np.asarray(a_scc, dtype=np.int64)
    s = a.shape[0]
    if a.shape != (s, s) or s > MAX_LANES or (a < 0).any():
        raise ValueError(f"a_scc must be a square non-negative matrix of at most {MAX_LANES} lanes, "
                         f"got shape {a.shape}")
    P = int(a.max()).bit_length() if a.size else 0
    W = state_words(s)
    wide = np.zeros((64 * W, s), dtype=np.int64)
    wide[:s] = a
    weights = np.left_shift(np.uint64(1), np.arange(64, dtype=np.uint64))[None, :, None]
    planes = np.zeros((P, W, s), dtype=np.uint64)
    for b in range(P):
        bits = ((wide >> b) & 1).astype(np.uint64).reshape(W, 64, s)
        planes[b] = (bits * weights).sum(axis=1, dtype=np.uint64)
    return planes


def permute_nodes(circuit: Circuit, order: Sequence[int]) -> Circuit:
    """The circuit relabelled so that node ``i`` is old node ``order[i]``
    (``order`` a permutation of its nodes): the member columns and the root
    units (unit ``v < n`` is node ``v``'s root) follow, inner units keep
    their places."""
    order = np.asarray(order, dtype=np.int64)
    n = circuit.n
    if sorted(order.tolist()) != list(range(n)):
        raise ValueError("order must be a permutation of the circuit's nodes")
    units = np.concatenate([order, np.arange(n, circuit.n_units)])
    return Circuit(
        n=n,
        n_units=circuit.n_units,
        depth=circuit.depth,
        thresholds=circuit.thresholds[units],
        members=circuit.members[units][:, order],
        child=circuit.child[units][:, units],
        unit_depth=circuit.unit_depth[units],
    )


@dataclass
class ArenaSet:
    """One arena: the state stack, its flag buffer and its counters."""

    T: torch.Tensor
    D: torch.Tensor
    flags: torch.Tensor
    ctr: torch.Tensor

    @classmethod
    def empty(cls, C: int, s: int, flag_cap: int, device: torch.device, pitch: Optional[int] = None) -> "ArenaSet":
        """Zeroed rows of ``s`` lanes, ``pitch`` (default ``s``) bytes apart:
        past ``s`` a row's bytes stay 0."""
        def rows(n: int) -> torch.Tensor:
            return torch.zeros((n, pitch or s), dtype=torch.int8, device=device)[:, :s]

        return cls(T=rows(C), D=rows(C), flags=rows(flag_cap), ctr=torch.zeros(4, dtype=torch.int32, device=device))


@dataclass
class IterationState:
    """One rank's chunk under a mesh: the source and destination arena sets,
    the rank's stash (``2 · stash_half_bytes`` bytes, ``csrc/frontier.cu``'s
    share-major halves) and loop state (``(2, 8)`` int32), and the launches
    of this chunk so far (``step``).  :meth:`begin` starts a chunk; the
    stash and the loop state serve every chunk of a solve."""

    src: ArenaSet
    dst: ArenaSet
    stash: torch.Tensor
    loop: torch.Tensor
    step: int = 0

    @classmethod
    def empty(cls, K: int, ranks: int, src: ArenaSet, dst: ArenaSet) -> "IterationState":
        dev = dst.T.device
        nbytes = stash_half_bytes(K, ranks, state_words(dst.T.shape[1]))
        return cls(src=src, dst=dst, stash=torch.zeros(2 * nbytes, dtype=torch.uint8, device=dev),
                   loop=torch.zeros((2, 8), dtype=torch.int32, device=dev))

    def begin(self, src: ArenaSet, dst: ArenaSet) -> None:
        self.src, self.dst, self.step = src, dst, 0

    def share(self, K: int, rank: int, ranks: int, half: int) -> torch.Tensor:
        """Rank ``rank``'s share of stash half ``half``, as bytes."""
        nbytes = stash_half_bytes(K, ranks, state_words(self.dst.T.shape[1]))
        share = nbytes // ranks
        return self.stash[half * nbytes + rank * share: half * nbytes + (rank + 1) * share]

    def half(self, K: int, ranks: int, half: int) -> torch.Tensor:
        nbytes = stash_half_bytes(K, ranks, state_words(self.dst.T.shape[1]))
        return self.stash[half * nbytes:(half + 1) * nbytes]


@dataclass
class CardState:
    """One card's chunk under a one-process mesh (the mesh-chunk
    instance): the source and destination arena sets, which the card's
    ranks share, those ranks (``ranks``, global, as ``mine`` on the card),
    the mesh's rank count, the card's stash (``2 · stash_half_bytes``
    bytes, every rank's shares) and its sync words ``(4,)`` int32
    ``[exchanges of the solve before this chunk, status, arrivals, 0]``.
    The stash and the sync words serve every chunk of a solve."""

    src: ArenaSet
    dst: ArenaSet
    ranks: Tuple[int, ...]
    mesh_size: int
    stash: torch.Tensor
    sync: torch.Tensor
    mine: torch.Tensor

    @classmethod
    def empty(cls, K: int, mesh_size: int, ranks: Sequence[int], src: ArenaSet, dst: ArenaSet) -> "CardState":
        dev = dst.T.device
        nbytes = stash_half_bytes(K, mesh_size, state_words(dst.T.shape[1]))
        return cls(src=src, dst=dst, ranks=tuple(int(r) for r in ranks), mesh_size=mesh_size,
                   stash=torch.zeros(2 * nbytes, dtype=torch.uint8, device=dev),
                   sync=torch.zeros(4, dtype=torch.int32, device=dev),
                   mine=torch.tensor([int(r) for r in ranks], dtype=torch.int32).to(dev))

    def begin(self, src: ArenaSet, dst: ArenaSet) -> None:
        self.src, self.dst = src, dst


def mesh_cards(devices: Sequence[torch.device]) -> List[Tuple[torch.device, Tuple[int, ...]]]:
    """The distinct devices of a one-process mesh's ranks, in order of first
    appearance, each with the ranks it holds."""
    cards: dict = {}
    for rank, dev in enumerate(devices):
        cards.setdefault(dev, []).append(rank)
    return [(dev, tuple(ranks)) for dev, ranks in cards.items()]


class FrontierRef:
    """The plain versions' constants for one problem on ``device``: the
    fixpoint tables of the scoped and the probe circuit, the lane → node map,
    the in-degree matrix and the probe's frozen row."""

    def __init__(self, circuit: Circuit, scc_idx: Sequence[int], a_scc: np.ndarray, shape: ChunkShape,
                 probe_circuit: Optional[Circuit] = None, frozen: Optional[np.ndarray] = None,
                 device: torch.device = torch.device("cpu")):
        self.shape = shape
        self.tables = CircuitTables(circuit, device)
        self.probe_tables = self.tables if probe_circuit is None else CircuitTables(probe_circuit, device)
        self.scc_idx = torch.as_tensor(np.asarray(scc_idx, dtype=np.int64), device=device)
        self.a_mat = torch.from_numpy(np.asarray(a_scc, dtype=np.int32)).to(device)
        self.frozen = None if frozen is None else self.probe_tables.cast(np.asarray(frozen))

    def chunk(self, src: ArenaSet, dst: ArenaSet, flag_exit: int) -> None:
        top = int(src.ctr[0])
        res = chunk_loop(self.tables, self.scc_idx, self.a_mat, self.shape, src.T, src.D, top,
                         dst.T, dst.D, dst.flags, flag_exit)
        dst.ctr.copy_(torch.tensor(res, dtype=torch.int32))

    def iteration(self, st: IterationState, rank: int, ranks: int, flag_exit: int) -> None:
        share_iteration(self.tables, self.scc_idx, self.a_mat, self.shape, rank, ranks, st.step, st.src.T,
                        st.src.D, int(st.src.ctr[0]) if st.step == 0 else 0, st.dst.T, st.dst.D, st.dst.flags,
                        st.dst.ctr, st.stash, st.loop, flag_exit)
        st.step += 1

    def mesh_chunk(self, st: CardState, flag_exit: int) -> None:
        if st.ranks != tuple(range(st.mesh_size)):
            raise ValueError(f"the plain mesh-chunk instance runs every rank on one device, got ranks {st.ranks} "
                             f"of {st.mesh_size}")
        mesh_chunk_ref(self.tables, self.scc_idx, self.a_mat, self.shape, st.mesh_size, st.src.T, st.src.D,
                       int(st.src.ctr[0]), st.dst.T, st.dst.D, st.dst.flags, st.dst.ctr, st.stash, flag_exit)

    def filter(self, flags_blk: torch.Tensor, count: int) -> torch.Tensor:
        mins, widx = filter_block(self.tables, self.probe_tables, self.scc_idx, self.frozen, flags_blk, count)
        return torch.tensor([mins, widx], dtype=torch.int32, device=flags_blk.device)


class FrontierKernels:
    """One frontier problem on one device.

    ``circuit`` is the (restricted, padded) scoped circuit, ``scc_idx[i]``
    the circuit node of lane ``i``, ``a_scc`` ``(s, s)`` the SCC's edge
    counts, ``probe_circuit`` (same members, child and units) the flag
    filter's probe side or None to probe under ``circuit`` with ``frozen``.
    On the card the lanes must cover the circuit's nodes (as the drive's
    restriction and padding make them), so the kernels work in lane space
    and the probe's frozen row is empty.  ``stream`` None picks the
    evaluator's instance from the tables' size.  ``s`` is the lanes of a
    state row and ``pitch`` the kernels' (``s`` rounded up to 8; the
    lanes past ``s`` are inert nodes the wrapper adds, never set in a row),
    the bytes between two rows of the arena sets :meth:`arena` makes."""

    def __init__(self, circuit: Circuit, scc_idx: Sequence[int], a_scc: np.ndarray, shape: ChunkShape,
                 probe_circuit: Optional[Circuit] = None, frozen: Optional[np.ndarray] = None,
                 device: DeviceLike = None, stream: Optional[bool] = None):
        self.device = resolve_device(device)
        self.shape = shape
        self.s = len(scc_idx)
        self.pitch = -(-self.s // 8) * 8
        if probe_circuit is not None and (
            probe_circuit.n_units != circuit.n_units
            or not np.array_equal(probe_circuit.members, circuit.members)
            or not np.array_equal(probe_circuit.child, circuit.child)
        ):
            raise ValueError("probe_circuit must share members, child and units with circuit")
        if self.device.type == "cpu":
            self.ref: Optional[FrontierRef] = FrontierRef(
                circuit, scc_idx, a_scc, shape, probe_circuit, frozen, self.device
            )
            return
        self.ref = None
        if self.s > MAX_LANES:
            raise KernelLimitError(f"frontier kernels: |scc| lanes {self.s}: at most {MAX_LANES}")
        a_scc = np.asarray(a_scc)
        planes = indegree_planes(np.pad(a_scc, (0, self.pitch - len(a_scc))))
        if len(planes) > MAX_PLANES:
            raise KernelLimitError(f"frontier kernels: in-degree counts up to {int(np.max(a_scc))} need "
                                   f"{len(planes)} bit-planes > {MAX_PLANES}")
        if shape.K > MAX_POP:
            raise KernelLimitError(f"frontier kernels: pop {shape.K} > {MAX_POP}")
        if sorted(int(v) for v in scc_idx) != list(range(circuit.n)):
            raise ValueError("frontier kernels: the SCC lanes must cover the circuit's nodes")
        if frozen is not None and np.asarray(frozen).any():
            raise ValueError("frontier kernels: a frozen node outside the SCC lanes")
        lane_c = _pad_lanes(permute_nodes(circuit, scc_idx), self.pitch)
        # Both instances read the same tables; the resident one keeps them
        # in shared memory beside K9's scan state, where that fits.
        t = plane_tables(lane_c, self.device, sweep=True, stream=True, max_nodes=MAX_LANES)

        def need(streamed: bool) -> int:
            return max(smem_bytes(False, streamed, t.nblocks, t.units, t.slabs)
                       + chunk_extra_bytes(self.pitch, shape.K, len(planes)),
                       smem_bytes(True, streamed, t.nblocks, t.units, t.slabs) + filter_extra_bytes(self.pitch))

        if stream is None:
            stream = need(False) > SMEM_LIMIT
        if need(stream) > SMEM_LIMIT:
            raise KernelLimitError(
                f"frontier kernels: {need(stream)} bytes of shared memory a block; one block may take at most "
                f"{SMEM_LIMIT}"
            )
        self.tables = dataclasses.replace(t, stream=bool(stream))
        probe_c = lane_c if probe_circuit is None else _pad_lanes(permute_nodes(probe_circuit, scc_idx), self.pitch)
        self.neg_thr_d = torch.from_numpy(-padded_thresholds(probe_c.thresholds, t.units)).to(self.device)
        self.planes = torch.from_numpy(planes.view(np.int64)).to(self.device)
        # The stash: two halves, iteration i writing one while it reads i-1's,
        # a state W words.
        rows = 2 * stash_rows(shape.K)
        W = state_words(self.pitch)
        self.st_T = torch.empty(rows * W, dtype=torch.int64, device=self.device)
        self.st_D = torch.empty(rows * W, dtype=torch.int64, device=self.device)
        self.st_code = torch.empty(rows, dtype=torch.int16, device=self.device)
        lib = _library()
        grid, coop = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(self.device):
            err = lib.qi_frontier_grid(*self._table_args(), self.pitch, shape.K, len(self.planes),
                                       ctypes.byref(grid), ctypes.byref(coop))
        if err != 0:
            raise RuntimeError(f"frontier grid query failed: {lib.qi_cuda_error_string(err).decode()}")
        if not coop.value:
            raise KernelLimitError("frontier chunk kernel: the device cannot launch cooperatively (grid barriers)")
        if grid.value < 1:
            raise KernelLimitError("frontier chunk kernel: not one block of it fits an SM")
        self.grid = grid.value

    def _table_args(self) -> Tuple:
        t = self.tables
        return (t.blocks.data_ptr(), t.chunks.data_ptr(), t.neg_thresholds.data_ptr(), t.n, t.n_units,
                t.units, t.depth, t.c0, t.slabs, t.pc, t.nblocks, int(t.stream))

    def arena(self) -> ArenaSet:
        return ArenaSet.empty(self.shape.C, self.s, self.shape.flag_cap, self.device, self.pitch)


def _pad_lanes(circuit: Circuit, n: int) -> Circuit:
    """The lane-space circuit grown to ``n`` nodes by inert ones (no votes,
    never available), keeping an inner unit's circuit's units past its
    nodes."""
    if n == circuit.n:
        return circuit
    units = max(circuit.n_units, n + 1) if circuit.n_units > circuit.n else max(circuit.n_units, n)
    return pad_circuit(circuit, n, units)


def _check_rows(kern: FrontierKernels, name: str, t: torch.Tensor, rows: int) -> None:
    if t.dtype != torch.int8 or tuple(t.shape) != (rows, kern.s) or t.stride() != (kern.pitch, 1):
        raise ValueError(f"arena {name} must be int8 of shape ({rows}, {kern.s}) with rows {kern.pitch} bytes "
                         f"apart, got {t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _check_set(kern: FrontierKernels, st: ArenaSet) -> None:
    sh = kern.shape
    for name, t, rows in (("T", st.T, sh.C), ("D", st.D, sh.C), ("flags", st.flags, sh.flag_cap)):
        _check_rows(kern, name, t, rows)
    if st.ctr.dtype != torch.int32 or tuple(st.ctr.shape) != (4,):
        raise ValueError(f"arena counters must be int32 of shape (4,), got {st.ctr.dtype} {tuple(st.ctr.shape)}")


def frontier_chunk(kern: FrontierKernels, src: ArenaSet, dst: ArenaSet, flag_exit: int) -> None:
    """One chunk from ``src`` into ``dst`` (the same set runs in place):
    ``dst``'s rows ``[0, top)``, flags and counters are its result."""
    _chunk(kern, src, dst, flag_exit, None)


def frontier_chunk_timed(kern: FrontierKernels, src: ArenaSet, dst: ArenaSet, flag_exit: int) -> torch.Tensor:
    """The same chunk through K9's timed instance, a measurement (resident
    tables with one child slab only; never launched by the drive and not
    counted in :data:`LAUNCHES`): ``(len(TIMED_PHASES) + 1,)`` int64, the
    ``clock64()`` cycles warp 0 of block 0 spent in each part of the
    iterations, then the iterations, without synchronising."""
    if dst.T.device.type != "cuda":
        raise ValueError(f"K9's timed instance runs on CUDA only, got {dst.T.device}")
    timing = torch.zeros(len(TIMED_PHASES) + 1, dtype=torch.int64, device=dst.T.device)
    _chunk(kern, src, dst, flag_exit, timing)
    return timing


def _chunk(kern: FrontierKernels, src: ArenaSet, dst: ArenaSet, flag_exit: int,
           timing: Optional[torch.Tensor]) -> None:
    devices = {src.T.device, dst.T.device, src.ctr.device, dst.ctr.device}
    if len(devices) != 1:
        raise ValueError(f"arena sets lie on different devices: {devices}")
    if dst.T.device.type == "cpu":
        if kern.ref is None:
            raise ValueError("frontier kernels built for CUDA got CPU arenas")
        kern.ref.chunk(src, dst, flag_exit)
        return
    if dst.T.device.type != "cuda" or kern.ref is not None:
        raise ValueError(f"frontier_chunk launches on CUDA only, got {dst.T.device} for a {kern.device} problem")
    if timing is not None and kern.pitch > 64:
        raise ValueError(f"K9's timed instance takes states of one word (at most 64 lanes), got {kern.s}")
    _check_set(kern, src)
    _check_set(kern, dst)
    sh = kern.shape
    lib = _library()
    err = lib.qi_frontier_chunk(
        *kern._table_args(), kern.pitch, sh.half, sh.K, sh.C, sh.chunk_iters, sh.flag_cap, int(flag_exit),
        len(kern.planes), kern.planes.data_ptr(), src.T.data_ptr(), src.D.data_ptr(), src.ctr.data_ptr(),
        dst.T.data_ptr(), dst.D.data_ptr(), dst.flags.data_ptr(), dst.ctr.data_ptr(),
        kern.st_T.data_ptr(), kern.st_D.data_ptr(), kern.st_code.data_ptr(),
        None if timing is None else timing.data_ptr(), kern.grid,
        torch.cuda.current_stream(kern.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"frontier_chunk launch failed: {lib.qi_cuda_error_string(err).decode()}")
    if timing is None:
        LAUNCHES["frontier_chunk"] += 1


def _mesh_limits(kern: FrontierKernels, ranks: int, what: str) -> None:
    """The mesh instances' limits on the card: the stash slots a half and
    the shared memory of a block, which holds the child map over them."""
    Ks = share_slots(kern.shape.K, ranks)[1]
    slots = ranks * Ks
    if slots > MAX_SLOTS:
        raise KernelLimitError(f"frontier {what} kernel: {slots} stash slots a half > {MAX_SLOTS}")
    t = kern.tables
    smem = smem_bytes(False, t.stream, t.nblocks, t.units, t.slabs) + chunk_extra_bytes(
        kern.pitch, kern.shape.K, len(kern.planes), rows=slots)
    if smem > SMEM_LIMIT:
        raise KernelLimitError(f"frontier {what} kernel: {smem} bytes of shared memory a block; one block may "
                               f"take at most {SMEM_LIMIT}")


def iteration_launcher(kern: FrontierKernels, st: IterationState, rank: int, ranks: int,
                       flag_exit: int) -> Callable[[], None]:
    """Check rank ``rank``'s launches of a chunk once (the state, its
    devices, the limits) and prepare their arguments: the returned function
    launches ``st.step`` (K9's iteration instance, on the current stream of
    the problem's card, without synchronising), counts it, and makes
    ``st.step`` one more.  Raises before any launch."""
    sh = kern.shape
    share_slots(sh.K, ranks)
    if not 0 <= rank < ranks:
        raise ValueError(f"rank {rank} of {ranks}")
    nbytes = 2 * stash_half_bytes(sh.K, ranks, state_words(kern.s))
    if st.stash.dtype != torch.uint8 or st.stash.numel() != nbytes \
            or tuple(st.loop.shape) != (2, 8) or st.loop.dtype != torch.int32:
        raise ValueError(f"iteration state must hold a uint8 stash of {nbytes} bytes and an int32 (2, 8) loop state")
    devices = {st.src.T.device, st.dst.T.device, st.stash.device, st.loop.device}
    if len(devices) != 1:
        raise ValueError(f"iteration state lies on different devices: {devices}")
    if st.dst.T.device.type == "cpu":
        if kern.ref is None:
            raise ValueError("frontier kernels built for CUDA got CPU arenas")
        return lambda: kern.ref.iteration(st, rank, ranks, flag_exit)
    dev = st.dst.T.device
    if dev.type != "cuda" or kern.ref is not None or kern.tables.blocks.device != dev:
        raise ValueError(f"frontier_iteration launches on CUDA only, on its problem's card: got {dev} for a "
                         f"{kern.tables.blocks.device} problem")
    _mesh_limits(kern, ranks, "iteration")
    _check_set(kern, st.src)
    _check_set(kern, st.dst)
    fn = _library().qi_frontier_iteration
    head = (*kern._table_args(), kern.pitch, sh.half, sh.K, sh.C, sh.chunk_iters, sh.flag_cap, int(flag_exit),
            len(kern.planes), kern.planes.data_ptr(), rank, ranks)
    tail = (st.src.T.data_ptr(), st.src.D.data_ptr(), st.src.ctr.data_ptr(), st.dst.T.data_ptr(),
            st.dst.D.data_ptr(), st.dst.flags.data_ptr(), st.dst.ctr.data_ptr(), st.stash.data_ptr(),
            st.loop.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

    def launch() -> None:
        with torch.cuda.device(dev):
            err = fn(*head, st.step, *tail)
        if err != 0:
            raise RuntimeError(f"frontier_iteration launch failed: {_library().qi_cuda_error_string(err).decode()}")
        LAUNCHES["frontier_iteration"] += 1
        st.step += 1

    return launch


def frontier_iteration(kern: FrontierKernels, st: IterationState, rank: int, ranks: int, flag_exit: int) -> None:
    """Launch ``st.step`` of a chunk for rank ``rank`` of ``ranks`` (K9's
    iteration instance, on the current stream of ``kern``'s device, without
    synchronising) and count it; then ``st.step`` is one more.  Step 0 reads
    ``st.src``; the rows ``[0, top)``, flags and counters of ``st.dst`` are
    the chunk's result once the loop state says it has ended, and the share
    this launch wrote (``st.share(K, rank, ranks, step & 1)``) must reach
    every rank before the next step (:func:`gather_shares`).  One launch
    with its checks; :func:`mesh_chunk` checks a chunk's launches once."""
    iteration_launcher(kern, st, rank, ranks, flag_exit)()


def gather_shares(mesh, states: Sequence[IterationState], K: int, half: int) -> None:
    """Every rank's share of stash half ``half`` into every local rank's
    stash (:func:`..parallel.mesh.mesh_all_gather`, in place)."""
    from quorum_intersection_tpu_torch.parallel.mesh import mesh_all_gather

    n = mesh.size
    mesh_all_gather(mesh, [st.share(K, mesh.global_rank(i), n, half) for i, st in enumerate(states)],
                    out=[st.half(K, n, half) for st in states])


Iterate = Callable[[object, IterationState, int, int, int], None]


def mesh_chunk(mesh, kerns: Sequence, states: Sequence[IterationState], flag_exit: int,
               iterate: Optional[Iterate] = None, batch: int = MESH_BATCH) -> int:
    """One chunk of the iteration instance on every local rank of ``mesh``
    (each ``states[i]`` begun on its source and destination): a launch on
    every rank, then :func:`gather_shares`, ``batch`` times before the host
    reads the home rank's loop state, until it says the chunk has ended.
    Every rank's launches are checked and prepared once, before the first
    (:func:`frontier_iteration`'s checks); ``iterate(kerns[i], states[i],
    global rank, ranks, flag_exit)`` takes their place where given (a plain
    version).  Every rank of every process makes the same launches and
    gathers: the end is read from values every rank holds alike.  Returns
    the steps a rank."""
    K, chunk_iters, n = kerns[0].shape.K, kerns[0].shape.chunk_iters, mesh.size
    if iterate is None:
        steps = [iteration_launcher(kern, st, mesh.global_rank(local), n, flag_exit)
                 for local, (kern, st) in enumerate(zip(kerns, states))]
    else:
        steps = [(lambda kern=kern, st=st, g=mesh.global_rank(local): iterate(kern, st, g, n, flag_exit))
                 for local, (kern, st) in enumerate(zip(kerns, states))]
    step = 0
    while True:
        todo = min(batch, chunk_iters + 1 - step)
        if todo < 1:
            raise RuntimeError(f"the chunk did not end within {chunk_iters + 1} iterations")
        for _ in range(todo):
            for launch in steps:
                launch()
            gather_shares(mesh, states, K, step & 1)
            step += 1
        if int(states[0].loop[step & 1, 6]):
            return step


CUDA_ERROR_PEER_ACCESS_UNSUPPORTED = 217  # cudaErrorPeerAccessUnsupported


def enable_peer_access(dev: torch.device, peer: torch.device) -> None:
    """Peer access from card ``dev`` to card ``peer`` (the library's
    ``qi_frontier_enable_peer``, which enables it once a pair and process);
    :class:`KernelLimitError` naming peer access where the pair has none."""
    lib = _library()
    err = lib.qi_frontier_enable_peer(dev.index, peer.index)
    if err == CUDA_ERROR_PEER_ACCESS_UNSUPPORTED:
        raise KernelLimitError(f"frontier mesh-chunk kernel: no peer access from {dev} to {peer} "
                               f"(cudaDeviceCanAccessPeer): a one-process mesh over these cards cannot exchange "
                               f"its stash shares on the device")
    if err != 0:
        raise RuntimeError(f"enabling peer access from {dev} to {peer} failed: "
                           f"{lib.qi_cuda_error_string(err).decode()}")


def frontier_mesh_chunk(kerns: Sequence[FrontierKernels], states: Sequence[CardState], flag_exit: int,
                        spin_cycles: int = SPIN_CYCLES) -> None:
    """One chunk of K9's mesh-chunk instance: on each card ``states[c]``
    (begun on its source and destination; its problem ``kerns[c]``) one
    cooperative launch, on the card's current stream, without
    synchronising, each counted.  The cards' ranks cover the mesh's once;
    each card pops its ranks' shares and stores them into every card's
    stash, and waits at most ``spin_cycles`` for the others at an exchange.
    Everything is checked, and peer access enabled, before the first
    launch.  Once the chunk has run, :func:`mesh_chunk_status` raises if a
    card timed out; otherwise every card's destination holds the chunk's
    rows ``[0, top)``, flags and counters.  On the CPU (one state, every
    rank) the plain version, :func:`..frontier_ref.mesh_chunk_ref`."""
    if not states or len(kerns) != len(states):
        raise ValueError(f"{len(kerns)} problems for {len(states)} cards")
    n, K = states[0].mesh_size, kerns[0].shape.K
    share_slots(K, n)
    if sorted(r for st in states for r in st.ranks) != list(range(n)) or any(st.mesh_size != n for st in states):
        raise ValueError(f"the cards' ranks {[st.ranks for st in states]} must cover the {n} ranks once")
    nbytes = 2 * stash_half_bytes(K, n, state_words(kerns[0].s))
    for st in states:
        if st.stash.dtype != torch.uint8 or st.stash.numel() != nbytes \
                or st.sync.dtype != torch.int32 or tuple(st.sync.shape) != (4,):
            raise ValueError(f"a card state must hold a uint8 stash of {nbytes} bytes and int32 (4,) sync words")
        devices = {st.src.T.device, st.dst.T.device, st.stash.device, st.sync.device, st.mine.device}
        if len(devices) != 1:
            raise ValueError(f"card state lies on different devices: {devices}")
    if states[0].dst.T.device.type == "cpu":
        if len(states) != 1 or kerns[0].ref is None:
            raise ValueError("the plain mesh-chunk instance runs one CPU state, every rank on it")
        kerns[0].ref.mesh_chunk(states[0], flag_exit)
        return
    if len(states) > MAX_CARDS:
        raise KernelLimitError(f"frontier mesh-chunk kernel: {len(states)} cards > {MAX_CARDS}")
    if spin_cycles < 1:
        raise ValueError(f"spin_cycles must be positive, got {spin_cycles}")
    for kern, st in zip(kerns, states):
        dev = st.dst.T.device
        if dev.type != "cuda" or kern.ref is not None or kern.tables.blocks.device != dev:
            raise ValueError(f"frontier_mesh_chunk launches on CUDA only, on its problem's card: got {dev} for a "
                             f"{kern.tables.blocks.device} problem")
        _mesh_limits(kern, n, "mesh-chunk")
        _check_set(kern, st.src)
        _check_set(kern, st.dst)
    for a in states:
        for b in states:
            if a.stash.device != b.stash.device:
                enable_peer_access(a.stash.device, b.stash.device)
    lib = _library()
    for kern, st in zip(kerns, states):
        sh, dev = kern.shape, st.dst.T.device
        peers = [o for o in states if o is not st]
        peer_stash = (ctypes.c_void_p * MAX_CARDS)(*[o.stash.data_ptr() for o in peers])
        peer_sync = (ctypes.c_void_p * MAX_CARDS)(*[o.sync.data_ptr() for o in peers])
        with torch.cuda.device(dev):
            err = lib.qi_frontier_mesh_chunk(
                *kern._table_args(), kern.pitch, sh.half, sh.K, sh.C, sh.chunk_iters, sh.flag_cap, int(flag_exit),
                len(kern.planes), kern.planes.data_ptr(), n, st.mine.data_ptr(), len(st.ranks), st.src.T.data_ptr(),
                st.src.D.data_ptr(), st.src.ctr.data_ptr(), st.dst.T.data_ptr(), st.dst.D.data_ptr(),
                st.dst.flags.data_ptr(), st.dst.ctr.data_ptr(), st.stash.data_ptr(), st.sync.data_ptr(),
                len(states), peer_stash, peer_sync, int(spin_cycles), torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"frontier_mesh_chunk launch on {dev} failed: {lib.qi_cuda_error_string(err).decode()}")
        LAUNCHES["frontier_mesh_chunk"] += 1


def _raise_status(dev, code: int) -> None:
    if code:
        raise RuntimeError(f"frontier_mesh_chunk on {dev}: {SYNC_STATUS.get(code, 'unknown status')} (status {code})")


def mesh_chunk_status(states: Sequence[CardState]) -> None:
    """Wait for a mesh chunk's launches and raise, naming the card and the
    fault, if one of them left it early (a spin timeout)."""
    for st in states:
        _raise_status(st.sync.device, int(st.sync[1]))


def mesh_chunk_check(states: Sequence[CardState], pinned: Sequence[torch.Tensor]) -> Callable[[], None]:
    """:func:`mesh_chunk_status` of the chunk just launched on ``states``,
    deferred: each card's status word follows to ``pinned[c]`` (a pinned
    ``(1,)`` int32 host tensor) behind an event on the card's stream, so the
    returned check waits for that chunk alone, not for what is queued after
    it.  On the CPU the check reads the states."""
    if states[0].sync.device.type == "cpu":
        return lambda: mesh_chunk_status(states)
    events = []
    for st, host in zip(states, pinned):
        dev = st.sync.device
        with torch.cuda.device(dev):
            host.copy_(st.sync[1:2], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        events.append((dev, host, ev))

    def check() -> None:
        for dev, host, ev in events:
            ev.synchronize()
            _raise_status(dev, int(host[0]))

    return check


def frontier_filter(kern: FrontierKernels, flags_blk: torch.Tensor, count: int) -> torch.Tensor:
    """The flag filter over the first ``count`` rows of ``flags_blk`` (B, s)
    int8: ``(2,)`` int32 ``[minimal count, first witness index or B]``,
    without synchronising.  On the card it runs on the current stream, as a
    PyTorch operation does: a caller on another stream than the one that
    wrote ``flags_blk`` orders the two itself."""
    if flags_blk.dtype != torch.int8 or flags_blk.ndim != 2 or flags_blk.shape[1] != kern.s:
        raise ValueError(f"flag block must be int8 of shape (B, {kern.s}), got {flags_blk.dtype} "
                         f"{tuple(flags_blk.shape)}")
    B = flags_blk.shape[0]
    count = max(0, min(int(count), B))
    if flags_blk.device.type == "cpu":
        if kern.ref is None:
            raise ValueError("frontier kernels built for CUDA got a CPU flag block")
        return kern.ref.filter(flags_blk, count)
    if flags_blk.device.type != "cuda" or kern.ref is not None:
        raise ValueError(f"frontier_filter launches on CUDA only, got {flags_blk.device}")
    if flags_blk.stride() != (kern.pitch, 1):
        # The kernel reads rows pitch bytes apart: a block of s-lane rows
        # (s off a multiple of 8) is copied into such rows, zero past s.
        rows = torch.zeros((max(count, 1), kern.pitch), dtype=torch.int8, device=flags_blk.device)
        rows[:count, : kern.s] = flags_blk[:count]
        flags_blk = rows[:, : kern.s]
    # Filled on the device: a tensor made from host data (or an item
    # assigned from a Python number) is a pageable copy, which holds the host
    # until the stream reaches it.
    out = torch.full((2,), B, dtype=torch.int32, device=flags_blk.device)
    out[0].zero_()
    if count:
        t = kern.tables
        lib = _library()
        err = lib.qi_frontier_filter(
            t.blocks.data_ptr(), t.chunks.data_ptr(), t.neg_thresholds.data_ptr(), kern.neg_thr_d.data_ptr(),
            t.n, t.n_units, t.units, t.depth, t.c0, t.slabs, t.pc, t.nblocks, int(t.stream), kern.pitch,
            flags_blk.data_ptr(), count, out.data_ptr(), torch.cuda.current_stream(kern.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"frontier_filter launch failed: {lib.qi_cuda_error_string(err).decode()}")
        LAUNCHES["frontier_filter"] += 1
    return out


def _library() -> ctypes.CDLL:
    return typed_library(build.load("frontier"))


def typed_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/frontier.cu``) with its C functions'
    argument and result types set, once."""
    if not getattr(lib, "_qi_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        tables = [p, p, p, i, i, i, i, i, i, i, i, i]
        lib.qi_frontier_grid.argtypes = tables + [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.qi_frontier_grid.restype = i
        lib.qi_frontier_chunk.argtypes = tables + [i] * 8 + [p] * 12 + [i, p]
        lib.qi_frontier_chunk.restype = i
        lib.qi_frontier_iteration.argtypes = tables + [i] * 8 + [p] + [i] * 3 + [p] * 9 + [p]
        lib.qi_frontier_iteration.restype = i
        lib.qi_frontier_mesh_chunk.argtypes = tables + [i] * 8 + [p, i, p, i] + [p] * 9 + [i, p, p, ctypes.c_longlong, p]
        lib.qi_frontier_mesh_chunk.restype = i
        lib.qi_frontier_enable_peer.argtypes = [i, i]
        lib.qi_frontier_enable_peer.restype = i
        lib.qi_frontier_filter.argtypes = [p, p, p, p] + [i] * 10 + [p, i, p, p]
        lib.qi_frontier_filter.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
