"""Device-resident branch-and-bound on the card — the frontier lives in device
memory (``gpu-frontier``).

The port of the JAX package's ``TpuFrontierBackend``
(``backends/tpu/frontier.py:108-1028``).  The worklist is a device array: a
LIFO stack of (toRemove, dontRemove) 0/1 rows over the SCC's lanes, and one
cooperative launch a chunk (K9, :func:`..kernels.frontier_cuda.frontier_chunk`)
pops a block of states per iteration, evaluates their fixpoints, applies the
reference's prunes (cpp:252-346; pinned spec ``backends/python_oracle.py``)
and pushes the children, up to ``CHUNK_ITERS`` iterations without the host.

Division of labour (verdict-equivalent to the serial oracle): the device
runs the tree's interior (the size, empty and containment prunes, the
``fixpoint(dontRemove)`` test, the branch variable by in-degree and the
two-child expansion); states whose dontRemove already holds a quorum are
**flagged** into a side buffer.  Each flagged set needs the minimality and
disjointness checks, by one of two engines (``flag_check``):

- ``"device"`` (``"auto"`` on CUDA): the leave-one-out rows and the Q6
  availability probe as one launch a flag block (K10,
  :func:`..kernels.frontier_cuda.frontier_filter`), on the card on a stream
  of its own, so that it need not queue behind the chunk in flight;
- ``"host"`` (``"auto"`` on the CPU): the exact serial check per set, through
  the native ``qi_max_quorum`` where the library builds, else the Python
  semantics (a host engine choice, logged, as in the JAX package).

Either way a witness never leaves this backend on device results alone: the
exact host semantics re-check the device's candidate before any verdict.

The branch variable always lies in ``quorum ∖ dontRemove`` (lowest lane on
tied in-degrees): the JAX module's deliberate deviation from cpp:221.

What the host drive keeps of the JAX one: SCC restriction and the pad
ladder (``pad_shapes``, on by default as in the JAX drive; off, the lane,
node and unit counts stay exact and the statistics carry no
``padded_shape``), the seed
state or a resumed checkpoint (the excess in spill blocks), the speculative
next chunk dispatched before the host reads the current one (so the flag
checks overlap the device), the flag-exit threshold doubling up to
``FLAG_EXIT_GROWTH`` times, the spill of the oldest half of an overflowing
arena and its refeed, ``interrupt_after_chunks`` and periodic
checkpoint writes, and its statistics key for key.  Where JAX arrays are
immutable, the port's arena is updated in place, so the drive ping-pongs two
arena sets: a chunk reads one and writes the other, and the host reads a
finished chunk's set (flags, spill, checkpoint) while the speculative chunk
writes the other.

Under a mesh (``mesh=``, a :class:`..parallel.mesh.CandidateMesh`; the JAX
drive's row-sharded fixpoint, ``frontier.py:351-363``, under the
``shard_map`` of ``:475-502``) the pop block is rounded as the JAX drive
rounds it (``:602-617``) and rank ``r`` pops states ``[r K/n, (r+1) K/n)``
of every pop block.  The mesh picks one of K9's two mesh instances
(``stats["mesh"]["instance"]``):

- ``"chunk"``, a mesh of one process: one cooperative launch a chunk and a
  card (:func:`..kernels.frontier_cuda.frontier_mesh_chunk`); the ranks of
  a card share its launch, its arena sets and its stash, and the cards
  exchange their stash shares on the device (peer stores; cards without
  peer access raise).  Its chunks are dispatched ahead as K9's are, and
  the host reads the home card's counters once a chunk;
- ``"iteration"``, processes joined by ``parallel.distributed``: a
  host-driven sequence of iteration launches
  (:func:`..kernels.frontier_cuda.frontier_iteration`) on every rank, with
  a gather of the ranks' stash shares between two launches
  (:func:`..kernels.frontier_cuda.mesh_chunk`), since no kernel reaches
  another process's memory.  Each rank keeps its own pair of arena sets.

Every arena set, a card's or a rank's, is written alike by the seed, the
resume, the refeed and the spill; the host reads the counters, the flags,
the spill blocks and the checkpoints from the home device's, and runs the
flag checks (K10 or the host) once a process on the home device, outside
the sharded loop, as the JAX filter runs replicated outside its
``shard_map``.  Under the iteration instance every rank of every process
runs the same iterations and gathers: a chunk runs when the drive reads its
counters, not when it is dispatched, so the speculative chunk, the
flag-exit doubling, the spills and ``interrupt_after_chunks`` follow values
every rank holds alike, and a checkpoint write, timed by the clock, adds or
drops no collective.  A mesh
never falls back to K9, to the other instance, to the plain versions or to
the host oracle.  On CUDA the backend launches its kernels or raises: no
path falls back to the CPU or to the plain versions.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import SccCheckResult
from quorum_intersection_tpu_torch.device import DeviceLike
from quorum_intersection_tpu_torch.encode.circuit import Circuit
from quorum_intersection_tpu_torch.fbas.graph import TrustGraph
from quorum_intersection_tpu_torch.fbas.semantics import max_quorum
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.frontier_ref import ChunkShape, frozen_row
from quorum_intersection_tpu_torch.parallel.mesh import CandidateMesh, collective_of, mesh_device
from quorum_intersection_tpu_torch.utils.env import qi_env_float
from quorum_intersection_tpu_torch.utils.faults import fault_point
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

log = logging.getLogger("quorum_intersection_tpu_torch.backends.frontier")

# The JAX package's constants (frontier.py:82-100): arena rows; states popped
# an iteration; the flag count that ends a chunk, grown up to
# FLAG_EXIT_GROWTH times on flag-bound chunks; iterations a chunk.
ARENA = 1 << 18
POP = 2048
FLAG_EXIT = 512
FLAG_EXIT_GROWTH = 16
CHUNK_ITERS = 512


class FrontierSearchInterrupted(RuntimeError):
    """Raised by the preemption-simulation hook after writing a checkpoint
    (``interrupt_after_chunks``); production runs never see it."""


@dataclass
class FrontierProblem:
    """One SCC set up for the frontier (JAX ``frontier.py:522-599``): the
    device circuit (restricted where the graph is wider than the SCC,
    padded up the ladder) and its probe side, lane ``i``'s circuit node
    ``scc_dev[i]``, the in-degree matrix over the lanes, the probe's frozen
    row, and the unpadded circuits the checkpoint fingerprint hashes."""

    s: int
    s_dev: int
    half: int
    scc_pos: Dict[int, int]
    a_scc: np.ndarray
    circuit: Circuit
    probe_circuit: Optional[Circuit]
    scc_local: List[int]
    scc_dev: List[int]
    frozen: Optional[np.ndarray]
    fp_circuit: Circuit
    fp_probe: Optional[Circuit]
    padded_from: Optional[List[int]]


def frontier_problem(graph: TrustGraph, circuit: Circuit, scc: List[int], *,
                     scope_to_scc: bool = False, pad_shapes: bool = True) -> FrontierProblem:
    """Set up ``scc`` of ``graph`` for the frontier, as the JAX drive does:
    with ``pad_shapes`` (its default) the lane count and the circuit's axes
    rounded up the pad ladder (the JAX drive's compile buckets; here they
    keep the statistics and the checkpoint files the JAX package's), else
    exact.  Padded lanes are inert, so the traversal is the same either
    way."""
    from quorum_intersection_tpu_torch.encode.circuit import ladder_up, pad_circuit, restrict_circuit_pair

    s = len(scc)
    scc_pos = {v: i for i, v in enumerate(scc)}
    a_scc = np.zeros((s, s), dtype=np.int32)
    for u in scc:
        for w in graph.succ[u]:
            j = scc_pos.get(w)
            if j is not None:
                a_scc[scc_pos[u], j] += 1

    # SCC restriction: fold the constant outside availability into the
    # thresholds, the scoped fold for the interior, the Q6 fold for the flag
    # filter's probe; host checks keep the original graph and scc.
    probe_circuit = None
    scc_local = list(scc)
    if circuit.n > s:
        scoped_c, q6_c = restrict_circuit_pair(circuit, scc)
        log.debug("frontier restricted to |scc|=%d: n %d->%d, units %d->%d",
                  s, circuit.n, scoped_c.n, circuit.n_units, scoped_c.n_units)
        circuit = scoped_c
        probe_circuit = None if scope_to_scc else q6_c
        scc_local = list(range(s))

    # The pad ladder: padded lanes map to inert padded columns, which never
    # enter a quorum, branch or flag.
    fp_circuit, fp_probe = circuit, probe_circuit
    scc_dev = list(scc_local)
    padded_from = None
    s_dev = ladder_up(s) if pad_shapes else s
    n_to = ladder_up(max(circuit.n, s_dev))
    if circuit.n_units > circuit.n:
        # Keep the strict inner-unit marker n_units > n.
        units_to = ladder_up(max(circuit.n_units, n_to + 1))
    else:
        units_to = n_to
    if pad_shapes and ((n_to, units_to) != (circuit.n, circuit.n_units) or s_dev != s):
        padded_from = [s, circuit.n, circuit.n_units]
        pad_base = circuit.n
        circuit = pad_circuit(circuit, n_to, units_to)
        if probe_circuit is not None:
            probe_circuit = pad_circuit(probe_circuit, n_to, units_to)
        scc_dev += list(range(pad_base, pad_base + (s_dev - s)))
    if s_dev != s:
        a_pad = np.zeros((s_dev, s_dev), dtype=np.int32)
        a_pad[:s, :s] = a_scc
        a_scc = a_pad
    return FrontierProblem(
        s=s, s_dev=s_dev, half=s // 2, scc_pos=scc_pos, a_scc=a_scc, circuit=circuit,
        probe_circuit=probe_circuit, scc_local=scc_local, scc_dev=scc_dev,
        frozen=frozen_row(circuit.n, scc_dev, q6=not scope_to_scc and probe_circuit is None),
        fp_circuit=fp_circuit, fp_probe=fp_probe, padded_from=padded_from,
    )


class _Chunk:
    """One dispatched chunk: the arena set it writes, the flag threshold it
    ran under and, on the card, its counters and flags copied to pinned host
    memory behind an event; under the mesh-chunk instance the check of its
    cards' status (:func:`..kernels.frontier_cuda.mesh_chunk_check`), made
    before its counters are read."""

    def __init__(self, index: int, dst, flag_exit: int, host, check=None):
        self.index = index  # which of the two arena sets it writes
        self.dst = dst
        self.flag_exit = flag_exit
        self.host = host  # (ctr, flags, event) on the card, None on the CPU
        self.check = check

    def counters(self) -> List[int]:
        if self.check is not None:
            self.check()
        if self.host is None:
            return [int(x) for x in self.dst.ctr.tolist()]
        self.host[2].synchronize()
        return [int(x) for x in self.host[0].tolist()]

    def flags(self, count: int) -> np.ndarray:
        src = self.dst.flags if self.host is None else self.host[1]
        return src[:count].numpy().copy()


class _MeshChunk:
    """One dispatched chunk of the iteration instance: ``run`` drives it on
    every rank (:func:`..kernels.frontier_cuda.mesh_chunk`) when the drive
    first reads it, so that a chunk the drive drops never runs; ``dst`` is
    the home rank's destination set, which the drive reads."""

    def __init__(self, index: int, dst, flag_exit: int, run):
        self.index = index
        self.dst = dst
        self.flag_exit = flag_exit
        self._run = run

    def counters(self) -> List[int]:
        if self._run is not None:
            self._run()
            self._run = None
        return [int(x) for x in self.dst.ctr.tolist()]

    def flags(self, count: int) -> np.ndarray:
        return self.dst.flags[:count].cpu().numpy().copy()


class GpuFrontierBackend:
    """Device-resident branch-and-bound over the quorum-bearing SCC."""

    name = "gpu-frontier"
    needs_circuit = True

    def __init__(
        self,
        arena: int = ARENA,
        pop: int = POP,
        flag_exit: int = FLAG_EXIT,
        chunk_iters: int = CHUNK_ITERS,
        checkpoint=None,
        checkpoint_interval_s: Optional[float] = None,
        interrupt_after_chunks: Optional[int] = None,
        flag_check: str = "auto",
        device: DeviceLike = None,
        mesh: Optional[CandidateMesh] = None,
        pad_shapes: bool = True,
    ) -> None:
        if arena < 4:
            # pop is clamped to arena // 4: a zero pop would spin forever.
            raise ValueError(f"arena={arena} too small (needs >= 4)")
        if flag_check not in ("auto", "device", "host"):
            raise ValueError(f"flag_check={flag_check!r} not in auto/device/host")
        # Under a mesh its home device, which a given device must equal.
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.arena = arena
        self.pop = min(pop, arena // 4)
        self.flag_exit = flag_exit
        self.chunk_iters = chunk_iters
        self.flag_check = flag_check
        self.checkpoint = checkpoint  # utils.checkpoint.FrontierCheckpoint or None
        if checkpoint_interval_s is None:
            # QI_FRONTIER_CKPT_INTERVAL_S as the JAX package reads it: seconds
            # between checkpoint writes, 5 when unset or malformed.
            checkpoint_interval_s = qi_env_float("QI_FRONTIER_CKPT_INTERVAL_S", 5.0)
        self.checkpoint_interval_s = checkpoint_interval_s
        self.interrupt_after_chunks = interrupt_after_chunks
        # The JAX drive's pad ladder switch (frontier_problem); off, the
        # kernels take the exact lane count (FrontierKernels aligns it).
        self.pad_shapes = pad_shapes

    # ---- host-side exact checks (reference semantics) -------------------

    @staticmethod
    def _host_witness_check(
        graph: TrustGraph, scc: List[int], members: List[int], scope_to_scc: bool,
    ) -> Tuple[bool, Optional[Tuple[List[int], List[int]]]]:
        """Exact minimality and disjointness probe of one flagged set:
        ``(is_minimal, witness)``, the witness ``(disjoint, members)``."""
        from quorum_intersection_tpu_torch.backends.python_oracle import is_minimal_quorum

        if not is_minimal_quorum(members, graph):
            return False, None
        if scope_to_scc:
            avail = [False] * graph.n
            for v in scc:
                avail[v] = True
        else:
            avail = [True] * graph.n  # Q6 whole-graph availability (cpp:354)
        for v in members:
            avail[v] = False
        disjoint = max_quorum(graph, scc, avail)
        if disjoint:
            return True, (disjoint, list(members))
        return True, None

    def _make_host_checker(self, graph: TrustGraph, scc: List[int], scope_to_scc: bool):
        """``check(members) -> (minimal, witness|None)`` on the native
        ``qi_max_quorum`` where the library builds, else the Python
        semantics: two exact engines of one pinned spec."""
        try:
            from quorum_intersection_tpu_torch.backends.cpp import NativeMaxQuorum

            nmq = NativeMaxQuorum(graph)
        except Exception as exc:  # noqa: BLE001 — no g++ etc.
            log.info("native max-quorum unavailable (%s); host checks use the Python semantics", exc)
            return lambda members: self._host_witness_check(graph, scc, members, scope_to_scc)

        scc_arr = np.asarray(scc, dtype=np.int32)
        avail = np.zeros(graph.n, dtype=np.uint8)  # reused across checks

        def check(members: List[int]) -> Tuple[bool, Optional[Tuple[List[int], List[int]]]]:
            m_arr = np.asarray(members, dtype=np.int32)
            avail[:] = 0
            avail[m_arr] = 1
            if not nmq.count(m_arr, avail):
                return False, None
            for v in members:
                avail[v] = 0
                if nmq.count(m_arr, avail):
                    return False, None
                avail[v] = 1
            if scope_to_scc:
                avail[:] = 0
                avail[scc_arr] = 1
            else:
                avail[:] = 1  # Q6 whole-graph availability (cpp:354)
            avail[m_arr] = 0
            disjoint = nmq(scc_arr, avail)
            if disjoint:
                return True, (disjoint, list(members))
            return True, None

        return check

    # ---- main entry ------------------------------------------------------

    def check_scc(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        *,
        scope_to_scc: bool = False,
    ) -> SccCheckResult:
        if circuit is None:
            raise ValueError("frontier backend requires the encoded circuit")
        from quorum_intersection_tpu_torch.kernels.frontier_cuda import (
            CardState,
            FrontierKernels,
            IterationState,
            frontier_chunk,
            frontier_filter,
            frontier_mesh_chunk,
            mesh_cards,
            mesh_chunk,
            mesh_chunk_check,
        )

        t0 = time.perf_counter()
        prob = frontier_problem(graph, circuit, scc, scope_to_scc=scope_to_scc, pad_shapes=self.pad_shapes)
        s_dev, scc_pos, circuit, probe_circuit = prob.s_dev, prob.scc_pos, prob.circuit, prob.probe_circuit
        fp_circuit, fp_probe, scc_local = prob.fp_circuit, prob.fp_probe, prob.scc_local

        K = self.pop
        C = self.arena
        mesh = self.mesh
        if mesh is not None:
            # The pop block splits evenly over the ranks: K rounded up to a
            # multiple of them, but never above arena // 4, where the spill's
            # keep = top - C // 2 could go negative (JAX :602-617).
            n_dev = mesh.size
            if C < 4 * n_dev:
                raise ValueError(f"arena={C} too small for a {n_dev}-device mesh (needs >= {4 * n_dev})")
            K = min(((K + n_dev - 1) // n_dev) * n_dev, (C // 4 // n_dev) * n_dev)
        # The loop exits once flag_exit is reached, and one more iteration
        # flags at most K (the effective K): at the threshold's cap no flag
        # can be dropped.
        flag_cap = self.flag_exit * FLAG_EXIT_GROWTH + K
        shape = ChunkShape(half=prob.half, K=K, C=C, chunk_iters=self.chunk_iters, flag_cap=flag_cap)
        # The kernels' build before their first use (the stat
        # kernel_build_seconds; nothing to build for the plain versions).
        build_s = build.timed_build(("frontier",)) if self.device.type == "cuda" else 0.0
        get_run_record().gauge("frontier.kernel_build_seconds", round(build_s, 4))
        # One problem a device: ranks on one device share its tables.
        kerns_by_device: Dict[torch.device, FrontierKernels] = {}
        for dev in (mesh.devices if mesh is not None else (self.device,)):
            if dev not in kerns_by_device:
                kerns_by_device[dev] = FrontierKernels(circuit, prob.scc_dev, prob.a_scc, shape,
                                                       probe_circuit=probe_circuit, frozen=prob.frozen, device=dev)
        rank_kerns = [kerns_by_device[d] for d in (mesh.devices if mesh is not None else (self.device,))]
        kern = rank_kerns[0]  # the home device's: K10 and the reads
        # Under a mesh of one process, K9's mesh-chunk instance, whose ranks
        # of a card share one arena; across processes the iteration
        # instance, an arena a rank.
        instance = None if mesh is None else ("chunk" if mesh.process_count == 1 else "iteration")
        cards = mesh_cards(mesh.devices) if instance == "chunk" else []
        holder_kerns = [kerns_by_device[d] for d, _ in cards] if cards else rank_kerns
        host_check = None  # built on the first flagged batch

        stats = {
            "backend": self.name,
            "device": self.device.type,
            "device_iters": 0,
            "device_chunks": 0,
            "states_popped": 0,
            "flagged": 0,
            "host_checks": 0,
            "device_flag_checks": 0,
            "minimal_quorums": 0,
            "spills": 0,
            # Dispatched-but-abandoned chunks: their counts never reach the
            # counters above.
            "discarded_chunks": 0,
            "kernel_build_seconds": round(build_s, 4),
        }
        if prob.padded_from is not None:
            stats["padded_from"] = prob.padded_from
            stats["padded_shape"] = [s_dev, circuit.n, circuit.n_units]
        if mesh is not None:
            stats["mesh"] = {"devices": mesh.describe(), "ranks": mesh.size, "processes": mesh.process_count,
                             "collective": collective_of(mesh), "pop": K, "instance": instance,
                             f"{instance}_launches": 0}

        fingerprint = None
        resumed = None
        if self.checkpoint is not None:
            from quorum_intersection_tpu_torch.utils.checkpoint import sweep_fingerprint

            # Masks in the (possibly restricted) circuit's index space; the
            # probe thresholds join the hash when restricted (JAX :654-677).
            scc_mask = np.zeros(fp_circuit.n, dtype=np.float32)
            scc_mask[scc_local] = 1.0
            fp_frozen = (
                np.zeros(fp_circuit.n, dtype=np.float32)
                if (scope_to_scc or fp_probe is not None)
                else 1.0 - scc_mask
            )
            fingerprint = sweep_fingerprint(
                fp_circuit.members, fp_circuit.child, fp_circuit.thresholds,
                np.asarray(scc, dtype=np.int32), scc_mask, fp_frozen,
                None if fp_probe is None else fp_probe.thresholds,
            )
            resumed = self.checkpoint.resume_states(fingerprint)

        spill: List[Tuple[np.ndarray, np.ndarray]] = []  # host stack of blocks

        def encode_states(pairs) -> Tuple[np.ndarray, np.ndarray]:
            """(toRemove, dontRemove) node-list pairs → int8 lane rows."""
            t_blk = np.zeros((len(pairs), s_dev), dtype=np.int8)
            d_blk = np.zeros((len(pairs), s_dev), dtype=np.int8)
            for r, (to_remove, dont_remove) in enumerate(pairs):
                for v in to_remove:
                    t_blk[r, scc_pos[v]] = 1
                for v in dont_remove:
                    d_blk[r, scc_pos[v]] = 1
            return t_blk, d_blk

        # A pair of arena sets a card (the mesh-chunk instance) or a rank;
        # the home device's is the one read.
        holder_sets = [(k.arena(), k.arena()) for k in holder_kerns]
        sets = holder_sets[0]

        def load(index: int, t_rows: np.ndarray, d_rows: np.ndarray) -> None:
            """Rows [0, len) of every holder's set ``index`` and its top from
            host blocks."""
            top = len(t_rows)
            for pair in holder_sets:
                st = pair[index]
                if top:
                    st.T[:top] = torch.from_numpy(t_rows).to(st.T.device)
                    st.D[:top] = torch.from_numpy(d_rows).to(st.D.device)
                st.ctr.copy_(torch.tensor([top, 0, 0, 0], dtype=torch.int32))

        seed = resumed[: C // 2] if resumed else [(list(scc), [])]
        load(0, *encode_states(seed))
        if resumed:
            stats["resumed_states"] = len(resumed)
            # The excess goes to the host spill in C // 2-row blocks, as
            # overflow spills do.
            for i in range(C // 2, len(resumed), C // 2):
                spill.append(encode_states(resumed[i: i + C // 2]))

        on_card = self.device.type == "cuda"
        pinned = None
        if on_card:
            pinned = [(torch.empty(4, dtype=torch.int32).pin_memory(),
                       torch.empty((flag_cap, s_dev), dtype=torch.int8).pin_memory()) for _ in sets]

        mesh_states = None
        if instance == "chunk":
            mesh_states = [CardState.empty(K, mesh.size, ranks, *pair) for (_, ranks), pair in zip(cards, holder_sets)]
        elif instance == "iteration":
            mesh_states = [IterationState.empty(K, mesh.size, *pair) for pair in holder_sets]

        status_pinned = None
        if instance == "chunk" and on_card:
            status_pinned = [[torch.empty(1, dtype=torch.int32).pin_memory() for _ in mesh_states] for _ in sets]

        def run_iteration_chunk(src_i: int, flag_exit_now: int) -> None:
            for pair, st in zip(holder_sets, mesh_states):
                st.begin(pair[src_i], pair[1 - src_i])
            stats["mesh"]["iteration_launches"] += mesh_chunk(mesh, holder_kerns, mesh_states, flag_exit_now)

        def dispatch(src_i: int, flag_exit_now: int):
            """Chunk from set ``src_i`` into the other one; on the card its
            counters and flags follow to pinned memory behind an event.
            Under the iteration instance the chunk runs when it is first
            read."""
            dst_i = 1 - src_i
            dst = sets[dst_i]
            check = None
            if instance == "iteration":
                return _MeshChunk(dst_i, dst, flag_exit_now, lambda: run_iteration_chunk(src_i, flag_exit_now))
            if instance == "chunk":
                for pair, st in zip(holder_sets, mesh_states):
                    st.begin(pair[src_i], pair[dst_i])
                frontier_mesh_chunk(holder_kerns, mesh_states, flag_exit_now)
                stats["mesh"]["chunk_launches"] += len(mesh_states)
                check = mesh_chunk_check(mesh_states, status_pinned[dst_i] if status_pinned else [])
            else:
                frontier_chunk(kern, sets[src_i], dst, flag_exit_now)
            host = None
            if on_card:
                ctr_h, flags_h = pinned[dst_i]
                ctr_h.copy_(dst.ctr, non_blocking=True)
                flags_h.copy_(dst.flags, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                host = (ctr_h, flags_h, ev)
            return _Chunk(dst_i, dst, flag_exit_now, host, check)

        witness: Optional[Tuple[List[int], List[int]]] = None
        last_ckpt = time.monotonic()
        first_chunk_s = 0.0
        chunk_s = 0.0

        # Flag-exit threshold: the configured value first (a broken network's
        # witness surfaces fast), doubled on each flag-bound chunk.
        flag_exit_cur = self.flag_exit
        flag_exit_cap = self.flag_exit * FLAG_EXIT_GROWTH

        use_device_filter = self.flag_check == "device" or (self.flag_check == "auto" and on_card)
        flag_block = flag_cap
        pending_flags: Optional[np.ndarray] = None
        side = None
        if on_card and use_device_filter:
            # K10's own stream, so that it need not queue behind the
            # speculative chunk on the main one (K9 holds a few dozen SMs),
            # its flag block uploaded from pinned memory and its result read
            # back behind an event.
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))  # the tables are set up
            stage = torch.empty((flag_block, s_dev), dtype=torch.int8).pin_memory()
            result_h = torch.empty(2, dtype=torch.int32).pin_memory()
            with torch.cuda.stream(side):
                blk_dev = torch.empty((flag_block, s_dev), dtype=torch.int8, device=self.device)

        def device_filter(blk: np.ndarray) -> Tuple[int, int]:
            """K10 over one flag block: ``(minimal count, first witness
            index or flag_block)``."""
            cnt = len(blk)
            if side is None:
                padded = np.zeros((flag_block, s_dev), dtype=np.int8)
                padded[:cnt] = blk
                return tuple(frontier_filter(kern, torch.from_numpy(padded).to(self.device), cnt).tolist())
            stage[:cnt] = torch.from_numpy(blk)
            with torch.cuda.stream(side):
                blk_dev[:cnt].copy_(stage[:cnt], non_blocking=True)
                result_h.copy_(frontier_filter(kern, blk_dev, cnt), non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            done.synchronize()
            return tuple(result_h.tolist())

        def serial_check(rows: np.ndarray) -> bool:
            """Exact host check per row; True iff a witness was found."""
            nonlocal witness, host_check
            if host_check is None:
                host_check = self._make_host_checker(graph, scc, scope_to_scc)
            for row in rows:
                members = [scc[i] for i in np.nonzero(row)[0]]
                stats["host_checks"] += 1
                minimal, hit = host_check(members)
                if minimal:
                    stats["minimal_quorums"] += 1
                if hit is not None:
                    witness = hit
                    return True
            return False

        def process_pending() -> None:
            nonlocal witness, host_check, pending_flags
            rows = pending_flags
            pending_flags = None
            if rows is None or not len(rows):
                return
            if not use_device_filter:
                serial_check(rows)
                return
            for start in range(0, len(rows), flag_block):
                blk = rows[start:start + flag_block]
                cnt = len(blk)
                mins, widx = device_filter(blk)
                stats["device_flag_checks"] += cnt
                if widx >= flag_block:
                    stats["minimal_quorums"] += mins
                    continue
                # The device names a witness candidate: the exact host
                # semantics re-check it before any verdict.
                if host_check is None:
                    host_check = self._make_host_checker(graph, scc, scope_to_scc)
                members = [scc[i] for i in np.nonzero(blk[widx])[0]]
                stats["host_checks"] += 1
                minimal, hit = host_check(members)
                if hit is not None:
                    stats["minimal_quorums"] += mins
                    witness = hit
                    return
                if on_card:
                    # K10 is held exact to its plain version: a candidate the
                    # exact semantics refuse is a kernel fault, not a verdict.
                    raise RuntimeError(
                        f"frontier_filter named flag {widx} of a {cnt}-flag block (chunk "
                        f"{stats['device_chunks']}, rows from {start}) as a witness candidate, and the exact "
                        f"host check refuses it (minimal {minimal})"
                    )
                # The plain version on the CPU keeps the JAX drive's answer to
                # a disagreement (frontier.py:812-824): exactness wins — count
                # the checked nominee, then check the rest of the block serially.
                log.warning("device flag filter disagreed with the exact host check; "
                            "serial check of %d flagged states", cnt)
                if minimal:
                    stats["minimal_quorums"] += 1
                if serial_check(np.delete(blk[:cnt], widx, axis=0)):
                    return

        # The pipeline of the JAX drive (frontier.py:826-984): `inflight` is
        # the dispatched, unread chunk; each turn chains a speculative chunk
        # onto its device counters before the host reads anything.  A chunk
        # is a no-op exactly where the host must intervene (top == 0, or top
        # past C - 2K), so a speculative chunk is dropped there and a fresh
        # one dispatched after the intervention.
        t_chunk = time.perf_counter()
        inflight = dispatch(0, flag_exit_cur)  # from the seeded set 0 into set 1
        while witness is None:
            # A device failure mid-search (the JAX drive's frontier.py:854):
            # a fired fault fails the solve.
            fault_point("frontier.chunk")
            spec = dispatch(inflight.index, flag_exit_cur)
            process_pending()  # the previous chunk's flags, overlapping the device
            if witness is not None:
                stats["discarded_chunks"] += 2
                break
            top_h, fcount_h, iters_h, popped_h = inflight.counters()
            if stats["device_chunks"] == 0:
                first_chunk_s = time.perf_counter() - t_chunk
            else:
                chunk_s += time.perf_counter() - t_chunk
            stats["device_chunks"] += 1
            stats["device_iters"] += iters_h
            stats["states_popped"] += popped_h
            stats["flagged"] += fcount_h
            get_run_record().add("cert.frontier_chunks")
            log.debug("frontier chunk %d: %d iters, %d popped, top=%d, %d flagged (exit at %d), "
                      "%d spilled blocks", stats["device_chunks"], iters_h, popped_h, top_h, fcount_h,
                      flag_exit_cur, len(spill))

            if fcount_h:
                pending_flags = inflight.flags(fcount_h)
                # Grow against the threshold this chunk ran under (the
                # speculative chunk runs one threshold behind).
                if fcount_h >= inflight.flag_exit and flag_exit_cur < flag_exit_cap:
                    flag_exit_cur = min(max(flag_exit_cur, inflight.flag_exit) * 2, flag_exit_cap)

            cur = inflight.dst
            intervened = False
            if top_h > C - 2 * K:
                # Overflow: spill the oldest half [0, C // 2) to the host and
                # move the rest down, on every holder.  Stream order puts this
                # after the speculative chunk, which only reads this set.
                spill.append((cur.T[: C // 2].cpu().numpy().copy(), cur.D[: C // 2].cpu().numpy().copy()))
                keep = top_h - C // 2
                for pair in holder_sets:
                    st = pair[inflight.index]
                    st.T[:keep] = st.T[C // 2: top_h].clone()
                    st.D[:keep] = st.D[C // 2: top_h].clone()
                    st.ctr[0] = keep
                top_h = keep
                stats["spills"] += 1
                intervened = True
            elif top_h == 0:
                if not spill:
                    # Worklist exhausted: drain the pending flags before
                    # concluding; the speculative chunk ran as a no-op.
                    stats["discarded_chunks"] += 1
                    process_pending()
                    break
                T_blk, D_blk = spill.pop()
                live = np.nonzero((T_blk | D_blk).any(axis=1))[0]
                load(inflight.index, T_blk[live], D_blk[live])
                top_h = len(live)
                intervened = True

            if self.checkpoint is not None and witness is None:
                # No write after a witness (a resume could lose it), and the
                # pending flags of this chunk are drained before any write.
                due_interrupt = (
                    self.interrupt_after_chunks is not None
                    and stats["device_chunks"] >= self.interrupt_after_chunks
                    and (top_h > 0 or spill)
                )
                due_interval = time.monotonic() - last_ckpt >= self.checkpoint_interval_s
                if due_interrupt or due_interval:
                    process_pending()
                    if witness is not None:
                        stats["discarded_chunks"] += 1
                        break
                if due_interrupt:
                    self._write_checkpoint(cur, top_h, spill, scc, fingerprint)
                    raise FrontierSearchInterrupted(
                        f"simulated preemption after {stats['device_chunks']} chunks")
                if due_interval:
                    self._write_checkpoint(cur, top_h, spill, scc, fingerprint)
                    last_ckpt = time.monotonic()

            if intervened:
                stats["discarded_chunks"] += 1
                inflight = dispatch(inflight.index, flag_exit_cur)
            else:
                inflight = spec
            t_chunk = time.perf_counter()

        if on_card:
            for dev in kerns_by_device:  # abandoned chunks end before the arenas go
                torch.cuda.synchronize(dev)
        stats["seconds"] = time.perf_counter() - t0
        stats["first_chunk_seconds"] = round(first_chunk_s, 3)
        stats["chunk_seconds"] = round(chunk_s, 3)
        # The certificate's coverage evidence: the worklist accounting.
        stats["cert"] = {
            "frontier_chunks_drained": stats["device_chunks"],
            "states_popped": stats["states_popped"],
            "flagged": stats["flagged"],
            "minimal_quorums": stats["minimal_quorums"],
            "host_checks": stats["host_checks"],
            "device_flag_checks": stats["device_flag_checks"],
        }
        if self.checkpoint is not None:
            self.checkpoint.clear()
        if witness is not None:
            q1, q2 = witness
            return SccCheckResult(intersects=False, q1=q1, q2=q2, stats=stats)
        return SccCheckResult(intersects=True, stats=stats)

    def _write_checkpoint(self, st, top: int, spill, scc, fingerprint) -> None:
        """Persist the whole frontier (the arena's live rows and the host
        spill) in the FrontierCheckpoint (toRemove, dontRemove) format."""
        states = []

        def add_block(T_blk, D_blk):
            for t_row, d_row in zip(T_blk, D_blk):
                if not (t_row.any() or d_row.any()):
                    continue
                states.append([[scc[i] for i in np.nonzero(t_row)[0]],
                               [scc[i] for i in np.nonzero(d_row)[0]]])

        add_block(st.T[:top].cpu().numpy(), st.D[:top].cpu().numpy())
        for T_blk, D_blk in spill:
            add_block(T_blk, D_blk)
        self.checkpoint.record(states, fingerprint)
