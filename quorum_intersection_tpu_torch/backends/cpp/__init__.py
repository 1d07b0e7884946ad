"""Native C++ host layer: the branch-and-bound oracle, the standalone CLI,
their builds, bindings and marshalling.

The port's copy of the JAX package's ``backends/cpp/__init__.py``.  Two
sources sit beside this file, each the JAX package's with one comment line
reworded (``tests/test_torch_convert.py`` pins the rest byte for byte):

- ``qi_oracle.cpp``, the search core, compiled at first use with
  ``g++ -O3 -fPIC -shared`` into a library loaded through :mod:`ctypes`
  (which releases the GIL for the whole search);
- ``qi_native.cpp``, the standalone CLI (the reference tool's single-binary
  deployment: parser, trust graph, Tarjan, the per-SCC scan, the search
  linked from ``qi_oracle.cpp``, PageRank, Graphviz), built by
  :func:`build_native_cli`, optionally under a sanitizer (``QI_SANITIZER``).
  It touches no device.

Every build lands in ``_build/`` (gitignored), or under
``QI_NO_COMPILE_CACHE`` in a private directory of the process
(:mod:`..utils.compile_cache`), named by a hash of the sources and flags so
an edit rebuilds; the build writes a temporary file and renames it into
place, so concurrent builders never load a half-written file.

Marshalling: the :class:`TrustGraph` is flattened per call into int32 arrays
(:class:`FlatGraph`) — CSR successor lists plus a pool of quorum-set
"units" (threshold, a span of direct members, a span of inner units); a null
qset (Q2) is root ``-1``.

:func:`native_top_tier` binds the library's minimal-quorum enumeration
(``qi_top_tier``) for the top-tier analysis and the rank order;
:class:`NativeMaxQuorum` its greatest fixpoint (``qi_max_quorum``) for the
frontier's exact host checks of flagged sets and :func:`native_scc_scan`,
the pipeline's per-SCC scan on big graphs; :func:`native_candidate_check`
its per-candidate check (``qi_candidate_check``), the host's candidate rate.

The backend gives the Python oracle's verdicts, witnesses and search
statistics (:mod:`.python_oracle`) in deterministic mode.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from quorum_intersection_tpu_torch.backends.base import (
    OracleBudgetExceeded,
    SccCheckResult,
    SearchCancelled,
)
from quorum_intersection_tpu_torch.encode.circuit import Circuit
from quorum_intersection_tpu_torch.fbas.graph import IndexedQSet, TrustGraph
from quorum_intersection_tpu_torch.fbas.schema import MAX_QSET_DEPTH
from quorum_intersection_tpu_torch.utils import compile_cache
from quorum_intersection_tpu_torch.utils.env import qi_env
from quorum_intersection_tpu_torch.utils.faults import fault_point
from quorum_intersection_tpu_torch.utils.telemetry import Span, get_run_record

log = logging.getLogger("quorum_intersection_tpu_torch.backends.cpp")

SRC = Path(__file__).with_name("qi_oracle.cpp")
CLI_SRC = Path(__file__).with_name("qi_native.cpp")
BUILD_DIR = Path(__file__).with_name("_build")
GXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared"]
CLI_FLAGS = ["-std=c++17", "-O2"]

# The instrumented builds of the standalone CLI, by sanitizer: asan is the
# memory and undefined-behaviour check, tsan vets the cancel flag another
# thread flips under the racing router.
SANITIZER_FLAGS: Dict[str, List[str]] = {
    "asan": ["-std=c++17", "-O1", "-g", "-fsanitize=address,undefined", "-fno-sanitize-recover=all"],
    "tsan": ["-std=c++17", "-O1", "-g", "-fsanitize=thread"],
}

# Ceiling on one g++ run: the oracle builds in a few seconds and the
# sanitized CLI in tens, so this means a wedged compiler — fail with its
# output instead of hanging the solve.
BUILD_TIMEOUT_S = 600

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)

_lib: Optional[ctypes.CDLL] = None


def _hashed(stem: str, sources: Sequence[Path], flags: Sequence[str], suffix: str = "") -> Path:
    text = b"".join(src.read_bytes() for src in sources) + " ".join(flags).encode()
    return compile_cache.build_dir(BUILD_DIR) / f"{stem}-{hashlib.sha256(text).hexdigest()[:16]}{suffix}"


def so_path() -> Path:
    return _hashed("qi_oracle", [SRC], GXX_FLAGS, ".so")


def _run_gxx(cmd: Sequence[str], what: str) -> "subprocess.CompletedProcess":
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        stderr = exc.stderr or b""
        if isinstance(stderr, bytes):
            stderr = stderr.decode("utf-8", "replace")
        raise RuntimeError(
            f"{what} timed out after {BUILD_TIMEOUT_S}s (`{' '.join(cmd)}`):\n{stderr.strip()}"
        ) from exc


def _compile(out: Path, sources: Sequence[Path], flags: Sequence[str], what: str, force: bool) -> Path:
    """One content-hashed g++ artifact (idempotent; a temporary file renamed
    into place, one per builder process)."""
    compile_cache.note(out, hit=out.exists() and not force)
    if out.exists() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = ["g++", *flags, "-o", str(tmp), *map(str, sources)]
    log.info("building the %s: %s", what, " ".join(cmd))
    # A broken toolchain: the auto router degrades to the Python oracle.
    fault_point("native.build")
    proc = _run_gxx(cmd, f"{what} build")
    if proc.returncode != 0:
        raise RuntimeError(f"{what} build failed (exit {proc.returncode}):\n{proc.stderr}")
    tmp.replace(out)
    return out


def build_library(force: bool = False) -> Path:
    """Compile ``qi_oracle.cpp`` into its content-hashed ``.so`` (idempotent)."""
    return _compile(so_path(), [SRC], GXX_FLAGS, "native oracle", force)


def sanitizer_mode() -> str:
    """The sanitizer an instrumented build uses: ``QI_SANITIZER`` in
    {asan, tsan, none}, default asan."""
    mode = qi_env("QI_SANITIZER").strip().lower() or "asan"
    if mode not in ("asan", "tsan", "none"):
        raise ValueError(f"QI_SANITIZER={mode!r} not in {{asan, tsan, none}}")
    return mode


def _probe_sanitizer_runtime(mode: str) -> None:
    """Compile and link a two-line program under the sanitizer, so a
    toolchain without its runtime fails here, naming it — never by handing
    back an uninstrumented binary."""
    with tempfile.TemporaryDirectory(prefix="qi-sanprobe-") as tmp:
        src = Path(tmp) / "probe.cpp"
        src.write_text("int main() { return 0; }\n")
        cmd = ["g++", *SANITIZER_FLAGS[mode], "-o", str(Path(tmp) / "probe"), str(src)]
        proc = _run_gxx(cmd, f"{mode} sanitizer probe")
    if proc.returncode != 0:
        raise RuntimeError(
            f"toolchain lacks the {mode} sanitizer runtime (probe `{' '.join(cmd)}` failed):\n"
            f"{proc.stderr.strip()}\nInstall the lib{mode} runtime or set QI_SANITIZER=none."
        )


def build_native_cli(force: bool = False, sanitize: Union[bool, str] = False) -> Path:
    """Compile the standalone native CLI (``qi_native.cpp`` and the oracle)
    into a content-hashed binary and return its path (idempotent).

    ``sanitize`` picks an instrumented build, cached apart per sanitizer
    (``qi_native-{asan,tsan}-<digest>``): ``True`` takes the mode
    ``QI_SANITIZER`` names (default asan), or pass ``"asan"``/``"tsan"``.
    ``QI_SANITIZER=none`` (or ``sanitize="none"``) refuses the instrumented
    build instead of returning the plain binary: a passing sanitized run
    must mean the instrumentation ran.  A toolchain without the sanitizer's
    runtime fails at a probe first, naming the runtime."""
    if not sanitize:
        return _compile(_hashed("qi_native", [CLI_SRC, SRC], CLI_FLAGS), [CLI_SRC, SRC], CLI_FLAGS,
                        "native CLI", force)
    mode = sanitizer_mode() if sanitize is True else str(sanitize).lower()
    if mode == "none":
        raise RuntimeError(
            "sanitized build requested but QI_SANITIZER=none — unset it (or pick asan/tsan) to build "
            "an instrumented binary"
        )
    if mode not in SANITIZER_FLAGS:
        raise ValueError(f"unknown sanitizer {mode!r}; expected one of {sorted(SANITIZER_FLAGS)} or 'none'")
    flags = SANITIZER_FLAGS[mode]
    exe = _hashed(f"qi_native-{mode}", [CLI_SRC, SRC], flags)
    if force or not exe.exists():
        _probe_sanitizer_runtime(mode)
    return _compile(exe, [CLI_SRC, SRC], flags, f"{mode}-sanitized native CLI", force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.qi_check_scc_cancel.restype = ctypes.c_int32
    lib.qi_check_scc_cancel.argtypes = [
        ctypes.c_int32,  # n
        _i32p, _i32p,  # succ_off, succ_tgt
        _i32p, _i32p, _i32p, _i32p,  # roots, units, mem, inner
        _i32p, ctypes.c_int32,  # scc, scc_len
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,  # scope, use_rng, seed
        ctypes.c_int32,  # trace (per-call stderr narration)
        ctypes.c_int64,  # budget_calls (0 = unlimited; -2 return on overrun)
        _i32p,  # cancel_flag (NULL = uncancellable; -3 return on cancel)
        _i32p, _i32p, _i32p, _i32p,  # q1_out, q1_len, q2_out, q2_len
        _i64p,  # stats_out[3]
    ]
    lib.qi_top_tier.restype = ctypes.c_int64
    lib.qi_top_tier.argtypes = [
        ctypes.c_int32,  # n
        _i32p, _i32p,  # succ_off, succ_tgt
        _i32p, _i32p, _i32p, _i32p,  # roots, units, mem, inner
        _i32p, ctypes.c_int32,  # scc, scc_len
        ctypes.c_int64,  # budget_calls (0 = unlimited; -2 return on overrun)
        _u8p,  # union_out (n bytes)
        _i64p,  # stats_out[3]
    ]
    lib.qi_max_quorum.restype = ctypes.c_int32
    lib.qi_max_quorum.argtypes = [
        ctypes.c_int32,  # n
        _i32p, _i32p, _i32p, _i32p,  # roots, units, mem, inner
        _i32p, ctypes.c_int32,  # nodes, nodes_len
        _u8p, _i32p,  # avail (restored on return), out
    ]
    lib.qi_candidate_check.restype = ctypes.c_int64
    lib.qi_candidate_check.argtypes = [
        ctypes.c_int32,  # n
        _i32p, _i32p, _i32p, _i32p,  # roots, units, mem, inner
        _u8p, ctypes.c_int32,  # masks, batch
    ]
    _lib = lib
    return lib


class FlatGraph:
    """Int32 flattening of a :class:`TrustGraph` for the C ABI.

    Unit layout (5 ints per unit): ``threshold, member_begin, member_end,
    inner_begin, inner_end`` — spans into the ``mem`` (node-index) and
    ``inner`` (unit-index) pools.  A null qset flattens to root ``-1``;
    every stored threshold is Q3-normalized (``<= 0``, including a
    ``None``-threshold inner set, or ``> member count`` becomes the
    never-satisfiable ``m_count + 1``), as ``fbas.semantics.slice_satisfied``
    reads them, which also keeps arbitrary-precision JSON thresholds exact
    in int32.
    """

    def __init__(self, graph: TrustGraph) -> None:
        units: List[Tuple[int, int, int, int, int]] = []
        mem: List[int] = []
        inner: List[int] = []

        def add_unit(q: IndexedQSet, depth: int = 0) -> int:
            if depth > MAX_QSET_DEPTH:
                raise ValueError(f"quorumSet nesting exceeds depth {MAX_QSET_DEPTH}")
            uid = len(units)
            units.append((0, 0, 0, 0, 0))  # placeholder; children first
            mb = len(mem)
            mem.extend(q.members)
            me = len(mem)
            child_ids = [add_unit(iq, depth + 1) for iq in q.inner]
            ib = len(inner)
            inner.extend(child_ids)
            ie = len(inner)
            t = 0 if q.threshold is None else q.threshold
            m_count = (me - mb) + (ie - ib)
            if t <= 0 or t > m_count:
                t = m_count + 1
            units[uid] = (t, mb, me, ib, ie)
            return uid

        roots: List[int] = [-1 if q.threshold is None else add_unit(q) for q in graph.qsets]

        succ_off = np.zeros(graph.n + 1, dtype=np.int32)
        for v, targets in enumerate(graph.succ):
            succ_off[v + 1] = succ_off[v] + len(targets)
        succ_tgt = np.fromiter(
            (w for targets in graph.succ for w in targets), dtype=np.int32, count=int(succ_off[-1])
        )

        self.n = graph.n
        self.succ_off = np.ascontiguousarray(succ_off)
        self.succ_tgt = np.ascontiguousarray(succ_tgt)
        self.roots = np.asarray(roots, dtype=np.int32)
        self.units = np.asarray([x for unit in units for x in unit] or [0], dtype=np.int32)
        self.mem = np.asarray(mem or [0], dtype=np.int32)
        self.inner = np.asarray(inner or [0], dtype=np.int32)

    @staticmethod
    def ptr(arr: np.ndarray):
        return arr.ctypes.data_as(_i32p)


class CppOracleBackend:
    """Branch-and-bound disjointness search in native code (C++17 via ctypes)."""

    name = "cpp"
    needs_circuit = False  # searches the host set semantics, like the Python oracle

    def __init__(
        self,
        seed: Optional[int] = None,
        randomized: bool = False,
        budget_calls: Optional[int] = None,
        cancel=None,
    ) -> None:
        self._use_rng = bool(randomized or seed is not None)
        # randomized without a seed is real nondeterminism, as in the Python
        # oracle's random.Random(None).
        self._seed = int.from_bytes(os.urandom(8), "little") if seed is None else int(seed)
        # B&B call budget (0: none): check_scc raises OracleBudgetExceeded.
        self._budget_calls = 0 if budget_calls is None else int(budget_calls)
        # A CancelToken whose int32 flag the native search polls.
        self._cancel = cancel

    def ensure_built(self) -> None:
        _load()

    def check_scc(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        *,
        scope_to_scc: bool = False,
    ) -> SccCheckResult:
        # One span per native entry: its id is the call id echoed in the
        # stats, which joins a result back to the call that produced it.
        with get_run_record().span("native.call", scc=len(scc)) as call_span:
            return self._check_scc_traced(call_span, graph, scc, scope_to_scc)

    def _check_scc_traced(
        self, call_span: Span, graph: TrustGraph, scc: List[int], scope_to_scc: bool
    ) -> SccCheckResult:
        call_id = call_span.span_id
        # A crashed (error) or wedged (hang) native call: the auto router's
        # ladder degrades or, past the watchdog, quarantines the rung.
        fault_point("native.call")
        lib = _load()
        flat = FlatGraph(graph)
        scc_arr = np.asarray(scc, dtype=np.int32)
        q1 = np.zeros(graph.n, dtype=np.int32)
        q2 = np.zeros(graph.n, dtype=np.int32)
        q1_len = ctypes.c_int32(0)
        q2_len = ctypes.c_int32(0)
        stats = np.zeros(3, dtype=np.int64)
        cancel_ptr = _i32p() if self._cancel is None else self._cancel.flag.ctypes.data_as(_i32p)
        t0 = time.perf_counter()
        intersects = lib.qi_check_scc_cancel(
            flat.n,
            flat.ptr(flat.succ_off),
            flat.ptr(flat.succ_tgt),
            flat.ptr(flat.roots),
            flat.ptr(flat.units),
            flat.ptr(flat.mem),
            flat.ptr(flat.inner),
            scc_arr.ctypes.data_as(_i32p),
            len(scc),
            int(scope_to_scc),
            int(self._use_rng),
            self._seed,
            int(log.isEnabledFor(logging.DEBUG)),
            self._budget_calls,
            cancel_ptr,
            q1.ctypes.data_as(_i32p),
            ctypes.byref(q1_len),
            q2.ctypes.data_as(_i32p),
            ctypes.byref(q2_len),
            stats.ctypes.data_as(_i64p),
        )
        seconds = time.perf_counter() - t0
        rec = get_run_record()
        rec.add("native.check_scc_calls")
        rec.add("native.check_scc_seconds", round(seconds, 6))
        rec.add("native.bnb_calls", int(stats[0]))
        call_span.set(call_id=call_id, bnb_calls=int(stats[0]), seconds=round(seconds, 6))

        if intersects == -2:
            rec.add("oracle.budget_calls_consumed", self._budget_calls)
            raise OracleBudgetExceeded(
                f"native oracle exceeded {self._budget_calls} B&B calls "
                f"on |scc|={len(scc)} after {seconds:.2f}s"
            )
        if intersects == -3:
            raise SearchCancelled(
                f"native oracle cancelled on |scc|={len(scc)} after "
                f"{seconds:.2f}s ({int(stats[0])} B&B calls)"
            )
        return SccCheckResult(
            intersects=bool(intersects),
            q1=q1[: q1_len.value].tolist() if not intersects else None,
            q2=q2[: q2_len.value].tolist() if not intersects else None,
            stats={
                "backend": self.name,
                "bnb_calls": int(stats[0]),
                "minimal_quorums": int(stats[1]),
                "fixpoint_calls": int(stats[2]),
                "seconds": seconds,
                "native_call_id": call_id,
                # The coverage ledger of a B&B engine: its node counts.
                "cert": {
                    "bnb_calls": int(stats[0]),
                    "minimal_quorums": int(stats[1]),
                    "fixpoint_calls": int(stats[2]),
                    "native_call_id": call_id,
                },
            },
        )


def native_top_tier(
    graph: TrustGraph, scc: List[int], budget_calls: int = 0
) -> Tuple[Optional[List[int]], int]:
    """Union of all minimal quorums' members in the SCC via the native
    enumeration (the JAX package's ``native_top_tier``).  Returns
    ``(members, minimal_quorum_count)``; members is None when the call
    budget was exceeded (the count is then the partial tally)."""
    lib = _load()
    flat = FlatGraph(graph)
    scc_arr = np.asarray(scc, dtype=np.int32)
    union = np.zeros(graph.n, dtype=np.uint8)
    stats = np.zeros(3, dtype=np.int64)
    count = lib.qi_top_tier(
        flat.n,
        flat.ptr(flat.succ_off),
        flat.ptr(flat.succ_tgt),
        flat.ptr(flat.roots),
        flat.ptr(flat.units),
        flat.ptr(flat.mem),
        flat.ptr(flat.inner),
        scc_arr.ctypes.data_as(_i32p),
        len(scc),
        int(budget_calls),
        union.ctypes.data_as(_u8p),
        stats.ctypes.data_as(_i64p),
    )
    if count == -2:
        return None, int(stats[1])
    return np.nonzero(union)[0].tolist(), int(count)


class NativeMaxQuorum:
    """Reusable native greatest-fixpoint evaluator over one graph (JAX
    package ``backends/cpp/__init__.py:481-518``).

    ``nmq(candidates, avail)`` returns the surviving quorum members, as
    :func:`fbas.semantics.max_quorum` does; :meth:`count` only their number.
    ``avail`` is a writable uint8 row the caller owns for the call: the
    native fixpoint narrows it in place and restores it before returning.
    Built once per graph, so the flattening and the library load amortize
    over the thousands of minimality fixpoints a safe hierarchical frontier
    search checks."""

    def __init__(self, graph: TrustGraph) -> None:
        self._lib = _load()
        self._flat = FlatGraph(graph)
        self._out = np.zeros(graph.n, dtype=np.int32)

    def count(self, candidates, avail: np.ndarray) -> int:
        flat = self._flat
        arr = np.asarray(candidates, dtype=np.int32)
        return self._lib.qi_max_quorum(
            flat.n, flat.ptr(flat.roots), flat.ptr(flat.units), flat.ptr(flat.mem),
            flat.ptr(flat.inner), arr.ctypes.data_as(_i32p), len(arr),
            avail.ctypes.data_as(_u8p), self._out.ctypes.data_as(_i32p),
        )

    def __call__(self, candidates, avail: np.ndarray) -> List[int]:
        return self._out[: self.count(candidates, avail)].tolist()


def native_scc_scan(graph: TrustGraph, sccs: List[List[int]]) -> List[List[int]]:
    """One max-quorum per SCC, restricted to its members, through
    ``qi_max_quorum`` (the JAX package's ``native_scc_scan``), with the
    Python scan's member order.  The JAX pipeline takes it above 256 nodes;
    the port's pipeline keeps its Python loop, the faster of the two on the
    card's host (``pipeline.scan_scc_quorums``).  Books ``native.scan_fixpoints`` and
    ``native.scan_seconds``."""
    t0 = time.perf_counter()
    nmq = NativeMaxQuorum(graph)
    avail = np.zeros(graph.n, dtype=np.uint8)
    quorums: List[List[int]] = []
    for members in sccs:
        arr = np.asarray(members, dtype=np.int32)
        avail[arr] = 1
        quorums.append(nmq(arr, avail))
        avail[arr] = 0
    rec = get_run_record()
    rec.add("native.scan_fixpoints", len(sccs))
    rec.add("native.scan_seconds", round(time.perf_counter() - t0, 6))
    return quorums


def native_candidate_check(graph: TrustGraph, masks: np.ndarray) -> Tuple[int, float]:
    """The sweep's per-candidate check (the fixpoint and the complement
    probe) over a batch of availability masks (rows of ``graph.n`` bytes),
    in native code on one host core.  Returns ``(hits, seconds)``."""
    lib = _load()
    flat = FlatGraph(graph)
    m = np.ascontiguousarray(masks.astype(np.uint8))
    t0 = time.perf_counter()
    hits = lib.qi_candidate_check(
        flat.n, flat.ptr(flat.roots), flat.ptr(flat.units), flat.ptr(flat.mem), flat.ptr(flat.inner),
        m.ctypes.data_as(_u8p), m.shape[0],
    )
    return int(hits), time.perf_counter() - t0


def native_candidate_rate(graph: TrustGraph, masks: np.ndarray) -> float:
    """Candidates a second of :func:`native_candidate_check` on one host core."""
    _, seconds = native_candidate_check(graph, masks)
    return masks.shape[0] / seconds if seconds > 0 else float("inf")
