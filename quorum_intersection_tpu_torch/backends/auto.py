"""Automatic backend selection: the budgeted host oracle raced against the
sweep on the card.

The port of the JAX package's ``AutoBackend`` (``backends/auto.py:159-548``,
``:614-1544``), optimizing time to the verdict:

- **|scc| within the sweep limit** (45, the sweep's decode ceiling, on
  CUDA; 18 on ``device="cpu"``): **race** the host oracle, run on this
  thread under a branch-and-bound call budget sized to the sweep's
  estimated cost, against the sweep, started on a worker thread.  The first
  verdict wins and the loser is cancelled through a :class:`CancelToken`.
  ``race=False`` (CLI ``--no-race``) runs the oracle alone first and the
  sweep only after a burned budget.
- **larger SCCs**: the device-resident frontier (``gpu-frontier``) inside
  the win region measured on the live card kind (``calibration``
  ``frontier_win_*``, plus ``FRONTIER_WIN_SCC_HEADROOM``), as the JAX
  router's frontier rung (``backends/auto.py:1443-1517``); elsewhere the
  host oracle, unbudgeted.

The host oracle is the native C++ oracle, degrading to the Python oracle on
a failed ``g++`` build, a watchdog trip or a quarantine
(:class:`DegradationLadder`, ``QI_NATIVE_WATCHDOG_S``): two exact host
engines with the same answers.  The card's rung never degrades: any
exception from the ``gpu-sweep`` or the ``gpu-frontier`` rung (a kernel
limit, an ``nvcc`` failure, a CUDA launch error, which leaves the context
unusable) propagates and fails the solve, without retries.

The sweep takes the JAX router's bitset hint (``_bitset_hint``,
``backends/auto.py:687-729``): inside the bitset engine's win region
measured on the live card kind (``calibration`` ``bitset_win_*``) the
sweep runs ``engine="bitset"``, at the race arm, the sweep rung and the
pack entry; an explicit ``QI_SWEEP_ENGINE`` always wins.  A
``checkpoint=`` (:class:`..utils.checkpoint.SweepCheckpoint`) goes to the
sweep, and to the frontier rung at the same path as a frontier file; a
checkpoint with recorded progress skips the oracle and the race, a losing
race arm clears what it recorded, and the batch entry does not pack with
one.

A ``mesh=`` (:class:`..parallel.mesh.CandidateMesh`, the CLI's ``--mesh``)
goes to every sweep the router builds (the JAX router's ``:682``) and to
its frontier rung (``:1492``), and closes the pack gate (``:1194``): the
sharded sweep packs nothing.

The router's constants come from :mod:`.calibration`, keyed by the live
card's name; the device is explicit (``device=``), so the budget needs no
platform probe.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, TypeVar

import torch

from quorum_intersection_tpu_torch.backends.base import (
    CancelToken,
    OracleBudgetExceeded,
    SccCheckResult,
    SearchBackend,
    SearchCancelled,
    cancelled_result,
)
from quorum_intersection_tpu_torch.backends.calibration import H100, HOST_CPU, Calibration
from quorum_intersection_tpu_torch.backends.sweep import LO_BITS, MAX_BITS
from quorum_intersection_tpu_torch.device import DeviceLike
from quorum_intersection_tpu_torch.encode.circuit import Circuit
from quorum_intersection_tpu_torch.fbas.graph import TrustGraph
from quorum_intersection_tpu_torch.fbas.synth import scc_qset_density
from quorum_intersection_tpu_torch.parallel.mesh import CandidateMesh, mesh_device
from quorum_intersection_tpu_torch.utils.checkpoint import SweepCheckpoint
from quorum_intersection_tpu_torch.utils.env import qi_env, qi_env_float
from quorum_intersection_tpu_torch.utils.telemetry import Span, dump_flight_recorder, get_run_record

_T = TypeVar("_T")

log = logging.getLogger("quorum_intersection_tpu_torch.backends.auto")

# The sweep's decode ceiling: bits = |scc| - 1 <= MAX_BITS.
SWEEP_DECODE_CEILING = MAX_BITS + 1
# On the card the race runs up to the decode ceiling: with the race on, the
# faster engine answers either way, and the limit only says when the card
# may join.  On the CPU the JAX package's host limit: the plain sweep is
# kept where its worst case is sub-second.
SWEEP_LIMIT_CUDA = SWEEP_DECODE_CEILING
SWEEP_LIMIT_CPU = 18
# The smallest oracle budget, in B&B calls, whatever the estimate says.
MIN_ORACLE_BUDGET = 50_000
# How far past the largest measured winning |scc| the pack gate extends.
SWEEP_WIN_SCC_HEADROOM = 4
# How far past the largest measured winning |scc| the frontier's win region
# extends (JAX auto.py:141): one step of the measured grid.
FRONTIER_WIN_SCC_HEADROOM = 4

# Ceiling on how long the race waits for a cancelled losing sweep to unwind
# before returning the winner's verdict: about twice the oracle's own time,
# within these bounds.  A still-unwinding loser finishes in the background
# (``loser_joined: false``); its thread is non-daemon, so interpreter exit
# waits for it (a daemon thread killed inside a CUDA call can abort the
# process).
RACE_LOSER_JOIN_S = 5.0
RACE_LOSER_JOIN_MIN_S = 0.2

# Canonical rung names of the degrade events.
RUNGS = ("gpu-sweep", "gpu-frontier", "native", "python-oracle")
# How often the native watchdog re-checks the call and forwards a race cancel.
WATCHDOG_POLL_S = 0.05


def _race_sync(point: str) -> None:
    """Deterministic-schedule hook: a no-op in production; tests replace the
    module attribute to force the race's interleavings.  Points:

    - ``sweep.started``   — the worker thread entered, before any work
    - ``sweep.verdict``   — the sweep's result recorded, before cancelling
      the oracle
    - ``sweep.unwound``   — the worker saw its cancel and is exiting
    - ``oracle.returned`` — the oracle call completed (verdict, budget burn
      or cancel), before the winner is decided

    A replacement may block to order the threads but must return."""


def _watchdog_seconds() -> float:
    """``QI_NATIVE_WATCHDOG_S`` as the JAX package reads it: seconds, 0 (the
    default, also for a malformed value) meaning no watchdog."""
    return qi_env_float("QI_NATIVE_WATCHDOG_S", 0.0)


class RungFailed(RuntimeError):
    """A host rung failed; control falls to the next one."""

    def __init__(self, rung: str, cause: BaseException) -> None:
        self.rung = rung
        self.cause = cause
        super().__init__(f"ladder rung {rung!r} failed: {type(cause).__name__}: {cause}")


class NativeWatchdogTimeout(RuntimeError):
    """The native call passed its ``QI_NATIVE_WATCHDOG_S`` deadline.
    ``quarantine``: it also ignored the cancel past the grace window, so the
    native rung is out for the rest of the run."""

    def __init__(self, message: str, quarantine: bool) -> None:
        self.quarantine = quarantine
        super().__init__(message)


class DegradationLadder:
    """Degrade and quarantine policy of the host rungs, one per router.

    Every transition leaves a ``degrade`` event naming the failed rung, where
    control went and why.  The card's rung is not on this ladder: its
    failures propagate."""

    def __init__(self) -> None:
        self._quarantined: Set[str] = set()

    def quarantine(self, rung: str, cause: object) -> None:
        if rung in self._quarantined:
            return
        self._quarantined.add(rung)
        rec = get_run_record()
        rec.add("ladder.quarantines")
        rec.event("ladder.quarantined", rung=rung, cause=str(cause))
        rec.gauge("ladder.quarantined_rungs", sorted(self._quarantined))
        dump_flight_recorder(f"quarantine:{rung}")
        log.warning("ladder: rung %r quarantined for this run (%s)", rung, cause)

    def record_degrade(self, rung: str, to: str, cause: object) -> None:
        for name in (rung, to):
            if name not in RUNGS:
                log.warning("degrade event with non-canonical rung name %r (expected one of %s)", name, RUNGS)
        rec = get_run_record()
        rec.add("ladder.degrades")
        rec.event("degrade", rung=rung, to=to, cause=str(cause), attempts=1, transient=False)
        dump_flight_recorder(f"degrade:{rung}->{to}")
        log.info("ladder: %s -> %s (%s)", rung, to, cause)

    def attempt(self, rung: str, fn: Callable[[], _T], fall_to: str) -> _T:
        """Run one host rung; a failure other than the verdict path's flow
        control (budget, cancel) records the degrade and raises
        :class:`RungFailed` toward the caller's next rung."""
        if rung in self._quarantined:
            raise RungFailed(rung, RuntimeError("rung quarantined earlier in this run"))
        try:
            with get_run_record().span("ladder.rung", rung=rung, attempt=1):
                return fn()
        except (OracleBudgetExceeded, SearchCancelled, RungFailed):
            raise
        except Exception as exc:  # noqa: BLE001 — the host ladder's one broad catch
            self.record_degrade(rung, fall_to, exc)
            raise RungFailed(rung, exc) from exc


class _WatchedNativeOracle:
    """The native rung: the C++ oracle, under a watchdog when
    ``QI_NATIVE_WATCHDOG_S`` is set, degrading to the Python oracle on any
    failure that is not a verdict, a budget burn or a race cancel.

    Without a deadline the call runs on the caller's thread.  With one it
    runs on a supervised non-daemon thread: past the deadline the watchdog
    trips the native cancel flag (the rung stays available if the call
    unwinds), and a call that ignores it past the grace window quarantines
    the native rung for the run."""

    def __init__(
        self,
        ladder: DegradationLadder,
        native: SearchBackend,
        python_factory: Callable[[], SearchBackend],
        outer_cancel: Optional[CancelToken],
        native_cancel: Optional[CancelToken],
        watchdog_s: float,
    ) -> None:
        self._ladder = ladder
        self._native = native
        self._python_factory = python_factory
        # outer_cancel: the race's token, forwarded inward; native_cancel:
        # the token the native search polls (the watchdog's trip wire).
        self._outer_cancel = outer_cancel
        self._native_cancel = native_cancel
        self._watchdog_s = watchdog_s
        self.name = "cpp"

    def check_scc(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        *,
        scope_to_scc: bool = False,
    ) -> SccCheckResult:
        try:
            return self._supervised(graph, circuit, scc, scope_to_scc)
        except (OracleBudgetExceeded, SearchCancelled):
            raise
        except NativeWatchdogTimeout as exc:
            if exc.quarantine:
                self._ladder.quarantine("native", exc)
            self._ladder.record_degrade("native", "python-oracle", exc)
        except Exception as exc:  # noqa: BLE001 — the ladder's native → python transition
            self._ladder.record_degrade("native", "python-oracle", exc)
        self.name = "python"
        return self._python_factory().check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)

    def _supervised(
        self, graph: TrustGraph, circuit: Optional[Circuit], scc: List[int], scope_to_scc: bool
    ) -> SccCheckResult:
        if self._watchdog_s <= 0:
            return self._native.check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)
        holder: Dict[str, object] = {}

        def work() -> None:
            try:
                holder["res"] = self._native.check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)
            except BaseException as exc:  # noqa: BLE001 — re-raised on the supervisor
                holder["exc"] = exc

        worker = threading.Thread(target=work, name="qi-native-watchdog", daemon=False)
        worker.start()
        deadline = time.monotonic() + self._watchdog_s
        grace_deadline: Optional[float] = None
        while worker.is_alive():
            if (self._outer_cancel is not None and self._outer_cancel.cancelled
                    and self._native_cancel is not None):
                self._native_cancel.cancel()  # the race decided elsewhere
            now = time.monotonic()
            if grace_deadline is None and now >= deadline:
                get_run_record().event("native.watchdog_cancel", deadline_s=self._watchdog_s, scc=len(scc))
                dump_flight_recorder("watchdog:native")
                log.warning("native call exceeded %.2fs watchdog deadline; tripping its cancel token",
                            self._watchdog_s)
                if self._native_cancel is not None:
                    self._native_cancel.cancel()
                grace_deadline = now + min(1.0, self._watchdog_s)
            elif grace_deadline is not None and now >= grace_deadline:
                raise NativeWatchdogTimeout(
                    f"native call ignored its cancel for {min(1.0, self._watchdog_s):.2f}s past the "
                    f"{self._watchdog_s:.2f}s deadline (|scc|={len(scc)})",
                    quarantine=True,
                )
            worker.join(WATCHDOG_POLL_S)
        exc = holder.get("exc")
        if exc is not None:
            if (isinstance(exc, SearchCancelled) and grace_deadline is not None
                    and not (self._outer_cancel is not None and self._outer_cancel.cancelled)):
                # Our trip unwound it, not the race's: a slow call.
                raise NativeWatchdogTimeout(
                    f"native call hit the {self._watchdog_s:.2f}s watchdog deadline and unwound "
                    f"on cancel (|scc|={len(scc)})",
                    quarantine=False,
                ) from exc
            raise exc  # type: ignore[misc]
        return holder["res"]  # type: ignore[return-value]


def calibration_for(device: torch.device) -> Calibration:
    """The router's constants for ``device``: the host-only CPU terms on the
    CPU; on CUDA the calibration measured on the live card's kind.  On any
    other card kind none of the card's numbers apply: the budget falls back
    to the host-CPU terms (the slowest sweep on record, so the most room for
    the oracle) and the pack gate stays closed."""
    if device.type == "cpu":
        return HOST_CPU
    kind = torch.cuda.get_device_name(device)
    cal = H100.for_kind(kind)
    if cal is not None:
        return cal
    return Calibration(
        kind=kind,
        sweep_rate=HOST_CPU.sweep_rate,
        sweep_overhead_warm_s=HOST_CPU.sweep_overhead_warm_s,
        sweep_overhead_cold_s=HOST_CPU.sweep_overhead_cold_s,
        oracle_seconds_per_call=dict(HOST_CPU.oracle_seconds_per_call),
        provenance={"sweep_rate": f"no calibration for {kind!r}: the host-only CPU terms"},
    )


class AutoBackend:
    name = "auto"

    def __init__(
        self,
        device: DeviceLike = None,
        race: bool = True,
        pack: Optional[bool] = None,
        cancel: Optional[CancelToken] = None,
        seed: Optional[int] = None,
        randomized: bool = False,
        checkpoint: Optional[SweepCheckpoint] = None,
        mesh: Optional[CandidateMesh] = None,
    ) -> None:
        # The device is resolved now: CUDA without a card raises here, as
        # resolve_device does, before any routing.  Under a mesh, its home.
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        # race=False (--no-race): the budgeted oracle alone, then the sweep
        # only after a burned budget.  Verdicts are the same either way.
        self.race = race
        # An external cancel token runs the sequential chain (the race mints
        # its own per-arm tokens, which cannot merge with an outer one).
        self.cancel = cancel
        if cancel is not None and race:
            self.race = False
        # The batch entry's lane packing: None packs only behind a measured
        # win on the live card kind, True forces it, False never packs.
        self.pack = pack
        # The host oracles' branching tie-break (the CLI's --seed/--randomized).
        self._oracle_options: Dict[str, object] = (
            {"seed": seed, "randomized": randomized} if (randomized or seed is not None) else {}
        )
        self._ladder = DegradationLadder()
        self._cal: Optional[Calibration] = None
        # The sweep's resume file (the CLI's --checkpoint); the frontier rung
        # reads the same path in its own format.
        self.checkpoint = checkpoint

    # ---- constants --------------------------------------------------------

    def calibration(self) -> Calibration:
        """The live device's constants, looked up once per router; a card of
        a kind they were not measured on records
        ``calibration.foreign_artifact_ignored``."""
        if self._cal is None:
            self._cal = calibration_for(self.device)
            if self._cal.kind not in (H100.kind, HOST_CPU.kind):
                get_run_record().event("calibration.foreign_artifact_ignored",
                                       artifact_device=H100.kind, live_device=self._cal.kind)
                log.info("router constants measured on %r ignored on %r", H100.kind, self._cal.kind)
        return self._cal

    def _sweep_limit(self) -> int:
        return SWEEP_LIMIT_CPU if self.device.type == "cpu" else SWEEP_LIMIT_CUDA

    def _frontier_region(self) -> Optional[Tuple[int, int]]:
        """The |scc| range the frontier rung takes, or None: a win region
        measured on the live device's kind, up to its largest measured
        winning size plus the headroom."""
        cal = self.calibration()
        win = cal.frontier_win_min_scc
        live = "cpu" if self.device.type == "cpu" else torch.cuda.get_device_name(self.device)
        if win is None or cal.kind != live:
            return None
        return win, (cal.frontier_win_max_scc or win) + FRONTIER_WIN_SCC_HEADROOM

    def _sweep_built(self) -> bool:
        from quorum_intersection_tpu_torch.kernels import build

        return build.is_built("sweep")

    def _estimated_sweep_seconds(self, s: int) -> float:
        """The sweep's cost on this router's own device: its first-solve
        overhead (warm where the kernels are built, else cold, which includes
        the nvcc build) plus the enumeration at the measured rate."""
        cal = self.calibration()
        space = float(1 << max(s - 1, 0))
        cold = self.device.type == "cuda" and not self._sweep_built()
        overhead = cal.sweep_overhead_cold_s if cold else cal.sweep_overhead_warm_s
        return overhead + space / cal.sweep_rate

    # ---- engines ----------------------------------------------------------

    def _sweep(self, cancel: Optional[CancelToken] = None, engine: Optional[str] = None) -> SearchBackend:
        from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend

        return GpuSweepBackend(cancel=cancel if cancel is not None else self.cancel, device=self.device,
                               engine=engine, checkpoint=self.checkpoint, mesh=self.mesh)

    def _bitset_hint(self, graph: TrustGraph, scc: List[int]) -> Optional[str]:
        """``"bitset"`` where the bitset engine's win region measured on the
        live device's kind covers this SCC, else None (the sweep's own
        default applies).  An explicit ``QI_SWEEP_ENGINE`` short-circuits it
        (the ctor argument this feeds would override the variable).  The
        region extends up the |scc| axis only, never past the densest
        measured win."""
        if qi_env("QI_SWEEP_ENGINE").strip():
            return None
        cal = self.calibration()
        win, dmax = cal.bitset_win_min_scc, cal.bitset_win_max_density
        if win is None or dmax is None or len(scc) < win:
            return None
        live = "cpu" if self.device.type == "cpu" else torch.cuda.get_device_name(self.device)
        if cal.kind != live:
            return None
        density = scc_qset_density(graph, scc)
        if density > dmax:
            return None
        get_run_record().event(
            "route.encoding", engine="bitset", scc=len(scc), density=round(density, 4),
            reason=f"measured win region: |scc| >= {win}, qset density <= {dmax:.4g} on {cal.kind}",
        )
        return "bitset"

    def _hinted_sweep(self, graph: TrustGraph, scc: List[int],
                      cancel: Optional[CancelToken] = None) -> SearchBackend:
        """The sweep for one SCC, with the bitset hint where it applies."""
        hint = self._bitset_hint(graph, scc)
        return self._sweep(cancel=cancel) if hint is None else self._sweep(cancel=cancel, engine=hint)

    def _has_recorded_progress(self, scc: List[int]) -> bool:
        """Whether the attached checkpoint holds progress plausibly of this
        problem (the backends check the fingerprint before resuming)."""
        if self.checkpoint is None:
            return False
        return self.checkpoint.has_progress(1 << max(len(scc) - 1, 0))

    def _cpu_oracle(
        self,
        budget_s: Optional[float] = None,
        cancel: Optional[CancelToken] = None,
    ) -> SearchBackend:
        """The host rungs: the native oracle (watchdog-supervised,
        quarantinable), degrading to the Python oracle.  ``budget_s`` sizes a
        B&B call budget per engine speed; ``cancel`` is the token the search
        polls."""
        spc = self.calibration().oracle_seconds_per_call

        def python_oracle() -> SearchBackend:
            from quorum_intersection_tpu_torch.backends.python_oracle import PythonOracleBackend

            options = dict(self._oracle_options)
            if budget_s is not None:
                options["budget_calls"] = max(int(budget_s / spc["python"]), MIN_ORACLE_BUDGET)
            if cancel is not None:
                options["cancel"] = cancel
            return PythonOracleBackend(**options)

        watchdog_s = _watchdog_seconds()

        def native_oracle() -> SearchBackend:
            from quorum_intersection_tpu_torch.backends.cpp import CppOracleBackend

            options = dict(self._oracle_options)
            if budget_s is not None:
                options["budget_calls"] = max(int(budget_s / spc["cpp"]), MIN_ORACLE_BUDGET)
            # Under a watchdog the native search polls the watchdog's own
            # token and the race's is forwarded inward.
            native_cancel = CancelToken() if watchdog_s > 0 else cancel
            if native_cancel is not None:
                options["cancel"] = native_cancel
            backend = CppOracleBackend(**options)
            backend.ensure_built()
            return _WatchedNativeOracle(
                self._ladder, backend, python_oracle,
                outer_cancel=cancel, native_cancel=native_cancel, watchdog_s=watchdog_s,
            )

        try:
            return self._ladder.attempt("native", native_oracle, fall_to="python-oracle")
        except RungFailed as fail:
            log.info("native C++ oracle unavailable (%s); using Python oracle", fail.cause)
        return python_oracle()

    def _budgeted_oracle(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        scope_to_scc: bool,
        budget_s: float,
    ) -> Optional[SccCheckResult]:
        """Sequential oracle-first attempt: a result, or None for a burned
        budget (the sweep takes over)."""
        backend = self._cpu_oracle(budget_s=budget_s, cancel=self.cancel)
        try:
            log.debug("auto: oracle-first (%s) for |scc|=%d, budget ~%.1fs of calls",
                      backend.name, len(scc), budget_s)
            return backend.check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)
        except OracleBudgetExceeded as exc:
            get_run_record().add("oracle.budget_burns")
            log.info("oracle budget burned (%s); switching to the exhaustive sweep", exc)
            return None

    # ---- the race ---------------------------------------------------------

    def _race(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        scope_to_scc: bool,
        budget_s: float,
    ) -> SccCheckResult:
        """Budgeted host oracle against the sweep on a worker thread; the
        first verdict wins and the loser is cancelled.  When both finish,
        the oracle's result is taken, so witnesses equal the sequential
        chain's whenever the oracle answers under budget.  A failure of the
        sweep arm is raised, never replaced by the oracle's answer."""
        with get_run_record().span("race", scc=len(scc)) as race_span:
            return self._race_inner(graph, circuit, scc, scope_to_scc, budget_s, race_span)

    def _race_inner(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        scope_to_scc: bool,
        budget_s: float,
        race_span: Span,
    ) -> SccCheckResult:
        rec = get_run_record()
        oracle_cancel = CancelToken()
        sweep_cancel = CancelToken()
        outcome: Dict[str, object] = {}
        t0 = time.monotonic()

        def sweep_worker() -> None:
            with rec.span("race.sweep", parent_id=race_span.span_id, scc=len(scc)) as arm_span:
                self._sweep_arm(arm_span, graph, circuit, scc, scope_to_scc,
                                oracle_cancel, sweep_cancel, outcome, t0)

        # Non-daemon, explicitly (daemonness is inherited from the spawning
        # thread): see RACE_LOSER_JOIN_S.
        worker = threading.Thread(target=sweep_worker, name="qi-race-sweep", daemon=False)
        worker.start()

        oracle_res = None
        oracle_state = "verdict"
        try:
            backend = self._cpu_oracle(budget_s=budget_s, cancel=oracle_cancel)
            log.debug("auto: racing %s (budget ~%.1fs of calls) against the sweep for |scc|=%d",
                      backend.name, budget_s, len(scc))
            t_oracle = time.monotonic()
            with rec.span("race.oracle", budget_s=round(budget_s, 3)) as ora_span:
                try:
                    oracle_res = backend.check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)
                except OracleBudgetExceeded as exc:
                    oracle_state = "budget_exceeded"
                    rec.add("oracle.budget_burns")
                    log.info("race: oracle budget burned (%s); awaiting the sweep", exc)
                except SearchCancelled:
                    oracle_state = "cancelled"
                ora_span.set(outcome=oracle_state)
        except BaseException:
            sweep_cancel.cancel()
            raise
        oracle_seconds = time.monotonic() - t_oracle
        _race_sync("oracle.returned")

        def race_stats(winner: str, joined: bool, loser_join_s: Optional[float] = None,
                       winner_wait_s: Optional[float] = None) -> dict:
            rs: Dict[str, object] = {
                "winner": winner,
                "budget_s": round(budget_s, 3),
                "oracle_seconds": round(oracle_seconds, 4),
                "oracle_outcome": oracle_state,
                "loser_joined": joined,
            }
            if loser_join_s is not None:
                rs["loser_join_seconds"] = round(loser_join_s, 4)
            if winner_wait_s is not None:
                rs["winner_wait_seconds"] = round(winner_wait_s, 4)
            if "sweep_seconds" in outcome:
                rs["sweep_seconds"] = round(outcome["sweep_seconds"], 4)  # type: ignore[arg-type]
            if "sweep_error" in outcome:
                rs["sweep_error"] = repr(outcome["sweep_error"])
            race_span.set(**rs)
            rec.event("race", **rs)
            if loser_join_s is not None:
                rec.gauge("race.loser_join_seconds", round(loser_join_s, 4))
            return rs

        def raise_sweep_error(winner: str, joined: bool, **kw) -> None:
            # The card's failure propagates whoever won: no degrade.
            if "sweep_error" in outcome:
                race_stats(winner, joined, **kw)
                raise outcome["sweep_error"]  # type: ignore[misc]

        if oracle_res is not None:
            sweep_cancel.cancel()
            t_join = time.monotonic()
            worker.join(timeout=min(RACE_LOSER_JOIN_S, max(RACE_LOSER_JOIN_MIN_S, 2.0 * oracle_seconds)))
            loser_join_s = time.monotonic() - t_join
            joined = not worker.is_alive()
            if not joined:
                log.info("race: cancelled sweep still unwinding (finishes in the background)")
            elif self.checkpoint is not None:
                # What the losing sweep recorded before the cancel landed:
                # left on disk it would skip the oracle on every later run.
                # Joined only; an unjoined worker clears it itself.
                self.checkpoint.clear()
            raise_sweep_error("oracle", joined, loser_join_s=loser_join_s)
            oracle_res.stats["race"] = race_stats("oracle", joined, loser_join_s)
            return oracle_res

        # Budget burned, or the sweep won and cancelled the oracle: the sweep
        # is the verdict path now.
        t_join = time.monotonic()
        worker.join()
        winner_wait_s = time.monotonic() - t_join
        raise_sweep_error("none", True, winner_wait_s=winner_wait_s)
        res = outcome.get("sweep_result")
        if res is None:
            race_stats("none", True, winner_wait_s=winner_wait_s)
            raise RuntimeError(f"race ended without a verdict (|scc|={len(scc)}, oracle {oracle_state})")
        res.stats["race"] = race_stats("sweep", True, winner_wait_s=winner_wait_s)  # type: ignore[union-attr]
        return res  # type: ignore[return-value]

    def _sweep_arm(
        self,
        arm_span: Span,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        scope_to_scc: bool,
        oracle_cancel: CancelToken,
        sweep_cancel: CancelToken,
        outcome: Dict[str, object],
        t0: float,
    ) -> None:
        """The worker thread's body.  The sweep backend checks the token
        before its host set-up, before the kernel build, before the CUDA
        context and before each launch, so an arm that has lost starts no
        further work; it sets its CUDA device on this thread itself."""
        try:
            _race_sync("sweep.started")
            if sweep_cancel.cancelled:
                arm_span.set(outcome="cancelled")
                return
            res = self._hinted_sweep(graph, scc, cancel=sweep_cancel).check_scc(
                graph, circuit, scc, scope_to_scc=scope_to_scc)
            outcome["sweep_result"] = res
            outcome["sweep_seconds"] = time.monotonic() - t0
            arm_span.set(outcome="verdict")
            _race_sync("sweep.verdict")
            oracle_cancel.cancel()
        except SearchCancelled:
            outcome["sweep_cancelled"] = True
            arm_span.set(outcome="cancelled")
            _race_sync("sweep.unwound")
            if self.checkpoint is not None:
                # From this thread, after the sweep raised: no record lands later.
                self.checkpoint.clear()
        except BaseException as exc:  # noqa: BLE001 — handed to the race, which raises it
            outcome["sweep_error"] = exc
            arm_span.set(outcome="error")
            oracle_cancel.cancel()

    # ---- routing ----------------------------------------------------------

    def check_scc(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        *,
        scope_to_scc: bool = False,
        _budget_burned: bool = False,
    ) -> SccCheckResult:
        """Route one SCC (the ``route`` span, stamped with the engine that
        answered).  ``_budget_burned``: this SCC's oracle budget already
        burned in the batch entry, so the route goes straight to the sweep."""
        if self.cancel is not None and self.cancel.cancelled:
            raise SearchCancelled(f"auto router cancelled before routing (|scc|={len(scc)})")
        rec = get_run_record()
        with rec.span("route", scc=len(scc), race_enabled=self.race) as route_span:
            res = self._route(graph, circuit, scc, scope_to_scc=scope_to_scc, budget_burned=_budget_burned)
            route_span.set(backend=res.stats.get("backend", "?"))
            rec.gauge("ladder.rung", res.stats.get("backend", "?"))
            return res

    def _route(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        *,
        scope_to_scc: bool = False,
        budget_burned: bool = False,
    ) -> SccCheckResult:
        rec = get_run_record()
        limit = self._sweep_limit()
        # Recorded progress resumes on the sweep directly: re-burning the
        # oracle's budget on every resume would tax the long runs.
        resumable = self._has_recorded_progress(scc)
        if len(scc) <= limit:
            if not resumable and not budget_burned:
                budget_s = self._estimated_sweep_seconds(len(scc))
                if self.race:
                    res = self._race(graph, circuit, scc, scope_to_scc, budget_s)
                else:
                    res = self._budgeted_oracle(graph, circuit, scc, scope_to_scc, budget_s)
                if res is not None:
                    rec.event(
                        "route.decision", engine=res.stats.get("backend", "?"), scc=len(scc),
                        reason=(f"race winner ({res.stats.get('race', {}).get('winner', '?')})" if self.race
                                else f"oracle finished under ~{budget_s:.1f}s budget"),
                    )
                    return res
            # The sweep rung: no degrade, no retry — its failure fails the solve.
            backend = self._hinted_sweep(graph, scc)
            rec.event("route.decision", engine="gpu-sweep", scc=len(scc),
                      reason="checkpoint has recorded progress" if resumable
                      else f"oracle budget burned; |scc| <= sweep limit {limit}")
            return backend.check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)
        region = self._frontier_region()
        in_region = region is not None and region[0] <= len(scc) <= region[1]
        if in_region:
            # The frontier rung: no degrade, no retry, as the sweep rung.
            from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
            from quorum_intersection_tpu_torch.utils.checkpoint import FrontierCheckpoint

            cal = self.calibration()
            ckpt = None if self.checkpoint is None else FrontierCheckpoint(self.checkpoint.path)
            frontier = GpuFrontierBackend(device=self.device, checkpoint=ckpt, mesh=self.mesh)
            rec.event("route.decision", engine="gpu-frontier", scc=len(scc),
                      reason=f"measured win region [{region[0]}, {region[1]}] on {cal.kind}",
                      provenance=cal.provenance.get("frontier"))
            return frontier.check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)
        if self.checkpoint is not None:
            # The host oracles keep no progress: say so, loudly.
            log.warning("checkpoint not honored: |scc|=%d routed to a host oracle "
                        "(no progress will be recorded)", len(scc))
        backend = self._cpu_oracle(cancel=self.cancel) if self.cancel is not None else self._cpu_oracle()
        reason = f"host oracle (|scc| above the sweep limit {limit})"
        rec.event("route.decision", engine=backend.name, scc=len(scc), reason=reason)
        return backend.check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)

    # ---- batch entry ------------------------------------------------------

    def _pack_bound(self, sizes: List[int]) -> Optional[int]:
        """Largest |scc| the batch entry may fuse into lane packs, or None
        when packing must not engage: ``pack=True`` forces it up to the
        decode ceiling, ``pack=None`` engages only behind the pack win
        measured on the live card kind (plus one grid step), with at least
        two jobs that could share a pack.  Never with a checkpoint (packs
        keep none) or a mesh (the sharded sweep packs nothing)."""
        if self.pack is False or self.checkpoint is not None or self.mesh is not None:
            return None
        if self.pack is True:
            return SWEEP_DECODE_CEILING
        win = self.calibration().pack_win_max_scc
        if win is None:
            return None
        bound = win + SWEEP_WIN_SCC_HEADROOM
        return bound if sum(1 for s in sizes if s <= bound) >= 2 else None

    def check_sccs(
        self,
        jobs: Sequence[Tuple[TrustGraph, Optional[Circuit], List[int]]],
        *,
        scope_to_scc: bool = False,
        cancels: Optional[Sequence[Optional[CancelToken]]] = None,
        origins: Optional[Sequence[str]] = None,
    ) -> List[SccCheckResult]:
        """Batch entry (``pipeline.check_many``): fuse sweep-sized jobs into
        lane packs where the pack gate allows, route the rest one by one
        through :meth:`check_scc`.  With ``pack=None`` each packable job first
        gets the budgeted oracle, and only the budget burners are packed;
        ``pack=True`` packs without the oracle.  A failure of the packed
        sweep propagates: there is no fall back to the per-problem route."""
        jobs = list(jobs)
        results: List[Optional[SccCheckResult]] = [None] * len(jobs)
        rec = get_run_record()
        packable: List[int] = []
        burned: Set[int] = set()
        pack_cap = self._pack_bound([len(scc) for _, _, scc in jobs])
        if pack_cap is not None:
            cap = min(self._sweep_limit(), pack_cap)
            for i, (graph, circuit, scc) in enumerate(jobs):
                if len(scc) > cap or len(scc) - 1 > LO_BITS:
                    continue
                if self.pack is None:
                    res = self._budgeted_oracle(graph, circuit, scc, scope_to_scc,
                                                self._estimated_sweep_seconds(len(scc)))
                    if res is not None:
                        results[i] = res
                        continue
                    burned.add(i)
                packable.append(i)
        if packable:
            # One engine for the whole pack: bitset only where every packed
            # job lies in the bitset win region.
            hint = None
            if all(self._bitset_hint(jobs[i][0], jobs[i][2]) == "bitset" for i in packable):
                hint = "bitset"
            sweep = self._sweep() if hint is None else self._sweep(engine=hint)
            rec.event("route.decision", engine="gpu-sweep", scc=max(len(jobs[i][2]) for i in packable),
                      reason=f"lane-packed batch of {len(packable)} jobs")
            packed = sweep.check_sccs(
                [jobs[i] for i in packable], scope_to_scc=scope_to_scc,
                cancels=[cancels[i] for i in packable] if cancels is not None else None,
                origins=[origins[i] for i in packable] if origins is not None else None,
            )
            for i, res in zip(packable, packed):
                results[i] = res
        for i, (graph, circuit, scc) in enumerate(jobs):
            if results[i] is not None:
                continue
            tok = cancels[i] if cancels is not None else None
            if tok is not None and tok.cancelled:
                results[i] = cancelled_result(self.name, scc)
                continue
            results[i] = self.check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc,
                                        _budget_burned=i in burned)
        return [res for res in results if res is not None]

