"""The port's run record, its sinks and the CLI's observability flags on the
CPU, against the JAX package's:

- the record and sink cases of ``tests/test_telemetry.py``: span nesting,
  cross-thread parents (and the Chrome sink's per-thread tracks), counter
  atomicity, the JSONL round trip, streaming before finish, the Prometheus
  textfile, the env sinks, the ``--timing`` legacy lines, and
  ``tools/metrics_report.py`` rendering the port's stream;
- the sweep's telemetry against the JAX ``tpu`` sweep on the same inputs: the
  ``cert.windows_enumerated``, ``sweep.candidates_checked``,
  ``sweep.blocks_pruned`` and ``cert.windows_pruned_guard`` totals, and every
  counter and event name the port emits on a solve is one the JAX package
  emits for the same solve;
- the env registry and the logging module against the JAX package's.

Counts, names and lines compare exactly.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest
import torch

from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu.pipeline import check_many as jax_check_many
from quorum_intersection_tpu.pipeline import solve as jax_solve
from quorum_intersection_tpu.utils import env as jax_env
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.pipeline import check_many, solve
from quorum_intersection_tpu_torch.utils import env, telemetry
from quorum_intersection_tpu_torch.utils.telemetry import (
    ChromeTraceSink,
    Histogram,
    JsonlSink,
    PromFileSink,
    RunRecord,
    TraceContext,
)

from _torch_cases import fixture_data

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
CLI = [sys.executable, "-m", "quorum_intersection_tpu_torch", "--device", "cpu"]


def _env(**extra):
    out = dict(os.environ)
    out.update(extra)
    return out


def load_trace(path):
    """A trace-event file as Perfetto loads it: the array is left open."""
    text = pathlib.Path(path).read_text().strip()
    if text.endswith(","):
        text = text[:-1]
    if not text.endswith("]"):
        text += "]"
    return json.loads(text)


@pytest.fixture
def records():
    """Fresh process-wide records in both packages."""
    rec = telemetry.reset_run_record()
    jax_rec = jax_telemetry.reset_run_record()
    yield rec, jax_rec
    telemetry.reset_run_record()
    jax_telemetry.reset_run_record()


class TestRunRecord:
    def test_span_nesting_parent_ids(self):
        rec = RunRecord()
        with rec.span("outer") as outer:
            with rec.span("inner") as inner:
                with rec.span("leaf") as leaf:
                    pass
        assert outer.parent_id is None
        assert inner.parent_id == outer.span_id
        assert leaf.parent_id == inner.span_id
        assert [sp.name for sp in rec.spans] == ["leaf", "inner", "outer"]
        assert all(sp.seconds is not None and sp.seconds >= 0 for sp in rec.spans)
        assert {sp.trace_id for sp in rec.spans} == {rec.trace_id}

    def test_worker_thread_spans_are_roots_unless_parented(self):
        rec = RunRecord()
        seen = {}

        def worker(parent=None):
            with rec.span("worker", parent_id=parent) as sp:
                seen[parent] = (sp.parent_id, sp.tid)

        with rec.span("race") as race:
            for parent in (None, race.span_id):
                t = threading.Thread(target=worker, args=(parent,))
                t.start()
                t.join()
        assert seen[None][0] is None
        assert seen[race.span_id][0] == race.span_id
        assert seen[None][1] != race.tid

    def test_counter_atomicity_two_threads(self):
        rec = RunRecord()
        n, per = 4, 20_000

        def hammer():
            for _ in range(per):
                rec.add("native.bnb_calls")
                rec.add("sweep.candidates_checked", 2)

        threads = [threading.Thread(target=hammer) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert rec.counters["native.bnb_calls"] == n * per
        assert rec.counters["sweep.candidates_checked"] == 2 * n * per

    def test_summary_lines_equal_the_jax_records(self):
        lines = []
        for cls in (RunRecord, jax_telemetry.RunRecord):
            rec = cls()
            rec.add("native.bnb_calls", 7)
            rec.gauge("sweep.candidates_per_sec", 123.4)
            lines.append([ln for ln in rec.summary_lines() if "compile_cache" not in ln])
        assert lines[0] == lines[1] == ["[telemetry] counter native.bnb_calls: 7",
                                        "[telemetry] gauge sweep.candidates_per_sec: 123.4"]

    def test_finish_idempotent_and_event_cap(self, monkeypatch):
        monkeypatch.setattr(telemetry, "MAX_EVENTS", 2)
        rec = RunRecord()
        for i in range(3):
            rec.event("e", x=i)
        rec.finish()
        rec.finish()
        assert [ev["attrs"] for ev in rec.events] == [{"x": 0}, {"x": 1}]
        assert rec.events_truncated() and rec.events_since(1)[0]["attrs"] == {"x": 1}

    def test_histogram_and_percentile_equal_the_jax_ones(self):
        samples = [0.1, 0.3, 3.0, 7.5, 40.0, 900.0, 1e6]
        port, jax_h = Histogram("h"), jax_telemetry.Histogram("h", window=0)
        for v in samples:
            port.observe(v)
            jax_h.observe(v)
        assert port.snapshot() == jax_h.snapshot()
        assert port.to_line() == jax_h.to_line()
        assert telemetry.percentile(sorted(samples), 99) == jax_telemetry.percentile(sorted(samples), 99)

    def test_trace_context_round_trip_and_adoption(self, monkeypatch):
        ctx = TraceContext("abcd1234", span_id=7, pid=4711)
        assert TraceContext.from_env(ctx.to_env()) == ctx
        assert TraceContext.from_env("") is None
        assert TraceContext.from_env("t:x:y") == TraceContext("t")
        monkeypatch.setenv("QI_TRACE_CONTEXT", "cafe0123deadbeef:42:1000")
        rec = RunRecord()
        assert rec.trace_id == "cafe0123deadbeef" and rec.parent_ctx == TraceContext("cafe0123deadbeef", 42, 1000)


class TestSinks:
    def test_jsonl_sink_round_trip(self, tmp_path):
        path = tmp_path / "m.jsonl"
        rec = RunRecord()
        rec.add_sink(JsonlSink(str(path)))
        with rec.span("phase.parse"):
            rec.event("race", winner="oracle")
        rec.add("native.bnb_calls", 3)
        rec.gauge("g", 1.5)
        rec.histogram("pulse.e2e_ms").observe(2.0)
        rec.finish()
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert lines[0]["kind"] == "meta" and lines[0]["schema"] == "qi-telemetry/1"
        ev = next(ln for ln in lines if ln["kind"] == "event")
        sp = next(ln for ln in lines if ln["kind"] == "span")
        assert ev["name"] == "race" and ev["attrs"]["winner"] == "oracle"
        assert ev["span_id"] == sp["span_id"]
        assert sp["name"] == "phase.parse" and sp["seconds"] >= 0
        assert {ln["name"]: ln["value"] for ln in lines if ln["kind"] == "counter"} == {"native.bnb_calls": 3}
        assert {ln["name"]: ln["value"] for ln in lines if ln["kind"] == "gauge"} == {"g": 1.5}
        assert next(ln for ln in lines if ln["kind"] == "histogram")["count"] == 1

    def test_jsonl_sink_streams_before_finish(self, tmp_path):
        path = tmp_path / "m.jsonl"
        rec = RunRecord()
        rec.add_sink(JsonlSink(str(path)))
        with rec.span("phase.scc"):
            pass
        assert any(json.loads(ln)["kind"] == "span" for ln in path.read_text().splitlines())

    def test_jsonl_sink_coerces_unserializable_attrs(self, tmp_path):
        path = tmp_path / "m.jsonl"
        rec = RunRecord()
        rec.add_sink(JsonlSink(str(path)))
        rec.event("weird", obj=object(), path=tmp_path)
        rec.finish()
        ev = next(json.loads(ln) for ln in path.read_text().splitlines() if json.loads(ln)["kind"] == "event")
        assert isinstance(ev["attrs"]["obj"], str)

    def test_prom_textfile_equals_the_jax_encoding(self, tmp_path):
        texts = []
        for cls, sink_cls in ((RunRecord, PromFileSink), (jax_telemetry.RunRecord, jax_telemetry.PromFileSink)):
            path = tmp_path / f"{cls.__module__}.prom"
            rec = cls()
            rec.add_sink(sink_cls(str(path)))
            rec.add("sweep.candidates_checked", 42)
            rec.gauge("sweep.candidates_per_sec", 99.5)
            rec.gauge("ladder.rung", "gpu-sweep")  # not numeric: left out
            rec.finish()
            texts.append([ln for ln in path.read_text().splitlines() if "compile_cache" not in ln])
        assert texts[0] == texts[1]
        assert "qi_sweep_candidates_checked 42" in texts[0]

    def test_chrome_trace_sink_puts_worker_spans_on_their_own_track(self, tmp_path):
        path = tmp_path / "t.json"
        rec = RunRecord()
        rec.add_sink(ChromeTraceSink(str(path)))

        def worker():
            with rec.span("race.sweep", parent_id=race.span_id):
                rec.event("sweep.window", candidates=8)

        with rec.span("race", scc=5) as race:
            rec.event("mark", x=1)
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        rec.finish()
        events = load_trace(path)
        assert {"M", "X", "i"} <= {e["ph"] for e in events}
        x = {e["name"]: e for e in events if e["ph"] == "X"}
        assert x["race"]["args"] == {"scc": 5} and x["race"]["dur"] >= 1.0
        marks = {e["name"]: e for e in events if e["ph"] == "i"}
        assert x["race"]["tid"] != x["race.sweep"]["tid"] == marks["sweep.window"]["tid"]
        assert marks["mark"]["tid"] == x["race"]["tid"]

    def test_env_sinks_in_a_cli_process(self, tmp_path):
        stream, prom, trace = tmp_path / "env.jsonl", tmp_path / "env.prom", tmp_path / "env.json"
        proc = subprocess.run(CLI + ["--backend", "python"], input=json.dumps(synth.majority_fbas(3)),
                              capture_output=True, text=True, timeout=120, cwd=ROOT,
                              env=_env(QI_METRICS_JSON=str(stream), QI_METRICS_PROM=str(prom),
                                       QI_TRACE_OUT=str(trace)))
        assert proc.returncode == 0, proc.stderr
        lines = [json.loads(ln) for ln in stream.read_text().splitlines()]
        assert {ln["kind"] for ln in lines} >= {"meta", "span", "counter"}
        assert "# TYPE qi_" in prom.read_text()
        assert any(e["ph"] == "X" and e["name"] == "phase.search" for e in load_trace(trace))


class TestCli:
    def test_timing_legacy_lines_first_then_telemetry(self):
        proc = subprocess.run(CLI + ["--timing", "--backend", "python"], input=json.dumps(synth.majority_fbas(3)),
                              capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert proc.returncode == 0 and proc.stdout == "true\n", proc.stderr
        err = proc.stderr.splitlines()
        legacy = [ln for ln in err if ln.startswith(("[timing]", "[stats]"))]
        telem = [ln for ln in err if ln.startswith("[telemetry]")]
        assert legacy and telem
        assert max(err.index(ln) for ln in legacy) < err.index(telem[0])
        assert any(ln.startswith("[timing] search: ") for ln in legacy)

    def test_all_flags_at_once_and_metrics_report_renders(self, tmp_path):
        files = {k: tmp_path / f"a.{k}" for k in ("jsonl", "prom", "json", "cert")}
        proc = subprocess.run(
            CLI + ["--backend", "gpu-sweep", "--timing", "--metrics-json", str(files["jsonl"]),
                   "--metrics-prom", str(files["prom"]), "--trace-out", str(files["json"]),
                   "--cert-out", str(files["cert"])],
            input=json.dumps(synth.majority_fbas(9)), capture_output=True, text=True, timeout=180, cwd=ROOT,
        )
        assert proc.returncode == 0 and proc.stdout == "true\n", proc.stderr
        lines = [json.loads(ln) for ln in files["jsonl"].read_text().splitlines()]
        windows = [ln for ln in lines if ln["kind"] == "event" and ln["name"] == "sweep.window"]
        counters = {ln["name"]: ln["value"] for ln in lines if ln["kind"] == "counter"}
        ledger = json.loads(files["cert"].read_text())["coverage"]["sccs"][0]
        assert windows and sum(w["attrs"]["candidates"] for w in windows) == counters["cert.windows_enumerated"]
        assert counters["cert.windows_enumerated"] == ledger["windows_enumerated"] == ledger["window_space"]
        assert "qi_cert_windows_enumerated " in files["prom"].read_text()
        assert any(e["ph"] == "X" and e["name"] == "sweep.drive" for e in load_trace(files["json"]))
        report = subprocess.run([sys.executable, str(ROOT / "tools" / "metrics_report.py"), str(files["jsonl"]),
                                 "--windows", "4"], capture_output=True, text=True, timeout=120)
        assert report.returncode == 0, report.stderr
        assert "per-phase spans" in report.stdout and "phase.search" in report.stdout
        assert "sweep windows" in report.stdout

    def test_flags_with_pagerank_and_an_analysis_mode(self, tmp_path):
        for flags in (["-p"], ["--top-tier"]):
            stream = tmp_path / f"{flags[0]}.jsonl"
            proc = subprocess.run(CLI + flags + ["--timing", "--metrics-json", str(stream)],
                                  input=json.dumps(synth.majority_fbas(5)),
                                  capture_output=True, text=True, timeout=120, cwd=ROOT)
            assert proc.returncode == 0, proc.stderr
            kinds = [json.loads(ln)["kind"] for ln in stream.read_text().splitlines()]
            assert kinds[0] == "meta" and "span" in kinds

    def test_trace_flag_and_log_env(self):
        data = json.dumps(synth.majority_fbas(3))
        proc = subprocess.run(CLI + ["--backend", "python", "-t"], input=data, capture_output=True,
                              text=True, timeout=120, cwd=ROOT)
        assert proc.returncode == 0 and "[DEBUG]" in proc.stderr
        proc = subprocess.run(CLI + ["--backend", "python"], input=data, capture_output=True, text=True,
                              timeout=120, cwd=ROOT, env=_env(QI_LOG_JSON="1", QI_LOG_LEVEL="DEBUG"))
        assert proc.returncode == 0
        logs = [json.loads(ln) for ln in proc.stderr.splitlines() if ln.startswith("{")]
        assert logs and {"kind", "level", "logger", "msg", "t_wall"} <= set(logs[0])


@pytest.mark.parametrize("backend", ["auto", "gpu-sweep", "gpu-frontier", "cpp", "python"])
def test_flags_with_every_backend(backend, tmp_path, monkeypatch, capsys, records):
    """The four flags on every backend, in process: the verdict line, the
    ``[timing]`` lines before the summary, and all three files written."""
    from quorum_intersection_tpu_torch import cli

    files = {k: tmp_path / f"m.{k}" for k in ("jsonl", "prom", "json")}
    monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps(fixture_data("nested_correct.json"))))
    code = cli.main(["--device", "cpu", "--backend", backend, "--timing", "--metrics-json", str(files["jsonl"]),
                     "--metrics-prom", str(files["prom"]), "--trace-out", str(files["json"])])
    out, err = capsys.readouterr()
    assert (code, out) == (0, "true\n")
    assert err.index("[timing] search: ") < err.index("[telemetry] span phase.search: ")
    lines = [json.loads(ln) for ln in files["jsonl"].read_text().splitlines()]
    assert lines[0]["kind"] == "meta" and any(ln["kind"] == "counter" for ln in lines)
    assert "qi_cert_certificates 1" in files["prom"].read_text()
    assert any(e["ph"] == "X" and e["name"] == "phase.search" for e in load_trace(files["json"]))


class TestPipeline:
    def test_solve_emits_phase_spans(self, records):
        rec, _ = records
        res = solve(synth.majority_fbas(5), backend="python")
        assert res.intersects is True
        names = [sp.name for sp in rec.spans]
        for phase in ("phase.parse", "phase.graph", "phase.scc", "phase.scc_scan", "phase.search"):
            assert phase in names, names
        assert "search" in res.timers

    def test_check_many_nests_packs_under_the_batch_span(self, records):
        rec, _ = records
        res = check_many([synth.majority_fbas(7), synth.majority_fbas(9)], backend=GpuSweepBackend(device="cpu"))
        assert [r.intersects for r in res] == [True, True]
        spans = {sp.name: sp for sp in rec.spans}
        assert spans["sweep.pack"].parent_id == spans["pipeline.check_many"].span_id
        assert rec.gauges["sweep.packs_in_flight"] == 0


# The sweep against the JAX tpu sweep on the same inputs: (name, data,
# GpuSweepBackend options / TpuSweepBackend options).
SWEEP_CASES = {
    "majority9": (lambda: synth.majority_fbas(9), {}),
    "majority9-broken": (lambda: synth.majority_fbas(9, broken=True), {}),
    "nested_correct": (lambda: fixture_data("nested_correct.json"), {}),
    "ndc6-pruned": (lambda: synth.near_disjoint_cores(6, 1), {"prune": True}),
    "ndc6-broken-pruned": (lambda: synth.near_disjoint_cores(6, 1, broken=True), {"prune": True}),
    "nested_correct-bitset": (lambda: fixture_data("nested_correct.json"), {"engine": "bitset"}),
}
PARITY_COUNTERS = ("cert.windows_enumerated", "sweep.candidates_checked", "sweep.blocks_pruned",
                   "cert.windows_pruned_guard")


def _names(rec):
    counters = {k for k, v in rec.counters.items()}
    events = {ev["name"] for ev in rec.events}
    return counters, events


@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_sweep_telemetry_equals_the_jax_sweeps(case, records):
    rec, jax_rec = records
    make, options = SWEEP_CASES[case]
    res = solve(make(), backend=GpuSweepBackend(device="cpu", **options))
    want = jax_solve(make(), backend=TpuSweepBackend(**options))
    assert res.intersects is want.intersects
    assert res.stats.get("hit_index") == want.stats.get("hit_index")
    for name in PARITY_COUNTERS:
        assert rec.counters.get(name, 0) == jax_rec.counters.get(name, 0), name
    counters, events = _names(rec)
    jax_counters, jax_events = _names(jax_rec)
    assert counters <= jax_counters and events <= jax_events, (counters - jax_counters, events - jax_events)
    assert "sweep.window" in events
    windows = [ev for ev in rec.events if ev["name"] == "sweep.window"]
    jax_windows = [ev for ev in jax_rec.events if ev["name"] == "sweep.window"]
    keys = ("start", "candidates", "steps_per_call", "done", "total")
    assert [[w["attrs"][k] for k in keys] for w in windows] == [[w["attrs"][k] for k in keys] for w in jax_windows]
    if options.get("prune"):
        assert "sweep.pruned" in events
        pruned = next(ev for ev in rec.events if ev["name"] == "sweep.pruned")["attrs"]
        jax_pruned = next(ev for ev in jax_rec.events if ev["name"] == "sweep.pruned")["attrs"]
        assert pruned == jax_pruned
        assert rec.gauges["sweep.prune_ratio"] == jax_rec.gauges["sweep.prune_ratio"]


@pytest.mark.parametrize("prune", [False, True])
def test_packed_sweep_telemetry_equals_the_jax_sweeps(prune, records):
    rec, jax_rec = records

    def sources():
        return [synth.majority_fbas(7), synth.majority_fbas(9, broken=True), synth.near_disjoint_cores(6, 1),
                fixture_data("nested_correct.json")]

    res = check_many(sources(), backend=GpuSweepBackend(device="cpu", prune=prune))
    want = jax_check_many(sources(), backend=TpuSweepBackend(prune=prune))
    assert [r.intersects for r in res] == [r.intersects for r in want]
    assert [r.stats.get("hit_index") for r in res] == [r.stats.get("hit_index") for r in want]
    for name in PARITY_COUNTERS:
        assert rec.counters.get(name, 0) == jax_rec.counters.get(name, 0), name
    assert rec.counters["cert.windows_enumerated"] == sum(r.stats["cert"]["windows_enumerated"] for r in res)
    counters, events = _names(rec)
    jax_counters, jax_events = _names(jax_rec)
    assert counters <= jax_counters and events <= jax_events, (counters - jax_counters, events - jax_events)
    assert "sweep.pack" in {sp.name for sp in rec.spans} and rec.gauges["sweep.packs_in_flight"] == 0


def test_env_registry_is_the_jax_packages():
    port = {v.name: v.default for v in env.registry()}
    jax_reg = {v.name: v.default for v in jax_env.registry()}
    assert port == {name: jax_reg[name] for name in port}
    assert {"QI_SWEEP_ENGINE", "QI_SWEEP_PRUNE", "QI_SWEEP_ORDER", "QI_NATIVE_WATCHDOG_S",
            "QI_FRONTIER_CKPT_INTERVAL_S", "QI_METRICS_JSON", "QI_METRICS_PROM", "QI_TRACE_OUT",
            "QI_TRACE_CONTEXT", "QI_FAULTS", "QI_FLIGHT_RECORDER", "QI_LOG_LEVEL", "QI_LOG_JSON",
            "QI_QUERY_WHATIF_LIMIT", "QI_DELTA_CACHE_MAX", "QI_FLEET_STORE_MAX_MB",
            "QI_SERVE_BATCH_MAX", "QI_SERVE_QUEUE_DEPTH", "QI_SERVE_CACHE_MAX", "QI_SERVE_DEADLINE_S",
            "QI_SERVE_JOURNAL", "QI_SERVE_FUSE_WINDOW_MS", "QI_SERVE_BIND", "QI_PULSE_SLOW_MS",
            "QI_COST_TENANTS_MAX", "QI_SLO", "QI_SLO_FAST_S", "QI_SLO_SLOW_S", "QI_METRICS_PORT",
            "QI_FLEET_STORE_DIR", "QI_FLEET_WORKERS", "QI_FLEET_VNODES", "QI_FLEET_PROBE_INTERVAL_S",
            "QI_FLEET_PROBE_FAILS", "QI_FLEET_RESPAWN_MAX", "QI_FLEET_TOKEN", "QI_FLEET_LEASE_S",
            "QI_FLEET_SCALE_INTERVAL_S", "QI_FLEET_SCALE_UP_MS", "QI_FLEET_SCALE_DOWN_MS", "QI_FLEET_SCALE_MIN",
            "QI_FLEET_SCALE_MAX", "QI_PULSE_AGG", "QI_PULSE_BUCKETS", "QI_NO_COMPILE_CACHE", "QI_SANITIZER",
            "QI_DIST_INIT_TIMEOUT_S"} == set(port)
    with pytest.raises(KeyError):
        env.qi_env("QI_NOT_A_KNOB")


@pytest.mark.parametrize("raw,want", [("2.5", 2.5), ("oops", 0.0), ("", 0.0)])
def test_env_reads_like_jax(raw, want, monkeypatch):
    monkeypatch.setenv("QI_NATIVE_WATCHDOG_S", raw)
    got = env.qi_env_float("QI_NATIVE_WATCHDOG_S", 0.0)
    assert got == want == jax_env.qi_env_float("QI_NATIVE_WATCHDOG_S", 0.0)
    monkeypatch.setenv("QI_QUERY_WHATIF_LIMIT", raw)
    assert env.qi_env_int("QI_QUERY_WHATIF_LIMIT", 512) == jax_env.qi_env_int("QI_QUERY_WHATIF_LIMIT", 512)
