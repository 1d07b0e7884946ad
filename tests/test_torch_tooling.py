"""The port's tooling utils: the profiler hook (``utils/profiling.py``, the
CLI's ``--profile-dir``), the build cache (``utils/compile_cache.py``,
``QI_NO_COMPILE_CACHE``), the build-seconds stat, and the histogram bucket
override (``QI_PULSE_BUCKETS``) against the JAX package's ``hist_bounds``.

On the CPU no kernel builds, so no timing ratio is asserted here; the
card's cold and warm builds are timed by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase ``tooling``.
"""

import io
import json

import pytest
import torch

from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends import cpp
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.pipeline import solve
from quorum_intersection_tpu_torch.utils import compile_cache, telemetry
from quorum_intersection_tpu_torch.utils.profiling import profile_trace, trace_file

from _torch_cases import FIXTURES, fixture_data

torch.set_num_threads(1)

PORT = FIXTURES.parent / "quorum_intersection_tpu_torch"


@pytest.fixture
def record():
    rec = telemetry.reset_run_record()
    yield rec
    telemetry.reset_run_record()


@pytest.fixture
def fresh_cache(monkeypatch):
    """A build cache that has counted nothing and made no private directory yet."""
    monkeypatch.setattr(compile_cache, "_counted", set())
    monkeypatch.setattr(compile_cache, "_announced", set())
    monkeypatch.setattr(compile_cache, "_private_root", None)


def test_profile_dir_writes_a_trace_joined_to_the_run_record(tmp_path, monkeypatch, capsys, record):
    prof, metrics = tmp_path / "prof", tmp_path / "m.jsonl"
    monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps(fixture_data("snapshot_broken.json"))))
    code = cli.main(["--device", "cpu", "--backend", "gpu-sweep", "--profile-dir", str(prof),
                     "--metrics-json", str(metrics)])
    assert (code, capsys.readouterr().out) == (1, "false\n")
    lines = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    trace_id = lines[0]["trace_id"]
    [span] = [ln for ln in lines if ln["kind"] == "span" and ln["name"] == "profile.trace"]
    assert span["attrs"] == {"dir": str(prof), "trace_id": trace_id}
    search = next(ln for ln in lines if ln["kind"] == "span" and ln["name"] == "phase.search")
    assert span["start_s"] <= search["start_s"] and search["seconds"] <= span["seconds"]
    assert {"kind": "gauge", "name": "profile.trace_dir", "value": str(prof)} in lines
    events = json.loads(trace_file(str(prof), trace_id).read_text())["traceEvents"]
    assert any(ev.get("name") == f"qi-trace:{trace_id}" for ev in events)


def test_profile_trace_without_a_dir_records_nothing(record):
    with profile_trace(None, "cpu"):
        solve(synth.majority_fbas(5), backend="python", device="cpu")
    assert "profile.trace" not in {sp.name for sp in record.spans}
    assert "profile.trace_dir" not in record.gauges


def test_a_profiler_that_fails_to_start_fails_the_solve(tmp_path, monkeypatch, record):
    import torch.profiler

    class Refused:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            raise RuntimeError("profiler refused to start")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Refused)
    ran = []
    with pytest.raises(RuntimeError, match="refused to start"):
        with profile_trace(str(tmp_path), "cpu"):
            ran.append(True)
    assert ran == []


def test_no_compile_cache_builds_the_oracle_in_a_private_directory(monkeypatch, fresh_cache, record):
    monkeypatch.setenv("QI_NO_COMPILE_CACHE", "1")
    private = cpp.build_library()
    assert private.is_file() and PORT.resolve() not in private.resolve().parents
    assert private.parent.parent == compile_cache._private_root
    assert private.name == cpp.so_path().name
    assert cpp.build_library() == private
    assert record.counters["compile_cache.misses"] == 1 and "compile_cache.hits" not in record.counters
    assert "compile_cache.enabled" not in {ev["name"] for ev in record.events}
    monkeypatch.delenv("QI_NO_COMPILE_CACHE")
    cached = cpp.build_library()
    assert cached.parent == cpp.BUILD_DIR and cached.name == private.name
    assert record.counters["compile_cache.misses"] + record.counters.get("compile_cache.hits", 0) == 2
    [enabled] = [ev for ev in record.events if ev["name"] == "compile_cache.enabled"]
    assert enabled["attrs"]["dir"] == str(cpp.BUILD_DIR)


def test_cache_counts_each_library_once_a_process(tmp_path, monkeypatch, fresh_cache, record):
    monkeypatch.setattr(cpp, "BUILD_DIR", tmp_path / "_build")
    first = cpp.build_library()
    assert first.parent == tmp_path / "_build"
    for _ in range(3):
        assert cpp.build_library() == first
    assert record.counters["compile_cache.misses"] == 1 and "compile_cache.hits" not in record.counters


def test_cache_hides_no_build_failure(tmp_path, monkeypatch, fresh_cache, record):
    monkeypatch.setattr(cpp, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cpp, "GXX_FLAGS", cpp.GXX_FLAGS + ["-fno-such-flag"])
    with pytest.raises(RuntimeError, match="native oracle build failed"):
        cpp.build_library()
    assert not list((tmp_path / "_build").glob("qi_oracle-*.so"))


@pytest.mark.parametrize("backend", ["gpu-sweep", "gpu-frontier"])
def test_card_backends_book_build_seconds(backend, record):
    res = solve(synth.majority_fbas(5), backend=backend, device="cpu")
    assert res.stats["kernel_build_seconds"] == 0.0
    gauge = "sweep.kernel_build_seconds" if backend == "gpu-sweep" else "frontier.kernel_build_seconds"
    assert record.gauges[gauge] == 0.0


def test_packed_drive_books_build_seconds(record):
    from quorum_intersection_tpu_torch.pipeline import check_many

    srcs = [synth.majority_fbas(5), synth.majority_fbas(6, broken=True), synth.majority_fbas(7)]
    res = check_many(srcs, backend=GpuSweepBackend(device="cpu"))
    packed = [r for r in res if r.stats.get("packed")]
    assert packed and all(r.stats["kernel_build_seconds"] == 0.0 for r in packed)


BUCKETS = {
    "unset": None,
    "empty": "",
    "good": "1,10,100,1000",
    "spaces": " 0.5, 2 ,8,",
    "unsorted": "10,1,100",
    "duplicate": "1,10,10,100",
    "malformed": "1,ten,100",
    "only-commas": ",,,",
}


@pytest.mark.parametrize("case", list(BUCKETS))
def test_hist_bounds_equal_the_jax_packages(case, monkeypatch):
    if BUCKETS[case] is None:
        monkeypatch.delenv("QI_PULSE_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("QI_PULSE_BUCKETS", BUCKETS[case])
    assert telemetry.hist_bounds() == jax_telemetry.hist_bounds()
    assert telemetry.Histogram("pulse.test").bounds == jax_telemetry.Histogram("pulse.test").bounds
