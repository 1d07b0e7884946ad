"""The port imports neither JAX nor the JAX package: it solves (profiled
too, and on a 2-rank CPU mesh), scans SCCs natively, and serves a two-line
stream through ``serve`` and through a two-worker ``fleet``, with both
blocked; no source line of it (or of ``chip_smoke.py``, of the helpers it
shares with the card tests ``tests/_torch_frontier_blocks.py``, or of the
multi-process worker ``tests/_torch_dist_worker.py``) names them, and its
native builds compile only its own sources."""

import json
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "quorum_intersection_tpu_torch"

_BLOCKED_RUN = r"""
import importlib.abc, json, pathlib, sys

sys.modules["jax"] = None  # any `import jax` now raises ImportError


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "quorum_intersection_tpu":
            raise ImportError("the JAX package is blocked in this process")
        return None


sys.meta_path.insert(0, _Block())
import torch

torch.set_num_threads(1)
from quorum_intersection_tpu_torch import solve

out = {}
for name in ("trivial_correct.json", "trivial_broken.json", "nested_correct.json",
             "nested_broken.json"):
    res = solve((pathlib.Path(sys.argv[1]) / name).read_text(), device="cpu")
    out[name] = [res.intersects, res.q1, res.q2]
import io
from quorum_intersection_tpu_torch import cli

for name in ("nested_correct.json", "nested_broken.json"):
    res = solve((pathlib.Path(sys.argv[1]) / name).read_text(), backend="gpu-frontier", device="cpu")
    out[f"frontier {name}"] = [res.intersects, res.q1, res.q2]
import os
from quorum_intersection_tpu_torch.fbas import synth
os.environ["QI_SWEEP_ENGINE"] = "bitset"
for name, data in (("near_disjoint_cores(6,1)", synth.near_disjoint_cores(6, 1)),
                   ("sparse_giant(400,broken)", synth.sparse_giant(400, broken=True))):
    res = solve(json.dumps(data), backend="gpu-sweep", device="cpu")
    assert res.stats["encoding"] == "bitset" and res.cert["provenance"]["encoding"] == "bitset"
    out[f"bitset {name}"] = [res.intersects, res.q1, res.q2]
del os.environ["QI_SWEEP_ENGINE"]
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.parallel import candidate_mesh

res = solve(json.dumps(synth.majority_fbas(9, broken=True)),
            backend=GpuSweepBackend(device="cpu", batch=128, mesh=candidate_mesh(2, device="cpu")))
out["mesh majority(9,broken)"] = [res.intersects, res.stats["mesh"]["ranks"], res.stats["hit_index"]]
from quorum_intersection_tpu_torch.delta import DeltaEngine

engine = DeltaEngine(device="cpu")
for i, snap in enumerate(synth.churn_trace(synth.benchmark_fbas(14, 6, broken=True, seed=3), 3, seed=0)):
    res = engine.check_many([snap], backend="gpu-sweep")[0]
    out[f"delta step {i}"] = [res.intersects, res.q1, res.q2, res.cert["provenance"]["delta"]["reused_sccs"]]
ckpt = pathlib.Path(sys.argv[2]) / "frontier.ckpt"
for name, argv in (("nested_correct.json", ["--backend", "auto", "--device", "cpu"]),
                   ("trivial_broken.json", ["--backend", "cpp", "--device", "cpu"]),
                   ("nested_correct.json", ["--backend", "gpu-frontier", "--device", "cpu",
                                            "--checkpoint", str(ckpt)]),
                   ("nested_broken.json", ["--backend", "gpu-sweep", "--device", "cpu",
                                           "--checkpoint", str(ckpt) + ".sweep"])):
    sys.stdin = io.StringIO((pathlib.Path(sys.argv[1]) / name).read_text())
    out[f"cli {argv[1]} {name}"] = [cli.main(argv)]
from quorum_intersection_tpu_torch import serve_transport

fixtures = pathlib.Path(sys.argv[1])
stream = "".join(json.dumps({"request_id": name, "nodes": json.loads((fixtures / name).read_text())}) + "\n"
                 for name in ("trivial_correct.json", "nested_broken.json"))
sys.stdin = io.StringIO(stream)
served = io.StringIO()
real_stdout, sys.stdout = sys.stdout, served
try:
    rc = serve_transport.serve_main(["--device", "cpu", "--backend", "gpu-sweep"])
finally:
    sys.stdout = real_stdout
out["serve rc"] = [rc]
for line in served.getvalue().splitlines():
    obj = json.loads(line)
    out[f"serve {obj['request_id']}"] = [obj["verdict"], obj["cached"]]
from quorum_intersection_tpu_torch import fleet

sys.stdin = io.StringIO(stream)
served = io.StringIO()
real_stdout, sys.stdout = sys.stdout, served
try:
    rc = fleet.fleet_main(["-n", "2", "--device", "cpu", "--backend", "gpu-sweep", "--local-workers",
                           "--journal-dir", str(pathlib.Path(sys.argv[2]) / "fleet")])
finally:
    sys.stdout = real_stdout
out["fleet rc"] = [rc]
for line in served.getvalue().splitlines()[1:]:
    obj = json.loads(line)
    out[f"fleet {obj['request_id']}"] = [obj["verdict"], obj["cached"]]
sys.stdin = sys.__stdin__
from quorum_intersection_tpu_torch.backends.cpp import native_scc_scan
from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.pipeline import scan_scc_quorums
from quorum_intersection_tpu_torch.utils.profiling import profile_trace

with profile_trace(str(pathlib.Path(sys.argv[2]) / "prof"), "cpu"):
    res = solve((fixtures / "snapshot_broken.json").read_text(), device="cpu")
out["profiled snapshot_broken.json"] = [res.intersects, len(list((pathlib.Path(sys.argv[2]) / "prof").iterdir()))]
graph = build_graph(parse_fbas((fixtures / "snapshot_correct.json").read_text()))
count, comp = tarjan_scc(graph.n, graph.succ)
sccs = group_sccs(graph.n, comp, count)
out["native scan"] = [native_scc_scan(graph, sccs) == scan_scc_quorums(graph, sccs)]
leaked = sorted(m for m in sys.modules
                if m == "jax" and sys.modules[m] is not None
                or m.split(".")[0] == "quorum_intersection_tpu")
print(json.dumps({"results": out, "leaked": leaked}))
"""


def test_port_solves_with_jax_and_reference_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "fixtures"), str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    verdicts = {k: v[0] for k, v in report["results"].items()}
    assert verdicts == {
        "trivial_correct.json": True,
        "trivial_broken.json": False,
        "nested_correct.json": True,
        "nested_broken.json": False,
        "frontier nested_correct.json": True,
        "frontier nested_broken.json": False,
        "cli auto nested_correct.json": 0,
        "cli cpp trivial_broken.json": 1,
        "cli gpu-frontier nested_correct.json": 0,
        "cli gpu-sweep nested_broken.json": 1,
        "bitset near_disjoint_cores(6,1)": True,
        "bitset sparse_giant(400,broken)": False,
        "delta step 0": False,
        "delta step 1": False,
        "delta step 2": False,
        "delta step 3": False,
        "serve rc": 0,
        "serve trivial_correct.json": True,
        "serve nested_broken.json": False,
        "fleet rc": 0,
        "fleet trivial_correct.json": True,
        "fleet nested_broken.json": False,
        "profiled snapshot_broken.json": False,
        "native scan": True,
        "mesh majority(9,broken)": False,
    }
    assert report["results"]["mesh majority(9,broken)"][1:] == [2, 31]
    assert report["results"]["profiled snapshot_broken.json"][1] == 1
    assert not any(report["results"][f"serve {name}"][1] for name in ("trivial_correct.json", "nested_broken.json"))
    reused = [report["results"][f"delta step {i}"][3] for i in range(4)]
    assert reused[0] == 0 and 1 in reused[1:]
    q1, q2 = report["results"]["trivial_broken.json"][1:]
    assert q1 and q2 and not set(q1) & set(q2)


_FORBIDDEN = [
    re.compile(r"import jax"),
    re.compile(r"from jax\b"),
    re.compile(r"quorum_intersection_tpu\."),
    re.compile(r"import quorum_intersection_tpu\b"),
    re.compile(r"from quorum_intersection_tpu\b"),
]


def _sources():
    files = (sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + sorted(PORT.rglob("*.cuh"))
             + sorted(PORT.rglob("*.cpp")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_frontier_blocks.py",
                                              ROOT / "tests" / "_torch_dist_worker.py"])
    assert any(path.suffix == ".cpp" for path in files)
    names = {str(path.relative_to(PORT)) for path in files if PORT in path.parents}
    assert {"backends/frontier.py", "kernels/frontier_ref.py", "kernels/frontier_cuda.py",
            "kernels/csrc/frontier.cu", "utils/checkpoint.py", "kernels/bitset_sweep_ref.py",
            "kernels/bitset_sweep_cuda.py", "kernels/csrc/bitset_sweep.cu", "delta.py", "fbas/diff.py",
            "cost.py", "fuse.py", "serve.py", "serve_transport.py", "utils/metrics_server.py", "fleet.py",
            "utils/compile_cache.py", "utils/profiling.py", "backends/cpp/qi_native.cpp",
            "backends/cpp/qi_oracle.cpp", "parallel/__init__.py", "parallel/mesh.py",
            "parallel/distributed.py"} <= names
    assert len(files) > 10 and all(path.exists() for path in files[-2:])
    return files


@pytest.mark.parametrize("pattern", _FORBIDDEN, ids=lambda p: p.pattern)
def test_sources_never_name_jax_or_the_jax_package(pattern):
    hits = [
        f"{path.relative_to(ROOT)}:{i}: {line.strip()}"
        for path in _sources()
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if pattern.search(line)
    ]
    assert hits == []


def test_scan_catches_the_forms_it_must_and_spares_the_port_prefix():
    must = ["import jax", "import jax.numpy as jnp", "from jax import lax",
            "from quorum_intersection_tpu.fbas import x", "import quorum_intersection_tpu",
            "from quorum_intersection_tpu import cli"]
    spare = ["import quorum_intersection_tpu_torch", "from quorum_intersection_tpu_torch.fbas import x"]
    assert all(any(p.search(s) for p in _FORBIDDEN) for s in must)
    assert not any(p.search(s) for p in _FORBIDDEN for s in spare)


def test_native_oracle_builds_from_the_ports_own_copy():
    """The port's C++ oracle compiles its own ``qi_oracle.cpp`` into its own
    build directory: no path into the JAX package."""
    from quorum_intersection_tpu_torch.backends import cpp

    jax_pkg = (ROOT / "quorum_intersection_tpu").resolve()
    for path in (cpp.SRC, cpp.BUILD_DIR, cpp.so_path()):
        resolved = path.resolve()
        assert PORT.resolve() in resolved.parents
        assert jax_pkg not in resolved.parents
    assert cpp.SRC.is_file() and cpp.SRC.name == "qi_oracle.cpp"


def test_native_cli_builds_from_the_ports_own_sources(tmp_path, monkeypatch):
    """``build_native_cli`` (plain and sanitized) hands g++ only sources
    under the port, read from the command it runs; by default it writes
    into the port's own build directory."""
    from quorum_intersection_tpu_torch.backends import cpp

    assert PORT.resolve() in cpp.BUILD_DIR.resolve().parents
    monkeypatch.setattr(cpp, "BUILD_DIR", tmp_path / "_build")
    commands = []

    def fake_gxx(cmd, what):
        commands.append(list(cmd))
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(cpp, "_run_gxx", fake_gxx)
    cpp.build_native_cli()
    cpp.build_native_cli(sanitize="asan")
    builds = [cmd for cmd in commands if cmd[-1].endswith(".cpp") and "probe.cpp" not in cmd[-1]]
    assert len(builds) == 2
    for cmd in builds:
        sources = [pathlib.Path(arg).resolve() for arg in cmd if arg.endswith(".cpp")]
        assert [src.name for src in sources] == ["qi_native.cpp", "qi_oracle.cpp"]
        assert all(src.parent == (PORT / "backends" / "cpp").resolve() for src in sources)
        assert pathlib.Path(cmd[cmd.index("-o") + 1]).parent == tmp_path / "_build"
    assert "-fsanitize=address,undefined" in builds[1]


_ENV_READ = re.compile(r"""(os\.environ|os\.getenv|environ\.get)\b[^\n]*["']QI_""")


def test_no_qi_env_read_outside_the_registry():
    """Every ``QI_*`` knob the port reads goes through ``utils/env.py``
    (``qi_env`` refuses an undeclared name): no other module of the port
    reads one from ``os.environ``."""
    scanned = [path for path in sorted(PORT.rglob("*.py")) if path != PORT / "utils" / "env.py"]
    assert {"delta.py", "cost.py", "fbas/diff.py", "fbas/synth.py", "fuse.py", "serve.py", "serve_transport.py",
            "utils/metrics_server.py", "fleet.py"} <= {
        str(path.relative_to(PORT)) for path in scanned}
    hits = [
        f"{path.relative_to(ROOT)}:{i}: {line.strip()}"
        for path in scanned
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if _ENV_READ.search(line)
    ]
    assert hits == []
    must = ['os.environ.get("QI_SWEEP_ENGINE", "")', "os.getenv('QI_FAULTS')", 'os.environ["QI_SWEEP_PRUNE"]']
    assert all(_ENV_READ.search(line) for line in must)
    assert not _ENV_READ.search('qi_env("QI_SWEEP_ENGINE")')
    env_src = (PORT / "utils" / "env.py").read_text()
    assert "os.environ.get(var.name)" in env_src
    delta_src = (PORT / "delta.py").read_text()
    assert 'qi_env_int("QI_DELTA_CACHE_MAX"' in delta_src and 'qi_env_float("QI_FLEET_STORE_MAX_MB"' in delta_src
