"""The port's candidate mesh and sharded sweep (K11) on the CPU, against the
JAX package's ``TpuSweepBackend(mesh=...)`` on the conftest's 8 emulated
devices:

- ``GpuSweepBackend(device="cpu", batch=64·n, mesh=candidate_mesh(n,
  device="cpu"))`` on meshes of 1, 2, 3, 4 and 8 ranks: verdict, witness,
  hit index, ``candidates_checked`` and ``device_steps``, exact, on
  ``majority_fbas``, the vendored fixtures, seeded random networks and the
  restricted wide graph of the JAX ``test_sharded_sweep_on_restricted_wide_graph``
  (``lo_bits`` 6, so it decodes wide).  The JAX drive compiles its ramp's
  jump target on a thread; here it compiles inline (the JAX tests'
  ``TestRampJump._InlineThread``), which makes its programs deterministic;
- the mesh rules: the ``sweep.engine_resolved`` reason, no pruning, no
  packing, a checkpoint that resumes under a mesh;
- ``AutoBackend(mesh=)``: the mesh reaches its sweeps and its frontier rung
  (the JAX ``test_auto_backend_forwards_mesh``), the pack gate is closed;
- ``card_shares``: the cards' contiguous shares tile a program once (one
  card, four cards, a mesh that repeats two cards, two processes), the 2^31
  ceiling raises before any launch; the plain mesh program (one range a
  card) against K1's plain contiguous program and the JAX sharded step's
  ``pmin``; the sweep's peer-access answers; ``candidate_mesh``'s prefix and
  its error text;
- the CLI's ``--mesh`` cases of the JAX ``tests/test_cli.py:146-190`` with
  ``--device cpu``, beside the JAX CLI.

``snapshot_correct.json`` (2^20 candidates, some 10 s a mesh through the
plain version on one thread) is left to the card (``chip_smoke.py --mesh``).
Everything compared is an integer or a string: exact equality.
"""

import functools
import io
import json
import sys
import types

import numpy as np
import pytest
import torch

import quorum_intersection_tpu.backends.tpu.sweep as jax_sweep_mod
from quorum_intersection_tpu import cli as jax_cli
from quorum_intersection_tpu.backends.base import SearchCancelled as JaxSearchCancelled
from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu.fbas import synth as jax_synth
from quorum_intersection_tpu.parallel.mesh import candidate_mesh as jax_candidate_mesh
from quorum_intersection_tpu.pipeline import check_many as jax_check_many
from quorum_intersection_tpu.pipeline import solve as jax_solve
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu.utils.checkpoint import SweepCheckpoint as JaxSweepCheckpoint
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends.auto import AutoBackend
from quorum_intersection_tpu_torch.backends.base import SearchCancelled
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.kernels import sweep_cuda
from quorum_intersection_tpu_torch.kernels.sweep_cuda import KernelLimitError, MeshSweep, sweep_fused, sweep_mesh
from quorum_intersection_tpu_torch.kernels.sweep_ref import SweepRef
from quorum_intersection_tpu_torch.parallel import CANDIDATE_AXIS, candidate_mesh
from quorum_intersection_tpu_torch.parallel.mesh import CandidateMesh, card_shares
from quorum_intersection_tpu_torch.pipeline import check_many, solve
from quorum_intersection_tpu_torch.utils import telemetry
from quorum_intersection_tpu_torch.utils.checkpoint import SweepCheckpoint

from _torch_cases import fixture_data, sweep_case

torch.set_num_threads(1)

MESHES = (1, 2, 3, 4, 8)
KEYS = ("hit_index", "candidates_checked", "device_steps", "enumeration_total")
CASES = {
    "maj9": lambda: jax_synth.majority_fbas(9),
    "maj11-broken": lambda: jax_synth.majority_fbas(11, broken=True),
    "maj13": lambda: jax_synth.majority_fbas(13),
    "trivial_correct": lambda: fixture_data("trivial_correct.json"),
    "trivial_broken": lambda: fixture_data("trivial_broken.json"),
    "nested_correct": lambda: fixture_data("nested_correct.json"),
    "nested_broken": lambda: fixture_data("nested_broken.json"),
    "snapshot_broken": lambda: fixture_data("snapshot_broken.json"),
    "random-14-s3": lambda: jax_synth.random_fbas(14, seed=3),
    "bench40-8-s5": lambda: jax_synth.benchmark_fbas(40, 8, seed=5),
    "bench40-8-broken-s6": lambda: jax_synth.benchmark_fbas(40, 8, broken=True, seed=6),
    "wide48-12": lambda: jax_synth.benchmark_fbas(48, 12, seed=3),
    "wide48-12-broken": lambda: jax_synth.benchmark_fbas(48, 12, broken=True, seed=3),
}
# Cases that run the two-level decode: 6 low bits, the rest on a hi row.
WIDE_LO_BITS = 6


class _InlineThread:
    """The JAX drive's compile thread, run at ``start()`` (the JAX tests'
    ``TestRampJump._InlineThread``)."""

    def __init__(self, *a, **k):
        self._target = k.get("target")

    def start(self):
        self._target()

    def is_alive(self):
        return False


@pytest.fixture(autouse=True, scope="module")
def inline_jax_compile():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sweep_mod, "_thread_factory", _InlineThread)
        yield


def _lo_bits(case: str) -> dict:
    return {"lo_bits": WIDE_LO_BITS} if case.startswith("wide") else {}


@functools.lru_cache(maxsize=None)
def _jax(case: str, n: int):
    return jax_solve(CASES[case](), backend=TpuSweepBackend(batch=64 * n, mesh=jax_candidate_mesh(n),
                                                           **_lo_bits(case)))


def _port(case: str, n: int, **kw):
    backend = GpuSweepBackend(device="cpu", batch=64 * n, mesh=candidate_mesh(n, device="cpu"),
                              **_lo_bits(case), **kw)
    return solve(CASES[case](), backend=backend)


def _answer(res):
    return (res.intersects, res.q1, res.q2) + tuple(res.stats.get(k) for k in KEYS)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_solve_matches_jax(case, n):
    want, got = _jax(case, n), _port(case, n)
    assert _answer(got) == _answer(want)
    if "candidates_checked" in got.stats:
        assert got.stats["mesh"] == {"devices": f"cpu x{n}", "ranks": n, "processes": 1, "collective": "none"}
    if not got.intersects:
        assert got.q1 and got.q2 and not set(got.q1) & set(got.q2)


def _engine_events(events):
    return [(e["attrs"]["requested"], e["attrs"]["resolved"], e["attrs"]["reason"])
            for e in events if e["name"] == "sweep.engine_resolved"]


@pytest.mark.parametrize("engine", ["pallas", "bitset", "xla"])
def test_engine_resolution_under_a_mesh_matches_jax(engine):
    data = jax_synth.majority_fbas(9, broken=True)
    jax_rec = jax_telemetry.reset_run_record()
    want = jax_solve(data, backend=TpuSweepBackend(batch=128, mesh=jax_candidate_mesh(2), engine=engine))
    rec = telemetry.reset_run_record()
    got = solve(data, backend=GpuSweepBackend(device="cpu", batch=128, engine=engine,
                                              mesh=candidate_mesh(2, device="cpu")))
    assert _engine_events(rec.events) == _engine_events(jax_rec.events)
    assert _engine_events(rec.events)[0][1] == "xla"
    assert _answer(got) == _answer(want) and "encoding" not in got.stats
    if engine != "xla":
        assert _engine_events(rec.events)[0][2] == f"mesh sharding: the {engine} kernel has no sharded program"


def test_no_pruning_under_a_mesh():
    data = jax_synth.benchmark_fbas(40, 8, seed=5)
    want = jax_solve(data, backend=TpuSweepBackend(batch=128, prune=True, mesh=jax_candidate_mesh(2)))
    got = solve(data, backend=GpuSweepBackend(device="cpu", batch=128, prune=True,
                                              mesh=candidate_mesh(2, device="cpu")))
    assert _answer(got) == _answer(want)
    assert "guard_rows" not in got.stats and got.stats["cert"]["windows_pruned_guard"] == 0
    assert got.stats["candidates_checked"] == got.stats["enumeration_total"]


def test_no_packing_under_a_mesh():
    sources = [jax_synth.majority_fbas(9), jax_synth.majority_fbas(10, broken=True),
               jax_synth.benchmark_fbas(40, 8, broken=True, seed=6)]
    want = jax_check_many(sources, backend=TpuSweepBackend(batch=128, mesh=jax_candidate_mesh(2)))
    backend = GpuSweepBackend(device="cpu", batch=128, mesh=candidate_mesh(2, device="cpu"))
    got = check_many(sources, backend=backend)
    assert [_answer(r) for r in got] == [_answer(r) for r in want]
    assert backend.pack_plans == [] and not any(r.stats.get("packed") for r in got)


class _CancelOnceRecorded:
    """Reads as cancelled once the sweep has recorded progress at ``path``
    (``tests/test_torch_sweep_checkpoint.py``'s)."""

    def __init__(self, path):
        self.path = path

    @property
    def cancelled(self):
        return self.path.exists()


def _ckpt_backend(package, path, cancel=None):
    if package == "jax":
        return TpuSweepBackend(batch=256, mesh=jax_candidate_mesh(4), max_inflight=2, cancel=cancel,
                               checkpoint=JaxSweepCheckpoint(path))
    return GpuSweepBackend(device="cpu", batch=256, mesh=candidate_mesh(4, device="cpu"), cancel=cancel,
                           checkpoint=SweepCheckpoint(path))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_under_a_mesh(writer, tmp_path):
    """A mesh sweep stopped after its first recorded program, then resumed
    from that file under a mesh by both packages: the same position, the
    same rest of the drive."""
    data = jax_synth.majority_fbas(14)
    path, again = tmp_path / "sweep.json", tmp_path / "again.json"
    run = jax_solve if writer == "jax" else solve
    with pytest.raises((JaxSearchCancelled, SearchCancelled)):
        run(data, backend=_ckpt_backend(writer, path, _CancelOnceRecorded(path)))
    recorded = json.loads(path.read_text())
    again.write_text(json.dumps(recorded))
    got = solve(data, backend=_ckpt_backend("port", path))
    want = jax_solve(data, backend=_ckpt_backend("jax", again))
    assert got.stats["resumed_from"] == want.stats["resumed_from"] == recorded["position"] > 0
    assert _answer(got) == _answer(want)
    assert got.stats["candidates_checked"] + got.stats["resumed_from"] == recorded["total"]
    assert not path.exists()  # the verdict cleared it


def test_auto_forwards_the_mesh_and_closes_pack_and_frontier(monkeypatch):
    mesh = candidate_mesh(3, device="cpu")
    auto = AutoBackend(device="cpu", mesh=mesh, pack=True)
    assert auto._sweep().mesh is mesh and auto._sweep(engine="bitset").mesh is mesh
    assert auto._pack_bound([5, 6, 7]) is None
    assert AutoBackend(device="cpu", pack=True)._pack_bound([5, 6, 7]) is not None
    # The router's race, sharded sweep against the oracle: either winner's
    # verdict is the JAX mesh solve's, with two disjoint quorums.
    res = solve(jax_synth.majority_fbas(11, broken=True), backend=auto)
    assert res.intersects is _jax("maj11-broken", 3).intersects is False
    assert res.q1 and res.q2 and not set(res.q1) & set(res.q2)
    # Without the race, the sweep rung answers on the mesh: the JAX witness.
    monkeypatch.setattr(AutoBackend, "_budgeted_oracle", lambda *a, **k: None)
    res = solve(jax_synth.majority_fbas(11, broken=True), backend=AutoBackend(device="cpu", mesh=mesh, race=False))
    want = _jax("maj11-broken", 3)
    assert (res.intersects, res.q1, res.q2) == (want.intersects, want.q1, want.q2)
    assert res.stats["mesh"]["ranks"] == 3
    # The frontier rung, open on its win region, takes the mesh as the JAX
    # router's does (auto.py:1492): the sharded frontier answers, with the
    # JAX mesh frontier's witness.  (A sweep limit of 0 sends this small SCC
    # past the sweep.)
    from quorum_intersection_tpu.backends.tpu.frontier import TpuFrontierBackend

    data = synth.majority_fbas(7, broken=True)
    want = jax_solve(jax_synth.majority_fbas(7, broken=True), backend=TpuFrontierBackend(mesh=jax_candidate_mesh(3)))
    for m in (None, mesh):
        router = AutoBackend(device="cpu", mesh=m)
        monkeypatch.setattr(router, "_frontier_region", lambda: (1, 64))
        monkeypatch.setattr(router, "_sweep_limit", lambda: 0)
        rec = telemetry.reset_run_record()
        got = solve(data, backend=router)
        assert (got.intersects, got.q1, got.q2) == (want.intersects, want.q1, want.q2) and got.intersects is False
        decision = [e["attrs"] for e in rec.events if e["name"] == "route.decision"][-1]
        assert decision["engine"] == "gpu-frontier" and "mesh" not in decision["reason"]
        assert got.stats.get("mesh", {}).get("ranks") == (None if m is None else 3)


CARDS = [torch.device("cuda", i) for i in range(4)]  # device objects only: no card is touched
# label: (local devices, processes)
SHARE_MESHES = {
    "cuda:0 x4": ((CARDS[0],) * 4, 1),
    "cuda:0-3": (tuple(CARDS), 1),
    "c0,c1,c0,c1": ((CARDS[0], CARDS[1], CARDS[0], CARDS[1]), 1),
    "two processes x4": ((CARDS[0], CARDS[1], CARDS[1], CARDS[2]), 2),
}


@pytest.mark.parametrize("label", list(SHARE_MESHES))
def test_card_shares_tile_a_program_once(label):
    """Each process's cards take contiguous shares, home card first, each
    card as many rows as its ranks cover; the processes' shares chain into
    the program's range exactly once."""
    devices, processes = SHARE_MESHES[label]
    per_dev, steps = 5, 3
    for start in (0, 7, (1 << 31) - per_dev * steps * len(devices) * processes):
        spans = []
        for p in range(processes):
            mesh = CandidateMesh(devices=devices, process_index=p, process_count=processes)
            shares = card_shares(mesh, per_dev, steps, start)
            assert [d for d, _, _ in shares] == list(dict.fromkeys(devices)) and shares[0][0] == mesh.home
            assert [rows for _, _, rows in shares] == [devices.count(d) * per_dev * steps for d, _, _ in shares]
            assert shares[0][1] == start + p * len(devices) * per_dev * steps
            spans += [(first, first + rows) for _, first, rows in shares]
        assert spans[0][0] == start and spans[-1][1] == start + steps * per_dev * len(devices) * processes
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # no gap, no overlap


@pytest.mark.parametrize("start, processes", [((1 << 31) - 40, 1), (-5, 1), ((1 << 31) - 100, 2)])
def test_index_ceiling_raises_before_any_launch(start, processes, monkeypatch):
    """A program whose range crosses 2^31 (or starts below 0) raises
    ``KernelLimitError`` on every process, the one whose own share fits
    too, before any card or plain program runs."""
    devices = (CARDS[0], CARDS[1]) * 2
    for p in range(processes):
        with pytest.raises(KernelLimitError, match="2\\^31 index ceiling"):
            card_shares(CandidateMesh(devices=devices, process_index=p, process_count=processes), 5, 4, start)
    monkeypatch.setattr(MeshSweep, "program", lambda *a, **k: pytest.fail("a mesh program ran past the ceiling"))
    sc = sweep_case("bench-broken:0")
    (q, d) = sc.pair
    lo_nodes = np.arange(1, q.n, dtype=np.int32)
    mesh = CandidateMesh(devices=(torch.device("cpu"),) * 4, process_count=processes)  # process 0
    backend = GpuSweepBackend(device="cpu", mesh=mesh)
    _, sharded = backend._build_sharded_step(q, lo_nodes, np.ones(q.n, dtype=np.int32), None, 5 * mesh.size,
                                             circuit_d=d)
    launches = sweep_fused.launches, sweep_mesh.launches
    with pytest.raises(KernelLimitError):
        sharded.program(start, 4)
    assert (sweep_fused.launches, sweep_mesh.launches) == launches


@pytest.mark.parametrize("n", [2, 3, 8])
def test_plain_mesh_program_equals_k1_and_jax_pmin(n):
    """One program of ``steps`` blocks on an ``n``-rank CPU mesh (the one
    card's range through the plain version) equals K1's plain contiguous
    program over the same coverage and the JAX sharded step's ``pmin`` on
    its ``n`` emulated devices, with the same ``base_block``."""
    sc = sweep_case("bench-nested-broken:0")  # an SCC of 9: 2^8 candidates
    (jq, jd), (q, d) = sc.jax_pair, sc.pair
    lo_nodes = np.arange(1, q.n, dtype=np.int32)
    mask = np.ones(q.n, dtype=np.int32)
    per_dev, steps = 5, 4
    backend = GpuSweepBackend(device="cpu", mesh=candidate_mesh(n, device="cpu"))
    base, sharded = backend._build_sharded_step(q, lo_nodes, mask, None, per_dev * n, circuit_d=d)
    jax_base, make_dispatch = TpuSweepBackend(mesh=jax_candidate_mesh(n))._build_sharded_step(
        jq, lo_nodes, mask, None, per_dev * n, circuit_d=jd)
    assert base == jax_base == per_dev * n
    jax_program = make_dispatch(steps)
    contiguous = SweepRef(q, lo_nodes, mask, None, base, d)
    hits = 0
    for start in (0, 7, 40, (1 << (q.n - 1)) - steps * base):
        got = int(sharded.program(start, steps))
        assert got == int(contiguous.program(start, steps)) == int(jax_program(start)), start
        hits += got != 2**31 - 1
    assert hits  # windows with a hit among them


@pytest.mark.parametrize("code", [0, 217, 999])
def test_sweep_peer_access_codes_map_to_errors(monkeypatch, code):
    """``sweep_cuda.enable_peer_access`` maps the library's answer: no peer
    path (``cudaErrorPeerAccessUnsupported``) is a ``KernelLimitError``
    naming peer access, any other fault a ``RuntimeError`` naming the CUDA
    error, success nothing.  A ``MeshSweep`` over two cards asks it first,
    before it touches a card's tables."""

    class Library:
        calls = []

        def qi_sweep_enable_peer(self, dev, peer):
            self.calls.append((dev, peer))
            return code

        def qi_cuda_error_string(self, err):
            return f"cuda error {err}".encode()

    monkeypatch.setattr(sweep_cuda, "_library", Library)
    a, b = CARDS[0], CARDS[1]
    if code == 217:
        with pytest.raises(KernelLimitError, match="no peer access from cuda:1 to cuda:0"):
            MeshSweep([types.SimpleNamespace(device=a), types.SimpleNamespace(device=b)])
    elif code:
        with pytest.raises(RuntimeError, match=f"cuda error {code}"):
            sweep_cuda.enable_peer_access(b, a)
    else:
        sweep_cuda.enable_peer_access(b, a)
    assert Library.calls == [(1, 0)]
    with pytest.raises(ValueError, match="one sweep a card"):
        MeshSweep([types.SimpleNamespace(device=a)] * 2)
    with pytest.raises(ValueError, match="all CUDA devices or one CPU"):
        MeshSweep([types.SimpleNamespace(device=torch.device("cpu")), types.SimpleNamespace(device=a)])


def test_candidate_mesh_prefix_and_errors():
    mesh = candidate_mesh(2, device="cpu")
    assert mesh.size == 2 and (mesh.axis_name,) == (CANDIDATE_AXIS,) == jax_candidate_mesh(2).axis_names
    assert candidate_mesh(device="cpu").size == 1
    assert candidate_mesh(devices=["cpu"] * 5).size == 5
    with pytest.raises(ValueError) as jax_err:
        jax_candidate_mesh(9)
    with pytest.raises(ValueError) as port_err:
        candidate_mesh(9, device="cpu")
    assert str(port_err.value) == str(jax_err.value) == "requested 9 devices, have 8"
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        candidate_mesh(3, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            candidate_mesh(2)  # never moves to the CPU unasked
    two = CandidateMesh(devices=(torch.device("cpu"),) * 2, process_index=1, process_count=3)
    assert two.size == 6 and [two.global_rank(i) for i in range(2)] == [2, 3]


def test_mesh_device_must_be_the_home_device(monkeypatch):
    """A backend's device under a mesh is the mesh's home device: another
    card raises rather than running on the home card; ``"cuda"`` without an
    index names no card and takes the home."""
    from quorum_intersection_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "resolve_device", torch.device)  # no card needed to name one
    on_card = CandidateMesh(devices=(torch.device("cuda", 0),) * 2)
    assert mesh_mod.mesh_device(on_card, None) == mesh_mod.mesh_device(on_card, "cuda") == on_card.home
    assert mesh_mod.mesh_device(on_card, "cuda:0") == on_card.home
    for other in ("cuda:1", "cpu"):
        with pytest.raises(ValueError, match=f"device={other}"):
            mesh_mod.mesh_device(on_card, other)
    on_cpu = candidate_mesh(2, device="cpu")
    assert GpuSweepBackend(device="cpu", mesh=on_cpu).device == torch.device("cpu")


def test_failed_collective_fails_the_solve():
    """A mesh that names a second process with no process group behind it:
    the collective raises and so does the solve, with no verdict."""
    mesh = CandidateMesh(devices=(torch.device("cpu"),) * 2, process_count=2)
    with pytest.raises((RuntimeError, ValueError)):
        solve(jax_synth.majority_fbas(9), backend=GpuSweepBackend(device="cpu", batch=64, mesh=mesh))


def _run(main, argv, stdin_text, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    code = main(argv)
    captured = capsys.readouterr()
    return captured.out, captured.err, code


@pytest.mark.parametrize("mesh,broken", [("2", False), ("all", True), ("3", True)])
def test_mesh_flag_solves_as_the_jax_cli(mesh, broken, monkeypatch, capsys):
    text = json.dumps(jax_synth.majority_fbas(9, broken=broken))
    want = _run(jax_cli.main, ["--backend", "tpu-sweep", "--mesh", mesh], text, monkeypatch, capsys)
    got = _run(cli.main, ["--device", "cpu", "--backend", "gpu-sweep", "--mesh", mesh], text, monkeypatch, capsys)
    assert (got[0], got[2]) == (want[0], want[2]) == (("false\n", 1) if broken else ("true\n", 0))


def test_mesh_flag_under_auto(monkeypatch, capsys):
    text = json.dumps(jax_synth.majority_fbas(9, broken=True))
    out, _, code = _run(cli.main, ["--device", "cpu", "--mesh", "2"], text, monkeypatch, capsys)
    assert (out, code) == ("false\n", 1)


def test_mesh_flag_requires_device_backend(monkeypatch, capsys):
    text = json.dumps(jax_synth.majority_fbas(3))
    _, err, code = _run(cli.main, ["--device", "cpu", "--backend", "python", "--mesh", "2"], text, monkeypatch, capsys)
    assert code == 1 and "--mesh requires a device backend" in err
    # The frontier takes the mesh and answers as the JAX CLI's tpu-frontier.
    want = _run(jax_cli.main, ["--backend", "tpu-frontier", "--mesh", "2"], text, monkeypatch, capsys)
    got = _run(cli.main, ["--device", "cpu", "--backend", "gpu-frontier", "--mesh", "2"], text, monkeypatch, capsys)
    assert (got[0], got[2]) == (want[0], want[2]) == ("true\n", 0)


def test_mesh_flag_bad_values(monkeypatch, capsys):
    text = json.dumps(jax_synth.majority_fbas(3))
    _, err, code = _run(cli.main, ["--device", "cpu", "--backend", "gpu-sweep", "--mesh", "lots"], text,
                        monkeypatch, capsys)
    assert code == 1 and "device count or 'all'" in err
    _, err, code = _run(cli.main, ["--device", "cpu", "--backend", "gpu-sweep", "--mesh", "999"], text,
                        monkeypatch, capsys)
    assert code == 1 and err == "--mesh 999: requested 999 devices, have 8\n"


@pytest.mark.parametrize("value", ["0", "-2"])
def test_mesh_flag_rejects_nonpositive(value, monkeypatch, capsys):
    text = json.dumps(jax_synth.majority_fbas(3))
    want = _run(jax_cli.main, ["--backend", "tpu-sweep", "--mesh", value], text, monkeypatch, capsys)
    got = _run(cli.main, ["--device", "cpu", "--backend", "gpu-sweep", "--mesh", value], text, monkeypatch, capsys)
    assert got == want and got[2] == 1 and "positive device count" in got[1]
