#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``quorum_intersection_tpu_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one NVIDIA card

Phases, one line each (any failure exits non-zero and prints no ``ok`` line):

1. device   — CUDA must be available; the card's name and power limit;
2. build    — the CUDA kernels, built from ``kernels/csrc`` with ``nvcc``;
3. kernels  — the kernels this script launches and the TPU kernels they replace;
4. compare  — each kernel against its plain PyTorch version on the card, on
              the same candidate windows (hits included): exact equality,
              since the result is an integer hit index;
5. main     — the verdict path through the entry points a user calls:
              ``solve`` on all seven vendored fixtures (launch counts reset
              before, read after; every ``false`` witness re-checked as two
              disjoint quorums) and ``python -m quorum_intersection_tpu_torch``
              on each fixture (verdict and exit code against MANIFEST.json);
6. full     — ``benchmark_fbas(256, core=34)``, correct and broken twins:
              2^33 candidates through SCC restriction and the wide decode.

The line before the last is the kernels' JSON record (launches on the main
path, error against the plain version, times, bound); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gzip
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "fixtures"
PORT = "quorum_intersection_tpu_torch"
INT8_TOPS = 1979e12  # H100 SXM dense int8 tensor-core peak, operations/s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
WINDOW = 1 << 20  # candidates per timed window


def fail(phase: str, msg: str) -> None:
    print(f"FAIL {phase}: {msg}", flush=True)
    raise SystemExit(1)


def phase_line(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=str), flush=True)


def fixture_text(name: str) -> str:
    raw = (FIXTURES / name).read_bytes()
    return (gzip.decompress(raw) if name.endswith(".gz") else raw).decode()


def sweep_problem(text: str):
    """The quorum-bearing SCC's sweep problem as the backend builds it:
    ``(circuit, circuit_d, local, scc_mask, frozen)``, the circuit restricted
    whenever the graph is wider than the SCC; ``local`` lists the SCC's node
    indices in the circuit (``local[0]`` is fixed out of the enumeration)."""
    import numpy as np

    from quorum_intersection_tpu_torch.encode.circuit import encode_circuit, restrict_circuit_pair
    from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.fbas.semantics import max_quorum

    graph = build_graph(parse_fbas(text))
    count, comp = tarjan_scc(graph.n, graph.succ)
    sccs = group_sccs(graph.n, comp, count)
    scc = next(m for m in sccs if max_quorum(graph, m, [v in set(m) for v in range(graph.n)]))
    circuit = encode_circuit(graph)
    circuit_d = None
    if circuit.n > len(scc):
        circuit, circuit_d = restrict_circuit_pair(circuit, scc)
        local = list(range(len(scc)))
    else:
        local = list(scc)
    scc_mask = np.zeros(circuit.n, dtype=np.int32)
    scc_mask[local] = 1
    frozen = None if circuit_d is not None else 1 - scc_mask
    return circuit, circuit_d, local, scc_mask, frozen


def multi_edge_circuit(seed: int = 5):
    """A hand-made 12-node circuit with vote counts up to 3, two inner units
    each repeated up to twice in a qset, and some thresholds <= 0."""
    import numpy as np

    from quorum_intersection_tpu_torch.encode.circuit import Circuit

    rng = np.random.default_rng(seed)
    n, u = 12, 14
    members = rng.integers(0, 4, size=(u, n)).astype(np.uint8)
    members[np.arange(n), np.arange(n)] = np.maximum(members[np.arange(n), np.arange(n)], 1)
    child = np.zeros((u, u), dtype=np.uint8)
    child[:n, n:] = rng.integers(0, 3, size=(n, u - n))
    votes = members.sum(axis=1).astype(np.int64) + child.sum(axis=1)
    thresholds = (votes * 11 // 20).astype(np.int32)
    thresholds[[3, 9]] = [0, -2]
    unit_depth = np.where(child.any(axis=1), 1, 0).astype(np.int32)
    return Circuit(n=n, n_units=u, depth=1, thresholds=thresholds, members=members,
                   child=child, unit_depth=unit_depth)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def window_bound_ms(circuit, circuit_d, lo_nodes, scc_mask, frozen, start, hi_row, device):
    """Least time the card could take for one window: the dense int8 MACs
    of the fixpoint passes this window's rows need (Q for every row, the D
    probe for rows with Q != 0) at the int8 tensor-core peak, against the
    bytes (tables in, one int32 out) at the memory rate."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref

    tq = ref.CircuitTables(circuit, device)
    td = tq if circuit_d is None else ref.CircuitTables(circuit_d, device)
    pos = torch.from_numpy(ref.bit_positions(lo_nodes, circuit.n)).to(device)
    passes = 0
    chunk = min(1 << 17, WINDOW)
    frozen_row = None if frozen is None else tq.cast(frozen)
    scc = tq.cast(scc_mask).to(torch.int32)
    for lo in range(start, start + WINDOW, chunk):
        avail = ref.decode_masks(lo, chunk, pos, tq.dtype)
        if hi_row is not None:
            avail = torch.maximum(avail, tq.cast(hi_row))
        q, q_passes = ref.fixpoint_passes(tq, avail)
        has_q = q.sum(dim=1) > 0
        comp = torch.clamp(scc - q[has_q].to(torch.int32), 0, 1)
        passes += int(q_passes.sum()) + int(ref.fixpoint_passes(td, comp, frozen_row)[1].sum())
    inner = circuit.n_units - tq.child_from
    depth = circuit.depth if circuit.n_units > circuit.n else 0
    macs = passes * (circuit.n * circuit.n_units + depth * circuit.n_units * inner)
    ops_ms = 2 * macs / INT8_TOPS * 1e3
    table_bytes = circuit.members.size + circuit.child.size + 8 * circuit.n_units + 4 * len(lo_nodes) + 4
    bytes_ms = table_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), passes


def main() -> int:
    if not (ROOT / PORT / "kernels" / "csrc" / "sweep.cu").is_file():
        print(f"FAIL setup: {PORT}/ not found beside chip_smoke.py (run from a checkout)")
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    # -- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card, flush=True)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    phase_line("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__,
               cuda=torch.version.cuda, python=sys.version.split()[0])

    # -- 2. build --------------------------------------------------------
    from quorum_intersection_tpu_torch.kernels import build

    t0 = time.perf_counter()
    try:
        built = build.build_all()
    except build.KernelBuildError as exc:
        fail("build", str(exc))
    ptxas = [ln.strip() for b in built.values() for ln in b.log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase_line("build", seconds=round(time.perf_counter() - t0, 3),
               libraries=[str(b.path.relative_to(ROOT)) for b in built.values()], ptxas=ptxas)

    # -- 3. kernels ------------------------------------------------------
    kernels_meta = {
        "sweep_fused_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/sweep.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:119",
            "counterparts": "K1 pallas_sweep_program_factory (pallas_sweep.py:119, kernel :158); "
                            "K5 kernels.sweep_program_factory (kernels.py:305)",
        }
    }
    phase_line("kernels", kernels={k: v["counterparts"] for k, v in kernels_meta.items()})

    # -- 4. compare: kernel vs plain version on the card ------------------
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import FusedSweep, mask_bits, sweep_fused

    def compare(label, circuit, circuit_d, local, scc_mask, frozen, lo_bits, his, starts,
                batch, steps):
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_nodes = local[1 + lo_bits:]
        fused = FusedSweep(circuit, lo_nodes, scc_mask, frozen, batch, circuit_d, device)
        plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, batch, circuit_d, device)
        hits = windows = 0
        max_err = 0
        for hi in his:
            hi_row = np.zeros(circuit.n, dtype=np.int32)
            for j, v in enumerate(hi_nodes):
                hi_row[v] = (hi >> j) & 1
            for start in starts:
                got = int(fused.program(start, steps, mask_bits(hi_row)))
                want = int(plain.program(start, steps, hi_row if hi_nodes else None))
                torch.cuda.synchronize()
                windows += 1
                hits += want != ref.INT32_MAX
                max_err = max(max_err, abs(got - want))
                if got != want:
                    fail("compare", f"{label} hi={hi} start={start}: kernel {got} != plain {want}")
        return {"label": label, "n": circuit.n, "units": circuit.n_units, "depth": circuit.depth,
                "restricted": circuit_d is not None, "lo_bits": lo_bits, "windows": windows,
                "windows_with_hits": hits, "max_abs_err": max_err}

    results = []
    launches_before_compare = sweep_fused.launches
    for name in ("snapshot_broken.json", "snapshot_correct.json"):
        problem = sweep_problem(fixture_text(name))
        bits = len(problem[2]) - 1
        results.append(compare(f"{name} restricted SCC", *problem, bits, [0],
                               sorted({0, (1 << bits) - WINDOW}), 1 << 17, 8))
    problem = sweep_problem(fixture_text("nested_correct.json"))
    bits = len(problem[2]) - 1
    results.append(compare("nested_correct.json", *problem, bits, [0], [0], 1 << bits, 1))
    for broken in (False, True):
        problem = sweep_problem(json.dumps(synth.benchmark_fbas(256, 34, broken=broken)))
        results.append(compare(f"benchmark_fbas(256,34,broken={broken}) wide", *problem, 30,
                               [0, 5, 7], [0, 3 << 27], 1 << 17, 8))
    me = multi_edge_circuit()
    me_scc = np.ones(me.n, dtype=np.int32)
    results.append(compare("multi-edge scoped", me, None, list(range(me.n)), me_scc, None,
                           me.n - 1, [0], [0], 1 << 11, 1))
    me_scc10 = np.zeros(me.n, dtype=np.int32)
    me_scc10[:10] = 1
    results.append(compare("multi-edge frozen (Q6)", me, None, list(range(10)), me_scc10,
                           1 - me_scc10, 9, [0], [0], 1 << 9, 1))
    max_abs_err = max(r["max_abs_err"] for r in results)
    phase_line("compare", tolerance="exact (integer hit indices)", circuits=results)

    # Times on two main-path shapes: the snapshot's restricted SCC and the
    # full-width config's restricted, wide one.  One window = 2^20 candidates.
    timing = {}
    for label, text, lo_bits, hi in (
        ("snapshot", fixture_text("snapshot_broken.json"), None, 0),
        ("bench256_34", json.dumps(synth.benchmark_fbas(256, 34)), 30, 5),
    ):
        circuit, circuit_d, local, scc_mask, frozen = sweep_problem(text)
        lo_bits = len(local) - 1 if lo_bits is None else lo_bits
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(circuit.n, dtype=np.int32)
        for j, v in enumerate(local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        start = 0 if label == "snapshot" else 1 << 20  # a window with no early hit
        fused = FusedSweep(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device)
        plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device)
        hi_bits = mask_bits(hi_row)
        ms = time_ms(lambda: fused.program(start, 8, hi_bits), 50)
        plain_ms = time_ms(lambda: plain.program(start, 8, hi_row if hi_bits else None), 3)
        bound, bound_by, passes = window_bound_ms(circuit, circuit_d, lo_nodes, scc_mask, frozen,
                                                  start, hi_row if hi_bits else None, device)
        timing[label] = {"n": circuit.n, "units": circuit.n_units, "window": WINDOW, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                         "fixpoint_passes": passes, "candidates_per_s": WINDOW / ms * 1e3}
    phase_line("timing", card=card, per_window=timing)
    compare_launches = sweep_fused.launches - launches_before_compare

    # -- 5. main path ----------------------------------------------------
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.fbas.semantics import is_quorum
    from quorum_intersection_tpu_torch.pipeline import solve

    manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
    texts = {name: fixture_text(name) for name in manifest}
    # The CLI as a user runs it, one process per fixture, all at once.
    procs = {}
    for name, text in texts.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", PORT], cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    cli = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(texts[name], timeout=300)
            cli[name] = (out, err, proc.returncode)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # The end-to-end number a CLI user sees on a snapshot: one process alone,
    # from start (Python, torch, CUDA context, kernel load) to exit.
    t = time.perf_counter()
    alone = subprocess.run([sys.executable, "-m", PORT], cwd=ROOT, input=texts["snapshot_correct.json"],
                           capture_output=True, text=True, timeout=300)
    cli_seconds = time.perf_counter() - t
    if alone.returncode != 0 or alone.stdout.strip() != "true":
        fail("main", f"CLI alone on snapshot_correct.json: exit {alone.returncode} {alone.stderr[-400:]!r}")

    sweep_fused.launches = 0
    main_rows = []
    for name, text in texts.items():
        t = time.perf_counter()
        res = solve(text)
        seconds = time.perf_counter() - t
        want = manifest[name]["verdict"]
        out, err, code = cli[name]
        if res.intersects is not want:
            fail("main", f"{name}: solve says {res.intersects}, MANIFEST says {want}")
        if out.strip().splitlines()[-1:] != ["true" if want else "false"] or code != (0 if want else 1):
            fail("main", f"{name}: CLI printed {out[-40:]!r} exit {code}; stderr {err[-400:]!r}")
        if not want:
            graph = build_graph(parse_fbas(text))
            q1, q2 = res.q1 or [], res.q2 or []
            if not (is_quorum(graph, q1) and is_quorum(graph, q2) and not set(q1) & set(q2)):
                fail("main", f"{name}: witness pair is not two disjoint quorums")
        main_rows.append({"fixture": name, "verdict": res.intersects, "seconds": seconds,
                          "hit_index": res.stats.get("hit_index"),
                          "candidates": res.stats.get("candidates_checked")})

    # -- 6. full width ---------------------------------------------------
    full = []
    for broken in (False, True):
        data = synth.benchmark_fbas(256, 34, broken=broken)
        t = time.perf_counter()
        res = solve(data)
        seconds = time.perf_counter() - t
        if res.intersects is broken:
            fail("full", f"benchmark_fbas(256,34,broken={broken}) gave intersects={res.intersects}")
        if broken:
            graph = build_graph(parse_fbas(data))
            if not (is_quorum(graph, res.q1) and is_quorum(graph, res.q2)
                    and not set(res.q1) & set(res.q2)):
                fail("full", "broken twin's witness pair is not two disjoint quorums")
        full.append({"config": f"benchmark_fbas(256, core=34, broken={broken})",
                     "intersects": res.intersects, "seconds": seconds,
                     "candidates": res.stats["candidates_checked"],
                     "enumeration_total": res.stats["enumeration_total"],
                     "candidates_per_s": res.stats["candidates_checked"] / seconds,
                     "hit_index": res.stats.get("hit_index")})
    launches = sweep_fused.launches
    phase_line("main", fixtures=main_rows, cli="python -m " + PORT + ": 7/7 verdicts and exit codes",
               cli_snapshot_correct_seconds=cli_seconds)
    phase_line("full", card=card, runs=full)
    if launches < 1:
        fail("main", "the main path never launched sweep_fused_cuda")

    snap = timing["bench256_34"]
    record = {"kernels": [{
        "name": "sweep_fused_cuda",
        "route": kernels_meta["sweep_fused_cuda"]["route"],
        "source": kernels_meta["sweep_fused_cuda"]["source"],
        "replaces": kernels_meta["sweep_fused_cuda"]["replaces"],
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": snap["ms"],
        "plain_ms": snap["plain_ms"],
        "bound_ms": snap["bound_ms"],
        "bound_by": snap["bound_by"],
        "library_ms": None,
        "compare_launches": compare_launches,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
