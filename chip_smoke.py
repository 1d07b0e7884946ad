#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``quorum_intersection_tpu_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one NVIDIA card
    python3 chip_smoke.py --stress 400   # build, then only compare_packed's and compare_warp's repeats

Phases, one line each (any failure exits non-zero and prints no ``ok`` line):

1. device   — CUDA must be available; the card's name and power limit;
2. build    — the CUDA kernels, built from ``kernels/csrc`` with ``nvcc``
              (one process per source, all started together);
3. kernels  — the kernels this script launches and the TPU kernels they replace;
4. compare  — the fused kernel, both instances (tables resident in shared
              memory and streamed through it), against its plain PyTorch
              version on the card, on the same candidate windows (hits
              included): exact equality, since the result is an integer hit
              index.  On the fixtures' SCCs, the wide decode, multi-edge
              circuits, a 390-unit and a 1240-unit circuit (hits among its
              windows) and a 3000-unit one whose tables only stream;
   compare_warp — the fused kernel 32 times on each of four cases and the
              guard on each of two, both instances, each launch against the
              plain result (the warp cases of ``--stress N``);
   timing   — ms per 2^20-candidate window of the fused kernel at the
              snapshot's, the full-width and the 1240-unit shape, both
              instances, beside the plain version's ms and the bound;
5. main     — the verdict path through the entry points a user calls:
              ``solve`` on all seven vendored fixtures (launch counts reset
              before, read after; every ``false`` witness re-checked as two
              disjoint quorums) and ``python -m quorum_intersection_tpu_torch``
              on each fixture (verdict and exit code against MANIFEST.json);
6. full     — ``benchmark_fbas(256, core=34)``, correct and broken twins:
              2^33 candidates through SCC restriction and the wide decode;
              the correct twin once more under the profiler;
7. batch    — the batch path: ``check_many`` on 16 snapshot-shaped sources in
              one call, once with the default engine and once with
              ``engine="bitset"`` (launch counts reset before each run, read
              after).  Verdicts against MANIFEST.json or the generator's
              ``broken`` flag, every ``false`` witness re-checked, and every
              hit index equal to the unpacked ``solve`` of the same source.
              Each engine once more under the profiler: device busy and idle
              share, device ms per kernel;
   batch_units — ``check_many`` on ``inner_set_ring_fbas(30|24, 12)``, both
              variants, both engines: jobs whose lane-only window split would
              pass the packed kernels' 1024 units; packs within it, the
              unpacked ``solve``'s verdicts and hit indices;
8. compare_packed — the two packed kernels against their plain version,
              exact, on every
              pack the default batch run swept (the backend's ``pack_plans``:
              a depth-1 pack and windows with hits among them), a pack with
              vote counts up to 3, and two 1024-unit nested packs (the dense
              kernel's streamed instance on the densely nested one); 3000
              rows a program (a ragged last tile); then the dense kernel
              32 times on each of six cases (the odd packs, the streamed
              ones among them), each launch against the plain version;
   timing_packed  — ms per 2^20-row program of each packed kernel at the
              widest packed shape (the pack
              ``check_many`` forms for ``benchmark_fbas(256, core=31)`` alone:
              4 window groups) and at the shape of the batch's first pack,
              beside the plain version's ms and the bound (the dense
              kernel's time on these 0/1 packs is the u8 evaluator's time
              on the bitset kernel's function); ptxas's registers and spills
              per kernel instance;
9. prune    — block-guard pruning on the unpacked path: ``solve`` with
              ``GpuSweepBackend(prune=True)`` on the seven fixtures and on
              ``near_disjoint_cores(12, 1)`` and ``(15, 1)``, correct and
              broken (2^24 and 2^30 candidates; the widest enumeration the
              planner takes).  Verdicts, witnesses, every hit index equal to
              the unpruned ``solve``'s, and on ``true`` checked + pruned ==
              the enumeration; guard launches counted (reset before, read
              after);
10. batch_pruned — ``check_many`` with pruning, default and bitset engines,
              on the batch's 16 sources plus ``near_disjoint_cores(6, 1)`` at
              three seeds and ``(10, 1)`` correct and broken: the batch's
              checks, and each guard instance launched; then each engine once
              more under the profiler (the guards' device ms);
11. compare_guard — both guard encodings, each on both instances, against
              their plain version, exact, on the masks of every plan the two
              runs above built, a multi-edge circuit, a 390-unit and a
              1240-unit circuit (dense);
    timing_guard  — ms per 16384-row guard call at ``near_disjoint_cores(15,
              1)``'s and the snapshot's shape, both instances, beside the
              plain version's ms, the bound and the guard's share of the
              pruned ``solve``.

The line before the last is the kernels' JSON record (launches on the main
path of each, error against the plain version, times, bound, device ms on
the main path under the profiler, ptxas registers and spills per instance);
the last line
is ``{"ok": true, "device": {...}}``.
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
STRESS_REPEATS = 32  # launches per case of compare_packed's repeats
# The per-pack stats the batch phases print.
PACK_KEYS = ("pack_jobs", "pack_groups", "pack_slot", "pack_shape", "pack_fill_pct", "pack_engine",
             "pack_rows_dispatched", "pack_seconds")


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


def dense_child_circuit(n: int = 31, units: int = 993, seed: int = 7, quorum=(3, 5)):
    """A 31-node circuit whose units nest densely (a 1024-unit pack): every
    root and every unit of the upper inner level counts children spread over
    all inner units below it (depth 2), so the dense kernel's byte tables
    exceed one block and stream.  Each unit's threshold is the fraction
    ``quorum`` of its votes.  The card tests build the same circuit
    (``tests/_torch_circuits.py``; a CPU test holds the two equal)."""
    import numpy as np

    from quorum_intersection_tpu_torch.encode.circuit import Circuit

    rng = np.random.default_rng(seed)
    upper = n + (units - n) // 3
    members = (rng.random((units, n)) < 0.2).astype(np.uint8)
    members[np.arange(n), np.arange(n)] = 1
    child = np.zeros((units, units), dtype=np.uint8)
    child[:n, n:] = rng.random((n, units - n)) < 0.01
    child[n:upper, upper:] = rng.random((upper - n, units - upper)) < 0.01
    votes = members.sum(axis=1).astype(np.int64) + child.sum(axis=1)
    unit_depth = np.zeros(units, dtype=np.int32)
    unit_depth[n:upper] = child[n:upper].any(axis=1)
    unit_depth[:n] = np.where(child[:n].any(axis=1), 1 + unit_depth[n:upper].max(), 0)
    return Circuit(n=n, n_units=units, depth=2,
                   thresholds=(votes * quorum[0] // quorum[1]).astype(np.int32),
                   members=members, child=child, unit_depth=unit_depth)


def stress_packed(device, repeats: int):
    """The dense kernel launched ``repeats`` times on each case, the plain
    version recomputed beside every launch: a pack with vote counts up to 3,
    the resident 1024-unit ring pack and the two densely nested 1024-unit
    packs (thresholds 3/5 and 1/2 of the votes; the streamed instance) at
    the card tests' program shape (2 x 1000 rows from two start vectors in
    turn), and the densely nested packs also at 2 x 8192 rows (256 tiles)
    over four windows.  Per case: launches whose result differed from the
    plain one, from the kernel's own first result for that window, plain
    results that differed from the first plain one, group windows with a
    hit, and the kernel's mean ms a launch (CUDA events around it)."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.encode.circuit import (
        encode_circuit,
        pack_circuits,
        restrict_circuit_pair,
    )
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels.packed_cuda import PackedSweep
    from quorum_intersection_tpu_torch.kernels.packed_ref import PackedRef
    from quorum_intersection_tpu_torch.kernels.sweep_ref import INT32_MAX

    ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12))))
    packs = {
        "multi-plane (votes up to 3)": pack_circuits([(multi_edge_circuit(), None)] * 3),
        "inner_set_ring_fbas(30,12) x2": pack_circuits([restrict_circuit_pair(ring, list(range(ring.n)))] * 2),
        "densely nested 3/5": pack_circuits([(dense_child_circuit(), None)]),
        "densely nested 1/2": pack_circuits([(dense_child_circuit(quorum=(1, 2)), None)]),
    }
    cases = []
    for name, pk in packs.items():
        cases.append((f"{name}, 2000 rows", pk, 1000,
                      [np.zeros(pk.groups, dtype=np.int64), np.asarray([(1 << (s - 1)) // 3 for s in pk.sizes])]))
        if name.startswith("densely"):
            cases.append((f"{name}, 16384 rows", pk, 8192,
                          [np.asarray([s]) for s in (0, 1 << 28, (1 << 29) + 12345, (1 << 30) // 3)]))
    out = {}
    for label, pk, batch, windows in cases:
        tables = pk.decode_tables()
        kernel = PackedSweep(pk.circuit, pk.circuit_d, *tables, batch, engine="dense", device=device)
        plain = PackedRef(pk.circuit, pk.circuit_d, *tables, batch, "dense", device)
        first_kernel, first_plain = {}, {}
        vs_plain = vs_first = plain_moved = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        kernel_ms = 0.0
        for i in range(repeats):
            w = i % len(windows)
            start.record()
            launched = kernel.program(windows[w], 2)
            end.record()
            got = launched.cpu().numpy()
            kernel_ms += start.elapsed_time(end)
            want = plain.program(windows[w], 2).cpu().numpy()
            vs_plain += int(not np.array_equal(got, want))
            vs_first += int(not np.array_equal(got, first_kernel.setdefault(w, got)))
            plain_moved += int(not np.array_equal(want, first_plain.setdefault(w, want)))
        out[label] = {"streamed": kernel.tables.stream, "launches": repeats, "kernel_vs_plain": vs_plain,
                      "kernel_vs_its_first": vs_first, "plain_vs_its_first": plain_moved,
                      "group_windows_with_hits": sum(int((v != INT32_MAX).sum()) for v in first_plain.values()),
                      "kernel_ms_mean": kernel_ms / repeats}
    return out


def stress_warp(device, repeats: int):
    """The warp kernels launched ``repeats`` times on each case, each launch
    against the plain result of its window: the fused sweep on both
    instances at the full-width shape (a window with a hit) and on the
    1240-unit ring (resident and streamed), and the dense guard on that
    ring's 3000 rows, both instances.  Per case as ``stress_packed``."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
    from quorum_intersection_tpu_torch.kernels.guard_cuda import BlockGuard
    from quorum_intersection_tpu_torch.kernels.guard_ref import guard_counts
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import FusedSweep, mask_bits

    full = sweep_problem(json.dumps(synth.benchmark_fbas(256, 34, broken=True)))
    ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30, broken=True))))
    ring_problem = (ring, None, list(range(40)), np.ones(40, dtype=np.int32), None)
    cases = []  # (label, stream, launch(window) -> numpy, plain(window) -> numpy, windows)
    for name, (circuit, circuit_d, local, scc_mask, frozen), lo_bits, hi, starts in (
            ("full width broken", full, 30, 0, [0, (1 << 29) + 12345]),
            ("ring(40,30) broken, 1240 units", ring_problem, 20, 0x55555, [0, 400])):
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(circuit.n, dtype=np.int32)
        for j, v in enumerate(local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, 3000, circuit_d, device)
        for stream in (False, True):
            fused = FusedSweep(circuit, lo_nodes, scc_mask, frozen, 3000, circuit_d, device, stream=stream)
            cases.append((f"sweep {name}, {'streamed' if stream else 'resident'}", stream,
                          lambda st, f=fused, h=mask_bits(hi_row): f.program(st, 2, h).cpu().numpy(),
                          lambda st, pl=plain, h=hi_row: pl.program(st, 2, h if h.any() else None).cpu().numpy(),
                          starts))
    rng = np.random.default_rng(3)
    masks = [(rng.random((3000, ring.n)) < rng.random((3000, 1))).astype(np.int8) for _ in range(2)]
    for stream in (False, True):
        guard = BlockGuard(ring, "dense", device, stream=stream)
        cases.append((f"guard ring(40,30), {'streamed' if stream else 'resident'}", stream,
                      lambda w, gd=guard: gd.counts(masks[w]),
                      lambda w: guard_counts(ring, masks[w], "dense", device).cpu().numpy(), [0, 1]))
    out = {}
    for label, stream, launch, plain_of, windows in cases:
        want = {w: plain_of(w) for w in windows}
        first = {}
        vs_plain = vs_first = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ms = 0.0
        for i in range(repeats):
            w = windows[i % len(windows)]
            start.record()
            got = launch(w)
            end.record()
            end.synchronize()
            ms += start.elapsed_time(end)
            vs_plain += int(not np.array_equal(got, want[w]))
            vs_first += int(not np.array_equal(got, first.setdefault(w, got)))
        out[label] = {"streamed": stream, "launches": repeats, "kernel_vs_plain": vs_plain,
                      "kernel_vs_its_first": vs_first, "plain_vs_its_first": 0,
                      "windows_with_hits": sum(int(np.any(v != ref.INT32_MAX)) for v in want.values())
                      if label.startswith("sweep") else None,
                      "ms_mean": ms / repeats}
    return out


def stress_failed(cases) -> bool:
    return any(r["kernel_vs_plain"] or r["kernel_vs_its_first"] or r["plain_vs_its_first"]
               for r in cases.values())


def batch_sources(fixture_names):
    """The batch phase's 16 sources, ``(label, source, expected verdict)``:
    the vendored fixtures, snapshot-shaped stellar networks (a 21-node and a
    27-node org core with inner sets), the widest packable majority core
    (31 nodes, 2^30 candidates) and a nested 1024-node network — the shape
    of a queue of snapshot checks from validator operators or an explorer
    replaying history."""
    from quorum_intersection_tpu_torch.fbas import synth

    manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
    out = [(name, fixture_text(name), manifest[name]["verdict"]) for name in fixture_names]
    for seed in (0, 1):
        for broken in (False, True):
            out.append((f"stellar_like_fbas(7,3,seed={seed},broken={broken})",
                        synth.stellar_like_fbas(7, 3, seed=seed, broken=broken), not broken))
    for broken in (False, True):
        out.append((f"stellar_like_fbas(9,3,n_watchers=300,seed=2,broken={broken})",
                    synth.stellar_like_fbas(9, 3, n_watchers=300, seed=2, broken=broken), not broken))
    for broken in (False, True):
        out.append((f"benchmark_fbas(256,core=31,broken={broken})",
                    synth.benchmark_fbas(256, 31, broken=broken), not broken))
    out.append(("benchmark_fbas(1024,core=24,nested_watchers=True)",
                synth.benchmark_fbas(1024, 24, nested_watchers=True), True))
    return out


def macs_per_pass(circuit) -> int:
    """MACs one fixpoint pass needs: one per nonzero member vote, then one
    per nonzero child vote at each child pass (a zero vote adds nothing, and
    the kernels skip the all-zero k-slabs)."""
    import numpy as np

    depth = circuit.depth if circuit.n_units > circuit.n else 0
    return int(np.count_nonzero(circuit.members)) + depth * int(np.count_nonzero(circuit.child))


def fixpoint_work(circuit, circuit_d, lo_nodes, scc_mask, frozen, start, rows, hi_row, device):
    """The fixpoint passes one sweep over candidates ``start + [0, rows)``
    needs (Q for every row, the D probe for rows with Q != 0), counted by
    the plain version."""
    import torch

    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref

    tq = ref.CircuitTables(circuit, device)
    td = tq if circuit_d is None else ref.CircuitTables(circuit_d, device)
    pos = torch.from_numpy(ref.bit_positions(lo_nodes, circuit.n)).to(device)
    passes = 0
    chunk = min(1 << 17, rows)
    frozen_row = None if frozen is None else tq.cast(frozen)
    scc = tq.cast(scc_mask).to(torch.int32)
    for lo in range(start, start + rows, chunk):
        avail = ref.decode_masks(lo, chunk, pos, tq.dtype)
        if hi_row is not None:
            avail = torch.maximum(avail, tq.cast(hi_row))
        q, q_passes = ref.fixpoint_passes(tq, avail)
        has_q = q.sum(dim=1) > 0
        comp = torch.clamp(scc - q[has_q].to(torch.int32), 0, 1)
        passes += int(q_passes.sum()) + int(ref.fixpoint_passes(td, comp, frozen_row)[1].sum())
    return passes


def bound(macs: int, nbytes: int):
    """``(ms, bound_by)``: the int8 MACs at the tensor-core peak against
    the bytes at the memory rate, whichever takes longer."""
    ops_ms = 2 * macs / INT8_TOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def table_bytes(circuit) -> int:
    """A circuit's tables as the kernels read them: int8 members and
    children, Q and D thresholds in int32."""
    return circuit.members.size + circuit.child.size + 8 * circuit.n_units


def packed_bound_ms(plan, starts, rows, device):
    """Least time the card could take for one packed program of ``rows``
    rows from the per-group ``starts``.  The packed circuit is
    block-diagonal, so the function needs each lane group's own fixpoints
    on its own circuit, not the fused one: per group, its rows' passes
    (Q, and the D probe where that group's Q is not empty) times that
    group's MACs per pass, summed over the groups; against each group's
    tables read once and the (K,) int32 out.  A group's passes are counted
    on the fused circuit with every other group's lanes at 0, which the
    block-diagonal layout keeps at 0: the same count as on its own circuit,
    at a shape the plain version's int8 matmul takes on the card."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.kernels import packed_ref, sweep_ref as ref

    p = plan.packed
    pos, _, lane_group, group_ind = plan.tables
    tq = ref.CircuitTables(p.circuit, device)
    td = tq if p.circuit_d is None else ref.CircuitTables(p.circuit_d, device)
    pos_t = torch.from_numpy(pos).to(device)
    lanes = torch.from_numpy(np.asarray(lane_group, dtype=np.int64)).to(device)
    starts_t = torch.from_numpy(np.asarray(starts, dtype=np.int32)).to(device)
    chunk = min(1 << 17, rows)
    macs = nbytes = passes = 0
    for g, (circuit, _) in enumerate(plan.group_circuits):
        own = tq.cast(np.asarray(group_ind)[:, g] != 0)  # group g's real lanes
        g_passes = 0
        for lo in range(0, rows, chunk):
            avail = packed_ref.decode_masks_packed((starts_t + lo)[lanes], chunk, pos_t, tq.dtype) * own
            q, q_passes = ref.fixpoint_passes(tq, avail)
            probe = (own - q)[q.any(dim=1)]  # the group's lanes outside Q, where Q is not empty
            g_passes += int(q_passes.sum()) + int(ref.fixpoint_passes(td, probe)[1].sum())
        passes += g_passes
        macs += g_passes * macs_per_pass(circuit)
        nbytes += table_bytes(circuit)
    ms, by = bound(macs, nbytes + 4 * len(plan.group_circuits))
    return ms, by, passes


def guard_rows_of(circuit, bit_nodes, guard_rows: int):
    """The maximal candidates a pruned run's planner gave the guard,
    rebuilt from its row count (one row per block, 2^prefix_bits blocks):
    ``(masks, block_bits)``."""
    from quorum_intersection_tpu_torch.backends.sweep import guard_masks

    prefix_bits = guard_rows.bit_length() - 1
    block_bits = len(bit_nodes) - prefix_bits
    return guard_masks(circuit.n, bit_nodes, block_bits, prefix_bits), block_bits


def ptxas_instances(log: str):
    """``nvcc -Xptxas -v`` output → one record per kernel instance: its
    (demangled) name, registers, and spill stores and loads in bytes."""
    import re
    import shutil

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    names = list(out)
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        shown = subprocess.run([filt, *names], capture_output=True, text=True, timeout=60).stdout.splitlines()
    except OSError:
        shown = []
    if len(shown) != len(names):
        shown = names
    return [{"kernel": label, **out[name]} for name, label in zip(names, shown)
            if "kernel" in label and out[name]]


def device_ms_by_kernel(prof):
    """Device milliseconds per kernel name under a ``torch.profiler`` run."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / 1e3
    return out


def ms_of(by_kernel, *needles) -> float:
    return sum(ms for name, ms in by_kernel.items() if all(n in name for n in needles))


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
    """Least time the card could take for one window of the fused sweep:
    the MACs of the fixpoint passes its rows need, against the bytes
    (tables and decode table in, one int32 out)."""
    passes = fixpoint_work(circuit, circuit_d, lo_nodes, scc_mask, frozen, start, WINDOW, hi_row,
                           device)
    ms, by = bound(passes * macs_per_pass(circuit), table_bytes(circuit) + 4 * len(lo_nodes) + 4)
    return ms, by, passes


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke run of the PyTorch/CUDA port.")
    ap.add_argument("--stress", type=int, metavar="N", default=0,
                    help="only build, then launch the dense packed kernel N times on each of "
                         "compare_packed's repeated cases and the warp kernels N times on each of "
                         "compare_warp's (no ok line)")
    args = ap.parse_args(argv)
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
    ptxas = {name: ptxas_instances(b.log) for name, b in built.items()}
    phase_line("build", seconds=round(time.perf_counter() - t0, 3),
               libraries=[str(b.path.relative_to(ROOT)) for b in built.values()], ptxas=ptxas)
    if args.stress:
        t0 = time.perf_counter()
        cases = {**stress_packed(device, args.stress), **stress_warp(device, args.stress)}
        phase_line("stress", card=card, seconds=round(time.perf_counter() - t0, 3), cases=cases)
        return 1 if stress_failed(cases) else 0

    # -- 3. kernels ------------------------------------------------------
    kernels_meta = {
        "sweep_fused_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/sweep.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:119",
            "counterparts": "K1 pallas_sweep_program_factory (pallas_sweep.py:119, kernel :158); "
                            "K5 kernels.sweep_program_factory (kernels.py:305)",
        },
        "packed_sweep_dense_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/packed_sweep.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:343",
            "counterparts": "K3 pallas_packed_program_factory (pallas_sweep.py:343, kernel :404); "
                            "K7 kernels.packed_sweep_program_factory (kernels.py:445)",
        },
        "packed_sweep_bitset_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/packed_sweep.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:556",
            "counterparts": "K4 pallas_bitset_program_factory (pallas_sweep.py:556, kernel :622)",
        },
        "guard_dense_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/guard.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:257",
            "counterparts": "K2 pallas_guard_factory (pallas_sweep.py:257, kernel :285); "
                            "K6 kernels.guard_program_factory (kernels.py:359)",
        },
        "guard_bitset_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/guard.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:257",
            "counterparts": "K2 pallas_guard_factory (pallas_sweep.py:257); the guard half of K8, "
                            "kernels.bitset_guard_program_factory (kernels.py:722)",
        },
    }
    phase_line("kernels", kernels={k: v["counterparts"] for k, v in kernels_meta.items()})

    # -- 4. compare: kernel vs plain version on the card ------------------
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
        FusedSweep,
        KernelLimitError,
        mask_bits,
        sweep_fused,
    )

    def compare(label, circuit, circuit_d, local, scc_mask, frozen, lo_bits, his, starts,
                batch, steps):
        """Both instances of the fused kernel (tables resident and streamed;
        the resident one only where the tables fit) against the plain
        version on every hi row and start."""
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_nodes = local[1 + lo_bits:]
        kernels = {}
        for stream in (False, True):
            try:
                kernels[stream] = FusedSweep(circuit, lo_nodes, scc_mask, frozen, batch, circuit_d,
                                             device, stream=stream)
            except KernelLimitError:
                if stream:
                    raise
        plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, batch, circuit_d, device)
        hits = windows = 0
        max_err = 0
        for hi in his:
            hi_row = np.zeros(circuit.n, dtype=np.int32)
            for j, v in enumerate(hi_nodes):
                hi_row[v] = (hi >> j) & 1
            for start in starts:
                want = int(plain.program(start, steps, hi_row if hi_nodes else None))
                windows += 1
                hits += want != ref.INT32_MAX
                for stream, fused in kernels.items():
                    got = int(fused.program(start, steps, mask_bits(hi_row)))
                    torch.cuda.synchronize()
                    max_err = max(max_err, abs(got - want))
                    if got != want:
                        fail("compare", f"{label} (streamed={stream}) hi={hi} start={start}: "
                                        f"kernel {got} != plain {want}")
        natural = FusedSweep(circuit, lo_nodes, scc_mask, frozen, 1, circuit_d, device).tables
        return {"label": label, "n": circuit.n, "units": circuit.n_units, "depth": circuit.depth,
                "max_vote": int(max(circuit.members.max(), circuit.child.max(initial=0))),
                "restricted": circuit_d is not None, "lo_bits": lo_bits, "windows": windows,
                "windows_with_hits": hits, "max_abs_err": max_err,
                "instances": ["streamed" if s else "resident" for s in kernels],
                "chosen": "streamed" if natural.stream else "resident", "table_blocks": natural.nblocks}

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
    from quorum_intersection_tpu_torch.encode.circuit import encode_circuit

    for broken in (False, True):
        # 30 nodes, 390 units: a child satisfaction mask of 8 words.
        ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12, broken=broken))))
        results.append(compare(f"inner_set_ring_fbas(30,12,broken={broken}) U={ring.n_units}",
                               ring, None, list(range(ring.n)), np.ones(ring.n, dtype=np.int32), None,
                               ring.n - 1, [0], [0, 3 << 20, (1 << 29) - (1 << 15)], 1 << 14, 2))
    for broken in (False, True):
        # 40 nodes, 1240 units: past the 1024 units the first fused kernel
        # took.  20 low bits and an alternating hi row, as the CPU model test.
        ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30, broken=broken))))
        results.append(compare(f"inner_set_ring_fbas(40,30,broken={broken}) U={ring.n_units}",
                               ring, None, list(range(ring.n)), np.ones(ring.n, dtype=np.int32), None,
                               20, [0, sum(1 << j for j in range(0, 19, 2))],
                               [0, 400, (1 << 19) - 67, (1 << 20) - 3000], 3000, 2))
    # A circuit whose tables pass one block's shared memory: streamed only.
    huge = dense_child_circuit(n=40, units=3000)
    results.append(compare(f"densely nested n=40 U={huge.n_units}", huge, None, list(range(huge.n)),
                           np.ones(huge.n, dtype=np.int32), None, 30, [0, 123],
                           [0, 1 << 20, (1 << 30) - 6000], 3000, 2))
    max_abs_err = max(r["max_abs_err"] for r in results)
    wide = [r for r in results if r["units"] > 1024]
    if not any(r["windows_with_hits"] for r in wide) or not any(r["chosen"] == "streamed" for r in wide):
        fail("compare", "the circuits above 1024 units lack a window with a hit or a streamed choice")
    phase_line("compare", tolerance="exact (integer hit indices)", circuits=results)
    # The warp kernels again and again, each launch against the plain result.
    repeated_warp = stress_warp(device, STRESS_REPEATS)
    if stress_failed(repeated_warp):
        fail("compare", f"a repeated warp-kernel launch differed: {repeated_warp}")
    phase_line("compare_warp", repeated=repeated_warp)

    # Times on two main-path shapes: the snapshot's restricted SCC and the
    # full-width config's restricted, wide one, then the 1240-unit ring.
    # One window = 2^20 candidates; each shape on both instances.
    ring40 = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30))))
    shapes = {
        "snapshot": sweep_problem(fixture_text("snapshot_broken.json")) + (None, 0),
        "bench256_34": sweep_problem(json.dumps(synth.benchmark_fbas(256, 34))) + (30, 5),
        "ring40_30": (ring40, None, list(range(40)), np.ones(40, dtype=np.int32), None, 30, 0),
    }
    timing = {}
    for label, (circuit, circuit_d, local, scc_mask, frozen, lo_bits, hi) in shapes.items():
        lo_bits = len(local) - 1 if lo_bits is None else lo_bits
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(circuit.n, dtype=np.int32)
        for j, v in enumerate(local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        start = 0 if label == "snapshot" else 1 << 20  # a window with no early hit
        plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device)
        hi_bits = mask_bits(hi_row)
        plain_ms = time_ms(lambda: plain.program(start, 8, hi_row if hi_bits else None), 3)
        bound_ms, bound_by, passes = window_bound_ms(circuit, circuit_d, lo_nodes, scc_mask, frozen,
                                                     start, hi_row if hi_bits else None, device)
        for stream in (False, True):
            fused = FusedSweep(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device,
                               stream=stream)
            ms = time_ms(lambda: fused.program(start, 8, hi_bits), 20 if label == "ring40_30" else 50)
            timing[f"{label}/streamed" if stream else label] = {"n": circuit.n, "units": circuit.n_units, "depth": circuit.depth,
                           "window": WINDOW, "instance": "streamed" if stream else "resident",
                           "table_blocks": fused.tables.nblocks, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "fixpoint_passes": passes,
                           "candidates_per_s": WINDOW / ms * 1e3}
    phase_line("timing", card=card, per_window=timing, ptxas=ptxas.get("sweep"))
    compare_launches = sweep_fused.launches - launches_before_compare

    # -- 5. main path ----------------------------------------------------
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
    # The correct twin once more under the profiler: the fused kernel's
    # device time on the main path.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        solve(synth.benchmark_fbas(256, 34))
        torch.cuda.synchronize()
    full_device_ms = device_ms_by_kernel(prof)
    phase_line("main", fixtures=main_rows, cli="python -m " + PORT + ": 7/7 verdicts and exit codes",
               cli_snapshot_correct_seconds=cli_seconds)
    phase_line("full", card=card, runs=full)
    if launches < 1:
        fail("main", "the main path never launched sweep_fused_cuda")

    # -- 7. batch path ---------------------------------------------------
    def witness_ok(src, res) -> bool:
        graph = build_graph(parse_fbas(src))
        q1, q2 = res.q1 or [], res.q2 or []
        return is_quorum(graph, q1) and is_quorum(graph, q2) and not set(q1) & set(q2)

    from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
    from quorum_intersection_tpu_torch.encode.circuit import bitset_supported
    from quorum_intersection_tpu_torch.kernels.packed_cuda import (
        PackedSweep,
        packed_sweep_bitset,
        packed_sweep_dense,
    )
    from quorum_intersection_tpu_torch.kernels.packed_ref import PackedRef
    from quorum_intersection_tpu_torch.pipeline import check_many

    sources = batch_sources(list(manifest))
    batch_runs, batch_results, batch_launches = {}, {}, {}
    for engine, kernel_name in ((None, "packed_sweep_dense_cuda"), ("bitset", "packed_sweep_bitset_cuda")):
        label = engine or "default"
        backend = GpuSweepBackend(engine=engine)
        sweep_fused.launches = packed_sweep_dense.launches = packed_sweep_bitset.launches = 0
        t = time.perf_counter()
        res = check_many([src for _, src, _ in sources], backend=backend)
        seconds = time.perf_counter() - t
        counts = {"sweep_fused_cuda": sweep_fused.launches,
                  "packed_sweep_dense_cuda": packed_sweep_dense.launches,
                  "packed_sweep_bitset_cuda": packed_sweep_bitset.launches}
        if counts[kernel_name] < 1:
            fail("batch", f"check_many (engine={label}) never launched {kernel_name}")
        batch_launches[kernel_name] = counts[kernel_name]
        for (name, src, want), r in zip(sources, res):
            if r.intersects is not want:
                fail("batch", f"{name} (engine={label}): intersects={r.intersects}, expected {want}")
            if not want:
                graph = build_graph(parse_fbas(src))
                q1, q2 = r.q1 or [], r.q2 or []
                if not (is_quorum(graph, q1) and is_quorum(graph, q2) and not set(q1) & set(q2)):
                    fail("batch", f"{name} (engine={label}): witness pair is not two disjoint quorums")
        candidates = sum(r.stats.get("candidates_checked", 0) for r in res)
        batch_results[label] = res
        if label == "default":
            plans = backend.pack_plans  # the packs this run swept, compared below
        # Each pack as the drive's own stats report it, in the order it ran.
        packs = {r.stats["pack_index"]: r.stats for r in res if r.stats.get("packed")}
        batch_runs[label] = {
            "seconds": seconds, "sources": len(sources), "packs": len(packs),
            "per_pack": [{key: s[key] for key in PACK_KEYS} for _, s in sorted(packs.items())],
            "candidates": candidates, "candidates_per_s": candidates / seconds, "launches": counts,
        }
    # One more run of each engine under the profiler: the card's busy time
    # (the sum of its kernels' times) against the run's wall time, and each
    # kernel's device time on the batch path.
    batch_device_ms = {}
    for engine in (None, "bitset"):
        label = engine or "default"
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            check_many([src for _, src, _ in sources], backend=GpuSweepBackend(engine=engine))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        by_kernel = batch_device_ms[label] = device_ms_by_kernel(prof)
        busy_ms = sum(by_kernel.values())
        batch_runs[f"profiled_{label}"] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured (no device events)",
            "device_ms_by_kernel": {k: v for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]},
        }
    # Every hit index equals the unpacked drive's (the fused kernel's path).
    solo_results = {}
    for i, (name, src, _) in enumerate(sources):
        solo = solo_results[name] = solve(src)
        for label, res in batch_results.items():
            got, want = res[i].stats.get("hit_index"), solo.stats.get("hit_index")
            if (res[i].intersects, got) != (solo.intersects, want):
                fail("batch", f"{name} (engine={label}): hit index {got} != unpacked solve's {want}")
    phase_line("batch", card=card, runs=batch_runs,
               hit_index_vs_unpacked_solve=f"{len(sources)}/{len(sources)} equal on both engines")

    # Jobs whose window split would pass the packed kernels' 1024 units
    # (the JAX drive plans 4 and 5 windows, 1568 and 1560 fused units):
    # check_many plans packs within it, with the unpacked solve's answers.
    ring_sources = [(f"inner_set_ring_fbas({n},12,broken={b})", synth.inner_set_ring_fbas(n, 12, broken=b))
                    for n in (30, 24) for b in (False, True)]
    unit_runs = {}
    for engine in (None, "bitset"):
        label = engine or "default"
        backend = GpuSweepBackend(engine=engine)
        t = time.perf_counter()
        res = check_many([src for _, src in ring_sources], backend=backend)
        seconds = time.perf_counter() - t
        for (name, src), r in zip(ring_sources, res):
            solo = solo_results.setdefault(name, solve(src))
            if not r.intersects and not witness_ok(src, r):
                fail("batch_units", f"{name} (engine={label}): witness pair is not two disjoint quorums")
            if (r.intersects, r.stats.get("hit_index")) != (solo.intersects, solo.stats.get("hit_index")):
                fail("batch_units", f"{name} (engine={label}): hit index {r.stats.get('hit_index')} != "
                                    f"unpacked solve's {solo.stats.get('hit_index')}")
        unit_runs[label] = {
            "seconds": seconds,
            "packs": [{"groups": pl.packed.groups, "shape": [pl.packed.circuit.n, pl.packed.circuit.n_units]}
                      for pl in backend.pack_plans],
            "verdicts": {name: r.intersects for (name, _), r in zip(ring_sources, res)},
            "hit_index": {name: r.stats.get("hit_index") for (name, _), r in zip(ring_sources, res)}}
    phase_line("batch_units", card=card, runs=unit_runs,
               hit_index_vs_unpacked_solve=f"{len(ring_sources)}/{len(ring_sources)} equal on both engines")

    # -- 8. the packed kernels against their plain versions ---------------
    # On every pack the default batch run swept (a depth-1 pack and windows
    # with hits among them), a pack with vote counts up to 3 (dense only)
    # and two 1024-unit nested packs (the dense kernel's tables resident in
    # one, streamed in the densely nested other), with both kernels where
    # the circuit allows.  3000 rows per program: a ragged last tile.
    from quorum_intersection_tpu_torch.encode.circuit import pack_circuits, restrict_circuit_pair

    cmp_batch = 1500
    cmp_cases = []
    for pi, plan in enumerate(plans):
        los = np.asarray([g.lo for g in plan.groups], dtype=np.int64)
        his = np.asarray([g.hi for g in plan.groups], dtype=np.int64)
        cmp_cases.append((f"batch pack {pi}", plan.packed, plan.tables,
                          (los, los + (1 << 16), np.maximum(his - 2 * cmp_batch, 0))))
    me = multi_edge_circuit()
    multi = pack_circuits([(me, None)] * 3)
    cmp_cases.append(("multi-plane (votes up to 3)", multi, multi.decode_tables(),
                      (np.zeros(3, dtype=np.int64), np.asarray([100, 900, 2000]))))
    ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12))))
    big = pack_circuits([restrict_circuit_pair(ring, list(range(ring.n)))] * 2)
    cmp_cases.append(("inner_set_ring_fbas(30,12) x2, 1024 units", big, big.decode_tables(),
                      (np.asarray([0, 3 << 20]), np.asarray([1 << 28, (1 << 29) - 5000]))))
    dense = pack_circuits([(dense_child_circuit(), None)])
    cmp_cases.append(("densely nested, 1024 units", dense, dense.decode_tables(),
                      (np.asarray([0]), np.asarray([(1 << 29) + 12345]))))
    packed_err = {"dense": 0, "bitset": 0}
    packed_results = []
    for label, pk, tables, windows in cmp_cases:
        for engine in ("dense", "bitset") if bitset_supported(pk.circuit) else ("dense",):
            kernel = PackedSweep(pk.circuit, pk.circuit_d, *tables, cmp_batch, engine=engine,
                                 device=device)
            plain = PackedRef(pk.circuit, pk.circuit_d, *tables, cmp_batch, engine, device)
            hits = 0
            for starts in windows:
                got = kernel.program(starts, 2).cpu().numpy()
                want = plain.program(starts, 2).cpu().numpy()
                torch.cuda.synchronize()
                hits += int((want != ref.INT32_MAX).sum())
                err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
                packed_err[engine] = max(packed_err[engine], err)
                if err:
                    fail("compare", f"{label} {engine} starts={list(starts)}: "
                                    f"kernel {got.tolist()} != plain {want.tolist()}")
            packed_results.append({"pack": label, "engine": engine, "route": kernel.tables.route,
                                   "streamed": kernel.tables.stream, "groups": pk.groups,
                                   "slot": pk.slot, "lanes": pk.circuit.n, "units": pk.circuit.n_units,
                                   "depth": pk.circuit.depth, "max_vote": int(pk.circuit.members.max()),
                                   "windows": len(windows) * pk.groups, "group_windows_with_hits": hits})
    if (not any(r["depth"] == 1 for r in packed_results)
            or not any(r["group_windows_with_hits"] for r in packed_results)
            or not any(r["streamed"] for r in packed_results)
            or not any(r["max_vote"] > 1 for r in packed_results)):
        fail("compare", "the packed comparison lacks a depth-1, a streamed or a multi-plane pack, "
                        "or a window with hits")
    # The dense kernel again and again on the odd packs: a fault in the
    # sharing of shared memory between a block's warps is intermittent.
    repeated = stress_packed(device, STRESS_REPEATS)
    if stress_failed(repeated):
        fail("compare", f"a repeated packed launch differed: {repeated}")
    phase_line("compare_packed", tolerance="exact (integer hit indices, per group)",
               rows_per_program=2 * cmp_batch, packs=packed_results, repeated=repeated)

    # The packed kernels at the widest packed shape: one 31-node job split
    # over 4 window groups (n = 128 lanes, slot 32), each group decoding 2^20
    # candidates of its own window per program; the pack is the one
    # check_many itself forms for that job.  Also at the shape of the batch's
    # first pack (the lockstep one of §5), kernels only.
    wide_backend = GpuSweepBackend()
    wide_res = check_many([synth.benchmark_fbas(256, 31)], backend=wide_backend)
    if wide_res[0].intersects is not True:
        fail("timing", "benchmark_fbas(256, core=31) alone did not intersect")
    shapes = {"widest": wide_backend.pack_plans[0], "batch_pack_0": plans[0]}
    wp = shapes["widest"].packed
    if (wp.groups, wp.slot, wp.circuit.n) != (4, 32, 128):
        fail("timing", f"widest pack is {wp.groups} groups of slot {wp.slot} over {wp.circuit.n} lanes")
    packed_timing = {}
    for shape, plan in shapes.items():
        pk = plan.packed
        starts = np.asarray([g.lo + WINDOW for g in plan.groups], dtype=np.int64)
        bound_ms, bound_by, passes = packed_bound_ms(plan, starts, WINDOW, device)
        plain_ms = {}
        for engine in ("dense", "bitset"):
            kernel = PackedSweep(pk.circuit, pk.circuit_d, *plan.tables, 1 << 17, engine=engine,
                                 device=device)
            ms = time_ms(lambda: kernel.program(starts, 8), 20)
            plain = PackedRef(pk.circuit, pk.circuit_d, *plan.tables, 1 << 17, engine, device)
            plain_ms[engine] = time_ms(lambda: plain.program(starts, 8), 2)
            t = kernel.tables
            packed_timing[f"{shape}/{engine}"] = {
                "groups": pk.groups, "lanes": pk.circuit.n, "units": pk.circuit.n_units,
                "depth": pk.circuit.depth, "route": t.route, "streamed": t.stream, "rows": WINDOW,
                "ms": ms, "plain_ms": plain_ms[engine], "bound_ms": bound_ms, "bound_by": bound_by,
                "fixpoint_passes": passes, "candidates_per_s": pk.groups * WINDOW / ms * 1e3}
    phase_line("timing_packed", card=card, per_program=packed_timing, ptxas=ptxas.get("packed_sweep"))

    # -- 9. prune: block-guard pruning on the unpacked path ----------------
    from quorum_intersection_tpu_torch.backends.sweep import _PrunePlan, guard_masks
    from quorum_intersection_tpu_torch.kernels.guard_cuda import BlockGuard, guard_bitset, guard_dense
    from quorum_intersection_tpu_torch.kernels.guard_ref import guard_counts

    def ledger_ok(stats) -> bool:
        """On a swept ``true``: every window checked, pruned or skipped."""
        if "enumeration_total" not in stats:
            return True  # decided by the SCC guard, no sweep
        return (stats["candidates_checked"] + stats.get("windows_pruned_guard", 0)
                + stats.get("windows_skipped_pack_fill", 0)) == stats["enumeration_total"]

    def guard_counts_now():
        return {"guard_dense_cuda": guard_dense.launches, "guard_bitset_cuda": guard_bitset.launches,
                "sweep_fused_cuda": sweep_fused.launches,
                "packed_sweep_dense_cuda": packed_sweep_dense.launches,
                "packed_sweep_bitset_cuda": packed_sweep_bitset.launches}

    def reset_counts():
        guard_dense.launches = guard_bitset.launches = sweep_fused.launches = 0
        packed_sweep_dense.launches = packed_sweep_bitset.launches = 0

    prune_sources = [(name, texts[name], manifest[name]["verdict"]) for name in manifest]
    for core in (12, 15):
        for broken in (False, True):
            prune_sources.append((f"near_disjoint_cores({core},1,broken={broken})",
                                  synth.near_disjoint_cores(core, 1, broken=broken), not broken))
    unpruned = {}
    for label, src, _ in prune_sources:
        t = time.perf_counter()
        unpruned[label] = (solve(src, backend=GpuSweepBackend(prune=False)), time.perf_counter() - t)
    # (label, circuit, masks, pruned prefixes) of every plan the two pruned
    # runs build; compare_guard holds the rebuilt masks to the run's prefixes.
    guard_plans = []
    prune_rows, prune_seconds, prune_guard = [], {}, {}
    reset_counts()
    for label, src, want in prune_sources:
        backend = GpuSweepBackend(prune=True)
        t = time.perf_counter()
        res = solve(src, backend=backend)
        seconds = prune_seconds[label] = time.perf_counter() - t
        base, base_seconds = unpruned[label]
        if res.intersects is not want:
            fail("prune", f"{label}: pruned solve says {res.intersects}, expected {want}")
        if not want and not witness_ok(src, res):
            fail("prune", f"{label}: witness pair is not two disjoint quorums")
        if (res.intersects, res.stats.get("hit_index"), res.q1, res.q2) != (
                base.intersects, base.stats.get("hit_index"), base.q1, base.q2):
            fail("prune", f"{label}: pruned hit index {res.stats.get('hit_index')} != unpruned "
                          f"{base.stats.get('hit_index')}")
        if res.intersects and not ledger_ok(res.stats):
            fail("prune", f"{label}: checked + pruned != enumeration ({res.stats})")
        ranges = None
        if "guard_rows" in res.stats:
            circuit, _, local, _, _ = sweep_problem(src)
            masks, k = guard_rows_of(circuit, local[1:], res.stats["guard_rows"])
            prefixes = res.stats.get("pruned_blocks", {}).get("prefixes", [])
            guard_plans.append((label, circuit, masks, prefixes))
            prune_guard[label] = (circuit, masks, res.stats["guard_seconds"])
            ranges = len(_PrunePlan.build(k, prefixes, res.stats["enumeration_total"], 0, len(masks)).ranges)
        prune_rows.append({
            "source": label, "verdict": res.intersects, "hit_index": res.stats.get("hit_index"),
            "seconds_pruned": seconds, "seconds_unpruned": base_seconds,
            "enumeration_total": res.stats.get("enumeration_total"),
            "windows_pruned": res.stats.get("windows_pruned_guard"),
            "guard_rows": res.stats.get("guard_rows"), "guard_seconds": res.stats.get("guard_seconds"),
            "surviving_ranges": ranges,
            "programs_pruned": res.stats.get("device_steps"),
            "programs_unpruned": base.stats.get("device_steps"),
        })
    prune_launches = guard_counts_now()
    if prune_launches["guard_dense_cuda"] < 1:
        fail("prune", "the pruned solves never launched guard_dense_cuda")
    phase_line("prune", card=card, launches=prune_launches, sources=prune_rows,
               hit_index_vs_unpruned_solve=f"{len(prune_rows)}/{len(prune_rows)} equal")

    # -- 10. batch_pruned: block-guard pruning on the packed path ----------
    pruned_batch = list(sources)
    pruned_batch += [(f"near_disjoint_cores(6,1,seed={seed})", synth.near_disjoint_cores(6, 1, seed=seed),
                      True) for seed in range(3)]
    pruned_batch += [(f"near_disjoint_cores(10,1,broken={broken})",
                      synth.near_disjoint_cores(10, 1, broken=broken), not broken) for broken in (False, True)]
    for name, src, _ in pruned_batch:
        if name not in solo_results:
            solo_results[name] = solve(src)
    batch_pruned_runs, batch_pruned_launches, pruned_device_ms = {}, {}, {}
    for engine, guard_name in ((None, "guard_dense_cuda"), ("bitset", "guard_bitset_cuda")):
        label = engine or "default"
        backend = GpuSweepBackend(prune=True, engine=engine)
        reset_counts()
        t = time.perf_counter()
        res = check_many([src for _, src, _ in pruned_batch], backend=backend)
        seconds = time.perf_counter() - t
        counts = guard_counts_now()
        if counts[guard_name] < 1:
            fail("batch_pruned", f"check_many (engine={label}) never launched {guard_name}")
        batch_pruned_launches[guard_name] = counts[guard_name]
        for (name, src, want), r in zip(pruned_batch, res):
            solo = solo_results[name]
            if r.intersects is not want:
                fail("batch_pruned", f"{name} (engine={label}): intersects={r.intersects}, expected {want}")
            if not want and not witness_ok(src, r):
                fail("batch_pruned", f"{name} (engine={label}): witness pair is not two disjoint quorums")
            if (r.intersects, r.stats.get("hit_index")) != (solo.intersects, solo.stats.get("hit_index")):
                fail("batch_pruned", f"{name} (engine={label}): hit index {r.stats.get('hit_index')} != "
                                     f"unpruned solve's {solo.stats.get('hit_index')}")
            if r.intersects and not ledger_ok(r.stats):
                fail("batch_pruned", f"{name} (engine={label}): checked + pruned + skipped != enumeration")
        for pi, plan in enumerate(backend.pack_plans):
            for jix, p in enumerate(plan.prune_plans):
                if p is not None:
                    gix = next(i for i, g in enumerate(plan.groups) if g.job == jix)
                    c = plan.group_circuits[gix][0]
                    masks, _ = guard_rows_of(c, np.arange(1, c.n), p.guard_rows)
                    guard_plans.append((f"batch {label} pack {pi} job {jix}", c, masks, p.prefixes))
        packs = {r.stats["pack_index"]: r.stats for r in res if r.stats.get("packed")}
        batch_pruned_runs[label] = {
            "seconds": seconds, "sources": len(pruned_batch), "packs": len(packs),
            "per_pack": [{key: s.get(key) for key in PACK_KEYS} for _, s in sorted(packs.items())],
            "windows_pruned": sum(r.stats.get("windows_pruned_guard", 0) for r in res),
            "candidates": sum(r.stats.get("candidates_checked", 0) for r in res), "launches": counts,
        }
    # Each engine once more under the profiler: the guards' device time.
    for engine in (None, "bitset"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            check_many([src for _, src, _ in pruned_batch], backend=GpuSweepBackend(prune=True, engine=engine))
            torch.cuda.synchronize()
        pruned_device_ms[engine or "default"] = device_ms_by_kernel(prof)
    phase_line("batch_pruned", card=card, runs=batch_pruned_runs,
               device_ms_by_kernel={k: {n: ms for n, ms in v.items() if "_kernel" in n}
                                    for k, v in pruned_device_ms.items()},
               unpruned_batch_seconds={k: batch_runs[k]["seconds"] for k in ("default", "bitset")},
               hit_index_vs_unpruned_solve=f"{len(pruned_batch)}/{len(pruned_batch)} equal on both engines")

    # -- 11. the guard instances against their plain version ---------------
    cases = {}  # one case per distinct (circuit, masks), with every plan that used it
    for label, c, masks, prefixes in guard_plans:
        key = (c.n, c.n_units, c.thresholds.tobytes(), c.members.tobytes(), c.child.tobytes(),
               masks.tobytes())
        encodings = ("dense", "bitset") if bitset_supported(c) else ("dense",)
        cases.setdefault(key, (label, c, masks, encodings, []))[4].append((label, prefixes))
    for label, c in (("multi-edge", multi_edge_circuit()),
                     ("inner_set_ring_fbas(30,12)",
                      encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12))))),
                     ("inner_set_ring_fbas(40,30), 1240 units",
                      encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30)))))):
        bits = c.n - 1
        prefix = min(14, bits - 2)
        cases[label] = (label, c, guard_masks(c.n, np.arange(1, c.n), bits - prefix, prefix), ("dense",), [])
    guard_err = {"dense": 0, "bitset": 0}
    zero_rows = positive_rows = 0
    guard_results = []
    for label, c, masks, encodings, runs in cases.values():
        for enc in encodings:
            want = guard_counts(c, masks, enc, device).cpu().numpy()
            for stream in (False, True):  # both instances: tables resident and streamed
                got = BlockGuard(c, enc, device, stream=stream).counts(masks)
                err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0))
                guard_err[enc] = max(guard_err[enc], err)
                if err or got.shape != want.shape:
                    fail("compare_guard", f"{label} {enc} (streamed={stream}): kernel differs from plain "
                                          f"(max err {err})")
        for run, prefixes in runs:
            if np.nonzero(want == 0)[0].tolist() != list(prefixes):
                fail("compare_guard", f"{run}: the rebuilt guard rows do not give the run's pruned blocks")
        zero_rows += int((want == 0).sum())
        positive_rows += int((want > 0).sum())
        guard_results.append({"case": label, "n": c.n, "units": c.n_units, "depth": c.depth,
                              "rows": len(masks), "encodings": list(encodings),
                              "instances": ["resident", "streamed"],
                              "rows_pruned": int((want == 0).sum())})
    if not zero_rows or not positive_rows:
        fail("compare_guard", f"compared rows lack a zero ({zero_rows}) or a positive ({positive_rows}) count")
    phase_line("compare_guard", tolerance="exact (integer survivor counts)", cases=guard_results,
               rows_zero=zero_rows, rows_positive=positive_rows)

    # 16384-row guard calls at the widest pruned shape and the snapshot's.
    guard_timing = {}
    for shape, label in (("near_disjoint_cores(15,1)", "near_disjoint_cores(15,1,broken=False)"),
                         ("snapshot", "snapshot_correct.json")):
        c, masks, plan_seconds = prune_guard[label]
        tables = ref.CircuitTables(c, device)
        passes = int(ref.fixpoint_passes(tables, tables.cast(masks))[1].sum())
        # Tables once (int8 votes, Q thresholds in int32); per row, the
        # candidate's n-1 enumerated node bits in (scc[0] is in no mask)
        # and one int32 count out.
        nbytes = c.members.size + c.child.size + 4 * c.n_units + (-(-(c.n - 1) // 8) + 4) * len(masks)
        bound_ms, bound_by = bound(passes * macs_per_pass(c), nbytes)
        for enc in ("dense", "bitset") if bitset_supported(c) else ("dense",):
            guard = BlockGuard(c, enc, device)
            words = guard.upload(masks)
            launch = guard_dense if enc == "dense" else guard_bitset
            guard_timing[f"{shape}/{enc}"] = {
                "n": c.n, "units": c.n_units, "depth": c.depth, "rows": len(masks),
                "ms": time_ms(lambda: launch(guard, words), 50),
                "call_ms": time_ms(lambda: guard.counts(masks), 20),
                "plain_ms": time_ms(lambda: guard_counts(c, masks, enc, device), 3),
                "bound_ms": bound_ms, "bound_by": bound_by, "fixpoint_passes": passes,
                "plan_seconds": plan_seconds, "pruned_solve_seconds": prune_seconds[label],
                "guard_share_of_pruned_solve": plan_seconds / prune_seconds[label],
            }
    phase_line("timing_guard", card=card, per_call=guard_timing)

    # Each kernel's device time on the main path (profiler): K1 in the
    # full-width solve, K3 in the default-engine batch, K4 in the bitset
    # batch, the guards in the pruned batches of their engine.
    main_device_ms = {
        "sweep_fused_cuda": ms_of(full_device_ms, "sweep_kernel"),
        "packed_sweep_dense_cuda": ms_of(batch_device_ms["default"], "packed_kernel"),
        "packed_sweep_bitset_cuda": ms_of(batch_device_ms["bitset"], "packed_kernel"),
        "guard_dense_cuda": ms_of(pruned_device_ms["default"], "guard_kernel"),
        "guard_bitset_cuda": ms_of(pruned_device_ms["bitset"], "guard_kernel"),
    }
    main_device_ms_of = {
        "sweep_fused_cuda": "full, benchmark_fbas(256, core=34)",
        "packed_sweep_dense_cuda": "batch, default engine",
        "packed_sweep_bitset_cuda": "batch, bitset engine",
        "guard_dense_cuda": "batch_pruned, default engine",
        "guard_bitset_cuda": "batch_pruned, bitset engine (both encodings' guards run one kernel)",
    }
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
        "main_path_device_ms": main_device_ms["sweep_fused_cuda"],
        "main_path_device_ms_of": main_device_ms_of["sweep_fused_cuda"],
        "compare_launches": compare_launches,
    }]}
    for engine, name in (("dense", "packed_sweep_dense_cuda"), ("bitset", "packed_sweep_bitset_cuda")):
        pt = packed_timing[f"widest/{engine}"]
        record["kernels"].append({
            "name": name,
            "route": kernels_meta[name]["route"],
            "source": kernels_meta[name]["source"],
            "replaces": kernels_meta[name]["replaces"],
            "launches": batch_launches[name],
            "max_abs_err": packed_err[engine],
            "ms": pt["ms"],
            "plain_ms": pt["plain_ms"],
            "bound_ms": pt["bound_ms"],
            "bound_by": pt["bound_by"],
            "library_ms": None,
            "main_path_device_ms": main_device_ms[name],
            "main_path_device_ms_of": main_device_ms_of[name],
        })
    for enc, name in (("dense", "guard_dense_cuda"), ("bitset", "guard_bitset_cuda")):
        gt = guard_timing[f"near_disjoint_cores(15,1)/{enc}"]
        record["kernels"].append({
            "name": name,
            "route": kernels_meta[name]["route"],
            "source": kernels_meta[name]["source"],
            "replaces": kernels_meta[name]["replaces"],
            "launches": prune_launches[name] if enc == "dense" else batch_pruned_launches[name],
            "max_abs_err": guard_err[enc],
            "ms": gt["ms"],
            "plain_ms": gt["plain_ms"],
            "bound_ms": gt["bound_ms"],
            "bound_by": gt["bound_by"],
            "library_ms": None,
            "main_path_device_ms": main_device_ms[name],
            "main_path_device_ms_of": main_device_ms_of[name],
        })
    # Each kernel's instances as ptxas built them: registers and spills.
    library_of = {"sweep_fused_cuda": "sweep", "packed_sweep_dense_cuda": "packed_sweep",
                  "packed_sweep_bitset_cuda": "packed_sweep", "guard_dense_cuda": "guard",
                  "guard_bitset_cuda": "guard"}
    for entry in record["kernels"]:
        entry["instances"] = ptxas.get(library_of[entry["name"]])
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
