"""The JAX frontier's results that ``tests/test_torch_frontier.py`` holds the
port to, pinned in ``tests/_torch_frontier_jax.json``: a live run of every
case through the JAX package's ``TpuFrontierBackend`` on the CPU takes about
35 s, past the port tests' time budget, so the test replays this file and
checks one case live against it.

Regenerate (from the repository root, JAX on the CPU):

    JAX_PLATFORMS=cpu python tests/_torch_frontier_pin.py
"""

from __future__ import annotations

import json
import pathlib
import sys

PIN = pathlib.Path(__file__).resolve().parent / "_torch_frontier_jax.json"

# The deterministic statistics both packages report, key for key.
STAT_KEYS = ("device_iters", "device_chunks", "states_popped", "flagged", "minimal_quorums", "host_checks",
             "device_flag_checks", "spills", "discarded_chunks", "padded_shape")

# name -> (generator, args, kwargs, backend kwargs, scope_to_scc).  The cases
# of tests/test_frontier.py's TestDifferential, TestArenaSpill,
# TestDeviceFlagFilter, TestDeterminism and TestRestrictedCheckpoint, the
# SCCs above the sweep's reach (63 lanes; 66 and 126 past the kernels'
# one-word states; 129, 180 and 255 past their two-word ones), and the JAX
# drive's pad_shapes=False.
CASES = {
    **{f"majority-{n}": ("majority_fbas", [n], {}, {"arena": 8192, "pop": 256}, False) for n in (7, 9, 11)},
    **{f"majority-{n}-broken": ("majority_fbas", [n], {"broken": True}, {"arena": 8192, "pop": 256}, False)
       for n in (8, 10, 12)},
    "hier-4x3": ("hierarchical_fbas", [4, 3], {}, {"arena": 8192, "pop": 256}, False),
    **{f"random-13-seed{seed}": ("random_fbas", [13], {"seed": seed}, {"arena": 8192, "pop": 256}, False)
       for seed in range(6)},
    "majority-10-broken-scoped": ("majority_fbas", [10], {"broken": True}, {"arena": 4096, "pop": 128}, True),
    "hier-4x3-spill": ("hierarchical_fbas", [4, 3], {}, {"arena": 64, "pop": 16}, False),
    "majority-12-broken-spill": ("majority_fbas", [12], {"broken": True}, {"arena": 128, "pop": 16}, False),
    "hier-5x3-device": ("hierarchical_fbas", [5, 3], {}, {"arena": 8192, "pop": 256, "flag_check": "device"},
                        False),
    "stellar-4x3-broken-device": ("stellar_like_fbas", [], {"n_core_orgs": 4, "per_org": 3, "n_watchers": 10,
                                                             "broken": True},
                                  {"arena": 8192, "pop": 256, "flag_check": "device"}, False),
    "hier-4x3-spill-device": ("hierarchical_fbas", [4, 3], {}, {"arena": 64, "pop": 16, "flag_check": "device"},
                              False),
    **{f"random-14-nested-seed{seed}-device": ("random_fbas", [14], {"seed": seed, "nested_prob": 0.3,
                                                                    "null_prob": 0.1},
                                               {"arena": 4096, "pop": 128, "flag_check": "device"}, False)
       for seed in range(4)},
    "majority-12-broken-pop128": ("majority_fbas", [12], {"broken": True}, {"arena": 2048, "pop": 128}, False),
    "bench-64-14-restricted": ("benchmark_fbas", [64, 14], {"seed": 1}, {"arena": 4096, "pop": 128}, False),
    "stellar-16x3-broken": ("stellar_like_fbas", [16, 3], {"broken": True}, {"arena": 8192, "pop": 256}, False),
    "stellar-21x3-broken": ("stellar_like_fbas", [21, 3], {"broken": True}, {"arena": 8192, "pop": 256}, False),
    # Past 64 lanes: 66 (padded to 96) and 126 (padded to 128, units 192).
    "stellar-22x3-broken": ("stellar_like_fbas", [22, 3], {"broken": True}, {"arena": 8192, "pop": 256}, False),
    "stellar-42x3-broken": ("stellar_like_fbas", [42, 3], {"broken": True}, {"arena": 8192, "pop": 256}, False),
    # Past 128 lanes: 129 (padded to 192), 180 (192) and 255 (256, units 384).
    **{f"stellar-{n}x3-broken": ("stellar_like_fbas", [n, 3], {"broken": True}, {"arena": 8192, "pop": 256}, False)
       for n in (43, 60, 85)},
    # pad_shapes=False: exact lane, node and unit counts, no padded_shape.
    "hier-5x3-unpadded": ("hierarchical_fbas", [5, 3], {}, {"arena": 8192, "pop": 256, "pad_shapes": False}, False),
    "stellar-22x3-broken-unpadded": ("stellar_like_fbas", [22, 3], {"broken": True},
                                     {"arena": 8192, "pop": 256, "pad_shapes": False}, False),
    "stellar-44x3-broken-unpadded": ("stellar_like_fbas", [44, 3], {"broken": True},
                                     {"arena": 8192, "pop": 256, "pad_shapes": False}, False),
}

# The case a test runs live through the JAX package, guarding this file.
LIVE_CASE = "hier-4x3-spill-device"


def case_data(name: str, synth) -> list:
    gen, args, kwargs, _, _ = CASES[name]
    return getattr(synth, gen)(*args, **kwargs)


def run_case(name: str, synth, parse_fbas, build_graph, encode_circuit, tarjan_scc, group_sccs, solve,
             backend) -> dict:
    """One case through either package (its modules passed in): the
    verdict, the witness pair and the deterministic statistics."""
    scoped = CASES[name][4]
    data = case_data(name, synth)
    if scoped:
        graph = build_graph(parse_fbas(data))
        count, comp = tarjan_scc(graph.n, graph.succ)
        scc = max(group_sccs(graph.n, comp, count), key=len)
        res = backend.check_scc(graph, encode_circuit(graph), scc, scope_to_scc=True)
    else:
        res = solve(data, backend=backend)
    return {"intersects": bool(res.intersects), "q1": res.q1, "q2": res.q2,
            "stats": {k: res.stats.get(k) for k in STAT_KEYS}}


def jax_result(name: str) -> dict:
    from quorum_intersection_tpu.backends.tpu.frontier import TpuFrontierBackend
    from quorum_intersection_tpu.encode.circuit import encode_circuit
    from quorum_intersection_tpu.fbas import synth
    from quorum_intersection_tpu.fbas.graph import build_graph, group_sccs, tarjan_scc
    from quorum_intersection_tpu.fbas.schema import parse_fbas
    from quorum_intersection_tpu.pipeline import solve

    return run_case(name, synth, parse_fbas, build_graph, encode_circuit, tarjan_scc, group_sccs, solve,
                    TpuFrontierBackend(**CASES[name][3]))


def main() -> int:
    sys.path.insert(0, str(PIN.parent.parent))
    pins = {name: jax_result(name) for name in CASES}
    PIN.write_text(json.dumps(pins, indent=1, sort_keys=True) + "\n")
    print(f"wrote {len(pins)} cases to {PIN}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
