"""Worker half of ``tests/test_torch_distributed.py`` (not a test module;
started as a subprocess): joins the port's multi-process runtime over gloo
through a localhost coordinator, builds the global candidate mesh of its 4
CPU ranks, and runs the sharded sweep on a correct and a broken majority
network and on the restricted wide graph, then the frontier under the same
mesh (the JAX ``tests/_dist_worker.py:56-70`` case: hier-4x3, arena 1024,
pop 8 a rank), whose gathers cross the processes every iteration.  Imports
nothing of JAX.  Prints
one JSON line for the parent to compare across processes and against the
JAX package's single-process 8-device solve.

    python tests/_torch_dist_worker.py PORT PROCESS_ID
"""

import json
import sys


def main() -> int:
    port, pid = sys.argv[1], int(sys.argv[2])
    import torch

    torch.set_num_threads(1)
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
    from quorum_intersection_tpu_torch.fbas.synth import benchmark_fbas, hierarchical_fbas, majority_fbas
    from quorum_intersection_tpu_torch.parallel import distributed
    from quorum_intersection_tpu_torch.pipeline import solve

    distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
                           backend="gloo")
    assert distributed.is_multihost()
    mesh = distributed.global_candidate_mesh(devices=["cpu"] * 4)
    out = {"process_count": mesh.process_count, "process_index": mesh.process_index,
           "global_ranks": mesh.size}
    cases = {"safe": (majority_fbas(11), {}), "broken": (majority_fbas(11, broken=True), {}),
             "wide": (benchmark_fbas(48, 12, broken=True, seed=3), {"lo_bits": 6})}
    for label, (data, kw) in cases.items():
        res = solve(data, backend=GpuSweepBackend(device="cpu", batch=64 * mesh.size, mesh=mesh, **kw))
        out[label] = {"intersects": res.intersects, "q1": res.q1, "q2": res.q2,
                      **{k: res.stats.get(k) for k in ("hit_index", "candidates_checked", "device_steps")},
                      "mesh": res.stats.get("mesh")}
    fr = solve(hierarchical_fbas(4, 3), backend=GpuFrontierBackend(device="cpu", arena=1024, pop=8 * mesh.size,
                                                                   mesh=mesh))
    out["frontier"] = {"intersects": fr.intersects, "q1": fr.q1, "q2": fr.q2,
                       **{k: fr.stats.get(k) for k in ("minimal_quorums", "states_popped", "device_iters",
                                                       "device_chunks", "flagged", "host_checks")},
                       "mesh": fr.stats.get("mesh")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
