"""Shared helpers of the serving-layer tests (``tests/test_torch_serve*.py``):
engines of both packages on the same backend, JSONL sessions driven in
process, and the one list of response fields that carry wall time."""

import copy
import io
import json
import threading

from quorum_intersection_tpu import serve as jax_serve
from quorum_intersection_tpu import serve_transport as jax_transport
from quorum_intersection_tpu.backends.tpu.frontier import TpuFrontierBackend
from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu_torch import serve, serve_transport
from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend

# port backend name -> (port backend factory, JAX backend factory)
BACKENDS = {
    "python": (lambda: "python", lambda: "python"),
    "cpp": (lambda: "cpp", lambda: "cpp"),
    "gpu-sweep": (lambda: GpuSweepBackend(batch=512, device="cpu"), lambda: TpuSweepBackend(batch=512)),
    "gpu-frontier": (lambda: GpuFrontierBackend(arena=4096, pop=128, device="cpu"),
                     lambda: TpuFrontierBackend(arena=4096, pop=128)),
}

# The response fields that carry wall time (or the run record's own
# identity) and so differ between any two runs: dropped before a port line
# is held to the JAX line.  Dotted names reach into nested objects.
WALL_FIELDS = (
    "seconds",
    "cost.device_s",
    "cert.provenance",
    "stats.seconds",
    "pid",
    "pulse",
)
# What each package's engine adds of its own under --emit-certs: the solve
# stats name the package's backends and devices, so only the certificate
# (less its provenance) is compared.
PACKAGE_FIELDS = ("stats",)


def drop(obj, dotted):
    """``obj`` less the field named by the dotted path (a deep copy)."""
    out = copy.deepcopy(obj)
    for name in dotted:
        parts = name.split(".")
        cur = out
        for part in parts[:-1]:
            cur = cur.get(part) if isinstance(cur, dict) else None
        if isinstance(cur, dict):
            cur.pop(parts[-1], None)
    return out


# Each package's name for the same engine in a certificate's coverage
# ledger, and the ledger keys that name a package's own run (as in
# tests/test_torch_cert.py).
ENGINE_NAMES = {"gpu-sweep": "tpu-sweep"}
LEDGER_RUN_KEYS = ("native_call_id",)


def comparable(line):
    """A response line less WALL_FIELDS and PACKAGE_FIELDS, its certificate's
    ledger entries under the JAX package's engine names."""
    out = drop(line, WALL_FIELDS + PACKAGE_FIELDS)
    cert = out.get("cert")
    for entry in ((cert or {}).get("coverage") or {}).get("sccs", []) if isinstance(cert, dict) else []:
        entry["backend"] = ENGINE_NAMES.get(entry["backend"], entry["backend"])
        if entry.get("engine") == "gpu-frontier":
            entry.pop("engine")  # the port's own name, kept beside the ledger kind
        for key in LEDGER_RUN_KEYS:
            entry.pop(key, None)
    return out


class Engine:
    """Context manager: a started engine of either package that always
    stops (bounded)."""

    def __init__(self, jax=False, **kw):
        self.engine = jax_serve.ServeEngine(**kw) if jax else serve.ServeEngine(device="cpu", **kw)

    def __enter__(self):
        self.engine.start()
        return self.engine

    def __exit__(self, *exc):
        self.engine.stop(drain=True, timeout=30.0)
        return False


def session_lines(lines, jax=False, emit_certs=False, **engine_kw):
    """Drive one JSONL conversation through a fresh engine of either package
    in process; the response objects, keyed by request id (response order is
    completion order).  Every line is admitted before the drain starts, so
    both packages batch the stream the same way."""
    out = io.StringIO()
    module = jax_transport if jax else serve_transport
    engine = Engine(jax=jax, **engine_kw).engine
    try:
        session = module.JsonlSession(engine, out, emit_certs=emit_certs)
        for n, line in enumerate(lines):
            session.handle_line(n, line)
        engine.start()
        assert session.wait_drained(timeout=60.0)
    finally:
        engine.stop(drain=True, timeout=30.0)
    objs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    return {o.get("request_id", o.get("pong")): o for o in objs}


class HeldDrain:
    """Park the drain loop at ``drain.popped`` until released."""

    def __init__(self):
        self.popped = threading.Event()
        self.release = threading.Event()

    def __call__(self, point):
        if point == "drain.popped":
            self.popped.set()
            self.release.wait(30.0)
