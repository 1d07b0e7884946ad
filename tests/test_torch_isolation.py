"""The port imports neither JAX nor the JAX package: it solves with both
blocked, and no source line of it (or of ``chip_smoke.py``) names them."""

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
leaked = sorted(m for m in sys.modules
                if m == "jax" and sys.modules[m] is not None
                or m.split(".")[0] == "quorum_intersection_tpu")
print(json.dumps({"results": out, "leaked": leaked}))
"""


def test_port_solves_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "fixtures")],
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
    }
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
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
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
