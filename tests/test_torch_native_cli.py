"""The port's standalone native CLI (``backends/cpp/qi_native.cpp`` linked
with its ``qi_oracle.cpp``) against the JAX package's binary.

The two binaries are run directly on the same stdin and flags: the golden
fixtures, the flag surface and the hostile corpus of
``tests/test_hostile_input.py``, stdout, stderr and exit code byte for byte.
Two cases hold the binary to the port's own CLI in process (``--device cpu
--backend python``), and the address/undefined-behaviour sanitized build
runs the fixtures clean.
"""

import contextlib
import io
import json
import subprocess

import pytest
import torch

from quorum_intersection_tpu.backends.cpp import build_native_cli as jax_build_native_cli
from quorum_intersection_tpu.fbas.schema import MAX_QSET_DEPTH
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends import cpp

from _torch_cases import FIXTURES
from test_hostile_input import nested_qset_node

torch.set_num_threads(1)


def _fixture_text(name):
    import gzip

    raw = (FIXTURES / name).read_bytes()
    return (gzip.decompress(raw) if name.endswith(".gz") else raw).decode()


@pytest.fixture(scope="module")
def binaries():
    try:
        return str(cpp.build_native_cli()), str(jax_build_native_cli())
    except Exception as exc:  # pragma: no cover - g++ missing
        pytest.skip(f"native CLI unavailable: {exc}")


def run(binary, args, stdin_data=""):
    proc = subprocess.run([binary, *args], input=stdin_data, capture_output=True, text=True, timeout=120)
    return proc.stdout, proc.stderr, proc.returncode


GOLDEN = ["trivial_correct.json", "trivial_broken.json", "nested_correct.json", "nested_broken.json",
          "snapshot_correct.json", "snapshot_broken.json", "dump_scale_correct.json.gz"]

FLAGS = {
    "help": (["-h"], None),
    "bad-flag": (["--definitely-not-a-flag"], None),
    "bad-number": (["-p", "-i", "abc"], "[]"),
    "missing-value": (["-i"], "[]"),
    "verbose": (["-v"], "snapshot_broken.json"),
    "pagerank": (["-p"], "snapshot_correct.json"),
    "pagerank-args": (["-p", "-m", "0.15", "-i", "40", "-c", "0.001"], "nested_broken.json"),
    "graphviz": (["-g"], "nested_correct.json"),
    "compat": (["-v", "--compat"], "snapshot_correct.json"),
    "seed": (["--seed", "7"], "snapshot_broken.json"),
    "seed-verbose": (["-v", "--seed", "12345"], "nested_broken.json"),
    "scope-scc": (["-v", "--scope-scc"], "snapshot_broken.json"),
    "front": (["--scc-select", "front", "--dangling-policy", "alias0"], "snapshot_correct.json"),
}

HOSTILE = {
    "empty": "",
    "not-json": "not json",
    "trailing": "[]true",
    "deep-arrays": "[" * 6000 + "]" * 6000,
    "deep-objects": '{"a":' * 6000 + "1" + "}" * 6000,
    "deep-qsets": nested_qset_node(400),
    "cap-depth": nested_qset_node(MAX_QSET_DEPTH - 1),
    "junk-unicode": "你好퟿ \x01 {][",
    "huge-threshold": '[{"publicKey": "A", "quorumSet": {"threshold": "' + "9" * 30 + '", "validators": ["A"]}}]',
    "negative-huge": '[{"publicKey": "A", "quorumSet": {"threshold": "-' + "9" * 30 + '", "validators": ["A"]}}]',
    "int64-plus-one": '[{"publicKey": "A", "quorumSet": {"threshold": 4294967297, "validators": ["A"]}}]',
    "nul-validator": '[{"publicKey": "A", "quorumSet": {"threshold": 1, "validators": ["\\u0000"]}}]',
    "null-inner": '[{"publicKey": "A", "quorumSet": {"threshold": 1, "innerQuorumSets": [{}]}}]',
    "nested-null-inner": ('[{"publicKey": "A", "quorumSet": '
                          + '{"threshold": 1, "innerQuorumSets": [' * 5 + "{}" + "]}" * 5 + "}]"),
    "dup-key": ('[{"publicKey": "A", "quorumSet": {"threshold": 1, "validators": ["A"]}}, '
                '{"publicKey": "A", "quorumSet": {"threshold": 1, "validators": ["A"]}}]'),
    "dup-json-key": ('[{"publicKey": "A", "quorumSet": {"threshold": 99, "validators": ["A"]}, '
                     '"quorumSet": {"threshold": 1, "validators": ["A"]}}]'),
    "float-threshold": json.dumps([{"publicKey": "A", "quorumSet": {"threshold": 1.5, "validators": ["A"]}}]),
    "control-char": '[{"publicKey": "A\tB", "quorumSet": {"threshold": 1, "validators": ["A\tB"]}}]',
    "truncated-10": None,
    "truncated-50": None,
    "truncated-90": None,
}


def _hostile(name):
    if name.startswith("truncated-"):
        text = _fixture_text("snapshot_correct.json")
        return text[: len(text) * int(name.split("-")[1]) // 100]
    return HOSTILE[name]


def _both(binaries, args, text):
    port, jax = binaries
    got, want = run(port, args, text), run(jax, args, text)
    assert got == want
    return got


@pytest.mark.parametrize("name", GOLDEN)
@pytest.mark.parametrize("args", [[], ["-v"]], ids=["plain", "verbose"])
def test_golden_fixtures_byte_identical(binaries, name, args):
    out, _, code = _both(binaries, args, _fixture_text(name))
    want = json.loads((FIXTURES / "MANIFEST.json").read_text())[name]["verdict"]
    assert out.splitlines()[-1] == ("true" if want else "false") and code == (0 if want else 1)


@pytest.mark.parametrize("case", list(FLAGS))
def test_flag_surface_byte_identical(binaries, case):
    args, stdin = FLAGS[case]
    text = "" if stdin is None else stdin if stdin.startswith("[") else _fixture_text(stdin)
    _both(binaries, args, text)


@pytest.mark.parametrize("case", list(HOSTILE))
def test_hostile_corpus_byte_identical(binaries, case):
    out, err, code = _both(binaries, [], _hostile(case))
    assert code in (0, 1)
    if code == 1 and not out:
        assert "invalid FBAS configuration" in err


def _port_cli(args, text):
    import sys

    buf = io.StringIO()
    real_stdin, sys.stdin = sys.stdin, io.StringIO(text)
    try:
        with contextlib.redirect_stdout(buf):
            code = cli.main(["--device", "cpu", "--backend", "python", *args])
    finally:
        sys.stdin = real_stdin
    return buf.getvalue(), code


@pytest.mark.parametrize("name,args", [("snapshot_broken.json", ["-v"]), ("nested_correct.json", ["-g"])])
def test_binary_equals_the_ports_cli(binaries, name, args):
    text = _fixture_text(name)
    out, _, code = run(binaries[0], args, text)
    assert (out, code) == _port_cli(args, text)


@pytest.fixture(scope="module")
def asan_cli():
    try:
        return str(cpp.build_native_cli(sanitize="asan"))
    except Exception as exc:  # pragma: no cover - g++ or libasan missing
        pytest.skip(f"sanitized build unavailable: {exc}")


# The vendored fixtures but the two largest searches (snapshot_correct.json's
# exhaustive one takes seconds under the sanitizer; the dump's SCC is its
# core): the B&B, the parser, Tarjan and the narration all run under it.
ASAN_FIXTURES = [name for name in GOLDEN if name not in ("snapshot_correct.json", "dump_scale_correct.json.gz")]


@pytest.mark.parametrize("name", ASAN_FIXTURES)
def test_fixtures_clean_under_asan(asan_cli, name):
    out, err, code = run(asan_cli, ["-v"], _fixture_text(name))
    want = json.loads((FIXTURES / "MANIFEST.json").read_text())[name]["verdict"]
    assert code == (0 if want else 1)
    for stream in (out, err):
        assert "ERROR: AddressSanitizer" not in stream and "runtime error:" not in stream
    assert "qi_native-asan-" in asan_cli


def test_sanitizer_mode_reads_the_env(monkeypatch):
    monkeypatch.setenv("QI_SANITIZER", "tsan")
    assert cpp.sanitizer_mode() == "tsan"
    monkeypatch.delenv("QI_SANITIZER")
    assert cpp.sanitizer_mode() == "asan"


def test_none_mode_refuses_instead_of_falling_back(monkeypatch):
    monkeypatch.setenv("QI_SANITIZER", "none")
    with pytest.raises(RuntimeError, match="QI_SANITIZER=none"):
        cpp.build_native_cli(sanitize=True)


def test_unknown_mode_is_rejected(monkeypatch):
    monkeypatch.setenv("QI_SANITIZER", "msan")
    with pytest.raises(ValueError, match="msan"):
        cpp.sanitizer_mode()
    with pytest.raises(ValueError, match="hwasan"):
        cpp.build_native_cli(sanitize="hwasan")
