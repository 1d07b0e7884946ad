"""The port's verdict path on the CPU against the JAX package's
``TpuSweepBackend``: verdict, witness pair and hit index on every vendored
JSON fixture and on seeded synthetic pairs, and the two CLIs on stdout and
exit code.  Everything compared is an integer or a string: exact equality.
"""

import io
import json
import sys

import pytest
import torch

from quorum_intersection_tpu import cli as jax_cli
from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu.fbas import synth as jax_synth
from quorum_intersection_tpu.pipeline import solve as jax_solve
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.pipeline import solve

from _torch_cases import JSON_FIXTURES, fixture_data, manifest

torch.set_num_threads(1)


def _same(data, **kw):
    want = jax_solve(data, backend=TpuSweepBackend(), **kw)
    got = solve(data, device="cpu", **kw)
    assert got.intersects == want.intersects
    assert (got.q1, got.q2) == (want.q1, want.q2)
    assert got.stats.get("hit_index") == want.stats.get("hit_index")
    assert got.stats.get("reason") == want.stats.get("reason")
    if "candidates_checked" in want.stats:
        assert got.stats["enumeration_total"] == want.stats["enumeration_total"]
    return got


@pytest.mark.parametrize("name", JSON_FIXTURES)
def test_fixture_matches_jax(name):
    got = _same(fixture_data(name))
    assert got.intersects is manifest()[name]["verdict"]


@pytest.mark.parametrize(
    "data",
    [
        jax_synth.majority_fbas(7),
        jax_synth.majority_fbas(8, broken=True),
        jax_synth.benchmark_fbas(60, 10, seed=1),
        jax_synth.benchmark_fbas(60, 10, broken=True, seed=1),
        jax_synth.benchmark_fbas(64, 9, nested_watchers=True, broken=True, seed=4),
    ],
    ids=["maj7", "maj8-broken", "bench60-10", "bench60-10-broken", "bench64-9-nested-broken"],
)
def test_synth_matches_jax(data):
    _same(data)


@pytest.mark.parametrize("scope", [False, True])
def test_scope_and_front_selection_match_jax(scope):
    data = jax_synth.benchmark_fbas(48, 9, nested_watchers=True, broken=True, seed=3)
    _same(data, scope_to_scc=scope, scc_select="front")


def test_wide_decode_matches_jax():
    """A two-level decode (lo_bits below the enumeration width) gives the
    same witness as the JAX backend's."""
    data = jax_synth.benchmark_fbas(40, 8, broken=True, seed=2)
    want = jax_solve(data, backend=TpuSweepBackend(lo_bits=3, batch=4))
    got = solve(data, backend=GpuSweepBackend(lo_bits=3, batch=4, device="cpu"))
    assert (got.q1, got.q2, got.stats["hit_index"]) == (want.q1, want.q2, want.stats["hit_index"])


def _run(main, argv, stdin_text, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    code = main(argv)
    return capsys.readouterr().out, code


@pytest.mark.parametrize(
    "name,flags",
    [
        ("trivial_correct.json", []),
        ("trivial_broken.json", ["-v"]),
        ("nested_broken.json", ["-v", "--scope-scc"]),
        ("nested_correct.json", ["-g"]),
        ("snapshot_broken.json", ["-v", "--dangling-policy", "alias0"]),
    ],
)
def test_cli_matches_jax_cli(name, flags, monkeypatch, capsys):
    text = json.dumps(fixture_data(name))
    want = _run(jax_cli.main, ["--backend", "tpu-sweep", *flags], text, monkeypatch, capsys)
    got = _run(cli.main, ["--device", "cpu", *flags], text, monkeypatch, capsys)
    assert got == want


def test_cli_errors(monkeypatch, capsys):
    out, code = _run(cli.main, ["--device", "cpu"], "[{", monkeypatch, capsys)
    assert (out, code) == ("", 1)
    with pytest.raises(SystemExit) as exit_info:
        _run(cli.main, ["--bogus"], "[]", monkeypatch, capsys)
    assert exit_info.value.code == 1
    assert capsys.readouterr().out.startswith("Invalid option!\n")


def test_cli_cuda_without_card_fails_loudly(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    text = json.dumps(fixture_data("trivial_correct.json"))
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert cli.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "torch.cuda.is_available() is false" in captured.err


def test_cancel_before_setup_and_width_ceiling():
    from quorum_intersection_tpu_torch.backends.base import CancelToken, SearchCancelled
    from quorum_intersection_tpu_torch.backends.sweep import SccTooLargeError

    token = CancelToken()
    token.cancel()
    with pytest.raises(SearchCancelled, match="before setup"):
        solve(jax_synth.majority_fbas(5), backend=GpuSweepBackend(cancel=token, device="cpu"))
    with pytest.raises(SccTooLargeError, match="46 exceeds"):
        solve(jax_synth.majority_fbas(46), device="cpu")
