"""Sweep and frontier checkpoint/resume — the port's copy of the JAX
package's ``utils/checkpoint.py`` (``:47-304``), with the on-disk formats
unchanged: a file written by either package resumes in the other.

A sweep's progress is one block-aligned scan position of its enumeration
(:class:`SweepCheckpoint`); a branch-and-bound search's is its explicit
worklist of unresolved (toRemove, dontRemove) states in graph-space node
ids (:class:`FrontierCheckpoint`).  Each is tied to the exact problem by a
fingerprint of the circuit tables, the SCC and the scoping.  A file with
another fingerprint (or, for the sweep, another enumeration size) is
ignored, never resumed.

Crash-only discipline: every write is atomic and durable (tmp file, flush
and fsync, rename, best-effort directory fsync), and an ``OSError`` on the
save path becomes the ``checkpoint.save_errors`` counter plus a warning, so
the run continues unprotected rather than dying.  An unreadable file is
renamed to ``<name>.corrupt`` and never retried.  Every write passes the
``checkpoint.write`` fault point (:mod:`.faults`), whose ``oserror`` lands on
that counter like a real full disk.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from quorum_intersection_tpu_torch.utils.faults import fault_point
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

log = logging.getLogger("quorum_intersection_tpu_torch.utils.checkpoint")


def _quarantine_corrupt(path: Path, why: str) -> None:
    """Rename an unreadable checkpoint to ``<name>.corrupt`` (overwriting an
    earlier quarantine: the newest corpse is the interesting one)."""
    corrupt = path.with_name(path.name + ".corrupt")
    try:
        os.replace(path, corrupt)
    except OSError:
        return  # racing unlink/rename: nothing left to quarantine
    get_run_record().add("checkpoint.corrupt_quarantined")
    get_run_record().event(
        "checkpoint.corrupt_quarantined", path=str(path), quarantined_to=str(corrupt), why=why,
    )
    log.warning("corrupt checkpoint quarantined to %s (%s)", corrupt, why)


def _read_json(path: Path) -> Optional[Dict[str, Any]]:
    """Parse a checkpoint file; corrupt content is quarantined, a missing
    file is simply None."""
    try:
        text = path.read_text()
    except OSError:
        return None
    except UnicodeDecodeError as exc:
        _quarantine_corrupt(path, f"undecodable bytes: {exc}")
        return None
    try:
        data = json.loads(text)
    except json.JSONDecodeError as exc:
        _quarantine_corrupt(path, f"unparseable JSON: {exc}")
        return None
    if not isinstance(data, dict):
        _quarantine_corrupt(path, f"not a JSON object: {type(data).__name__}")
        return None
    return data


def _write_json(path: Path, payload: Dict[str, Any]) -> bool:
    """Atomic and durable write; False (never an exception) on failure."""
    tmp = path.with_suffix(".tmp")
    try:
        fault_point("checkpoint.write")
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(payload))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        try:
            dir_fd = os.open(str(path.parent), os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
        except OSError:
            pass  # directory fsync is best-effort
    except OSError as exc:
        get_run_record().add("checkpoint.save_errors")
        get_run_record().event("checkpoint.save_error", path=str(path), error=str(exc))
        log.warning("checkpoint save failed (%s); run continues without this checkpoint update", exc)
        try:
            tmp.unlink()
        except OSError:
            pass
        return False
    get_run_record().add("checkpoint.saves")
    return True


def sweep_fingerprint(*arrays: Optional[np.ndarray]) -> str:
    """Stable hash of the problem's identity (circuit tables, node order,
    availability masks): any difference means another problem.  Byte for
    byte the JAX package's hash, so the two packages' files interchange."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"\x00none")
            continue
        arr = np.ascontiguousarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:32]


@dataclass
class SweepCheckpoint:
    """Checkpoint/resume of the exhaustive sweep: the scan position reached,
    under the enumeration's size and the problem's fingerprint."""

    path: Union[str, Path]

    def __post_init__(self) -> None:
        self.path = Path(self.path)

    def has_progress(self, total: int) -> bool:
        """Cheap probe: recorded progress for an enumeration of this size
        (no fingerprint check: ``resume_position`` guards the resume itself;
        the router only needs "plausibly this problem").  A frontier file at
        the same path counts too: the CLI hands one path to whichever
        engine the router picks."""
        data = _read_json(self.path)
        if data is None:
            return False
        if data.get("total") == total and int(data.get("position", 0) or 0) > 0:
            return True
        return bool(data.get("states"))

    def resume_position(
        self,
        total: int,
        fingerprint: Optional[str] = None,
        alt_fingerprints: tuple = (),
    ) -> int:
        """The last recorded position, or 0 when absent or mismatched.
        ``alt_fingerprints`` are older hashes of the same enumeration that
        also count as this problem."""
        data = _read_json(self.path)
        if data is None:
            return 0
        if data.get("total") != total:
            log.info("checkpoint total %s != current %d; ignoring", data.get("total"), total)
            return 0
        if fingerprint is not None and data.get("fingerprint") != fingerprint:
            if data.get("fingerprint") in alt_fingerprints:
                log.info("resuming from a legacy-format checkpoint fingerprint")
            else:
                log.info("checkpoint belongs to a different problem; ignoring")
                return 0
        pos = int(data.get("position", 0))
        if 0 < pos <= total:
            get_run_record().add("checkpoint.restores")
            get_run_record().event("checkpoint.restore", position=pos, total=total, path=str(self.path))
        return pos if 0 <= pos <= total else 0

    def record(self, position: int, total: int, fingerprint: Optional[str] = None) -> None:
        payload: Dict[str, Any] = {"position": position, "total": total}
        if fingerprint is not None:
            payload["fingerprint"] = fingerprint
        _write_json(self.path, payload)

    def clear(self) -> None:
        try:
            self.path.unlink()  # type: ignore[union-attr]
        except OSError:
            pass


@dataclass
class FrontierCheckpoint:
    """Checkpoint/resume of the branch-and-bound frontier: the worklist of
    unresolved (toRemove, dontRemove) states under a problem fingerprint.
    Re-pushing exactly those states reproduces the rest of the search."""

    path: Union[str, Path]

    def __post_init__(self) -> None:
        self.path = Path(self.path)

    def has_progress(self, total: int = 0) -> bool:
        """Cheap probe: a non-empty saved frontier."""
        data = _read_json(self.path)
        return data is not None and bool(data.get("states"))

    def resume_states(self, fingerprint: str) -> Optional[List[List[List[int]]]]:
        """Saved frontier ``[(to_remove, dont_remove), ...]``, or None."""
        data = _read_json(self.path)
        if data is None:
            return None
        if data.get("fingerprint") != fingerprint:
            log.info("frontier checkpoint belongs to a different problem; ignoring")
            return None
        states = data.get("states") or None
        if states is not None and not (
            isinstance(states, list)
            and all(
                isinstance(s, list) and len(s) == 2
                and all(isinstance(part, list) for part in s)
                and all(isinstance(v, int) for part in s for v in part)
                for s in states
            )
        ):
            log.info("frontier checkpoint states malformed; ignoring")
            return None
        if states:
            log.info("resuming search from %d frontier states", len(states))
            get_run_record().add("checkpoint.restores")
            get_run_record().event("checkpoint.restore", states=len(states), path=str(self.path))
        return states

    def record(self, states: Sequence[Sequence[Sequence[int]]], fingerprint: str) -> None:
        if not states:
            return  # an empty frontier means the search is finishing anyway
        _write_json(self.path, {"fingerprint": fingerprint, "states": list(states)})

    def clear(self) -> None:
        try:
            self.path.unlink()  # type: ignore[union-attr]
        except OSError:
            pass
