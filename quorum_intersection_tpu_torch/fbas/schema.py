"""Stellarbeat ``/nodes/raw`` JSON schema → validated FBAS model.

Capability parity with the reference frontend
(the reference tool's `quorum_intersection.cpp:402-436`):

- each array element must carry ``publicKey`` (cpp:428) and a ``quorumSet`` key
  (cpp:430 — absent key is an error there too);
- ``name`` is optional, defaulting to ``""`` (cpp:429);
- a quorum set carries ``threshold``, ``validators`` and recursive
  ``innerQuorumSets`` (cpp:410-416); unknown keys (``hashKey``, dates, …) are
  ignored;
- a ``null`` / empty ``quorumSet`` maps to :data:`NULL_QSET` — the reference
  default-constructs a qset with an *uninitialized* threshold in this case
  (cpp:405-408) whose observable behavior is "never satisfiable" (SURVEY.md
  §2.3-Q2).  We model that explicitly with ``threshold=None`` instead of UB.

Deliberate lenient superset: inside a non-empty quorum set, a missing
``validators`` or ``innerQuorumSets`` key is treated as the empty list (the
reference throws an uncaught ``ptree_bad_path`` and crashes, cpp:411,414);
real stellarbeat snapshots occasionally omit the empty lists.  ``threshold``
remains required for non-empty quorum sets, as in the reference (cpp:410).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import IO, Iterable, Iterator, Mapping, Optional, Sequence, Union


class FbasSchemaError(ValueError):
    """Raised when the input JSON does not satisfy the FBAS schema."""


# Hostile-input hardening: a quorum set nested deeper than this is rejected
# with a clean schema error instead of exhausting the interpreter stack (the
# reference would crash on such input, cpp:402-418).  Real stellarbeat
# snapshots nest 1-2 levels; 128 is far beyond any legitimate FBAS while
# keeping every downstream recursion (graph indexing, circuit interning,
# native flattening — all capped to the same constant) well inside default
# stack budgets.
MAX_QSET_DEPTH = 128


@dataclass(frozen=True)
class QSet:
    """A (possibly nested) quorum set.

    ``threshold is None`` encodes the reference's null/empty quorum set —
    a slice that can never be satisfied (SURVEY.md §2.3-Q2).
    """

    threshold: Optional[int]
    validators: tuple = ()
    inner: tuple = ()

    @property
    def is_null(self) -> bool:
        return self.threshold is None

    def member_count(self) -> int:
        """Direct member count: validators + inner sets (one vote each)."""
        return len(self.validators) + len(self.inner)

    def max_depth(self) -> int:
        """Nesting depth: 0 for a flat qset, 1 + max over children otherwise."""
        if not self.inner:
            return 0
        return 1 + max(q.max_depth() for q in self.inner)

    def all_validator_refs(self) -> Iterable[str]:
        """Every validator reference at every nesting depth, with repeats.

        Mirrors the reference's edge construction, which adds one trust edge
        per occurrence at every depth (cpp:455-464, SURVEY.md §2.3-Q7).
        """
        for v in self.validators:
            yield v
        for q in self.inner:
            yield from q.all_validator_refs()


NULL_QSET = QSet(threshold=None)


@dataclass(frozen=True)
class FbasNode:
    public_key: str
    name: str
    qset: QSet


@dataclass
class Fbas:
    """A parsed FBAS: ordered node list + public-key index.

    Node order is the JSON array order — vertex ``i`` of the trust graph is
    ``nodes[i]``, matching the reference's ``add_vertex`` order (cpp:441-446).
    """

    nodes: list = field(default_factory=list)

    def __post_init__(self) -> None:
        self.index: dict = {}
        for i, node in enumerate(self.nodes):
            # First occurrence wins on duplicate keys; the reference's
            # idMap[node.nodeID] = v overwrite makes the *last* occurrence win
            # for edge targets (cpp:445) but vertices are still distinct.
            # Duplicate publicKeys are rejected here instead: silently aliased
            # vertices are a foot-gun, and no real snapshot contains them.
            if node.public_key in self.index:
                raise FbasSchemaError(f"duplicate publicKey: {node.public_key!r}")
            self.index[node.public_key] = i

    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self) -> "Iterator[FbasNode]":
        return iter(self.nodes)

    def __getitem__(self, i: int) -> FbasNode:
        return self.nodes[i]

    def label(self, i: int) -> str:
        """Display label: name if non-empty else publicKey (cpp:507, :596-597)."""
        node = self.nodes[i]
        return node.name if node.name else node.public_key


def _parse_qset(value: object, where: str, depth: int = 0) -> QSet:
    if depth > MAX_QSET_DEPTH:
        raise FbasSchemaError(
            f"{where}: quorumSet nesting exceeds depth {MAX_QSET_DEPTH}"
        )
    if value is None:
        return NULL_QSET
    if not isinstance(value, Mapping):
        raise FbasSchemaError(f"{where}: quorumSet must be an object or null, got {type(value).__name__}")
    if not value:
        # Empty object → same "never satisfiable" semantics as null (cpp:406-408).
        return NULL_QSET
    if "threshold" not in value:
        raise FbasSchemaError(f"{where}: non-empty quorumSet missing 'threshold'")
    threshold = value["threshold"]
    if isinstance(threshold, str):
        # boost::property_tree stores scalars as strings and converts on get;
        # accept numeric strings for input compatibility.
        try:
            threshold = int(threshold)
        except ValueError:
            raise FbasSchemaError(f"{where}: threshold {threshold!r} is not an integer") from None
    if isinstance(threshold, bool) or not isinstance(threshold, int):
        raise FbasSchemaError(f"{where}: threshold must be an integer, got {threshold!r}")
    validators = value.get("validators")
    if validators is None:
        validators = ()
    if not isinstance(validators, Sequence) or isinstance(validators, (str, bytes)):
        raise FbasSchemaError(f"{where}: validators must be an array")
    for v in validators:
        if not isinstance(v, str):
            raise FbasSchemaError(f"{where}: validator entries must be strings, got {v!r}")
    inner_raw = value.get("innerQuorumSets")
    if inner_raw is None:
        inner_raw = ()
    if not isinstance(inner_raw, Sequence) or isinstance(inner_raw, (str, bytes)):
        raise FbasSchemaError(f"{where}: innerQuorumSets must be an array")
    inner = tuple(
        _parse_qset(q, f"{where}.innerQuorumSets[{i}]", depth + 1)
        for i, q in enumerate(inner_raw)
    )
    return QSet(threshold=threshold, validators=tuple(validators), inner=inner)


def parse_fbas(source: Union[str, bytes, IO, list]) -> Fbas:
    """Parse a stellarbeat ``/nodes/raw`` JSON array into an :class:`Fbas`.

    ``source`` may be a JSON string/bytes, an open text stream (the CLI passes
    stdin, matching the reference's stdin-only contract, cpp:791), or an
    already-decoded list.
    """
    try:
        if isinstance(source, (str, bytes)):
            data = json.loads(source)
        elif isinstance(source, list):
            data = source
        else:
            data = json.load(source)
    except RecursionError:
        # json's C scanner recurses per nesting level; surface the same clean
        # diagnostic as any other malformed input instead of a traceback.
        raise FbasSchemaError("JSON nesting too deep") from None
    if not isinstance(data, list):
        raise FbasSchemaError(f"top level must be a JSON array, got {type(data).__name__}")

    nodes = []
    for i, raw in enumerate(data):
        where = f"nodes[{i}]"
        if not isinstance(raw, Mapping):
            raise FbasSchemaError(f"{where}: must be an object")
        if "publicKey" not in raw:
            raise FbasSchemaError(f"{where}: missing required 'publicKey'")
        public_key = raw["publicKey"]
        if not isinstance(public_key, str):
            raise FbasSchemaError(f"{where}: publicKey must be a string")
        name = raw.get("name") or ""
        if not isinstance(name, str):
            raise FbasSchemaError(f"{where}: name must be a string")
        if "quorumSet" not in raw:
            raise FbasSchemaError(f"{where} ({public_key}): missing required 'quorumSet'")
        qset = _parse_qset(raw["quorumSet"], f"{where}.quorumSet")
        nodes.append(FbasNode(public_key=public_key, name=name, qset=qset))
    return Fbas(nodes)
