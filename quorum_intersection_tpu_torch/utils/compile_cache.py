"""The port's build cache: where the native libraries it compiles live.

The port compiles no XLA, so the JAX package's persistent XLA compilation
cache (its ``utils/compile_cache.py``) has nothing to act on here.  What the
port compiles are its own native libraries: the CUDA kernels
(``kernels/build.py``, ``nvcc``) and the host oracle and standalone CLI
(``backends/cpp``, ``g++``).  Each is named by a hash of its sources and
flags, so a library built once in a checkout's ``_build/`` directory is
reused by every later process, and an edited source never loads a stale one.

``QI_NO_COMPILE_CACHE=1`` is the JAX package's opt-out, read at each build:
every library is then built into a private temporary directory of the
process (removed at exit), so nothing is reused across processes.  Within
one process a library is still built once.

The run record counts each library once a process, under the JAX names:
``compile_cache.hits`` when its file was already there, ``compile_cache.misses``
when it had to be built; ``compile_cache.enabled`` is an event per cache
directory first used with the cache on.  A build failure is never hidden by
the cache: the builder raises as it would without it.
"""

from __future__ import annotations

import atexit
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Optional, Set

from quorum_intersection_tpu_torch.utils.env import qi_env_flag
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

_lock = threading.Lock()
_private_root: Optional[Path] = None
_counted: Set[Path] = set()
_announced: Set[Path] = set()


def enabled() -> bool:
    """Whether libraries are reused across processes (``QI_NO_COMPILE_CACHE`` unset)."""
    return not qi_env_flag("QI_NO_COMPILE_CACHE")


def _private_dir() -> Path:
    global _private_root
    with _lock:
        if _private_root is None:
            _private_root = Path(tempfile.mkdtemp(prefix="qi-build-"))
            atexit.register(shutil.rmtree, _private_root, True)
        return _private_root


def build_dir(cached: Path) -> Path:
    """The directory a library whose cached home is ``cached`` builds into:
    ``cached`` itself, or under ``QI_NO_COMPILE_CACHE`` a directory of the
    same name inside this process's private temporary directory."""
    if enabled():
        with _lock:
            first = cached not in _announced
            _announced.add(cached)
        if first:
            get_run_record().event("compile_cache.enabled", dir=str(cached))
        return cached
    return _private_dir() / f"{cached.parent.name}-{cached.name}"


def note(target: Path, hit: bool) -> None:
    """Count one library, once a process: a hit if ``target`` was already
    built, a miss if it had to be built."""
    with _lock:
        if target in _counted:
            return
        _counted.add(target)
    get_run_record().add("compile_cache.hits" if hit else "compile_cache.misses")

