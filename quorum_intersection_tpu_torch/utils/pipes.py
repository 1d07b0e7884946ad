"""Downstream-pipe hygiene for stdin/stdout CLI entry points (the JAX
package's ``utils/pipes.py``)."""

from __future__ import annotations

import os
import sys
from typing import Callable


def run_with_pipe_hygiene(main: Callable[[], int]) -> int:
    """Run a CLI ``main``; a closed stdout (e.g. ``… | head``) exits 1
    quietly instead of dumping a BrokenPipeError traceback."""
    try:
        return main()
    except BrokenPipeError:
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 1
