"""``python -m quorum_intersection_tpu_torch`` — the CLI entry point."""

import sys

from quorum_intersection_tpu_torch.cli import run

sys.exit(run())
