"""Search backends (``gpu-sweep``)."""
