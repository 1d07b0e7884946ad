"""Threshold-circuit encoding of quorum sets."""
