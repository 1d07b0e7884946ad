"""Stellarbeat JSON frontend, trust graph, set semantics, synthetic FBAS."""
