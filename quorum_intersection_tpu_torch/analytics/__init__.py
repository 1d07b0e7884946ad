"""Graphviz export."""
