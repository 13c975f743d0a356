"""Mapping loops that put the chaining DP on a torch device."""
