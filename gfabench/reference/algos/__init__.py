"""Frozen plain copies; see :mod:`gfabench.reference`."""
