"""Least times of the program's kernels on an NVIDIA H100 SXM, counted from
the work a cell's inputs and configuration need (``bounds.py``)."""

from .bounds import bound_ms

__all__ = ["bound_ms"]
