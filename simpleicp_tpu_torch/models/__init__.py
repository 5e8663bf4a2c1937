"""The ICP driver and its solvers."""
