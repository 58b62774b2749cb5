"""Solvers of the PyTorch port (this slice: the fleet lane solver)."""
