"""Solvers of the PyTorch port: the generic tier and the fleet lane
solvers."""
