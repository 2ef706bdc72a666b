"""Solvers of the port: the plain loop, the CUDA kernels and their routes."""
