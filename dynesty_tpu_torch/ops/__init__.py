"""Numerical building blocks: integrals, geometry, Hopper kernels and
their build."""
