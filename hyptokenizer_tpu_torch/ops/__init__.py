"""Geometry and kernels of the port."""
