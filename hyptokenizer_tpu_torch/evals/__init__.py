"""Evaluation of the port: the kernels' checks against their plain
versions (``selfcheck``)."""
