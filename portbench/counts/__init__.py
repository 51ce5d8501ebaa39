"""Frozen operation and byte counts of the port's kernels.

Copies of the counts that ``hyptokenizer_tpu_torch/ops/cuda/`` states for
its kernels (``enhanced_loop.segment_bytes``/``segment_ops`` for K1/K2,
``pairwise.pairwise_flops`` for K3, ``merge_loop.chunk_bytes``/``chunk_ops``
for K4), taken on plain integers, so that a change to a kernel cannot move
its own yardstick. ``portbench/tests/test_portbench_counts.py`` holds them
equal to the program's at several shapes. Each byte is counted read once
and written once, whatever a kernel reads again.
"""
