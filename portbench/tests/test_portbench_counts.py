"""The frozen counts equal the program's at several shapes."""

import types

import pytest

from portbench.counts import enhanced_loop as K12
from portbench.counts import merge_loop as K4
from portbench.counts import pairwise as K3


def _st_cfg(queue_size, d1):
    st = types.SimpleNamespace(base=types.SimpleNamespace(
        emb=types.SimpleNamespace(shape=(50176, d1))))
    return st, types.SimpleNamespace(queue_size=queue_size)


@pytest.mark.parametrize("queue_size,d1,merges,steps,rows", [
    (4096, 101, 896, 56, 0), (4096, 101, 10_657, 700, 0),
    (1024, 33, 17, 3, 0), (4096, 101, 100, 67, 43),
    (4096, 101, 1024, 128, 49_152), (128, 9, 1, 1, 5)])
def test_segment_counts_equal_the_program(queue_size, d1, merges, steps,
                                          rows):
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as P

    st, cfg = _st_cfg(queue_size, d1)
    assert K12.segment_bytes(queue_size, d1, merges, rows) == \
        P.segment_bytes(st, cfg, merges, rows)
    assert K12.segment_ops(queue_size, d1, merges, steps, rows) == \
        P.segment_ops(cfg, d1, merges, steps, rows)


@pytest.mark.parametrize("v,d1", [(43, 101), (4096, 101), (50_176, 101),
                                  (2, 3)])
def test_pairwise_flops_equal_the_program(v, d1):
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as P

    assert K3.pairwise_flops(v, d1) == P.pairwise_flops(v, d1)


@pytest.mark.parametrize("v0,merges,steps,d1,max_v,gate", [
    (4096, 4096, 4096, 101, 50_176, 0), (45_056, 4096, 4096, 101, 50_176, 0),
    (4096, 256, 300, 101, 50_176, 512), (10, 3, 5, 7, 64, 2)])
def test_chunk_counts_equal_the_program(v0, merges, steps, d1, max_v, gate):
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop as P

    assert K4.chunk_bytes(v0, merges, d1, max_v, gate) == \
        P.chunk_bytes(v0, merges, d1, max_v, gate)
    assert K4.chunk_ops(v0, merges, steps, d1) == \
        P.chunk_ops(v0, merges, steps, d1)
