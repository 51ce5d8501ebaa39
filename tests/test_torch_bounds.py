"""The bound counts of the port's kernels and their launch plans, pure
Python on worked cases (no card): ``merge_loop.chunk_bytes``,
``chunk_ops`` and ``smem_plan``, ``enhanced_loop.segment_bytes``,
``segment_ops`` and K1's ``smem_plan``, ``pairwise.tile_plan`` (K3's
tensor-core tiles, padding and scratch), each input byte read once and each
output byte written once; the padding that holds K2 at depth
(``selfcheck.pad_dense_state``); and the K2/K4 wrappers' refusal of CPU
states."""

import types

import pytest
import torch

from hyptokenizer_tpu_torch.evals import selfcheck
from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4
from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3
from hyptokenizer_tpu_torch.tokenizer import scoring


def test_chunk_bytes_three_merges_by_hand():
    # 10 active rows of d1 = 5 in 16 slots, 3 merges, no length gate:
    # rows 10*5*4 = 200; best_dist over the slots 16*4 = 64; best_j read
    # 13*4 = 52; best_dist/best_j written 13*8 = 104; lengths of the merged
    # pairs' rows min(10, 6)*4 = 24; per merge the new row 20, its length
    # 4, the pair 8 and the distance 4: 3*36 = 108.
    assert K4.chunk_bytes(10, 3, 5, 16) == 200 + 64 + 52 + 104 + 24 + 108
    # With the length gate every active row's length is read: 10*4 = 40.
    assert K4.chunk_bytes(10, 3, 5, 16, max_token_len=8) == \
        200 + 64 + 52 + 104 + 40 + 108


def test_chunk_bytes_rereading_counts_every_step():
    # 4 steps, 3 merges from 10 rows: the argmin reads 16 slots per step
    # (4*64); the merges fold 10, 11 and 12 rows of 5*4 + 4 + 8 bytes.
    assert K4.chunk_bytes_rereading(10, 3, 4, 5, 16) == \
        4 * 64 + 33 * 32 + 3 * (20 + 16)
    assert K4.chunk_bytes_rereading(10, 3, 4, 5, 16) > \
        K4.chunk_bytes(10, 3, 5, 16)


def test_chunk_ops_by_hand():
    # 3 merges fold 10 + 11 + 12 rows at 2*5 + 8 operations each, and 4
    # argmin steps compare the 10 active entries.
    assert K4.chunk_ops(10, 3, 4, 5) == 33 * 18 + 4 * 10


def test_chunk_bound_at_the_smoke_shape():
    # 28,922 active rows, 4096 merges, d1 = 101, 50,176 slots: about 14 MB
    # read once, and about 2.7e10 operations, which bound the chunk.
    nbytes = K4.chunk_bytes(28_922, 4096, 101, 50_176)
    ops = K4.chunk_ops(28_922, 4096, 4096, 101)
    assert 13e6 < nbytes < 15e6
    assert 2.6e10 < ops < 2.8e10
    assert ops / 67e12 > nbytes / 3.35e12


@pytest.mark.parametrize("max_v,d1,sms,owned,resident,row_floats", [
    (50_176, 101, 132, 384, 384, 101),     # all owned rows fit
    (50_176, 301, 132, 384, 160, 301),     # part of them
    (50_176, 10_001, 132, 384, 0, 0),      # none; the new row global too
    (1024, 10_001, 132, 32, 0, 0),
    (1024, 101, 132, 32, 32, 101),
    (256, 8, 132, 32, 32, 8),
])
def test_smem_plan(max_v, d1, sms, owned, resident, row_floats):
    plan = K4.smem_plan(max_v, d1, sms)
    assert (plan.owned, plan.resident, plan.row_floats) == \
        (owned, resident, row_floats)
    assert plan.stride % 8 == 4 and d1 <= plan.stride < d1 + 8
    assert plan.resident % K4.CHUNK == 0
    fold_row = plan.stride if resident else 0
    assert plan.bytes == (row_floats + fold_row) * 4 + \
        resident * (plan.stride * 4 + 12)
    assert plan.bytes <= K4.SMEM_LIMIT - K4.SMEM_RESERVE


def test_smem_plan_full_width_is_about_170_kb():
    # 384 rows at a stride of 108 floats with their candidates and lengths,
    # the fold's copy of the new row (108 floats) and the new row (101).
    plan = K4.smem_plan(50_176, 101, 132)
    assert plan.stride == 108
    assert plan.bytes == 101 * 4 + 108 * 4 + 384 * (108 * 4 + 12) == 171_332


@pytest.mark.parametrize("d1,stride", [(8, 12), (101, 108), (128, 132),
                                       (129, 132), (301, 308)])
def test_smem_plan_stride_is_4_mod_8(d1, stride):
    # 16-byte loads of 8 rows at a stride of 4 mod 8 floats hit 8 distinct
    # 16-byte bank groups.
    assert K4.smem_plan(4096, d1, 132).stride == stride


def _segment_args(d1=5, queue_size=4):
    st = types.SimpleNamespace(base=types.SimpleNamespace(
        emb=torch.zeros((16, d1))))
    cfg = types.SimpleNamespace(queue_size=queue_size)
    return st, cfg


def test_segment_bytes_by_hand():
    st, cfg = _segment_args()
    # Queues: 12 entries read (16 B) and scores written (4 B) = 240; hash
    # powers 2 * MAX_HASH_LEN * 4.
    fixed = 240 + 2 * scoring.MAX_HASH_LEN * 4
    # K1, 2 merges: per merge two rows (20 B) and their features (17 B)
    # read, the new row and features (37 B) and history (12 B) written.
    assert K12.segment_bytes(st, cfg, 2) == fixed + 2 * (74 + 49)
    # K2 from 10 active rows: the rows read once (10 * (20 + 4)) instead
    # of per merge, and best_dist/best_j over the final 12 rows read and
    # written (12 * 16).
    assert K12.segment_bytes(st, cfg, 2, dense_rows=10) == \
        fixed + 2 * (34 + 49) + 10 * 24 + 12 * 16


def test_segment_bytes_rereading_counts_fold_rows():
    st, cfg = _segment_args()
    # Each fold row: best_dist read for the argmin, the row, its length,
    # best_dist/best_j read and written: 4 + 20 + 4 + 16 = 44 B.
    assert K12.segment_bytes_rereading(st, cfg, 2, fold_rows=23) == \
        K12.segment_bytes(st, cfg, 2) + 23 * 44


def test_segment_ops_by_hand():
    cfg = types.SimpleNamespace(queue_size=4)
    # 3 steps scan 4 entries (2 ops each); 2 merges consume 12 entries and
    # take 12 ops per coordinate of d1 = 5.
    assert K12.segment_ops(cfg, 5, 2, 3) == 3 * 8 + 2 * (12 + 60)
    # The dense channel: 3 argmin steps over 10 rows, and the 2 merges'
    # columns folded into 10 and 11 rows at 2*5 + 8 ops.
    assert K12.segment_ops(cfg, 5, 2, 3, dense_rows=10) == \
        3 * 8 + 2 * (12 + 60) + 30 + 21 * 18


def test_pad_dense_state():
    """The padded prefix: fresh rows on the sheet, length 1, no vowel,
    distinct hashes, and candidates equal to K3's plain pass over it."""
    from tests.test_torch_cuda import dense_tokenizer

    tok = dense_tokenizer("cpu", max_vocab_size=512)
    st0 = tok.enh_state
    v0 = int(st0.base.vocab_size)
    st = selfcheck.pad_dense_state(st0, 300)
    assert int(st.base.vocab_size) == 300 and int(st0.base.vocab_size) == v0
    assert torch.equal(st.base.emb[:v0], st0.base.emb[:v0])
    new = st.base.emb[v0:300].double()
    c = float(st.base.curvature)
    sheet = new[:, 0] ** 2 - c * (new[:, 1:] ** 2).sum(-1)
    assert torch.allclose(sheet, torch.ones_like(sheet), atol=1e-4)
    assert (st.base.lengths[v0:300] == 1).all()
    assert (st.byte_lengths[v0:300] == 1).all()
    assert not st.has_vowel[v0:300].any()
    keys = st.token_hash[:300, 0].long() * 65536 + st.token_hash[:300, 1]
    assert keys.unique().numel() == 300
    assert (st.token_hash[v0:300, 0] < scoring.HASH_P1).all()
    assert (st.token_hash[v0:300, 1] < scoring.HASH_P2).all()
    bd, bj = K3.pairwise_min_best_plain(st.base.emb, 300, st.base.curvature)
    assert torch.equal(st.base.best_dist, bd)
    assert torch.equal(st.base.best_j, bj)
    with pytest.raises(ValueError):
        selfcheck.pad_dense_state(st0, 513)


def test_cuda_wrappers_refuse_cpu_states():
    """For a CPU state the kernel wrappers raise before any launch; the
    plain versions are reached only through ``run_merges`` and
    ``run_segment``."""
    from tests.test_torch_cuda import dense_tokenizer

    st, cfg = selfcheck.base_state("cpu", n0=32, d=7, max_v=64)
    with pytest.raises(ValueError, match="CUDA"):
        K4.run_merges_chunk(st, cfg, 4)
    tok = dense_tokenizer("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        K12.run_segment_cuda(tok.enh_state, tok.enh_config, 10, 10, 10)


@pytest.mark.parametrize("queue_size,nb,ring,resident", [
    (4096, 16, 512, 3),       # the flagship: every phase queue on chip
    (4096, 2048, 4096, 2),    # a large batch's ring leaves room for two
    (8192, 16, 512, 1),
    (16384, 16, 512, 0),      # one phase alone outgrows shared memory
    (8192, 8192, 16384, 0),
    (128, 4, 512, 3),
    (4096, 300, 608, 3),      # two batches, in whole rounds of 16 warps
    (4096, 1024, 2048, 2),    # ranks past 512
])
def test_k1_smem_plan(queue_size, nb, ring, resident):
    plan = K12.smem_plan(queue_size, nb)
    assert (plan.ring, plan.resident) == (ring, resident)
    assert plan.ring >= 2 * nb and plan.ring % K12.MERGE_WARPS == 0
    ring_bytes = -(-ring * 12 // 8) * 8
    assert plan.bytes == ring_bytes + resident * 16 * queue_size
    assert plan.bytes <= K12.SMEM_LIMIT - K12.SMEM_RESERVE
    if resident < 3:     # one more phase would not fit
        assert plan.bytes + 16 * queue_size > \
            K12.SMEM_LIMIT - K12.SMEM_RESERVE


def test_k1_smem_plan_flagship_by_hand():
    # A ring of 512 merges at 12 B (6,144 B), then three phases of 4096
    # entries at 16 B (196,608 B).
    plan = K12.smem_plan(4096, 16)
    assert plan.bytes == 6_144 + 196_608 == 202_752


@pytest.mark.parametrize("vocab,d1,rows,depth,col_tiles", [
    (127, 101, 128, 104, 2), (128, 101, 128, 104, 2),
    (129, 9, 256, 16, 3), (257, 8, 384, 8, 5), (1, 8, 128, 8, 1),
    (50_176, 101, 50_176, 104, 784), (4096, 101, 4096, 104, 64),
])
def test_k3_tile_plan_padding(vocab, d1, rows, depth, col_tiles):
    plan = K3.tile_plan(vocab, d1, 132)
    assert (plan.rows, plan.depth, plan.col_tiles) == (rows, depth, col_tiles)
    assert plan.row_tiles == rows // 128 and plan.tensor_cores
    # hi and lo: rows x depth floats each; a 64-bit key per row; a counter.
    assert plan.scratch_bytes == 2 * rows * depth * 4 + rows * 8 + 4
    # A 128-row tile and two stages of a 64-column tile, hi and lo.
    assert plan.smem_bytes == 2 * (128 + 2 * 64) * depth * 4 <= 232_448


@pytest.mark.parametrize("vocab,n_sms", [(50_176, 132), (4096, 132),
                                          (300, 132), (1000, 7)])
def test_k3_tile_plan_covers_the_upper_triangle(vocab, n_sms):
    """Each row tile rt meets column tiles 2 rt .. col_tiles - 1 exactly
    once, in items of at most ``chunk`` tiles, largest first."""
    plan = K3.tile_plan(vocab, 101, n_sms)
    seen = {}
    for rt, c0, c1 in plan.items:
        assert 0 < c1 - c0 <= plan.chunk
        seen.setdefault(rt, []).extend(range(c0, c1))
    for rt in range(plan.row_tiles):
        want = list(range(2 * rt, plan.col_tiles))
        assert sorted(seen.get(rt, [])) == want
    sizes = [c1 - c0 for _, c0, c1 in plan.items]
    assert sizes == sorted(sizes, reverse=True)


def test_k3_tile_plan_full_width_by_hand():
    # 392 row tiles against 784 column tiles: 154,056 tile pairs over
    # 4 x 132 items gives chunks of 292; 50,176 x 104 floats of hi and of
    # lo (41,746,432 B), 401,408 B of keys and the counter.
    plan = K3.tile_plan(50_176, 101, 132)
    assert plan.chunk == 292 and len(plan.items) == 738
    assert plan.scratch_bytes == 41_746_432 + 401_408 + 4
    assert plan.smem_bytes == 212_992
    assert not K3.tile_plan(50_176, 129, 132).tensor_cores   # depth 136
