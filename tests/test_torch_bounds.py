"""The bound counts of the port's kernels and K4's shared-memory plan,
pure Python on worked cases (no card): ``merge_loop.chunk_bytes``,
``chunk_ops`` and ``smem_plan``, ``enhanced_loop.segment_bytes`` and
``segment_ops``, each input byte read once and each output byte written
once; the padding that holds K2 at depth
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
