"""Port candidate search (tokenizer/search.py) and the plain version of
kernel K3 == the JAX package's, on the same numpy inputs.

Tolerances: distances 1e-5 absolute; partners equal except at distance
ties within 1e-5 (the rule of tests/test_pallas_pairwise.py: two float32
grams summed in other orders can order a near-tie either way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.ops.pallas.pairwise import pairwise_min_best
from hyptokenizer_tpu.tokenizer import search as JS
from hyptokenizer_tpu_torch.ops.cuda import pairwise as TP
from hyptokenizer_tpu_torch.tokenizer import search as TS
from tests.torch_port_checks import assert_same_best, np_points


def buffers(max_v, n_active, d, seed=0, n_hist=0, lengths_max=4):
    """(emb (max_v, d+1), lengths, merges, n_hist) with a random history of
    pairs among the active rows, in both orders."""
    pts, lens = np_points(seed, n_active, d, lengths_max=lengths_max)
    emb = np.zeros((max_v, d + 1), np.float32)
    emb[:n_active] = pts
    lengths = np.zeros((max_v,), np.int32)
    lengths[:n_active] = lens
    merges = np.full((max_v, 2), -1, np.int32)
    rng = np.random.default_rng(seed + 1)
    merges[:n_hist] = rng.integers(0, n_active, (n_hist, 2))
    # Half the history consumes rows' closest partners.
    _, bj = TS.full_pass_best(torch.from_numpy(emb), n_active, 1.0,
                              torch.from_numpy(merges), 0)
    rows = rng.permutation(n_active - 1)[:n_hist // 2]
    merges[:len(rows), 0] = rows
    merges[:len(rows), 1] = bj.numpy()[rows]
    return emb, lengths, merges


@pytest.mark.parametrize("case", [
    dict(max_v=96, n_active=70, n_hist=40, block=32),
    dict(max_v=96, n_active=70, max_token_len=5, block=32),
    dict(max_v=200, n_active=131, n_hist=25, max_token_len=6, block=48),
], ids=["history", "length-gate", "nondivisible-prefix"])
def test_full_pass_best(case):
    n_hist = case.get("n_hist", 0)
    mtl = case.get("max_token_len", 0)
    emb, lengths, merges = buffers(case["max_v"], case["n_active"], 7,
                                   n_hist=n_hist)
    c = np.float32(1.3)
    jbd, jbj = JS.full_pass_best(
        jnp.asarray(emb), jnp.int32(case["n_active"]), jnp.float32(c),
        jnp.asarray(merges), jnp.int32(n_hist), block=case["block"],
        lengths=jnp.asarray(lengths), max_token_len=mtl)
    tbd, tbj = TS.full_pass_best(
        torch.from_numpy(emb), case["n_active"], torch.tensor(c),
        torch.from_numpy(merges), n_hist, block=case["block"],
        lengths=torch.from_numpy(lengths), max_token_len=mtl)
    assert tbd.dtype == torch.float32 and tbj.dtype == torch.int32
    assert_same_best(emb, c, tbd.numpy(), tbj.numpy(), jbd, jbj)
    assert not np.isfinite(tbd.numpy()[case["n_active"]:]).any()
    # Teeth: the history and the gate change the answer.
    ubd, _ = TS.full_pass_best(torch.from_numpy(emb), case["n_active"],
                               torch.tensor(c), torch.from_numpy(merges), 0)
    assert (ubd.numpy() < tbd.numpy()).any()


def test_row_best_and_column_update():
    emb, _, merges = buffers(64, 40, 7, seed=3, n_hist=30)
    te, tm = torch.from_numpy(emb), torch.from_numpy(merges)
    je, jm = jnp.asarray(emb), jnp.asarray(merges)
    c = np.float32(0.8)
    for i in (0, 5, 17, 38, 39):
        jd, jj = JS.row_best(je, jnp.int32(i), jnp.int32(40), jnp.float32(c),
                             jm, jnp.int32(30))
        td, tj = TS.row_best(te, i, 40, torch.tensor(c), tm, 30)
        assert_same_best(emb, c, [float(td)], [int(tj)], [float(jd)],
                         [int(jj)])
    bd, bj = JS.full_pass_best(je, jnp.int32(40), jnp.float32(c), jm,
                               jnp.int32(0), block=16)
    new = 39
    jd, jj = JS.column_update(je, jnp.int32(new), jnp.float32(c), bd, bj)
    td, tj = TS.column_update(te, new, torch.tensor(c),
                              torch.from_numpy(np.array(bd)),
                              torch.from_numpy(np.array(bj)))
    assert_same_best(emb, c, td.numpy(), tj.numpy(), jd, jj)
    assert (np.asarray(jj) == new).any()        # the fold improved rows


@pytest.mark.parametrize("max_v,n_active,d,tile_m,tile_n", [
    (128, 50, 7, 8, 128), (256, 130, 15, 16, 128), (128, 128, 31, 8, 128)],
    ids=["small", "nondivisible-active", "full-buffer"])
def test_k3_plain_matches_pallas_kernel(max_v, n_active, d, tile_m, tile_n):
    """K3's plain version against the TPU kernel in interpret mode, at the
    shapes of tests/test_pallas_pairwise.py."""
    emb, _, _ = buffers(max_v, n_active, d, seed=max_v + d)
    jbd, jbj = pairwise_min_best(jnp.asarray(emb), jnp.int32(n_active),
                                 jnp.float32(1.0), tile_m=tile_m,
                                 tile_n=tile_n, interpret=True)
    tbd, tbj = TP.pairwise_min_best(torch.from_numpy(emb), n_active,
                                    torch.tensor(1.0))
    assert TP.launches == 0                     # the CPU runs no kernel
    assert_same_best(emb, 1.0, tbd.numpy(), tbj.numpy(), jbd, jbj)


def test_k3_plain_inactive_rows():
    """Rows at or past the active prefix, and the last active row, have no
    valid column: (inf, 0)."""
    emb, _, _ = buffers(128, 40, 7, seed=1)
    jbd, jbj = pairwise_min_best(jnp.asarray(emb), jnp.int32(40),
                                 jnp.float32(1.0), tile_m=8, tile_n=128,
                                 interpret=True)
    tbd, tbj = TP.pairwise_min_best(torch.from_numpy(emb), 40, 1.0)
    assert np.isfinite(tbd.numpy()[:39]).all()
    assert not np.isfinite(tbd.numpy()[39:]).any()
    assert (tbj.numpy()[39:] == 0).all()
    np.testing.assert_array_equal(tbj.numpy()[39:], np.asarray(jbj)[39:])
    assert not np.isfinite(np.asarray(jbd)[39:]).any()
