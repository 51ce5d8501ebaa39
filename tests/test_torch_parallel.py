"""The port's sharded training (hyptokenizer_tpu_torch/parallel/) on gloo
worlds of 2 and 4 CPU ranks == the JAX package's single-device runs.

The counterpart of ``tests/test_parallel.py`` (all but its two tests of
JAX itself: the 8-device count and the graft entry). Each world is started
once per module (``tests/torch_parallel_worker.py``: spawned ranks, a
``FileStore`` under the test's temporary directory, one torch thread a
rank) and runs every case; every rank draws what the JAX package draws,
replayed from the port's single-device run with ``ReplaySampler``, which
must itself give JAX's merges.

Every rank's merge history, queues and pair table equal the port's
single-device run's exactly, and that run equals JAX's: the whole history
of the corpus-only cases, and with the dense channel the history up to
the acosh clamp floor (``CLAMP_FLOOR``, tests/test_torch_cli.py's rule:
the geometric channel chains a token with its own midpoints, halving the
distance each time, and below the floor every candidate ties at 0, so
either package may take any of them). Rows 1e-6; the sharded embedding
training 1e-4 (the JAX test's); curvature rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.ops import lorentz as JL
from hyptokenizer_tpu.parallel import make_mesh as jax_mesh
from hyptokenizer_tpu.parallel.sharded import run_enhanced_sharded as JRS
from hyptokenizer_tpu.tokenizer import EnhancedHyperbolicTokenizer as JaxTok
from hyptokenizer_tpu.tokenizer import MergeConfig as JMC
from hyptokenizer_tpu.tokenizer import enhanced_state as JE
from hyptokenizer_tpu.tokenizer import init_state as j_init
from hyptokenizer_tpu.tokenizer import run_merges as j_run
from hyptokenizer_tpu.tokenizer.embed_train import train_embeddings as j_embed
from hyptokenizer_tpu.tokenizer.normalize import (
    NormalizerConfig as JNC, WHITESPACE as JWS)
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer as TT
from hyptokenizer_tpu_torch.tokenizer import embed_train as TET
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as TE
from hyptokenizer_tpu_torch.tokenizer import state as TS
from hyptokenizer_tpu_torch.tokenizer.normalize import (
    NormalizerConfig as TNC, WHITESPACE as TWS)
from tests.torch_parallel_worker import RecordingSampler, run_world
from tests.torch_port_common import (  # noqa: F401
    ReplayDraws, ReplaySampler, one_torch_thread)

CORPUS_A = ["abc abd abe fgh", "cde cdf fgh abc"] * 6
CORPUS_B = ["abc abd abe fgh", "cde cdf fgh abc", "bcd ab fg hh"] * 8
CORPUS_C = ["abc abd abe fgh pqr", "cde cdf fgh abc klm"] * 6  # 20 a line
CORPUS_D = ["abc abd abe fgh", "cde cdf fgh abc", "fgh fgi abz qrs"] * 6


def _vocab(corpus):
    return ["<pad>", "<bos>", "<eos>", "<unk>"] + sorted(
        {ch for ln in corpus for ch in ln})


def _emb(key, n, d=8, sigma=0.6):
    return np.array(JL.random_points(jax.random.PRNGKey(key), n, d,
                                     sigma=sigma))


# Each enhanced case: (corpus, embedding key, constructor keywords, merges
# per chunk); "normalizer" stands for the whitespace pre-split, built by
# each package.
BASIC = dict(merge_threshold=3.0, max_vocab_size=64, search_block=16,
             use_hierarchical=False, use_adaptive_curvature=False, seed=3)
PRIORITY = dict(merge_threshold=50.0, max_vocab_size=64, search_block=16,
                use_hierarchical=False, use_adaptive_curvature=False,
                use_compression_aware=False, use_dense_channel=False,
                min_pair_freq=1, merge_batch=4, seed=3,
                merge_policy="priority", normalizer=True)
CASES = {
    "default": (CORPUS_A, 5, dict(BASIC, corpus_max_tokens=256), [10]),
    "priority": (CORPUS_A, 5, dict(PRIORITY, corpus_max_tokens=256), [10]),
    "corpus_sharded": (CORPUS_B, 5, dict(BASIC, corpus_max_tokens=512,
                                         corpus_shards=8), [12, 8]),
    "unaligned": (CORPUS_C, 5, dict(BASIC, corpus_max_tokens=256), [6]),
    "v3": (CORPUS_D, 9, dict(PRIORITY, corpus_max_tokens=512,
                             corpus_shards=8), [12]),
    "v3_all": (CORPUS_D, 9, dict(
        merge_threshold=50.0, max_vocab_size=64, search_block=16,
        corpus_max_tokens=512, corpus_shards=8, freq_table_size=2048,
        use_frequency_aware=True, use_hierarchical=True,
        use_compression_aware=True, use_adaptive_curvature=True,
        optimize_curvature_freq=4, use_dense_channel=True, min_pair_freq=1,
        merge_batch=4, seed=3), [12]),
}
FROZEN = dict(merge_threshold=50.0, max_vocab_size=64, search_block=16,
              corpus_max_tokens=512, freq_table_size=2048,
              use_frequency_aware=True, use_hierarchical=False,
              use_compression_aware=False, use_adaptive_curvature=False,
              use_dense_channel=False, min_pair_freq=1, merge_batch=4,
              seed=3)


def _kw(kw, port):
    kw = dict(kw)
    if kw.pop("normalizer", False):
        kw["normalizer"] = TNC(pre_split=TWS) if port else JNC(
            pre_split=JWS)
    return kw


CLAMP_FLOOR = 1e-3


def comparable(jst, start: int = 0) -> int:
    """Merges of a JAX state made above the acosh clamp floor (those before
    ``start`` were loaded, not made)."""
    n = int(jst.base.num_merges)
    below = np.flatnonzero(np.asarray(jst.base.merge_dists[start:n])
                           <= CLAMP_FLOOR)
    return start + int(below[0]) if below.size else n


def check_base_against_jax(tst, jst):
    """The port's distance-only history == JAX's up to a tie: the first
    pair that differs must be a tie, at a distance within 1e-5 of JAX's
    (a merge's midpoint is equidistant from two parents of one length, so
    rounding picks either), and the loop scalars agree."""
    n = int(jst.num_merges)
    assert int(tst.num_merges) == n > 3
    tm, jm = tst.merges[:n].numpy(), jst.merges[:n]
    diff = np.flatnonzero(np.any(tm != jm, axis=1))
    k = int(diff[0]) if diff.size else n
    assert k >= 1
    if k < n:
        assert abs(float(tst.merge_dists[k]) - float(jst.merge_dists[k])) \
            <= 1e-5
    assert int(tst.step) == int(jst.step)


def _run_pair(vocab, emb, kw, chunks, jax_tok=None, port_tok=None):
    """JAX single-device chunks and the port's single-device chunks with
    the JAX draws, held equal up to the clamp floor: (the port's chunks
    as a rank reports them, the port's recorded draws, JAX's last state,
    merges comparable with it)."""
    from tests.torch_parallel_worker import _enhanced_out
    jt = jax_tok or JaxTok(vocab, emb, corpus_sample=kw.get("corpus"),
                           **_kw(kw["kw"], False))
    tt = port_tok or TT(vocab, emb, device="cpu",
                        corpus_sample=kw.get("corpus"),
                        **_kw(kw["kw"], True))
    rec = RecordingSampler(ReplaySampler(jt.enh_state.key))
    start = int(jt.enh_state.base.num_merges)
    jst = jax.tree.map(jnp.array, jt.enh_state)
    tst = tt.enh_state
    outs = []
    for n in chunks:
        jst = JE.run_enhanced(jst, jt.enh_config, n)
        tst, _ = TE.run_enhanced(tst, tt.enh_config, n, rec)
        outs.append(_enhanced_out(tst, "single"))
    jst = jax.tree.map(np.asarray, jst)
    k = comparable(jst, start)
    np.testing.assert_array_equal(tst.base.merges[:k].numpy(),
                                  jst.base.merges[:k])
    if k == int(jst.base.num_merges):
        assert int(tst.base.num_merges) == k
        np.testing.assert_array_equal(tst.q_i.numpy(), jst.q_i)
        np.testing.assert_array_equal(tst.q_j.numpy(), jst.q_j)
    return outs, rec.calls, jst, k


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The JAX references and every rank's jobs (D-independent)."""
    jobs, want = {}, {}
    # Distance-only loop (test_parallel.build).
    n0 = 24
    emb = _emb(3, n0)
    lengths = np.asarray([1 + i % 3 for i in range(n0)], np.int32)
    cfg = JMC(max_vocab_size=64, search_block=16)
    tcfg = TS.MergeConfig(max_vocab_size=64, search_block=16)
    for name, chunks in (("base", [15]), ("chained", [5, 5])):
        st = j_init(jnp.asarray(emb), jnp.asarray(lengths), curvature=1.0,
                    threshold=3.0, config=cfg)
        jst = jax.tree.map(np.asarray, j_run(st, cfg, sum(chunks)))
        tst = TS.run_merges(TS.init_state(
            emb, lengths, curvature=1.0, threshold=3.0, config=tcfg,
            device="cpu"), tcfg, sum(chunks))
        check_base_against_jax(tst, jst)
        want[name] = tst
        jobs[name] = ("merges", dict(emb=emb, lengths=lengths, max_v=64,
                                     threshold=3.0, chunks=chunks))
    # Enhanced cases.
    for name, (corpus, key, kw, chunks) in CASES.items():
        vocab = _vocab(corpus)
        emb = _emb(key, len(vocab))
        spec = dict(kw=kw, corpus=corpus)
        want[name], calls, want[name + "_jax"], want[name + "_k"] = \
            _run_pair(vocab, emb, spec, chunks)
        jobs[name] = ("enhanced", dict(
            vocab=vocab, emb=emb, kw=dict(_kw(kw, True), corpus_sample=corpus),
            chunks=chunks, calls=calls))
    # The frozen table of a loaded tokenizer.
    vocab = _vocab(CORPUS_D)
    tok = JaxTok(vocab, _emb(9, len(vocab)), corpus_sample=CORPUS_D,
                 **FROZEN)
    tok.optimize_merges(steps=6, log_every=6)
    path = str(tmp_path_factory.mktemp("frozen") / "tok")
    tok.save(path)
    want["frozen_start"] = int(tok.state.num_merges)
    j1, t1 = JaxTok.load(path), TT.load(path, device="cpu")
    assert j1.enh_config.frozen_freqs and t1.enh_config.frozen_freqs
    want["frozen"], calls, want["frozen_jax"], want["frozen_k"] = \
        _run_pair(None, None, {}, [6], j1, t1)
    jobs["frozen"] = ("enhanced", dict(load=path, chunks=[6], calls=calls))
    # Embedding pretraining.
    emb0 = np.asarray(JL.random_points(jax.random.PRNGKey(0), 64, 8,
                                       sigma=0.3))
    corpus = np.asarray([i % 24 for i in range(255)] + [-2], np.int32)
    kw = dict(steps=20, batch=32, negatives=4)
    e1, l1 = j_embed(jnp.asarray(emb0), jnp.asarray(corpus), 24,
                     jax.random.PRNGKey(1), **kw)
    emb0 = emb0.copy()
    rec = RecordingSampler(ReplayDraws(jax.random.PRNGKey(1), 3))
    TET.train_embeddings(torch.from_numpy(emb0), torch.from_numpy(corpus),
                         24, rec, **kw)
    want["embed"] = (np.asarray(e1), np.asarray(l1))
    jobs["embed"] = ("embed", dict(emb=emb0, corpus=corpus, vocab_size=24,
                                   kw=kw, calls=rec.calls))
    vocab = _vocab(CORPUS_D)
    jobs["layout"] = ("layout", dict(
        vocab=vocab, emb=_emb(9, len(vocab)),
        kw=dict(_kw(CASES["v3"][2], True), corpus_sample=CORPUS_D)))
    return jobs, want


@pytest.fixture(scope="module", params=[2, 4], ids=["d2", "d4"])
def world(request, refs, tmp_path_factory):
    d = request.param
    jobs, want = refs
    out = run_world(d, jobs, str(tmp_path_factory.mktemp(f"world{d}")))
    return d, out, want


def _hist(m):
    return np.asarray(m)


def table(rec) -> dict:
    """{(hi, lo): count} of a pair table."""
    keys, counts = rec["pair_keys"], rec["pair_counts"]
    real = keys[:, 0] != TE.scoring.PKEY_SENT
    return {(int(a), int(b)): int(c)
            for (a, b), c in zip(keys[real], counts[real])}


def check_enhanced(world, name, whole=False):
    """Every rank's chunks == the port's single-device chunks (merges,
    queues, pair table, curvature), whose history equals JAX's up to the
    clamp floor (``whole``: all of it); returns the ranks' last chunks."""
    d, out, want = world
    jst, k = want[name + "_jax"], want[name + "_k"]
    assert k >= 2
    if whole:
        assert k == int(jst.base.num_merges)
    last = []
    for r in range(d):
        for got, ref in zip(out[r][name]["chunks"], want[name]):
            for field in ("merges", "q_i", "q_j"):
                np.testing.assert_array_equal(got[field], ref[field],
                                              err_msg=field)
            assert got["curvature"] == ref["curvature"]
            # v3 leaves the same pairs and counts in hash-partition order.
            assert table(got) == table(ref)
            if got["path"] != "v3":
                np.testing.assert_array_equal(got["pair_keys"],
                                              ref["pair_keys"])
        last.append(out[r][name]["chunks"][-1])
        np.testing.assert_array_equal(last[-1]["merges"][:k],
                                      jst.base.merges[:k])
    return last


def test_sharded_equals_single_device(world):
    """The distance-only loop on every rank == the port's single-device
    run (itself JAX's up to a tie, ``check_base_against_jax``)."""
    d, out, want = world
    ref = want["base"]
    n = int(ref.num_merges)
    assert n > 3
    for r in range(d):
        got = out[r]["base"][0]
        np.testing.assert_array_equal(got["merges"], ref.merges[:n].numpy())
        np.testing.assert_allclose(got["emb"], ref.emb.numpy(), atol=1e-6)
        assert got["threshold"] == float(ref.threshold)


def test_sharded_chained_calls(world):
    d, out, want = world
    ref = want["chained"]
    n = int(ref.num_merges)
    for r in range(d):
        s2 = out[r]["chained"][1]
        assert s2["step"] == 10
        np.testing.assert_array_equal(s2["merges"], ref.merges[:n].numpy())


def test_state_sharding_layout(world):
    d, out, _ = world
    shards = []
    for r in range(d):
        lay = out[r]["layout"]
        assert lay["mesh"] == (r, d, "cpu", "gloo")
        assert set(lay["base"].values()) == {"rep"}
        assert (lay["corpus"], lay["pair_keys"], lay["q_i"]) == \
            ("row", "owner", "rep")
        n = lay["whole"].shape[0]
        assert lay["shard"].shape == (n // d,) and lay["rep"] == n
        shards.append(lay["shard"])
    np.testing.assert_array_equal(np.concatenate(shards), lay["whole"])


def test_enhanced_sharded_equals_single_device(world):
    last = check_enhanced(world, "default")
    assert last[0]["merges"].shape[0] > 2


def test_enhanced_sharded_priority_replay(world):
    last = check_enhanced(world, "priority", whole=True)
    assert last[0]["merges"].shape[0] > 2


def test_embed_train_sharded_matches_single(world):
    d, out, want = world
    e1, l1 = want["embed"]
    for r in range(d):
        got = out[r]["embed"]
        np.testing.assert_allclose(got["losses"], l1, atol=1e-4)
        np.testing.assert_allclose(got["emb"], e1, atol=1e-4)
        e = torch.from_numpy(got["emb"]).double()
        sig = torch.ones(e.shape[1], dtype=torch.float64)
        sig[0] = -1.0
        dots = -(e * sig * e).sum(-1)
        np.testing.assert_allclose(dots.numpy(), 1.0, atol=1e-4)


def test_embed_train_world_of_one_is_bit_equal(refs):
    """At a world of one the sharded trainer is ``train_embeddings`` bit
    for bit (its slice is the whole batch, its reduce the identity)."""
    from hyptokenizer_tpu_torch.parallel.mesh import Mesh
    from hyptokenizer_tpu_torch.parallel.sharded import \
        run_embed_train_sharded
    from tests.torch_parallel_worker import PlaybackSampler
    spec = refs[0]["embed"][1]
    one = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
               backend="gloo")
    args = (torch.from_numpy(spec["emb"]), torch.from_numpy(spec["corpus"]),
            spec["vocab_size"])
    e1, l1 = TET.train_embeddings(*args, PlaybackSampler(spec["calls"]),
                                  **spec["kw"])
    e2, l2 = run_embed_train_sharded(*args, PlaybackSampler(spec["calls"]),
                                     one, **spec["kw"])
    assert torch.equal(e1, e2) and torch.equal(l1, l2)


def test_enhanced_sharded_sync_corpus_sharded_path(world):
    """corpus_shards=8: the aligned corpus takes the v3 sync (the dense
    channel on: K2's plain version reads the hashed table), and a chained
    second chunk re-syncs from the gathered corpus."""
    last = check_enhanced(world, "corpus_sharded")
    assert last[0]["path"] == "v3"
    d, out, want = world
    first = want["corpus_sharded"][0]
    assert last[0]["merges"].shape[0] > first["merges"].shape[0] > 2


def test_unaligned_corpus_falls_back_to_replicated_sync(world):
    last = check_enhanced(world, "unaligned")
    assert last[0]["path"] == "replicated"
    assert last[0]["merges"].shape[0] > 0


def _jax_sharded(name, d):
    """The JAX package's sharded run of a case on a d-device mesh."""
    corpus, key, kw, chunks = CASES[name]
    vocab = _vocab(corpus)
    jt = JaxTok(vocab, _emb(key, len(vocab)), corpus_sample=corpus,
                **_kw(kw, False))
    st = jt.enh_state
    for n in chunks:
        st = JRS(st, jt.enh_config, n, jax_mesh(n_devices=d))
    return jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("name", ["v3", "v3_all"])
def test_enhanced_sharded_v3_bit_identical(world, name):
    """The hash-partitioned sync: merges and queues == the single-device
    run's; the gathered hashed table == the single-device table laid out
    for D owners, and at D = 2 the JAX sharded state's (``save()``'s
    frequencies.json reads it). ``v3_all``: the all-features configuration
    with the dense channel reading that table, curvature on the same
    trajectory."""
    from hyptokenizer_tpu_torch.parallel.sharded import hash_partition_table
    last = check_enhanced(world, name, whole=True)
    d, out, want = world
    jst = want[name + "_jax"]
    assert last[0]["path"] == "v3"
    assert last[0]["merges"].shape[0] > 4
    single = want[name][-1]
    hk, hc = hash_partition_table(torch.from_numpy(single["pair_keys"]),
                                  torch.from_numpy(single["pair_counts"]), d)
    js = _jax_sharded(name, d) if d == 2 else None
    for got in last:
        np.testing.assert_array_equal(got["q_i"], jst.q_i)
        np.testing.assert_array_equal(got["q_j"], jst.q_j)
        np.testing.assert_array_equal(got["pair_keys"], hk.numpy())
        np.testing.assert_array_equal(got["pair_counts"], hc.numpy())
        if js is not None:
            np.testing.assert_array_equal(got["pair_keys"], js.pair_keys)
            np.testing.assert_array_equal(got["pair_counts"],
                                          js.pair_counts)
        np.testing.assert_allclose(got["curvature"],
                                   float(jst.base.curvature), rtol=1e-6)


def test_enhanced_sharded_frozen_preserves_freqs_and_matches(world):
    """A loaded (frozen-frequency) tokenizer takes v3f: the same merges and
    queues as one device, and the restored table untouched."""
    last = check_enhanced(world, "frozen", whole=True)
    d, out, want = world
    assert last[0]["path"] == "v3f"
    assert last[0]["merges"].shape[0] > want["frozen_start"]
    for r in range(d):
        keys0, counts0 = out[r]["frozen"]["table_before"]
        assert counts0.sum() > 0
        np.testing.assert_array_equal(last[r]["pair_keys"], keys0)
        np.testing.assert_array_equal(last[r]["pair_counts"], counts0)
