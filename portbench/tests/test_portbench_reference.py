"""Port against reference at a toy size on the CPU: sound runs come out
correct, the lower-precision controls do not, and a run whose timed path
is broken underneath comes out not correct."""

import dataclasses

import pytest
import torch

from portbench import controls, registry, run
from portbench.reference import corpus_training as R
from portbench.tests.conftest import SMALL_FLAGSHIP, SMALL_PRETRAIN, smaller

PRETRAIN_FAULT = smaller(SMALL_PRETRAIN, embed_steps=300)
# A queue shorter than the table (resyncs when fewer than a batch are
# left) on a corpus that runs out of pairs before the target.
SPENT_FLAGSHIP = dict(smaller(SMALL_FLAGSHIP, queue_size=40, steps=3000,
                              target_vocab_size=1000),
                      traffic=dict(max_lines=12))


def test_replay_is_classic_bpe_in_rank_order():
    # "a a a b": rule 0 (a,a)->X takes the leftmost, rule 1 (a,b)->Y the
    # rest; "b a b": rule (a,b) ranks before (b,a).
    a, b = 0, 1
    corpus = torch.tensor([a, a, a, b, -2, b, a, b, -1, -1],
                          dtype=torch.int32)
    rules = torch.tensor([[a, a], [a, b], [b, a]])
    out = R.replay(corpus, rules, 10)
    assert out.tolist() == [10, 11, -2, b, 11, -1, -1, -1, -1, -1]
    keys, counts, n = R.pair_table(out, 2)
    assert n == 2 and keys.tolist() == [(b << 32) | 11, (10 << 32) | 11]
    assert counts.tolist() == [1, 1]


@pytest.mark.parametrize("seed,cfg", [
    (1, SMALL_FLAGSHIP), (2**31 + 7, SMALL_FLAGSHIP),
    (5_000_000_017, SMALL_FLAGSHIP), (4, SPENT_FLAGSHIP)])
def test_port_against_reference_flagship(seed, cfg):
    r = run.run_cell("flagship.wiki", seed, 0.1, False, "cpu", cfg)
    assert r["correct"], r["compared"]
    assert r["compared"]["merge_score_gap"]["value"] < 1e-6


def test_schedule_of_a_small_recipe():
    # Chunks of 40 merges in batches of 16, a curvature step every 40.
    # Chunk 0: a whole queue of 40 (16 + 16 + 8). Chunk 1 syncs at 40, then
    # takes its curvature step; a truncated queue of 20 resyncs at 56, when
    # 4 are left; the chunk ends at the first batch end past 80 (88).
    # Chunk 2: 5, a resync, 30 (16 + 14), the curvature step at 123 before
    # the spent queue's resync, which finds nothing; two chunks whose
    # syncs find nothing end the training before its seventh chunk.
    rec = R.Recipe.from_config(dict(
        registry.config("flagship"), curvature_freq=40, merge_batch=16,
        log_every=40, steps=260, queue_size=20, target_vocab_size=10**6,
        max_vocab_size=10**6))
    events = R.schedule(rec, 10)
    seen = [next(events)]
    replies = iter([(40, False), (20, True), (100, True), (5, False),
                    (30, False), (0, False), (0, False), (0, False)])
    while seen[-1][0] != "end":
        seen.append(events.send(next(replies)) if seen[-1][0] == "coherence"
                    else next(events))
    assert seen == [
        ("coherence", 0), ("coherence", 40), ("curvature", 40),
        ("coherence", 56), ("coherence", 88), ("curvature", 88),
        ("coherence", 93), ("curvature", 123), ("coherence", 123),
        ("coherence", 123), ("coherence", 123), ("end", 123)]


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_port_against_reference_pretrain(seed):
    r = run.run_cell("quickstart.pretrain", seed, 0.1, False, "cpu",
                     SMALL_PRETRAIN)
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("cell,cfg", [("flagship.wiki", SMALL_FLAGSHIP),
                                      ("quickstart.pretrain", SMALL_PRETRAIN)])
def test_the_control_is_not_correct(cell, cfg):
    out = controls.run_control(cell, 11, "bfloat16", "cpu", cfg)
    assert not out["correct"], out
    same = controls.run_control(cell, 11, "tf32", "cpu", cfg)
    assert same["correct"], same


def _broken(monkeypatch, cell, patch):
    """The cell's job kind with ``patch(monkeypatch)`` applied once the
    window starts (the warm-up runs the sound program)."""
    kind = registry.job(registry.cell(cell)["job"])
    job = kind.job
    patched = []

    def broken_job(ctx, k, traced=False):
        if not patched:
            patch(monkeypatch)
            patched.append(k)
        return job(ctx, k, traced)

    monkeypatch.setattr(kind, "job", broken_job)


def _state_unchanged(mp):
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    mp.setattr(E, "enhanced_step", lambda st, config, sampler: st)


def _pair_altered(mp):
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    insert = E.insert_batch

    def altered(state, ii, jj, dd, **kw):
        ii, jj = ii.clone(), jj.clone()
        ii[0], jj[0] = jj[0].clone(), ii[0].clone()
        return insert(state, ii, jj, dd, **kw)

    mp.setattr(E, "insert_batch", altered)


def _point_altered(mp):
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    insert = E.insert_batch

    def altered(state, ii, jj, dd, **kw):
        out = insert(state, ii, jj, dd, **kw)
        out.emb[int(state.vocab_size)] *= 1.05
        return out

    mp.setattr(E, "insert_batch", altered)


def _curvature_skipped(mp):
    """Each curvature step is marked as taken and left undone: no draw, no
    Adam step (a step that returns its state unchanged never lets the
    segments past the first multiple, and the chunk raises)."""
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    def skip(st, config, sampler):
        nm, freq = int(st.base.num_merges), config.curvature_freq
        if nm // freq <= int(st.curv_last) // freq:
            return st
        return dataclasses.replace(st, curv_last=torch.full_like(
            st.curv_last, nm))

    mp.setattr(E, "_maybe_update_curvature", skip)


def _chunk_sync_dropped(mp):
    """Every chunk after the first goes on from the last chunk's queue:
    its opening sync returns the state as it is."""
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    run_enhanced = E.run_enhanced

    def stale(st, config, n_steps, sampler, sync=None):
        opening = [int(st.base.num_merges) > 0]

        def sync_once(st, config, sampler):
            if opening.pop() if opening else False:
                return st
            return E.sync_corpus(st, config, sampler)

        return run_enhanced(st, config, n_steps, sampler, sync=sync_once)

    mp.setattr(E, "run_enhanced", stale)


def _table_unchanged(mp):
    from hyptokenizer_tpu_torch.ops import lorentz

    mp.setattr(lorentz, "rsgd_step", lambda x, g, lr, c=1.0: x)


def _half_batch(mp):
    from hyptokenizer_tpu_torch.tokenizer import embed_train

    nll = embed_train._ranking_nll

    def half(e, u, v, neg, c):
        out = nll(e, u, v, neg, c)
        b = out.shape[0] // 2
        return torch.cat([2 * out[:b], 0 * out[b:]])

    mp.setattr(embed_train, "_ranking_nll", half)


@pytest.mark.parametrize("cell,small,patch", [
    ("flagship.wiki", SMALL_FLAGSHIP, _state_unchanged),
    ("flagship.wiki", SMALL_FLAGSHIP, _pair_altered),
    ("flagship.wiki", SMALL_FLAGSHIP, _point_altered),
    ("flagship.wiki", SMALL_FLAGSHIP,
     _curvature_skipped),
    ("flagship.wiki", SMALL_FLAGSHIP,
     _chunk_sync_dropped),
    ("quickstart.pretrain", PRETRAIN_FAULT,
     _table_unchanged),
    ("quickstart.pretrain", PRETRAIN_FAULT, _half_batch),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, small,
                                            patch):
    _broken(monkeypatch, cell, patch)
    r = run.run_cell(cell, 21, 0.1, False, "cpu", small)
    assert r["correct"] is False, r["compared"]


def test_recipe_reads_the_configuration():
    rec = R.Recipe.from_config(dict(registry.config("flagship"),
                                    curvature_freq=1000))
    assert dataclasses.asdict(rec)["merge_batch"] == 16
