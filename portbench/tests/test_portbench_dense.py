"""The all-features training against its reference at a toy size on the
CPU: sound trainings come out correct, the schedule is owed event for
event, the bfloat16 control is not correct, and a training whose path is
broken underneath comes out not correct."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import controls, run
from portbench.reference import dense_training as R
from portbench.tests.conftest import smaller
from portbench.tests.test_portbench_imports import _top_level
from portbench.tests.test_portbench_reference import (
    _broken, _curvature_skipped, _point_altered)

# The Quick start's recipe on a few hundred lines: a small pair table and
# queue, the phases switching at 300 and 900 merges, a curvature step every
# 100, the threshold growing at 1,000, the points pretrained for 200 steps
# (a storm of resyncs in the second phase) or not at all.
SMALL_QUICKSTART = {
    "config": dict(max_vocab_size=3000, steps=1600, log_every=400,
                   corpus_max_tokens=20000, freq_table_size=4096,
                   queue_size=256, embed_steps=200, embed_batch=256,
                   embed_corpus_tokens=20000, phase2_step=300,
                   phase3_step=900, optimize_curvature_freq=100),
    "cell": dict(warmup_merges=64),
    "traffic": dict(max_lines=300)}
RANDOM_POINTS = smaller(SMALL_QUICKSTART, embed_steps=0)
CELL = "quickstart.merge"


@pytest.mark.parametrize("seed,small", [
    (1, SMALL_QUICKSTART), (2**31 + 7, SMALL_QUICKSTART),
    (5_000_000_017, RANDOM_POINTS)])
def test_port_against_reference(seed, small):
    r = run.run_cell(CELL, seed, 0.1, False, "cpu", small)
    assert r["correct"], (r["compared"], R.last_unowed)
    assert r["compared"]["merge_score_gap"]["value"] == 0.0
    assert r["compared"]["dense_held_gap"]["value"] == 0.0
    job = r["jobs"][0]
    assert job["merges"] >= 1600
    if small is SMALL_QUICKSTART:
        assert job["syncs"] > 10 * 4   # a storm in the second phase


@pytest.mark.parametrize("seed,small", [
    (1, SMALL_QUICKSTART), (5, RANDOM_POINTS)])
def test_the_search_takes_wrong_readings_back(monkeypatch, seed, small):
    # Intervals 1,700 times float32's leave many steps open to several
    # readings; tried shortest first, most are wrong and show a few steps
    # on. The walk has to take them back and still find the training
    # sound, with no gap (given the room that so many wrong first tries
    # take).
    monkeypatch.setattr(R, "U32", 1e-4)
    monkeypatch.setattr(R, "_preference", lambda r: (max(r[1][:2]), r[0]))
    monkeypatch.setattr(R, "TRIES", 16)
    monkeypatch.setattr(R, "RESTORES", 1024)
    r = run.run_cell(CELL, seed, 0.1, False, "cpu", small)
    assert r["correct"], (r["compared"], R.last_unowed, R.last_search)
    assert r["compared"]["merge_score_gap"]["value"] == 0.0
    assert r["compared"]["dense_held_gap"]["value"] == 0.0
    assert R.last_search["restores"] > 0


def test_schedule_of_a_small_recipe():
    # Chunks of 20 merges (the last 5) in batches of 4 and a dense merge:
    # a resync, two empty rounds and the threshold's growth after them;
    # the curvature step at the first step start past each multiple of 10
    # (43, not 48, for the multiple 40); the
    # second phase at 14 (the first step at or past 12), the third at 33;
    # the threshold grown at each multiple of 16 crossed, and set back by
    # each new phase.
    rec = R.Recipe.from_config(dict(
        SMALL_QUICKSTART["config"], alpha=0.4, beta=0.4, gamma=0.2,
        compression_weight=0.7, use_frequency_aware=True,
        use_compression_aware=True, use_hierarchical=True,
        use_adaptive_curvature=True, merge_batch=4, min_pair_freq=1,
        merge_threshold=0.1, curvature_lr=0.01, hierarchy_weight=1.0,
        distortion_weight=0.1, log_every=20, steps=45, queue_size=64,
        optimize_curvature_freq=10, phase2_step=12, phase3_step=30,
        threshold_growth_every=16, empty_growth_after=2,
        max_vocab_size=10**6))
    f32 = np.float32
    t1 = float(f32(0.05) * f32(1.5))
    t2 = float(f32(0.1) * f32(1.1))
    t3 = float(f32(t2) * f32(1.1))
    t4 = float(f32(0.2) * f32(1.1))
    replies = iter([5, "resync", 0, 0, 5, 4, 5, 5, 5, "resync", 4, 5, 5, 5,
                    5])
    events = R.schedule(rec, 10)
    seen = [next(events)]
    while seen[-1][0] != "end":
        seen.append(events.send(next(replies)) if seen[-1][0] == "step"
                    else next(events))
    th = float(f32(0.05))
    assert seen == [
        ("coherence", 0, th), ("step", 0, 1, th, False),
        ("step", 5, 1, th, True), ("coherence", 5, th),
        ("step", 5, 1, th, False), ("step", 5, 1, th, False),
        ("empty_growth", 5, t1), ("step", 5, 1, t1, False),
        ("curvature", 10), ("step", 10, 1, t1, True),
        ("phase", 14, 2, float(f32(0.1))),
        ("step", 14, 2, float(f32(0.1)), True), ("growth", 19, t2),
        ("step", 19, 2, t2, True),
        ("coherence", 24, t2), ("curvature", 24),
        ("step", 24, 2, t2, False), ("step", 29, 2, t2, True),
        ("coherence", 29, t2), ("step", 29, 2, t2, False),
        ("growth", 33, t3), ("phase", 33, 3, float(f32(0.2))),
        ("curvature", 33), ("step", 33, 3, float(f32(0.2)), True),
        ("step", 38, 3, float(f32(0.2)), True), ("curvature", 43),
        ("step", 43, 3, float(f32(0.2)), True), ("growth", 48, t4),
        ("coherence", 48, t4), ("step", 48, 3, t4, False), ("end", 53)]


def test_the_control_is_not_correct():
    out = controls.run_control(CELL, 11, "bfloat16", "cpu", SMALL_QUICKSTART)
    assert not out["correct"], out
    same = controls.run_control(CELL, 11, "tf32", "cpu", SMALL_QUICKSTART)
    assert same["correct"], (same, R.last_unowed)


def _dense_ignored(mp):
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    candidate = E._dense_candidate

    def never(st, config, pidx):
        di, dj, dd, valid, score = candidate(st, config, pidx)
        return di, dj, dd, torch.zeros_like(valid), score

    mp.setattr(E, "_dense_candidate", never)


def _with_config(mp, change):
    """Every step run with ``change(config)`` for its configuration."""
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    step = E.enhanced_step
    mp.setattr(E, "enhanced_step",
               lambda st, config, sampler: step(st, change(config), sampler))


def _phase_late(mp):
    nb = SMALL_QUICKSTART["config"].get("merge_batch", 8)
    _with_config(mp, lambda c: dataclasses.replace(
        c, phase2_step=c.phase2_step + nb, phase3_step=c.phase3_step + nb))


def _growth_skipped(mp):
    _with_config(mp, lambda c: dataclasses.replace(
        c, base=dataclasses.replace(c.base, threshold_growth=1.0)))


def _resync_dropped(mp):
    """The second phase's resyncs never happen: each step reads a table
    that holds no more candidates than its queue."""
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    step = E.enhanced_step

    def dropped(st, config, sampler):
        if int(st.base.num_merges) < config.phase2_step:
            return step(st, config, sampler)
        out = step(dataclasses.replace(
            st, q_valid_total=torch.zeros_like(st.q_valid_total)), config,
            sampler)
        return dataclasses.replace(out, q_valid_total=st.q_valid_total)

    mp.setattr(E, "enhanced_step", dropped)


@pytest.mark.parametrize("patch", [
    _dense_ignored, _phase_late, _growth_skipped, _resync_dropped,
    _curvature_skipped, _point_altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, patch):
    _broken(monkeypatch, CELL, patch)
    r = run.run_cell(CELL, 21, 0.1, False, "cpu", SMALL_QUICKSTART)
    assert r["correct"] is False, r["compared"]


def test_the_reference_and_readers_load_nothing_of_the_program():
    loaded = _top_level(["portbench.reference.dense_training"])
    assert not loaded & {"jax", "jaxlib", "flax", "hyptokenizer_tpu",
                         "hyptokenizer_tpu_torch"}
    loaded = _top_level(["portbench.jobs.dense_training",
                         "portbench.dense_spans"], metrics=True)
    assert not loaded & {"jax", "jaxlib", "flax", "hyptokenizer_tpu"}


def test_recipe_takes_the_constructors_defaults():
    from portbench import registry
    from portbench.jobs import dense_training as J

    rec = R.Recipe.from_config(registry.config("quickstart"))
    assert (rec.max_token_len, rec.threshold_growth_every,
            rec.empty_growth_after, rec.phase_thresholds) == (
        512, 1000, 6, (0.05, 0.1, 0.2))
    assert J.ASSUMED is R.DEFAULTS
