"""The port's ``evals/selfcheck.kernel_selfcheck`` and its two enhanced
checks, on the CPU, where both sides of each lockstep are the plain
version: every verdict "pass"; a merge corrupted on the kernel's side
records "FAIL ..."; a check that raises records "error: ..." and leaves
the other verdicts standing; the checks build their tokenizers with the
JAX package's constructor arguments; and without a card the report is the
skip verdict.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hyptokenizer_tpu.evals import selfcheck as JS
from hyptokenizer_tpu_torch.evals import selfcheck as TS
from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop

CHECKS = [("_check_enhanced_kernel", "enhanced_kernel_selfcheck"),
          ("_check_enhanced_full_features", "enhanced_full_selfcheck")]


@pytest.mark.parametrize("check,name", CHECKS)
def test_enhanced_check_passes_plain_against_plain(check, name):
    out = {}
    getattr(TS, check)(out, device="cpu")
    assert out[name] == "pass"
    assert out[f"{name}_merges"] == 32          # 4 chunks of 8 merges
    assert out[f"{name}_reorders"] == 0 == out[f"{name}_dist_ties"]


@pytest.mark.parametrize("check,name", CHECKS)
def test_corrupted_merge_fails(monkeypatch, check, name):
    """The kernel's side of the second chunk merges a pair the plain
    version did not, at a distance far from the plain pick's."""
    real = enhanced_loop.run_chunk
    calls = []

    def corrupt(st, config, n_steps, sampler, plain=False, **kw):
        n0 = int(st.base.num_merges)
        out = real(st, config, n_steps, sampler, plain=plain, **kw)
        if not plain:
            calls.append(n0)
            if len(calls) == 2:
                out.base.merges[n0] = torch.tensor([0, 1], dtype=torch.int32)
                out.base.merge_dists[n0] += 1.0
        return out

    monkeypatch.setattr(enhanced_loop, "run_chunk", corrupt)
    out = {}
    getattr(TS, check)(out, device="cpu")
    assert out[name].startswith("FAIL ")
    assert "'kernel': [0, 1]" in out[name]
    assert out[f"{name}_merges"] == 16          # stops at the bad chunk


def test_kernel_selfcheck_on_the_cpu_passes():
    out = TS.kernel_selfcheck("cpu")
    assert {n: out[n] for n, _ in TS.SELFCHECKS} == {
        n: "pass" for n, _ in TS.SELFCHECKS}
    assert TS.selfcheck_failures(out) == {}


def test_a_check_that_raises_keeps_the_others(monkeypatch):
    def boom(out, device):
        raise RuntimeError("kernel did not build\nsecond line")

    monkeypatch.setattr(TS, "_check_enhanced_kernel", boom)
    out = TS.kernel_selfcheck("cpu")
    assert out["enhanced_kernel_selfcheck"] == "error: kernel did not build"
    assert out["kernel_selfcheck"] == "pass"
    assert out["enhanced_full_selfcheck"] == "pass"
    assert TS.selfcheck_failures(out) == {
        "enhanced_kernel_selfcheck": "error: kernel did not build"}


def test_skip_verdict_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = TS.kernel_selfcheck()
    assert out == {"kernel_selfcheck": "skipped (no CUDA device)"}
    assert set(TS.selfcheck_failures(out)) == {n for n, _ in TS.SELFCHECKS}


def _captured(module, check, monkeypatch, **kw):
    """The tokenizer ``check`` hands to its lockstep, and the lockstep's
    sizes."""
    seen = {}

    def capture(tok, n_chunks, chunk, out, name, *a, **k):
        seen.update(tok=tok, n_chunks=n_chunks, chunk=chunk, name=name)

    monkeypatch.setattr(module, "_lockstep_enhanced", capture)
    getattr(module, check)({}, **kw)
    return seen


@pytest.mark.parametrize("check,name", CHECKS)
def test_checks_build_the_jax_tokenizers(monkeypatch, check, name):
    """Same vocabulary, the same configuration field by field (the JAX
    package's ``EnhancedConfig`` fields that the port's has), the same
    corpus buffer and width, and the same lockstep sizes."""
    j = _captured(JS, check, monkeypatch)
    t = _captured(TS, check, monkeypatch, device="cpu")
    jt, tt = j.pop("tok"), t.pop("tok")
    assert t == j and t["name"] == name
    assert tt.vocab == jt.vocab
    shared = {f.name for f in dataclasses.fields(tt.enh_config)} & {
        f.name for f in dataclasses.fields(jt.enh_config)}
    assert len(shared) > 20
    for f in sorted(shared - {"base"}):
        assert getattr(tt.enh_config, f) == getattr(jt.enh_config, f), f
    for f in ("max_vocab_size", "search_block", "max_token_len"):
        assert getattr(tt.enh_config.base, f) == getattr(jt.enh_config.base,
                                                         f), f
    np.testing.assert_array_equal(tt.enh_state.corpus.numpy(),
                                  np.asarray(jt.enh_state.corpus))
    assert tt.state.emb.shape == jt.state.emb.shape == (256, 17)
    assert tt.merge_threshold == jt.merge_threshold
