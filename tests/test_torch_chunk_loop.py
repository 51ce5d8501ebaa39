"""The port's merge-training loop (``enhanced_state.run_enhanced`` and
``run_chunk``): it lives in the tokenizer layer, above the kernel wrapper
of K1/K2, and it reads the device's scalars once after each sync and once
after each segment, and hands them to the curvature step, which reads
nothing of its own. On the CPU the segments are the plain step loop, which
reads its own scalars at every step; those reads are not the chunk
loop's and are not counted here.
"""

import ast
import collections
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from tests.torch_port_common import (  # noqa: F401
    SMALL, history, one_torch_thread, small_vocab_and_emb,
)

PKG = pathlib.Path(__file__).resolve().parents[1] / "hyptokenizer_tpu_torch"
LOOP_NAMES = ("run_chunk", "run_segment", "run_segment_plain", "_halted",
          "_segment_end", "NO_CURVATURE_STOP")
DENSE = dict(use_dense_channel=True, use_hierarchical=True,
             use_compression_aware=True, use_frequency_aware=True,
             alpha=0.4, beta=0.4, gamma=0.2, merge_batch=3,
             merge_threshold=0.4, merge_policy="fixpoint")


def _imports(path: pathlib.Path):
    """(module imported, whether inside a function) for every import
    statement of a file."""
    out = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                out.extend((a.name, fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                out.extend((f"{child.module}.{a.name}", fn)
                           for a in child.names)
            visit(child, fn)

    visit(ast.parse(path.read_text()), False)
    return out


def test_kernel_wrappers_import_no_chunk_loop():
    """No kernel wrapper under ``ops/cuda/`` imports the chunk loop's
    module; that module imports the K1/K2 wrapper once, at its top; and the
    chunk loop's names live in that module only."""
    wrappers = sorted((PKG / "ops" / "cuda").glob("*.py"))
    assert any(p.name == "enhanced_loop.py" for p in wrappers)
    for path in wrappers:
        for name, _ in _imports(path):
            assert not name.startswith(
                "hyptokenizer_tpu_torch.tokenizer.enhanced_state"), \
                (path.name, name)
    kernel = "hyptokenizer_tpu_torch.ops.cuda.enhanced_loop"
    found = [fn for name, fn in _imports(PKG / "tokenizer"
                                         / "enhanced_state.py")
             if name == kernel]
    assert found == [False]
    for name in LOOP_NAMES:
        assert hasattr(E, name) and not hasattr(enhanced_loop, name), name


def test_kernel_wrapper_imports_first():
    """The K1/K2 wrapper imported before anything else of the package (the
    chunk loop's module, which imports it back, loads on the way)."""
    subprocess.run(
        [sys.executable, "-c",
         "import hyptokenizer_tpu_torch.ops.cuda.enhanced_loop as K\n"
         "from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E\n"
         "assert E.enhanced_loop is K\n"],
        check=True, cwd=PKG.parent)


class LoggedSampler(E.TorchSampler):
    """A seeded sampler that keeps every draw it hands out."""

    def __init__(self):
        super().__init__(0, "cpu")
        self.log = []

    def coherence(self, n, high):
        out = super().coherence(n, high)
        self.log.append(("coherence", (out.clone(),)))
        return out

    def curvature(self, hp, hn, ds, high):
        out = super().curvature(hp, hn, ds, high)
        self.log.append(("curvature", tuple(o.clone() for o in out)))
        return out


def _train(tok, chunks: int, per_chunk: int):
    st, sampler = E.clone_state(tok.enh_state), LoggedSampler()
    for _ in range(chunks):
        st, _ = E.run_enhanced(st, tok.enh_config, per_chunk, sampler)
    return st, sampler.log


def _record(mp) -> list:
    """Marks, in order, the chunk loop's syncs (S), segments (G), curvature
    steps (C), scalar reads (s), and host reads of a tensor made in
    ``run_chunk`` (r) and in ``run_enhanced`` (e)."""
    marks = []
    loop_code = {E.run_chunk.__code__: "r", E.run_enhanced.__code__: "e"}

    def caller():
        return sys._getframe(2).f_code

    def mark(name, tag, only_loop):
        fn = getattr(E, name)

        def marked(*a, **k):
            if not only_loop or caller() in loop_code:
                marks.append(tag)
            return fn(*a, **k)

        mp.setattr(E, name, marked)

    mark("sync_corpus", "S", False)
    mark("run_segment", "G", False)
    mark("_maybe_update_curvature", "C", True)
    mark("state_scalars", "s", True)
    for name in ("__int__", "__bool__", "__float__", "__index__", "item",
                 "tolist"):
        read = getattr(torch.Tensor, name)

        def counted(self, *a, _read=read, **k):
            tag = loop_code.get(caller())
            if tag:
                marks.append(tag)
            return _read(self, *a, **k)

        mp.setattr(torch.Tensor, name, counted)
    return marks


@pytest.mark.parametrize("overrides", [{}, DENSE],
                         ids=["corpus-only", "dense"])
def test_chunk_loop_reads_each_scalar_once(monkeypatch, overrides):
    """One read of the scalars after each sync and after each segment, and
    none after a curvature step, which runs only when one is due and takes
    the loop's scalars; besides them, each chunk's opening read of the
    merge count (and, with the dense channel, of its poisoned-state
    guard). The same merges and the same draws as an unwatched run."""
    vocab, emb = small_vocab_and_emb()
    kw = dict(SMALL, optimize_curvature_freq=5, queue_size=16, **overrides)
    tok = EnhancedHyperbolicTokenizer(vocab, emb, device="cpu", **kw)
    chunks, per_chunk = 3, 16
    want, want_draws = _train(tok, chunks, per_chunk)

    with monkeypatch.context() as mp:
        marks = _record(mp)
        got, draws = _train(tok, chunks, per_chunk)
    trace = "".join(marks)
    opening = "ee" if overrides else "e"
    rounds = r"(?:Ss(?:C?Gs)*)+"
    assert re.fullmatch(f"(?:{opening}{rounds}){{{chunks}}}", trace), trace
    n = collections.Counter(trace)
    steps = sum(kind == "curvature" for kind, _ in want_draws)
    assert n["C"] == steps > 0 and n["r"] == 0
    assert n["S"] >= chunks and n["G"] > n["S"]
    np.testing.assert_array_equal(history(got), history(want))
    assert len(history(got)) == chunks * per_chunk
    assert [k for k, _ in draws] == [k for k, _ in want_draws]
    for (_, a), (_, b) in zip(draws, want_draws):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_curvature_step_that_does_not_advance_raises(monkeypatch):
    """A curvature step that leaves its counter where it was: the chunk
    loop reads the counter after the next segment, and its no-progress
    guard raises."""
    vocab, emb = small_vocab_and_emb()
    tok = EnhancedHyperbolicTokenizer(vocab, emb, device="cpu", **SMALL)
    monkeypatch.setattr(E, "_maybe_update_curvature",
                        lambda st, config, sampler, scalars=None: st)
    with pytest.raises(RuntimeError, match="no progress"):
        E.run_enhanced(tok.enh_state, tok.enh_config, 24,
                       E.TorchSampler(0, "cpu"))
