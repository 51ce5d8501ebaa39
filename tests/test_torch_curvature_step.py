"""The curvature Adam step (``enhanced_state._maybe_update_curvature``) and
its kernel C1 (``ops/cuda/curvature_step.py``).

On the CPU: the loss's curvature gradient in closed form (the kernel's
arithmetic, written here in PyTorch) against autograd through
``enhanced_state._curvature_losses``, within 1e-5 relative, on the edges of
the loss (no merges, fewer merges than ``hier_pairs``, negatives on the
pair, distortion self-pairs, no active hinge, the curvature at either
bound); the step taking the plain version for CPU tensors, reading nothing
when handed the chunk loop's scalars; the wrapper's refusals; the
``curvature.kernel_launches`` counter. On the card (marker ``cuda``): C1
against ``curvature_adam_plain`` on the same tensors at the flagship's and
the Quick start's sizes and on small edge states (curvature and moments
within 1e-5 relative, the rescaled distances within 1e-5 relative with
their infinities kept, the counters equal), two launches giving the same
bits, no synchronisation with the scalars handed in, and the counter in a
traced training.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hyptokenizer_tpu_torch.ops import lorentz as L
from hyptokenizer_tpu_torch.ops.cuda import curvature_step as C1
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from hyptokenizer_tpu_torch.tokenizer import scoring
from hyptokenizer_tpu_torch.tokenizer import state as S
from hyptokenizer_tpu_torch.utils import metrics

INF = float("inf")
FREQ = 100


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def config(**kw) -> E.EnhancedConfig:
    return E.EnhancedConfig(**dict(dict(
        use_adaptive_curvature=True, curvature_freq=FREQ, queue_size=64),
        **kw))


def curvature_state(device, *, max_v=256, d=16, vocab=200, nm=150,
                    sigma=0.5, seed=0, queue_size=64, poisoned=True,
                    c=1.0, t=0, m=0.0, v=0.0) -> E.EnhancedState:
    """An enhanced state with what the curvature step reads: ``vocab``
    points at ``sigma``, ``nm`` merges of random pairs (some of them
    self-pairs), the counter one step behind ``nm``, the queue's distances
    finite in part and inf elsewhere, ``best_dist`` all -inf (``poisoned``,
    a corpus-only state) or finite over the active rows with an -inf and an
    inf among them and inf beyond."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    emb0 = L.random_points(gen, vocab, d, sigma=sigma, device="cpu")
    base = S.init_state(emb0, torch.ones(vocab, dtype=torch.int32),
                        curvature=c, config=S.MergeConfig(
                            max_vocab_size=max_v, init_candidates=False),
                        device="cpu")
    pairs = rng.integers(0, vocab, (nm, 2))
    pairs[::17, 1] = pairs[::17, 0]
    base.merges[:nm] = torch.from_numpy(pairs.astype(np.int32))
    base.num_merges = torch.tensor(nm, dtype=torch.int32)
    if not poisoned:
        bd = torch.full((max_v,), INF)
        bd[:vocab] = torch.from_numpy(rng.uniform(0.05, 8.0, vocab)
                                      .astype(np.float32))
        bd[3], bd[5] = -INF, INF
        base.best_dist = bd
    buffers = E.assemble_enhanced_buffers(
        np.zeros((vocab, 4), np.int32), np.full(1, scoring.HKEY_SENT),
        np.full(1, scoring.HKEY_SENT), 0, 0, max_v, 8, queue_size, 4,
        "cpu")
    q = rng.uniform(0.05, 8.0, (3, queue_size)).astype(np.float32)
    q[:, queue_size // 2:] = INF
    buffers.update(
        q_dist=torch.from_numpy(q), curv_m=torch.tensor(m),
        curv_v=torch.tensor(v), curv_t=torch.tensor(t, dtype=torch.int32),
        curv_last=torch.tensor(nm // FREQ * FREQ - FREQ, dtype=torch.int32))
    st = E.EnhancedState(base=base, corpus=torch.full((8,), -1,
                                                      dtype=torch.int32),
                         **buffers)
    return state_to(st, torch.device(device))


def state_to(st, dev):
    return dataclasses.replace(
        st, base=dataclasses.replace(st.base, **{
            f.name: getattr(st.base, f.name).to(dev)
            for f in dataclasses.fields(st.base)}),
        **{f.name: getattr(st, f.name).to(dev)
           for f in dataclasses.fields(st) if f.name != "base"})


def draws_for(st, cfg, seed=1):
    """The step's draws (negatives, ii, jj), int32 ids below the
    vocabulary size, on the state's device."""
    rng = np.random.default_rng(seed)
    high = int(st.base.vocab_size)
    dev = st.base.emb.device

    def draw(*shape):
        return torch.from_numpy(rng.integers(0, high, shape)
                                .astype(np.int32)).to(dev)

    return (draw(cfg.hier_pairs, cfg.hier_negatives),
            draw(cfg.distortion_samples), draw(cfg.distortion_samples))


class FixedDraws:
    """A sampler that hands out the given curvature draws."""

    def __init__(self, draws):
        self.draws = draws
        self.calls = 0

    def curvature(self, hp, hn, ds, high):
        self.calls += 1
        return self.draws


def closed_form(st, cfg, draws, c):
    """dL/dc of ``_curvature_losses`` in closed form (the kernel's
    arithmetic): every distance is A / sqrt(c) with A free of c. Returns
    (g, active hinges)."""
    negs, ii, jj = (x.long() for x in draws)
    base = st.base
    emb = base.emb
    nm = int(base.num_merges)
    hp = cfg.hier_pairs
    idx = torch.arange(hp)
    take = torch.clamp(max(nm - hp, 0) + idx, max=max(nm - 1, 0))
    valid = idx < min(nm, hp)
    pi = base.merges[take, 0].long()
    pj = base.merges[take, 1].long()

    def a(x, y):
        return L.acosh(torch.clamp_min(L.minkowski_dot(x, y),
                                       1.0 + E.GRAD_EPS))

    a_p = a(emb[pi], emb[pj])
    a_x = a(emb[pi][:, None, :], emb[negs])
    a_y = a(emb[pj][:, None, :], emb[negs])
    sq = torch.sqrt(c)
    pair_d = a_p / sq
    act_x = (pair_d[:, None] - a_x / sq + 0.1) > 0
    act_y = (pair_d[:, None] - a_y / sq + 0.1) > 0
    not_self = (negs != pi[:, None]) & (negs != pj[:, None])
    zero = torch.zeros(())
    term = (torch.where(act_x, a_p[:, None] - a_x, zero)
            + torch.where(act_y, a_p[:, None] - a_y, zero))
    per = (torch.where(not_self, term, zero).sum(dim=1)
           / torch.clamp_min(not_self.sum(dim=1), 1))
    d_hier = (torch.where(valid, per, zero).sum()
              / (2 * torch.clamp_min(valid.sum(), 1)))
    active = int((not_self & valid[:, None] & (act_x | act_y)).sum())

    keep = ii != jj
    n = torch.clamp_min(keep.sum(), 1)
    ad = a(emb[ii], emb[jj])
    mu = torch.where(keep, ad, zero).sum() / n
    var = torch.where(keep, (ad - mu) ** 2, zero).sum() / n
    s = 1.0 / sq
    d_dist = -10.0 * mu * torch.exp(-10.0 * s * mu) + 0.2 * s * var
    g = ((cfg.hierarchy_weight * d_hier + cfg.distortion_weight * d_dist)
         * (-0.5 * s / c))
    return g, active


def autograd_grad(st, cfg, draws, c):
    with torch.enable_grad():
        cc = c.clone().requires_grad_(True)
        return torch.autograd.grad(E._curvature_losses(st, cfg, draws, cc),
                                   cc)[0]


def _negatives_on_the_pair(st, cfg, draws):
    negs, ii, jj = (x.clone() for x in draws)
    nm, hp = int(st.base.num_merges), cfg.hier_pairs
    take = torch.clamp(max(nm - hp, 0) + torch.arange(hp),
                       max=max(nm - 1, 0))
    pi, pj = (st.base.merges[take, k] for k in (0, 1))
    negs[:, :3] = pi[:, None]
    negs[:, 3:5] = pj[:, None]
    negs[7] = pi[7]               # a pair with no negative left
    return st, (negs, ii, jj)


def _distortion_self_pairs(st, cfg, draws):
    negs, ii, jj = draws
    jj = jj.clone()
    jj[::3] = ii[::3]
    return st, (negs, ii, jj)


def _every_distortion_pair_a_self_pair(st, cfg, draws):
    negs, ii, _ = draws
    return st, (negs, ii, ii.clone())


def _no_active_hinge(st, cfg, draws):
    """Every merge pair a token with itself, so the pair's distance is the
    clamp floor's and no negative lies within the margin."""
    st = E.clone_state(st)
    st.base.merges[:, 1] = st.base.merges[:, 0]
    return st, draws


def _at_num_merges(nm):
    def edit(st, cfg, draws):
        st = E.clone_state(st)
        st.base.num_merges = torch.tensor(nm, dtype=torch.int32)
        return st, draws
    return edit


def _at_curvature(which):
    def edit(st, cfg, draws):
        c = getattr(cfg, which)
        return dataclasses.replace(st, base=dataclasses.replace(
            st.base, curvature=torch.tensor(c))), draws
    return edit


CASES = {
    "trained": lambda st, cfg, draws: (st, draws),
    "no merges": _at_num_merges(0),
    "fewer merges than hier_pairs": _at_num_merges(37),
    "negatives on the pair": _negatives_on_the_pair,
    "distortion self-pairs": _distortion_self_pairs,
    "every distortion pair a self-pair": _every_distortion_pair_a_self_pair,
    "no active hinge": _no_active_hinge,
    "curvature at its minimum": _at_curvature("curvature_min"),
    "curvature at its maximum": _at_curvature("curvature_max"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_closed_form_equals_autograd(case):
    cfg = config()
    st = curvature_state("cpu")
    st, draws = CASES[case](st, cfg, draws_for(st, cfg))
    c = st.base.curvature
    want = autograd_grad(st, cfg, draws, c)
    got, active = closed_form(st, cfg, draws, c)
    assert (active == 0) == (case in ("no merges", "no active hinge"))
    assert float(want) != 0.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_cpu_step_takes_the_plain_version_and_reads_nothing(monkeypatch):
    """For CPU tensors the step is ``curvature_adam_plain`` on the
    sampler's draws, bit for bit; handed the chunk loop's scalars it reads
    nothing of the device; a step that is not due draws nothing."""
    cfg = config()
    st = curvature_state("cpu", t=2, m=0.01, v=1e-4, c=0.9)
    draws = draws_for(st, cfg)
    sc = E.state_scalars(st)
    want = E.curvature_adam_plain(st, cfg, draws, sc["num_merges"])

    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(C1, "step", refuse)
    reads = []
    for name in ("__int__", "__bool__", "__float__", "__index__", "item",
                 "tolist"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    sampler = FixedDraws(draws)
    got = E._maybe_update_curvature(st, cfg, sampler, scalars=sc)
    assert reads == [] and sampler.calls == 1
    got_read = E._maybe_update_curvature(st, cfg, FixedDraws(draws))
    assert reads
    monkeypatch.undo()
    for out in (got, got_read):
        for name in ("curvature", "best_dist"):
            assert torch.equal(getattr(out.base, name),
                               getattr(want.base, name))
        for name in ("q_dist", "curv_m", "curv_v", "curv_t", "curv_last"):
            assert torch.equal(getattr(out, name), getattr(want, name))
    assert int(got.curv_t) == 3 and int(got.curv_last) == sc["num_merges"]
    assert bool((got.base.best_dist == -INF).all())
    idle = FixedDraws(draws)
    assert E._maybe_update_curvature(got, cfg, idle) is got
    assert idle.calls == 0


def wrapper_inputs(device="cpu"):
    cfg = config()
    st = curvature_state(device, poisoned=False)
    negs, ii, jj = draws_for(st, cfg)
    base = st.base
    return dict(emb=base.emb, merges=base.merges, num_merges=base.num_merges,
                negs=negs, ii=ii, jj=jj, curvature=base.curvature,
                curv_m=st.curv_m, curv_v=st.curv_v, curv_t=st.curv_t,
                best_dist=base.best_dist, q_dist=st.q_dist)


WRAPPER_CONFIG = dict(hierarchy_weight=1.0, distortion_weight=0.5, lr=0.01,
                      curvature_min=0.1, curvature_max=10.0)
BAD = {
    "CPU tensors": ({}, "CUDA tensor"),
    "negs int64": ({"negs": "long"}, "negs: dtype"),
    "emb not contiguous": ({"emb": "t"}, "emb: not contiguous"),
    "merges of another vocabulary": ({"merges": "short"}, "merges: shape"),
    "jj too short": ({"jj": "short"}, "jj: shape"),
    "num_merges int64": ({"num_merges": "long"}, "num_merges: dtype"),
    "curvature float64": ({"curvature": "double"}, "curvature: dtype"),
    "curv_t of two": ({"curv_t": "two"}, "curv_t: 2 elements"),
    "best_dist too short": ({"best_dist": "short"}, "best_dist: shape"),
    "q_dist of one phase": ({"q_dist": "short"}, "q_dist: shape"),
}


def spoil(t, how):
    return {"long": lambda: t.long(), "t": lambda: t.t().contiguous().t(),
            "short": lambda: t[:-1], "double": lambda: t.double(),
            "two": lambda: t.reshape(1).repeat(2)}[how]()


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_refuses_bad_tensors(case):
    change, message = BAD[case]
    inp = wrapper_inputs()
    inp.update({k: spoil(inp[k], how) for k, how in change.items()})
    C1.reset_launches()
    with pytest.raises(ValueError, match=message):
        C1.step(**inp, **WRAPPER_CONFIG)
    assert C1.launches == 0


def test_kernel_launches_counted_only_while_tracing():
    C1.reset_launches()
    metrics.tracing()
    C1._launched(0)
    assert C1.launches == 1
    with torch.profiler.profile():
        C1._launched(0)
        C1._launched(0)
    assert C1.launches == 3
    assert metrics.trace_snapshot()["counters"] == {
        "curvature.kernel_launches": 2}
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        C1._launched(700)
    assert C1.launches == 3


# ------------------------------------------------------------------ card

# The flagship's corpus-only state near the end of its training (d = 100,
# 50,176 slots, about 45,000 merges) and the Quick start's dense state
# partway through its (50,000 slots, finite candidate distances).
SIZED = {
    "flagship": dict(max_v=50_176, d=100, vocab=45_100, nm=44_950,
                     sigma=0.5, queue_size=4096, poisoned=True),
    "quickstart": dict(max_v=50_000, d=100, vocab=20_044, nm=20_000,
                       sigma=0.3, queue_size=4096, poisoned=False),
    "no merges": dict(nm=0),
    "fewer merges than hier_pairs": dict(nm=37, poisoned=False),
}


def assert_steps_match(got, want):
    for a, b in ((got.base.curvature, want.base.curvature),
                 (got.curv_m, want.curv_m), (got.curv_v, want.curv_v),
                 (got.base.best_dist, want.base.best_dist),
                 (got.q_dist, want.q_dist)):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    assert torch.equal(got.curv_t, want.curv_t)
    assert torch.equal(got.curv_last, want.curv_last)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SIZED))
def test_kernel_matches_plain(cuda, case):
    """Three steps in turn, each from the plain version's state, C1 against
    ``curvature_adam_plain`` on the same draws; the infinities of both
    distance arrays kept."""
    cfg = config(queue_size=SIZED[case].get("queue_size", 64))
    st = curvature_state(cuda, **SIZED[case])
    for k in range(3):
        draws = draws_for(st, cfg, seed=k)
        sc = E.state_scalars(st)
        C1.reset_launches()
        got = E._maybe_update_curvature(st, cfg, FixedDraws(draws),
                                        scalars=sc)
        assert C1.launches == 1
        want = E.curvature_adam_plain(st, cfg, draws, sc["num_merges"])
        assert_steps_match(got, want)
        assert float(want.base.curvature) != float(st.base.curvature)
        for a, b in ((got.base.best_dist, st.base.best_dist),
                     (got.q_dist, st.q_dist)):
            assert torch.equal(torch.isfinite(a), torch.isfinite(b))
            assert torch.equal(a[~torch.isfinite(a)], b[~torch.isfinite(b)])
        st = dataclasses.replace(want, curv_last=torch.full_like(
            want.curv_last, sc["num_merges"] - FREQ))


@pytest.mark.cuda
def test_kernel_gives_the_same_bits_twice(cuda):
    inp = wrapper_inputs(cuda)
    first = C1.step(**inp, **WRAPPER_CONFIG)
    second = C1.step(**inp, **WRAPPER_CONFIG)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert float(first[0]) != float(inp["curvature"])


@pytest.mark.cuda
def test_step_with_scalars_does_not_synchronise(cuda):
    cfg = config(queue_size=4096)
    st = curvature_state(cuda, **SIZED["flagship"])
    sampler = E.TorchSampler(3, cuda)
    E._maybe_update_curvature(st, cfg, sampler)      # builds and loads C1
    sc = E.state_scalars(st)
    C1.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = E._maybe_update_curvature(st, cfg, sampler, scalars=sc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert C1.launches == 1
    assert int(out.curv_t) == int(st.curv_t) + 1
    assert int(out.curv_last) == sc["num_merges"]


@pytest.mark.cuda
def test_counter_equals_the_span_in_a_traced_training(cuda):
    chars = sorted(set("the cat sat on the mat and the dog ran"))
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    gen = torch.Generator(device="cpu").manual_seed(0)
    emb = L.random_points(gen, len(vocab), 8, sigma=0.6, device="cpu")
    corpus = ["the cat sat on the mat", "the dog ran and the cat sat"] * 8
    tok = EnhancedHyperbolicTokenizer(
        vocab, emb, device=cuda, corpus_sample=corpus, max_vocab_size=256,
        merge_threshold=5.0, corpus_max_tokens=1024, freq_table_size=1024,
        queue_size=64, use_dense_channel=False, use_hierarchical=False,
        use_compression_aware=False, use_adaptive_curvature=True,
        optimize_curvature_freq=5, alpha=0.05, beta=0.9, gamma=0.05,
        merge_batch=2, merge_policy="priority")
    C1.reset_launches()
    with torch.profiler.profile():
        tok.optimize_merges(steps=40, log_every=20)
        snap = metrics.trace_snapshot()
    steps = snap["spans"]["curvature_adam"]["count"]
    assert steps > 0
    assert snap["counters"]["curvature.kernel_launches"] == steps
    assert C1.launches == steps
    assert float(tok.curvature) != 1.0
