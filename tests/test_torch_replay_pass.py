"""The corpus sync's replay kernel R2 (``ops/cuda/replay_pass.py``) and the
sync's replay that launches it (``enhanced_state.replay_corpus``).

On the CPU: the launch plan as a pure function of the shapes (slices,
shared memory or global state, the occupancy's grid), the rule table's
size, the wrapper's refusals (type, layout and shape before the device,
and a CPU tensor refused, never replayed), and the sync's replay on the
CPU: the plain pass loop over the window it reads, the corpus itself for
an empty window, and a sync that leaves nothing to replay. On the card
(marker ``cuda``): R2 against the plain pass loop (``scoring._replay`` on
the CPU) under both policies, output and the ``replay.passes`` /
``replay.match_rounds`` counts exactly, the input left as it was: a real
wiki window in two syncs, an empty window (known to the host, and known
only on the card), a window that chains over three passes and more, runs
of one rule across the blocks' slice edges, a length that is no multiple
of the slice, PAD gaps and an all-PAD tail over several blocks, SEP
stretches, duplicate and half-empty rules, a window too large for a
block's own rule table, and a corpus too large for shared memory; the
window handed as card scalars; no host synchronisation in the sync's
replay; one launch a sync in a traced training.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from hyptokenizer_tpu_torch.ops.cuda import replay_pass as RP
from hyptokenizer_tpu_torch.ops.cuda import replay_select as RS
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from hyptokenizer_tpu_torch.tokenizer import scoring as SC
from hyptokenizer_tpu_torch.utils import metrics
from tests.test_torch_cuda import wiki_window  # noqa: F401

PAD, SEP = SC.PAD_ID, SC.SEP_ID
H100_SMEM = 232_448 - 512   # a block's opt-in limit less some static
SMALL_CORPUS = ["the cat sat on the mat", "the dog ran and the cat sat",
                "a rat and a cat and a dog"] * 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("n, per_sm, shared, blocks, slice_", [
    (2_097_152, 1, True, 132, 15_904),     # the Quick start's corpus
    (2_900_000, 1, True, 132, 21_984),     # the flagship's
    (4_000_000, 1, False, 132, 30_304),    # past shared memory
    (4_000_000, 2, False, 264, 15_168),
    (1_000_003, 1, True, 132, 7_584),
    (1_000_003, 2, True, 264, 3_808),
    (0, 1, True, 132, 32),
    (1, 1, True, 132, 32),
    (132 * 32 + 1, 1, True, 132, 64),
])
def test_launch_plan(n, per_sm, shared, blocks, slice_):
    asked = []

    def occupancy(smem):
        asked.append(smem)
        return per_sm

    plan = RP.launch_plan(n, 132, H100_SMEM, occupancy)
    assert (plan.shared, plan.blocks, plan.slice) == (shared, blocks, slice_)
    assert plan.slice % 32 == 0 and plan.blocks * plan.slice >= n
    assert plan.slice == 32 or plan.blocks * (plan.slice - 32) < n
    if shared:
        assert plan.smem_bytes == 4 * RP.state_words(plan.slice) <= H100_SMEM
        assert plan.work_words == 0 and asked[0] > 0
    else:
        assert plan.smem_bytes == 0 and asked == [0]
        assert plan.work_words == plan.blocks * RP.state_words(plan.slice)


def test_state_and_table_sizes():
    assert RP.state_words(32) == 69
    assert RP.state_words(15_904) == 2 * 15_904 + 5 * 497
    assert [RP.table_capacity(r) for r in (0, 1, 8, 9, 50_176)] == [
        32, 32, 32, 64, 262_144]
    # windows of up to 128 rules fit the table a block holds itself
    assert RP.table_capacity(128) == RP.LOCAL_TABLE < RP.table_capacity(129)


def _bad_inputs():
    c = torch.zeros(64, dtype=torch.int32)
    m = torch.full((16, 2), -1, dtype=torch.int32)
    one = torch.zeros((), dtype=torch.int32)
    return {
        "corpus_on_cpu": (c, m, 0, 4),
        "corpus_int64": (c.long(), m, 0, 4),
        "corpus_strided": (torch.zeros(128, dtype=torch.int32)[::2], m, 0, 4),
        "corpus_2d": (c.reshape(8, 8), m, 0, 4),
        "merges_3_wide": (c, torch.zeros((16, 3), dtype=torch.int32), 0, 4),
        "merges_int64": (c, m.long(), 0, 4),
        "merges_transposed": (c, m.t(), 0, 4),
        "start_int64": (c, m, one.long(), 4),
        "end_two_elements": (c, m, 0, torch.zeros(2, dtype=torch.int32)),
        "start_past_int32": (c, m, 2**31, 4),
        "end_on_cpu": (c, m, 0, one),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses(case):
    """Each refusal comes before the kernel's library is asked for: a CPU
    tensor is refused, never replayed."""
    corpus, merges, start, end = _bad_inputs()[case]
    before = RP.launches
    with pytest.raises(ValueError):
        RP.replay(corpus, merges, start, end, 4, rank=True)
    assert RP.launches == before


def _tokenizer(device, **kw):
    from hyptokenizer_tpu_torch.ops import lorentz as L
    chars = sorted({ch for line in SMALL_CORPUS for ch in line})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    gen = torch.Generator(device="cpu").manual_seed(0)
    emb = L.random_points(gen, len(vocab), 8, sigma=0.6, device="cpu")
    return EnhancedHyperbolicTokenizer(
        vocab, emb, device=device, corpus_sample=SMALL_CORPUS,
        max_vocab_size=256, merge_threshold=5.0, corpus_max_tokens=1024,
        freq_table_size=1024, use_dense_channel=False,
        use_hierarchical=False, use_compression_aware=False, alpha=0.05,
        beta=0.9, gamma=0.05, merge_batch=2, merge_policy="priority", **kw)


def _small_state(device="cpu", steps=24):
    """A trained state whose corpus lags all its merges: the constructor's
    corpus with ``corpus_synced`` 0, as after a restore."""
    tok = _tokenizer(device, queue_size=64, use_adaptive_curvature=False)
    corpus = tok.enh_state.corpus.clone()
    tok.optimize_merges(steps=steps, log_every=steps)
    st = dataclasses.replace(
        tok.enh_state, corpus=corpus,
        corpus_synced=torch.zeros_like(tok.enh_state.corpus_synced))
    return st, tok.enh_config


@pytest.mark.parametrize("policy", ["priority", "fixpoint"])
def test_sync_replay_on_the_cpu_is_the_plain_loop(monkeypatch, policy):
    """On the CPU the sync's replay reads the two counts and runs the
    plain pass loop of its policy over ``[corpus_synced, num_merges)``;
    R2 is never asked for."""
    st, cfg = _small_state()
    cfg = dataclasses.replace(cfg, priority_replay=policy == "priority")
    n = int(st.base.num_merges)
    assert int(st.corpus_synced) == 0 and n > 0
    monkeypatch.setattr(RP, "replay", None)
    got = E.replay_corpus(st, cfg)
    replay = (SC.batch_rank_replay if policy == "priority"
              else SC.batch_fixpoint_replay)
    want = replay(st.corpus, st.base.merges, 0, n, cfg.n_init)
    assert torch.equal(got, want) and not torch.equal(got, st.corpus)


def test_sync_replay_of_an_empty_window_is_the_corpus():
    st, cfg = _small_state()
    st = dataclasses.replace(st, corpus_synced=st.base.num_merges.clone())
    assert E.replay_corpus(st, cfg) is st.corpus


def test_sync_leaves_nothing_to_replay():
    """A sync replays the whole lag: after it the corpus is synced to the
    merge count, and a second sync's replay has nothing to do."""
    st, cfg = _small_state()
    a = E.sync_corpus(E.clone_state(st), cfg, E.TorchSampler(1, "cpu"))
    assert int(a.corpus_synced) == int(a.base.num_merges) > 0
    assert torch.equal(a.corpus, E.replay_corpus(st, cfg))
    assert E.replay_corpus(a, cfg) is a.corpus


# ---------------------------------------------------------------- card

def plain_replay(corpus, merges, start, count, n_init, policy):
    """The plain pass loop on the CPU: (corpus, passes, rounds)."""
    replay = (SC.batch_rank_replay if policy == "rank"
              else SC.batch_fixpoint_replay)
    metrics.tracing()   # a look with none recording: a record of its own
    with torch.profiler.profile():
        out = replay(corpus, merges, start, count, n_init)
        counters = metrics.trace_snapshot()["counters"]
    return (out, counters.get("replay.passes", 0),
            counters.get("replay.match_rounds", 0))


def card_replay(cuda, corpus, merges, start, count, n_init, policy,
                bounds="ints"):
    """R2 on the card, one launch: (corpus on the CPU, passes, rounds),
    after checking that the input is left as it was."""
    c = corpus.to(cuda)
    keep = c.clone()
    m = merges.to(cuda)
    s, e = start, start + count
    if bounds == "tensors":
        s = torch.tensor(s, dtype=torch.int32, device=cuda)
        e = torch.tensor(e, dtype=torch.int32, device=cuda)
    before = RP.launches
    out, stats = RP.replay(c, m, s, e, n_init, rank=policy == "rank")
    passes, rounds = stats.tolist()
    assert RP.launches == before + 1
    assert torch.equal(c, keep) and out.data_ptr() != c.data_ptr()
    return out.cpu(), passes, rounds


def rounds_window(corpus, n_init, start, rounds, per_round):
    """A merge window made as training makes one: rounds of the most
    frequent pairs of the replayed corpus, later rules on ids made by
    earlier ones. Rows before ``start`` stay empty."""
    merges = torch.full((start + rounds * per_round + 3, 2), -1,
                        dtype=torch.int32)
    c = corpus
    at = start
    for _ in range(rounds):
        keys, counts, _, _ = SC.build_pair_table(c, 1 << 16)
        k = min(per_round, int((counts > 0).sum()))
        if k == 0:
            break
        top = torch.topk(counts, k).indices
        merges[at:at + k] = keys[top]
        c = SC.batch_rank_replay(c, merges, at, k, n_init)
        at += k
    return merges, at - start


def _random_corpus(rng, n, alphabet, sep=0.05):
    c = rng.integers(0, alphabet, n).astype(np.int32)
    c[rng.random(n) < sep] = SEP
    return c


def case_chain(rng, n, slice_):
    """a b c d repeated with noise; rules (a,b)=X, (X,c)=Y, (Y,d)=Z and a
    few more: every pass makes what the next one merges."""
    c = np.tile(np.array([0, 1, 2, 3, SEP], np.int32), n // 5 + 1)[:n]
    noise = rng.random(n) < 0.02
    c[noise] = rng.integers(0, 6, int(noise.sum()))
    start, n_init = 5, 6
    x = n_init + start
    rules = [(0, 1), (x, 2), (x + 1, 3), (x + 2, SEP), (4, 5), (x + 2, x)]
    merges = np.full((start + len(rules) + 2, 2), -1, np.int32)
    merges[start:start + len(rules)] = rules
    return c, merges, start, len(rules), n_init


def case_runs_across_edges(rng, n, slice_):
    """Runs of one symbol, odd and even lengths, across every slice edge:
    one rule matches all along each run, so the take's parity carries
    from block to block; lower-ranked rules compete at the runs' ends."""
    c = rng.integers(1, 4, n).astype(np.int32)
    for edge in range(slice_, n, slice_):
        a = edge - int(rng.integers(1, 3 * slice_ // 2))
        b = edge + int(rng.integers(1, 200))
        c[max(a, 0):min(b, n)] = 0
    c[rng.random(n) < 0.001] = SEP
    start, n_init = 0, 4
    x = n_init + start
    rules = [(1, 0), (0, 0), (0, 1), (2, 0), (x + 1, x + 1), (x + 1, 0)]
    merges = np.full((len(rules), 2), -1, np.int32)
    merges[:] = rules
    return c, merges, start, len(rules), n_init


def case_ragged(rng, n, slice_):
    n = n - 1 - int(rng.integers(0, slice_ // 2))
    assert n % slice_ != 0
    c = _random_corpus(rng, n, 8)
    merges, count = rounds_window(torch.from_numpy(c), 8, 3, 3, 12)
    return c, merges.numpy(), 3, count, 8


def case_pad_gaps(rng, n, slice_):
    """Short PAD gaps all along (as the shard layout leaves before its
    first sync), one gap over two and a half slices, and an all-PAD tail
    over four and a half."""
    c = _random_corpus(rng, n, 6)
    for at in rng.integers(0, n, n // 500):
        c[at:at + int(rng.integers(1, 4))] = PAD
    mid = n // 3
    c[mid:mid + 5 * slice_ // 2] = PAD
    c[n - 9 * slice_ // 2:] = PAD
    merges, count = rounds_window(torch.from_numpy(c), 6, 0, 3, 10)
    return c, merges.numpy(), 0, count, 6


def case_sep_stretches(rng, n, slice_):
    """Stretches of SEP, some over several slices, between random text."""
    c = _random_corpus(rng, n, 5)
    for at in rng.integers(0, n, 40):
        c[at:at + int(rng.integers(1, 3 * slice_))] = SEP
    merges, count = rounds_window(torch.from_numpy(c), 5, 2, 3, 8)
    return c, merges.numpy(), 2, count, 5


def case_duplicate_rules(rng, n, slice_):
    """The same pair at several rows (the largest id wins), rules with a
    negative operand (they match nothing), a chain over the duplicates."""
    c = _random_corpus(rng, n, 4)
    start, n_init = 1, 4
    x = n_init + start
    rules = [(0, 1), (2, 3), (0, 1), (-1, -1), (1, 2), (0, -1), (0, 1),
             (x + 6, x + 1), (2, 3), (-1, 0)]
    merges = np.full((start + len(rules), 2), -1, np.int32)
    merges[start:] = rules
    return c, merges, start, len(rules), n_init


def case_many_rules(rng, n, slice_):
    """A window of 300 rules: a rule table too large for a block's shared
    memory, built by the grid in global memory."""
    c = _random_corpus(rng, n, 40, sep=0.01)
    merges, count = rounds_window(torch.from_numpy(c), 40, 7, 2, 150)
    assert count > 128
    return c, merges.numpy(), 7, count, 40


def case_global_path(rng, n, slice_):
    n = 4_000_000
    c = _random_corpus(rng, n, 10)
    c[rng.random(n) < 0.001] = PAD
    merges, count = rounds_window(torch.from_numpy(c), 10, 0, 3, 20)
    return c, merges.numpy(), 0, count, 10


CASES = {f.__name__[5:]: f for f in (
    case_chain, case_runs_across_edges, case_ragged, case_pad_gaps,
    case_sep_stretches, case_duplicate_rules, case_many_rules,
    case_global_path)}
CASE_N = 1_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["rank", "fixpoint"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_the_plain_loop(cuda, case, policy):
    lib = RP._launcher()
    slice_ = RP._plan(lib, cuda, CASE_N).slice
    rng = np.random.default_rng(zlib.crc32(f"{case}/{policy}".encode()))
    c, merges, start, count, n_init = CASES[case](rng, CASE_N, slice_)
    corpus, merges = torch.from_numpy(c), torch.from_numpy(merges)
    plan = RP._plan(lib, cuda, corpus.shape[0])
    assert plan.shared == (case != "global_path")
    want, passes, rounds = plain_replay(corpus, merges, start, count,
                                        n_init, policy)
    got, k_passes, k_rounds = card_replay(cuda, corpus, merges, start, count,
                                          n_init, policy)
    assert torch.equal(got, want)
    assert (k_passes, k_rounds) == (passes, rounds)
    assert int((want >= n_init).sum()) > 0   # some rule applied
    if case == "chain":
        assert passes >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["rank", "fixpoint"])
def test_wiki_window_with_card_scalars(cuda, wiki_window, policy):
    """The wiki window's two syncs, the window handed as one-element
    tensors on the card (as the sync hands it), equal to the plain loop
    and to the window handed as ints."""
    corpus, merges, n_init = wiki_window
    half = merges.shape[0] // 2
    want = got = got_ints = corpus
    for start in (0, half):
        want, passes, rounds = plain_replay(want, merges, start, half, n_init,
                                            policy)
        got, k_passes, k_rounds = card_replay(cuda, got, merges, start, half,
                                              n_init, policy, "tensors")
        got_ints, _, _ = card_replay(cuda, got_ints, merges, start, half,
                                     n_init, policy)
        assert (k_passes, k_rounds) == (passes, rounds)
        assert torch.equal(got, want) and torch.equal(got_ints, want)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["rank", "fixpoint"])
def test_empty_window(cuda, wiki_window, policy):
    """An empty window the host knows launches nothing and returns the
    corpus itself; one known only on the card launches once and returns a
    copy of the input as it is, PAD gaps and all, with no pass."""
    corpus, merges, n_init = wiki_window
    c = corpus.clone()
    c[1000:1010] = PAD
    c = c.to(cuda)
    replay = (SC.batch_rank_replay if policy == "rank"
              else SC.batch_fixpoint_replay)
    before = RP.launches
    assert replay(c, merges.to(cuda), 7, 0, n_init) is c
    assert RP.launches == before
    at = torch.tensor(7, dtype=torch.int32, device=cuda)
    out, stats = RP.replay(c, merges.to(cuda), at, at, n_init,
                           rank=policy == "rank")
    assert RP.launches == before + 1
    assert torch.equal(out, c) and out.data_ptr() != c.data_ptr()
    assert stats.tolist() == [0, 0]


@pytest.mark.cuda
def test_wrapper_refuses_mixed_devices(cuda):
    c = torch.zeros(64, dtype=torch.int32, device=cuda)
    m = torch.full((16, 2), -1, dtype=torch.int32, device=cuda)
    for args in ((c, m.cpu(), 0, 4), (c.cpu(), m, 0, 4),
                 (c, m, torch.zeros((), dtype=torch.int32), 4),
                 (c[::2], m, 0, 4)):
        with pytest.raises(ValueError):
            RP.replay(*args, 4, rank=True)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["priority", "fixpoint"])
def test_sync_replay_does_not_synchronise(cuda, policy):
    """``replay_corpus`` on the card: one launch, no host
    synchronisation, the CPU's corpus."""
    st, cfg = _small_state(cuda)
    cfg = dataclasses.replace(cfg, priority_replay=policy == "priority")
    assert int(st.corpus_synced) < int(st.base.num_merges)
    E.replay_corpus(st, cfg)       # builds and loads R2
    cpu = dataclasses.replace(
        st, corpus=st.corpus.cpu(), corpus_synced=st.corpus_synced.cpu(),
        base=dataclasses.replace(st.base, merges=st.base.merges.cpu(),
                                 num_merges=st.base.num_merges.cpu()))
    want = E.replay_corpus(cpu, cfg)
    RP.reset_launches()
    RS.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = E.replay_corpus(st, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert RP.launches == 1 and RS.launches == 0
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_one_launch_a_sync(cuda, monkeypatch):
    """In a traced training on the card, ``replay.kernel_launches`` is the
    number of syncs, an empty window included, R1 is never launched, and
    the passes and rounds are counted."""
    windows = []
    real = E.replay_corpus

    def watched(st, config):
        windows.append(torch.stack([st.corpus_synced, st.base.num_merges]))
        return real(st, config)

    monkeypatch.setattr(E, "replay_corpus", watched)
    tok = _tokenizer(cuda, queue_size=8, use_adaptive_curvature=True,
                     optimize_curvature_freq=5)
    metrics.tracing()
    with torch.profiler.profile():
        tok.optimize_merges(steps=60, log_every=20)
        snap = metrics.trace_snapshot()
    counters = snap["counters"]
    full = sum(int(w[0]) != int(w[1]) for w in windows)
    assert full > 0 and len(windows) == snap["spans"]["sync"]["count"]
    assert counters["replay.kernel_launches"] == len(windows)
    assert counters["replay.passes"] >= full
    assert "replay.select_launches" not in counters
