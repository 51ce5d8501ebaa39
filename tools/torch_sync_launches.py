"""Kernel launches, host reads and host time of one sync's queue build and
of its replay on the card.

    python3 tools/torch_sync_launches.py [--root DIR]

For the flagship (``bench.ENHANCED``) and the all-features configuration
(``bench.ALLFEATURES``), each after 2,048 merges on the wiki corpus:

- the queue build: one ``enhanced_state._sync_finish`` (the span
  ``sync.queues``) under ``torch.profiler``, its CUDA launches counted,
  then the host and wall milliseconds of 20 more;
- the replay (the span ``sync.replay``) of the next chunk's first sync,
  which replays those merges, from the state that sync was handed: its
  launches under ``torch.profiler``, its host synchronisations under
  ``torch.cuda.set_sync_debug_mode("warn")``, then the host and wall
  milliseconds of 20 more. The replay is what ``sync_corpus`` runs
  inside the span: ``enhanced_state.replay_corpus`` where the port has
  that function, else the counts read and ``scoring.batch_rank_replay``
  or ``batch_fixpoint_replay``.

``--root`` imports the port from another checkout (a parent commit
unpacked with ``git archive``), so that two versions are compared in one
process's call.
"""

import argparse
import json
import os
import sys
import time
import warnings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from hyptokenizer_tpu_torch import bench
    from hyptokenizer_tpu_torch.tokenizer import (
        WORDS_WITH_SPACE, EnhancedHyperbolicTokenizer, NormalizerConfig)
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
    from hyptokenizer_tpu_torch.tokenizer import scoring

    if not torch.cuda.is_available():
        print("torch_sync_launches: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"# {torch.cuda.get_device_name(0)}, port from "
          f"{os.path.dirname(E.__file__)}", flush=True)
    dev = torch.device("cuda")
    lines = bench.load_corpus()
    recipes = (("flagship", bench.ENHANCED,
                dict(normalizer=NormalizerConfig(pre_split=WORDS_WITH_SPACE))),
               ("all_features", bench.ALLFEATURES, {}))
    sync_corpus = E.sync_corpus
    for name, kw, extra in recipes:
        vocab, emb = bench.char_points(lines, dev)
        tok = EnhancedHyperbolicTokenizer(vocab, emb, device=dev,
                                          corpus_sample=lines, **extra, **kw)
        tok.optimize_merges(steps=2048, log_every=2048)
        handed = []

        def watched(st, config, sampler):
            window = (int(st.corpus_synced), int(st.base.num_merges))
            if window[0] != window[1] and not handed:
                handed.append((E.clone_state(st), window))
            return sync_corpus(st, config, sampler)

        E.sync_corpus = watched
        try:   # the next chunk's first sync replays the first one's merges
            tok.optimize_merges(steps=64, log_every=64)
        finally:
            E.sync_corpus = sync_corpus
        st, cfg = tok.enh_state, tok.enh_config
        print(name, "replay", json.dumps(
            replay_numbers(torch, E, scoring, cfg, *handed[0])), flush=True)
        keys, counts, n_unique, max_count = scoring.build_pair_table(
            st.corpus, cfg.freq_table_size)
        sampler = E.TorchSampler(0, dev)

        def build():
            return E._sync_finish(st, cfg, sampler, st.corpus, keys, counts,
                                  n_unique, max_count)

        build()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            build()
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if "LaunchKernel" in e.key)
        t0 = time.perf_counter()
        for _ in range(20):
            build()
        host = (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 20
        print(name, json.dumps({
            "rows": int((keys[:, 0] != scoring.PKEY_SENT).sum()),
            "launches": launches, "host_ms": round(host * 1e3, 3),
            "wall_ms": round(wall * 1e3, 3)}), flush=True)
        del tok
    return 0


def replay_numbers(torch, E, scoring, cfg, st, window) -> dict:
    """Launches, host synchronisations and milliseconds of one sync's
    replay of ``window`` on ``st``."""
    def replay():
        if hasattr(E, "replay_corpus"):
            return E.replay_corpus(st, cfg)
        fn = (scoring.batch_rank_replay if cfg.priority_replay
              else scoring.batch_fixpoint_replay)
        start = int(st.corpus_synced)
        return fn(st.corpus, st.base.merges, start,
                  int(st.base.num_merges) - start, cfg.n_init)

    replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if "LaunchKernel" in e.key or "LaunchCooperative" in e.key)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in seen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        replay()
    host = (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 20
    return {"window": window[1] - window[0], "launches": launches,
            "host_syncs": reads, "host_ms": round(host * 1e3, 4),
            "wall_ms": round(wall * 1e3, 4)}


if __name__ == "__main__":
    sys.exit(main())
