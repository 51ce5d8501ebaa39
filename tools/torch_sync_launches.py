"""Kernel launches and host time of one sync's queue build on the card.

    python3 tools/torch_sync_launches.py [--root DIR]

For the flagship (``bench.ENHANCED``) and the all-features configuration
(``bench.ALLFEATURES``), each after 2,048 merges on the wiki corpus:
one ``enhanced_state._sync_finish`` (the span ``sync.queues``) under
``torch.profiler``, its CUDA launches counted, then the host and wall
milliseconds of 20 more. ``--root`` imports the port from another
checkout (a parent commit unpacked with ``git archive``), so that two
versions are compared in one call.
"""

import argparse
import json
import os
import sys
import time


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
    for name, kw, extra in recipes:
        vocab, emb = bench.char_points(lines, dev)
        tok = EnhancedHyperbolicTokenizer(vocab, emb, device=dev,
                                          corpus_sample=lines, **extra, **kw)
        tok.optimize_merges(steps=2048, log_every=2048)
        st, cfg = tok.enh_state, tok.enh_config
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


if __name__ == "__main__":
    sys.exit(main())
