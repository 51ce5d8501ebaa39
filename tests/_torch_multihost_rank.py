"""One process of a multi-process run of the port's sharded training.

Launched by tests/test_torch_multihost.py: each process is one gloo rank
on the CPU, meeting the others through ``initialize_multihost`` at a
localhost coordinator (the TCP rendezvous a multi-host job uses), or, with
one process, alone (a world of one). Runs the distance-only loop, the
enhanced loop through the tokenizer's ``mesh`` and the v3 sync's
configuration, and writes the merge histories as JSON.

Usage: python _torch_multihost_rank.py <coordinator> <n_proc> <proc_id>
       <out.json>
"""

import json
import sys


def main():
    coordinator, n_proc, proc_id, out_path = sys.argv[1:5]

    import torch

    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.parallel.multihost import (
        global_mesh, initialize_multihost)
    from hyptokenizer_tpu_torch.parallel.sharded import run_merges_sharded
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    from hyptokenizer_tpu_torch.tokenizer.state import MergeConfig, init_state

    torch.set_num_threads(1)
    if int(n_proc) > 1:
        initialize_multihost(coordinator_address=coordinator,
                             num_processes=int(n_proc),
                             process_id=int(proc_id), device="cpu")
    mesh = global_mesh(device="cpu")
    assert mesh.size == int(n_proc), mesh
    result = {"process_count": mesh.size, "rank": mesh.rank}

    def points(seed, n):
        g = torch.Generator()
        g.manual_seed(seed)
        return L.random_points(g, n, 8, sigma=0.5, device="cpu")

    # The distance-only loop.
    config = MergeConfig(max_vocab_size=256, search_block=64)
    state = init_state(points(0, 96), torch.ones((96,), dtype=torch.int32),
                       curvature=1.0, threshold=2.0, config=config,
                       device="cpu")
    state = run_merges_sharded(state, config, 60, mesh)
    result["merges"] = state.merges[:int(state.num_merges)].tolist()

    # The enhanced loop through the tokenizer's mesh.
    corpus = ["the cat sat on the mat", "the dog sat on the log",
              "a cat and a dog and a rat"] * 8
    chars = sorted({c for ln in corpus for c in ln})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    emb = points(1, len(vocab))
    tok = EnhancedHyperbolicTokenizer(
        vocab, emb, merge_threshold=3.0, max_vocab_size=256,
        corpus_sample=corpus, corpus_max_tokens=1024, merge_batch=4,
        search_block=64, use_hierarchical=False,
        use_adaptive_curvature=False, seed=0, mesh=mesh)
    tok.optimize_merges(steps=24, log_every=12)
    result["enhanced_merges"] = [list(m) for m in tok.merge_history]

    # The v3 sync across the process boundary: the all_to_all and the
    # statistics' all_reduce ride the TCP-rendezvous group.
    tok2 = EnhancedHyperbolicTokenizer(
        vocab, emb, merge_threshold=50.0, max_vocab_size=256,
        corpus_sample=corpus, corpus_max_tokens=1024, corpus_shards=8,
        merge_batch=4, search_block=64, use_hierarchical=False,
        use_adaptive_curvature=False, use_compression_aware=False,
        use_dense_channel=False, merge_policy="priority",
        freq_table_size=8192, queue_size=512, seed=0, mesh=mesh)
    from hyptokenizer_tpu_torch.parallel.sharded import select_sync_path
    result["v3_path"] = select_sync_path(tok2.enh_state, tok2.enh_config,
                                         mesh)
    tok2.optimize_merges(steps=16, log_every=8)
    result["v3_merges"] = [list(m) for m in tok2.merge_history]

    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"proc {proc_id}: ok ({len(result['merges'])} merges, "
          f"{len(result['enhanced_merges'])} enhanced)")


if __name__ == "__main__":
    main()
