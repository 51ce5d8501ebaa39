"""Command-line entry points of the port. Run as
``python -m hyptokenizer_tpu_torch.cli.<name>``; each keeps the flags of
its counterpart in ``hyptokenizer_tpu/cli/``; those that touch the card
add ``--device`` (default: the card; ``--device cpu`` runs on the CPU).

- ``train_enhanced_tokenizer`` — the enhanced tokenizer (the README's Quick
  start), with embedding pretraining, checkpoints and resume, and
  hierarchy supervision
- ``train_tokenizer``          — the distance-only tokenizer
- ``train_graph_embeddings``   — hierarchy supervision of saved embeddings
- ``eval_hierarchy``           — WordNet distortion of saved embeddings
- ``preprocess_wiki``          — corpus cleaning and the initial vocabulary
  (host only)
- ``train_nlp_tasks``          — BERT MLM and classification with a tokenizer
- ``train_retrieval``          — hyperbolic two-tower image-text retrieval
- ``benchmark_efficiency``     — tokenize and encode throughput
- ``compare_tokenizers``       — throughput, quality and compression of
  several tokenizers
- ``analysis``                 — plots over experiment artifacts
- ``train_baseline_tokenizers`` — HF ``tokenizers`` baselines (host only)
- ``build_wordnet_graph``      — the WordNet graph pickle (host only)
- ``download_data``            — corpus downloads, failing gracefully
  without a network (host only)
- ``test_torch``               — device smoke test and, with
  ``--kernel-check``, the kernels' selfcheck (the port of ``test_tpu``)
- ``bench_scaling``            — merge throughput of the sharded loop at
  the world's size (``--multihost`` for several processes)

``--mesh`` and ``--multihost`` train through ``parallel/`` (one process
per rank, ``torch.distributed``).
"""
