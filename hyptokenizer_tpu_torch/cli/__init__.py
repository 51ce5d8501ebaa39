"""Command-line entry points of the port. Run as
``python -m hyptokenizer_tpu_torch.cli.<name>``; each keeps the flags of
its counterpart in ``hyptokenizer_tpu/cli/`` and adds ``--device``
(default: the card).

- ``train_enhanced_tokenizer`` — the enhanced tokenizer (the README's Quick
  start), with embedding pretraining, checkpoints and resume, and
  hierarchy supervision
- ``train_tokenizer``          — the distance-only tokenizer
- ``train_graph_embeddings``   — hierarchy supervision of saved embeddings
- ``eval_hierarchy``           — WordNet distortion of saved embeddings
- ``preprocess_wiki``          — corpus cleaning and the initial vocabulary
- ``test_torch``               — device smoke test and, with
  ``--kernel-check``, the kernels' selfcheck (the port of ``test_tpu``)
"""
