"""Command-line entry points of the port. Run as
``python -m hyptokenizer_tpu_torch.cli.<name>``; each keeps the flags of
its counterpart in ``hyptokenizer_tpu/cli/``.

- ``test_torch`` — device smoke test and, with ``--kernel-check``, the
  kernels' selfcheck (the port of ``test_tpu``)
"""
