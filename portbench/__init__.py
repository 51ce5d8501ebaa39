"""The benchmark of ``hyptokenizer_tpu_torch`` on NVIDIA cards.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cells and metrics;
each cell (``cells/<cell>.json``), configuration (``configs/<name>.json``),
job kind (``jobs/<kind>.py``) and metric (``metrics/<metric>.py``) is a file
of its own that :mod:`portbench.registry` finds by its name. The plain
references that decide ``correct`` are in ``reference/``; the frozen
operation and byte counts of the kernels in ``counts/``.
"""
