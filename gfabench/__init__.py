"""The benchmark of ``gfasort_tpu_torch``: whole CLI jobs, one after another
in a warm process, on synthetic chromosome-scale pangenome graphs.

``python -m gfabench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``README.md``.
Importing this package imports neither torch nor the program.
"""
