"""The H100 benchmark of ``new_cg_variants_tpu_torch``.

``python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card and
prints one JSON line; :mod:`.spec` says where each cell's data lives.
"""
