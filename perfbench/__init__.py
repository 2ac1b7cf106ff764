"""Benchmark of the PyTorch and CUDA port of Ocean (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on a CUDA device and
prints one JSON line. Everything that belongs to one configuration, one
traffic mix or one per-layer metric is a file of its own, found by name:
``configs/<config>.json`` names a generator ``gen/<generator>.py``,
``traffic/<traffic>.json`` names a driver ``drivers/<driver>.py``, and
each per-layer metric is read by ``metrics/<metric>.py``.
"""
