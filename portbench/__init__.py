"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the checkout's
root and prints one JSON line.  Everything a cell is made of is found by
name: its configuration (``configs/<name>.json``, whose ``generator`` names
``gens/<generator>.py``), its traffic (``traffic/<name>.json``, whose
``query`` names ``queries/<query>.py`` and ``limits/<query>.json``) and its
per-layer metrics (``metrics/<name>.py``).  ``reference/`` is the plain
PyTorch reference that decides ``correct``; it imports nothing of the port.
"""
