"""aggbench: the benchmark of the PyTorch and CUDA port of tpu_aggcomm.

``python3 -m aggbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: it builds the cell's
schedule on the port, fills seeded send arenas on the card, warms up,
runs exchanges back to back for ``--seconds``, judges a seeded sample of
what the exchanges delivered against the plain reference in
:mod:`aggbench.reference`, and prints one JSON line.

Everything that belongs to one configuration, traffic mix, metric or
backend is a file of its own, found by name: ``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py``, ``backends/<name>.py``.
Nothing here imports JAX or the JAX package ``tpu_aggcomm``.
"""
