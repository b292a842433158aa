"""fieldbench — the benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 fieldbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line.  Everything that belongs to one configuration,
traffic mix or per-layer metric is a file of its own, found by name:
``configs/<config>.json`` (sizes) and ``configs/<config>.py`` (the plain
reference), ``workloads/<traffic>.json`` (parameters), ``traffic/<kind>.py``
(the driver of one kind of traffic), ``metrics/<metric>.py`` (a reader).
``yardstick/`` holds the peaks and the operation and byte counts.
"""
