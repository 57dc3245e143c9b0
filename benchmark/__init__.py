"""The benchmark of ``roadsurf_tpu_torch`` on NVIDIA cards.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once, in one process,
and prints one JSON result line.  Everything a cell is made of is found by
name: ``configs/<config>.json`` (the deployment), ``traffic/<traffic>.json``
(the cycles' mix), ``checks/<workload>.json`` (the limits of the comparison
that decides ``correct``) and ``metrics/<metric>.py`` (one reader a
per-layer metric).  The yardstick lives here: the traffic generators
(``generators/``), the plain reference (``reference/``), the roofline
arithmetic (``roofline.py``) and the comparison (``check.py``).
"""
