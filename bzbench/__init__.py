"""bzbench: the benchmark of tpubz_torch, the PyTorch/CUDA port of tpubz.

One run measures one cell (a configuration under a traffic) once:
``python3 bzbench/run.py --workload <config>.<traffic> --seed N --seconds S
--trace 0|1``. Configurations, traffic and metrics are data and readers
found by name (``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py``); ``reference.py`` is the plain NumPy codec that
decides ``correct``.
"""
