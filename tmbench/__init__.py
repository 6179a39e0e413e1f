"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``tmbench/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything a
cell, a configuration, a traffic mix or a metric needs is found by its name
in files of its own under this folder: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``kind`` names a module in ``kinds/``) and
``metrics/<metric>.py``.  The yardstick (data generation, the plain
reference, the work counts, the peaks, the trace reduction) lives here too;
from the program the benchmark takes only the entry points it times and the
kernel names its trace shows.
"""
