"""Metric readers: ``<name>.py`` reads metric ``<name>`` of BENCHMARK.json
from a ``harness.Run`` with ``read(run)``, or returns None where the run
has nothing for it to read. ``COUNTERS`` names program counters
("module:attribute") whose change over the window it reads."""
