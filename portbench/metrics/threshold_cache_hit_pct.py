"""Lookups of the program's threshold cache (``core._THRESHOLD_CACHE``)
that it served, over the window, in %: 100 x hits / lookups, and 100 where
the window made no lookup."""

from portbench.metrics._program import counters

COUNTERS = counters("THRESHOLD_HITS", "THRESHOLD_LOOKUPS")


def read(run):
    hits, lookups = run.counters["THRESHOLD_HITS"], run.counters["THRESHOLD_LOOKUPS"]
    return 100.0 * hits / lookups if lookups else 100.0
