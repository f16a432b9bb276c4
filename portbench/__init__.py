"""The benchmark of xhistogram_torch: see run.py and PERF.md."""
