"""The per-layer metrics, one file each, named as in BENCHMARK.json:
``read(run)`` takes a traced window (``harness.Run``) and returns the
metric's value, or None where the run holds nothing for it to read.
``_read.py`` holds what several of them share."""
