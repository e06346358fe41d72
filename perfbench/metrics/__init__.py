"""One reader a per-layer metric, metrics/<name>.py, each with
read(ctx) -> float | None (see perfbench/run.py Context). None where its
source holds nothing in the traced window: the run then leaves the metric
out and says so."""
