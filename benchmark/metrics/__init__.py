"""One reader a metric: ``<metric name>.py`` with ``read(run)``, which
returns the metric's value or None when the run has nothing to read.
Each file states the metric's source and layer; ``BENCHMARK.json``
holds its unit, direction, the end-to-end metric it moves and its
cells."""
