"""The benchmark of ch_shrinkwrap_torch: whole NanoWrap fits on one card.

``run.py`` is the command.  The manifest is ``BENCHMARK.json`` at the
root of the checkout; a configuration, a workload (its fit schedule), a
per-cell set of correctness limits and a metric are each a file of their
own, found by the name the manifest gives.
"""
