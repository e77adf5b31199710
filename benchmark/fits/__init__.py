"""One module a kind of fit, named by a configuration's ``fit`` key.

Each module has a class ``Fit(config, workload, seed, device, spans)``
that draws the inputs from the seed in set-up and keeps in ``inputs``
what the correctness check holds the program's state to (the cloud's
rows, inverse errors and weights; the true surface is the shape that
the configuration's ``cloud.shape`` names); calling it runs one whole
fit (``max_iter`` cuts the schedule, for the warm-up) and returns the
fitted mesh.
"""
