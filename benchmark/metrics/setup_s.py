"""setup_s (host_clock): from the start of the process to the start of
the first timed fit: imports, the kernels and the host engine loaded
(or built), the inputs drawn, the warm-up fit."""

SOURCE = 'host_clock'


def read(run):
    return run.setup_s
