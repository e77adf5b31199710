"""fit_s (host_clock): the window's wall-clock seconds over the fits it
completed; the window runs from the first timed fit's start to the last
one's end."""

SOURCE = 'host_clock'


def read(run):
    return run.window_s / len(run.fits) if run.fits else None
