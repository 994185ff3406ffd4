"""sweeps_idle_pct.sort (%): the share of the time of the program's
sweep.run spans inside the SGD steps with nothing on the device (the
host's launch and key work between the 1D sweeps), from the device
trace."""

from gfabench.program_spans import idle_pct_in


def read(run):
    return idle_pct_in(run, "sweep.run", inside="SGD")
