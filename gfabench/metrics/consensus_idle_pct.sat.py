"""consensus_idle_pct.sat (%): the share of the time of the program's
sweep.consensus spans inside the SGD steps with nothing on the device:
how far the host's launches of the consensus's gathers and adds hold the
device back, from the device trace."""

from gfabench.program_spans import idle_pct_in


def read(run):
    return idle_pct_in(run, "sweep.consensus", inside="SGD")
