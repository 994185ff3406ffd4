"""sweeps_idle_pct.layout (%): the share of the time of the program's
sweep.run spans inside the layout steps with nothing on the device (the
host's launch and key work between the nD sweeps), from the device
trace."""

from gfabench.program_spans import idle_pct_in, layout_step


def read(run):
    return idle_pct_in(run, "sweep.run", inside=layout_step(run))
