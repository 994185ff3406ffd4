"""device_idle_pct.sat (%): the share of the window's sort-job time on
graphs with a looped satellite in which nothing runs on the device, from
the trace."""

from gfabench.readers import idle_pct


def read(run):
    return idle_pct(run)
