"""device_idle_pct.layout (%): the share of the window's layout-job time
in which nothing runs on the device, from the trace."""

from gfabench.readers import idle_pct


def read(run):
    return idle_pct(run)
