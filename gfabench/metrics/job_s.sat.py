"""job_s.sat (s, host clock): the wall seconds of a sort job on a graph
with a looped satellite, the window's summed job time over its number of
jobs.  A per-layer metric, as job_s.sort is."""

from gfabench.readers import mean_job_s


def read(run):
    return mean_job_s(run)
