"""job_s.sort (s, host clock): the wall seconds of a sort job, the
window's summed job time over its number of jobs.  A per-layer metric:
the host's speed on the card's machine swings by a quarter over minutes,
more than any bound allows (PERF.md, section 2)."""

from gfabench.readers import mean_job_s


def read(run):
    return mean_job_s(run)
