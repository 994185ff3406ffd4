"""host_steps_s (s): per job, the seconds of its topo-sort and groom steps
(the s and g steps of algos/ through pipeline.py), from --trace-out."""

from gfabench.readers import mean_step_s


def read(run):
    return mean_step_s(run, lambda name: name in ("topo-sort", "groom"))
