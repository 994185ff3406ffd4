"""host_steps_s.sat (s): per job on a graph with a looped satellite, the
seconds of its topo-sort and groom steps (the s and g steps of algos/
through pipeline.py, on a cyclic graph), from --trace-out."""

from gfabench.readers import mean_step_s


def read(run):
    return mean_step_s(run, lambda name: name in ("topo-sort", "groom"))
