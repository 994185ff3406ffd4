"""sgd_step_s (s): per job, the seconds of its SGD step (the Y step:
pipeline.sgd_sort_only, the 1D sweep engine with its set-up, and
graph.apply_ordering), from --trace-out."""

from gfabench.readers import mean_step_s


def read(run):
    return mean_step_s(run, lambda name: name == "SGD")
