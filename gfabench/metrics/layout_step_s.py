"""layout_step_s (s): per job, the seconds of its nD layout step (the L
step: pipeline.layout_step, the initial coordinates, the nD sweep engine
and the sampled stress), from --trace-out."""

from gfabench.readers import mean_step_s


def read(run):
    return mean_step_s(run, lambda name: name.endswith("D layout"))
