"""params_s.layout (s): per layout job, the seconds of the program's
pipeline.params span: run_pipeline's parameters derived from the input
graph before the first step, with their path indexes (pipeline.py,
params.py), from the device trace."""

from gfabench.program_spans import spans_s


def read(run):
    return spans_s(run, ("pipeline.params",))
