"""sgd_sweeps_s.sat (s): per sort job, the seconds of the program's
sweep.run spans inside its SGD step (the 1D sweeps and the consensus of
ops/sweep.py through the read-back of the positions), from the device
trace."""

from gfabench.program_spans import spans_s


def read(run):
    return spans_s(run, ("sweep.run",), inside="SGD")
