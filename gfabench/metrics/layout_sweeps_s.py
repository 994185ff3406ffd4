"""layout_sweeps_s (s): per layout job, the seconds of the program's
sweep.run spans inside its layout step (the nD sweeps and consensus of
ops/sweep_nd.py through the read-back of the coordinates), from the
device trace."""

from gfabench.program_spans import layout_step, spans_s


def read(run):
    return spans_s(run, ("sweep.run",), inside=layout_step(run))
