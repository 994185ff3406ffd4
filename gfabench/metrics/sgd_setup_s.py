"""sgd_setup_s (s): per sort job, the seconds of the program's
index.build, sweep.plan and sweep.build spans inside its SGD step (the
path indexes, the sweep plan, the runner build and the state upload of
ops/sweep.py), from the device trace."""

from gfabench.program_spans import spans_s


def read(run):
    return spans_s(run, ("index.build", "sweep.plan", "sweep.build"),
                   inside="SGD")
