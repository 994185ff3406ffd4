"""layout_setup_s (s): per layout job, the seconds of the program's
index.build, layout.init, sweep.plan and sweep.build spans inside its
layout step and outside its stress (the path index, the initial
coordinates of ops/exact.py, the sweep plan, the runner build and the
state upload of ops/sweep_nd.py), from the device trace."""

from gfabench.program_spans import layout_step, spans_s


def read(run):
    return spans_s(run, ("index.build", "layout.init", "sweep.plan",
                         "sweep.build"),
                   inside=layout_step(run), outside="layout.stress")
