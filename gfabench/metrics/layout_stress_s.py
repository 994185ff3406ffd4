"""layout_stress_s (s): per layout job, the seconds of the program's
layout.stress spans (ops/exact.calculate_layout_stress_pidx on the L
step's own path index: no index build inside), from the device trace."""

from gfabench.program_spans import spans_s


def read(run):
    return spans_s(run, ("layout.stress",))
