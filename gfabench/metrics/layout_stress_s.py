"""layout_stress_s (s): per layout job, the seconds of the program's
layout.stress spans (ops/exact.calculate_layout_stress with its path
index), from the device trace."""

from gfabench.program_spans import spans_s


def read(run):
    return spans_s(run, ("layout.stress",))
