"""sgd_order_s (s): per sort job, the seconds of the program's
sgd.order and graph.reorder spans inside its SGD step (the order from the
positions, and graph.apply_ordering), from the device trace."""

from gfabench.program_spans import spans_s


def read(run):
    return spans_s(run, ("sgd.order", "graph.reorder"), inside="SGD")
