"""consensus_s.sat (s): per sort job, the seconds of the program's
sweep.consensus spans inside its SGD step (each a call of
ops/node_sum.GatherConsensus by the 1D runner, one per consensus period,
the host's launches of its gathers and adds), from the device trace."""

from gfabench.program_spans import spans_s


def read(run):
    return spans_s(run, ("sweep.consensus",), inside="SGD")
