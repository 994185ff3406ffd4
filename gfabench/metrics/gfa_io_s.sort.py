"""gfa_io_s.sort (s): per sort job, the seconds of the program's
gfa.read and gfa.write spans (cli.py: the GFA parse, the GFA text and its
file write), from the device trace."""

from gfabench.program_spans import spans_s


def read(run):
    return spans_s(run, ("gfa.read", "gfa.write"))
