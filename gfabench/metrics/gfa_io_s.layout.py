"""gfa_io_s.layout (s): per layout job, the seconds of the program's
gfa.read, gfa.write and tsv.write spans (cli.py: the GFA parse, the GFA
text and its file write, the layout TSV write), from the device trace."""

from gfabench.program_spans import spans_s


def read(run):
    return spans_s(run, ("gfa.read", "gfa.write", "tsv.write"))
