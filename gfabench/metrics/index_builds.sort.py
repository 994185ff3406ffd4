"""index_builds.sort (count): per sort job, the number of the
program's index.build spans (index.PathIndex.from_graph calls), from the
device trace."""

from gfabench.program_spans import span_count


def read(run):
    return span_count(run, "index.build")
