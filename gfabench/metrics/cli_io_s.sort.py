"""cli_io_s.sort (s): per sort job, its wall time less the summed seconds
of its --trace-out steps: the GFA parse and write and the CLI's own work
(cli.py, io/)."""

from gfabench.readers import mean_cli_io_s


def read(run):
    return mean_cli_io_s(run)
