"""setup_s (s, host clock): from the start of the process through its
imports, the library loads, the warm-up job's input and the whole warm-up
job, to the start of the window."""


def read(run):
    return run.setup_s
