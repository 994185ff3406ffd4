"""device_peak_gib (GiB): the most device memory that the process held in
tensors at once, through set-up and the window (torch's caching
allocator, read once the window has closed): what a job of the cell needs
of the card.  None without a card."""


def read(run):
    peak = run.memory_peak_bytes
    return peak / 2**30 if peak else None
