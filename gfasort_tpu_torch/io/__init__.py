from . import gfa, layout_tsv  # noqa: F401
