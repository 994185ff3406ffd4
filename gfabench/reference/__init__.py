"""The benchmark's plain reference: the CLI job (``sYgs``, ``Y``, ``L`` and
any other string of ``s``, ``g``, ``Y`` and ``L``) worked out again from
the input GFA in plain NumPy, Python and PyTorch, with no kernel.

Every module here is a frozen copy of the plain branch of the matching
module of ``gfasort_tpu_torch`` (the package's own plain versions, which
its kernels and native library are held equal to), taken at the commit
that added the benchmark and trimmed to what the CLI job runs.  Nothing
here imports ``gfasort_tpu_torch``, ``gfasort_tpu`` or ``jax``: a later
change to the program does not move the reference.
"""
