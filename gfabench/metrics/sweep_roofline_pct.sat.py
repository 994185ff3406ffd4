"""sweep_roofline_pct.sat (%): the bound of the 1D sweep kernels
(sweep_sampler.cu, bucket_apply.cu, roll_apply.cu) of the window's Y steps
on graphs with a looped satellite over their device seconds in the
trace."""

from gfabench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "sort")
