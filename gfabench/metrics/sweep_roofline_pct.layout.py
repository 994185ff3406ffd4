"""sweep_roofline_pct.layout (%): the bound of the nD sweep kernels
(sweep_sampler.cu, dense_apply_nd.cu, roll_apply.cu) of the window's L
steps over their device seconds in the trace."""

from gfabench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "layout")
