"""k3_roofline_pct (%, device trace): the least time of the traced items'
K3 launches (roofline.py: work counted from the rays and triangles, estimated
from the checked paths) over their device time."""

from h100_bench import devtrace, roofline


def read(run):
    return roofline.kernel_share_pct(run, devtrace.SEARCH_KERNELS["k3"])
