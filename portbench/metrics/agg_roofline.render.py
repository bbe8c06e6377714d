"""The forward aggregators' share of their roofline in a rendered frame:
the least time of K2/K3 at the cell's shapes (workcount.py) over the
device time of their kernels (trunk_kernel, ray_kernel)."""

from portbench.metrics._common import roofline_pct

KERNELS = ("trunk_kernel", "ray_kernel")


def read(ctx, res, summary):
  return roofline_pct(res, summary, KERNELS)
