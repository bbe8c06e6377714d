"""The aggregators' share of their roofline in a train step: the least
time of their forward and backward at the cell's shapes (workcount.py)
over the device time of their kernels: K2r/K3r (trunk_kernel,
ray_kernel), K5a (static_ray_bwd_kernel), K5b (static_trunk_bwd_kernel),
K4a (dynamic_ray_bwd_kernel), K4b/K5c (trunk_bwd_kernel), K5d
(inmlp_bwd_kernel), K4s (dynamic_bwd_single_kernel) and the weight
gradients' reduce (reduce_slabs)."""

from portbench.metrics._common import roofline_pct

KERNELS = ("trunk_kernel", "ray_kernel", "static_ray_bwd_kernel",
           "static_trunk_bwd_kernel", "dynamic_ray_bwd_kernel",
           "trunk_bwd_kernel", "inmlp_bwd_kernel",
           "dynamic_bwd_single_kernel", "reduce_slabs")


def read(ctx, res, summary):
  return roofline_pct(res, summary, KERNELS)
