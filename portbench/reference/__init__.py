"""The benchmark's plain reference: plain PyTorch, float32, no kernels.

Frozen copies of the port's plain modules (dynibar_tpu_torch at commit
a749e58): the camera and sampling geometry, the feature nets, the motion
MLP, both aggregators as modules, compositing, the render cores, the
losses and the eval metrics.  Each file names the port file it was copied
from.  Nothing here imports the port or the JAX package; what the port
derives from the benchmark's inputs (packed weights, batches, feature
maps) the reference works out again from the same inputs.  The kernels'
dispatch is cut out: ``dynibar.aggregate`` always calls the module and
the sampler is always ``F.grid_sample``.  ``precision`` holds the
control's fp8 switch.
"""
