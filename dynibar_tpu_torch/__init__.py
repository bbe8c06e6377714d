"""PyTorch/CUDA port of the forward-facing DynIBaR eval render.

The package mirrors ``dynibar_tpu``'s layout (core/, ops/, models/,
render/, data/, utils/) so each counterpart is easy to find.  It imports
torch and numpy only.  Its hot path runs three hand-written CUDA kernels
(``csrc/``): the bilinear view sampler and the fused static and dynamic
aggregators.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel wrapper uses its plain PyTorch twin.
"""
