"""PyTorch/CUDA port of DynIBaR: the forward-facing eval render, the FF
fine-stage and monocular train steps, and the monocular training CLI.

The package mirrors ``dynibar_tpu``'s layout (core/, ops/, models/,
render/, data/, train/, utils/, cli/) so each counterpart is easy to find.
It imports torch, numpy and scipy only.  Its hot paths run hand-written
CUDA kernels (``csrc/``): the bilinear view sampler, the fused static and
dynamic aggregators and their training backwards.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``, where every kernel
wrapper uses its plain PyTorch twin.
"""
