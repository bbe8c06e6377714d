"""Persistent rendering service.

Port of ``dynibar_tpu.serve``.  The reference ships only offline batch
renderers (render_monocular_bt.py); a deployment wants a resident process
that loads the checkpoint once, keeps per-frame feature maps warm on the
card, and streams rendered views out.  :mod:`session` holds the device
state, :mod:`registry` one session per scene, :mod:`server` exposes them
over HTTP.
"""

from dynibar_tpu_torch.serve.session import RenderSession  # noqa: F401
