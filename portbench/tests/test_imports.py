"""Nothing the benchmark imports is JAX's or the JAX package's, and the
reference pulls in nothing of the port."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_PROBE = """
import sys
sys.path.insert(0, {root!r})
import portbench.reference.render_image, portbench.reference.train_step
import portbench.reference.nvidia_eval, portbench.reference.llff
import portbench.workcount, portbench.scenes.mono, portbench.scenes.nvidia
tops = {{m.split('.')[0] for m in sys.modules}}
print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'dynibar_tpu',
                      'dynibar_tpu_torch'}}))
import portbench.run, portbench.control
import portbench.drivers.train_loop, portbench.drivers.nvidia_eval
import portbench.drivers.session_render
import dynibar_tpu_torch.train.trainer, dynibar_tpu_torch.serve.session
import dynibar_tpu_torch.eval.nvidia_eval
print(sorted({{m.split('.')[0] for m in sys.modules}}
             & {{'jax', 'jaxlib', 'flax', 'dynibar_tpu'}}))
"""


def test_no_jax_and_a_standalone_reference():
  out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                       capture_output=True, text=True, check=True,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
  lines = out.stdout.strip().splitlines()
  assert lines == ["[]", "[]"], out.stdout + out.stderr


def test_forbidden_names_are_whole():
  from portbench import run
  assert "dynibar_tpu" in run.FORBIDDEN
  sys.modules.setdefault("dynibar_tpu_torch", sys.modules[__name__])
  assert "dynibar_tpu_torch" not in run.forbidden_modules()
