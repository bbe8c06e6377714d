"""The weight bridge (dynibar_tpu_torch/utils/convert.py): JAX FFModel
params -> port state_dict -> JAX params is bit-identical, loading is
strict, and the mapping agrees with the JAX package's own torch->flax
converter on the reference's names."""

import jax
import numpy as np
import pytest
import torch

from dynibar_tpu.config import RenderSettings as JSettings
from dynibar_tpu.models.dynibar import FFModel as JFFModel
from dynibar_tpu.utils import torch_convert
from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.models.dynibar import FFModel
from dynibar_tpu_torch.utils import convert
from torch_port_threads import one_torch_thread  # noqa: F401

KW = dict(n_samples=8, n_importance=8, num_views_dy=7, num_views_static=4,
          num_basis=6, inv_uniform=True)


@pytest.fixture(scope="module")
def params():
  jcfg = JSettings(num_views_anchor=0, num_vv=0, **KW)
  jmodel = JFFModel(cfg=jcfg, num_frames=48)
  return jax.tree_util.tree_map(
      np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))


def _leaves(tree, prefix=()):
  for k, v in sorted(tree.items()):
    if isinstance(v, dict):
      yield from _leaves(v, prefix + (k,))
    else:
      yield prefix + (k,), v


def test_round_trip_is_bit_identical(params):
  cfg = RenderSettings(**KW)
  model = FFModel(cfg, 48, device="cpu")
  convert.load_jax_params(model, params)
  back = convert.state_dict_to_jax_params(model.state_dict(),
                                          convert.ff_entries(cfg))
  want, got = dict(_leaves(params)), dict(_leaves(back))
  assert set(got) == set(want)
  for path, a in want.items():
    b = got[path]
    assert b.shape == a.shape and b.dtype == a.dtype, path
    np.testing.assert_array_equal(b, a, err_msg=str(path))


def test_loading_is_strict(params):
  cfg = RenderSettings(**KW)
  model = FFModel(cfg, 48, device="cpu")
  sd = convert.jax_params_to_state_dict(params, convert.ff_entries(cfg))
  assert set(sd) == set(model.state_dict())
  missing = dict(sd)
  missing.pop("net_fine_st.s")
  with pytest.raises(RuntimeError, match="Missing"):
    model.load_state_dict(missing, strict=True)
  extra = dict(sd, **{"net_fine_st.bogus": torch.zeros(1)})
  with pytest.raises(RuntimeError, match="Unexpected"):
    model.load_state_dict(extra, strict=True)
  with pytest.raises(KeyError):
    convert.jax_params_to_state_dict(
        dict(params, stray={"kernel": np.zeros(1)}), convert.ff_entries(cfg))


@pytest.mark.parametrize("which", ["net_fine_st", "net_fine_dy",
                                   "feature_net", "motion_mlp"])
def test_inverts_the_jax_converter(params, which):
  """Port state_dict keys are the reference's: feeding them to the JAX
  package's torch->flax converter gives the original params back."""
  cfg = RenderSettings(**KW)
  sd = convert.jax_params_to_state_dict(params, convert.ff_entries(cfg))
  prefix = which + "."
  sub = {k[len(prefix):]: v.numpy() for k, v in sd.items()
         if k.startswith(prefix)}
  fn = {"net_fine_st": torch_convert.convert_static_aggregator,
        "net_fine_dy": torch_convert.convert_dynamic_aggregator,
        "feature_net": torch_convert.convert_feature_net,
        "motion_mlp": torch_convert.convert_motion_mlp}[which]
  got = dict(_leaves(fn(sub)))
  want = dict(_leaves(params[which]))
  assert set(got) == set(want)
  for path, a in want.items():
    np.testing.assert_array_equal(np.asarray(got[path]), a, err_msg=str(path))
