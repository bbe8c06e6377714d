"""The port's render CLI (``dynibar_tpu_torch.cli.render_monocular``) on
the CPU, held against the JAX package's.

One 12-frame 32×48 scene (N_samples 10, num_source_views 2, num_vv 1,
chunk 256, f32, ``mask_src_view``) and the JAX ``MonoModel``'s weights
from PRNGKey(0), saved as each package's snapshot (the port's through
``utils/convert.load_jax_params``):

  * ``render_batch_template`` equals the JAX one array for array over
    the same frame sequence (both draw the virtual views from one
    ``RandomState(0)``);
  * the CLI's PNG frames on the stabilization path (``--render_idx -1``)
    are at most one level from the JAX CLI's, 3% border crop included;
    with ``video_out`` "auto" it also writes ``video.mp4`` (cv2 is
    installed here);
  * with ``video_out`` set and cv2 blocked it raises, naming cv2, before
    it renders a frame; without a scene it stops naming
    ``--train_scenes``; a mesh larger than one card raises outside a
    launcher (torchrun); without ``--device cpu`` a host with no CUDA
    raises.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from dynibar_tpu.cli import render_monocular as jcli
from dynibar_tpu.config import DynibarConfig as JConfig
from dynibar_tpu.data.monocular import MonocularSceneData as JData
from dynibar_tpu.models.dynibar import MonoModel as JMonoModel
from dynibar_tpu.utils import checkpoints as jckpt
from dynibar_tpu_torch.cli import render_monocular as cli
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.data import png
from dynibar_tpu_torch.data.monocular import MonocularSceneData
from dynibar_tpu_torch.data.synthetic_scene import write_synthetic_scene
from dynibar_tpu_torch.models.dynibar import MonoModel
from dynibar_tpu_torch.utils import checkpoints as ckpt
from dynibar_tpu_torch.utils import convert

FRAMES = 12
KW = dict(train_scenes=["tiny"], training_height=32, num_source_views=2,
          max_range=8, num_vv=1, N_samples=10, num_basis=4, chunk_size=256,
          mesh_shape="1", mask_src_view=True)


def _argv(root, rootdir, **kw):
  out = ["--folder_path", root, "--rootdir", rootdir, "--render_idx", "-1"]
  for k, v in dict(KW, **kw).items():
    out += [f"--{k}", " ".join(v) if isinstance(v, list) else str(v)]
  return out


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
  """(scene root, JAX run folder, port run folder): the weights saved in
  each package's snapshot format."""
  root = str(tmp_path_factory.mktemp("render_cli"))
  write_synthetic_scene(root, "tiny", num_frames=FRAMES, height=32, width=48)
  jconfig = JConfig(folder_path=root, rootdir=os.path.join(root, "jax"),
                    **KW)
  jmodel = JMonoModel(cfg=jconfig.render_settings("mono"),
                      num_frames=FRAMES)
  params = jax.tree_util.tree_map(
      np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
  jckpt.save_checkpoint(jconfig.out_folder(), 7, params)
  config = DynibarConfig(folder_path=root, rootdir=os.path.join(root, "pt"),
                         **KW)
  model = MonoModel(config.render_settings("mono"), FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  ckpt.save_checkpoint(config.out_folder(), 7, model.state_dict())
  return root, jconfig.rootdir, config.rootdir


def test_render_batch_template_matches_jax(scene):
  root = scene[0]
  data = MonocularSceneData(DynibarConfig(folder_path=root, **KW), "tiny")
  jdata = JData(JConfig(folder_path=root, **KW), "tiny")
  rng, jrng = np.random.RandomState(0), np.random.RandomState(0)
  for idx in (3, 4, 8, 5, 5, 6):
    got = cli.render_batch_template(data, idx, 2, 1, rng)
    want = jcli.render_batch_template(jdata, idx, 2, 1, jrng)
    assert set(got) == set(want)
    for k, w in want.items():
      w = np.asarray(w)
      assert np.asarray(got[k]).dtype == w.dtype, k
      np.testing.assert_array_equal(got[k], w, err_msg=f"frame {idx} {k}")
  assert (got["static_valid"] == 0).any()   # padded static views


@pytest.fixture(scope="module")
def cli_frames(scene, tmp_path_factory):
  """Both CLIs' stabilization frames (uint8) and the port CLI's result."""
  root, jroot, troot = scene
  mp = pytest.MonkeyPatch()
  try:
    mp.setattr(sys, "argv", ["render_monocular"]
               + _argv(root, jroot, video_out=""))
    jcli.main()
  finally:
    mp.undo()
  jout = os.path.join(JConfig(folder_path=root, rootdir=jroot,
                              **KW).out_folder(), "render_stab")
  res = cli.main(["--device", "cpu"] + _argv(root, troot))
  jpaths = sorted(os.path.join(jout, p) for p in os.listdir(jout))
  return ([png.read(p) for p in res["frames"]],
          [png.read(p) for p in jpaths], res)


def test_cli_frames_match_the_jax_cli(cli_frames):
  got, want, res = cli_frames
  assert len(got) == len(want) == FRAMES
  for i, (g, w) in enumerate(zip(got, want)):
    # 3% crop: int(32 * 0.03) = 0 rows, int(48 * 0.03) = 1 column a side
    assert g.shape == w.shape == (32, 46, 3) and g.dtype == np.uint8
    diff = np.abs(g.astype(int) - w.astype(int))
    assert diff.max() <= 1, (i, diff.max())
  assert any(g.any() for g in got)
  assert res["step"] == 7 and len(res["seconds"]) == FRAMES


def test_cli_writes_the_video(cli_frames):
  res = cli_frames[2]
  assert res["out_dir"].endswith("render_stab")
  assert res["video"] == os.path.join(res["out_dir"], "video.mp4")
  with open(res["video"], "rb") as fh:
    assert fh.read(12)[4:8] == b"ftyp"
  assert sorted(os.listdir(res["out_dir"])) == [
      f"{i:05d}.png" for i in range(FRAMES)] + ["video.mp4"]


def test_cli_without_cv2_stops_before_rendering(scene, monkeypatch,
                                                tmp_path):
  root, _, troot = scene
  monkeypatch.setitem(sys.modules, "cv2", None)

  def no_render(*a, **kw):
    raise AssertionError("rendered before the cv2 check")

  monkeypatch.setattr(cli, "render_image_mono", no_render)
  rootdir = str(tmp_path)
  with pytest.raises(ImportError, match="cv2"):
    cli.main(["--device", "cpu"] + _argv(root, rootdir, video_out="auto"))
  assert not os.path.exists(os.path.join(rootdir, "out"))


def test_cli_errors(scene):
  root, _, troot = scene
  with pytest.raises(SystemExit, match="--train_scenes"):
    cli.main(["--device", "cpu", "--folder_path", root])
  with pytest.raises(RuntimeError, match="torchrun"):
    cli.main(["--device", "cpu"] + _argv(root, troot, mesh_shape="8"))
  with pytest.raises(SystemExit, match="no checkpoint"):
    cli.main(["--device", "cpu"] + _argv(root, os.path.join(root, "none"),
                                         video_out=""))
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      cli.main(_argv(root, troot, video_out=""))
