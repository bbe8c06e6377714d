"""Frozen copy of dynibar_tpu_torch/models/aggregators.py at commit a749e58, part
of the benchmark's plain reference (portbench/reference/__init__.py).

IBR view-aggregation networks (per-sample color/density heads).

The reference's ``DynibarDynamic`` (ibrnet/mlp_network.py:129-316) and
``DynibarStatic`` (:319-527) as ``nn.Module``s with its parameter names.
Their ``forward`` is the plain f32 twin of the CUDA kernels K2/K3
(ops/agg.py): it runs on CPU tensors, and on the card it is what the
kernels are held against.  Under ``torch.autocast`` to bf16 it is their
bf16 twin (``utils/kernel_check.bf16_twin``): the density heads and the
static blend logits leave it in f32, as the flax modules cast them
(dynibar_tpu/models/aggregators.py), so the -1e9 fills and the dynamic
shift stay exact.  Inputs use the [rays, samples, views, ·] layout.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.posenc import periodic_embed, sample_axis_posenc
from portbench.reference.attention import RayTransformer
from portbench.reference.nn_layers import mlp


def weighted_mean_variance(x: torch.Tensor, weight: torch.Tensor):
  """fused_mean_variance (reference mlp_network.py:115-119), view axis 2."""
  mean = torch.sum(x * weight, dim=2, keepdim=True)
  var = torch.sum(weight * (x - mean) ** 2, dim=2, keepdim=True)
  return mean, var


class _Trunk(nn.Module):
  """base_fc -> visibility gating -> re-pooled geometry feature, shared by
  both aggregators (reference mlp_network.py:270-283 / :483-496)."""

  def __init__(self, in_feat: int):
    super().__init__()
    self.base_fc = mlp(in_feat * 3, (256, 128), activate_final=True)
    self.vis_fc = mlp(128, (128, 129), activate_final=True)
    self.vis_fc2 = mlp(128, (128, 1))
    self.geometry_fc = mlp(257, (256, 128), activate_final=True)
    self.ray_attention = RayTransformer()

  def trunk(self, rgb_feat, weight, mask):
    """Returns (x [R,S,V,128], vis [R,S,V,1], globalfeat [R,S,128])."""
    num_views = rgb_feat.shape[2]
    mean, var = weighted_mean_variance(rgb_feat, weight)
    glob = torch.cat([mean, var], dim=-1)
    x = torch.cat([glob.expand(-1, -1, num_views, -1), rgb_feat], dim=-1)
    x = self.base_fc(x)
    x_vis = self.vis_fc(x * weight)
    x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
    vis = torch.sigmoid(vis) * mask
    x = x + x_res
    vis = torch.sigmoid(self.vis_fc2(x * vis)) * mask
    weight = vis / (torch.sum(vis, dim=2, keepdim=True) + 1e-8)
    mean, var = weighted_mean_variance(x, weight)
    glob = torch.cat([mean[:, :, 0], var[:, :, 0], weight.mean(dim=2)],
                     dim=-1)
    return x, vis, self.geometry_fc(glob)


class DynamicAggregator(_Trunk):
  """Time-varying dynamic model (reference DynibarDynamic)."""

  def __init__(self, in_feat_ch: int = 32, n_samples: int = 64,
               shift: float = 0.0):
    super().__init__(in_feat_ch + 3)
    self.shift = shift
    self.ray_dir_fc = mlp(21, (256, in_feat_ch + 3), activate_final=True)
    self.ref_pts_fc = mlp(128 + 33, (256, 128), activate_final=True)
    self.out_geometry_fc = mlp(128, (128, 1))
    self.rgb_fc = mlp(128 + 27, (128, 64, 3))
    self.register_buffer("pos_enc", torch.from_numpy(
        sample_axis_posenc(128, n_samples)), persistent=False)

  def direction_feature(self, time: torch.Tensor) -> torch.Tensor:
    """ray_dir_fc on the time PE, [R,S,1] -> [R,S,3+C].  Broadcasting it
    over views after the MLP equals the reference's MLP over the expanded
    [R,S,V,·] input (reference mlp_network.py:240-247)."""
    return self.ray_dir_fc(periodic_embed(time, 10, 10, linspace=False))

  def forward(self, pts, rgb_feat, glb_ray_dir, mask, time):
    """pts [R,S,3], rgb_feat [R,S,V,3+C], glb_ray_dir [R,3],
    mask [R,S,V,1], time [R,S,1] -> raw [R,S,4]."""
    rgb_feat, mask = rgb_feat.float(), mask.float()
    s = rgb_feat.shape[1]
    rgb_feat = rgb_feat + self.direction_feature(time)[:, :, None, :]
    weight = mask / (torch.sum(mask, dim=2, keepdim=True) + 1e-8)
    _, _, glob = self.trunk(rgb_feat, weight, mask)
    num_valid = torch.sum(mask, dim=2)                          # [R,S,1]
    glob = glob + self.pos_enc[:s]
    glob = self.ray_attention(glob, glob, glob,
                              mask=(num_valid > 1).float())
    pts_pe = periodic_embed(pts, 5, 5, linspace=False)
    glob = self.ref_pts_fc(torch.cat([glob, pts_pe], dim=-1))
    sigma = self.out_geometry_fc(glob).float() - self.shift
    sigma = torch.where(num_valid < 1, torch.full_like(sigma, -1e9), sigma)
    dir_pe = periodic_embed(glb_ray_dir, 4, 4, linspace=False)  # [R,27]
    h = torch.cat([glob, dir_pe[:, None, :].expand(-1, s, -1)], dim=-1)
    rgb = torch.sigmoid(self.rgb_fc(h))
    rgb = torch.where(num_valid > 0, rgb, torch.zeros_like(rgb))
    return torch.cat([rgb, sigma], dim=-1)


class StaticAggregator(_Trunk):
  """Time-invariant static model (reference DynibarStatic)."""

  def __init__(self, in_feat_ch: int = 32, n_samples: int = 64,
               anti_alias_pooling: bool = True, mask_rgb: bool = True):
    super().__init__((in_feat_ch + 3) * 2)
    del n_samples  # no sample-axis positional encoding (reference :499)
    self.anti_alias_pooling, self.mask_rgb = anti_alias_pooling, mask_rgb
    if anti_alias_pooling:
      self.s = nn.Parameter(torch.tensor(0.2))
    self.ray_dir_fc = mlp(4 + 33 + 66, (256, in_feat_ch + 3))
    self.ref_feature_fc = nn.Sequential(nn.Linear(66, in_feat_ch + 3))
    self.out_geometry_fc = mlp(128, (128, 1))
    self.rgb_fc = mlp(128 * 2 + 1 + 4, (128, 64, 1))

  def forward(self, pts, ref_pl, src_pl, rgb_feat, ray_diff, mask):
    """pts [R,S,3], ref_pl [R,6], src_pl [R,S,V,6], rgb_feat [R,S,V,3+C],
    ray_diff [R,S,V,4], mask [R,S,V,1] -> raw [R,S,4]."""
    rgb_feat, ray_diff, mask = rgb_feat.float(), ray_diff.float(), mask.float()
    num_views = rgb_feat.shape[2]
    ref_pe = periodic_embed(ref_pl, 5, 5, linspace=False)       # [R,66]
    src_pe = periodic_embed(src_pl, 5, 5, linspace=False)       # [R,S,V,66]
    pts_pe = periodic_embed(pts, 5, 5, linspace=False)          # [R,S,33]
    src_features = torch.cat(
        [pts_pe[:, :, None, :].expand(-1, -1, num_views, -1), src_pe], dim=-1)
    src_feat = self.ray_dir_fc(torch.cat([src_features, ray_diff], dim=-1))
    # Linear(broadcast(x)) == broadcast(Linear(x)): run it per ray
    ref_feat = self.ref_feature_fc(ref_pe)[:, None, None, :]
    rgb_in = rgb_feat[..., :3]
    if self.mask_rgb:
      # black (masked-out) source pixels contribute nothing
      mask = mask * (torch.sum(rgb_in, dim=-1, keepdim=True) > 1e-3).float()
    rgb_feat = torch.cat([rgb_feat, src_feat * ref_feat], dim=-1)
    if self.anti_alias_pooling:
      # reference mlp_network.py:461-467: the min runs over all views;
      # amin splits its gradient evenly among ties, as jnp.min does
      exp_dot = torch.exp(torch.abs(self.s) * (ray_diff[..., 3:4] - 1.0))
      weight = (exp_dot - torch.amin(exp_dot, dim=2, keepdim=True)) * mask
    else:
      weight = mask
    weight = weight / (torch.sum(weight, dim=2, keepdim=True) + 1e-8)
    x, vis, glob = self.trunk(rgb_feat, weight, mask)
    num_valid = torch.sum(mask, dim=2)
    glob = self.ray_attention(glob, glob, glob,
                              mask=(num_valid > 1).float())
    sigma = self.out_geometry_fc(glob).float()
    sigma = torch.where(num_valid < 1, torch.full_like(sigma, -1e9), sigma)
    h = torch.cat([glob[:, :, None, :].expand(-1, -1, num_views, -1), x, vis,
                   ray_diff], dim=-1)
    logits = self.rgb_fc(h).float()
    logits = torch.where(mask == 0, torch.full_like(logits, -1e9), logits)
    blend = torch.softmax(logits, dim=2)
    rgb = torch.sum(rgb_in * blend, dim=2)
    return torch.cat([rgb, sigma], dim=-1)
