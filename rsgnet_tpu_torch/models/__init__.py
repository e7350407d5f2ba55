"""Model registry (``get_pose_net``) and the seeded initialization."""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from rsgnet_tpu_torch.config.defaults import Config
from rsgnet_tpu_torch.models.hrnet import BatchNorm, PoseHighResolutionNet
from rsgnet_tpu_torch.models.pose_resnet import PoseResNet
from rsgnet_tpu_torch.models.pose_rsgnet import PoseRSGNet
from rsgnet_tpu_torch.models.pose_vit import PoseViT
from rsgnet_tpu_torch.models.vit import VisionTransformer

# flax lecun_normal: a normal truncated at +-2 std, rescaled so the
# truncated distribution has variance 1 / fan_in
_TRUNC_STD_CORRECTION = 0.87962566103423978


def get_pose_net(cfg: Config) -> nn.Module:
    """Build the module named by cfg.MODEL.NAME, on the CPU, in eval mode.

    `pose_hrnet`  -> plain HRNet backbone + 1x1 heatmap head.
    `pose_resnet` -> SimpleBaseline ResNet backbone + deconv head.
    `pose_rsgnet` -> HRNet backbone + relation/skeleton-graph head
                     (also selected when MODEL.RSG.ENABLED is set).
    `pose_vit`    -> ViTPose: plain ViT backbone (MODEL.VIT) + deconv head.
    """
    name = cfg.MODEL.NAME
    if name == "pose_vit":
        if cfg.MODEL.RSG.ENABLED:
            raise ValueError("MODEL.RSG.ENABLED requires the HRNet backbone's"
                             " high-res features; unset it or use "
                             "MODEL.NAME=pose_rsgnet")
        return PoseViT(cfg).eval()
    if name == "pose_resnet":
        if cfg.MODEL.RSG.ENABLED:
            raise ValueError("MODEL.RSG.ENABLED requires the HRNet backbone's"
                             " high-res features; unset it or use "
                             "MODEL.NAME=pose_rsgnet")
        return PoseResNet(cfg).eval()
    if name == "pose_rsgnet" or cfg.MODEL.RSG.ENABLED:
        return PoseRSGNet(cfg).eval()
    if name == "pose_hrnet":
        return PoseHighResolutionNet(cfg).eval()
    raise KeyError(f"unknown MODEL.NAME: {name}")


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init with the flax defaults the JAX package starts from:
    lecun-normal conv, transposed-conv and Dense kernels (truncated at 2
    std), zero biases, BatchNorm scale 1, bias 0, running mean 0, running
    var 1; LayerNorm scale 1, bias 0; a ViT's position table normal with
    std 0.02 (ViTPose's ``trunc_normal_``, whose bounds of +-2 lie 100 std
    out). Values
    are drawn in fp32 on the CPU from one ``torch.Generator`` in module
    order, then cast into each parameter's dtype and device."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, VisionTransformer):
            t = torch.empty(mod.pos_embed.shape, dtype=torch.float32)
            nn.init.trunc_normal_(t, 0.0, 0.02, generator=gen)
            mod.pos_embed.copy_(t)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            # Cin*kh*kw or in_features; a transposed conv's (Cin, Cout, k,
            # k) weight is flax's dilated-input conv with fan_in k*k*Cin
            fan_in = (w[:, 0].numel() if isinstance(mod, nn.ConvTranspose2d)
                      else w[0].numel())
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
            t = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            w.copy_(t)
            if mod.bias is not None:
                mod.bias.zero_()
    return model


__all__ = ["get_pose_net", "init_weights", "PoseHighResolutionNet",
           "PoseResNet", "PoseRSGNet", "PoseViT"]
