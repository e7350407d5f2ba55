"""ViTPose (arXiv 2204.12484): the plain ViT backbone (``models/vit.py``)
and its classic decoder (``TopdownHeatmapSimpleHead``): the tokens back
on their grid, NUM_DECONV_LAYERS transposed convs (each a 2x upsample)
with BatchNorm and ReLU (``pose_resnet.py::DeconvBN``), and a
FINAL_CONV_KERNEL fp32 conv with bias to K heatmaps. ViTPose-H at
256x192: 16x12 tokens, two 256-filter deconvs, 64x48 heatmaps.

The model names its parts for the inference pipeline (``parts``):
``vit.embed``, ``vit.blocks`` (every block and the last norm) and
``vit.head``. ``core/inference.py::heatmaps_with_flip_test`` runs each
in a stage of its own, so each is a CUDA graph of its own and a traced
call records a span with device time for each. ``forward`` runs them in
turn.
"""
from __future__ import annotations

import torch.nn as nn

from rsgnet_tpu_torch.config.defaults import Config
from rsgnet_tpu_torch.models.hrnet import at_least_f32, compute_dtype
from rsgnet_tpu_torch.models.pose_resnet import DeconvBN
from rsgnet_tpu_torch.models.vit import VisionTransformer


class PoseViT(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        extra = cfg.MODEL.EXTRA
        dtype = compute_dtype(cfg)
        self.backbone = VisionTransformer(cfg, dtype)
        rows, cols = self.backbone.grid
        up = 2 ** extra.NUM_DECONV_LAYERS
        w, h = cfg.MODEL.HEATMAP_SIZE
        if (rows * up, cols * up) != (h, w):
            raise ValueError(f"a {rows}x{cols} token grid and "
                             f"{extra.NUM_DECONV_LAYERS} deconvs give "
                             f"{rows * up}x{cols * up} heatmaps; "
                             f"MODEL.HEATMAP_SIZE says {h}x{w}")
        self.num_deconv = extra.NUM_DECONV_LAYERS
        cin = cfg.MODEL.VIT.EMBED_DIM
        for i in range(self.num_deconv):
            setattr(self, f"deconv{i}", DeconvBN(
                cin, extra.NUM_DECONV_FILTERS[i],
                kernel=extra.NUM_DECONV_KERNELS[i],
                use_bias=extra.DECONV_WITH_BIAS, dtype=dtype))
            cin = extra.NUM_DECONV_FILTERS[i]
        k = extra.FINAL_CONV_KERNEL
        self.final_layer = nn.Conv2d(cin, cfg.MODEL.NUM_JOINTS, k, 1,
                                     1 if k == 3 else 0, bias=True)

    def head(self, tokens):
        """(N, tokens, C) fp32 features -> (N, K, H/4, W/4) fp32 heatmaps.
        The tokens go back on their grid as a channels-last view."""
        n, _, c = tokens.shape
        x = tokens.transpose(1, 2).reshape(n, c, *self.backbone.grid)
        for i in range(self.num_deconv):
            x = getattr(self, f"deconv{i}")(x)
        return self.final_layer(at_least_f32(x))

    def parts(self):
        """The model's stages in order: (span name, callable)."""
        return (("vit.embed", self.backbone.embed),
                ("vit.blocks", self.backbone.encode),
                ("vit.head", self.head))

    def forward(self, x):
        """x: (N, 3, H, W) normalized crops -> (N, K, H/4, W/4) heatmaps."""
        for _, part in self.parts():
            x = part(x)
        return x
