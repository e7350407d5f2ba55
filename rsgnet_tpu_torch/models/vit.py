"""The plain ViT backbone of ViTPose (Xu et al., "ViTPose: Simple Vision
Transformer Baselines for Human Pose Estimation", NeurIPS 2022, arXiv
2204.12484), from the MODEL.VIT keys.

- ``patch_embed``: a PATCH_SIZE conv of stride PATCH_SIZE and padding
  PATCH_PADDING to EMBED_DIM channels (ViTPose's ``PatchEmbed`` at ratio
  1: padding 2, so a 256x192 crop gives a 16x12 grid, 192 tokens);
- ``pos_embed``: a learned (1, tokens + 1, EMBED_DIM) table, added as
  ``x + pos[:, 1:] + pos[:, :1]`` (no class token; ViTPose keeps the
  first row for its MAE initialization and adds it to every token);
- DEPTH pre-LN blocks, ``x = x + Attn(LN1(x)); x = x + MLP(LN2(x))``:
  NUM_HEADS heads of EMBED_DIM / NUM_HEADS, a ``qkv`` projection with a
  bias under QKV_BIAS, scale head_dim^-0.5, an MLP of MLP_RATIO x
  EMBED_DIM with exact GELU; LayerNorm eps LN_EPS;
- ``last_norm``, a final LayerNorm.

Submodules carry the names of the public checkpoint's ``backbone.*``
tensors, but for ``patch_embed`` (its ``proj`` conv is the module itself):
``utils/torch_convert.py::vit_key_map``.

Precision (cfg.DTYPE, no autocast): the patch conv and the four linears
a block compute in the compute dtype (``CastConv2d``, ``CastLinear``: fp32
parameters, casts cached in eval); attention runs through
``F.scaled_dot_product_attention`` on q, k and v in that dtype, so a
fused kernel runs on a card (its softmax statistics in fp32) and is
captured by the inference function's CUDA graphs; GELU acts on the first
linear's output in its dtype. The residual stream, the position table and
LayerNorm are fp32: each block adds its branches' outputs to the fp32
stream.

The backbone names its two stages for the inference pipeline: ``embed``
(crops -> fp32 tokens) and ``encode`` (the blocks and the last norm).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsgnet_tpu_torch.config.defaults import Config, check_vit
from rsgnet_tpu_torch.models.hrnet import CastConv2d, CastLinear


def token_grid(cfg: Config):
    """(rows, cols) of the patch grid of a MODEL.IMAGE_SIZE crop."""
    vit = cfg.MODEL.VIT
    w, h = cfg.MODEL.IMAGE_SIZE
    p, pad = vit.PATCH_SIZE, vit.PATCH_PADDING
    return (h + 2 * pad - p) // p + 1, (w + 2 * pad - p) // p + 1


class Attention(nn.Module):
    def __init__(self, dim, heads, qkv_bias, dtype):
        super().__init__()
        self.heads = heads
        self.qkv = CastLinear(dim, 3 * dim, bias=qkv_bias,
                              compute_dtype=dtype)
        self.proj = CastLinear(dim, dim, compute_dtype=dtype)

    def forward(self, x):
        n, t, d = x.shape
        q, k, v = self.qkv(x).reshape(n, t, 3, self.heads, d // self.heads) \
            .permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(q, k, v)      # (n, heads, t, hd)
        return self.proj(y.transpose(1, 2).reshape(n, t, d))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, dtype):
        super().__init__()
        self.fc1 = CastLinear(dim, hidden, compute_dtype=dtype)
        self.fc2 = CastLinear(hidden, dim, compute_dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, qkv_bias, eps, dtype):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads, qkv_bias, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, dim * mlp_ratio, dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """``forward(x)``: (N, 3, H, W) normalized crops -> (N, tokens,
    EMBED_DIM) fp32 features after the last norm."""

    def __init__(self, cfg: Config, dtype):
        super().__init__()
        vit = cfg.MODEL.VIT
        check_vit(vit)
        d = vit.EMBED_DIM
        self.grid = token_grid(cfg)
        self.patch_embed = CastConv2d(3, d, vit.PATCH_SIZE,
                                      stride=vit.PATCH_SIZE,
                                      padding=vit.PATCH_PADDING,
                                      compute_dtype=dtype)
        tokens = self.grid[0] * self.grid[1]
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, d))
        self.blocks = nn.ModuleList(
            Block(d, vit.NUM_HEADS, vit.MLP_RATIO, vit.QKV_BIAS, vit.LN_EPS,
                  dtype) for _ in range(vit.DEPTH))
        self.last_norm = nn.LayerNorm(d, eps=vit.LN_EPS)

    def embed(self, x):
        """Crops -> fp32 tokens with the position table added."""
        x = self.patch_embed(x).flatten(2).transpose(1, 2)
        if x.shape[1] != self.pos_embed.shape[1] - 1:
            raise ValueError(f"{tuple(x.shape)} tokens; the position table "
                             f"holds {self.pos_embed.shape[1] - 1}")
        return x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]

    def encode(self, x):
        """The blocks and the last norm."""
        for blk in self.blocks:
            x = blk(x)
        return self.last_norm(x)

    def forward(self, x):
        return self.encode(self.embed(x))
