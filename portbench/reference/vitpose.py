"""Plain NCHW PyTorch ViTPose in float32: Xu et al., "ViTPose: Simple
Vision Transformer Baselines for Human Pose Estimation" (NeurIPS 2022,
arXiv 2204.12484), as its COCO configurations define it
(``ViTPose_huge_coco_256x192.py`` for ViTPose-H), built from the plain
topology dict of a ``portbench/configs`` file (its ``model``).

- ``backbone.patch_embed.proj``: Conv2d(3, C, p, stride p, padding 2) of
  the normalized crop (ViTPose's ``PatchEmbed`` at ratio 1);
- ``backbone.pos_embed``: a (1, tokens + 1, C) table added as
  ``x + pos[:, 1:] + pos[:, :1]`` (no class token);
- ``backbone.blocks.{i}``: ``x = x + attn(norm1(x)); x = x + mlp(norm2(x))``
  with LayerNorm (eps from the file), multi-head attention with a biased
  ``qkv`` projection, q scaled by head_dim^-0.5, a softmax over keys and
  an output ``proj``, and an MLP ``fc1`` -> exact GELU -> ``fc2``;
- ``backbone.last_norm``, then the tokens back on their grid;
- ``keypoint_head`` (``TopdownHeatmapSimpleHead``): ``deconv_layers`` of
  ConvTranspose2d(k 4, stride 2, padding 1, no bias), BatchNorm2d and
  ReLU each, and a 1x1 ``final_layer`` conv with bias to K heatmaps.

The names are the released checkpoints'. Departures from the published
model: none in the forward (drop-path, 0.55 in ViTPose-H's training, is
the identity at inference). Around it, the benchmark runs the pipeline of
``pipeline.py`` (the crop, flip-test with the one-column shift and DARK),
not ViTPose's UDP test pipeline; the configuration's ``assumed`` says so.

Everything runs in float32, TF32 off (``reference_model``), except the
layers the configuration runs in its compute dtype (the patch conv, the
block linears, the attention's two matmuls and the deconvs), which
``model.py::Quant`` may round to float8 (the control) or run in bfloat16
(a witness); LayerNorm, softmax, the residual stream, BatchNorm and the
final conv stay float32. Weights: ``make_state_dict``, one seeded draw.
FLOPs from shapes: ``vitpose_flops``, ``vit_blocks_flops``. Imports
nothing of the measured program.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.model import BN_MOMENTUM, QConv2d, QLinear, Quant

POS_STD = 0.02          # ViTPose's trunc_normal_(pos_embed, std=.02)


def _mode(q):
    return None if q is None else q.mode


def qmatmul(a, b, q):
    """``a @ b`` as a layer in the compute dtype computes it: float32, or
    in bfloat16, or with inputs and output rounded to float8."""
    mode = _mode(q)
    if mode is None:
        return a @ b
    if mode == "bf16":
        return (a.bfloat16() @ b.bfloat16()).float()
    return q(q(a) @ q(b))


class QConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, quant=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def _run(self, x, w, b):
        return F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)

    def forward(self, x):
        mode = _mode(self.quant)
        if mode is None:
            return super().forward(x)
        if mode == "bf16":
            b = None if self.bias is None else self.bias.bfloat16()
            return self._run(x.bfloat16(), self.weight.bfloat16(), b).float()
        return self.quant(self._run(self.quant(x), self.quant(self.weight),
                                    self.bias))


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, padding, q):
        super().__init__()
        self.proj = QConv2d(3, dim, patch, stride=patch, padding=padding,
                            quant=q)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim, heads, qkv_bias, q):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = QLinear(dim, 3 * dim, bias=qkv_bias, quant=q)
        self.proj = QLinear(dim, dim, quant=q)
        self.q = q

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = qmatmul(q, k.transpose(-2, -1), self.q).softmax(dim=-1)
        x = qmatmul(attn, v, self.q).transpose(1, 2).reshape(b, n, c)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, q):
        super().__init__()
        self.fc1 = QLinear(dim, hidden, quant=q)
        self.fc2 = QLinear(hidden, dim, quant=q)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, m, q):
        super().__init__()
        d = m["embed_dim"]
        self.norm1 = nn.LayerNorm(d, eps=m["ln_eps"])
        self.attn = Attention(d, m["num_heads"], m["qkv_bias"], q)
        self.norm2 = nn.LayerNorm(d, eps=m["ln_eps"])
        self.mlp = Mlp(d, d * m["mlp_ratio"], q)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def token_grid(m):
    """(rows, cols) of the patch grid of the configuration's crop."""
    w, h = m["image_size"]
    p, pad = m["patch_size"], m["patch_padding"]
    return (h + 2 * pad - p) // p + 1, (w + 2 * pad - p) // p + 1


class ViT(nn.Module):
    def __init__(self, m, q):
        super().__init__()
        d = m["embed_dim"]
        self.grid = token_grid(m)
        self.patch_embed = PatchEmbed(d, m["patch_size"], m["patch_padding"],
                                      q)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1] + 1, d))
        self.blocks = nn.ModuleList(Block(m, q) for _ in range(m["depth"]))
        self.last_norm = nn.LayerNorm(d, eps=m["ln_eps"])

    def forward(self, x):
        b = x.shape[0]
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        x = self.last_norm(x)
        return x.permute(0, 2, 1).reshape(b, -1, *self.grid)


class Head(nn.Module):
    def __init__(self, m, q):
        super().__init__()
        layers, cin = [], m["embed_dim"]
        for cout, k in zip(m["deconv_filters"], m["deconv_kernels"]):
            if k != 4:
                raise ValueError(f"deconv kernel {k}: only 4 (padding 1, "
                                 f"no output padding) is written here")
            layers += [QConvTranspose2d(cin, cout, k, stride=2, padding=1,
                                        bias=m["deconv_bias"], quant=q),
                       nn.BatchNorm2d(cout, momentum=BN_MOMENTUM),
                       nn.ReLU(inplace=True)]
            cin = cout
        self.deconv_layers = nn.Sequential(*layers)
        k = m["final_conv_kernel"]
        # float32 in the configuration: never rounded
        self.final_layer = nn.Conv2d(cin, m["num_joints"], k,
                                     padding=1 if k == 3 else 0)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class ViTPose(nn.Module):
    """``forward(x)`` -> (heatmaps,): the pipeline's ``predict`` takes the
    first output, as it takes RSGNet's final heatmaps."""

    def __init__(self, m, quant=None):
        super().__init__()
        q = Quant(quant)
        self.backbone = ViT(m, q)
        self.keypoint_head = Head(m, q)

    def forward(self, x):
        return (self.keypoint_head(self.backbone(x)),)


def reference_model(m, sd, device, quant=None):
    """The reference on ``device`` holding the weights ``sd``; its float32
    matmuls and convs stay float32: TF32 is switched off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        model = ViTPose(m, quant)
    model = model.to(device)
    model.load_state_dict(sd)
    return model.eval()


def weight_leaves(model):
    """[(name, shape, std)] of the tensors drawn from the seed, in
    parameter order: every conv, transposed-conv and linear weight
    lecun-normal (std fan_in^-0.5; a transposed conv's fan_in is Cin x k x
    k, as the program's initializer counts it) and the position table at
    ``POS_STD``."""
    kinds = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
    weights = {f"{n}.weight": m for n, m in model.named_modules()
               if isinstance(m, kinds)}
    out = []
    for name, p in model.named_parameters():
        if name in weights:
            w = p[:, 0] if isinstance(weights[name], nn.ConvTranspose2d) \
                else p[0]
            out.append((name, tuple(p.shape), w.numel() ** -0.5))
        elif name.endswith("pos_embed"):
            out.append((name, tuple(p.shape), POS_STD))
    return out


def make_state_dict(m, seed, device):
    """{reference name: float32 tensor on ``device``} from ``seed``: one
    ``randn`` of every drawn tensor together (``weight_leaves``), cut in
    parameter order; biases 0; LayerNorm and BatchNorm the identity
    (scale 1, shift 0, running mean 0, running variance 1)."""
    with torch.device("meta"):
        shape_model = ViTPose(m)
    leaves = weight_leaves(shape_model)
    total = sum(int(torch.Size(s).numel()) for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    sd, off = {}, 0
    for name, shape, std in leaves:
        n = int(torch.Size(shape).numel())
        sd[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    for name, t in shape_model.state_dict().items():
        if name in sd:
            continue
        leaf = name.rsplit(".", 1)[1]
        if leaf == "num_batches_tracked":
            sd[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif leaf in ("weight", "running_var"):
            sd[name] = torch.ones(t.shape, device=device)
        else:                   # biases, shifts, running means
            sd[name] = torch.zeros(t.shape, device=device)
    return sd


def vit_blocks_flops(m, batch=1):
    """FLOPs of the blocks of ``batch`` crops, 2 a multiply-add: per block
    and token the four linears (qkv 3C^2, proj C^2, fc1 and fc2 r C^2
    each), per block the two attention matmuls (2 T^2 C)."""
    c, r = m["embed_dim"], m["mlp_ratio"]
    rows, cols = token_grid(m)
    t = rows * cols
    linears = 2 * t * c * c * (4 + 2 * r)
    attention = 2 * 2 * t * t * c
    return batch * m["depth"] * (linears + attention)


def vitpose_flops(m):
    """FLOPs of one crop's forward, 2 a multiply-add: the patch conv, the
    blocks (``vit_blocks_flops``), each transposed conv (every input pixel
    times Cin x Cout x k x k) and the final conv. ViTPose-H at 256x192:
    251.7 GFLOP."""
    c, p = m["embed_dim"], m["patch_size"]
    rows, cols = token_grid(m)
    flops = 2 * rows * cols * c * 3 * p * p + vit_blocks_flops(m)
    cin = c
    for cout, k in zip(m["deconv_filters"], m["deconv_kernels"]):
        flops += 2 * rows * cols * cin * cout * k * k
        rows, cols, cin = 2 * rows, 2 * cols, cout
    k = m["final_conv_kernel"]
    return flops + 2 * rows * cols * cin * m["num_joints"] * k * k
