"""Plain NCHW PyTorch RSGNet: HRNet backbone + relation/skeleton-graph head.

A frozen copy of the module classes of the repository's test oracles
(``tests/torch_hrnet.py``, ``tests/torch_rsgnet.py``), without their
loaders, built from the plain topology dict of a ``portbench/configs``
file. Public HRNet architecture (arXiv 1902.09212 section 3): stem (two
stride-2 3x3 convs -> 64ch), layer1 (4 x Bottleneck -> 256ch), per-stage
transitions, HighResolutionModules with exchange fusion, and a 1x1 conv to
K heatmaps; then the RSG head (node pooling by heatmap softmax, instance
FiLM, skeleton GCN, splat + refine + delta).

Everything runs in float32 except the layers named by the configuration's
compute dtype, which ``Quant`` may round to a lower precision: that is the
benchmark's control (``portbench/controls.py``), never the reference. It
imports nothing of the measured program.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_MOMENTUM = 0.1


class _Fp8RoundTrip(torch.autograd.Function):
    """Per-tensor scaled float8 rounding: e4m3 forward, e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def _fp8(x, dtype):
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    s = float(torch.finfo(dtype).max) / amax
    return ((x.float() * s).to(dtype).float() / s).to(x.dtype)


class Quant:
    """How the layers the configuration runs in its compute dtype compute:
    ``None`` (float32, the reference), ``"fp8"`` (the control: inputs,
    weights and outputs rounded to float8 with a per-tensor scale, e4m3
    forward and e5m2 for the gradients, accumulation in float32) or
    ``"bf16"`` (the layer run in bfloat16, as the configuration states: a
    witness of what that precision alone does)."""

    def __init__(self, mode=None):
        if mode not in (None, "fp8", "bf16"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x):
        return _Fp8RoundTrip.apply(x)


class QConv2d(nn.Conv2d):
    def __init__(self, *args, quant=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        mode = None if self.quant is None else self.quant.mode
        if mode is None:
            return super().forward(x)
        if mode == "bf16":
            b = None if self.bias is None else self.bias.bfloat16()
            return self._conv_forward(x.bfloat16(), self.weight.bfloat16(),
                                      b).float()
        return self.quant(self._conv_forward(
            self.quant(x), self.quant(self.weight), self.bias))


class QLinear(nn.Linear):
    def __init__(self, *args, quant=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        mode = None if self.quant is None else self.quant.mode
        if mode is None:
            return super().forward(x)
        if mode == "bf16":
            return F.linear(x.bfloat16(), self.weight.bfloat16(),
                            self.bias.bfloat16()).float()
        return self.quant(F.linear(self.quant(x), self.quant(self.weight),
                                   self.bias))


def conv3x3(cin, cout, stride=1, q=None):
    return QConv2d(cin, cout, 3, stride=stride, padding=1, bias=False,
                   quant=q)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, q=None):
        super().__init__()
        self.conv1 = conv3x3(inplanes, planes, stride, q)
        self.bn1 = nn.BatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv3x3(planes, planes, q=q)
        self.bn2 = nn.BatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.downsample = downsample

    def forward(self, x):
        residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, q=None):
        super().__init__()
        self.conv1 = QConv2d(inplanes, planes, 1, bias=False, quant=q)
        self.bn1 = nn.BatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.conv2 = QConv2d(planes, planes, 3, stride=stride, padding=1,
                             bias=False, quant=q)
        self.bn2 = nn.BatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.conv3 = QConv2d(planes, planes * self.expansion, 1, bias=False,
                             quant=q)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion,
                                  momentum=BN_MOMENTUM)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


class HighResolutionModule(nn.Module):
    """Parallel branches + exchange-fusion units."""

    def __init__(self, num_branches, block, num_blocks, num_inchannels,
                 num_channels, multi_scale_output=True, q=None):
        super().__init__()
        self.num_branches = num_branches
        self.num_inchannels = list(num_inchannels)

        branches = []
        for i in range(num_branches):
            layers = []
            cin = self.num_inchannels[i]
            cout = num_channels[i] * block.expansion
            for n in range(num_blocks[i]):
                downsample = None
                if n == 0 and cin != cout:
                    downsample = nn.Sequential(
                        QConv2d(cin, cout, 1, bias=False, quant=q),
                        nn.BatchNorm2d(cout, momentum=BN_MOMENTUM))
                layers.append(block(cin, num_channels[i],
                                    downsample=downsample, q=q))
                cin = cout
            self.num_inchannels[i] = cout
            branches.append(nn.Sequential(*layers))
        self.branches = nn.ModuleList(branches)

        fuse_layers = []
        if num_branches > 1:
            num_out = num_branches if multi_scale_output else 1
            for i in range(num_out):
                row = []
                for j in range(num_branches):
                    if j == i:
                        row.append(None)
                    elif j > i:
                        row.append(nn.Sequential(
                            QConv2d(self.num_inchannels[j],
                                    self.num_inchannels[i], 1, bias=False,
                                    quant=q),
                            nn.BatchNorm2d(self.num_inchannels[i],
                                           momentum=BN_MOMENTUM),
                            nn.Upsample(scale_factor=2 ** (j - i),
                                        mode="nearest")))
                    else:
                        steps = []
                        for k in range(i - j):
                            last = k == i - j - 1
                            cout = (self.num_inchannels[i] if last
                                    else self.num_inchannels[j])
                            ops = [conv3x3(self.num_inchannels[j], cout, 2, q),
                                   nn.BatchNorm2d(cout, momentum=BN_MOMENTUM)]
                            if not last:
                                ops.append(nn.ReLU(inplace=True))
                            steps.append(nn.Sequential(*ops))
                        row.append(nn.Sequential(*steps))
                fuse_layers.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse_layers)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, xs):
        xs = list(xs)
        for i in range(self.num_branches):
            xs[i] = self.branches[i](xs[i])
        if self.num_branches == 1:
            return xs
        outs = []
        for i in range(len(self.fuse_layers)):
            y = xs[0] if i == 0 else self.fuse_layers[i][0](xs[0])
            for j in range(1, self.num_branches):
                if j == i:
                    y = y + xs[j]
                else:
                    y = y + self.fuse_layers[i][j](xs[j])
            outs.append(self.relu(y))
        return outs


class PoseHighResolutionNet(nn.Module):
    """HRNet from the configuration's ``stages`` list (STAGE2..4)."""

    def __init__(self, model_cfg, q=None, checkpoint=False):
        super().__init__()
        self.checkpoint = checkpoint
        self.conv1 = conv3x3(3, 64, 2, q)
        self.bn1 = nn.BatchNorm2d(64, momentum=BN_MOMENTUM)
        self.conv2 = conv3x3(64, 64, 2, q)
        self.bn2 = nn.BatchNorm2d(64, momentum=BN_MOMENTUM)
        self.relu = nn.ReLU(inplace=True)

        downsample = nn.Sequential(
            QConv2d(64, 256, 1, bias=False, quant=q),
            nn.BatchNorm2d(256, momentum=BN_MOMENTUM))
        self.layer1 = nn.Sequential(
            Bottleneck(64, 64, downsample=downsample, q=q),
            *[Bottleneck(256, 64, q=q) for _ in range(3)])

        prev = [256]
        self.stage_cfgs = model_cfg["stages"]
        for si, scfg in enumerate(self.stage_cfgs, start=2):
            block = BLOCKS[scfg["block"]]
            cur = [c * block.expansion for c in scfg["channels"]]
            setattr(self, f"transition{si - 1}",
                    self._make_transition(prev, cur, q))
            modules = []
            chans = cur
            last_stage = si == len(self.stage_cfgs) + 1
            for m in range(scfg["modules"]):
                # the last stage's last module emits only the top branch
                mso = not last_stage or m < scfg["modules"] - 1
                mod = HighResolutionModule(
                    scfg["branches"], block, scfg["blocks"], chans,
                    scfg["channels"], multi_scale_output=mso, q=q)
                chans = mod.num_inchannels
                modules.append(mod)
            setattr(self, f"stage{si}", nn.Sequential(*modules))
            prev = cur

        k = model_cfg["final_conv_kernel"]
        # float32 in the configuration: never rounded
        self.final_layer = nn.Conv2d(prev[0], model_cfg["num_joints"], k,
                                     padding=1 if k == 3 else 0)
        self.feature_channels = prev[0]

    @staticmethod
    def _make_transition(prev, cur, q):
        layers = []
        for i, ch in enumerate(cur):
            if i < len(prev):
                if prev[i] != ch:
                    layers.append(nn.Sequential(
                        conv3x3(prev[i], ch, q=q),
                        nn.BatchNorm2d(ch, momentum=BN_MOMENTUM),
                        nn.ReLU(inplace=True)))
                else:
                    layers.append(None)
            else:
                steps = []
                src = prev[-1]
                n = i + 1 - len(prev)
                for k in range(n):
                    cout = ch if k == n - 1 else src
                    steps.append(nn.Sequential(
                        conv3x3(src, cout, 2, q),
                        nn.BatchNorm2d(cout, momentum=BN_MOMENTUM),
                        nn.ReLU(inplace=True)))
                layers.append(nn.Sequential(*steps))
        return nn.ModuleList(layers)

    def _run(self, mod, xs):
        if self.checkpoint and self.training and torch.is_grad_enabled():
            # recomputed in backward: the same float32 arithmetic, less
            # memory; train-mode BatchNorm normalizes with batch statistics,
            # so the recompute gives the same values
            return torch.utils.checkpoint.checkpoint(
                lambda *a: tuple(mod(list(a))), *xs, use_reentrant=False)
        return mod(xs)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [x]
        for si, scfg in enumerate(self.stage_cfgs, start=2):
            transition = getattr(self, f"transition{si - 1}")
            nxt = []
            for i in range(scfg["branches"]):
                if transition[i] is not None:
                    nxt.append(transition[i](xs[min(i, len(xs) - 1)]))
                else:
                    nxt.append(xs[i])
            xs = nxt
            for mod in getattr(self, f"stage{si}"):
                xs = list(self._run(mod, xs))
        return self.final_layer(xs[0]), xs[0]


def skeleton_adjacency(num_joints, skeleton):
    """Symmetric-normalized adjacency with self loops: D^-1/2 (A + I)
    D^-1/2."""
    a = np.zeros((num_joints, num_joints), np.float64)
    for i, j in skeleton:
        a[i, j] = a[j, i] = 1.0
    a += np.eye(num_joints)
    d = 1.0 / np.sqrt(a.sum(1))
    return (a * d[:, None] * d[None, :]).astype(np.float32)


class RSGHead(nn.Module):
    def __init__(self, num_joints, adjacency, feat_channels,
                 node_channels=64, relation_channels=64, gcn_layers=2,
                 refine_blocks=1, q=None):
        super().__init__()
        self.register_buffer(
            "adj", torch.as_tensor(np.asarray(adjacency), dtype=torch.float32),
            persistent=False)
        cn = node_channels
        self.node_proj = QConv2d(feat_channels, cn, 1, quant=q)
        self.rel_fc1 = QLinear(feat_channels, relation_channels, quant=q)
        self.rel_film = QLinear(relation_channels, 2 * cn, quant=q)
        self.w_neigh = nn.ModuleList(
            [QLinear(cn, cn, quant=q) for _ in range(gcn_layers)])
        self.w_self = nn.ModuleList(
            [QLinear(cn, cn, quant=q) for _ in range(gcn_layers)])
        refine = []
        cin = feat_channels + cn
        for _ in range(refine_blocks):
            refine.append(nn.Sequential(
                QConv2d(cin, cn, 3, padding=1, bias=False, quant=q),
                nn.BatchNorm2d(cn, momentum=BN_MOMENTUM),
                nn.ReLU(inplace=True)))
            cin = cn
        self.refine = nn.ModuleList(refine)
        self.delta = nn.Conv2d(cn, num_joints, 1)      # float32

    def forward(self, feats, initial):
        """feats: (B, C, H, W); initial: (B, K, H, W) -> (final, initial)."""
        b, c, h, w = feats.shape
        k = initial.shape[1]
        attn = torch.softmax(initial.reshape(b, k, h * w), dim=-1)
        proj = self.node_proj(feats).reshape(b, -1, h * w)
        nodes = torch.einsum("bkp,bcp->bkc", attn, proj)
        g = torch.relu(self.rel_fc1(feats.mean(dim=(2, 3))))
        scale, shift = self.rel_film(g).chunk(2, dim=-1)
        nodes = nodes * (1.0 + scale[:, None, :]) + shift[:, None, :]
        for wn, ws in zip(self.w_neigh, self.w_self):
            neigh = torch.einsum("kj,bjc->bkc", self.adj, nodes)
            nodes = torch.relu(wn(neigh) + ws(nodes))
        ctx = torch.einsum("bkp,bkc->bpc", attn, nodes)
        ctx = ctx.permute(0, 2, 1).reshape(b, -1, h, w)
        y = torch.cat([feats, ctx], dim=1)
        for block in self.refine:
            y = block(y)
        return initial + self.delta(y), initial


class PoseRSGNet(nn.Module):
    """backbone + head; ``forward`` returns (final, initial) heatmaps."""

    def __init__(self, model_cfg, skeleton, quant=None, checkpoint=False):
        super().__init__()
        q = Quant(quant)
        self.backbone = PoseHighResolutionNet(model_cfg, q, checkpoint)
        rsg = model_cfg["rsg"]
        self.head = RSGHead(
            model_cfg["num_joints"],
            skeleton_adjacency(model_cfg["num_joints"], skeleton),
            self.backbone.feature_channels,
            node_channels=rsg["node_channels"],
            relation_channels=rsg["relation_channels"],
            gcn_layers=rsg["gcn_layers"], refine_blocks=rsg["refine_blocks"],
            q=q)

    def forward(self, x):
        initial, feats = self.backbone(x)
        return self.head(feats, initial)


def weight_leaves(model):
    """[(name, shape, fan_in)] of every conv and linear weight, in module
    order: the tensors ``portbench/weights.py`` draws."""
    out = []
    for mname, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            out.append((f"{mname}.weight", tuple(mod.weight.shape),
                        int(mod.weight[0].numel())))
    return out
