"""Reference ``pose_hrnet``, ``pose_resnet`` and ViTPose checkpoints -> this
package's model (the port of the JAX package's ``utils/torch_convert.py``;
the ViTPose map, ``vit_key_map``, is the port's own).

Released HRNet-family checkpoints name their tensors ``conv1``/``bn1``,
``layer1.{b}``, ``transition{t}.{i}``, ``stage{s}.{m}.branches`` /
``fuse_layers`` and ``final_layer``; SimpleBaseline ones ``conv1``/``bn1``,
``layer{l}.{b}``, ``deconv_layers.{3i}`` / ``.{3i+1}`` and
``final_layer``. ``hrnet_key_map`` and ``resnet_key_map`` list, for each
of them, its flax scope path, which is also this package's module path
(``stem1.conv``, ``stage3_module2.fuse0_2.bn``, ``deconv1.conv``, ...).
The tensors stay as they are: convs are OIHW on both sides, a
``ConvTranspose2d`` weight is (I, O, kH, kW) on both sides (no flip on
this route), and BatchNorm's weight/bias/running_mean/running_var keep
their names. The RSG head has no reference counterpart and keeps its own
weights.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from rsgnet_tpu_torch.config.defaults import Config

# flax leaf name -> this package's parameter or buffer name
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _blocks(scfg):
    return {"BASIC": ("cb1", "cb2"),
            "BOTTLENECK": ("cb1", "cb2", "cb3")}[scfg.BLOCK]


def _leaf_makers(out):
    """(conv, bn): append a conv's weight, or a BatchNorm's four tensors,
    to ``out`` as (reference name, flax path, kind)."""

    def conv(tname, fpath):
        out.append((f"{tname}.weight", (*fpath, "conv", "kernel"), "conv"))

    def bn(tname, fpath):
        out.append((f"{tname}.weight", (*fpath, "bn", "scale"), "bn"))
        out.append((f"{tname}.bias", (*fpath, "bn", "bias"), "bn"))
        out.append((f"{tname}.running_mean", (*fpath, "bn", "mean"),
                    "bn_stat"))
        out.append((f"{tname}.running_var", (*fpath, "bn", "var"),
                    "bn_stat"))

    return conv, bn


def hrnet_key_map(cfg: Config) -> List[Tuple[str, Tuple[str, ...], str]]:
    """[(reference name, flax path, kind)] for every HRNet tensor; kind is
    'conv', 'bn', 'bn_stat' or 'bias'."""
    extra = cfg.MODEL.EXTRA
    out: List[Tuple[str, Tuple[str, ...], str]] = []
    conv, bn = _leaf_makers(out)

    conv("conv1", ("stem1",))
    bn("bn1", ("stem1",))
    conv("conv2", ("stem2",))
    bn("bn2", ("stem2",))
    # layer1: 4 x Bottleneck(64), a downsample on block 0
    for b in range(4):
        for ci, cb in enumerate(("cb1", "cb2", "cb3")):
            conv(f"layer1.{b}.conv{ci + 1}", (f"layer1_{b}", cb))
            bn(f"layer1.{b}.bn{ci + 1}", (f"layer1_{b}", cb))
        if b == 0:
            conv(f"layer1.{b}.downsample.0", (f"layer1_{b}", "downsample"))
            bn(f"layer1.{b}.downsample.1", (f"layer1_{b}", "downsample"))

    prev = [256]
    for si, scfg in enumerate([extra.STAGE2, extra.STAGE3, extra.STAGE4],
                              start=2):
        t = si - 1                      # transition index (1-based)
        exp = 4 if scfg.BLOCK == "BOTTLENECK" else 1
        cur = [c * exp for c in scfg.NUM_CHANNELS]
        for i, ch in enumerate(cur):
            if i < len(prev):
                if prev[i] != ch:
                    conv(f"transition{t}.{i}.0", (f"transition{t}_{i}",))
                    bn(f"transition{t}.{i}.1", (f"transition{t}_{i}",))
            else:
                for k in range(i + 1 - len(prev)):
                    conv(f"transition{t}.{i}.{k}.0",
                         (f"transition{t}_{i}_down{k}",))
                    bn(f"transition{t}.{i}.{k}.1",
                       (f"transition{t}_{i}_down{k}",))
        cbs = _blocks(scfg)
        for m in range(scfg.NUM_MODULES):
            mod, tmod = f"stage{si}_module{m}", f"stage{si}.{m}"
            for b in range(scfg.NUM_BRANCHES):
                for n in range(scfg.NUM_BLOCKS[b]):
                    for ci, cb in enumerate(cbs):
                        conv(f"{tmod}.branches.{b}.{n}.conv{ci + 1}",
                             (mod, f"branch{b}_block{n}", cb))
                        bn(f"{tmod}.branches.{b}.{n}.bn{ci + 1}",
                           (mod, f"branch{b}_block{n}", cb))
            # the last module of stage 4 has one output branch
            single = si == 4 and m == scfg.NUM_MODULES - 1
            num_out = 1 if single else scfg.NUM_BRANCHES
            if scfg.NUM_BRANCHES > 1:
                for i in range(num_out):
                    for j in range(scfg.NUM_BRANCHES):
                        if j > i:
                            conv(f"{tmod}.fuse_layers.{i}.{j}.0",
                                 (mod, f"fuse{i}_{j}"))
                            bn(f"{tmod}.fuse_layers.{i}.{j}.1",
                               (mod, f"fuse{i}_{j}"))
                        elif j < i:
                            for k in range(i - j):
                                conv(f"{tmod}.fuse_layers.{i}.{j}.{k}.0",
                                     (mod, f"fuse{i}_{j}_down{k}"))
                                bn(f"{tmod}.fuse_layers.{i}.{j}.{k}.1",
                                   (mod, f"fuse{i}_{j}_down{k}"))
        prev = cur

    out.append(("final_layer.weight", ("final_layer", "kernel"), "conv"))
    out.append(("final_layer.bias", ("final_layer", "bias"), "bias"))
    return out


def resnet_key_map(cfg: Config) -> List[Tuple[str, Tuple[str, ...], str]]:
    """[(reference name, flax path, kind)] for every pose_resnet tensor;
    kind is 'conv', 'deconv' (a ``ConvTranspose2d`` weight), 'bn',
    'bn_stat' or 'bias'. ImageNet ResNet checkpoints share the backbone
    names, so a pretrained backbone loads through the same map."""
    from rsgnet_tpu_torch.models.pose_resnet import RESNET_SPEC
    extra = cfg.MODEL.EXTRA
    block_name, stage_blocks = RESNET_SPEC[extra.NUM_LAYERS]
    out: List[Tuple[str, Tuple[str, ...], str]] = []
    conv, bn = _leaf_makers(out)
    conv("conv1", ("stem",))
    bn("bn1", ("stem",))
    cbs = ("cb1", "cb2") if block_name == "BASIC" else ("cb1", "cb2", "cb3")
    exp = 1 if block_name == "BASIC" else 4
    in_ch = 64
    for li, num_blocks in enumerate(stage_blocks, start=1):
        feats = 64 * (2 ** (li - 1))
        stride = 1 if li == 1 else 2
        for b in range(num_blocks):
            for ci, cb in enumerate(cbs):
                conv(f"layer{li}.{b}.conv{ci + 1}", (f"layer{li}_{b}", cb))
                bn(f"layer{li}.{b}.bn{ci + 1}", (f"layer{li}_{b}", cb))
            # the block has a projection exactly when stride or width change
            if b == 0 and (stride != 1 or in_ch != feats * exp):
                conv(f"layer{li}.{b}.downsample.0",
                     (f"layer{li}_{b}", "downsample"))
                bn(f"layer{li}.{b}.downsample.1",
                   (f"layer{li}_{b}", "downsample"))
            in_ch = feats * exp
    for i in range(extra.NUM_DECONV_LAYERS):
        # the reference head is nn.Sequential((ConvTranspose2d, BN, ReLU)*n)
        base = f"deconv_layers.{3 * i}"
        out.append((f"{base}.weight", (f"deconv{i}", "conv", "kernel"),
                    "deconv"))
        if extra.DECONV_WITH_BIAS:
            out.append((f"{base}.bias", (f"deconv{i}", "conv", "bias"),
                        "bias"))
        bn(f"deconv_layers.{3 * i + 1}", (f"deconv{i}",))
    out.append(("final_layer.weight", ("final_layer", "kernel"), "conv"))
    out.append(("final_layer.bias", ("final_layer", "bias"), "bias"))
    return out


def vit_key_map(cfg: Config) -> List[Tuple[str, str]]:
    """[(public ViTPose name, this package's name)] for every ``pose_vit``
    tensor. The released checkpoints name the backbone
    ``backbone.patch_embed.proj``, ``backbone.pos_embed``,
    ``backbone.blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
    mlp.fc2}`` and ``backbone.last_norm``, the decoder
    ``keypoint_head.deconv_layers.{3i}`` (a transposed conv) and
    ``.{3i+1}`` (its BatchNorm) and ``keypoint_head.final_layer``. Here
    the patch conv is ``backbone.patch_embed`` itself and the decoder
    ``deconv{i}.conv`` / ``.bn`` and ``final_layer``; every other name is
    the same. The whole model is mapped: no prefix is added."""
    vit, extra = cfg.MODEL.VIT, cfg.MODEL.EXTRA
    out = [("backbone.patch_embed.proj.weight", "backbone.patch_embed.weight"),
           ("backbone.patch_embed.proj.bias", "backbone.patch_embed.bias"),
           ("backbone.pos_embed", "backbone.pos_embed")]
    linears = [("attn.qkv", vit.QKV_BIAS), ("attn.proj", True),
               ("mlp.fc1", True), ("mlp.fc2", True)]
    for i in range(vit.DEPTH):
        names = [f"norm1.{t}" for t in ("weight", "bias")]
        names += [f"norm2.{t}" for t in ("weight", "bias")]
        for lin, bias in linears:
            names += [f"{lin}.weight"] + ([f"{lin}.bias"] if bias else [])
        out += [(f"backbone.blocks.{i}.{n}",) * 2 for n in names]
    out += [(f"backbone.last_norm.{t}",) * 2 for t in ("weight", "bias")]
    for i in range(extra.NUM_DECONV_LAYERS):
        base = "keypoint_head.deconv_layers"
        out.append((f"{base}.{3 * i}.weight", f"deconv{i}.conv.weight"))
        if extra.DECONV_WITH_BIAS:
            out.append((f"{base}.{3 * i}.bias", f"deconv{i}.conv.bias"))
        out += [(f"{base}.{3 * i + 1}.{t}", f"deconv{i}.bn.{t}")
                for t in ("weight", "bias", "running_mean", "running_var")]
    out += [(f"keypoint_head.final_layer.{t}", f"final_layer.{t}")
            for t in ("weight", "bias")]
    return out


def key_map(cfg: Config) -> List[Tuple[str, str]]:
    """[(reference name, this package's name without the backbone
    prefix)] for cfg's model family (``pose_vit``: the whole model's
    names, ``vit_key_map``)."""
    if cfg.MODEL.NAME == "pose_vit":
        return vit_key_map(cfg)
    table = (resnet_key_map(cfg) if cfg.MODEL.NAME == "pose_resnet"
             else hrnet_key_map(cfg))
    return [(tname, ".".join((*fpath[:-1], _LEAF[fpath[-1]])))
            for tname, fpath, _ in table]


def backbone_prefix(model) -> str:
    """"backbone." for a model with an HRNet backbone submodule
    (PoseRSGNet), else "" (a ViTPose map names the whole model)."""
    from rsgnet_tpu_torch.models.pose_vit import PoseViT
    return ("backbone." if hasattr(model, "backbone")
            and not isinstance(model, PoseViT) else "")


def convert_state_dict(cfg: Config, torch_sd: Dict[str, torch.Tensor],
                       prefix: str = "") -> Dict[str, torch.Tensor]:
    """Reference state dict -> this package's names (under ``prefix``).

    Raises on a missing backbone tensor and on any reference tensor the
    map does not consume (``head*`` and ``num_batches_tracked`` aside), so
    nothing is dropped silently."""
    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    for tname, pname in key_map(cfg):
        if tname not in torch_sd:
            raise KeyError(f"missing tensor in torch checkpoint: {tname}")
        out[prefix + pname] = torch_sd[tname]
        consumed.add(tname)
    leftovers = [k for k in torch_sd
                 if k not in consumed and not k.startswith("head")
                 and "num_batches_tracked" not in k]
    if leftovers:
        raise ValueError(f"unmapped torch tensors: {leftovers[:8]}"
                         f"{'...' if len(leftovers) > 8 else ''}")
    return out


@torch.no_grad()
def load_pretrained_backbone(cfg: Config, model, torch_sd) -> int:
    """The reference's ``init_weights``: copy into ``model`` the backbone
    tensors that ``torch_sd`` holds (an ImageNet HRNet or a pose
    checkpoint), as far as MODEL.EXTRA.PRETRAINED_LAYERS allows ('*' =
    all). Tensors it lacks (a classification checkpoint's final_layer)
    keep their init; a shape mismatch raises. Returns the count loaded."""
    allowed = tuple(cfg.MODEL.EXTRA.PRETRAINED_LAYERS)
    load_all = "*" in allowed
    own = model.state_dict()
    prefix = backbone_prefix(model)
    n_loaded = 0
    for tname, pname in key_map(cfg):
        if tname not in torch_sd:
            continue
        head = tname.split(".")[0]
        root = head.rstrip("0123456789") or tname
        if not load_all and head not in allowed and root not in allowed:
            continue
        dst, src = own[prefix + pname], torch_sd[tname]
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"shape mismatch for {tname}: "
                             f"{tuple(dst.shape)} vs {tuple(src.shape)}")
        dst.copy_(src)
        n_loaded += 1
    return n_loaded


def strip_module_prefix(sd) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's tensors: unwrapped from a ``state_dict``
    entry, with DataParallel's ``module.`` prefix removed."""
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` (tensors only, ``weights_only``)."""
    return strip_module_prefix(torch.load(path, map_location="cpu",
                                          weights_only=True))
