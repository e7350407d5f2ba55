"""The benchmark's one door into the measured program, ``rsgnet_tpu_torch``:
its configuration from a ``portbench/configs`` file, and its model holding
the benchmark's weights. The drivers call the program's entry points
themselves; nothing here reaches below them.
"""
from __future__ import annotations

import torch


def config(cfg_file):
    """The program's Config from the configuration file's ``program``
    section (the experiment YAML as it stands), checked against the
    sizes the file states for the reference."""
    from rsgnet_tpu_torch.config.defaults import load_config
    cfg = load_config(None, cfg_file["program"])
    m = cfg_file["model"]
    stages = [cfg.MODEL.EXTRA.STAGE2, cfg.MODEL.EXTRA.STAGE3,
              cfg.MODEL.EXTRA.STAGE4]
    got = {"num_joints": cfg.MODEL.NUM_JOINTS,
           "image_size": list(cfg.MODEL.IMAGE_SIZE),
           "heatmap_size": list(cfg.MODEL.HEATMAP_SIZE),
           "final_conv_kernel": cfg.MODEL.EXTRA.FINAL_CONV_KERNEL,
           "stages": [{"modules": s.NUM_MODULES, "branches": s.NUM_BRANCHES,
                       "block": s.BLOCK, "blocks": list(s.NUM_BLOCKS),
                       "channels": list(s.NUM_CHANNELS)} for s in stages],
           "rsg": {"node_channels": cfg.MODEL.RSG.NODE_CHANNELS,
                   "relation_channels": cfg.MODEL.RSG.RELATION_CHANNELS,
                   "gcn_layers": cfg.MODEL.RSG.GCN_LAYERS,
                   "refine_blocks": cfg.MODEL.RSG.REFINE_BLOCKS}}
    if got != m or cfg.DTYPE != cfg_file["dtype"]:
        raise ValueError(f"the program's configuration differs from the "
                         f"file's: {got} dtype {cfg.DTYPE}")
    return cfg


def _head_name(ref_name):
    """Reference RSG head name -> the program's (``rsg_head.*``)."""
    parts = ref_name.split(".")[1:]
    if parts[0] in ("w_neigh", "w_self"):
        return ".".join(["rsg_head", f"gcn{parts[1]}", parts[0], *parts[2:]])
    if parts[0] == "refine":
        sub = {"0": "conv", "1": "bn"}[parts[2]]
        return ".".join(["rsg_head", f"refine{parts[1]}", sub, *parts[3:]])
    return ".".join(["rsg_head", *parts])


def state_dict(cfg, ref_sd):
    """The benchmark's reference-named weights under the program's names:
    the backbone through the program's own reader of reference HRNet
    checkpoints, the head by ``_head_name``."""
    from rsgnet_tpu_torch.utils.torch_convert import convert_state_dict
    prefix = "backbone."
    backbone = {k[len(prefix):]: v for k, v in ref_sd.items()
                if k.startswith(prefix)}
    out = convert_state_dict(cfg, backbone, prefix=prefix)
    out.update({_head_name(k): v for k, v in ref_sd.items()
                if k.startswith("head.")
                and not k.endswith("num_batches_tracked")})
    return out


def model(cfg, ref_sd, device):
    """``get_pose_net(cfg)`` on ``device`` holding the benchmark's
    weights (every tensor of its state dict, strictly)."""
    from rsgnet_tpu_torch.models import get_pose_net
    with torch.device(device):
        net = get_pose_net(cfg)
    net = net.to(device)
    net.load_state_dict(state_dict(cfg, ref_sd), strict=True)
    return net
