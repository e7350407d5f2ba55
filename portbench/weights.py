"""Seeded weights, made on the device in one draw.

Every conv and linear weight is lecun-normal (std sqrt(1 / fan_in)), as
the program's own initializer draws them; biases are 0; BatchNorm scale 1,
shift 0, running mean 0, running variance 1. The draw is one ``randn`` of
all weights together from a ``torch.Generator`` on the device, cut into
leaves in module order: the same seed gives the same weights, and set-up
pays one kernel, not one per leaf. The names are the reference model's
(``portbench/reference/model.py``); ``portbench/program.py`` maps them onto
the program's modules.
"""
from __future__ import annotations

import torch

from portbench.reference.model import PoseRSGNet, weight_leaves


def reference_model(model_cfg, skeleton, sd, device, quant=None,
                    checkpoint=False):
    """The reference model on ``device`` holding the weights ``sd``. Its
    float32 matmuls and convs stay float32: TF32 is switched off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        model = PoseRSGNet(model_cfg, skeleton, quant, checkpoint)
    model = model.to(device)
    model.load_state_dict(sd)
    return model


def make_state_dict(model_cfg, skeleton, seed, device):
    """{reference name: float32 tensor on ``device``} from ``seed``."""
    with torch.device("meta"):
        shape_model = PoseRSGNet(model_cfg, skeleton)
    leaves = weight_leaves(shape_model)
    total = sum(int(torch.Size(s).numel()) for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    sd, off = {}, 0
    for name, shape, fan_in in leaves:
        n = int(torch.Size(shape).numel())
        sd[name] = flat[off:off + n].view(shape).mul_(fan_in ** -0.5)
        off += n
    for name, t in shape_model.state_dict().items():
        if name in sd:
            continue
        leaf = name.rsplit(".", 1)[1]
        if leaf == "num_batches_tracked":
            sd[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif leaf in ("weight", "running_var"):
            sd[name] = torch.ones(t.shape, device=device)
        else:                   # conv/linear bias, BN shift, running mean
            sd[name] = torch.zeros(t.shape, device=device)
    return sd
