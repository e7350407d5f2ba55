"""Card-only tests of the train slice: the hand-written CUDA shear-warp
kernel against its plain PyTorch version, and one tiny train step on the
card against the CPU. Every test takes the ``cuda`` fixture, which skips
where ``torch.cuda.is_available()`` is False. No JAX is imported, so the
file runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_train_gpu.py -q

Tolerances: kernel vs plain version on the same card, bit-equal. Both
round every multiply and add separately in the same order (the kernel is
built with -fmad=false), and the kernel's one pass computes each
pass-A value with the plain version's operations. Tiny fp32 train step,
card vs CPU, with SGD (Adam's first step maps every gradient element to
about +-lr and so magnifies rounding noise in near-zero elements; SGD
carries the gradients into the params linearly): loss rtol 1e-4; each
gradient tensor within 5e-2 of its max |grad| and within 3e-3 on average
over tensors (the bounds the CPU tests hold the JAX package's gradients
to: this model's gradients move by up to 2.7% under a 1e-6 change of its
inputs); every updated param within lr times that gradient bound.
"""
import copy

import numpy as np
import pytest
import torch

from rsgnet_tpu_torch.config.defaults import Config, tiny_rsgnet
from rsgnet_tpu_torch.core.train import create_train_state, make_train_step
from rsgnet_tpu_torch.data.augment import augment_geometry, draw_augment
from rsgnet_tpu_torch.data.skeletons import get_spec
from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
from rsgnet_tpu_torch.models import get_pose_net, init_weights
from rsgnet_tpu_torch.ops.affine import get_affine_transform_t
from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
from rsgnet_tpu_torch.ops.shear_warp import shear_prepare, shear_warp_reference

from _torch_port_common import HARD_WARPS, hard_warp_matrix


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _train_matrices(n, size, cfg, seed):
    """Augmentation matrices of a seeded raw batch, as the train step makes
    them, with fixed rotations, a flip and the transposed frame appended."""
    b = synthetic_train_batch(n, size, seed=seed)
    trans = augment_geometry(
        draw_augment(torch.Generator().manual_seed(seed), n),
        torch.from_numpy(b["joints"]), torch.from_numpy(b["joints_vis"]),
        torch.from_numpy(b["center"]), torch.from_numpy(b["scale"]),
        float(size), cfg, get_spec("coco"))[0]
    rots = torch.tensor([0.0, 30.0, -30.0, 90.0, -90.0, 179.0])
    fixed = get_affine_transform_t(
        torch.full((6, 2), size / 2.0), torch.full((6, 2), size / 300.0),
        rots, tuple(cfg.MODEL.IMAGE_SIZE))
    flipped = torch.stack([-fixed[1:2, :, 0], fixed[1:2, :, 1],
                           fixed[1:2, :, 0] * (size - 1) + fixed[1:2, :, 2]],
                          dim=-1)
    return torch.cat([trans, fixed, flipped])


def _kernel_vs_plain(images, trans, out_size, both_frames=True):
    """Runs the kernel once; it must be bit-equal to the plain version."""
    pos = shear_prepare(trans, images.shape[1], out_size)
    before = shear_warp.launches
    got = shear_warp(images, pos)
    assert shear_warp.launches == before + 1
    ref = shear_warp_reference(images, pos)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32
    if both_frames:
        assert pos.swap.any() and not pos.swap.all()
    assert torch.equal(got, ref), float((got - ref).abs().max())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_kernel_matches_plain_at_train_shape(cuda, dtype):
    cfg = Config()
    size = 640
    trans = _train_matrices(25, size, cfg, seed=3).to(cuda)
    n = trans.shape[0]
    rng = np.random.RandomState(4)
    if dtype == "uint8":
        images = torch.from_numpy(rng.randint(0, 256, (n, size, size, 3))
                                  .astype(np.uint8)).to(cuda)
    else:
        images = torch.from_numpy(rng.uniform(-1, 2, (n, size, size, 3))
                                  .astype(np.float32)).to(cuda)
    _kernel_vs_plain(images, trans, tuple(cfg.MODEL.IMAGE_SIZE))


@pytest.mark.gpu
def test_kernel_matches_plain_at_odd_size(cuda):
    cfg = Config()
    cfg.MODEL.IMAGE_SIZE = (40, 56)
    size = 97
    trans = _train_matrices(9, size, cfg, seed=5).to(cuda)
    images = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (trans.shape[0], size, size, 1)).astype(np.uint8)).to(cuda)
    _kernel_vs_plain(images, trans, (40, 56))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_kernel_matches_plain_off_the_tile_grid(cuda, dtype):
    # 45 x 27 outputs: neither side a multiple of the kernel's 32 x 4 tile
    cfg = Config()
    cfg.MODEL.IMAGE_SIZE = (45, 27)
    size = 130
    trans = _train_matrices(9, size, cfg, seed=8).to(cuda)
    rng = np.random.RandomState(9)
    shape = (trans.shape[0], size, size, 3)
    images = (torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
              if dtype == "uint8" else
              torch.from_numpy(rng.uniform(-1, 2, shape).astype(np.float32)))
    _kernel_vs_plain(images.to(cuda), trans, (45, 27))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("case", sorted(HARD_WARPS))
def test_kernel_matches_plain_on_hard_matrices(cuda, case, dtype):
    size, out_size = 640, tuple(Config().MODEL.IMAGE_SIZE)
    rng = np.random.RandomState(10)
    shape = (1, size, size, 3)
    images = (torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
              if dtype == "uint8" else
              torch.from_numpy(rng.uniform(-1, 2, shape).astype(np.float32)))
    trans = torch.from_numpy(hard_warp_matrix(case, size, out_size))
    got = _kernel_vs_plain(images.to(cuda), trans.to(cuda), out_size,
                           both_frames=False)
    assert (float(got.abs().max()) == 0.0) == (case == "outside")


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    cfg = Config()
    trans = _train_matrices(2, 64, cfg, seed=7)[:2].to(cuda)
    pos = shear_prepare(trans, 64, (48, 64))
    images = torch.zeros(2, 64, 64, 3, dtype=torch.uint8, device=cuda)
    before = shear_warp.launches
    with pytest.raises(TypeError):
        shear_warp(images.to(torch.int32), pos)
    with pytest.raises(ValueError):
        shear_warp(images.transpose(1, 2), pos)
    with pytest.raises(ValueError):
        shear_warp(images, pos._replace(p_a=pos.p_a.cpu()))
    assert shear_warp.launches == before


@pytest.mark.gpu
def test_tiny_train_step_on_card_matches_cpu(cuda):
    cfg = tiny_rsgnet()
    cfg.TRAIN.OPTIMIZER = "sgd"
    spec = get_spec("coco")
    model = init_weights(get_pose_net(cfg), seed=1)
    b = synthetic_train_batch(4, 128, seed=2)
    draws = draw_augment(torch.Generator().manual_seed(3), 4)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        state = create_train_state(cfg, copy.deepcopy(model), device=dev)
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        batch["image"] = batch["image"].to(dev)
        before = shear_warp.launches
        state, metrics = make_train_step(cfg, spec)(state, batch, draws)
        assert shear_warp.launches == before + (dev.type == "cuda")
        out[dev.type] = (float(metrics["loss"]),
                         {n: (p.detach().cpu(), p.grad.cpu())
                          for n, p in state.model.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    rels = []
    for name, (p_cpu, g_cpu) in out["cpu"][1].items():
        p_gpu, g_gpu = out["cuda"][1][name]
        scale = max(float(g_cpu.abs().max()), 1e-12)
        rels.append(float((g_gpu - g_cpu).abs().max()) / scale)
        assert rels[-1] <= 5e-2, (name, rels[-1])
        torch.testing.assert_close(p_gpu, p_cpu, rtol=0,
                                   atol=1e-6 + cfg.TRAIN.LR * 5e-2 * scale)
    assert float(np.mean(rels)) <= 3e-3, np.mean(rels)
