"""The port's train warps against the JAX package's, on the CPU.

- The plain shear warp (``rsgnet_tpu_torch/ops/shear_warp.py``, the plain
  version of the CUDA kernel) against the JAX package's
  ``shear_warp_batch`` run op by op (eager): bit-equal, for uint8 and float
  sources. Against ``jax.jit(shear_warp_batch)`` and the Pallas kernel in
  interpret mode (bit-identical to each other on the CPU,
  tests/test_pallas_shear.py) the port may differ by no more than the JAX
  package's own eager form does on the same inputs: jit contracts the
  position arithmetic into fused multiply-adds (ops/pallas/shear_warp.py
  puts that gap at ~1e-3 on the 0-255 scale; on these inputs it reaches
  3.2e-3 for uint8 and 4.8e-5 for the float sources of range 3, 4.1e-3
  on the 0-255 scale).
- The same on five hard matrices, one sample each (4x zoom-out at 45
  degrees, 0.05x zoom-in, a crop centred 5 px from a corner, a crop wholly
  outside the source, -135 degrees flipped): bit-equal to the eager form
  on every case; the jitted form's own gap there reaches 1.08e-2 (uint8,
  the 4x zoom-out) and 1.2e-4 for float sources of range 3.
- The plain shear warp against the port's exact gather at rot 0, +-90 and
  flips: within 2e-5 on the 0-255 scale where the matrices' entries are
  dyadic, so that both compute their positions exactly; within 2e-3 for
  matrices from ``get_affine_transform``, where the gather rounds u = p + s
  to fp32 (~4e-6 px at u ~ 50) and the shear warp keeps frac(p) + frac(s)
  (the JAX package's own test of those angles allows 2e-3 and 1e-2).
- ``affine_warp_batch`` and ``shear_prepare`` against the JAX package's.
- The kernel wrapper's CPU route and its shape checks.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsgnet_tpu.ops.affine import get_affine_transform
from rsgnet_tpu.ops.pallas.shear_warp import shear_warp_pallas
from rsgnet_tpu.ops import shear_warp as jsw
from rsgnet_tpu.ops import warp as jwarp
from rsgnet_tpu_torch.ops import shear_warp as tsw
from rsgnet_tpu_torch.ops import warp as twarp
from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp

from _torch_port_common import HARD_WARPS, hard_warp_matrix

ROTS = [0.0, 17.0, -33.0, 45.0, 60.0, 90.0, -90.0, 120.0, 179.0]


def _trans_batch(rots, size, out_size, rng, jitter=True, flip=()):
    """src->dst matrices of random boxes around the center; samples listed
    in ``flip`` get the source mirror folded in, as augmentation does."""
    mats = []
    for i, r in enumerate(rots):
        c = np.array([size / 2, size / 2], np.float32)
        if jitter:
            c = c + rng.uniform(-size / 8, size / 8, 2).astype(np.float32)
        s = np.array([size / 200.0 * rng.uniform(0.7, 1.4),
                      size / 200.0 * rng.uniform(0.7, 1.4)], np.float32)
        m = get_affine_transform(c, s, r, out_size).astype(np.float32)
        if i in flip:
            m = np.stack([-m[:, 0], m[:, 1], m[:, 0] * (size - 1) + m[:, 2]],
                         axis=-1)
        mats.append(m)
    return np.stack(mats).astype(np.float32)


def _images(dtype, n, size, rng):
    if dtype == "uint8":
        return rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8), 255.0
    return rng.uniform(-1, 2, (n, size, size, 3)).astype(np.float32), 3.0


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_plain_shear_matches_jax(dtype):
    rng = np.random.RandomState(0)
    size, out_size = 96, (40, 56)          # non-power-of-two on purpose
    rots = ROTS + [25.0, -100.0]           # the last two flipped
    imgs, span = _images(dtype, len(rots), size, rng)
    trans = _trans_batch(rots, size, out_size, rng,
                         flip=(len(rots) - 2, len(rots) - 1))
    jit_ref = np.asarray(jax.jit(functools.partial(
        jsw.shear_warp_batch, out_size=out_size))(jnp.asarray(imgs),
                                                  jnp.asarray(trans)))
    pallas = np.asarray(shear_warp_pallas(jnp.asarray(imgs),
                                          jnp.asarray(trans), out_size,
                                          interpret=True))
    got = tsw.shear_warp_batch(torch.from_numpy(imgs),
                               torch.from_numpy(trans), out_size)
    assert got.shape == (len(rots), 3, out_size[1], out_size[0])
    assert got.dtype == torch.float32
    eager = np.asarray(jsw.shear_warp_batch(jnp.asarray(imgs),
                                            jnp.asarray(trans), out_size))
    np.testing.assert_array_equal(_nhwc(got), eager)
    gap = np.abs(eager - jit_ref).max()
    print(f"\nJAX shear warp, eager vs jit on {dtype} sources of range "
          f"{span:g}: {gap:.3e} ({gap * 255.0 / span:.3e} on 0-255)")
    assert gap <= 5e-3 * span / 255.0          # JAX's own eager-vs-jit gap
    for ref in (jit_ref, pallas):
        assert np.abs(_nhwc(got) - ref).max() <= gap
    # the transposed source frame was exercised
    pos = tsw.shear_prepare(torch.from_numpy(trans), size, out_size)
    assert pos.swap.any() and not pos.swap.all()


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("case", sorted(HARD_WARPS))
def test_plain_shear_matches_jax_on_hard_matrices(case, dtype):
    rng = np.random.RandomState(7)
    size, out_size = 96, (40, 56)
    imgs, span = _images(dtype, 1, size, rng)
    trans = hard_warp_matrix(case, size, out_size)
    got = _nhwc(tsw.shear_warp_batch(torch.from_numpy(imgs),
                                     torch.from_numpy(trans), out_size))
    eager = np.asarray(jsw.shear_warp_batch(jnp.asarray(imgs),
                                            jnp.asarray(trans), out_size))
    jit_ref = np.asarray(jax.jit(functools.partial(
        jsw.shear_warp_batch, out_size=out_size))(jnp.asarray(imgs),
                                                  jnp.asarray(trans)))
    gap = np.abs(eager - jit_ref).max()
    diff = np.abs(got - eager).max()
    print(f"\n{case} {dtype}: port vs JAX eager {diff:.3e}, JAX eager vs "
          f"jit {gap:.3e} (range {span:g})")
    np.testing.assert_array_equal(got, eager)
    assert np.abs(got - jit_ref).max() <= gap
    if case == "outside":
        assert not got.any()
    else:
        assert got.max() > 0.5 * span / 3.0


def test_plain_shear_exact_angles_match_gather():
    rng = np.random.RandomState(1)
    size, out_size = 64, (48, 64)
    imgs = torch.from_numpy(rng.randint(0, 256, (6, size, size, 3))
                            .astype(np.uint8))
    # rot 0 at scales 1 and 2, rot +90, rot -90, a flip and a flipped +90,
    # with dyadic entries: every position is exact in fp32 either way
    dyadic = torch.tensor([
        [[1.0, 0.0, -8.25], [0.0, 1.0, 4.5]],
        [[2.0, 0.0, -40.75], [0.0, 2.0, -30.5]],
        [[0.0, 1.0, -3.5], [-1.0, 0.0, 60.25]],
        [[0.0, -1.0, 55.75], [1.0, 0.0, 2.5]],
        [[-1.0, 0.0, 50.5], [0.0, 1.0, -6.25]],
        [[0.0, 1.0, 2.25], [1.0, 0.0, -5.5]]])
    for trans, atol in (
            (dyadic, 2e-5),
            (torch.from_numpy(_trans_batch(
                [0.0, 0.0, 90.0, -90.0, 0.0, 90.0], size, out_size, rng,
                jitter=False, flip=(4, 5))), 2e-3)):
        shear = tsw.shear_warp_batch(imgs, trans, out_size)
        gather = twarp.affine_warp_batch(imgs, trans, out_size)
        assert float(gather.abs().max()) > 0
        np.testing.assert_allclose(shear.numpy(), gather.numpy(), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_affine_warp_batch_matches_jax(dtype):
    rng = np.random.RandomState(2)
    src_h, src_w, out_size = 80, 72, (40, 56)      # non-square source
    n = 5
    imgs = (rng.randint(0, 256, (n, src_h, src_w, 3)).astype(np.uint8)
            if dtype == "uint8"
            else rng.uniform(-1, 2, (n, src_h, src_w, 3)).astype(np.float32))
    span = 255.0 if dtype == "uint8" else 3.0
    trans = _trans_batch([0.0, 30.0, -75.0, 90.0, 150.0], 72, out_size, rng)
    ref = np.asarray(jwarp.affine_warp_batch(jnp.asarray(imgs),
                                             jnp.asarray(trans), out_size))
    got = twarp.affine_warp_batch(torch.from_numpy(imgs),
                                  torch.from_numpy(trans), out_size)
    assert got.shape == (n, 3, out_size[1], out_size[0])
    np.testing.assert_allclose(_nhwc(got), ref, rtol=0,
                               atol=2e-3 * span / 255.0)


def test_invert_affine_and_shear_prepare_match_jax():
    rng = np.random.RandomState(3)
    size, out_size = 96, (40, 56)
    trans = _trans_batch(ROTS, size, out_size, rng, flip=(2,))
    inv_j = np.asarray(jwarp.invert_affine(jnp.asarray(trans)))
    inv_t = twarp.invert_affine(torch.from_numpy(trans)).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-6, atol=1e-6)
    imgs = np.zeros((len(ROTS), size, size, 1), np.float32)
    x_j, (pa, sa), (pb, sb) = jsw.shear_prepare(jnp.asarray(imgs),
                                                jnp.asarray(trans), out_size)
    pos = tsw.shear_prepare(torch.from_numpy(trans), size, out_size)
    m = np.asarray(jwarp.invert_affine(jnp.asarray(trans)))
    swap_j = np.abs(m[:, 1, 1]) < np.abs(m[:, 1, 0])
    np.testing.assert_array_equal(pos.swap.numpy(), swap_j)
    for got, ref in ((pos.p_a, pa), (pos.s_a, sa), (pos.p_b, pb),
                     (pos.s_b, sb)):
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_resolve_train_warp():
    for name in ("auto", "pallas", "shear"):
        assert twarp.resolve_train_warp(name) == "shear"
    assert twarp.resolve_train_warp("gather") == "gather"
    with pytest.raises(ValueError):
        twarp.resolve_train_warp("separable")


def test_kernel_wrapper_cpu_route_and_checks():
    rng = np.random.RandomState(4)
    size, out_size = 48, (24, 32)
    imgs = torch.from_numpy(rng.randint(0, 256, (2, size, size, 3))
                            .astype(np.uint8))
    trans = torch.from_numpy(_trans_batch([10.0, 100.0], size, out_size,
                                          rng))
    pos = tsw.shear_prepare(trans, size, out_size)
    before = shear_warp.launches
    out = shear_warp(imgs, pos)
    assert shear_warp.launches == before       # the CPU runs no kernel
    torch.testing.assert_close(out, tsw.shear_warp_reference(imgs, pos),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):            # not square
        shear_warp(imgs[:, :, :40].contiguous(), pos)
    with pytest.raises(TypeError):             # no int32 sources
        shear_warp(imgs.to(torch.int32), pos)
    with pytest.raises(ValueError):            # not contiguous
        shear_warp(imgs.transpose(1, 2), pos)
    with pytest.raises(ValueError):            # positions of another batch
        shear_warp(imgs[:1].contiguous(), pos)
    with pytest.raises(ValueError):            # no channels
        shear_warp(imgs[..., :0].contiguous(), pos)
    with pytest.raises(TypeError):
        shear_warp(imgs, pos._replace(p_a=pos.p_a.double()))
    with pytest.raises(ValueError):            # past 31-bit offsets
        shear_warp(imgs[:1].contiguous(),
                   tsw.shear_prepare(trans[:1], size, (2 ** 16, 2 ** 16)))
