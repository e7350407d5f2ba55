"""Port decode vs JAX on CPU, and the CUDA DARK kernel vs its plain version.

CPU tolerances:
- argmax peaks, maxvals and quarter-offset: exact (same first-match rule,
  same fp32 ops);
- DARK: integer peaks and maxvals identical; coords rtol 1e-4 / atol 2e-4,
  the JAX kernel's own contract (tests/test_pallas_dark.py): the blur sums
  in another order than XLA's convolution and the log differs by an ulp.

The kernel itself is tested on the card in tests/test_torch_port_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsgnet_tpu.ops.decode import (dark_gaussian_blur_jax, dark_refine_jax,
                                   get_final_preds_jax, get_max_preds_jax,
                                   quarter_offset_jax)
from rsgnet_tpu.ops.pallas.dark_decode import dark_decode_pallas
from rsgnet_tpu_torch.ops import decode as tdec
from rsgnet_tpu_torch.ops.cuda.dark_decode import (MAX_BLUR_KERNEL,
                                                   MAX_SHARED_BYTES,
                                                   MAX_WIDTH, dark_decode,
                                                   shared_bytes)

from _torch_port_common import (HARD_DARK, hard_dark_heatmaps, make_heatmaps,
                                nchw)


def _np(t):
    return t.detach().cpu().numpy()


def test_get_max_preds_exact_with_ties():
    hm, _ = make_heatmaps()
    hm[0, 10, 11, 0] = hm[0, 30, 5, 0] = 5.0          # tie: first match wins
    hm[1, :, :, 1] = -1.0                              # maxval <= 0 -> 0,0
    c1, v1 = get_max_preds_jax(jnp.asarray(hm))
    c2, v2 = tdec.get_max_preds(nchw(hm))
    np.testing.assert_array_equal(_np(c2), np.asarray(c1))
    np.testing.assert_array_equal(_np(v2), np.asarray(v1))
    assert _np(c2)[0, 0].tolist() == [11.0, 10.0]


def test_quarter_offset_exact():
    hm, _ = make_heatmaps(seed=1)
    coords, _ = get_max_preds_jax(jnp.asarray(hm))
    theirs = np.asarray(quarter_offset_jax(jnp.asarray(hm), coords))
    ours = tdec.quarter_offset(nchw(hm), torch.from_numpy(np.asarray(coords)))
    np.testing.assert_array_equal(_np(ours), theirs)


@pytest.mark.parametrize("ksize", [1, 3, 7, 11, 15])
def test_cv2_gaussian_table(ksize):
    from rsgnet_tpu.ops.decode import _cv2_gaussian_kernel_1d as jax_k1d
    np.testing.assert_array_equal(tdec._cv2_gaussian_kernel_1d(ksize),
                                  jax_k1d(ksize))


@pytest.mark.parametrize("blur", [3, 11])
def test_dark_blur_matches_jax(blur):
    hm, _ = make_heatmaps(seed=2)
    theirs = np.asarray(dark_gaussian_blur_jax(jnp.asarray(hm), blur))
    ours = _np(tdec.dark_gaussian_blur(nchw(hm), blur)).transpose(0, 2, 3, 1)
    # summation order differs from XLA's conv: a few ulp of values <= ~1
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)


def _dark_decode_vs_jax(hm, blur, against):
    """The port's DARK decode (its plain version, on the CPU) against the
    Pallas kernel in interpret mode or the jnp argmax + refine."""
    if against == "pallas":
        c_ref, v_ref = dark_decode_pallas(jnp.asarray(hm), blur_kernel=blur,
                                          interpret=True)
    else:
        c0, v_ref = get_max_preds_jax(jnp.asarray(hm))
        c_ref = dark_refine_jax(jnp.asarray(hm), c0, blur_kernel=blur)
    n, _, _, k = hm.shape
    jax_peaks = np.argmax(hm.transpose(0, 3, 1, 2).reshape(n, k, -1), 2)
    c, v, peaks = dark_decode(nchw(hm), blur, return_peaks=True)  # plain
    np.testing.assert_array_equal(_np(peaks), jax_peaks)
    np.testing.assert_array_equal(_np(v), np.asarray(v_ref))
    np.testing.assert_allclose(_np(c), np.asarray(c_ref), rtol=1e-4,
                               atol=2e-4)


@pytest.mark.parametrize("blur", [3, 11])
@pytest.mark.parametrize("against", ["pallas", "jnp"])
def test_dark_decode_matches_jax(blur, against):
    hm, _ = make_heatmaps(n=3, k=17, h=64, w=48, seed=4)
    _dark_decode_vs_jax(hm, blur, against)


def test_dark_recovers_subpixel_peaks():
    hm, centers = make_heatmaps(seed=3)
    c, _ = dark_decode(nchw(hm), 11)
    assert np.abs(_np(c) - centers).max() < 0.35


def test_dark_zero_map_and_border_peak():
    hm = np.zeros((1, 64, 48, 2), np.float32)
    hm[0, 1, 1, 1] = 1.0                   # too close to the border
    c, v = dark_decode(nchw(hm), 11)
    assert _np(c)[0, 0].tolist() == [0.0, 0.0] and _np(v)[0, 0, 0] == 0.0
    assert _np(c)[0, 1].tolist() == [1.0, 1.0]


def test_dark_wrapper_rejects_what_the_kernel_does_not_take():
    hm = torch.zeros(1, 2, 8, 8)
    for bad in (0, 2, MAX_BLUR_KERNEL + 2, 3.0):
        with pytest.raises(ValueError):
            dark_decode(hm, bad)
    with pytest.raises(TypeError):
        dark_decode(hm.double(), 3)
    with pytest.raises(ValueError):
        dark_decode(hm.transpose(2, 3), 3)
    with pytest.raises(ValueError):
        dark_decode(hm[0], 3)


def test_dark_wrapper_counts_no_launch_on_cpu():
    before = dark_decode.launches
    dark_decode(torch.rand(1, 2, 8, 8), 3)
    assert dark_decode.launches == before


def test_dark_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        dark_decode(torch.zeros(1, 2, 8, 8, device="meta"), 3)


@pytest.mark.parametrize("against", ["pallas", "jnp"])
@pytest.mark.parametrize("case", sorted(HARD_DARK))
def test_dark_decode_hard_cases_match_jax(case, against):
    _dark_decode_vs_jax(hard_dark_heatmaps(case), HARD_DARK[case], against)


def test_dark_hard_cases_hit_what_they_name():
    hm = nchw(hard_dark_heatmaps("plateau_tie_rows"))
    assert torch.equal(torch.argmax(hm[0, 0].reshape(-1)),
                       torch.tensor(28 * 48 + 17))      # first of the rows
    hm = nchw(hard_dark_heatmaps("newton_border"))
    _, _, peaks = dark_decode(hm, 11, return_peaks=True)
    assert [(int(p) % 48, int(p) // 48) for p in peaks[1, :4]] == [
        (2, 30), (45, 30), (20, 2), (20, 61)]
    c, v = dark_decode(nchw(hard_dark_heatmaps("all_negative")), 11)
    assert (_np(v) < 0).all() and (_np(c) == 0).all()
    hm = nchw(hard_dark_heatmaps("blurred_max_off_peak"))[2, :2]
    blurred = tdec.dark_gaussian_blur(hm[None], 11)[0]
    for j in range(2):
        assert int(torch.argmax(hm[j].reshape(-1))) == (10 + j) * 48 + 10
        assert int(torch.argmax(blurred[j].reshape(-1))) != (10 + j) * 48 + 10


@pytest.mark.parametrize("h,w,blur,fits", [
    (96, 72, 11, True), (96, 72, 31, True), (64, 64, 31, True),
    (8, 6, 11, True), (256, 256, 3, False), (4, 1000, 1, False)])
def test_dark_shared_bytes_takes_serving_maps_and_refuses_large_ones(
        h, w, blur, fits):
    # one staged copy, each row after a gap of round_up(r, 4) zeros, one
    # more gap after the last row, then 80 scratch words
    gap = ((blur - 1) // 2 + 3) // 4 * 4
    assert shared_bytes(h, w, blur) == 4 * (gap + h * (w + gap) + 80)
    assert (shared_bytes(h, w, blur) <= MAX_SHARED_BYTES
            and w <= MAX_WIDTH) == fits


def test_dark_serving_maps_fit_seven_to_an_sm():
    # an SM's 228 KB of shared memory holds seven 96x72 blur-11 maps (CUDA
    # reserves 1 KB per block); the first port's two copies held four
    assert shared_bytes(96, 72, 11) == 31072
    assert 7 * (shared_bytes(96, 72, 11) + 1024) <= 228 * 1024
    assert 4 * (2 * 96 * 72 * 4 + 1024) <= 228 * 1024 < 5 * (2 * 96 * 72 * 4)


@pytest.mark.parametrize("use_dark", [False, True])
@pytest.mark.parametrize("post_process", [False, True])
def test_get_final_preds_matches_jax(use_dark, post_process):
    hm, _ = make_heatmaps(n=4, k=17, seed=5)
    rng = np.random.RandomState(0)
    centers = rng.uniform(50, 400, (4, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, (4, 2)).astype(np.float32)
    p1, v1 = get_final_preds_jax(jnp.asarray(hm), centers, scales,
                                 post_process=post_process,
                                 use_dark=use_dark, blur_kernel=11)
    p2, v2 = tdec.get_final_preds(nchw(hm), torch.from_numpy(centers),
                                  torch.from_numpy(scales),
                                  post_process=post_process,
                                  use_dark=use_dark, blur_kernel=11)
    np.testing.assert_array_equal(_np(v2), np.asarray(v1))
    # image-space coords: the heatmap-space tolerance (2e-4) times the
    # box-to-heatmap scale (<= 400 px / 48 px) plus fp32 rounding
    np.testing.assert_allclose(_np(p2), np.asarray(p1), rtol=1e-5, atol=2e-3)
