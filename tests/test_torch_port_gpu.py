"""Card-only tests of the port: the hand-written CUDA DARK kernel against
its plain PyTorch version, and the inference function on the card against
the CPU. Every test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is False.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_port_gpu.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the other files.)

Tolerances: kernel vs plain version on the same card — peaks identical,
maxvals and coords bit-equal: the kernel is built with -fmad=false and
takes the plain version's operations in its order, and ``chip_smoke.py``
phase 2 shows it bit-equal on every case, the ``HARD_DARK`` ones
included (the JAX kernel's own contract, tests/test_pallas_dark.py, is
rtol 1e-4 / atol 2e-4). Card vs CPU
at fp32: preds atol 1e-2 px, maxvals atol 1e-4 (conv summation order, as
tests/test_torch_port_inference.py).
"""
import numpy as np
import pytest
import torch

from rsgnet_tpu_torch.config.defaults import tiny_rsgnet
from rsgnet_tpu_torch.core.inference import make_inference_fn
from rsgnet_tpu_torch.models import get_pose_net, init_weights
from rsgnet_tpu_torch.ops import decode as tdec
from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode

from _torch_port_common import (HARD_DARK, hard_dark_heatmaps, make_heatmaps,
                                nchw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _np(t):
    return t.detach().cpu().numpy()


def _kernel_vs_plain(hm, blur):
    c_k, v_k, peaks_k = dark_decode(hm, blur, return_peaks=True)
    c_p, v_p = tdec.dark_decode_reference(hm, blur)
    torch.cuda.synchronize()
    peaks_p = torch.argmax(hm.reshape(hm.shape[0], hm.shape[1], -1), dim=2)
    np.testing.assert_array_equal(_np(peaks_k), _np(peaks_p))
    np.testing.assert_array_equal(_np(v_k), _np(v_p))
    np.testing.assert_array_equal(_np(c_k), _np(c_p))


@pytest.mark.gpu
@pytest.mark.parametrize("blur", [3, 11])
def test_kernel_matches_plain_at_serving_shape(cuda, blur):
    hm, _ = make_heatmaps(n=64, k=17, h=96, w=72, seed=6, sigma=3.0)
    x = nchw(hm).to(cuda)
    before = dark_decode.launches
    _kernel_vs_plain(x, blur)
    assert dark_decode.launches == before + 1


@pytest.mark.gpu
def test_kernel_edge_cases(cuda):
    hm = np.zeros((3, 96, 72, 7), np.float32)   # N*K = 21: no block multiple
    hm[0, 1, 1, 1] = 1.0                         # border peak: no Newton
    hm[1, :, :, 2] = -1.0                        # maxval <= 0: coords 0
    hm[2, 40, 30, 3] = hm[2, 50, 20, 3] = 2.0    # tie: first match
    c, v = dark_decode(nchw(hm).to(cuda), 11)
    c, v = _np(c), _np(v)
    assert c[0, 0].tolist() == [0.0, 0.0] and v[0, 0, 0] == 0.0   # zero map
    assert c[0, 1].tolist() == [1.0, 1.0]
    assert c[1, 2].tolist() == [0.0, 0.0] and v[1, 2, 0] == -1.0
    assert abs(c[2, 3, 0] - 30.0) < 1.0 and abs(c[2, 3, 1] - 40.0) < 1.0
    _kernel_vs_plain(nchw(hm).to(cuda), 11)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(HARD_DARK))
def test_kernel_matches_plain_on_hard_cases(cuda, case):
    _kernel_vs_plain(nchw(hard_dark_heatmaps(case)).to(cuda), HARD_DARK[case])


@pytest.mark.gpu
def test_kernel_matches_plain_on_its_4_byte_path(cuda):
    hm, _ = make_heatmaps(n=2, h=37, w=29, k=3, seed=7)
    _kernel_vs_plain(nchw(hm).to(cuda), 7)           # odd width
    x = nchw(make_heatmaps(n=4, h=96, w=72, k=17, seed=8, sigma=3.0)[0])
    shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)                                 # 4-byte aligned maps
    _kernel_vs_plain(shifted, 11)


@pytest.mark.gpu
def test_kernel_rejects_maps_beyond_shared_memory(cuda):
    with pytest.raises(ValueError):
        dark_decode(torch.zeros(1, 1, 256, 256, device=cuda), 3)


@pytest.mark.gpu
def test_inference_on_card_matches_cpu(cuda):
    cfg = tiny_rsgnet()
    cfg.TEST.DECODE = "dark"
    cfg.TEST.BLUR_KERNEL = 5
    model = init_weights(get_pose_net(cfg), seed=1)
    model_cpu = get_pose_net(cfg)
    model_cpu.load_state_dict(model.state_dict())
    rng = np.random.RandomState(2)
    req = (rng.randint(0, 256, (4, 96, 64, 3)).astype(np.uint8),
           rng.uniform(50, 300, (4, 2)).astype(np.float32),
           rng.uniform(0.4, 1.5, (4, 2)).astype(np.float32))
    fn = make_inference_fn(cfg, model, normalize_input=True, device=cuda)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    before = dark_decode.launches
    p, v = fn(*req)
    assert dark_decode.launches == before + 1
    assert p.is_cuda and v.is_cuda
    p_ref, v_ref = make_inference_fn(cfg, model_cpu, normalize_input=True,
                                     device="cpu")(*req)
    np.testing.assert_allclose(_np(p), _np(p_ref), atol=1e-2, rtol=0)
    np.testing.assert_allclose(_np(v), _np(v_ref), atol=1e-4, rtol=0)
