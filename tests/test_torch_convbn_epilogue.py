"""The ConvBN epilogue (``ops/cuda/convbn_epilogue.py``,
``csrc/convbn_epilogue.cu``) and its routing in ``models/hrnet.py``.

On the CPU: the operator's plain version is, bit for bit, the chain the
eval forward ran before the kernel (fp32 upcast, eval ``F.batch_norm``,
``+ residual``, ReLU), for BatchNorm alone, with ReLU, with a residual and
ReLU, and in ``DeconvBN``; eval mode reaches the operator, gradients on
or off, and its backward gives the plain chain's gradients; train mode
and CPU tensors never reach it; ``torch.export`` records the operator
where the eager path calls it; tiny HRNet, pose_resnet and ViTPose eval
forwards give the bits of the forward before the epilogue.

On a card (``gpu``; each test takes the ``cuda`` fixture, which skips
where ``torch.cuda.is_available()`` is False): the kernel against the
plain version at W48's plane sizes (27,648 down to 108 px) and ViTPose's
decoder's, bf16 and fp32, NCHW and channels-last, with and without
residual and ReLU, within a stated fp32 bound; the vector width it picks,
read from the kernel's name in a trace; a tensor it does not take raises;
ViTPose's channels-last decoder through it; W48's eval forward against
the plain chain at full width, and a W48 DARK e2e call replayed from CUDA
graphs bit-equal to its eager call, with the launch counter under capture
and replay; a ``TEST.FOLD_BN`` model; gradients on the card through the
operator's backward; an export on the card records the operator. No JAX
is imported, so the file runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_convbn_epilogue.py -q
"""
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rsgnet_tpu_torch.config.defaults import (load_config, tiny_resnet,
                                              tiny_rsgnet, tiny_vit)
from rsgnet_tpu_torch.models import get_pose_net, init_weights
from rsgnet_tpu_torch.models import hrnet, pose_resnet
from rsgnet_tpu_torch.models.hrnet import BN_EPS, BatchNorm, ConvBN
from rsgnet_tpu_torch.ops.cuda.convbn_epilogue import (
    convbn_epilogue, convbn_epilogue_reference)

W48_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments", "coco", "rsgnet", "w48_384x288.yaml")
OP = "rsgnet_tpu_torch.convbn_epilogue.default"
# (C, H, W) of W48 @ 384x288's BatchNorms: the stem at 192x144, layer1,
# then the four branches down to 12x9
W48_PLANES = [(64, 192, 144), (256, 96, 72), (48, 96, 72), (96, 48, 36),
              (192, 24, 18), (384, 12, 9)]
# ViTPose-H's two deconvs at 256x192, handed on channels-last
VIT_PLANES = [(256, 32, 24), (256, 64, 48)]
CASES = {"bn": (False, False), "bn_relu": (False, True),
         "bn_addend_relu": (True, True)}


def _stats(c, seed, device="cpu"):
    """BatchNorm parameters and running statistics with spread."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(c, generator=g)
    b = 0.5 * torch.randn(c, generator=g)
    m = 0.5 * torch.randn(c, generator=g)
    v = torch.rand(c, generator=g) * 2.0 + 0.05
    return [t.to(device) for t in (w, b, m, v)]


def _inputs(shape, dtype, addend, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=g).to(dtype).to(device)
    r = torch.randn(shape, generator=g).to(device) if addend else None
    return y, r


def _before(y, w, b, m, v, addend=None, relu=False):
    """The eval chain as the forward ran it before the epilogue."""
    x = F.batch_norm(y.float(), m, v, w, b, False, 0.0, BN_EPS)
    if addend is not None:
        x = x + addend
    return F.relu(x) if relu else x


def _bn_module(w, b, m, v):
    bn = BatchNorm(w.shape[0]).to(w.device)
    with torch.no_grad():
        for t, src in zip((bn.weight, bn.bias, bn.running_mean,
                           bn.running_var), (w, b, m, v)):
            t.copy_(src)
    return bn.eval()


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plain_version_is_the_chain_before(dtype, case):
    with_addend, relu = CASES[case]
    y, r = _inputs((2, 6, 5, 7), dtype, with_addend, seed=1)
    w, b, m, v = _stats(6, seed=2)
    want = _before(y, w, b, m, v, r, relu)
    op = torch.ops.rsgnet_tpu_torch.convbn_epilogue(y, w, b, m, v, r, BN_EPS,
                                                    relu)
    assert torch.equal(op, want)
    assert torch.equal(convbn_epilogue_reference(y, w, b, m, v, BN_EPS, r,
                                                 relu), want)
    with torch.no_grad():
        got = _bn_module(w, b, m, v)(y, addend=r, relu=relu)
    assert torch.equal(got, want)


def test_deconvbn_is_the_chain_before():
    torch.manual_seed(3)
    mod = pose_resnet.DeconvBN(4, 6, 4, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        mod.bn.running_mean.normal_()
        mod.bn.running_var.uniform_(0.1, 2.0)
        mod.bn.weight.normal_()
        x = torch.randn(2, 4, 5, 3)
        bn = mod.bn
        want = _before(mod.conv(x), bn.weight, bn.bias, bn.running_mean,
                       bn.running_var, relu=True)
        assert torch.equal(mod(x), want)


@pytest.fixture
def spied(monkeypatch):
    """The operator's calls from ``BatchNorm``, recorded, with the CPU's
    plain path sent through the operator too, so that only the mode
    decides the path."""
    calls = []

    def spy(*args, **kw):
        calls.append(args)
        return convbn_epilogue(*args, **kw)

    monkeypatch.setattr(hrnet, "convbn_epilogue", spy)
    monkeypatch.setattr(hrnet, "convbn_epilogue_reference", spy)
    return calls


def _grads(out, *leaves):
    return torch.autograd.grad(out.square().sum(), leaves)


# The operator's backward against autograd through the plain chain: the
# same formula, each product and sum rounded in another order (fp32)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["eval", "train", "grad"])
def test_only_eval_without_gradients_reaches_the_operator(spied, mode):
    """Eval mode reaches the operator, gradients off or on (its backward
    is the plain chain's); train mode never does."""
    y, r = _inputs((2, 3, 4, 4), torch.float32, True, seed=4)
    w, b, m, v = _stats(3, seed=5)
    bn = _bn_module(w, b, m, v)
    bn.train(mode == "train")
    y.requires_grad_(mode != "eval")
    with torch.set_grad_enabled(mode != "eval"):
        out = bn(y, addend=r, relu=True)
    assert len(spied) == (0 if mode == "train" else 1)
    if mode == "train":
        mean, var = hrnet.batch_stats(y)
        want = F.relu(hrnet._normalize(y, mean, var, w, b) + r)
    else:
        want = _before(y, w, b, m, v, r, relu=True)
    assert torch.equal(out, want)
    assert out.requires_grad == (mode != "eval")
    if mode == "grad":
        r.requires_grad_(True)
        got = _grads(bn(y, addend=r, relu=True), y, bn.weight, bn.bias, r)
        wl, bl = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        want = _grads(_before(y, wl, bl, m, v, r, relu=True), y, wl, bl, r)
        for g, g_want in zip(got, want):
            torch.testing.assert_close(g, g_want, **GRAD_TOL)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    calls = []
    monkeypatch.setattr(hrnet, "convbn_epilogue",
                        lambda *a, **k: calls.append(a))
    y, r = _inputs((2, 3, 4, 4), torch.bfloat16, True, seed=6)
    bn = _bn_module(*_stats(3, seed=7))
    with torch.no_grad():
        out = bn(y, addend=r, relu=True)
    assert calls == [] and out.dtype == torch.float32
    assert bn(y, addend=r, relu=True).requires_grad and calls == []


def test_export_records_the_operator(spied):
    torch.manual_seed(8)
    block = hrnet.BasicBlock(4, 4, dtype=torch.bfloat16).eval()
    x = torch.randn(2, 4, 6, 5)
    program = torch.export.export(block, (x,))
    ops = [str(n.target) for n in program.graph.nodes
           if "rsgnet_tpu_torch" in str(n.target)]
    assert ops == [OP, OP]
    with torch.no_grad():
        assert torch.equal(program.module()(x), block(x))


def _parent_bn(self, x):
    x = hrnet.at_least_f32(x)
    return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                        self.bias, False, 0.0, BN_EPS)


def _parent_convbn(self, x):
    y = (hrnet.space_to_depth_conv(x, self.conv) if self.s2d
         else self.conv(x))
    x = self.bn(y)
    return F.relu(x) if self.relu else x


def _parent_block(last):
    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = x
        for name in ("cb1", "cb2", "cb3")[:last]:
            y = getattr(self, name)(y)
        return F.relu(y + residual)
    return forward


def _parent_deconvbn(self, x):
    return F.relu(self.bn(self.conv(x)))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("preset,dtype", [
    (tiny_rsgnet, "float32"), (tiny_rsgnet, "bfloat16"),
    (tiny_resnet, "bfloat16"), (tiny_vit, "bfloat16")])
def test_tiny_eval_forwards_keep_the_parent_s_bits(monkeypatch, one_thread,
                                                   preset, dtype):
    cfg = preset()
    cfg.DTYPE = dtype
    model = init_weights(get_pose_net(cfg), seed=9).eval()
    for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
        with torch.no_grad():
            bn.running_mean.normal_(0.0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    x = torch.randn(2, 3, h, w, generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        now = model(x)
    monkeypatch.setattr(BatchNorm, "forward", _parent_bn)
    monkeypatch.setattr(ConvBN, "forward", _parent_convbn)
    monkeypatch.setattr(hrnet.BasicBlock, "forward", _parent_block(2))
    monkeypatch.setattr(hrnet.Bottleneck, "forward", _parent_block(3))
    monkeypatch.setattr(pose_resnet.DeconvBN, "forward", _parent_deconvbn)
    with torch.no_grad():
        before = model(x)
    assert torch.equal(now, before)


# -- on a card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsgnet_tpu_torch.core.inference import configure_precision
    configure_precision()
    return torch.device("cuda")


def _assert_close_to_plain(got, y, w, b, m, v, addend, relu):
    want = _before(y, w, b, m, v, addend, relu)
    s = w * torch.rsqrt(v + BN_EPS)
    mag = ((y.float() * s[:, None, None]).abs()
           + (m * s).abs()[:, None, None] + b.abs()[:, None, None])
    if addend is not None:
        mag = mag + addend.abs()
    err = (got - want).abs()
    bound = 8 * 2.0 ** -24 * mag
    assert bool((err <= bound).all()), (
        f"max |kernel - plain| {float(err.max()):.3e} beyond 8 ulps of the "
        f"terms at {int((err > bound).sum())} elements")


@pytest.mark.gpu
@pytest.mark.parametrize("plane", W48_PLANES + VIT_PLANES,
                         ids=lambda p: "x".join(map(str, p)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES) + ["bn_addend"])
@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last])
def test_the_kernel_against_the_plain_version(cuda, plane, dtype, case,
                                              layout):
    with_addend, relu = CASES.get(case, (True, False))
    c, h, w_ = plane
    y, r = _inputs((2, c, h, w_), dtype, with_addend, seed=c + h,
                   device=cuda)
    y = y.contiguous(memory_format=layout)
    r = None if r is None else r.contiguous(memory_format=layout)
    w, b, m, v = _stats(c, seed=h, device=cuda)
    before = convbn_epilogue.launches
    got = convbn_epilogue(y, w, b, m, v, BN_EPS, r, relu)
    torch.cuda.synchronize()
    assert convbn_epilogue.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == y.shape
    assert got.stride() == y.stride()          # y's order kept
    _assert_close_to_plain(got, y, w, b, m, v, r, relu)


def _widths(fn):
    """The vector widths (elements a thread) of the epilogue kernels that
    ``fn`` launches, in order: the second template argument of
    ``convbn_epilogue_kernel`` in a trace's kernel names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "convbn_epilogue_kernel" in e.name)
    return [int(re.search(r"convbn_epilogue_kernel<[^,]+, *(?:\(int\))?"
                          r"(\d+)", n).group(1)) for _, n in names]


@pytest.mark.gpu
def test_the_vector_width(cuda):
    def width(shape, dtype, shift=0, layout=torch.contiguous_format):
        y = torch.zeros(int(np.prod(shape)) + shift, dtype=dtype,
                        device=cuda)[shift:].view(shape)
        if layout != torch.contiguous_format:
            y = y.contiguous(memory_format=layout)
        st = _stats(shape[1], 0, cuda)
        (v,) = _widths(lambda: convbn_epilogue(y, *st, BN_EPS))
        return v
    assert [width((2, c, h, w), torch.bfloat16)
            for c, h, w in W48_PLANES] == [8, 8, 8, 8, 8, 4]
    assert [width((2, c, h, w), torch.float32)
            for c, h, w in W48_PLANES] == [4] * 6
    assert [width((2, c, h, w), torch.bfloat16, layout=torch.channels_last)
            for c, h, w in VIT_PLANES] == [8, 8]
    assert width((2, 3, 7, 5), torch.bfloat16) == 1
    assert width((2, 3, 8, 8), torch.bfloat16, shift=1) == 1
    assert width((2, 6, 4, 4), torch.bfloat16,
                 layout=torch.channels_last) == 2
    # a misaligned y, an odd plane and an odd channel count come out right
    for shape, shift, layout in (
            ((2, 3, 8, 8), 1, torch.contiguous_format),
            ((3, 5, 7, 5), 0, torch.contiguous_format),
            ((3, 5, 7, 5), 0, torch.channels_last)):
        y = torch.randn(int(np.prod(shape)) + shift, device=cuda).to(
            torch.bfloat16)[shift:].view(shape).contiguous(
                memory_format=layout)
        w, b, m, v = _stats(shape[1], seed=11, device=cuda)
        r = torch.randn(shape, device=cuda).contiguous(memory_format=layout)
        _assert_close_to_plain(convbn_epilogue(y, w, b, m, v, BN_EPS, r,
                                               True), y, w, b, m, v, r, True)


@pytest.mark.gpu
def test_what_the_kernel_does_not_take_raises(cuda):
    """Eval ``BatchNorm`` on the card has no fallback: a y the kernel does
    not take raises, through the module as through the operator."""
    w, b, m, v = _stats(4, seed=17, device=cuda)
    bn = _bn_module(w, b, m, v)
    y = torch.randn(2, 4, 6, 10, device=cuda).to(torch.bfloat16)
    nchw_r = torch.randn(2, 4, 6, 10, device=cuda)
    for label, y_, r in (
            ("a strided view", y[..., ::2], None),
            ("float16", y.half(), None),
            ("an addend of other strides", y.contiguous(
                memory_format=torch.channels_last), nchw_r),
            ("a bf16 addend", y, nchw_r.to(torch.bfloat16))):
        before = convbn_epilogue.launches
        with pytest.raises((ValueError, TypeError)), torch.no_grad():
            bn(y_, addend=r)
        assert convbn_epilogue.launches == before, label


@pytest.mark.gpu
def test_float64_on_the_card_is_the_plain_chain(cuda):
    """The exact model of the precision checks: float64 BatchNorms run
    the plain chain in float64, with no launch."""
    y, r = _inputs((2, 4, 6, 10), torch.float64, True, seed=20, device=cuda)
    r = r.double()
    w, b, m, v = _stats(4, seed=21, device=cuda)
    bn = _bn_module(w, b, m, v).double()
    before = convbn_epilogue.launches
    with torch.no_grad():
        out = bn(y, addend=r, relu=True)
    assert convbn_epilogue.launches == before and out.dtype == torch.float64
    want = F.relu(F.batch_norm(y, bn.running_mean, bn.running_var,
                               bn.weight, bn.bias, False, 0.0, BN_EPS) + r)
    assert torch.equal(out, want)


def _plain_chain(monkeypatch):
    """Send ``BatchNorm``'s eval path on the card through the plain chain:
    the comparison side of the model-level tests."""
    monkeypatch.setattr(hrnet, "convbn_epilogue", convbn_epilogue_reference)


@pytest.mark.gpu
def test_w48_s_eval_forward_against_the_plain_chain(cuda, monkeypatch):
    """W48 @ 384x288 in fp32, every one of its 293 BatchNorms through the
    kernel, against the same forward through the plain chain. Each kernel
    output lies within 8 fp32 ulps of its terms' magnitude; the convs,
    sums and upsamples carry a relative error on, so the heatmaps lie
    within 293 x 8 ulps of their largest magnitude."""
    cfg = load_config(W48_YAML)
    cfg.DTYPE = "float32"
    model = init_weights(get_pose_net(cfg), seed=18).cuda().eval()
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 293
    g = torch.Generator().manual_seed(19)
    with torch.no_grad():
        for bn in bns:
            c = bn.running_mean.shape[0]
            bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    x = torch.randn(2, 3, cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0],
                    generator=g).to(cuda)
    before = convbn_epilogue.launches
    with torch.no_grad():
        fused = model(x)
    torch.cuda.synchronize()
    assert convbn_epilogue.launches == before + 293
    _plain_chain(monkeypatch)
    with torch.no_grad():
        plain = model(x)
    assert convbn_epilogue.launches == before + 293
    scale = float(plain.abs().max())
    err = float((fused - plain).abs().max())
    tol = 293 * 8 * 2.0 ** -24 * scale
    print(f"W48 fp32 heatmaps: max |kernel - plain| {err:.3e}, "
          f"{err / tol:.4f} x the bound (max |heatmap| {scale:.3e})")
    assert err <= tol


@pytest.mark.gpu
def test_w48_replays_give_the_eager_bits_and_count_launches(cuda):
    from rsgnet_tpu_torch.core.inference import configure_cudnn, make_e2e_fn
    cfg = load_config(W48_YAML)
    configure_cudnn(cfg)
    model = init_weights(get_pose_net(cfg), seed=11).cuda()
    per_call = 2 * sum(isinstance(m, BatchNorm) for m in model.modules())
    assert per_call == 2 * 293                 # two forwards: flip-test
    fn = make_e2e_fn(cfg, model, (640, 640))
    rng = np.random.RandomState(1)
    req = (rng.randint(0, 256, (8, 640, 640, 3)).astype(np.uint8),
           rng.uniform(60, 220, (8, 2)).astype(np.float32),
           rng.uniform(0.4, 1.4, (8, 2)).astype(np.float32))
    counts = [convbn_epilogue.launches]
    outs = []
    for _ in range(3):                         # eager, captured, replayed
        outs.append([t.cpu() for t in fn(*req)])
        torch.cuda.synchronize()
        counts.append(convbn_epilogue.launches)
    assert (fn.eager_calls, fn.graph_replays) == (1, 2)
    assert np.diff(counts).tolist() == [per_call] * 3
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_a_folded_model_through_the_epilogue(cuda, monkeypatch):
    from rsgnet_tpu_torch.models.fold_bn import bn_folded
    cfg = tiny_rsgnet()
    model = init_weights(get_pose_net(cfg), seed=12).cuda().eval()
    x = torch.randn(4, 3, cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0],
                    device=cuda)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    with bn_folded(model):
        before = convbn_epilogue.launches
        with torch.no_grad():
            fused = model(x)
        torch.cuda.synchronize()
        assert convbn_epilogue.launches == before + n_bn
        with monkeypatch.context() as patch, torch.no_grad():
            _plain_chain(patch)
            plain = model(x)
        assert convbn_epilogue.launches == before + n_bn
    with torch.no_grad():
        unfolded = model(x)
    scale = float(plain.abs().max())
    torch.testing.assert_close(fused, plain, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(fused, unfolded, rtol=0, atol=1e-4 * scale)


@pytest.mark.gpu
def test_vitpose_s_channels_last_decoder_runs_the_epilogue(cuda,
                                                           monkeypatch):
    cfg = tiny_vit()                           # fp32: plain within rounding
    model = init_weights(get_pose_net(cfg), seed=16).cuda().eval()
    x = torch.randn(4, 3, cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0],
                    device=cuda)
    before = convbn_epilogue.launches
    with torch.no_grad():
        fused = model(x)
    torch.cuda.synchronize()
    assert convbn_epilogue.launches == before + cfg.MODEL.EXTRA.\
        NUM_DECONV_LAYERS
    _plain_chain(monkeypatch)
    with torch.no_grad():
        plain = model(x)
    assert convbn_epilogue.launches == before + cfg.MODEL.EXTRA.\
        NUM_DECONV_LAYERS
    # the two decoders differ by fp32 roundings before the final layer
    torch.testing.assert_close(fused, plain, rtol=0,
                               atol=1e-5 * float(plain.abs().max()))


@pytest.mark.gpu
def test_gradients_on_the_card_flow_through_the_operator(cuda):
    y, r = _inputs((2, 8, 6, 4), torch.bfloat16, True, seed=13,
                   device=cuda)
    y.requires_grad_(True)
    r.requires_grad_(True)
    w, b, m, v = _stats(8, seed=14, device=cuda)
    bn = _bn_module(w, b, m, v)
    before = convbn_epilogue.launches
    out = bn(y, addend=r, relu=True)
    assert convbn_epilogue.launches == before + 1 and out.requires_grad
    got = _grads(out, y, bn.weight, bn.bias, r)
    wl, bl = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = _grads(convbn_epilogue_reference(y, wl, bl, m, v, BN_EPS, r, True),
                  y, wl, bl, r)
    # the outputs differ within 8 ulps (above), so the squared loss's
    # gradients do too; y's is rounded to bf16 on both sides
    for g, g_want in zip(got, want):
        torch.testing.assert_close(g, g_want)


@pytest.mark.gpu
def test_an_export_on_the_card_records_the_operator(cuda):
    from rsgnet_tpu_torch.utils.export import export_inference
    cfg = tiny_rsgnet()
    cfg.TEST.DECODE = "dark"
    model = init_weights(get_pose_net(cfg), seed=15).cuda()
    program = export_inference(cfg, model, normalize_input=True)
    ops = [str(n.target) for n in program.graph.nodes
           if "convbn_epilogue" in str(n.target)]
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert cfg.TEST.FLIP_TEST
    assert ops == [OP] * (2 * n_bn)            # two forwards: flip-test
