"""HRNet backbone in PyTorch (NCHW) — topology from the config.

The port of the JAX package's ``models/hrnet.py``. Submodules are named
after the flax scopes (``stem1.conv``, ``stage3_module2.fuse0_2.bn``, ...),
so ``utils/convert.py`` maps a flax variable tree onto this module's
state dict mechanically.

Precision follows ``cfg.DTYPE`` with explicit casts where the JAX side
casts (no autocast):

- parameters are fp32, as flax's ``param_dtype``; a conv or Dense layer
  (``CastConv2d``, ``CastLinear``) casts its input, weight and bias to the
  compute dtype (bf16 by default) at the call, as ``nn.Conv(dtype=...)``
  does. With gradients on, the cast sits inside autograd; without them
  (eval, serving) the cast weights are cached, so a forward pays no weight
  cast;
- ``BatchNorm`` in fp32, eps 1e-5: running statistics in eval mode; batch
  statistics and the flax running update in train mode. It also takes a
  block's residual and the ReLU after it, so that in eval mode on a card
  BatchNorm, residual and ReLU run as one kernel over the conv's output
  (``ops/cuda/convbn_epilogue.py``);
- residual sums, fusion sums and nearest upsampling in fp32;
- ``final_layer``: a fp32 1x1 conv with bias on fp32 features.

A float64 model (``model.double()`` with every cast layer's
``compute_dtype`` set to float64) computes everything in float64: the
"fp32" places keep float64 inputs as they are. The tests use that as an
anchor.

Execution strategies that compute the same function (the JAX package's
knobs; the state dict is the same under each):

- ``TRAIN.REMAT``: each HighResolutionModule of a train-mode forward runs
  under ``torch.utils.checkpoint`` and is recomputed in the backward pass;
  the recompute does not fold the batch statistics into the running ones
  a second time (``BatchNorm.update_stats``);
- ``MODEL.FUSE_MERGED``: the exchange fusion runs as merged convs (one
  channel-concat conv per source's up edges, the down chains level by
  level, concatenated at level 0 and block-diagonal after) with one
  BatchNorm over the concatenated edges;
- ``MODEL.S2D_STEM``: the 3-channel stride-2 stem conv runs as
  space-to-depth(2) and a smaller stride-1 conv (``space_to_depth_conv``).

In a process group of several processes, train-mode BatchNorm takes the
global batch's statistics (``batch_stats``), as the JAX package's
BatchNorm does over a batch sharded across devices.

Structure: stem (two stride-2 3x3 convs -> 64ch) -> layer1 (4 x Bottleneck
-> 256ch) -> transition1 -> stage2 {W, 2W} -> transition2 -> stage3
{W, 2W, 4W} -> transition3 -> stage4 {W, 2W, 4W, 8W} with only the
highest-resolution branch leaving it -> final conv W -> K heatmaps.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rsgnet_tpu_torch.config.defaults import Config, StageConfig
from rsgnet_tpu_torch.ops.cuda.convbn_epilogue import (
    convbn_epilogue, convbn_epilogue_reference)
from rsgnet_tpu_torch.parallel.distributed import (all_reduce_sum,
                                                   is_distributed)

BN_EPS = 1e-5
BN_MOMENTUM = 0.9        # flax EMA momentum (torch's momentum 0.1)


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.DTYPE == "bfloat16" else torch.float32


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is when it is float64 (the test anchor)."""
    return x if x.dtype == torch.float64 else x.float()


def _cast_params(mod: nn.Module, dtype: torch.dtype):
    """(weight, bias) of ``mod`` in ``dtype``. With gradients on, cast
    inside autograd (flax keeps fp32 params and casts at every call);
    otherwise reuse a cached cast, rebuilt when the weights change place or
    version (``load_state_dict``, an optimizer step, ``.to()``). A trace
    (``torch.export``) casts at the call: its fake tensors have no data
    pointer to key a cache by."""
    w, b = mod.weight, mod.bias
    if w.dtype == dtype:
        return w, b
    if torch.is_grad_enabled() or torch.compiler.is_compiling():
        return w.to(dtype), None if b is None else b.to(dtype)
    key = (w.device, w.data_ptr(), w._version,
           None if b is None else b._version)
    if mod._cast_key != key:
        mod._cast = (w.detach().to(dtype),
                     None if b is None else b.detach().to(dtype))
        mod._cast_key = key
    return mod._cast


class CastConv2d(nn.Conv2d):
    """``nn.Conv2d`` with fp32 parameters that computes in
    ``compute_dtype`` (input, weight and bias cast at the call)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self._cast_key = None

    def forward(self, x):
        w, b = _cast_params(self, self.compute_dtype)
        return self._conv_forward(x.to(self.compute_dtype), w, b)


class CastConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with fp32 parameters that computes in
    ``compute_dtype`` (the JAX side's dilated-input ``nn.Conv(dtype=...)``,
    ``models/pose_resnet.py::DeconvBN``)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self._cast_key = None

    def forward(self, x):
        w, b = _cast_params(self, self.compute_dtype)
        return F.conv_transpose2d(x.to(self.compute_dtype), w, b,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class CastLinear(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in
    ``compute_dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self._cast_key = None

    def forward(self, x):
        w, b = _cast_params(self, self.compute_dtype)
        return F.linear(x.to(self.compute_dtype), w, b)


def batch_stats(x):
    """Train-mode BatchNorm statistics of fp32 ``x`` (N, C, H, W) per
    channel, as flax computes them: mean E[x] and the biased variance
    max(0, E[x^2] - E[x]^2) (flax's default ``use_fast_variance``).

    In a process group of several processes they are the global batch's
    mean and biased variance: one all-reduce per call of a (2C + 1,)
    float64 tensor [count, sum x, sum x^2], differentiable
    (``parallel/distributed.py::all_reduce_sum``), so the gradient flows
    through the other processes' samples too and every process gets the
    same numbers. Each process's sums come from its own two-pass mean and
    variance, and E[x^2] - E[x]^2 is taken in float64, so the sums across
    processes add no cancellation of their own: a two-process step's
    gradients stay as close to the exact ones as one process's
    (``tests/test_torch_dp_step.py``)."""
    if is_distributed():
        c = x.shape[1]
        n = float(x.numel() // c)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        mean, var = mean.double(), var.double()
        sums = all_reduce_sum(torch.cat([
            mean.new_full((1,), n), n * mean, n * (var + mean * mean)]))
        mean = sums[1:c + 1] / sums[0]
        var = sums[c + 1:] / sums[0] - mean * mean
        return mean.to(x.dtype), torch.clamp_min(var, 0.0).to(x.dtype)
    mean = x.mean(dim=(0, 2, 3))
    ex2 = (x * x).mean(dim=(0, 2, 3))
    return mean, torch.clamp_min(ex2 - mean * mean, 0.0)


def _normalize(x, mean, var, weight, bias):
    mul = torch.rsqrt(var + BN_EPS) * weight
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + bias[:, None, None])


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 in fp32 (flax ``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5, dtype=float32)``): weight/bias parameters,
    running_mean/running_var buffers, nothing else in the state dict.

    Eval mode normalizes with the running statistics. Train mode
    normalizes with ``batch_stats`` (the global batch's in a process
    group), then (x - mean) * (rsqrt(var + eps) * weight) + bias; and it
    updates ``ra = 0.9 * ra + 0.1 * batch`` with that biased variance
    (``F.batch_norm`` would fold in the unbiased one), unless
    ``update_stats`` is False (a rematerialized forward's recompute).

    ``addend`` (a block's fp32 residual) is added to the normalized values
    and ``relu`` takes the ReLU last. In eval mode, off the CPU, the chain
    is the ConvBN epilogue operator: on a card one launch of its kernel,
    which raises for a tensor it does not take. On the CPU, in float64
    (the exact model that precision checks compare against) and in train
    mode the plain chain runs: fp32 at least (``at_least_f32``),
    normalize, ``+ addend``, ReLU."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.update_stats = True

    @torch.no_grad()
    def fold_running(self, mean, var):
        """Fold batch statistics into the running ones (flax's EMA)."""
        if self.update_stats:
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1.0 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1.0 - BN_MOMENTUM) * var)

    def forward(self, x, addend=None, relu=False):
        if not self.training:
            args = (self.weight, self.bias, self.running_mean,
                    self.running_var, BN_EPS, addend, relu)
            if x.device.type == "cpu" or x.dtype == torch.float64:
                return convbn_epilogue_reference(x, *args)
            return convbn_epilogue(x, *args)
        x = at_least_f32(x)
        mean, var = batch_stats(x)
        self.fold_running(mean, var)
        x = _normalize(x, mean, var, self.weight, self.bias)
        if addend is not None:
            x = x + addend
        return F.relu(x) if relu else x


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block no BatchNorm of ``module`` updates its running
    statistics (the recompute of a rematerialized forward: flax's
    ``nn.remat`` writes them once)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(bns, saved):
            m.update_stats = flag


def _remat_contexts(module):
    # checkpoint's context_fn: (forward context, recompute context)
    return contextlib.nullcontext(), frozen_running_stats(module)


def remat(module, *args):
    """``module(*args)`` with its activations recomputed in the backward
    pass instead of kept (TRAIN.REMAT, the JAX package's ``nn.remat``)."""
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=functools.partial(_remat_contexts, module))


def _cached(owner, key, tensors, build):
    """``build()`` with gradients on; else a copy cached on ``owner`` that
    is rebuilt when any of ``tensors`` changes place or version (as
    ``_cast_params`` caches casts). Inference tensors (a model moved under
    ``torch.inference_mode``) have no version and a trace's fake tensors no
    data pointer: no cache for them."""
    if (torch.is_grad_enabled() or torch.compiler.is_compiling()
            or any(t.is_inference() for t in tensors)):
        return build()
    stamp = tuple((t.device, t.data_ptr(), t._version) for t in tensors)
    hit = owner._merged_cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = (stamp, build())
        owner._merged_cache[key] = hit
    return hit[1]


def space_to_depth_conv(x, conv: nn.Conv2d):
    """``conv`` (odd k x k, stride 2, padding (k - 1) / 2, no bias) run as
    space-to-depth(2) and a stride-1 conv over the 2x2 blocks (the JAX
    package's ``_space_to_depth_conv``, MODEL.S2D_STEM).

    The kernel is zero-padded to (k + 1) x (k + 1) (a row and a column at
    the top and left, the taps outside the block lattice) and regrouped
    into a ((k + 1) / 2)^2 kernel over 4C channels; the blocks' channels
    are ordered (row in block, column in block, channel) on both sides.
    Every output is the same sum of products as the plain conv's, in
    another order. The parameter is the conv's own weight."""
    b, c, h, w = x.shape
    k = conv.kernel_size[0]
    if h % 2 or w % 2:
        raise ValueError(f"s2d stem needs even input dims, got {h}x{w}")
    dtype = conv.compute_dtype
    z = x.to(dtype).reshape(b, c, h // 2, 2, w // 2, 2)
    z = z.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)
    nblk = (k + 1) // 2
    weight = F.pad(conv.weight, (1, 0, 1, 0))     # (O, C, k + 1, k + 1)
    weight = weight.reshape(-1, c, nblk, 2, nblk, 2).permute(0, 3, 5, 1, 2, 4)
    weight = weight.reshape(-1, 4 * c, nblk, nblk).to(dtype)
    lo = nblk // 2
    hi = nblk - 1 - lo
    return F.conv2d(F.pad(z, (lo, hi, lo, hi)), weight)


class ConvBN(nn.Module):
    """Bias-free conv in the compute dtype -> fp32 BatchNorm -> optional
    ReLU. ``s2d``: the conv runs as ``space_to_depth_conv`` (odd kernels
    of stride 2 only). Called with ``residual`` (a block's last ConvBN),
    it adds the residual after the BatchNorm and takes the ReLU after the
    sum, whatever ``relu`` says: the block's tail, inside ``BatchNorm``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True,
                 dtype: torch.dtype = torch.float32, s2d: bool = False):
        super().__init__()
        if s2d and (kernel % 2 == 0 or stride != 2):
            raise ValueError("s2d execution requires an odd-kernel stride-2 "
                             "conv")
        pad = (kernel - 1) // 2
        self.conv = CastConv2d(in_features, features, kernel, stride, pad,
                               bias=False, compute_dtype=dtype)
        self.bn = BatchNorm(features)
        self.relu = relu
        self.s2d = s2d

    def forward(self, x, residual=None):
        y = space_to_depth_conv(x, self.conv) if self.s2d else self.conv(x)
        return self.bn(y, addend=residual,
                       relu=self.relu or residual is not None)


class BasicBlock(nn.Module):
    """conv3x3-bn-relu-conv3x3-bn + residual (expansion 1)."""
    expansion = 1

    def __init__(self, in_features, features, stride=1, dtype=torch.float32):
        super().__init__()
        self.cb1 = ConvBN(in_features, features, 3, stride, dtype=dtype)
        self.cb2 = ConvBN(features, features, 3, 1, relu=False, dtype=dtype)
        self.downsample = None
        if in_features != features or stride != 1:
            self.downsample = ConvBN(in_features, features, 1, stride,
                                     relu=False, dtype=dtype)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return self.cb2(self.cb1(x), residual=residual)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand(x4) + residual (expansion 4)."""
    expansion = 4

    def __init__(self, in_features, features, stride=1, dtype=torch.float32):
        super().__init__()
        out_ch = features * self.expansion
        self.cb1 = ConvBN(in_features, features, 1, 1, dtype=dtype)
        self.cb2 = ConvBN(features, features, 3, stride, dtype=dtype)
        self.cb3 = ConvBN(features, out_ch, 1, 1, relu=False, dtype=dtype)
        self.downsample = None
        if in_features != out_ch or stride != 1:
            self.downsample = ConvBN(in_features, out_ch, 1, stride,
                                     relu=False, dtype=dtype)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return self.cb3(self.cb2(self.cb1(x)), residual=residual)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _upsample_nearest(x, factor: int):
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def _block_diag(weights):
    """(O_i, I_i, kh, kw) conv weights -> one block-diagonal
    (sum O, sum I, kh, kw): conv(concat inputs, W) == concat of the
    per-weight convs (the JAX package's ``_block_diag_kernel``)."""
    kh, kw = weights[0].shape[2:]
    out = weights[0].new_zeros(sum(w.shape[0] for w in weights),
                               sum(w.shape[1] for w in weights), kh, kw)
    o = i = 0
    for w in weights:
        out[o:o + w.shape[0], i:i + w.shape[1]] = w
        o += w.shape[0]
        i += w.shape[1]
    return out


class HighResolutionModule(nn.Module):
    """Parallel branches of blocks + exchange-fusion units.

    Output branch i receives the sum over input branches j of
      j == i: identity
      j >  i: 1x1 conv + BN, then nearest-upsample by 2^(j-i)
      j <  i: chain of stride-2 3x3 conv+BN (ReLU on all but the last),
    then ReLU on the sum: edge by edge, or merged (``merged_fuse``,
    MODEL.FUSE_MERGED, ``_merged_fusion``) over the same submodules.
    """

    def __init__(self, num_branches: int, block: str,
                 num_blocks: Sequence[int], in_channels: Sequence[int],
                 num_channels: Sequence[int], multi_scale_output=True,
                 dtype=torch.float32, merged_fuse: bool = False):
        super().__init__()
        blk = BLOCKS[block]
        self.num_branches = num_branches
        self.num_blocks = tuple(num_blocks)
        self.merged_fuse = merged_fuse
        self._merged_cache: dict = {}
        out_ch = [c * blk.expansion for c in num_channels]
        for i in range(num_branches):
            cin = in_channels[i]
            for b in range(num_blocks[i]):
                setattr(self, f"branch{i}_block{b}",
                        blk(cin, num_channels[i], dtype=dtype))
                cin = out_ch[i]
        self.num_out = (num_branches if multi_scale_output else 1) \
            if num_branches > 1 else 0
        for i in range(self.num_out):
            for j in range(num_branches):
                if j > i:
                    setattr(self, f"fuse{i}_{j}",
                            ConvBN(out_ch[j], out_ch[i], 1, 1, relu=False,
                                   dtype=dtype))
                elif j < i:
                    for k in range(i - j):
                        last = k == i - j - 1
                        setattr(self, f"fuse{i}_{j}_down{k}",
                                ConvBN(out_ch[j],
                                       out_ch[i] if last else out_ch[j], 3, 2,
                                       relu=not last, dtype=dtype))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i in range(self.num_branches):
            x = xs[i]
            for b in range(self.num_blocks[i]):
                x = getattr(self, f"branch{i}_block{b}")(x)
            outs.append(x)
        if self.num_branches == 1:
            return outs
        if self.merged_fuse:
            return self._merged_fusion(outs)
        fused = []
        for i in range(self.num_out):
            acc = None
            for j in range(self.num_branches):
                if j == i:
                    y = outs[j]
                elif j > i:
                    y = _upsample_nearest(getattr(self, f"fuse{i}_{j}")(outs[j]),
                                          2 ** (j - i))
                else:
                    y = outs[j]
                    for k in range(i - j):
                        y = getattr(self, f"fuse{i}_{j}_down{k}")(y)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused

    def _merged_conv_bn(self, key, x, edges, stride, block_diag):
        """The ConvBN ``edges`` as one conv over ``x`` (their kernels
        concatenated along the output channels, or block-diagonal over
        ``x``'s concatenated inputs) and one BatchNorm over the
        concatenated channels; each edge's running statistics are its
        slice of the batch statistics. Outputs: the edges' channels in
        order."""
        convs = [e.conv for e in edges]
        bns = [e.bn for e in edges]
        dtype = convs[0].compute_dtype
        weights = [c.weight for c in convs]
        weight = _cached(
            self, key + "/conv", weights,
            lambda: (_block_diag(weights) if block_diag
                     else torch.cat(weights)).to(dtype))
        pad = (convs[0].kernel_size[0] - 1) // 2
        y = at_least_f32(F.conv2d(x.to(dtype), weight, None, stride, pad))
        if not self.training:
            stats = [t for b in bns for t in (b.weight, b.bias,
                                              b.running_mean, b.running_var)]
            w, b, rm, rv = _cached(self, key + "/bn", stats, lambda: [
                torch.cat([getattr(bn, n) for bn in bns]) for n in
                ("weight", "bias", "running_mean", "running_var")])
            return F.batch_norm(y, rm, rv, w, b, False, 0.0, BN_EPS)
        mean, var = batch_stats(y)
        off = 0
        for bn in bns:
            c = bn.weight.shape[0]
            bn.fold_running(mean[off:off + c], var[off:off + c])
            off += c
        return _normalize(y, mean, var, torch.cat([bn.weight for bn in bns]),
                          torch.cat([bn.bias for bn in bns]))

    def _merged_fusion(self, outs):
        """The exchange fusion with merged convs (the JAX package's
        ``_merged_fusion``): a source branch's 1x1 up edges share their
        input and run as one conv; its down chains advance level by level,
        sharing the input at level 0 (concatenated kernels) and merged
        block-diagonally after, one chain per level on its own input.
        Same function as the edge-by-edge loop up to the order of the
        sums; same submodules, so the same state dict."""
        acc = list(outs[:self.num_out])             # the identity terms
        for j in range(1, self.num_branches):
            targets = list(range(min(j, self.num_out)))
            if not targets:
                continue
            edges = [getattr(self, f"fuse{i}_{j}") for i in targets]
            y = self._merged_conv_bn(f"up{j}", outs[j], edges, 1, False)
            off = 0
            for i, e in zip(targets, edges):
                ch = e.bn.weight.shape[0]
                acc[i] = acc[i] + _upsample_nearest(y[:, off:off + ch],
                                                    2 ** (j - i))
                off += ch
        for j in range(self.num_branches):
            targets = list(range(j + 1, self.num_out))
            if not targets:
                continue
            cur = {i: outs[j] for i in targets}
            for level in range(max(i - j for i in targets)):
                active = [i for i in targets if i - j > level]
                edges = [getattr(self, f"fuse{i}_{j}_down{level}")
                         for i in active]
                if level == 0 or len(active) == 1:
                    x, diag = cur[active[0]], False
                else:
                    x, diag = torch.cat([cur[i] for i in active], 1), True
                y = self._merged_conv_bn(f"down{j}_{level}", x, edges, 2,
                                         diag)
                off = 0
                for i, e in zip(active, edges):
                    ch = e.bn.weight.shape[0]
                    yi = y[:, off:off + ch]
                    off += ch
                    if level == i - j - 1:
                        acc[i] = acc[i] + yi       # ReLU after the sum
                    else:
                        cur[i] = F.relu(yi)
        return [F.relu(a) for a in acc]


class PoseHighResolutionNet(nn.Module):
    """The full backbone + final heatmap conv (reference `get_pose_net`)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        extra = cfg.MODEL.EXTRA
        dtype = compute_dtype(cfg)
        self.stem1 = ConvBN(3, 64, 3, 2, dtype=dtype,
                            s2d=cfg.MODEL.S2D_STEM)
        self.stem2 = ConvBN(64, 64, 3, 2, dtype=dtype)
        cin = 64
        for b in range(4):
            setattr(self, f"layer1_{b}", Bottleneck(cin, 64, dtype=dtype))
            cin = 256
        prev = [256]
        self._stages = []
        for t, (name, scfg) in enumerate(
                (("stage2", extra.STAGE2), ("stage3", extra.STAGE3),
                 ("stage4", extra.STAGE4)), start=1):
            chans = [c * BLOCKS[scfg.BLOCK].expansion
                     for c in scfg.NUM_CHANNELS]
            self._add_transition(prev, chans, f"transition{t}", dtype)
            self._add_stage(scfg, chans, name, dtype,
                            multi_scale_output=name != "stage4")
            self._stages.append((f"transition{t}", prev, chans, name, scfg))
            prev = chans
        self.feature_channels = prev[0]
        k = extra.FINAL_CONV_KERNEL
        self.final_layer = nn.Conv2d(prev[0], cfg.MODEL.NUM_JOINTS, k, 1,
                                     1 if k == 3 else 0, bias=True)

    def _add_transition(self, prev, new, name, dtype):
        for i, ch in enumerate(new):
            if i < len(prev):
                if prev[i] != ch:
                    setattr(self, f"{name}_{i}",
                            ConvBN(prev[i], ch, 3, 1, dtype=dtype))
            else:
                # new (coarser) branch from the last existing one; only the
                # chain's final conv maps to the target channel count
                steps = i + 1 - len(prev)
                for k in range(steps):
                    out_ch = ch if k == steps - 1 else prev[-1]
                    setattr(self, f"{name}_{i}_down{k}",
                            ConvBN(prev[-1], out_ch, 3, 2, dtype=dtype))

    def _add_stage(self, scfg: StageConfig, chans, name, dtype,
                   multi_scale_output):
        for m in range(scfg.NUM_MODULES):
            mso = multi_scale_output or m < scfg.NUM_MODULES - 1
            setattr(self, f"{name}_module{m}", HighResolutionModule(
                scfg.NUM_BRANCHES, scfg.BLOCK, scfg.NUM_BLOCKS, chans,
                scfg.NUM_CHANNELS, multi_scale_output=mso, dtype=dtype,
                merged_fuse=self.cfg.MODEL.FUSE_MERGED))

    def _transition(self, name, prev, new, xs):
        outs = []
        for i, ch in enumerate(new):
            if i < len(prev):
                outs.append(getattr(self, f"{name}_{i}")(xs[i])
                            if prev[i] != ch else xs[i])
            else:
                y = xs[-1]
                for k in range(i + 1 - len(prev)):
                    y = getattr(self, f"{name}_{i}_down{k}")(y)
                outs.append(y)
        return outs

    def forward(self, x, return_features: bool = False):
        """x: (N, 3, H, W) normalized images. Returns (N, K, H/4, W/4) fp32
        heatmaps (and the fp32 highest-resolution features)."""
        x = self.stem2(self.stem1(x))
        for b in range(4):
            x = getattr(self, f"layer1_{b}")(x)
        xs = [x]
        rematerialize = (self.cfg.TRAIN.REMAT and self.training
                         and torch.is_grad_enabled())
        for tname, prev, chans, sname, scfg in self._stages:
            xs = self._transition(tname, prev, chans, xs)
            for m in range(scfg.NUM_MODULES):
                module = getattr(self, f"{sname}_module{m}")
                xs = remat(module, xs) if rematerialize else module(xs)
        feats = at_least_f32(xs[0])
        heatmaps = self.final_layer(feats)
        if return_features:
            return heatmaps, feats
        return heatmaps
