"""ViTPose on the port (``MODEL.NAME: pose_vit``; ``models/vit.py``,
``models/pose_vit.py``), against the benchmark's plain float32 reference
(``portbench/reference/vitpose.py``, which imports nothing of the port) on
seeded weights, at a tiny size on the CPU (``tiny_vit``: width 64, depth 2,
4 heads, 64x48 crops): heatmaps in float32 and in bfloat16; keypoints
through ``make_inference_fn`` and one request through the serving engine;
the published ViTPose-H YAML and its parameter count; the stages the
inference pipeline runs for a model that names its parts and for one
that does not; the key map of released checkpoints; the seeded init;
BatchNorm folding and the export artifact; the clear errors.

On a card (``gpu``; each test takes the ``vith`` fixture, which skips
where ``torch.cuda.is_available()`` is False), ViTPose-H at the published
widths: at 64 boxes a replay gives the eager call's bits, and a traced
replay records ``vit.embed``, ``vit.blocks`` and ``vit.head`` with device
time. No JAX is imported, so the file runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_vitpose.py -q
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import compare
from portbench.drivers.infer_vitpose import topology
from portbench.reference import pipeline as ref_pipe
from portbench.reference import vitpose as ref_vit
from rsgnet_tpu_torch.config.defaults import (VitConfig, load_config,
                                              tiny_rsgnet, tiny_vit)
from rsgnet_tpu_torch.core.inference import (configure_cudnn,
                                             heatmaps_with_flip_test,
                                             make_e2e_fn, make_inference_fn)
from rsgnet_tpu_torch.models import PoseViT, get_pose_net, init_weights
from rsgnet_tpu_torch.models.fold_bn import count_convbn, fold_bn_variables
from rsgnet_tpu_torch.serving import ServingEngine
from rsgnet_tpu_torch.utils import profiler
from rsgnet_tpu_torch.utils.checkpoint import load_weights
from rsgnet_tpu_torch.utils.torch_convert import (backbone_prefix,
                                                  convert_state_dict,
                                                  key_map)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VITH_YAML = os.path.join(REPO, "rsgnet_tpu_torch", "experiments", "coco",
                         "vitpose", "vitpose_h_256x192.yaml")
VIT_STAGES = ["vit.embed", "vit.blocks", "vit.head"]


def program(cfg, ref_sd):
    """The port's model holding the reference's weights, strictly."""
    net = get_pose_net(cfg)
    net.load_state_dict(convert_state_dict(cfg, ref_sd), strict=True)
    return net


@pytest.fixture(scope="module")
def tiny():
    """(cfg, reference weights, float32 reference model) at the tiny
    size, with running statistics and biases away from their identity so
    the key map and BatchNorm folding have something to move."""
    cfg = tiny_vit()
    m = topology(cfg)
    sd = ref_vit.make_state_dict(m, 7, "cpu")
    gen = torch.Generator().manual_seed(8)
    for k, v in sd.items():
        if k.endswith(("bias", "running_mean")) or "norm" in k:
            sd[k] = v + 0.1 * torch.randn(v.shape, generator=gen)
        elif k.endswith("running_var"):
            sd[k] = v + 0.5 * torch.rand(v.shape, generator=gen)
    return cfg, sd, ref_vit.reference_model(m, sd, "cpu")


def _crops(n, cfg, seed):
    rng = np.random.RandomState(seed)
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    return (rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
            rng.uniform(60, 220, (n, 2)).astype(np.float32),
            rng.uniform(0.4, 1.4, (n, 2)).astype(np.float32))


def _normalized(images):
    x = torch.as_tensor(images).permute(0, 3, 1, 2).float()
    return ref_pipe.normalize(x)


# -- the model against the reference -----------------------------------------

def test_float32_heatmaps_match_the_reference(tiny):
    cfg, sd, ref = tiny
    x = _normalized(_crops(3, cfg, 0)[0])
    with torch.no_grad():
        got = program(cfg, sd)(x)
        want = ref(x)[0]
    assert got.shape == (3, 17, 16, 12)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_bfloat16_heatmaps_stay_near_the_reference(tiny):
    """The bf16 program against the float32 reference and against the
    reference's own bf16 witness. bf16 keeps 8 bits of mantissa (relative
    rounding 2^-9): the matmuls' inputs and outputs are rounded at each
    of the 2 blocks' 4 linears, 2 attention matmuls and the 4 convs, so
    the heatmaps (peaks ~1) move by a few 1e-3; 0.03 is ten times what
    they move here. The witness rounds at the same places, so it stays
    nearer to the program than the float32 reference does."""
    cfg, sd, ref = tiny
    cfg = dataclasses.replace(cfg, DTYPE="bfloat16")
    x = _normalized(_crops(3, cfg, 1)[0])
    with torch.no_grad():
        got = program(cfg, sd)(x)
        want = ref(x)[0]
        witness = ref_vit.reference_model(topology(cfg), sd, "cpu",
                                          quant="bf16")(x)[0]
    assert got.dtype == torch.float32
    gap = (got - want).abs().max().item()
    assert 0 < gap < 0.03
    assert (got - witness).abs().max().item() < gap


def test_keypoints_through_the_inference_fn_and_the_engine(tiny):
    """Image-space keypoints of ``make_inference_fn`` (flip-test, DARK)
    and of one request through ``ServingEngine`` against the reference
    pipeline on the same crops, judged as the benchmark judges them
    (``portbench/compare.py``): float32 both, so the peaks agree to
    round-off and every box keeps its argmaxes. Single keypoints are not
    compared: on the flat heatmaps of random weights DARK's Newton step
    meets near-singular Hessians, where round-off moves the step by
    hundreds of pixels."""
    cfg, sd, ref = tiny
    cfg = dataclasses.replace(cfg, TEST=dataclasses.replace(
        cfg.TEST, DECODE="dark"))
    images, centers, scales = _crops(5, cfg, 2)
    fn = make_inference_fn(cfg, program(cfg, sd), normalize_input=True,
                           device="cpu")
    pipe = {"num_joints": 17, "flip_test": True, "shift_heatmap": True,
            "blur_kernel": cfg.TEST.BLUR_KERNEL,
            "heatmap_size": list(cfg.MODEL.HEATMAP_SIZE)}
    c64, s64 = (torch.as_tensor(a, dtype=torch.float64)
                for a in (centers, scales))
    with torch.no_grad():
        rp, rm = ref_pipe.predict(ref, _normalized(images), c64, s64, pipe)

    def judged(p, m, rows):
        np.testing.assert_allclose(m.numpy(), rm[rows].numpy(), rtol=0,
                                   atol=1e-5)
        got = compare.pose_numbers(p.numpy(), m.numpy(), rp[rows].numpy(),
                                   rm[rows].numpy(), scales[rows],
                                   cfg.MODEL.HEATMAP_SIZE[0])
        assert got["kpt_gap_q25_px"] < 1e-3 and got["boxes_off_pct"] == 0

    judged(*fn(images, centers, scales), slice(None))
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    engine = ServingEngine(fn, buckets=(1, 2, 4), image_shape=(h, w, 3),
                           image_dtype=np.uint8)
    try:
        ep, em = engine.run(images[1:4], centers[1:4], scales[1:4])
    finally:
        engine.close()
    judged(ep, em, slice(1, 4))


# -- the published model -----------------------------------------------------

def test_the_published_yaml_is_vitpose_h():
    cfg = load_config(VITH_YAML)
    assert cfg.MODEL.NAME == "pose_vit" and cfg.DTYPE == "bfloat16"
    assert cfg.MODEL.VIT == VitConfig(EMBED_DIM=1280, DEPTH=32,
                                      NUM_HEADS=16)
    assert tuple(cfg.MODEL.IMAGE_SIZE) == (192, 256)
    assert tuple(cfg.MODEL.HEATMAP_SIZE) == (48, 64)
    assert cfg.MODEL.SIGMA == 2 and cfg.TEST.FLIP_TEST
    assert cfg.TEST.DECODE == "dark" and cfg.TEST.BLUR_KERNEL == 11
    with torch.device("meta"):
        net = get_pose_net(cfg)
        ref = ref_vit.ViTPose(topology(cfg))
    count = sum(p.numel() for p in net.parameters())
    assert count == sum(p.numel() for p in ref.parameters()) == 637208849
    assert net.backbone.grid == (16, 12)
    assert len(key_map(cfg)) == len(net.state_dict())
    # the benchmark's configuration holds this YAML as the program loads it
    with open(os.path.join(REPO, "portbench", "configs",
                           "vitpose_h_256x192.json")) as f:
        assert load_config(None, json.load(f)["program"]) == cfg


@pytest.mark.parametrize("change,message", [
    ({"NUM_HEADS": 5}, "multiple of NUM_HEADS"),
    ({"DEPTH": 0}, "DEPTH"),
    ({"LN_EPS": "1e-6"}, "LN_EPS"),
])
def test_a_vit_section_that_builds_nothing_raises(change, message):
    with pytest.raises(ValueError, match=message):
        load_config(overrides={"MODEL": {"NAME": "pose_vit",
                                         "VIT": change}})


def test_heatmaps_that_the_grid_cannot_give_raise():
    cfg = tiny_vit()
    cfg.MODEL.HEATMAP_SIZE = (16, 16)
    with pytest.raises(ValueError, match="MODEL.HEATMAP_SIZE"):
        get_pose_net(cfg)


# -- stages of the inference pipeline ----------------------------------------

def _stage_names(model, cfg):
    seen = []

    def stage(name):
        seen.append(name)
        return profiler.no_stage(name)

    x = torch.zeros(1, 3, cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0])
    perm = torch.arange(cfg.MODEL.NUM_JOINTS)
    with torch.no_grad():
        heatmaps_with_flip_test(model, x, cfg, perm, stage)
    return seen


def test_a_model_that_names_its_parts_runs_a_stage_a_part(tiny):
    cfg, sd, _ = tiny
    names = _stage_names(program(cfg, sd), cfg)
    assert names == [*VIT_STAGES, "pipeline.flip", *VIT_STAGES,
                     "pipeline.flip"]


def test_an_hrnet_model_still_runs_one_forward_stage():
    cfg = tiny_rsgnet()
    model = init_weights(get_pose_net(cfg), seed=1)
    assert not hasattr(model, "parts")
    assert _stage_names(model, cfg) == [
        "pipeline.forward", "pipeline.flip", "pipeline.forward",
        "pipeline.flip"]


# -- weights: the key map, the init, BatchNorm folding, the artifact ---------

def test_a_released_checkpoint_s_names_load_strictly(tiny, tmp_path):
    """A synthetic state dict under the public checkpoint's names (what
    the reference holds) loads strictly, by ``convert_state_dict`` and by
    ``load_weights`` from a ``.pth`` with DataParallel's prefix."""
    cfg, sd, ref = tiny
    names = set(sd) - {k for k in sd if k.endswith("num_batches_tracked")}
    assert names == {t for t, _ in key_map(cfg)}
    assert {k for k in names if "deconv_layers" in k} == {
        f"keypoint_head.deconv_layers.{i}.{t}" for i in (0, 3)
        for t in ("weight",)} | {
        f"keypoint_head.deconv_layers.{i}.{t}" for i in (1, 4)
        for t in ("weight", "bias", "running_mean", "running_var")}
    net = get_pose_net(cfg)
    assert backbone_prefix(net) == ""
    path = tmp_path / "vitpose.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               path)
    loaded = load_weights(cfg, net, str(path))
    for k, v in convert_state_dict(cfg, sd).items():
        assert torch.equal(loaded.state_dict()[k], v)
    with pytest.raises(KeyError, match="attn.proj.bias"):
        convert_state_dict(cfg, {k: v for k, v in sd.items()
                                 if k != "backbone.blocks.1.attn.proj.bias"})


def test_a_msgpack_file_raises_for_pose_vit(tmp_path):
    path = tmp_path / "model.msgpack"
    path.write_bytes(b"\x82")                 # a msgpack map's first byte
    cfg = tiny_vit()
    with pytest.raises(ValueError, match="no pose_vit model"):
        load_weights(cfg, get_pose_net(cfg), str(path))


def test_the_seeded_init_covers_layer_norm_and_the_position_table():
    cfg = tiny_vit()
    a = init_weights(get_pose_net(cfg), seed=3)
    b = init_weights(get_pose_net(cfg), seed=3)
    for mod in a.modules():
        if isinstance(mod, torch.nn.LayerNorm):
            assert torch.equal(mod.weight, torch.ones_like(mod.weight))
            assert torch.equal(mod.bias, torch.zeros_like(mod.bias))
    pos = a.backbone.pos_embed
    assert torch.equal(pos, b.backbone.pos_embed)
    assert 0.015 < pos.std().item() < 0.025 and pos.abs().max() < 0.1


def test_bn_folding_and_the_export_artifact(tiny, tmp_path):
    """TEST.FOLD_BN folds both deconvs' BatchNorms (the heatmaps move by
    fp32 round-off alone), and the artifact of the folded model gives the
    eager function's keypoints."""
    from rsgnet_tpu_torch.utils.export import (export_inference,
                                               read_exported, save_exported)
    cfg, sd, _ = tiny
    net = program(cfg, sd)
    assert count_convbn(net) == 2
    folded = program(cfg, sd)
    folded.load_state_dict(fold_bn_variables(net))
    x = _normalized(_crops(2, cfg, 3)[0])
    with torch.no_grad():
        torch.testing.assert_close(folded(x), net(x), rtol=0, atol=1e-5)
    cfg = dataclasses.replace(cfg, TEST=dataclasses.replace(
        cfg.TEST, FOLD_BN=True))
    path = tmp_path / "vit.pt2"
    save_exported(path, export_inference(cfg, net, normalize_input=True))
    images, centers, scales = _crops(3, cfg, 4)
    p, m = read_exported(path)(images, centers, scales)
    wp, wm = make_inference_fn(cfg, folded, normalize_input=True,
                               device="cpu")(images, centers, scales)
    np.testing.assert_array_equal(p.numpy(), wp.numpy())
    np.testing.assert_array_equal(m.numpy(), wm.numpy())


def test_the_reference_loads_nothing_of_the_port_or_of_jax():
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys, portbench.reference.vitpose\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": REPO, "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr[-2000:]
    mods = set(p.stdout.split())
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "rsgnet_tpu",
                       "rsgnet_tpu_torch"}


# -- on the card -------------------------------------------------------------

@pytest.fixture(scope="module")
def vith():
    """ViTPose-H of the published YAML on the card, torch's default init
    (bitwise comparisons need no particular weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = load_config(VITH_YAML)
    configure_cudnn(cfg)
    torch.manual_seed(0)
    with torch.device("cuda"):
        return cfg, get_pose_net(cfg)


def _canvases(n, seed, side=640):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, side, side, 3)).astype(np.uint8),
            rng.uniform(200, 440, (n, 2)).astype(np.float32),
            np.stack([rng.uniform(0.6, 1.1, n), rng.uniform(0.8, 1.5, n)],
                     -1).astype(np.float32))


@pytest.mark.gpu
def test_a_vith_replay_gives_the_eager_call_s_bits(vith):
    cfg, model = vith
    assert isinstance(model, PoseViT)
    fn = make_e2e_fn(cfg, model, (640, 640))
    a, b = _canvases(64, 1), _canvases(64, 2)
    eager_a = fn(*a)
    replay_a = fn(*a)                             # captured, replayed
    replay_b = fn(*b)
    eager_b = make_e2e_fn(cfg, model, (640, 640))(*b)
    for got, want in ((replay_a, eager_a), (replay_b, eager_b)):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    assert (fn.eager_calls, fn.graph_replays) == (1, 2)


@pytest.mark.gpu
def test_a_traced_vith_replay_records_its_parts_with_device_time(
        vith, monkeypatch):
    rec = profiler.Recorder()
    monkeypatch.setattr(profiler, "RECORDER", rec)
    cfg, model = vith
    fn = make_e2e_fn(cfg, model, (640, 640))
    a = _canvases(64, 3)
    fn(*a)
    fn(*a)
    with profile(activities=[ProfilerActivity.CPU]):
        fn(*a)
    torch.cuda.synchronize()
    got = [s for s in rec.spans() if not s.setup]
    (call,) = [s for s in got if s.name == "pipeline.call"]
    assert call.args == {"graph": True}
    stages = sorted((s for s in got if s.parent == call.span_id),
                    key=lambda s: s.start_ns)
    assert [s.name for s in stages] == [
        "pipeline.crop", *VIT_STAGES, "pipeline.flip", *VIT_STAGES,
        "pipeline.flip", "pipeline.decode"]
    assert all(s.device_ms is not None and s.device_ms > 0 for s in stages)
    blocks = [s.device_ms for s in stages if s.name == "vit.blocks"]
    # the blocks hold ~96% of the forward's FLOPs
    assert min(blocks) > max(s.device_ms for s in stages
                             if s.name in ("vit.embed", "vit.head"))
