"""Typed config tree with the reference yacs schema's key names and defaults.

The same dataclass tree as the JAX package's ``config/defaults.py`` (this
package keeps its own copy and imports nothing from there), so the
experiment YAMLs under ``experiments/`` load unchanged: ``load_config``
merges defaults, an experiment YAML and ``KEY VALUE`` overrides.

Topology is data: MODEL.EXTRA carries the STAGE2/3/4 dicts that fully
determine the HRNet variant (W32/W48 are pure config). MODEL.VIT, the
ViT backbone of ``pose_vit``, is the port's own: the JAX package has no
such model or section.

Keys that select an execution strategy compute the same function as their
default. MODEL.S2D_STEM, MODEL.FUSE_MERGED and TRAIN.REMAT are read
(``models/hrnet.py``); TEST.PALLAS_DECODE and MESH_DATA_AXIS are kept so
the YAMLs load. TEST.FOLD_BN is read: eval folds BatchNorm into the
convs (``models/fold_bn.py``), as the JAX package does. DARK decode on a CUDA tensor always runs
the hand-written kernel (``ops/cuda/dark_decode.py``), whatever
TEST.PALLAS_DECODE says. TRAIN.WARP is read
(``ops/warp.py::resolve_train_warp``): "auto", "pallas" and "shear" run
the shear warp, on a CUDA tensor its hand-written kernel
(``ops/cuda/shear_warp.py``); "gather" runs the exact gather. TEST.WARP is
read (``ops/warp.py::crop_and_normalize``): "auto" and "separable" run the
separable matmul crop, "shear" and "pallas" the shear warp (its kernel on
a CUDA tensor), "gather" the exact gather.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass
class StageConfig:
    NUM_MODULES: int = 1
    NUM_BRANCHES: int = 2
    NUM_BLOCKS: Tuple[int, ...] = (4, 4)
    NUM_CHANNELS: Tuple[int, ...] = (32, 64)
    BLOCK: str = "BASIC"
    FUSE_METHOD: str = "SUM"


def _w32_extra():
    return ModelExtra(
        STAGE2=StageConfig(1, 2, (4, 4), (32, 64)),
        STAGE3=StageConfig(4, 3, (4, 4, 4), (32, 64, 128)),
        STAGE4=StageConfig(3, 4, (4, 4, 4, 4), (32, 64, 128, 256)),
    )


@dataclass
class ModelExtra:
    PRETRAINED_LAYERS: Tuple[str, ...] = ("*",)
    FINAL_CONV_KERNEL: int = 1
    STAGE2: StageConfig = field(default_factory=StageConfig)
    STAGE3: StageConfig = field(
        default_factory=lambda: StageConfig(4, 3, (4, 4, 4), (32, 64, 128)))
    STAGE4: StageConfig = field(
        default_factory=lambda: StageConfig(3, 4, (4, 4, 4, 4),
                                            (32, 64, 128, 256)))
    # pose_resnet (SimpleBaseline) keys; each model family reads its own
    NUM_LAYERS: int = 50
    NUM_DECONV_LAYERS: int = 3
    NUM_DECONV_FILTERS: Tuple[int, ...] = (256, 256, 256)
    NUM_DECONV_KERNELS: Tuple[int, ...] = (4, 4, 4)
    DECONV_WITH_BIAS: bool = False


@dataclass
class RSGConfig:
    """Relation/skeleton-graph head knobs."""
    ENABLED: bool = False
    NODE_CHANNELS: int = 64          # per-keypoint node embedding width
    GCN_LAYERS: int = 2              # skeleton-graph message-passing rounds
    RELATION_CHANNELS: int = 64      # instance-relation (global) embedding
    REFINE_BLOCKS: int = 1           # conv blocks fusing node context back


@dataclass
class VitConfig:
    """The plain ViT backbone of ``pose_vit`` (ViTPose, arXiv 2204.12484):
    a patch-embedding conv (PATCH_SIZE, stride PATCH_SIZE, PATCH_PADDING),
    DEPTH pre-LN blocks of NUM_HEADS-head attention and an MLP of
    MLP_RATIO x EMBED_DIM, LayerNorm eps LN_EPS. Defaults: ViTPose-B."""
    EMBED_DIM: int = 768
    DEPTH: int = 12
    NUM_HEADS: int = 12
    MLP_RATIO: int = 4
    PATCH_SIZE: int = 16
    PATCH_PADDING: int = 2
    QKV_BIAS: bool = True
    LN_EPS: float = 1e-6


def check_vit(vit: VitConfig):
    """Raise ``ValueError`` on a MODEL.VIT section no ViT can be built
    from."""
    for key in ("EMBED_DIM", "DEPTH", "NUM_HEADS", "MLP_RATIO",
                "PATCH_SIZE"):
        v = getattr(vit, key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"MODEL.VIT.{key}={v!r}: a positive integer")
    if not isinstance(vit.PATCH_PADDING, int) or vit.PATCH_PADDING < 0:
        raise ValueError(f"MODEL.VIT.PATCH_PADDING={vit.PATCH_PADDING!r}: "
                         f"a non-negative integer")
    if vit.EMBED_DIM % vit.NUM_HEADS:
        raise ValueError(f"MODEL.VIT.EMBED_DIM={vit.EMBED_DIM} is not a "
                         f"multiple of NUM_HEADS={vit.NUM_HEADS}")
    if not isinstance(vit.QKV_BIAS, bool):
        raise ValueError(f"MODEL.VIT.QKV_BIAS={vit.QKV_BIAS!r}: a bool")
    if not isinstance(vit.LN_EPS, (int, float)) or not 0 < vit.LN_EPS < 1:
        raise ValueError(f"MODEL.VIT.LN_EPS={vit.LN_EPS!r}: in (0, 1)")


@dataclass
class ModelConfig:
    NAME: str = "pose_hrnet"
    INIT_WEIGHTS: bool = True
    PRETRAINED: str = ""
    NUM_JOINTS: int = 17
    TAG_PER_JOINT: bool = True
    TARGET_TYPE: str = "gaussian"
    IMAGE_SIZE: Tuple[int, int] = (192, 256)     # (w, h)
    HEATMAP_SIZE: Tuple[int, int] = (48, 64)     # (w, h)
    SIGMA: int = 2
    S2D_STEM: bool = False           # stem conv as space-to-depth
    FUSE_MERGED: bool = False        # exchange fusion as merged convs
    EXTRA: ModelExtra = field(default_factory=_w32_extra)
    RSG: RSGConfig = field(default_factory=RSGConfig)
    VIT: VitConfig = field(default_factory=VitConfig)     # pose_vit


@dataclass
class LossConfig:
    USE_OHKM: bool = False
    TOPK: int = 8
    USE_TARGET_WEIGHT: bool = True
    USE_DIFFERENT_JOINTS_WEIGHT: bool = False


@dataclass
class DatasetConfig:
    ROOT: str = ""
    DATASET: str = "coco"
    TRAIN_SET: str = "train2017"
    TEST_SET: str = "val2017"
    DATA_FORMAT: str = "jpg"
    HYBRID_JOINTS_TYPE: str = ""
    SELECT_DATA: bool = False
    FLIP: bool = True
    SCALE_FACTOR: float = 0.35
    ROT_FACTOR: float = 45.0
    PROB_HALF_BODY: float = 0.3
    NUM_JOINTS_HALF_BODY: int = 8
    COLOR_RGB: bool = True


@dataclass
class TrainConfig:
    LR_FACTOR: float = 0.1
    LR_STEP: Tuple[int, ...] = (170, 200)
    LR: float = 0.001
    OPTIMIZER: str = "adam"
    MOMENTUM: float = 0.9
    WD: float = 0.0001
    NESTEROV: bool = False
    GAMMA1: float = 0.99
    GAMMA2: float = 0.0
    BEGIN_EPOCH: int = 0
    END_EPOCH: int = 210
    RESUME: bool = False
    AUTO_RESUME: bool = True
    CHECKPOINT: str = ""
    BATCH_SIZE_PER_GPU: int = 32
    SHUFFLE: bool = True
    REMAT: bool = False              # recompute HRNet modules in backward
    PREEMPT_CHECKPOINT: bool = True
    LOADER: str = "threads"
    WARP: str = "auto"
    ASYNC_CHECKPOINT: bool = False


@dataclass
class TestConfig:
    BATCH_SIZE_PER_GPU: int = 32
    COCO_BBOX_FILE: str = ""
    BBOX_THRE: float = 1.0
    IMAGE_THRE: float = 0.0
    IN_VIS_THRE: float = 0.2
    MODEL_FILE: str = ""
    NMS_THRE: float = 1.0
    OKS_THRE: float = 0.9
    SOFT_NMS: bool = False
    FLIP_TEST: bool = True
    POST_PROCESS: bool = True
    SHIFT_HEATMAP: bool = True
    USE_GT_BBOX: bool = True
    BLUR_KERNEL: int = 11
    DECODE: str = "default"          # "default" (quarter-offset) | "dark"
    PALLAS_DECODE: bool = False      # JAX kernel switch; see module docstring
    DEVICE_NMS: bool = True
    LOADER: str = "threads"
    FOLD_BN: bool = False            # models/fold_bn.py at eval
    WARP: str = "separable"


@dataclass
class CudnnConfig:
    """The reference's cuDNN switches, read by every CLI through
    ``core/inference.py::configure_cudnn``: BENCHMARK picks conv algorithms
    by timing them, DETERMINISTIC takes deterministic algorithms only
    (with cuBLAS's fixed workspace and
    ``torch.use_deterministic_algorithms``), ENABLED turns cuDNN off when
    False. Bitwise repeatable runs need DETERMINISTIC on and BENCHMARK
    off. TF32 stays off whatever they say. The library functions leave
    the process's cuDNN state as the caller set it."""
    BENCHMARK: bool = True
    DETERMINISTIC: bool = False
    ENABLED: bool = True


@dataclass
class DebugConfig:
    DEBUG: bool = False
    SAVE_BATCH_IMAGES_GT: bool = False
    SAVE_BATCH_IMAGES_PRED: bool = False
    SAVE_HEATMAPS_GT: bool = False
    SAVE_HEATMAPS_PRED: bool = False


@dataclass
class Config:
    OUTPUT_DIR: str = "output"
    LOG_DIR: str = "log"
    DATA_DIR: str = ""
    GPUS: Tuple[int, ...] = (0,)
    WORKERS: int = 4
    PRINT_FREQ: int = 100
    AUTO_RESUME: bool = True
    PIN_MEMORY: bool = True
    RANK: int = 0
    CUDNN: CudnnConfig = field(default_factory=CudnnConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    LOSS: LossConfig = field(default_factory=LossConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    DEBUG: DebugConfig = field(default_factory=DebugConfig)
    DTYPE: str = "bfloat16"          # compute dtype for the conv stack
    MESH_DATA_AXIS: str = "data"

    @property
    def aspect_ratio(self) -> float:
        return self.MODEL.IMAGE_SIZE[0] / self.MODEL.IMAGE_SIZE[1]


# Keys the schema accepts (so reference YAMLs load) but that nothing reads.
# Setting one to a non-default value warns instead of silently changing
# nothing.
_ACCEPTED_UNREAD_KEYS = {
    "GPUS": "the device is the entry point's `device` argument",
    "DATA_DIR": "the reference defines but never reads it either; dataset "
                "location comes from DATASET.ROOT",
    "TEST.BBOX_THRE": "detector boxes are filtered by TEST.IMAGE_THRE only",
    "TEST.NMS_THRE": "pose dedup uses OKS-NMS (TEST.OKS_THRE); there is no "
                     "bbox-IoU NMS stage in the top-down eval path",
    "PIN_MEMORY": "the inference function pins its host inputs itself",
    "RANK": "no torch.distributed rank is read",
    "MODEL.TAG_PER_JOINT": "bottom-up (associative-embedding) leftover; the "
                           "reference top-down path never reads it either",
    "DATASET.DATA_FORMAT": "zip-archive inputs are auto-detected from "
                           "'archive.zip@/member' paths instead",
    "DATASET.HYBRID_JOINTS_TYPE": "reference dataset option not used by the "
                                  "COCO/CrowdPose configs",
    "TRAIN.GAMMA1": "the reference defines but never reads it",
    "TRAIN.GAMMA2": "the reference defines but never reads it",
}

# Keys with exactly one implemented value (as in the reference): any other
# value fails loudly instead of silently doing nothing.
_SINGLE_VALUE_KEYS = {
    "MODEL.TARGET_TYPE": "gaussian",
    "MODEL.EXTRA.STAGE2.FUSE_METHOD": "SUM",
    "MODEL.EXTRA.STAGE3.FUSE_METHOD": "SUM",
    "MODEL.EXTRA.STAGE4.FUSE_METHOD": "SUM",
}


def _merge(obj: Any, d: dict, path=""):
    """Recursively merge a plain dict (from YAML) into a dataclass tree."""
    for k, v in d.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key {path}{k}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge(cur, v, path + k + ".")
        else:
            if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                v = tuple(v)
            elif isinstance(cur, tuple) and isinstance(v, str):
                # reference YAMLs write tuples as '(0,1,2,3)' strings (yacs)
                v = tuple(int(t) if t.strip().isdigit() else t.strip()
                          for t in v.strip("()").split(",") if t.strip())
            full = path + k
            if full in _ACCEPTED_UNREAD_KEYS and v != cur:
                import warnings
                warnings.warn(
                    f"config key {full} is accepted for reference-YAML "
                    f"compatibility but read nowhere — setting it to {v!r} "
                    f"changes nothing ({_ACCEPTED_UNREAD_KEYS[full]})",
                    stacklevel=2)
            if full in _SINGLE_VALUE_KEYS and v != _SINGLE_VALUE_KEYS[full]:
                raise ValueError(
                    f"config key {full}={v!r}: only "
                    f"{_SINGLE_VALUE_KEYS[full]!r} is implemented (same as "
                    f"the reference); refusing to silently ignore it")
            setattr(obj, k, v)
    return obj


def update_config(cfg: Config, yaml_dict: dict) -> Config:
    """Merge a reference-style experiment YAML dict into ``cfg`` in place."""
    return _merge(cfg, yaml_dict)


def opts_to_dict(opts) -> dict:
    """argparse REMAINDER ``KEY VALUE`` pairs -> nested override dict."""
    import ast
    if len(opts) % 2:
        raise ValueError(f"override opts must be KEY VALUE pairs; got an "
                         f"odd-length list ending in {opts[-1]!r}")
    out: dict = {}
    for k, v in zip(opts[0::2], opts[1::2]):
        node = out
        parts = k.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        node[parts[-1]] = v
    return out


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[dict] = None) -> Config:
    """Build a Config from defaults + experiment YAML + override dict."""
    cfg = Config()
    if yaml_path:
        import yaml
        with open(yaml_path) as f:
            update_config(cfg, yaml.safe_load(f))
    if overrides:
        update_config(cfg, overrides)
    check_vit(cfg.MODEL.VIT)
    return cfg


# The JAX package's presets (reference experiments/*.yaml values); the
# infer CLI's defaults and the CPU tests build from them.
def w32_256x192() -> Config:
    return Config()


def w48_384x288() -> Config:
    cfg = Config()
    cfg.MODEL.IMAGE_SIZE = (288, 384)
    cfg.MODEL.HEATMAP_SIZE = (72, 96)
    cfg.MODEL.SIGMA = 3
    cfg.MODEL.EXTRA = ModelExtra(
        STAGE2=StageConfig(1, 2, (4, 4), (48, 96)),
        STAGE3=StageConfig(4, 3, (4, 4, 4), (48, 96, 192)),
        STAGE4=StageConfig(3, 4, (4, 4, 4, 4), (48, 96, 192, 384)),
    )
    return cfg


def rsgnet_w32_256x192() -> Config:
    cfg = Config()
    cfg.MODEL.NAME = "pose_rsgnet"
    cfg.MODEL.RSG.ENABLED = True
    return cfg


def tiny_rsgnet() -> Config:
    """Miniature RSGNet topology for fast CPU tests: the flagship's module
    graph (all stages, transitions, graph head) with shrunk channels and
    blocks and a 64x96 input, in float32."""
    cfg = Config()
    cfg.MODEL.NAME = "pose_rsgnet"
    cfg.MODEL.RSG.ENABLED = True
    cfg.MODEL.RSG.NODE_CHANNELS = 8
    cfg.MODEL.RSG.RELATION_CHANNELS = 8
    cfg.MODEL.IMAGE_SIZE = (64, 96)     # divisible by 32 (1/32 branch)
    cfg.MODEL.HEATMAP_SIZE = (16, 24)
    cfg.MODEL.EXTRA = ModelExtra(
        STAGE2=StageConfig(1, 2, (1, 1), (8, 16)),
        STAGE3=StageConfig(1, 3, (1, 1, 1), (8, 16, 32)),
        STAGE4=StageConfig(1, 4, (1, 1, 1, 1), (8, 16, 32, 64)),
    )
    cfg.DTYPE = "float32"
    return cfg


def res50_256x192() -> Config:
    """SimpleBaseline ResNet-50 @ 256x192 (the reference's
    experiments/coco/resnet/res50_256x192_d256x3_adam_lr1e-3.yaml)."""
    cfg = Config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.EXTRA.NUM_LAYERS = 50
    return cfg


def tiny_resnet() -> Config:
    """Miniature pose_resnet for fast CPU tests: ResNet-18's stages with
    the deconv head shrunk to 16 filters, a 64x96 input, in float32."""
    cfg = Config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = (16, 16, 16)
    cfg.MODEL.IMAGE_SIZE = (64, 96)
    cfg.MODEL.HEATMAP_SIZE = (16, 24)
    cfg.DTYPE = "float32"
    return cfg


def tiny_vit() -> Config:
    """Miniature pose_vit for fast CPU tests: the ViTPose module graph
    (patch embedding, position table, pre-LN blocks, last norm, two
    deconvs, 1x1 conv) at width 64, depth 2, 4 heads, 16-filter deconvs
    and 64x48 crops (a 4x3 token grid), in float32."""
    cfg = Config()
    cfg.MODEL.NAME = "pose_vit"
    cfg.MODEL.IMAGE_SIZE = (48, 64)
    cfg.MODEL.HEATMAP_SIZE = (12, 16)
    cfg.MODEL.VIT = VitConfig(EMBED_DIM=64, DEPTH=2, NUM_HEADS=4)
    cfg.MODEL.EXTRA.NUM_DECONV_LAYERS = 2
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = (16, 16)
    cfg.MODEL.EXTRA.NUM_DECONV_KERNELS = (4, 4)
    cfg.DTYPE = "float32"
    return cfg


def crowdpose_rsgnet_w32() -> Config:
    cfg = rsgnet_w32_256x192()
    cfg.MODEL.NUM_JOINTS = 14
    cfg.DATASET.DATASET = "crowdpose"
    cfg.DATASET.NUM_JOINTS_HALF_BODY = 8
    return cfg
