"""Default config tree, copied key for key from the JAX package's
``config/defaults.py`` so YAML files and ``--opts`` merge identically in
both packages.

Covers every section/key the reference pipeline actually reads
(ref: utils/defaults.py:8-833), re-expressed as a plain ``CfgNode`` tree.
GPU-era knobs are kept for YAML compatibility (the reference's
``models/configs/Kinetics/*.yaml`` files merge cleanly) but the
distributed section is TPU-native: a device mesh instead of
NUM_GPUS/NCCL (ref: utils/defaults.py:420-445).
"""

from __future__ import annotations

from .cfg_node import CfgNode

_C = CfgNode()

# Batch-norm options (only used if BN models such as S3D are enabled;
# ref: utils/defaults.py:13-33).
_C.BN = CfgNode()
_C.BN.USE_PRECISE_STATS = False
_C.BN.NUM_BATCHES_PRECISE = 200
_C.BN.WEIGHT_DECAY = 0.0
_C.BN.NORM_TYPE = "batchnorm"
_C.BN.NUM_SPLITS = 1
_C.BN.NUM_SYNC_DEVICES = 1

# Training loop (ref: utils/defaults.py:39-75).
_C.TRAIN = CfgNode()
_C.TRAIN.ENABLE = True
_C.TRAIN.DATASET = "kinetics"
_C.TRAIN.FINETUNE = False
_C.TRAIN.BATCH_SIZE = 64
_C.TRAIN.EVAL_PERIOD = 10
_C.TRAIN.CHECKPOINT_PERIOD = 10
_C.TRAIN.AUTO_RESUME = True
_C.TRAIN.CHECKPOINT_FILE_PATH = ""
_C.TRAIN.CHECKPOINT_TYPE = "pytorch"
_C.TRAIN.CHECKPOINT_INFLATE = False
_C.TRAIN.CHECKPOINT_EPOCH_RESET = False
_C.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = ()

# Testing / multi-view ensembles (ref: utils/defaults.py:80-105).
_C.TEST = CfgNode()
_C.TEST.ENABLE = True
_C.TEST.DATASET = "kinetics"
_C.TEST.BATCH_SIZE = 8
_C.TEST.CHECKPOINT_FILE_PATH = ""
_C.TEST.NUM_ENSEMBLE_VIEWS = 10
_C.TEST.NUM_SPATIAL_CROPS = 3
_C.TEST.CHECKPOINT_TYPE = "pytorch"
_C.TEST.SAVE_RESULTS_PATH = ""

# Model selection (ref: utils/defaults.py:203-233, 262-264).
_C.MODEL = CfgNode()
_C.MODEL.ARCH = "vit"
_C.MODEL.MODEL_NAME = "vit_base_patch16_224"
_C.MODEL.NUM_CLASSES = 400
_C.MODEL.LOSS_FUNC = "cross_entropy"
_C.MODEL.SINGLE_PATHWAY_ARCH = ["c2d", "i3d", "slow", "x3d"]
_C.MODEL.MULTI_PATHWAY_ARCH = ["slowfast"]
_C.MODEL.DROPOUT_RATE = 0.5
_C.MODEL.DROPCONNECT_RATE = 0.0
_C.MODEL.FC_INIT_STD = 0.01
_C.MODEL.HEAD_ACT = "softmax"
_C.MODEL.TWO_STREAM = False
_C.MODEL.TWO_TOKEN = False
_C.MODEL.CNN_DISTILL = False

# TimeSformer attention mode (ref: utils/defaults.py:257-259).
_C.TIMESFORMER = CfgNode()
_C.TIMESFORMER.ATTENTION_TYPE = "divided_space_time"
_C.TIMESFORMER.PRETRAINED_MODEL = ""

_C.MIXUP = CfgNode()
_C.MIXUP.ENABLED = False
_C.MIXUP.ALPHA = 0.8
_C.MIXUP.CUTMIX_ALPHA = 1.0
_C.MIXUP.CUTMIX_MINMAX = None
_C.MIXUP.PROB = 1.0
_C.MIXUP.SWITCH_PROB = 0.5
_C.MIXUP.MODE = "batch"

_C.EMA = CfgNode()
_C.EMA.ENABLED = False

# Data pipeline (ref: utils/defaults.py:282-360).
_C.DATA = CfgNode()
_C.DATA.PATH_TO_DATA_DIR = ""
_C.DATA.PATH_LABEL_SEPARATOR = " "
_C.DATA.PATH_PREFIX = ""
_C.DATA.CROP_SIZE = 224
_C.DATA.NUM_FRAMES = 8
_C.DATA.SAMPLING_RATE = 8
_C.DATA.MEAN = [0.45, 0.45, 0.45]
_C.DATA.STD = [0.225, 0.225, 0.225]
_C.DATA.INPUT_CHANNEL_NUM = [3, 3]
_C.DATA.TRAIN_JITTER_SCALES = [256, 320]
_C.DATA.TRAIN_CROP_SIZE = 224
_C.DATA.TEST_CROP_SIZE = 256
_C.DATA.TARGET_FPS = 30
_C.DATA.DECODING_BACKEND = "libav"  # TPU build: native libav shim or ffmpeg pipe
_C.DATA.INV_UNIFORM_SAMPLE = False
_C.DATA.RANDOM_FLIP = True
_C.DATA.MULTI_LABEL = False
_C.DATA.ENSEMBLE_METHOD = "sum"
_C.DATA.REVERSE_INPUT_CHANNEL = False
_C.DATA.USE_FLOW = False
_C.DATA.NO_FLOW_AUG = False
_C.DATA.NO_RGB_AUG = False
_C.DATA.RAND_CONV = False
_C.DATA.NO_SPATIAL = False
_C.DATA.RAND_FR = False
_C.DATA.TEMPORAL_EXTENT = 8
_C.DATA.DEIT_TRANSFORMS = False
_C.DATA.COLOR_JITTER = 0.0
_C.DATA.AUTO_AUGMENT = ""
_C.DATA.RE_PROB = 0.0

# Optimizer (ref: utils/defaults.py:360-413).
_C.SOLVER = CfgNode()
_C.SOLVER.BASE_LR = 0.1
_C.SOLVER.LR_POLICY = "cosine"
_C.SOLVER.COSINE_END_LR = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEP_SIZE = 1
_C.SOLVER.STEPS = []
_C.SOLVER.LRS = []
_C.SOLVER.MAX_EPOCH = 300
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.DAMPENING = 0.0
_C.SOLVER.NESTEROV = True
_C.SOLVER.WEIGHT_DECAY = 1e-4
_C.SOLVER.WARMUP_FACTOR = 0.1
_C.SOLVER.WARMUP_EPOCHS = 0.0
_C.SOLVER.WARMUP_START_LR = 0.01
_C.SOLVER.OPTIMIZING_METHOD = "sgd"
_C.SOLVER.BASE_LR_SCALE_NUM_SHARDS = False

# Misc / distributed. NUM_GPUS is interpreted as "number of devices" so the
# reference YAMLs keep working; the mesh axis names drive pjit sharding.
_C.NUM_GPUS = 1
_C.NUM_SHARDS = 1
_C.SHARD_ID = 0
_C.OUTPUT_DIR = "./tmp"
_C.RNG_SEED = 1
_C.LOG_PERIOD = 10
_C.LOG_MODEL_INFO = False
_C.DIST_BACKEND = "ici"  # TPU: XLA collectives over ICI (ref default: "nccl")
_C.GLOBAL_BATCH_SIZE = 64

_C.MESH = CfgNode()
_C.MESH.DATA_AXIS = "data"
_C.MESH.MODEL_AXIS = "model"
_C.MESH.DATA_PARALLEL = -1  # -1: all devices on the data axis
_C.MESH.MODEL_PARALLEL = 1

# Numerics: reference-compat float32 vs production bfloat16.
_C.PRECISION = CfgNode()
_C.PRECISION.COMPUTE_DTYPE = "float32"
_C.PRECISION.PARAM_DTYPE = "float32"
_C.PRECISION.REFERENCE_COMPAT = True

_C.BENCHMARK = CfgNode()
_C.BENCHMARK.NUM_EPOCHS = 5
_C.BENCHMARK.LOG_PERIOD = 100
_C.BENCHMARK.SHUFFLE = True

_C.DATA_LOADER = CfgNode()
_C.DATA_LOADER.NUM_WORKERS = 8
_C.DATA_LOADER.PIN_MEMORY = True
_C.DATA_LOADER.ENABLE_MULTI_THREAD_DECODE = False

_C.MULTIGRID = CfgNode()
_C.MULTIGRID.EPOCH_FACTOR = 1.5
_C.MULTIGRID.SHORT_CYCLE = False
_C.MULTIGRID.SHORT_CYCLE_FACTORS = [0.5, 0.5 ** 0.5]
_C.MULTIGRID.LONG_CYCLE = False
_C.MULTIGRID.LONG_CYCLE_FACTORS = [
    (0.25, 0.5 ** 0.5),
    (0.5, 0.5 ** 0.5),
    (0.5, 1),
    (1, 1),
]
_C.MULTIGRID.BN_BASE_SIZE = 8
_C.MULTIGRID.EVAL_FREQ = 3
_C.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = 0
_C.MULTIGRID.DEFAULT_B = 0
_C.MULTIGRID.DEFAULT_T = 0
_C.MULTIGRID.DEFAULT_S = 0

_C.TENSORBOARD = CfgNode()
_C.TENSORBOARD.ENABLE = False
_C.TENSORBOARD.LOG_DIR = ""


def _assert_and_infer_cfg(cfg: CfgNode) -> CfgNode:
    """Invariant checks (ref: utils/defaults.py:802-826)."""
    assert cfg.TRAIN.CHECKPOINT_TYPE in ["pytorch", "caffe2", "jax", "orbax"]
    assert cfg.TEST.CHECKPOINT_TYPE in ["pytorch", "caffe2", "jax", "orbax"]
    if cfg.NUM_GPUS:
        assert cfg.TRAIN.BATCH_SIZE % cfg.NUM_GPUS == 0
        assert cfg.TEST.BATCH_SIZE % cfg.NUM_GPUS == 0
    if cfg.SOLVER.BASE_LR_SCALE_NUM_SHARDS:
        cfg.SOLVER.BASE_LR *= cfg.NUM_SHARDS
    assert cfg.SHARD_ID < cfg.NUM_SHARDS
    return cfg


def get_cfg() -> CfgNode:
    """Copy of the default config (ref: utils/defaults.py:829-833)."""
    return _assert_and_infer_cfg(_C.clone())
