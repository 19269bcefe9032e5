"""Config loading for the CLIs (ref: utils/parser.py:65-90).

``load_config`` builds the config tree from defaults + YAML + trailing
``opts`` overrides; ``set_data_path`` points it at a ``--data_path``.
Copied from the JAX package's ``config/parser.py``.
"""

from __future__ import annotations

from .defaults import get_cfg


def load_config(args):
    """Defaults -> YAML -> opts merge (ref: utils/parser.py:65-90)."""
    cfg = get_cfg()
    cfg_file = getattr(args, "cfg_file", None)
    if cfg_file is not None:
        cfg.merge_from_file(cfg_file)
    opts = getattr(args, "opts", None)
    if opts:
        cfg.merge_from_list(list(opts))
    if hasattr(args, "num_shards") and hasattr(args, "shard_id"):
        cfg.NUM_SHARDS = args.num_shards
        cfg.SHARD_ID = args.shard_id
    if hasattr(args, "rng_seed"):
        cfg.RNG_SEED = args.rng_seed
    if hasattr(args, "output_dir"):
        cfg.OUTPUT_DIR = args.output_dir
    return cfg


def set_data_path(cfg, data_path):
    """A CLI's ``--data_path`` fills ``DATA.PATH_TO_DATA_DIR``, and
    ``DATA.PATH_PREFIX`` where the config left it empty; an empty path
    changes nothing."""
    if data_path:
        cfg.DATA.PATH_TO_DATA_DIR = data_path
        if not cfg.DATA.PATH_PREFIX:
            cfg.DATA.PATH_PREFIX = data_path
