from .cfg_node import CfgNode
from .defaults import get_cfg
from .parser import load_config, set_data_path

__all__ = ["CfgNode", "get_cfg", "load_config", "set_data_path"]
