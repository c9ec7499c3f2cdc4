"""User configuration (reference: gammagl/data/utils.py:19-60 +
ggl_config_default.json: per-user ~/.ggl_tpu/config.json with dataset_root;
TL_BACKEND is gone -- one backend -- and mesh defaults are added).
"""

import json
import os
import os.path as osp

__all__ = ["get_config", "get_dataset_root", "save_config", "DEFAULTS"]

DEFAULTS = {
    "dataset_root": "~/.ggl_tpu/datasets",
    "mesh_axis_names": ["dp"],
}

_CONFIG_DIR = osp.expanduser("~/.ggl_tpu")
_CONFIG_PATH = osp.join(_CONFIG_DIR, "config.json")
_cache = None


def get_config():
    global _cache
    if _cache is not None:
        return _cache
    cfg = dict(DEFAULTS)
    if osp.exists(_CONFIG_PATH):
        try:
            with open(_CONFIG_PATH) as f:
                cfg.update(json.load(f))
        except (json.JSONDecodeError, OSError):
            pass
    # env override (reference uses env vars as tier 1)
    if "GGL_TPU_DATASET_ROOT" in os.environ:
        cfg["dataset_root"] = os.environ["GGL_TPU_DATASET_ROOT"]
    _cache = cfg
    return cfg


def get_dataset_root():
    return osp.expanduser(get_config()["dataset_root"])


def save_config(cfg):
    global _cache
    os.makedirs(_CONFIG_DIR, exist_ok=True)
    with open(_CONFIG_PATH, "w") as f:
        json.dump(cfg, f, indent=2)
    _cache = None
