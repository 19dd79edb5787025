"""Config system — YAML with `inherit_from` chains over Python defaults.

Load -> follow inherit_from recursively -> recursive dict merge, with the
base defaults expressed here in code so the package works without any
config file.  The same schema as the JAX package's configs/ files.
"""
from __future__ import annotations

import copy
from typing import Optional


def default_config() -> dict:
    """Defaults of the GO-SLAM base config (go_slam.yaml)."""
    return {
        "verbose": True,
        "dataset": "",
        "mode": "mono",
        "stride": 1,
        # multi-device scale-out of global BA and mapping (not ported
        # yet: tracking runs on one device whatever this says, and
        # mapping raises when it would shard over several GPUs)
        "multichip": True,
        "only_tracking": False,
        "mapping": {
            "BA": False,
            "BA_cam_lr": 1e-3,
            "net_lr": 1e-3,
            "grid_lr": 1e-2,
            "w_color_loss": 2.0,
            "w_depth_loss": 1.0,
            "w_sdf_loss": 2.0,
            "w_eikonal_loss": 0.1,
            "uncertainty_weight_loss": True,
            "mapping_window_size": 22,
            "pixels": 4400,
            "iters": 2,
            "post_processing_iters": 10,
            "decay": 0.8,
            "bound": [[-6.0, 6.0], [-6.0, 6.0], [-6.0, 6.0]],
            "model": {
                "sdf_truncation": 0.16,
                "sdf_sparse_factor": 5,
                "sdf_random_weight": 0.04,
                "sdf_network": {"d_in": 3, "d_out": 32},
                "color_network": {"d_in": 3, "d_feat": 31, "d_hidden": 64,
                                  "n_layers": 2},
                "variance_network": {"init_val": 0.2, "scale_factor": 10.0},
            },
        },
        "tracking": {
            "pretrained": "",
            "buffer": 512,
            "beta": 0.75,
            "warmup": 8,
            # confidence calibration applied to the update net's BA
            # weights; 1.0 = the net's raw sigmoid output (the value for
            # DROID's droid.pth).  Synthetic-trained checkpoints document
            # their validated value in the scene config.
            "weight_calib": 1.0,
            "upsample": True,
            "motion_filter": {"thresh": 4.0},
            "multiview_filter": {
                "thresh": 0.01, "visible_num": 2, "kernel_size": 1,
                "bound_enlarge_scale": 1.10,
            },
            "frontend": {
                "enable_loop": True,
                "keyframe_thresh": 4.0,
                "thresh": 16.0,
                "window": 25,
                "radius": 1,
                "nms": 1,
                "max_factors": 75,
            },
            "backend": {
                "thresh": 25.0,
                "radius": 1,
                "nms": 5,
                "loop_window": 25,
                "loop_thresh": 25.0,
                "loop_radius": 1,
                "loop_nms": 12,
            },
        },
        "cam": {
            "H": 480, "W": 640,
            "fx": 577.590698, "fy": 578.729797,
            "cx": 318.905426, "cy": 242.683609,
            "png_depth_scale": 1000.0,
            "calibration_txt": "",
            "H_edge": 8, "W_edge": 16,
            "H_out": 240, "W_out": 320,
        },
        "rendering": {
            "N_samples": 24, "N_surface": 48, "lindisp": False,
            "perturb": 1.0,
        },
        "data": {"input_folder": "", "output": ""},
        "meshing": {
            "level_set": 0, "resolution": 512, "eval_rec": False,
            "get_largest_components": False,
            "remove_small_geometry_threshold": 0.2,
            "n_points_to_eval": 200000,
            "mesh_threshold_to_eval": 0.05,
            "gt_mesh_path": "",
            "forecast_radius": 0,
        },
    }


def update_recursive(dst: dict, src: dict) -> dict:
    """In-place recursive merge of src over dst (config.py:42-58)."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            update_recursive(dst[k], v)
        else:
            dst[k] = v
    return dst


def load_config(path: Optional[str] = None,
                defaults: Optional[dict] = None) -> dict:
    """Load a YAML config, following single-parent `inherit_from` chains,
    merged over the built-in defaults (config.py:4-35)."""
    cfg = copy.deepcopy(defaults) if defaults is not None else default_config()
    if path is None:
        return cfg

    import yaml

    chain = []
    p = path
    while p:
        with open(p) as f:
            c = yaml.safe_load(f) or {}
        chain.append(c)
        p = c.pop("inherit_from", None)

    for c in reversed(chain):
        update_recursive(cfg, c)
    return cfg


def save_config(cfg: dict, path: str):
    """Write `cfg` as YAML (``load_config`` reads it back)."""
    import yaml

    with open(path, "w") as f:
        yaml.dump(cfg, f)
