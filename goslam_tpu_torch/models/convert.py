"""Carry DroidNet weights from the flax parameter tree to the port.

The JAX package keeps DroidNet's parameters as a nested dict of numpy
arrays (flax names, HWIO conv kernels); its trainer pickles that tree
together with the training config (``checkpoints/droid_synthetic.ckpt``).
``flax_to_state_dict`` maps it onto the port's modules, which use DROID's
own torch names and OIHW kernels, so a torch ``droid.pth`` state dict
loads into the same modules unchanged.  Unpickling needs numpy alone.
"""
from __future__ import annotations

import pickle
from typing import Dict, Mapping

import numpy as np
import torch

# flax module path -> torch module path
_ENC = {"conv1": "conv1", "conv2": "conv2",
        **{f"layer{s}_{b}": f"layer{s}.{b}" for s in (1, 2, 3) for b in (0, 1)}}
_BLOCK = {"conv1": "conv1", "conv2": "conv2", "downsample": "downsample.0"}
_UPDATE = {
    "corr_enc1": "corr_encoder.0", "corr_enc2": "corr_encoder.2",
    "flow_enc1": "flow_encoder.0", "flow_enc2": "flow_encoder.2",
    "weight1": "weight.0", "weight2": "weight.2",
    "delta1": "delta.0", "delta2": "delta.2",
    "gru": "gru", "agg": "agg",
}
_AGG = {"conv1": "conv1", "conv2": "conv2", "eta": "eta.0",
        "upmask": "upmask.0"}


def _conv(sd: Dict, prefix: str, leaf: Mapping):
    """One flax conv (kernel HWIO, bias) -> torch weight OIHW, bias."""
    k = np.asarray(leaf["kernel"], np.float32)
    sd[prefix + ".weight"] = torch.from_numpy(
        np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    sd[prefix + ".bias"] = torch.from_numpy(
        np.asarray(leaf["bias"], np.float32).copy())


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax DroidNet param tree (numpy leaves) -> the port's state dict.
    A ``weight_calib`` scalar leaf, if present, rides along."""
    sd: Dict[str, torch.Tensor] = {}
    for enc in ("fnet", "cnet"):
        for fname, tname in _ENC.items():
            node = params[enc][fname]
            if "kernel" in node:
                _conv(sd, f"{enc}.{tname}", node)
            else:
                for sub, tsub in _BLOCK.items():
                    if sub in node:
                        _conv(sd, f"{enc}.{tname}.{tsub}", node[sub])
    for fname, tname in _UPDATE.items():
        node = params["update"][fname]
        if fname == "gru":
            for sub, leaf in node.items():
                _conv(sd, f"update.gru.{sub}", leaf)
        elif fname == "agg":
            for sub, tsub in _AGG.items():
                _conv(sd, f"update.agg.{tsub}", node[sub])
        else:
            _conv(sd, f"update.{tname}", node)
    sd["weight_calib"] = torch.tensor(
        float(np.asarray(params.get("weight_calib", 1.0))))
    return sd


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a trainer checkpoint (a pickle of numpy arrays) into the
    port's state dict."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    return flax_to_state_dict(state["params"])
