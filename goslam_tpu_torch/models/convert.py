"""Carry DroidNet and InstantNeuS weights from flax parameter trees to the port.

The JAX package keeps DroidNet's parameters as a nested dict of numpy
arrays (flax names, HWIO conv kernels); its trainer pickles that tree
together with the training config (``checkpoints/droid_synthetic.ckpt``).
``flax_to_state_dict`` maps it onto the port's modules, which use DROID's
own torch names and OIHW kernels, so a torch ``droid.pth`` state dict
loads into the same modules unchanged; ``state_dict_to_flax`` is its
inverse, with which the port's trainer writes the JAX trainer's
checkpoint format.  Unpickling needs numpy alone.
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


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The port's DroidNet state dict -> the JAX package's flax param tree
    of fp32 numpy arrays (HWIO kernels), the inverse of
    ``flax_to_state_dict``.  ``weight_calib`` is not a parameter of the
    flax tree (the JAX package's config carries it) and is left out."""
    def conv(prefix):
        w = sd[prefix + ".weight"].detach().cpu().float().numpy()
        return {"kernel": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))),
                "bias": sd[prefix + ".bias"].detach().cpu().float().numpy()
                .copy()}

    tree: Dict = {}
    for enc in ("fnet", "cnet"):
        node = tree[enc] = {}
        for fname, tname in _ENC.items():
            if f"{enc}.{tname}.weight" in sd:
                node[fname] = conv(f"{enc}.{tname}")
            else:
                node[fname] = {sub: conv(f"{enc}.{tname}.{tsub}")
                               for sub, tsub in _BLOCK.items()
                               if f"{enc}.{tname}.{tsub}.weight" in sd}
    upd = tree["update"] = {}
    for fname, tname in _UPDATE.items():
        if fname == "gru":
            subs = sorted({k.split(".")[2] for k in sd
                           if k.startswith("update.gru.")})
            upd[fname] = {sub: conv(f"update.gru.{sub}") for sub in subs}
        elif fname == "agg":
            upd[fname] = {sub: conv(f"update.agg.{tsub}")
                          for sub, tsub in _AGG.items()}
        else:
            upd[fname] = conv(f"update.{tname}")
    return tree


def convert_mapping_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX mapper's InstantNeuS parameter tree (numpy leaves) -> the
    port's ``InstantNeuS`` state dict: dense kernels [in, out] become
    ``Linear.weight`` [out, in]; the hash table, ``B`` and the variance
    are copied as they are."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32, order="C"))

    def dense(prefix, leaf):
        sd[prefix + ".weight"] = t(np.asarray(leaf["kernel"]).T)
        sd[prefix + ".bias"] = t(leaf["bias"])

    sd: Dict[str, torch.Tensor] = {}
    sdf, col = params["sdf_network"], params["color_network"]
    sd["sdf_network.encoding.table"] = t(sdf["encoding"]["table"])
    dense("sdf_network.sdf_layer", sdf["sdf_layer"])
    sd["color_network.B"] = t(col["B"])
    i = 0
    while f"hidden{i}" in col:
        dense(f"color_network.hidden.{i}", col[f"hidden{i}"])
        i += 1
    dense("color_network.out", col["out"])
    sd["variance"] = t(params["variance"])
    return sd


def is_flax_tree(params: Mapping) -> bool:
    """A nested flax tree (the JAX package's) rather than a flat state
    dict of dotted names (the port's)."""
    return any(isinstance(v, Mapping) for v in params.values())


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a trainer checkpoint (a pickle of numpy arrays) into the
    port's state dict."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    return flax_to_state_dict(state["params"])
