"""Shards over a list of devices, driven by one process.

``ShardMesh`` is the port's counterpart of the JAX package's
``jax.sharding.Mesh`` together with the ``psum`` and ``pmax`` that its
``shard_map`` bodies use.  The JAX package has a single controller: one
process takes the host decisions (motion filter, greedy edge proposal)
once and hands the edge and ray work to the mesh.  The port keeps that
shape: one process, a list of devices, each shard's work launched on its
own device in shard order (``map``), and the shards' partial results
combined by a sum in fixed shard order on the first shard's device
(``psum``), so the combined result is the same bits from run to run.

Several shards may share one device: ``ShardMesh([cpu] * S)`` is the
counterpart of the JAX package's virtual CPU devices, and
``ShardMesh([cuda:0] * 2)`` runs the sharded program for real on one
card.

A module a shard needs on another device than its own (the frozen
DroidNet, the mapper's InstantNeuS) is copied there once and kept with
the mesh, which lives as long as the system (``replicate_module``); its
weights are copied in from the module's at each use, so a copy never
runs on weights the module no longer holds.
"""
from __future__ import annotations

import copy
import weakref
from typing import Callable, List, Sequence

import torch
from torch import nn


def _index(d) -> torch.device:
    """A device with its index: 'cuda' becomes the current CUDA device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class ShardMesh:
    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [_index(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        # module -> {device: its copy there}
        self._copies: "weakref.WeakKeyDictionary[nn.Module, dict]" = \
            weakref.WeakKeyDictionary()

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"ShardMesh({[str(d) for d in self.devices]})"

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """t on each shard's device: one copy per distinct device, and t
        itself on a device it already lies on."""
        on = {}
        for d in self.devices:
            if d not in on:
                on[d] = t.to(d)
        return [on[d] for d in self.devices]

    def replicate_module(self, module: nn.Module) -> List[nn.Module]:
        """module on each shard's device, holding module's weights now:
        module itself on the device it lies on; elsewhere one copy per
        device, made at first use and kept, its parameters and buffers
        copied from module's at every call."""
        own = next(module.parameters()).device
        copies = self._copies.setdefault(module, {})
        src = list(module.parameters()) + list(module.buffers())
        on = {}
        for d in self.devices:
            if d in on:
                continue
            if d == own:
                on[d] = module
                continue
            rep = copies.get(d)
            if rep is None:
                rep = copies[d] = copy.deepcopy(module).to(d)
            else:
                with torch.no_grad():
                    for a, b in zip(list(rep.parameters())
                                    + list(rep.buffers()), src):
                        a.copy_(b)
            on[d] = rep
        return [on[d] for d in self.devices]

    def map(self, fn: Callable, *per_shard: Sequence) -> list:
        """[fn(shard 0's arguments), fn(shard 1's), ...], in shard order:
        per_shard holds one sequence of arguments for each parameter of
        fn, indexed by shard."""
        return [fn(*(a[s] for a in per_shard)) for s in range(self.size)]

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of the shards' tensors, added in shard order on the
        first shard's device, then placed on each shard's device."""
        total = parts[0].to(self.devices[0])
        for p in parts[1:]:
            total = total + p.to(self.devices[0])
        return self.replicate(total)

    def pmax(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise maximum over the shards, on each shard's
        device."""
        top = parts[0].to(self.devices[0])
        for p in parts[1:]:
            top = torch.maximum(top, p.to(self.devices[0]))
        return self.replicate(top)
