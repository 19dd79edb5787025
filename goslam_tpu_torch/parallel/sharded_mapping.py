"""The mapper's train step sharded over the rays of a ``ShardMesh``.

Each shard renders its block of the ray batch through the mapper's
InstantNeuS on its own device (``ShardMesh.replicate_module``: the
mapper's model on the mapper's device, elsewhere a copy holding its
weights).  The renders are gathered on the mapper's device in shard
order, and the mapper's loss runs once on them: the loss of the whole
batch.  One backward sends each shard's part of the gradient to the
parameters it rendered with; a copy's gradient is added to the model's
in device order.  The result is the single-device gradient.  Then the
mapper's own global-norm clip and AdamW step update the mapper's model,
and the copies take its new weights at the next step.  (Under the JAX
package's ``shard_map`` the gradient of the psum'd loss comes back
already summed over the shards, and its step sums it once more: S times
the single-device gradient.  The port does not follow it there.)
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..mapping import mapper as mapper_lib
from ..mapping.renderer import render_rays
from . import ShardMesh


def shard_rays(n_shards: int, rays_o, rays_d, gt_color, gt_depth):
    """Pad the ray batch to a multiple of n_shards.  Padded rays copy ray
    0's geometry (a zero direction would give NaN in the renderer) with
    depth 0, so they are outside every loss term normalized by the rays
    with depth; only the eikonal mean sees them."""
    n = rays_o.shape[0]
    k = -n % n_shards
    if k == 0:
        return rays_o, rays_d, gt_color, gt_depth

    def rep(a):
        return torch.cat([a, a[:1].expand(k, *a.shape[1:])])

    return (rep(rays_o), rep(rays_d), rep(gt_color),
            torch.cat([gt_depth, gt_depth.new_zeros(k)]))


class ShardedMapStep:
    """The ray-sharded train step of `mapper` over `mesh` (the JAX
    package's ``make_sharded_map_step_from_cfg``): the mapper's model,
    loss, clip and optimizer."""

    def __init__(self, mesh: ShardMesh, mapper):
        self.mesh = mesh
        self.mapper = mapper

    def grads(self, rays_o, rays_d, gt_color, gt_depth, bound,
              realtime_bound, rs: Optional[Sequence] = None):
        """The loss terms and the gradient before the clip, on the
        mapper's device and in the order of ``mapper.params``, of one
        step on the batch (its length a multiple of the shards,
        ``shard_rays``).  rs: each shard's stratified jitter [n_samples]
        or None; by default drawn from the mapper's generator in shard
        order when ``perturb`` is on."""
        m, mesh = self.mapper, self.mesh
        S, devs = mesh.size, mesh.devices
        n = rays_o.shape[0] // S
        if n * S != rays_o.shape[0]:
            raise ValueError(f"{rays_o.shape[0]} rays do not split into "
                             f"{S} shards; pad them with shard_rays")
        if rs is None:
            rs = [m._jitter() for _ in range(S)]
        home = m.params[0].device
        models = mesh.replicate_module(m.model)

        def split(t):
            return [t[s * n:(s + 1) * n].to(dev) for s, dev in enumerate(devs)]

        ro, rd, gd = map(split, (rays_o, rays_d, gt_depth))
        # the far clamp and the surface range of rays without depth see
        # the whole batch's largest depth
        dmax = mesh.pmax([g.max() for g in gd])

        def render(model, dev, r, o, d, g, dm, b, rb):
            return render_rays(model, None if r is None else r.to(dev), o, d,
                               g, b, rb, m.n_samples, m.n_surface,
                               depth_max=dm)

        with torch.enable_grad():
            rets = mesh.map(render, models, devs, rs, ro, rd, gd, dmax,
                            mesh.replicate(bound),
                            mesh.replicate(realtime_bound))
            # every output is per ray but the eikonal term, one mean per
            # shard: the shards are of one size, so their mean is the
            # batch's
            ret = {k: torch.cat([r[k].to(home) for r in rets])
                   for k in rets[0]}
            total, terms = m.losses(ret, gt_color, gt_depth)
            # each distinct model's parameters, in the optimizer's order
            names = {p: k for k, p in m.model.named_parameters()}
            distinct = list({id(x): x for x in models}.values())
            params = [[dict(x.named_parameters())[names[p]] for p in m.params]
                      for x in distinct]
            flat = torch.autograd.grad(total, [p for ps in params for p in ps])
        P = len(m.params)
        grads = [g.to(home) for g in flat[:P]]
        for c in range(1, len(distinct)):
            grads = [g + h.to(home) for g, h in zip(grads,
                                                    flat[c * P:(c + 1) * P])]
        return {k: v.detach() for k, v in terms.items()}, grads

    def __call__(self, rays_o, rays_d, gt_color, gt_depth, bound,
                 realtime_bound, rs: Optional[Sequence] = None):
        """One step: the gradient (``grads``), then the mapper's
        global-norm clip and AdamW step.  Returns the loss terms."""
        terms, grads = self.grads(rays_o, rays_d, gt_color, gt_depth, bound,
                                  realtime_bound, rs)
        m = self.mapper
        mapper_lib._step(m.opt, m.params, mapper_lib.clip_by_global_norm(
            grads, mapper_lib.GRAD_CLIP))
        return terms
