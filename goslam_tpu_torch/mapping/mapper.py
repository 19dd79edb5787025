"""Mapper: the online training loop of the InstantNeuS scene model.

Keyframe schedule: keyframes not visited yet get a burst (x10 on the
first round); the revisit window takes the two newest keyframes, the
ten of highest update priority and random ones up to the window size.
Rays are drawn without replacement from each keyframe's multiview mask.
The optimizer is AdamW in two groups (the hash table at ``grid_lr``,
the rest at ``net_lr``, weight decay 0.01 on both; torch's decoupled
decay is optax.adamw's) after a global-norm clip at 35, written out as
optax computes it.  The loss: L1 colour x2,
uncertainty-weighted L1 depth, truncation SDF + free space x2, eikonal
x0.1.  With ``mapping.BA`` the revisit window also refines one se(3)
increment per keyframe (Adam at ``BA_cam_lr``); the refined poses only
shape the map, they are not written back to the tracker.

Padding is part of the loss: a window of F keyframes is padded to a
bucket of (2, 4, 8, ..., 64) frames whose rays carry depth 0, and the
ray batch to ``bucket(R)`` rays by repeating its first rays with depth
0; those rays count in the eikonal mean and the far clamp.

With a ``ShardMesh`` of more than one shard (``mesh=``) each map step
is ray-sharded (``parallel.sharded_mapping.ShardedMapStep``); the pose-BA
step stays on one device.

Host random draws (the frame schedule, the pose-BA pixels) come from
``np.random.default_rng(seed)``, device draws (ray keys, stratified
jitter) from a ``torch.Generator`` on the video's device; the functions
that use device draws take them as arguments.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import lie
from ..utils import trace
from ..utils.shapes import bucket
from .instant_neus import InstantNeuS, compute_sdf_losses
from .renderer import build_ray_dirs, render_rays

FRAME_BUCKETS = (2, 4, 8, 16, 24, 32, 48, 64)
BA_FRAME_BUCKETS = (8, 16, 24, 32, 48, 64)
GRAD_CLIP = 35.0


def sample_rays(frames: torch.Tensor, keys: torch.Tensor, images,
                disps_f, masks, poses_f, pose_comp, intr8, n_per: int,
                scale: int):
    """Masked ray sampling over a window of keyframes on the device.

    frames [F] keyframe ids (-1 = padding); keys [F, H, W] uniform.  Per
    frame the n_per masked pixels of largest key are picked (ties to the
    lower index, as lax.top_k); a frame with fewer masked pixels, or a
    padding frame, gives rays of depth 0.  Returns flat (rays_o [F*n_per,
    3], rays_d, gt_color, gt_depth)."""
    F = frames.shape[0]
    ok_f = frames >= 0
    fi = torch.where(ok_f, frames, 0)
    H, W = masks.shape[-2:]

    score = torch.where(masks[fi] > 0, keys, -1.0).reshape(F, H * W)
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :n_per], idx[:, :n_per]
    picked = top >= 0.0
    ys, xs = idx // W, idx % W

    fx, fy, cx, cy = (intr8 * scale).unbind(-1)
    xf, yf = xs.float(), ys.float()
    dirs = torch.stack([(xf - cx) / fx, (yf - cy) / fy,
                        torch.ones_like(xf)], dim=-1)           # [F, n, 3]
    c2w = lie.matrix(lie.compose(pose_comp[None], lie.inv(poses_f[fi])))
    rays_d = torch.einsum("fab,fpb->fpa", c2w[:, :3, :3], dirs)
    rays_o = c2w[:, None, :3, 3].expand(rays_d.shape)

    fr = fi[:, None]
    gt_color = images[fr, ys, xs]                               # [F, n, 3]
    gt_depth = 1.0 / (disps_f[fr, ys, xs] + 1e-7)
    gt_depth = torch.where(picked & ok_f[:, None], gt_depth, 0.0)
    return (rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
            gt_color.reshape(-1, 3), gt_depth.reshape(-1))


def _rays_with_depth(gt_depth: torch.Tensor):
    """The rays of a batch (padding not yet added) whose target depth is
    positive, counted on the device while the tracer is on; else 0."""
    return (gt_depth > 0).sum() if trace.ON else 0


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g / norm * max_norm, only when the norm
    of all gradients together reaches max_norm (no host round trip)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm)
            for g in grads]


def make_optimizer(params, net_lr: float, grid_lr: float):
    """AdamW in two groups: params[0], the hash table, at grid_lr, the
    rest at net_lr; weight decay 0.01 on both."""
    return torch.optim.AdamW(
        [{"params": params[:1], "lr": grid_lr},
         {"params": params[1:], "lr": net_lr}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, fused=True)


def _step(opt: torch.optim.Optimizer, params, grads):
    """One optimizer step with the given gradients."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


class Mapper:
    def __init__(self, video, cfg: dict, seed: int = 0, mesh=None):
        m = cfg["mapping"]
        self.video = video
        self.cfg = cfg
        self.device = video.device
        self.w_color = m["w_color_loss"]
        self.w_sdf = m["w_sdf_loss"]
        self.w_eik = m["w_eikonal_loss"]
        self.uncertainty = m["uncertainty_weight_loss"]
        self.window = m["mapping_window_size"]
        self.pixels = m["pixels"]
        self.iters = m["iters"]
        self.decay = m["decay"]

        mm = m["model"]
        # the initial parameters come from the seed, on the CPU
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = InstantNeuS(
                d_out=mm["sdf_network"]["d_out"],
                d_hidden=mm["color_network"]["d_hidden"],
                n_layers=mm["color_network"]["n_layers"],
                init_val=mm["variance_network"]["init_val"],
                scale_factor=mm["variance_network"]["scale_factor"])
        self.model = model.to(self.device)
        self.truncation = mm["sdf_truncation"]
        self.sparse_factor = mm["sdf_sparse_factor"]

        r = cfg["rendering"]
        self.n_samples = r["N_samples"]
        self.n_surface = r["N_surface"]
        self.perturb = r["perturb"]

        self.enable_ba = m.get("BA", False)
        self.ba_cam_lr = m.get("BA_cam_lr", 1e-3)
        # AdamW: the hash table in the grid group, the rest in the net one
        named = list(self.model.named_parameters())
        self.params = [p for n, p in named if n.endswith("table")] \
            + [p for n, p in named if not n.endswith("table")]
        self.net_lr, self.grid_lr = m["net_lr"], m["grid_lr"]
        self.opt = make_optimizer(self.params, self.net_lr, self.grid_lr)

        self.last_visit = 0
        self.init = True
        self.global_step = 0
        self.np_rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

        # the ray-sharded map step over a mesh of two or more shards
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        self.sharded_step = None
        if self.mesh is not None:
            from ..parallel.sharded_mapping import ShardedMapStep
            self.sharded_step = ShardedMapStep(self.mesh, self)

    # ------------------------------------------------------------------
    def _jitter(self) -> Optional[torch.Tensor]:
        if self.perturb <= 0:
            return None
        return torch.rand(self.n_samples, generator=self.gen,
                          device=self.device)

    def losses(self, ret: Dict[str, torch.Tensor], gt_color, gt_depth):
        """The total loss and its terms (tensors, no host round trip)."""
        valid = (gt_depth > 0).float()
        nv = torch.clamp(valid.sum(), min=1.0)
        color_l = ((ret["color"] - gt_color).abs().mean(-1) * valid).sum() / nv
        if self.uncertainty:
            uw = 1.0 / torch.sqrt(ret["depth_variance"][:, 0].detach()
                                  + 1e-10)
        else:
            uw = torch.ones_like(gt_depth)
        depth_l = ((ret["depth"][:, 0] - gt_depth).abs() * uw
                   * valid).sum() / nv
        sdf_l, front_l = compute_sdf_losses(
            ret["sdf"], ret["z_vals"], gt_depth, self.truncation,
            self.sparse_factor)
        eik_l = ret["gradient_error"].mean()
        total = (color_l * self.w_color + depth_l
                 + (sdf_l + front_l) * self.w_sdf + eik_l * self.w_eik)
        return total, {"color": color_l, "depth": depth_l, "sdf": sdf_l,
                       "eikonal": eik_l, "total": total}

    @torch.enable_grad()
    def train_step(self, rays_o, rays_d, gt_color, gt_depth, bound,
                   realtime_bound, r: Optional[torch.Tensor] = None):
        """One optimizer step on a ray batch; r [n_samples] is the
        stratified jitter (drawn from the generator when None and
        ``perturb`` is on).  Returns the loss terms."""
        if r is None:
            r = self._jitter()
        ret = render_rays(self.model, r, rays_o, rays_d, gt_depth, bound,
                          realtime_bound, self.n_samples, self.n_surface)
        total, metrics = self.losses(ret, gt_color, gt_depth)
        grads = torch.autograd.grad(total, self.params)
        _step(self.opt, self.params, clip_by_global_norm(grads, GRAD_CLIP))
        return {k: v.detach() for k, v in metrics.items()}

    @torch.enable_grad()
    def train_step_ba(self, deltas, cam_opt, c2w_base, frame_of_ray,
                      dirs_cam, gt_color, gt_depth, bound, realtime_bound,
                      r: Optional[torch.Tensor] = None):
        """One joint step of the map and the per-keyframe pose increments
        deltas [F, 6] (a leaf that requires grad) around c2w_base [F, 7];
        rays are rebuilt from the refined poses so the loss reaches
        them."""
        if r is None:
            r = self._jitter()
        Gr = lie.retr(c2w_base, deltas)[frame_of_ray]
        rays_d = lie.quat_rotate(Gr[:, 3:7], dirs_cam)
        ret = render_rays(self.model, r, Gr[:, 0:3], rays_d, gt_depth,
                          bound, realtime_bound, self.n_samples,
                          self.n_surface)
        total, metrics = self.losses(ret, gt_color, gt_depth)
        *gp, gd = torch.autograd.grad(total, self.params + [deltas])
        _step(self.opt, self.params, clip_by_global_norm(gp, GRAD_CLIP))
        _step(cam_opt, [deltas], [gd])
        return {k: v.detach() for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def _sample_pixels(self, frames: list, n_per_frame: int):
        """Masked pixel sampling for the pose-BA step (host choice of
        pixels with the numpy generator): per-ray frame slot,
        camera-frame direction, colour and depth, and each slot's base
        c2w pose."""
        video = self.video
        fx, fy, cx, cy = (video.intrinsics * video.device_scale).tolist()
        dirs_cam = build_ray_dirs(video.ht, video.wd, fx, fy, cx, cy,
                                  self.device)
        c2w_base, fo, dc, gc, gd = [], [], [], [], []
        for f in frames:
            image, depth, c2w, _, mask = video.get_mapping_item(
                f, decay=self.decay)
            ys, xs = np.nonzero(mask.cpu().numpy() > 0)
            if len(ys) == 0:
                continue
            sel = self.np_rng.integers(0, len(ys), n_per_frame)
            py = torch.as_tensor(ys[sel], device=self.device)
            px = torch.as_tensor(xs[sel], device=self.device)
            c2w_base.append(lie.from_matrix(c2w))
            fo.append(torch.full((n_per_frame,), len(c2w_base) - 1,
                                 dtype=torch.long, device=self.device))
            dc.append(dirs_cam[py, px])
            gc.append(image[py, px])
            gd.append(depth[py, px])
        if not fo:
            return None
        return (torch.stack(c2w_base), torch.cat(fo), torch.cat(dc),
                torch.cat(gc), torch.cat(gd))

    def _optimize_ba(self, frames, n_per_frame, bound, realtime_bound,
                     iters: int):
        """Revisit-window optimization with camera refinement."""
        F = bucket(len(frames), BA_FRAME_BUCKETS)
        deltas = torch.zeros((F, 6), device=self.device, requires_grad=True)
        cam_opt = torch.optim.Adam([deltas], lr=self.ba_cam_lr,
                                   betas=(0.9, 0.999), eps=1e-8, fused=True)
        metrics = None
        for _ in range(iters):
            out = self._sample_pixels(frames, n_per_frame)
            if out is None:
                return None
            c2w_base, fo, dc, gc, gd = out
            if c2w_base.shape[0] < F:            # identity for padding slots
                c2w_base = torch.cat([c2w_base, lie.identity(
                    (F - c2w_base.shape[0],), device=self.device)])
            R = fo.shape[0]
            with_depth = _rays_with_depth(gd)
            pad = bucket(R) - R
            if pad:
                fo = torch.cat([fo, fo[:pad]])
                dc = torch.cat([dc, dc[:pad]])
                gc = torch.cat([gc, gc[:pad]])
                gd = torch.cat([gd, gd.new_zeros(pad)])
            self.global_step += 1
            trace.add("mapper.steps")
            trace.add("mapper.rays", R)
            trace.add("mapper.rays_depth", with_depth)
            with trace.span("slam.map_step"):
                metrics = self.train_step_ba(deltas, cam_opt, c2w_base, fo,
                                             dc, gc, gd, bound,
                                             realtime_bound)
        return metrics

    # ------------------------------------------------------------------
    def _sample_rays(self, frames: list, n_per_frame: int, keys=None):
        """Masked ray sampling over the given keyframes, padded to a
        bucket of frames; each access decays the keyframe's update
        priority (duplicates included).  keys [F, H, W] default to draws
        from the generator."""
        if not frames:
            return None
        video = self.video
        F = bucket(len(frames), FRAME_BUCKETS)
        fr = np.full(F, -1, np.int64)
        fr[:len(frames)] = frames
        for f in frames:
            video.update_priority[f] *= self.decay
        if keys is None:
            keys = torch.rand((F, video.ht, video.wd), generator=self.gen,
                              device=self.device)
        return sample_rays(
            torch.as_tensor(fr, device=self.device), keys, video.images,
            video.disps_filtered, video.mask_filtered, video.poses_filtered,
            video.pose_compensate, video.intrinsics, n_per_frame,
            video.device_scale)

    def _optimize(self, batch, bound, realtime_bound, iters: int):
        """`iters` steps on one ray batch, padded to bucket(R) rays by
        repeating its first rays with depth 0; with a mesh the ray-sharded
        step, on the batch padded again to a multiple of the shards
        (``shard_rays``)."""
        rays_o, rays_d, gt_color, gt_depth = batch
        R = rays_o.shape[0]
        with_depth = _rays_with_depth(gt_depth)
        pad = bucket(R) - R
        if pad:
            rays_o = torch.cat([rays_o, rays_o[:pad]])
            rays_d = torch.cat([rays_d, rays_d[:pad]])
            gt_color = torch.cat([gt_color, gt_color[:pad]])
            gt_depth = torch.cat([gt_depth, gt_depth.new_zeros(pad)])
        step = self.train_step
        if self.mesh is not None:
            from ..parallel.sharded_mapping import shard_rays
            rays_o, rays_d, gt_color, gt_depth = shard_rays(
                self.mesh.size, rays_o, rays_d, gt_color, gt_depth)
            step = self.sharded_step
        metrics = None
        for _ in range(iters):
            self.global_step += 1
            trace.add("mapper.steps")
            trace.add("mapper.rays", R)
            trace.add("mapper.rays_depth", with_depth)
            with trace.span("slam.map_step"):
                metrics = step(rays_o, rays_d, gt_color, gt_depth, bound,
                               realtime_bound)
        return metrics

    # ------------------------------------------------------------------
    def schedule(self, cur: int):
        """The unvisited keyframes and the revisit window of a round
        (draws the window's random part from the numpy generator)."""
        unvisit = list(range(self.last_visit, cur))
        visit = [cur - 1, cur - 2]
        if self.last_visit > 0:
            prio = self.video.update_priority[:self.last_visit]
            visit += np.argsort(-prio)[:10].tolist()
            n_rand = max(self.window - 12, 0)
            if n_rand and self.last_visit > 1:
                visit += self.np_rng.integers(
                    0, self.last_visit, n_rand).tolist()
        return unvisit, [int(v) for v in visit if 0 <= v < cur]

    def __call__(self, the_end: bool = False):
        """One mapping round; returns the last step's loss terms."""
        with trace.span("slam.mapper"):
            return self._round(the_end)

    def _round(self, the_end: bool):
        video = self.video
        cur = video.filtered_id
        if cur <= 1:
            return None
        trace.add("mapper.rounds")

        iters = self.iters * (10 if the_end else 1)
        bound = torch.as_tensor(video.bound, dtype=torch.float32,
                                device=self.device)
        realtime_bound = bound
        unvisit, visit = self.schedule(cur)

        metrics = None
        # the unvisited burst (x10 on the first round)
        if len(unvisit) > 2:
            self.last_visit = cur
            factor = iters * 10 if self.init else iters
            n_per = max(self.pixels // min(len(unvisit), self.window), 1)
            for _ in range(factor):
                sub = self.np_rng.choice(
                    unvisit, min(self.window, len(unvisit)), replace=True)
                batch = self._sample_rays([int(s) for s in sub], n_per)
                if batch is None or batch[0].shape[0] < 100:
                    continue
                metrics = self._optimize(batch, bound, realtime_bound, 1)

        # the revisit window, with camera refinement when asked for
        n_per = max(self.pixels // max(len(visit), 1), 1)
        if self.enable_ba and self.last_visit >= 10 and visit:
            metrics = self._optimize_ba(visit, n_per, bound,
                                        realtime_bound, iters) or metrics
        else:
            for _ in range(iters):
                batch = self._sample_rays(visit, n_per)
                if batch is None or batch[0].shape[0] < 100:
                    continue
                metrics = self._optimize(batch, bound, realtime_bound, 1)

        self.init = False
        return metrics
