"""Factor graph over keyframes: fixed-capacity edge slots on one device.

Host (numpy): edge bookkeeping -- endpoints, age, slot allocation, dedup,
eviction, edge proposal.  Device (torch): per-edge GRU hidden state, flow
targets and weights, correlation pyramids, and the update step:
reproject -> motion features -> correlation -> update operator -> DBA.

Two correlation backends:
  * 'volume': all-pairs pyramids per edge slot, looked up every step
    (frontend);
  * 'alt':    on-the-fly correlation from feature pyramids with
    edge-chunked GRU updates (global BA and loop closing,
    ``update_lowmem``).  On CUDA the alt-corr is the hand-written kernel
    ``csrc/alt_corr.cu``.

With a ``ShardMesh`` of more than one shard (``mesh=``), the low-memory
step of global BA shards its edges over the mesh by source frame
(``_lowmem_step_sharded``); the frontend's update stays on one device.

Slots are updated in place.  Edges are computed over every slot and
masked by validity, so results do not depend on which slots are free.

Index hygiene: invalid slots carry stale endpoints, so endpoints are
zeroed where a slot is invalid before any gather, and window-local
indices are clamped into [0, P) -- the JAX gathers clamp silently, a torch
gather would raise or read out of bounds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.droidnet import upsample_disp
from ..ops import corr, dba, projective
from ..parallel import sharded_ba
from ..utils.greedy import greedy_nms_scan
from ..utils.shapes import bucket
from .video import VideoBuffer

EPS_DAMP = 1e-7
MOTION_CLAMP = 64.0
DEG_BUCKETS = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128)
# edges per GraphAgg block in the global aggregation (bounds the
# [block, h8, w8, 128] fp32 transient)
AGG_BLOCK = 3072
# global-BA windows from this many poses on are solved with PCG, with this
# iteration budget per Gauss-Newton step
CG_MIN_POSES = 192
CG_ITERS = 32


def resolve_dtype(name) -> torch.dtype:
    """'bfloat16' | 'float32' | None (None -> bf16, the runtime default)."""
    if name is None:
        return torch.bfloat16
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(name)]


class FactorGraph:
    def __init__(self, video: VideoBuffer, net, max_factors: int = 96,
                 corr_impl: str = "volume", upsample: bool = False,
                 inac_capacity: int = 0, chunk: int = 256,
                 compute_dtype: torch.dtype = torch.bfloat16, mesh=None):
        self.video = video
        self.model = net
        # the low-memory step shards its edges over a mesh of two or more
        # shards
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        self.max_factors = max_factors
        self.corr_impl = corr_impl
        self.upsample = upsample
        # conv compute dtype, also the storage dtype of the hidden slab
        # (fp32 mode must not round hidden states through bf16)
        self.cdt = compute_dtype

        cap = bucket(max_factors + 48)
        self.cap = cap
        # chunk divides cap, so the chunk loop updates the slabs in place
        c = min(chunk, cap)
        while cap % c:
            c -= 1
        self.chunk = c
        self.cap_inac = bucket(max(inac_capacity, max_factors)) \
            if inac_capacity >= 0 else 0

        h8, w8 = video.h8, video.w8
        self.h8, self.w8 = h8, w8
        dev = video.device

        self.ii = np.zeros(cap, np.int64)
        self.jj = np.zeros(cap, np.int64)
        self.age = np.zeros(cap, np.int64)
        self.valid = np.zeros(cap, bool)
        self.ii_inac = np.zeros(self.cap_inac, np.int64)
        self.jj_inac = np.zeros(self.cap_inac, np.int64)
        self.valid_inac = np.zeros(self.cap_inac, bool)
        self.ii_bad: list = []
        self.jj_bad: list = []

        f32 = torch.float32
        self.net = torch.zeros((cap, h8, w8, 128), dtype=self.cdt, device=dev)
        self.target = torch.zeros((cap, h8, w8, 2), dtype=f32, device=dev)
        self.weight = torch.zeros((cap, h8, w8, 2), dtype=f32, device=dev)
        self.target_inac = torch.zeros((self.cap_inac, h8, w8, 2), dtype=f32,
                                       device=dev)
        self.weight_inac = torch.zeros((self.cap_inac, h8, w8, 2), dtype=f32,
                                       device=dev)
        self.pyramid = None
        if corr_impl == "volume":
            hw = h8 * w8
            self.pyramid = [
                torch.zeros((cap, hw, h8 // 2 ** l, w8 // 2 ** l),
                            dtype=torch.bfloat16, device=dev)
                for l in range(corr.NUM_LEVELS)]

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.video.device)

    # ------------------------------------------------------------------
    # host-side edge set operations
    # ------------------------------------------------------------------
    def n_edges(self) -> int:
        return int(self.valid.sum())

    def add_factors(self, ii, jj, remove: bool = False):
        """Add edges (dedup against live and archived edges, optional
        age-based eviction); compute their correlation pyramids and
        initial targets."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)

        seen = set(zip(self.ii[self.valid].tolist(),
                       self.jj[self.valid].tolist()))
        seen |= set(zip(self.ii_inac[self.valid_inac].tolist(),
                        self.jj_inac[self.valid_inac].tolist()))
        keep = []
        for k, pair in enumerate(zip(ii.tolist(), jj.tolist())):
            if pair not in seen:
                seen.add(pair)
                keep.append(k)
        ii, jj = ii[keep], jj[keep]
        if len(ii) == 0:
            return

        limit = self.max_factors if (remove and self.max_factors > 0) \
            else self.cap
        over = self.n_edges() + len(ii) - min(limit, self.cap)
        if over > 0:
            act = np.where(self.valid)[0]
            oldest = act[np.argsort(-self.age[act])][:over]
            mask = np.zeros(self.cap, bool)
            mask[oldest] = True
            self.rm_factors(mask, store=True)

        free = np.where(~self.valid)[0][:len(ii)]
        ii, jj = ii[:len(free)], jj[:len(free)]
        self.ii[free] = ii
        self.jj[free] = jj
        self.age[free] = 0
        self.valid[free] = True
        self._write_new_edges(self._t(ii), self._t(jj), self._t(free))

    def _write_new_edges(self, ii, jj, slots):
        v = self.video
        coords, _ = projective.transform(v.poses, v.disps, v.intrinsics,
                                         ii, jj)
        self.target[slots] = coords
        self.weight[slots] = 0.0
        self.net[slots] = v.nets[ii].to(self.cdt)
        if self.pyramid is not None:
            # a stereo self-edge (ii == jj) correlates the left view with
            # the right
            c = (ii == jj).long() if v.stereo else torch.zeros_like(jj)
            levels = corr.build_pyramid(v.fmaps[ii, 0], v.fmaps[jj, c])
            for p, lvl in zip(self.pyramid, levels):
                p[slots] = lvl

    def rm_factors(self, mask, store: bool = False):
        """Drop edges; with store, archive their targets and weights."""
        mask = np.asarray(mask, bool) & self.valid
        if not mask.any():
            return
        if store and self.cap_inac:
            idx = np.where(mask)[0]
            free = np.where(~self.valid_inac)[0]
            if len(free) < len(idx):       # recycle the oldest archive slots
                used = np.where(self.valid_inac)[0][:len(idx) - len(free)]
                free = np.concatenate([free, used])
            free = free[:len(idx)]
            idx = idx[:len(free)]
            self.ii_inac[free] = self.ii[idx]
            self.jj_inac[free] = self.jj[idx]
            self.valid_inac[free] = True
            src, dst = self._t(idx), self._t(free)
            self.target_inac[dst] = self.target[src]
            self.weight_inac[dst] = self.weight[src]
        self.valid[mask] = False

    def rm_keyframe(self, ix: int):
        """Remove keyframe ix: shift the video down and reindex edges."""
        self.video.remove_keyframe(ix)

        m = self.valid & ((self.ii == ix) | (self.jj == ix))
        self.valid[m] = False
        self.ii[self.ii > ix] -= 1
        self.jj[self.jj > ix] -= 1

        mi = self.valid_inac & ((self.ii_inac == ix) | (self.jj_inac == ix))
        self.valid_inac[mi] = False
        self.ii_inac[self.ii_inac > ix] -= 1
        self.jj_inac[self.jj_inac > ix] -= 1

    def clear_edges(self):
        self.valid[:] = False
        self.valid_inac[:] = False

    # ------------------------------------------------------------------
    # edge proposal
    # ------------------------------------------------------------------
    def add_neighborhood_factors(self, t0: int, t1: int, r: int = 3):
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        # stereo keeps the pairs one frame apart out too
        c = 1 if self.video.stereo else 0
        keep = (np.abs(ii - jj) > c) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False):
        """Distance-sorted greedy edge proposal with NMS suppression: the
        distance matrix on the device, the sequential scan on the host."""
        t = self.video.counter
        ilen, jlen = t - t0, t - t1
        if ilen <= 0 or jlen <= 0:
            return
        ii0, jj0 = np.meshgrid(np.arange(t0, t), np.arange(t1, t),
                               indexing="ij")
        ii_f, jj_f = ii0.reshape(-1), jj0.reshape(-1)
        d = np.array(self.video.distance(ii_f, jj_f, beta=beta))
        d[ii_f - rad < jj_f] = np.inf
        d[d > 100] = np.inf
        d = d.reshape(ilen, jlen)

        # suppress around existing edges
        ii1 = np.concatenate([self.ii[self.valid],
                              np.asarray(self.ii_bad, np.int64),
                              self.ii_inac[self.valid_inac]])
        jj1 = np.concatenate([self.jj[self.valid],
                              np.asarray(self.jj_bad, np.int64),
                              self.jj_inac[self.valid_inac]])
        for i, j in zip(ii1, jj1):
            if t0 <= i < t and t1 <= j < t:
                di, dj = i - t0, j - t1
                d[max(0, di - nms):di + nms + 1,
                  max(0, dj - nms):dj + nms + 1] = np.inf

        es = []
        for i in range(t0, t):
            if self.video.stereo:
                # the stereo self-edge, and no proposal at its cell
                es.append((i, i))
                d[i - t0, i - t1] = np.inf
            for j in range(max(i - rad, 0), i):
                es.append((i, j))
                es.append((j, i))
                di, dj = i - t0, j - t1
                d[max(0, di - nms):di + nms + 1,
                  max(0, dj - nms):dj + nms + 1] = np.inf

        def accept(di, dj):
            if len(es) > self.max_factors:
                return False
            es.append((di + t0, dj + t1))
            es.append((dj + t1, di + t0))
            return True

        greedy_nms_scan(d, thresh, nms, accept)

        if es:
            ii, jj = np.asarray(es, np.int64).T
            self.add_factors(ii, jj, remove)

    # ------------------------------------------------------------------
    # shared pieces of the two update paths
    # ------------------------------------------------------------------
    def _motion_features(self, coords1, target):
        grid = projective.coords_grid(self.h8, self.w8, coords1.device)
        motion = torch.cat([coords1 - grid, target - coords1], dim=-1)
        return motion.clamp(-MOTION_CLAMP, MOTION_CLAMP)

    def _max_deg(self, ii_src) -> int:
        deg = int(np.bincount(ii_src).max()) if len(ii_src) else 1
        return bucket(deg, DEG_BUCKETS)

    def _window_ba(self, P, base, damping_w, ii_ba, jj_ba, tg, wt, ok,
                   t0, t1, iters, lm, ep, motion_only, max_deg,
                   solver="chol"):
        """DBA over window [base, base + P) of the video, in place."""
        v = self.video
        win = slice(base, base + P)
        eta = 0.2 * damping_w + EPS_DAMP
        poses_w, disps_w = dba.ba(
            v.poses[win], v.disps[win], v.intrinsics, v.disps_sens[win],
            tg, wt, eta, ii_ba, jj_ba, ok, t0 - base, t1 - base,
            iters=iters, lm=lm, ep=ep, motion_only=motion_only,
            max_deg=max_deg, solver=solver, cg_iters=CG_ITERS)
        v.poses[win] = poses_w
        v.disps[win] = disps_w
        return disps_w

    def _window_base(self, base: int, P: int) -> int:
        # the window must lie inside the buffer (JAX's dynamic_slice clamps
        # its start the same way)
        return max(0, min(base, self.video.buffer - P))

    # ------------------------------------------------------------------
    # the update step (frontend, trajectory filler)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def update(self, t0: Optional[int] = None, t1: Optional[int] = None,
               iters: int = 2, use_inactive: bool = False,
               motion_only: bool = False, ba_lm: float = 1e-4,
               ba_ep: float = 0.1):
        """One GRU/flow step + `iters` Gauss-Newton DBA iterations: the
        host bookkeeping of the JAX package's ``update`` followed by the
        device work of its ``_update_kernel``, in place."""
        if not self.valid.any():
            return
        vi, vj = self.ii[self.valid], self.jj[self.valid]
        if t0 is None:
            t0 = max(1, int(vi.min()) + 1)
        t0 = max(1, t0)
        if t1 is None:
            t1 = int(max(vi.max(), vj.max())) + 1

        if use_inactive and self.cap_inac:
            inac_ok = self.valid_inac & (self.ii_inac >= t0 - 3) & \
                (self.jj_inac >= t0 - 3)
        else:
            inac_ok = np.zeros(self.cap_inac, bool)

        lows = [vi.min(), vj.min(), t0 - 1]
        if inac_ok.any():
            lows += [self.ii_inac[inac_ok].min(), self.jj_inac[inac_ok].min()]
        base = int(min(lows))
        P = bucket(t1 - base)
        base = self._window_base(base, P)

        ii_all = np.concatenate([vi, self.ii_inac[inac_ok]])
        max_deg = self._max_deg(ii_all)

        v = self.video
        h8, w8 = self.h8, self.w8
        cdt = self.cdt
        valid = self._t(self.valid)
        ii_s = self._t(np.where(self.valid, self.ii, 0))
        jj_s = self._t(np.where(self.valid, self.jj, 0))

        coords1, _ = projective.transform(v.poses, v.disps, v.intrinsics,
                                          ii_s, jj_s)
        motion = self._motion_features(coords1, self.target)
        corr_feat = corr.lookup(self.pyramid, coords1)

        ii_local = (ii_s - base).clamp(0, P - 1)
        jj_local = (jj_s - base).clamp(0, P - 1)

        net_new, delta, w_new, eta, upmask, has_edge = self.model.update(
            self.net.to(cdt), v.inps[ii_s], corr_feat.to(cdt),
            motion.to(cdt), dtype=cdt, ii=ii_local, edge_valid=valid,
            num_frames=P)

        vm = valid[:, None, None, None]
        self.net = torch.where(vm, net_new.to(self.net.dtype), self.net)
        self.target = torch.where(vm, coords1 + delta.float(), self.target)
        self.weight = torch.where(
            vm, w_new.float() * self.model.weight_calib, self.weight)

        # damping of the window's frames that have edges
        win = slice(base, base + P)
        damping_w = torch.where(has_edge[:, None, None], eta.float(),
                                v.damping[win])
        v.damping[win] = damping_w

        if self.cap_inac:
            ii_in = self._t(self.ii_inac)
            jj_in = self._t(self.jj_inac)
            ii_ba = torch.cat([ii_local, (ii_in - base).clamp(0, P - 1)])
            jj_ba = torch.cat([jj_local, (jj_in - base).clamp(0, P - 1)])
            tg_ba = torch.cat([self.target, self.target_inac])
            wt_ba = torch.cat([self.weight, self.weight_inac])
            ok_ba = torch.cat([valid, self._t(inac_ok)])
        else:
            ii_ba, jj_ba, tg_ba, wt_ba, ok_ba = (
                ii_local, jj_local, self.target, self.weight, valid)

        disps_w = self._window_ba(P, base, damping_w, ii_ba, jj_ba, tg_ba,
                                  wt_ba, ok_ba, t0, t1, iters, ba_lm, ba_ep,
                                  motion_only, max_deg)

        if self.upsample:
            up = upsample_disp(disps_w, upmask.float())
            v.disps_up[win] = torch.where(has_edge[:, None, None], up,
                                          v.disps_up[win])

        self.age[self.valid] += 1
        v.dirty[int(vi.min()):t1] = True

    # ------------------------------------------------------------------
    # low-memory update for global BA
    # ------------------------------------------------------------------
    @torch.no_grad()
    def update_lowmem(self, t0=None, t1=None, iters=2, steps=8, max_t=None,
                      ba_type="dense", motion_only=False):
        """steps x (edge-chunked alt-corr GRU + full-window BA)."""
        if not self.valid.any():
            return
        vi, vj = self.ii[self.valid], self.jj[self.valid]
        if t0 is None:
            t0 = max(1, int(vi.min()) + 1)
        t0 = max(1, t0)
        if t1 is None:
            t1 = int(max(vi.max(), vj.max())) + 1
        t = max_t if max_t is not None else self.video.counter

        lm, ep = (1e-4, 1e-1) if ba_type == "loop" else (1e-5, 1e-2)
        # feature maps in the rig-flattened pyramid: frame k's view r is
        # map k * rig + r
        rig = self.video.rig
        Tb = bucket(min((t + 2) * rig, self.video.buffer * rig))
        P = bucket(t1)
        for _ in range(steps):
            self._lowmem_step(P, Tb, t0, t1, iters, lm, ep, motion_only)
        self.video.dirty[:t] = True

    def _lowmem_step(self, P, Tb, t0, t1, iters, lm, ep, motion_only):
        """One step, the JAX package's ``_lowmem_kernel``: alt-corr GRU
        over the edge chunks (``_gru_chunks``, updating the slabs in
        place), whole-graph GraphAgg, then DBA over frames [0, P).
        Windows of CG_MIN_POSES poses or more take the matrix-free PCG
        solver: the dense Cholesky solve dominates beyond a few hundred
        poses.  With a mesh (and not motion-only) the step is sharded:
        ``_lowmem_step_sharded``."""
        v = self.video
        max_deg = self._max_deg(self.ii[self.valid])
        if self.mesh is not None and not motion_only:
            self._lowmem_step_sharded(P, Tb, t0, t1, iters, lm, ep, max_deg)
            return
        solver = "cg" if P >= CG_MIN_POSES else "chol"

        valid_np = self.valid
        valid = self._t(valid_np)
        ii_s = self._t(np.where(valid_np, self.ii, 0))
        jj_s = self._t(np.where(valid_np, self.jj, 0))
        # each edge's maps in the pyramid: ii's left view, and jj's but for
        # a stereo self-edge, which reads the right view (invalid slots
        # read map 0, as in the JAX package)
        ii_r, jj_r = ii_s * v.rig, jj_s
        if v.stereo:
            jj_r = torch.where(valid, jj_s * v.rig + (ii_s == jj_s).long(),
                               torch.zeros_like(jj_s))

        self._gru_chunks(self.model, self._feature_pyramid(Tb), v.poses,
                         v.disps, v.intrinsics, v.inps, self.net,
                         self.target, self.weight, ii_s, jj_s, ii_r, jj_r,
                         valid, valid_np)

        ii_local = ii_s.clamp(0, P - 1)
        eta, has_frame = self._agg_head(*self._agg_segments(
            self.model, self.net, ii_local, valid, P))
        damping_w = torch.where(has_frame[:, None, None], eta,
                                v.damping[:P])
        v.damping[:P] = damping_w

        self._window_ba(P, 0, damping_w, ii_local, jj_s.clamp(0, P - 1),
                        self.target, self.weight, valid, t0, t1, iters, lm,
                        ep, motion_only, max_deg, solver=solver)

    def _lowmem_step_sharded(self, P, Tb, t0, t1, iters, lm, ep, max_deg):
        """The low-memory step with its edges sharded over the mesh, the
        JAX package's ``_lowmem_kernel_sharded``: the valid slots are
        partitioned by source frame (``partition_edge_slots``), and each
        shard gathers its slots' hidden states, targets and weights and
        runs the alt-corr GRU on them with the feature pyramid and the
        window's state replicated on its device, and the network's copy
        there (``ShardMesh.replicate_module``).  The
        GraphAgg segment sums are psum'd (every frame's edges lie on one
        shard) and the frame head runs once; DBA is ``ba_shard_gn``.  The
        shards' results are scattered back to their slots, the padding
        dropped.  DBA always solves the dense system here."""
        mesh, v, cap = self.mesh, self.video, self.cap
        home = v.device
        slot_idx = sharded_ba.partition_edge_slots(self.ii, self.valid, P,
                                                   mesh.size)
        pad_ok = slot_idx < cap
        sc = np.minimum(slot_idx, cap - 1).astype(np.int64)
        ok = pad_ok & self.valid[sc]
        ii = np.where(ok, self.ii[sc], 0)
        jj = np.where(ok, self.jj[sc], 0)
        # a stereo self-edge reads its frame's right view; padding map 0
        ii_r = ii * v.rig
        jj_r = np.where(ok, jj * v.rig + (ii == jj) * int(v.stereo), 0)

        fpyr = self._feature_pyramid(Tb)
        devs = mesh.devices
        rep = mesh.replicate
        fpyr_r = [list(levels) for levels in zip(*map(rep, fpyr))]

        def on(dev, a):
            return torch.as_tensor(a, device=dev)

        def gru(model, dev, s, levels, poses, disps, intr, inps):
            """The shard's alt-corr GRU over its slots, and its GraphAgg
            segment sums."""
            slots = torch.as_tensor(sc[s], device=home)
            net = self.net[slots].to(dev)
            target = self.target[slots].to(dev)
            weight = self.weight[slots].to(dev)
            valid = on(dev, ok[s])
            ii_s, jj_s = on(dev, ii[s]), on(dev, jj[s])
            self._gru_chunks(model, levels, poses, disps, intr, inps, net,
                             target, weight, ii_s, jj_s, on(dev, ii_r[s]),
                             on(dev, jj_r[s]), valid, ok[s])
            ii_loc = ii_s.clamp(0, P - 1)
            seg_sum, seg_cnt = self._agg_segments(model, net, ii_loc, valid,
                                                  P)
            edges = (target, weight, ii_loc, jj_s.clamp(0, P - 1), valid)
            return net, edges, seg_sum, seg_cnt

        out = mesh.map(gru, mesh.replicate_module(self.model), devs,
                       range(mesh.size), fpyr_r, rep(v.poses),
                       rep(v.disps), rep(v.intrinsics), rep(v.inps))
        seg_sum = mesh.psum([o[2] for o in out])[0].to(home)
        seg_cnt = mesh.psum([o[3] for o in out])[0].to(home)
        eta, has_frame = self._agg_head(seg_sum, seg_cnt)
        damping_w = torch.where(has_frame[:, None, None], eta,
                                v.damping[:P])
        v.damping[:P] = damping_w

        poses_w, disps_w = sharded_ba.ba_shard_gn(
            mesh, v.poses[:P], v.disps[:P], v.disps_sens[:P],
            0.2 * damping_w + EPS_DAMP, v.intrinsics, [o[1] for o in out],
            t0, t1, iters, lm, ep, max_deg)
        v.poses[:P] = poses_w
        v.disps[:P] = disps_w

        for s, (net, (target, weight, *_), _, _) in enumerate(out):
            keep = pad_ok[s]
            dst = torch.as_tensor(sc[s][keep], device=home)
            src = torch.as_tensor(np.nonzero(keep)[0], device=net.device)
            self.net[dst] = net[src].to(home)
            self.target[dst] = target[src].to(home)
            self.weight[dst] = weight[src].to(home)

    def _feature_pyramid(self, Tb):
        """The alt-corr pyramid of the first Tb rig-flattened feature maps
        (frame k's view r is map k * rig + r)."""
        v = self.video
        return corr.build_feature_pyramid(
            v.fmaps[:Tb // v.rig].reshape(-1, self.h8, self.w8, 128))

    def _gru_chunks(self, model, fpyr, poses, disps, intrinsics, inps, net,
                    target, weight, ii, jj, ii_r, jj_r, valid, valid_np):
        """The edge-chunked alt-corr GRU (the JAX package's
        ``_gru_chunk_scan``) over the slabs net/target/weight [E, ...],
        updated in place where valid: each chunk of ``self.chunk`` edges
        is reprojected, looked up in the feature pyramid fpyr and run
        through the update operator.  ii/jj are the endpoints (0 where
        invalid), ii_r/jj_r their maps in fpyr, valid_np the host's copy
        of valid: a chunk with no valid edge is skipped."""
        cdt = self.cdt
        for c0 in range(0, len(valid_np), self.chunk):
            sl = slice(c0, c0 + self.chunk)
            if not valid_np[sl].any():
                continue           # nothing to update in this chunk
            ii_ch, ok = ii[sl], valid[sl]
            coords, _ = projective.transform(poses, disps, intrinsics,
                                             ii_ch, jj[sl])
            motion = self._motion_features(coords, target[sl])
            corr_feat = corr.alt_corr(fpyr, coords, ii_r[sl], jj_r[sl])
            net_c, delta_c, w_c = model.update(
                net[sl].to(cdt), inps[ii_ch], corr_feat.to(cdt),
                motion.to(cdt), dtype=cdt)
            okm = ok[:, None, None, None]
            net[sl] = torch.where(okm, net_c.to(net.dtype), net[sl])
            target[sl] = torch.where(okm, coords + delta_c.float(),
                                     target[sl])
            weight[sl] = torch.where(
                okm, w_c.float() * model.weight_calib, weight[sl])

    def _agg_segments(self, model, nets, ii_loc, valid, P):
        """GraphAgg's edge side over the slab nets [E, h8, w8, 128]: every
        edge's final hidden state through the edge-side conv, summed in
        fp32 per source frame, and the edge count per frame.  Returns
        (seg_sum [P, h8, w8, 128], seg_cnt [P])."""
        agg = model.update.agg
        okf = valid.float()
        seg_sum = torch.zeros((P, self.h8, self.w8, 128), dtype=torch.float32,
                              device=okf.device)
        seg_cnt = torch.zeros((P,), dtype=torch.float32,
                              device=okf.device).index_add_(0, ii_loc, okf)
        for s0 in range(0, nets.shape[0], AGG_BLOCK):
            sl = slice(s0, s0 + AGG_BLOCK)
            ef = agg.edge_features(nets[sl].to(self.cdt), self.cdt)
            seg_sum.index_add_(0, ii_loc[sl],
                               ef.float() * okf[sl][:, None, None, None])
        return seg_sum, seg_cnt

    def _agg_head(self, seg_sum, seg_cnt):
        """Whole-graph GraphAgg's frame side: the segment mean through the
        frame head, once.  Returns (eta [P,h8,w8] fp32, has_edge [P])."""
        mean = seg_sum / seg_cnt.clamp(min=1.0)[:, None, None, None]
        eta, _ = self.model.update.agg.frame_head(mean, want_upmask=False)
        return eta.float(), seg_cnt > 0
