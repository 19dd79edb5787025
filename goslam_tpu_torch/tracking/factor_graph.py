"""Factor graph over keyframes: fixed-capacity edge slots on one device.

Host (numpy): edge bookkeeping -- endpoints, age, slot allocation, dedup,
eviction, edge proposal (``proposal.propose_edges``).  Device (torch):
per-edge GRU hidden state, flow targets and weights, correlation
pyramids, and the update step: reproject -> motion features ->
correlation -> update operator -> DBA.

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

Slots are updated in place.  Both steps run their per-edge work
(reprojection, correlation lookup, update operator; and in the
low-memory step GraphAgg's edge side) over a bucket of B slots that
holds every live slot, ``B = bucket(live edges)``: the live slots,
padded with invalid ones (``_bucket_slots``), read from the slabs and
the volumes in place and written back where valid.  Their DBA runs over
every slot (and the archive), masked by validity.  So results do not
depend on which slots are free.

The update step's device work has static shapes: B edge slots, every
slot in its DBA, and a window of P frames read and written at ``base +
arange(P)``, ``base`` a device scalar.  Its kernels and shapes depend
only on the key (P, B, the degree bucket, iters, motion_only,
use_inactive, lm, ep); everything else is data -- which slots the
bucket holds among them -- which the host stages in one pinned buffer
and copies to the device at once.  The step writes its results into the
graph's and the video's own tensors.  So on CUDA a key seen once before
is captured into a ``torch.cuda.CUDAGraph`` and replayed from then on:
one launch instead of the step's few hundred.  The first sighting of a
key runs eagerly, which warms the libraries and the allocator; the CPU
always runs eagerly, through the same function.

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
from ..utils import trace
from ..utils.shapes import bucket
from .proposal import propose_edges
from .video import VideoBuffer

EPS_DAMP = 1e-7
MOTION_CLAMP = 64.0
DEG_BUCKETS = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128)
# edges per GraphAgg block in the global aggregation (bounds the
# [block, h8, w8, 128] fp32 transient)
AGG_BLOCK = 3072
# edges per chunk of the low-memory step's alt-corr GRU, at most (bounds
# the update operator's transient)
GRU_CHUNK = 256
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
                 inac_capacity: int = 0,
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

        # the update step's input buffers and CUDA graphs, made at its first
        # call (``_stage``)
        self._steps: Optional[_StepGraphs] = None

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

    def seed_live_edges(self, other: "FactorGraph"):
        """Copy the live edges of ``other`` into this graph's first slots:
        endpoints, ages and validity on the host, hidden states, targets
        and weights on the device."""
        sel = np.flatnonzero(other.valid)
        n = len(sel)
        self.ii[:n] = other.ii[sel]
        self.jj[:n] = other.jj[sel]
        self.age[:n] = other.age[sel]
        self.valid[:n] = True
        src = self._t(sel)
        self.net[:n] = other.net[src]
        self.target[:n] = other.target[src]
        self.weight[:n] = other.weight[src]

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
        """``proposal.propose_edges`` with rows [t0, t), columns [t1, t)
        (t the video's counter) and near pairs from frame 0 on, suppressed
        around the live and archived edges; the edges are added in the
        order proposed.  The threshold is ``thresh`` rounded to float32,
        the distances' dtype, and at most 100, the frontend's cap."""
        t = self.video.counter
        if t <= t0 or t <= t1:
            return
        ok, ok_in = self.valid, self.valid_inac
        taken = [*zip(self.ii[ok], self.jj[ok]),
                 *zip(self.ii_inac[ok_in], self.jj_inac[ok_in])]
        es, _ = propose_edges(self.video, t0, t1, t, rad, nms,
                              min(float(np.float32(thresh)), 100.0),
                              self.max_factors, beta, loop=False,
                              near_from=0, suppress=taken)
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

    def _max_deg(self, ii_local):
        """(deg, its bucket): the most valid edges of one source frame,
        from the window-local source indices of the valid edges as DBA
        will count them, and the degree table's capacity."""
        deg = int(np.bincount(ii_local).max()) if len(ii_local) else 0
        return deg, bucket(max(deg, 1), DEG_BUCKETS)

    def _window_ba(self, win, damping_w, ii_ba, jj_ba, tg, wt, ok, t0, t1,
                   iters, lm, ep, motion_only, max_deg, deg, solver="chol"):
        """DBA over the window of the video at frames ``win`` (a [P] index
        on the device; t0/t1 window-local), in place."""
        v = self.video
        eta = 0.2 * damping_w + EPS_DAMP
        poses_w, disps_w = dba.ba(
            v.poses.index_select(0, win), v.disps.index_select(0, win),
            v.intrinsics, v.disps_sens.index_select(0, win), tg, wt, eta,
            ii_ba, jj_ba, ok, t0, t1, iters=iters, lm=lm, ep=ep,
            motion_only=motion_only, max_deg=max_deg, solver=solver,
            cg_iters=CG_ITERS, deg=deg)
        v.poses.index_copy_(0, win, poses_w)
        v.disps.index_copy_(0, win, disps_w)
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
        n = self.n_edges()
        if not n:
            return
        # the update operator's slots: a bucket that holds every live one
        # (cap is a bucket too, so B <= cap)
        B = bucket(n)
        if trace.ON:
            trace.add("update.calls")
            trace.add("update.edges", n)
            trace.add("update.slots", B)
        with trace.span("slam.update"):
            self._update(t0, t1, iters, use_inactive, motion_only, ba_lm,
                         ba_ep, B)

    def _update(self, t0, t1, iters, use_inactive, motion_only, ba_lm,
                ba_ep, B):
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
        deg, max_deg = self._max_deg(np.clip(ii_all - base, 0, P - 1))

        self._stage(inac_ok, base, t0, t1, B)
        self._steps.run((P, B, max_deg, iters, motion_only, use_inactive,
                         ba_lm, ba_ep),
                        lambda: self._step(P, B, iters, motion_only, ba_lm,
                                           ba_ep, max_deg, deg))
        self.age[self.valid] += 1
        self.video.dirty[int(vi.min()):t1] = True

    def _stage(self, inac_ok, base: int, t0: int, t1: int, B: int):
        """Write what the step reads into the host staging buffer and copy
        it to the device buffer ``_steps.inputs`` in one copy: every
        slot's validity and endpoints, the archive's, the bucket's B
        slots (``_slot_list``) and the window."""
        cap, ci = self.cap, self.cap_inac
        if self._steps is None:
            self._steps = _StepGraphs(4 * cap + 3 * ci + 3,
                                      self.video.device)
        s = self._steps.staging()
        s[:cap] = self.valid
        s[cap:2 * cap] = np.where(self.valid, self.ii, 0)
        s[2 * cap:3 * cap] = np.where(self.valid, self.jj, 0)
        o = 3 * cap
        s[o:o + ci] = self.ii_inac
        s[o + ci:o + 2 * ci] = self.jj_inac
        s[o + 2 * ci:o + 3 * ci] = inac_ok
        o += 3 * ci
        s[o:o + B] = self._bucket_slots(B)
        s[-3:] = (base, t0, t1)
        self._steps.upload()

    def _bucket_slots(self, B: int) -> np.ndarray:
        """The B slots a step runs its per-edge work over: the live slots
        in slot order, then distinct invalid ones (B is at least the live
        count and at most cap, so there are enough)."""
        live = np.flatnonzero(self.valid)
        return np.concatenate(
            [live, np.flatnonzero(~self.valid)[:B - len(live)]])

    def _slot_list(self, B: int) -> torch.Tensor:
        """The bucket's B slots on the device, as ``_stage`` wrote them."""
        o = 3 * self.cap + 3 * self.cap_inac
        return self._steps.inputs[o:o + B]

    def _step(self, P, B, iters, motion_only, lm, ep, max_deg, deg):
        """The step's device work, reading its edges and window from the
        device buffer ``_steps.inputs`` and writing its results in place:
        the slabs net/target/weight at the bucket's valid slots, and the
        video's poses, disparities, damping and upsampled disparities of
        the window."""
        v = self.video
        cap, ci, cdt = self.cap, self.cap_inac, self.cdt
        x = self._steps.inputs
        valid = x[:cap] != 0
        ii_s, jj_s = x[cap:2 * cap], x[2 * cap:3 * cap]
        base, t0, t1 = x[-3], x[-2], x[-1]
        win = base + torch.arange(P, device=x.device)

        # the per-edge work over the bucket's slots
        slots = self._slot_list(B)
        ok = valid[slots]
        ii_b, jj_b = ii_s[slots], jj_s[slots]
        net_b, target_b = self.net[slots], self.target[slots]
        coords1, _ = projective.transform(v.poses, v.disps, v.intrinsics,
                                          ii_b, jj_b)
        motion = self._motion_features(coords1, target_b)
        corr_feat = corr.lookup(self.pyramid, coords1, slots=slots)

        net_new, delta, w_new, eta, upmask, has_edge = self.model.update(
            net_b.to(cdt), v.inps[ii_b], corr_feat.to(cdt),
            motion.to(cdt), dtype=cdt, ii=(ii_b - base).clamp(0, P - 1),
            edge_valid=ok, num_frames=P)

        okm = ok[:, None, None, None]
        self.net.index_copy_(0, slots, torch.where(
            okm, net_new.to(self.net.dtype), net_b))
        self.target.index_copy_(0, slots, torch.where(
            okm, coords1 + delta.float(), target_b))
        self.weight.index_copy_(0, slots, torch.where(
            okm, w_new.float() * self.model.weight_calib, self.weight[slots]))

        # damping of the window's frames that have edges
        has = has_edge[:, None, None]
        damping_w = torch.where(has, eta.float(),
                                v.damping.index_select(0, win))
        v.damping.index_copy_(0, win, damping_w)

        ii_local = (ii_s - base).clamp(0, P - 1)
        jj_local = (jj_s - base).clamp(0, P - 1)
        if ci:
            o = 3 * cap
            ii_in, jj_in = x[o:o + ci], x[o + ci:o + 2 * ci]
            ii_ba = torch.cat([ii_local, (ii_in - base).clamp(0, P - 1)])
            jj_ba = torch.cat([jj_local, (jj_in - base).clamp(0, P - 1)])
            tg_ba = torch.cat([self.target, self.target_inac])
            wt_ba = torch.cat([self.weight, self.weight_inac])
            ok_ba = torch.cat([valid, x[o + 2 * ci:o + 3 * ci] != 0])
        else:
            ii_ba, jj_ba, tg_ba, wt_ba, ok_ba = (
                ii_local, jj_local, self.target, self.weight, valid)

        disps_w = self._window_ba(win, damping_w, ii_ba, jj_ba, tg_ba, wt_ba,
                                  ok_ba, t0 - base, t1 - base, iters, lm, ep,
                                  motion_only, max_deg, deg)

        if self.upsample:
            up = upsample_disp(disps_w, upmask.float())
            v.disps_up.index_copy_(0, win, torch.where(
                has, up, v.disps_up.index_select(0, win)))

    # ------------------------------------------------------------------
    # low-memory update for global BA
    # ------------------------------------------------------------------
    @torch.no_grad()
    def update_lowmem(self, t0=None, t1=None, iters=2, steps=8, max_t=None,
                      ba_type="dense", motion_only=False):
        """steps x (alt-corr GRU over the live edges' bucket + full-window
        BA)."""
        n = self.n_edges()
        if not n:
            return
        if trace.ON:
            trace.add("update_lowmem.calls")
            trace.add("update_lowmem.edges", n)
            trace.add("update_lowmem.steps", steps)
        with trace.span("slam.update_lowmem"):
            self._update_lowmem(t0, t1, iters, steps, max_t, ba_type,
                                motion_only, n)

    def _update_lowmem(self, t0, t1, iters, steps, max_t, ba_type,
                       motion_only, n):
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
        # the edge set is the same at every step
        deg, max_deg = self._max_deg(np.clip(vi, 0, P - 1))
        if self.mesh is not None and not motion_only:
            for _ in range(steps):
                self._lowmem_step_sharded(P, Tb, t0, t1, iters, lm, ep,
                                          max_deg)
        else:
            # the per-edge work's slots: a bucket that holds every live one
            # (cap is a bucket too, so B <= cap)
            B = bucket(n)
            trace.add("update_lowmem.slots", B * steps)
            edges = self._lowmem_edges(B)
            for _ in range(steps):
                self._lowmem_step(edges, P, Tb, t0, t1, iters, lm, ep,
                                  motion_only, max_deg, deg)
        self.video.dirty[:t] = True

    def _lowmem_edges(self, B: int):
        """The low-memory step's edges on the device, from one upload:
        every slot's validity and endpoints (0 where invalid), and the
        bucket's B slots (``_bucket_slots``) with the bucket's validity on
        the host."""
        cap = self.cap
        slots = self._bucket_slots(B)
        x = self._t(np.concatenate([
            self.valid, np.where(self.valid, self.ii, 0),
            np.where(self.valid, self.jj, 0), slots]))
        return (x[:cap] != 0, x[cap:2 * cap], x[2 * cap:3 * cap],
                x[3 * cap:], self.valid[slots])

    def _lowmem_step(self, edges, P, Tb, t0, t1, iters, lm, ep, motion_only,
                     max_deg, deg):
        """One step, the JAX package's ``_lowmem_kernel``: alt-corr GRU
        over the bucket's slots (``_gru_chunks``, updating the slabs in
        place where valid), GraphAgg over the same slots, then DBA over
        every slot and frames [0, P).  Windows of CG_MIN_POSES poses or
        more take the matrix-free PCG solver: the dense Cholesky solve
        dominates beyond a few hundred poses."""
        v = self.video
        solver = "cg" if P >= CG_MIN_POSES else "chol"
        valid, ii_s, jj_s, slots, ok_np = edges

        # each edge's maps in the pyramid: ii's left view, and jj's but for
        # a stereo self-edge, which reads the right view (invalid slots
        # read map 0, as in the JAX package)
        ok, ii_b, jj_b = valid[slots], ii_s[slots], jj_s[slots]
        ii_r, jj_r = ii_b * v.rig, jj_b
        if v.stereo:
            jj_r = torch.where(ok, jj_b * v.rig + (ii_b == jj_b).long(),
                               torch.zeros_like(jj_b))

        self._gru_chunks(self.model, self._feature_pyramid(Tb), v.poses,
                         v.disps, v.intrinsics, v.inps, self.net,
                         self.target, self.weight, ii_b, jj_b, ii_r, jj_r,
                         ok, ok_np, slots)

        eta, has_frame = self._agg_head(*self._agg_segments(
            self.model, self.net[slots], ii_b.clamp(0, P - 1), ok, P))
        damping_w = torch.where(has_frame[:, None, None], eta,
                                v.damping[:P])
        v.damping[:P] = damping_w

        self._window_ba(torch.arange(P, device=v.device), damping_w,
                        ii_s.clamp(0, P - 1), jj_s.clamp(0, P - 1),
                        self.target, self.weight, valid, t0, t1, iters, lm,
                        ep, motion_only, max_deg, deg, solver=solver)

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
                    target, weight, ii, jj, ii_r, jj_r, valid, valid_np,
                    slots=None):
        """The edge-chunked alt-corr GRU (the JAX package's
        ``_gru_chunk_scan``) over the slots ``slots`` [S] of the slabs
        net/target/weight (every slot if None), updated in place where
        valid: each chunk of at most GRU_CHUNK of the slots is
        reprojected, looked up in the feature pyramid fpyr and run through
        the update operator.  ii/jj [S] are the slots' endpoints (0 where
        invalid), ii_r/jj_r their maps in fpyr, valid_np the host's copy
        of valid: a chunk with no valid edge is skipped."""
        cdt = self.cdt
        if slots is None:
            slots = torch.arange(len(valid_np), device=net.device)
        for c0 in range(0, len(valid_np), GRU_CHUNK):
            sl = slice(c0, c0 + GRU_CHUNK)
            if not valid_np[sl].any():
                continue           # nothing to update in this chunk
            s, ii_ch, ok = slots[sl], ii[sl], valid[sl]
            net_s, target_s = net[s], target[s]
            coords, _ = projective.transform(poses, disps, intrinsics,
                                             ii_ch, jj[sl])
            motion = self._motion_features(coords, target_s)
            corr_feat = corr.alt_corr(fpyr, coords, ii_r[sl], jj_r[sl])
            net_c, delta_c, w_c = model.update(
                net_s.to(cdt), inps[ii_ch], corr_feat.to(cdt),
                motion.to(cdt), dtype=cdt)
            okm = ok[:, None, None, None]
            net.index_copy_(0, s, torch.where(okm, net_c.to(net.dtype),
                                              net_s))
            target.index_copy_(0, s, torch.where(
                okm, coords + delta_c.float(), target_s))
            weight.index_copy_(0, s, torch.where(
                okm, w_c.float() * model.weight_calib, weight[s]))

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


class _StepGraphs:
    """A FactorGraph's update step as inputs staged in one buffer and, on
    CUDA, CUDA graphs by shape key.

    The host writes the step's inputs into ``staging()`` (pinned on
    CUDA) and ``upload()`` copies them into the device buffer ``inputs``
    without a synchronize; before handing the staging buffer out again
    the host waits for the last copy out of it (an event), which the
    stream runs after the step that read the copy before it.  ``run``
    runs a step eagerly at its key's first sighting, and always off
    CUDA; captures it into a CUDA graph at the second sighting; and
    replays it from then on (the capture only records, so the step then
    runs by replay too).  Every graph allocates from one pool: they run
    one at a time on one stream, and each leaves its results in the
    caller's persistent tensors, never in the pool.  The kernel launches
    a capture records are counted at each replay, not at the capture,
    which launches nothing (``trace.launches``)."""

    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self._staging = torch.zeros(n, dtype=torch.int64,
                                    pin_memory=self.cuda)
        self.inputs = torch.zeros(n, dtype=torch.int64, device=device)
        self._copied = torch.cuda.Event() if self.cuda else None
        self.graphs: dict = {}     # key -> (CUDAGraph, launches it makes)
        self.seen: set = set()     # keys run once eagerly
        self._pool = None
        self._stream = None

    def staging(self) -> np.ndarray:
        if self._copied is not None:
            self._copied.synchronize()
        return self._staging.numpy()

    def upload(self):
        self.inputs.copy_(self._staging, non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def run(self, key, step):
        entry = self.graphs.get(key)
        if entry is None and key in self.seen:
            before = trace.launches()
            graph = self._capture(step)
            made = {k: n - before.get(k, 0)
                    for k, n in trace.launches().items()
                    if n != before.get(k, 0)}
            trace.count_launches(made, -1)
            entry = self.graphs[key] = (graph, made)
            trace.add("update.captures")
        if entry is None:
            step()
            if self.cuda:
                self.seen.add(key)
        else:
            entry[0].replay()
            trace.count_launches(entry[1])
        trace.add("update.replays", int(entry is not None))

    def _capture(self, step) -> torch.cuda.CUDAGraph:
        """``step()`` captured into a new CUDA graph on a side stream."""
        dev = self.inputs.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if not self.graphs:
            # a pool lives as long as a graph holds it
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        side, cur = self._stream, torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool)
            try:
                step()
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        return graph
