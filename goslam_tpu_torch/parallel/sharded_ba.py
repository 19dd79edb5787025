"""Dense bundle adjustment sharded over the edges of a ``ShardMesh``.

Each shard builds the per-edge normal equations of its own edges (the
edge-system kernel ``csrc/edge_system.cu`` on CUDA tensors, through
``dba.build_edge_system``) and assembles its partial reduced system; the
partial Hessians, right-hand sides and depth sums are combined with the
mesh's fixed-order ``psum``, and the reduced system is solved once with
the dense damped Cholesky of ``dba`` (a failed factorization gives
dx = 0, as in ``dba.ba``).  The sharded path always solves the dense
system, at any window size, as the JAX package's does.

The Schur complement has a term for every pair of edges that leave the
same frame, so every such pair must lie on one shard: edges are
partitioned by contiguous blocks of source frames, and each shard's
source table covers its own frames alone.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import dba, lie
from ..utils.shapes import bucket
from . import ShardMesh


def _shard_of(ii: np.ndarray, n_frames: int, n_shards: int) -> np.ndarray:
    block = (n_frames + n_shards - 1) // n_shards
    return np.clip(ii // block, 0, n_shards - 1)


def partition_edges_by_source(ii, jj, valid, n_frames: int, n_shards: int):
    """Assign the valid edges to shards by contiguous source-frame blocks.

    Returns (ii_s, jj_s, valid_s), int32/int32/bool arrays of shape
    [n_shards, cap] with per-shard padding, such that all edges with the
    same ii land on the same shard; cap is the bucket of the largest
    shard's edge count (at least 1)."""
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    valid = np.asarray(valid, bool)
    shard_of = _shard_of(ii, n_frames, n_shards)
    counts = [int(((shard_of == s) & valid).sum()) for s in range(n_shards)]
    cap = bucket(max(max(counts), 1))

    ii_s = np.zeros((n_shards, cap), np.int32)
    jj_s = np.zeros((n_shards, cap), np.int32)
    ok_s = np.zeros((n_shards, cap), bool)
    for s in range(n_shards):
        sel = np.where((shard_of == s) & valid)[0]
        ii_s[s, :len(sel)] = ii[sel]
        jj_s[s, :len(sel)] = jj[sel]
        ok_s[s, :len(sel)] = True
    return ii_s, jj_s, ok_s


def partition_edge_slots(ii, valid, n_frames: int, n_shards: int):
    """Assign edge SLOTS to shards by contiguous source-frame blocks: the
    indices into the cap-length edge arrays of each shard's valid edges,
    for gathering the per-edge device state (hidden state, target,
    weight) into shard layout and scattering the results back.

    Returns slot_idx [n_shards, Es] int32, padded with cap (out of
    bounds: a gather there is masked, a scatter there dropped).  Slot
    order is kept within each shard, so per-frame sums add in the order
    of the single-device path."""
    ii = np.asarray(ii)
    valid = np.asarray(valid, bool)
    cap = len(ii)
    shard_of = _shard_of(ii, n_frames, n_shards)
    counts = [int(((shard_of == s) & valid).sum()) for s in range(n_shards)]
    Es = bucket(max(max(counts), 1))
    slot_idx = np.full((n_shards, Es), cap, np.int32)
    for s in range(n_shards):
        sel = np.where((shard_of == s) & valid)[0]
        slot_idx[s, :len(sel)] = sel
    return slot_idx


def ba_shard_gn(mesh: ShardMesh, poses, disps, disps_sens, eta, intrinsics,
                edges, t0: int, t1: int, iters: int, lm: float, ep: float,
                max_deg: int):
    """`iters` Gauss-Newton steps of dense BA with the edge work sharded.

    poses [P, 7], disps/disps_sens/eta [P, ht, wd] and intrinsics [4] are
    replicated (given on one device, copied to each shard's); edges holds
    each shard's (target, weight [Es, ht, wd, 2], ii, jj [Es] int64
    window-local, valid [Es] bool) on that shard's device, all edges that
    leave one frame on one shard.  Poses in [t0, t1) are optimized.
    Returns (poses, disps) on the device of the given poses.  A source
    table overflow (a degree past max_deg) poisons both with NaN, as in
    ``dba.ba``."""
    home = poses.device
    f32 = torch.float32
    P = poses.shape[0]
    ht, wd = disps.shape[-2:]
    hw, P6 = ht * wd, P * 6
    devs = mesh.devices

    frames = torch.arange(P, device=home)
    pose_mask = (frames >= t0) & (frames < t1)
    pm_f = pose_mask.to(f32)
    sens_flat = disps_sens.reshape(P, hw)
    m = (sens_flat > 0).to(f32)
    eta_flat = eta.reshape(P, hw)
    intr_r = mesh.replicate(intrinsics)
    pm_r = mesh.replicate(pm_f)

    def plan(dev, pm, edge):
        """What stays fixed over the steps: the pose-mask gates, the flat
        indices of the 6x6 blocks, the source table."""
        _, _, ii, jj, valid = edge
        table, overflow = dba._source_table(ii, valid, P, max_deg)
        src = torch.zeros(P, device=dev).index_add_(0, ii, valid.to(f32))
        fr = torch.arange(P, device=dev)
        pj = jj[table.clamp(min=0)]
        return dict(
            gi=pm[ii], gj=pm[jj], tbl_ok=table >= 0,
            tbl_idx=table.clamp(min=0), overflow=overflow, src=src,
            idx_ii=dba._block_index(ii, ii, P6).reshape(-1),
            idx_ij=dba._block_index(ii, jj, P6).reshape(-1),
            idx_ji=dba._block_index(jj, ii, P6).reshape(-1),
            idx_jj=dba._block_index(jj, jj, P6).reshape(-1),
            idx_kk=dba._block_index(fr, fr, P6).reshape(-1),
            idx_pp=dba._block_index(pj[:, :, None], pj[:, None, :],
                                    P6).reshape(-1))

    plans = mesh.map(plan, devs, pm_r, edges)
    # a frame's depth is eliminated when it is optimized or is the source
    # of a valid edge on any shard
    kx_mask = pose_mask | (mesh.psum([p["src"] for p in plans])[0]
                           .to(home) > 0)

    def system(dev, p, edge, poses_s, disps_s, intr):
        """The shard's edge system and its sums over source frames of the
        depth blocks."""
        tw, ww, ii, jj, valid = edge
        sys = dba.build_edge_system(poses_s, disps_s, intr, tw, ww, ii, jj,
                                    valid)
        Cacc = torch.zeros((P, hw), dtype=f32, device=dev).index_add_(
            0, ii, sys.Cii)
        wacc = torch.zeros((P, hw), dtype=f32, device=dev).index_add_(
            0, ii, sys.bz)
        return sys, Cacc, wacc

    def reduced(dev, p, edge, sys, pm, Q, w_rhs):
        """The shard's partial reduced system: its pose-pair blocks minus
        its part of E Q E^T (flat [6P * 6P]), its part of the rhs
        v - E Q w, and what the back-substitution needs."""
        _, _, ii, jj, _ = edge
        gi, gj = p["gi"], p["gj"]
        L = torch.zeros(P6 * P6, dtype=f32, device=dev)
        L.index_add_(0, p["idx_ii"],
                     (sys.H[:, :6, :6] * gi[:, None, None]).reshape(-1))
        L.index_add_(0, p["idx_ij"], (sys.H[:, :6, 6:]
                                      * (gi * gj)[:, None, None]).reshape(-1))
        L.index_add_(0, p["idx_ji"], (sys.H[:, 6:, :6]
                                      * (gj * gi)[:, None, None]).reshape(-1))
        L.index_add_(0, p["idx_jj"],
                     (sys.H[:, 6:, 6:] * gj[:, None, None]).reshape(-1))
        b = torch.zeros((P, 6), dtype=f32, device=dev)
        b.index_add_(0, ii, sys.v[:, :6] * gi[:, None])
        b.index_add_(0, jj, sys.v[:, 6:] * gj[:, None])

        # the depth rows of pose k, complete on the shard that owns k's
        # edges and zero elsewhere
        Ei = torch.zeros((P, 6, hw), dtype=f32, device=dev).index_add_(
            0, ii, sys.Eii) * pm[:, None, None]
        Eij_m = sys.Eij * gj[:, None, None]
        Skk = torch.einsum("kah,kbh->kab", Ei * Q[:, None], Ei)
        L.index_add_(0, p["idx_kk"], -Skk.reshape(-1))
        Sx = torch.einsum("eah,ebh->eab", Ei[ii] * Q[ii][:, None], Eij_m)
        L.index_add_(0, p["idx_ij"], -Sx.reshape(-1))
        L.index_add_(0, p["idx_ji"], -Sx.transpose(-1, -2).reshape(-1))
        G = Eij_m[p["tbl_idx"]] * p["tbl_ok"][..., None, None]
        Spp = torch.einsum("kdah,kebh->kdeab", G * Q[:, None, None], G)
        okrc = (p["tbl_ok"][:, :, None] & p["tbl_ok"][:, None, :]).to(f32)
        L.index_add_(0, p["idx_pp"],
                     (-Spp * okrc[..., None, None]).reshape(-1))

        bs = torch.einsum("kah,kh->ka", Ei, Q * w_rhs)
        bx = torch.einsum("eah,eh->ea", Eij_m, (Q * w_rhs)[ii])
        rf = b - bs - torch.zeros((P, 6), dtype=f32,
                                  device=dev).index_add_(0, jj, bx)
        return L, rf, Ei, Eij_m

    def back(dev, edge, red, dx):
        """The shard's part of E^T dx."""
        _, _, ii, jj, _ = edge
        _, _, Ei, Eij_m = red
        dw = torch.einsum("kah,ka->kh", Ei, dx)
        return dw.index_add(0, ii, torch.einsum("eah,ea->eh", Eij_m,
                                                dx[jj]))

    for _ in range(iters):
        parts = mesh.map(system, devs, plans, edges, mesh.replicate(poses),
                         mesh.replicate(disps), intr_r)
        Cacc = mesh.psum([c for _, c, _ in parts])[0].to(home)
        wacc = mesh.psum([w for _, _, w in parts])[0].to(home)
        C = Cacc + m * dba.ALPHA_RGBD + (1.0 - m) * eta_flat
        w_rhs = wacc - m * dba.ALPHA_RGBD * (disps.reshape(P, hw)
                                              - sens_flat)
        Q = kx_mask[:, None].to(f32) / C.clamp(min=1e-12)

        red = mesh.map(reduced, devs, plans, edges, [s for s, _, _ in parts],
                       pm_r, mesh.replicate(Q), mesh.replicate(w_rhs))
        L = mesh.psum([r[0] for r in red])[0].to(home)
        rf = mesh.psum([r[1] for r in red])[0].to(home)
        dx = dba._dense_solve(rf, L, pm_f, lm, ep)
        poses = lie.retr(poses, dx)

        dw = mesh.psum(mesh.map(back, devs, edges, red,
                                mesh.replicate(dx)))[0].to(home)
        dz = Q * (w_rhs - dw)
        disps = (disps + dz.reshape(P, ht, wd)).clamp(min=dba.DISP_MIN)

    overflow = mesh.psum([p["overflow"] for p in plans])[0].to(home)
    nan = torch.tensor(float("nan"), device=home)
    bad = overflow > 0
    return torch.where(bad, nan, poses), torch.where(bad, nan, disps)


def ba_sharded(mesh: ShardMesh, poses, disps, intrinsics, disps_sens,
               target, weight, eta, ii_s, jj_s, valid_s, t0: int, t1: int,
               iters: int = 2, lm: float = 1e-4, ep: float = 0.1,
               max_deg: int = 24):
    """Sharded full BA: the arguments of ``dba.ba`` but the edge arrays
    carry a leading shard dimension (``partition_edges_by_source``):
    target/weight [S, Es, ht, wd, 2]; ii_s/jj_s/valid_s [S, Es] (numpy or
    tensors).  Poses, disparities, eta and intrinsics are replicated.
    Returns (poses, disps) on the device of the given poses."""
    ii_s = torch.as_tensor(np.asarray(ii_s), dtype=torch.long)
    jj_s = torch.as_tensor(np.asarray(jj_s), dtype=torch.long)
    valid_s = torch.as_tensor(np.asarray(valid_s), dtype=torch.bool)
    if bool(valid_s.any()):
        deg = int(torch.bincount(ii_s[valid_s]).max())
        if deg > max_deg:
            raise ValueError(
                f"per-source edge degree {deg} exceeds the table capacity "
                f"max_deg={max_deg}")
    edges = [tuple(a[s].to(dev).contiguous() for a in (
        target, weight, ii_s, jj_s, valid_s))
        for s, dev in enumerate(mesh.devices)]
    return ba_shard_gn(mesh, poses, disps, disps_sens, eta, intrinsics,
                       edges, t0, t1, iters, lm, ep, max_deg)
