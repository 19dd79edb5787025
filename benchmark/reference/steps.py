"""The tracking steps, plain, from captured state.

Each function takes the state a step of the program started from (a
dict of tensors and host arrays that ``harness/check.py`` captured) and
returns what the step should produce, computed with ``net.Net``:

  motion_filter  the filter's encoders of the new frame and its one
                 update iteration at zero flow against the last keyframe
  update         one frontend step (FactorGraph.update): reproject,
                 correlation lookup, update operator, GraphAgg, then
                 `iters` Gauss-Newton iterations of DBA over the window
  lowmem         global BA's `steps` low-memory steps
                 (FactorGraph.update_lowmem): each the update operator
                 over every edge with on-the-fly correlation, GraphAgg
                 over the whole graph, DBA over frames [0, P)
"""
from __future__ import annotations

import torch

from . import corr, dba, geom

MOTION_CLAMP = 64.0
EPS_DAMP = 1e-7
GRU_BLOCK = 64
# the window sizes the program pads to (its utils/shapes.py buckets)
BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
           1536, 2048, 3072, 4096)


def bucket(n: int) -> int:
    return next(b for b in BUCKETS if b >= n)


def motion_filter(net, s):
    """s: image [rig, ht, wd, 3], fmap [rig, h8, w8, 128] (the last
    keyframe's), net/inp [1, h8, w8, 128].  -> fnet [rig, ...], cnet
    [1, h8, w8, 256] before its activations, delta [1, h8, w8, 2]."""
    gmap = net.encoder("fnet", s["image"])
    cnet = net.encoder("cnet", s["image"][:1])
    h8, w8 = gmap.shape[1:3]
    coords0 = geom.coords_grid(h8, w8, gmap.device)[None]
    c = corr.lookup(s["fmap"][:1], gmap[:1], coords0)
    flow = torch.zeros(c.shape[:-1] + (4,), device=c.device)
    _, delta, _ = net.update(s["net"], s["inp"], c, flow)
    return {"fnet": gmap, "cnet": cnet, "delta": delta}


def _gru(net, s, poses, disps, ii, jj, jview, hidden, target):
    """The update operator over edges (ii -> jj) in blocks: returns
    (hidden, target = coords + delta, weight, coords)."""
    outs = []
    v = s["video"]
    for b in range(0, ii.shape[0], GRU_BLOCK):
        i, j = ii[b:b + GRU_BLOCK], jj[b:b + GRU_BLOCK]
        coords = geom.transform(poses, disps, v["intrinsics"], i, j)
        grid = geom.coords_grid(coords.shape[1], coords.shape[2],
                                coords.device)
        motion = torch.cat([coords - grid, target[b:b + GRU_BLOCK] - coords],
                           dim=-1).clamp(-MOTION_CLAMP, MOTION_CLAMP)
        c = corr.lookup(v["fmaps"][i, 0],
                        v["fmaps"][j, jview[b:b + GRU_BLOCK]], coords)
        h, delta, w = net.update(hidden[b:b + GRU_BLOCK], v["inps"][i], c,
                                 motion)
        outs.append((h, coords + delta, w * s["weight_calib"], coords))
    return [torch.cat(x) for x in zip(*outs)]


def _eta(net, hidden, ii_loc, P):
    """GraphAgg: the edges' features averaged per source frame, through
    the frame head.  -> (eta [P, h8, w8], has_edge [P])."""
    feats = torch.cat([net.edge_features(hidden[b:b + GRU_BLOCK])
                       for b in range(0, hidden.shape[0], GRU_BLOCK)])
    seg = torch.zeros((P,) + feats.shape[1:], device=feats.device)
    seg.index_add_(0, ii_loc, feats)
    cnt = torch.zeros(P, device=feats.device).index_add_(
        0, ii_loc, torch.ones_like(ii_loc, dtype=torch.float32))
    return net.frame_head(seg / cnt.clamp(min=1.0)[:, None, None, None]), \
        cnt > 0


def _jview(s, ii, jj):
    """Which view of jj an edge reads: the right one for a stereo
    self-edge."""
    if s["video"]["stereo"]:
        return (ii == jj).long()
    return torch.zeros_like(jj)


def window(s):
    """The frontend step's frames: (t0, t1, base, P, inactive edges in
    the DBA), as FactorGraph.update picks them."""
    g, v, a = s["graph"], s["video"], s["args"]
    valid = g["valid"]
    vi, vj = g["ii"][valid], g["jj"][valid]
    t0 = a["t0"] if a["t0"] is not None else max(1, int(vi.min()) + 1)
    t0 = max(1, t0)
    t1 = a["t1"] if a["t1"] is not None else int(max(vi.max(), vj.max())) + 1
    inac_ok = g["valid_inac"] & (g["ii_inac"] >= t0 - 3) & \
        (g["jj_inac"] >= t0 - 3) if a["use_inactive"] else \
        g["valid_inac"] & False
    lows = [vi.min(), vj.min(), t0 - 1]
    if inac_ok.any():
        lows += [g["ii_inac"][inac_ok].min(), g["jj_inac"][inac_ok].min()]
    base = int(min(lows))
    P = bucket(t1 - base)
    base = max(0, min(base, v["buffer"] - P))
    return t0, t1, base, P, inac_ok


def update(net, s):
    """One frontend step from state s (see harness/check.py).  Returns
    the window's poses, disparities and damping, base, and the valid
    edges' targets, weights and reprojected coordinates."""
    g, v = s["graph"], s["video"]
    dev = v["poses"].device
    t0, t1, base, P, _ = window(s)
    valid = g["valid"]
    ii = torch.as_tensor(g["ii"][valid], device=dev)
    jj = torch.as_tensor(g["jj"][valid], device=dev)
    sel = torch.as_tensor(valid.nonzero()[0], device=dev)
    hidden, target, weight, coords = _gru(
        net, s, v["poses"], v["disps"], ii, jj, _jview(s, ii, jj),
        g["net"][sel].float(), g["target"][sel])
    eta, has = _eta(net, hidden, (ii - base).clamp(0, P - 1), P)
    win = slice(base, base + P)
    damping = torch.where(has[:, None, None], eta, v["damping"][win])
    poses, disps = update_dba(s, target, weight, damping)
    return {"base": base, "P": P, "t0": t0, "t1": t1, "poses": poses,
            "disps": disps, "target": target, "weight": weight,
            "coords": coords, "damping": damping}


def update_dba(s, target, weight, damping):
    """The DBA of one frontend step from state s, given the step's
    targets and weights of the valid edges and the window's damping.
    Returns the window's poses and disparities."""
    g, v, a = s["graph"], s["video"], s["args"]
    dev = v["poses"].device
    t0, t1, base, P, inac_ok = window(s)
    valid = g["valid"]
    loc = (lambda x: (torch.as_tensor(x, device=dev) - base).clamp(0, P - 1))
    isel = torch.as_tensor(inac_ok.nonzero()[0], device=dev)
    ii_ba = torch.cat([loc(g["ii"][valid]), loc(g["ii_inac"][inac_ok])])
    jj_ba = torch.cat([loc(g["jj"][valid]), loc(g["jj_inac"][inac_ok])])
    tg = torch.cat([target, g["target_inac"][isel]])
    wt = torch.cat([weight, g["weight_inac"][isel]])
    ok = torch.ones(ii_ba.shape[0], dtype=torch.bool, device=dev)
    win = slice(base, base + P)
    return dba.ba(
        v["poses"][win], v["disps"][win], v["intrinsics"],
        v["disps_sens"][win], tg, wt, 0.2 * damping + EPS_DAMP, ii_ba, jj_ba,
        ok, t0 - base, t1 - base, a["iters"], a["ba_lm"], a["ba_ep"],
        a["motion_only"])


def lowmem(net, s):
    """Global BA's low-memory steps from state s.  Returns poses and
    disparities of frames [0, P) and the valid edges' results."""
    g, v, a = s["graph"], s["video"], s["args"]
    dev = v["poses"].device
    valid = g["valid"]
    vi, vj = g["ii"][valid], g["jj"][valid]
    t0 = a["t0"] if a["t0"] is not None else max(1, int(vi.min()) + 1)
    t0 = max(1, t0)
    t1 = a["t1"] if a["t1"] is not None else int(max(vi.max(), vj.max())) + 1
    lm, ep = (1e-4, 1e-1) if a["ba_type"] == "loop" else (1e-5, 1e-2)
    P = bucket(t1)

    ii = torch.as_tensor(vi, device=dev)
    jj = torch.as_tensor(vj, device=dev)
    sel = torch.as_tensor(valid.nonzero()[0], device=dev)
    hidden = g["net"][sel].float()
    target = g["target"][sel]
    weight = g["weight"][sel]
    poses, disps = v["poses"].clone(), v["disps"].clone()
    damping = v["damping"].clone()
    ii_loc, jj_loc = ii.clamp(0, P - 1), jj.clamp(0, P - 1)
    jview = _jview(s, ii, jj)
    ok = torch.ones(ii.shape[0], dtype=torch.bool, device=dev)
    for _ in range(a["steps"]):
        hidden, target, weight, coords = _gru(net, s, poses, disps, ii, jj,
                                              jview, hidden, target)
        eta, has = _eta(net, hidden, ii_loc, P)
        damping[:P] = torch.where(has[:, None, None], eta, damping[:P])
        p, d = dba.ba(poses[:P], disps[:P], v["intrinsics"],
                      v["disps_sens"][:P], target, weight,
                      0.2 * damping[:P] + EPS_DAMP, ii_loc, jj_loc, ok, t0,
                      t1, a["iters"], lm, ep, a["motion_only"])
        poses[:P], disps[:P] = p, d
    return {"base": 0, "P": P, "t0": t0, "t1": t1, "poses": poses[:P],
            "disps": disps[:P], "target": target, "weight": weight,
            "coords": coords}


def map_step(s):
    """One mapper train step from state s: the InstantNeuS with the
    program's parameters before the step renders the step's ray batch
    (its stratified jitter as drawn); the loss (L1 colour x w_color,
    uncertainty-weighted L1 depth, truncation SDF and free space x w_sdf,
    eikonal x w_eik) and its gradient, clipped to a global norm of 35 as
    optax does.  Returns the loss terms and the clipped gradient of each
    parameter, in the optimizer's order."""
    from .instant_neus import InstantNeuS, compute_sdf_losses
    from .renderer import render_rays
    c = s["cfg"]
    dev = s["rays_o"].device
    model = InstantNeuS(**c["model"]).to(dev)
    model.load_state_dict(s["state"])
    named = dict(model.named_parameters())
    params = [named[n] for n in s["order"]]
    with torch.enable_grad():
        ret = render_rays(model, s["r"], s["rays_o"], s["rays_d"],
                          s["gt_depth"], s["bound"], s["realtime_bound"],
                          c["n_samples"], c["n_surface"])
        gt_color, gt_depth = s["gt_color"], s["gt_depth"]
        valid = (gt_depth > 0).float()
        nv = valid.sum().clamp(min=1.0)
        color = ((ret["color"] - gt_color).abs().mean(-1) * valid).sum() / nv
        uw = 1.0 / torch.sqrt(ret["depth_variance"][:, 0].detach() + 1e-10) \
            if c["uncertainty"] else torch.ones_like(gt_depth)
        depth = ((ret["depth"][:, 0] - gt_depth).abs() * uw
                 * valid).sum() / nv
        sdf, front = compute_sdf_losses(ret["sdf"], ret["z_vals"], gt_depth,
                                        c["truncation"], c["sparse_factor"])
        eik = ret["gradient_error"].mean()
        total = (color * c["w_color"] + depth + (sdf + front) * c["w_sdf"]
                 + eik * c["w_eik"])
        grads = torch.autograd.grad(total, params)
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clipped = [torch.where(norm < 35.0, g, g / norm * 35.0) for g in grads]
    return {"terms": {"color": color.detach(), "depth": depth.detach(),
                      "sdf": sdf.detach(), "eikonal": eik.detach(),
                      "total": total.detach()},
            "grads": clipped}
