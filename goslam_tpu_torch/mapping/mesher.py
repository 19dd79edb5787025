"""Mesher: extract, cull, export and evaluate the scene mesh.

  * the SDF on a regular grid over the bound, evaluated on the device in
    chunks (negated, so the zero level set comes out facing outward)
  * the iso-surface by the native marching tetrahedra (``native``)
  * culling: bound or OBB cull -> frustum and depth-occlusion cull
    against the extracted mesh's own depth, rendered by the native
    z-buffer -> connected components by area -> forecast mesh
  * evaluation: accuracy / completion (cm), ratios and F-score at 5 cm on
    sampled surface points (cKDTree), and ICP alignment
  * PLY export and import without mesh libraries

Everything after the grid evaluation is host numpy, kept equal to the
JAX package's mesher (tests/test_torch_tracking.py holds it).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..native import marching_cubes, render_depth
from ..utils.obb import OrientedBoundingBox


# ---------------------------------------------------------------------------
# field extraction
# ---------------------------------------------------------------------------

@torch.no_grad()
def extract_sdf_grid(model, bound, realtime_bound, resolution: int,
                     chunk: int = 64 ** 2 * 16) -> np.ndarray:
    """-sdf on a resolution^3 grid over `bound` [3, 2] (a tensor on the
    model's device): the points are np.linspace's float32 values, made
    on the device chunk by chunk."""
    dev = bound.device
    b = bound.cpu().numpy().astype(np.float32)
    axes = [torch.from_numpy(np.linspace(b[a, 0], b[a, 1], resolution,
                                         dtype=np.float32)).to(dev)
            for a in range(3)]
    n = resolution ** 3
    out = torch.empty(n, dtype=torch.float32, device=dev)
    for i in range(0, n, chunk):
        idx = torch.arange(i, min(i + chunk, n), device=dev)
        pts = torch.stack([axes[0][idx // resolution ** 2],
                           axes[1][idx // resolution % resolution],
                           axes[2][idx % resolution]], dim=-1)
        out[i:i + chunk] = model.sdf_grid(pts, bound, realtime_bound)
    return -out.view(resolution, resolution, resolution).cpu().numpy()


def extract_mesh(model, bound, realtime_bound, resolution: int = 256,
                 level_set: float = 0.0):
    """Grid evaluation + marching tetrahedra + rescale to world
    coordinates: (vertices [V, 3] float32, triangles [T, 3] int32)."""
    u = extract_sdf_grid(model, bound, realtime_bound, resolution)
    verts, tris = marching_cubes(u, level_set)
    b = bound.cpu().numpy().astype(np.float32)
    scale = (b[:, 1] - b[:, 0]) / (resolution - 1.0)
    return verts * scale[None] + b[None, :, 0], tris


@torch.no_grad()
def extract_vertex_colors(model, bound, verts: np.ndarray,
                          chunk: int = 16384) -> np.ndarray:
    """Colours at the vertices, uint8 [V, 3].  The colour network takes
    the SDF's gradient, so each chunk differentiates the hash grid once
    (and frees that graph)."""
    out = np.empty((len(verts), 3), np.float32)
    for i in range(0, len(verts), chunk):
        p = torch.as_tensor(np.asarray(verts[i:i + chunk], np.float32),
                            device=bound.device)
        out[i:i + len(p)] = model.color_at(p, bound).cpu().numpy()
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# culling
# ---------------------------------------------------------------------------

def cull_by_bound(verts, tris, bound, eps: float = 0.01):
    """Drop faces with any vertex outside bound (InstantNeuS.py:486-492)."""
    bound = np.asarray(bound)
    ok = np.all(verts >= bound[:, 0] - eps, axis=1) & \
        np.all(verts <= bound[:, 1] + eps, axis=1)
    keep = ok[tris].all(axis=1)
    return _compact(verts, tris[keep])


def cull_small_components(verts, tris, min_area_ratio: float = 0.2,
                          get_largest: bool = False):
    """Connected-component culling by surface AREA (mesher.py:140-153,
    get_connected_mesh): either keep only the largest component, or drop
    components whose area is below min_area_ratio of the total."""
    if len(tris) == 0:
        return verts, tris
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                     shape=(len(verts), len(verts)))
    n_comp, labels = connected_components(adj, directed=False)
    face_labels = labels[tris[:, 0]]
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    face_area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    areas = np.bincount(face_labels, weights=face_area, minlength=n_comp)
    if get_largest:
        keep = face_labels == areas.argmax()
    else:
        big = areas > min_area_ratio * areas.sum()
        keep = big[face_labels]
    return _compact(verts, tris[keep])


def point_masks(points, depth_list, c2w_list, intrinsics, ht: int, wd: int,
                forecast_radius: float = 0.0, eps: float = 0.05):
    """Seen / forecast masks per vertex against rendered mesh depth
    (mesher.py:56-136): a point is *seen* if some camera has it inside the
    frustum and not behind the mesh's own rendered depth (+eps); the
    *forecast* mask additionally admits points within `forecast_radius`
    pixels outside the image border. Pixels where the render hit nothing
    count as visible (mesher.py:120-121 `torch.where(depth>0, ..., True)`).

    depth_list: [N, ht, wd] depths rendered from the mesh itself
    (native.render_depth — the pyrender replacement).
    """
    fx, fy, cx, cy = [float(x) for x in intrinsics]
    n_pts = len(points)
    seen = np.zeros(n_pts, bool)
    forecast = np.zeros(n_pts, bool)
    r = float(forecast_radius)
    pts_h = np.concatenate([points, np.ones((n_pts, 1), points.dtype)],
                           axis=1)

    for k in range(len(c2w_list)):
        w2c = np.linalg.inv(np.asarray(c2w_list[k], np.float64))
        pc = pts_h @ w2c[:3].T
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = fx * pc[:, 0] / z + cx
            v = fy * pc[:, 1] / z + cy

        in_frustum = (u >= 0) & (u <= wd - 1) & (v >= 0) & (v <= ht - 1) \
            & (z > 0)
        fore_frustum = (u >= -r) & (u <= wd - 1 + r) & (v >= -r) \
            & (v <= ht - 1 + r) & (z > 0)

        # bilinear depth sample, border padding, align_corners=True
        # (grid_sample semantics, mesher.py:113-119)
        uu = np.clip(u, 0.0, wd - 1.0)
        vv = np.clip(v, 0.0, ht - 1.0)
        u0 = np.floor(uu).astype(np.int64)
        v0 = np.floor(vv).astype(np.int64)
        u1 = np.minimum(u0 + 1, wd - 1)
        v1 = np.minimum(v0 + 1, ht - 1)
        au = uu - u0
        av = vv - v0
        D = np.asarray(depth_list[k])
        ds = (D[v0, u0] * (1 - au) * (1 - av) + D[v0, u1] * au * (1 - av)
              + D[v1, u0] * (1 - au) * av + D[v1, u1] * au * av)

        is_front = np.where(ds > 0.0, z < ds + eps, True)
        in_f = in_frustum & is_front
        seen |= in_f
        forecast |= in_f | (fore_frustum & is_front)
    return seen, forecast


def cull_mesh(verts, tris, c2w_list, intrinsics, ht: int, wd: int,
              bound=None, obb=None, forecast_radius: float = 0.0,
              get_largest_components: bool = False,
              min_area_ratio: float = 0.2, far: float = 20.0,
              depth_list=None):
    """Full reference culling flow (mesher.py:157-240):
      bound/OBB cull -> projection cull against the mesh's own rendered
      depth -> connected components -> forecast mesh restricted to the
      culled mesh's OBB -> components.

    Returns ((cull_v, cull_t), (forecast_v, forecast_t)).
    """
    if bound is not None:
        verts_k, tris_k = cull_by_bound(verts, tris, bound)
    elif obb is not None:
        ok = obb.contains(verts)
        verts_k, tris_k = _compact(verts, tris[ok[tris].all(axis=1)])
    else:
        verts_k, tris_k = verts, tris
    if len(tris_k) == 0:
        empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
        return empty, empty

    # occlusion oracle: the extracted mesh's own depth at every camera
    # (extract_depth_from_mesh, mesher.py:190-193)
    if depth_list is None:
        w2c = np.linalg.inv(np.asarray(c2w_list, np.float64)).astype(
            np.float32)
        depth_list = render_depth(verts_k, tris_k, w2c, intrinsics,
                                  ht, wd, zfar=far)

    seen, forecast = point_masks(verts_k, depth_list, c2w_list, intrinsics,
                                 ht, wd, forecast_radius=forecast_radius)

    cull_v, cull_t = _compact(verts_k, tris_k[seen[tris_k].all(axis=1)])
    cull_v, cull_t = cull_small_components(cull_v, cull_t, min_area_ratio,
                                           get_largest_components)

    if abs(forecast_radius) > 0 and len(cull_v):
        fore_v, fore_t = _compact(verts_k,
                                  tris_k[forecast[tris_k].all(axis=1)])
        if len(fore_v):
            # restrict the forecast mesh to the culled mesh's OBB
            # (mesher.py:218-231)
            box = OrientedBoundingBox.from_points(cull_v)
            inb = box.contains(fore_v)
            fore_v, fore_t = _compact(fore_v,
                                      fore_t[inb[fore_t].all(axis=1)])
            fore_v, fore_t = cull_small_components(
                fore_v, fore_t, min_area_ratio, get_largest_components)
    else:
        fore_v, fore_t = cull_v.copy(), cull_t.copy()
    return (cull_v, cull_t), (fore_v, fore_t)


def _compact(verts, tris):
    """Drop unreferenced vertices, reindex triangles."""
    if len(tris) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    used = np.unique(tris)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[tris].astype(np.int32)


# ---------------------------------------------------------------------------
# I/O + evaluation
# ---------------------------------------------------------------------------

def save_ply(path: str, verts: np.ndarray, tris: np.ndarray,
             colors: Optional[np.ndarray] = None):
    """Minimal binary-little-endian PLY writer."""
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(tris)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is not None:
            rec = np.empty(len(verts), [("p", "<f4", 3), ("c", "u1", 3)])
            rec["p"], rec["c"] = verts, colors
            f.write(rec.tobytes())
        else:
            f.write(np.asarray(verts, "<f4").tobytes())
        face = np.empty((len(tris), 13), np.uint8)
        face[:, 0] = 3
        face[:, 1:] = np.asarray(tris, "<i4").view(np.uint8).reshape(-1, 12)
        f.write(face.tobytes())


def load_ply(path: str):
    """Minimal PLY reader (binary LE or ascii; xyz + faces)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header") + len(b"end_header") + 1
    header = data[:head_end].decode(errors="ignore").splitlines()
    n_v = n_f = 0
    props = 0
    binary = True
    in_vertex = False
    vprops = []
    for line in header:
        if line.startswith("format ascii"):
            binary = False
        if line.startswith("element vertex"):
            n_v = int(line.split()[-1])
            in_vertex = True
        elif line.startswith("element face"):
            n_f = int(line.split()[-1])
            in_vertex = False
        elif line.startswith("property") and in_vertex:
            vprops.append(line.split()[1])
    if binary:
        sizes = {"float": 4, "uchar": 1, "int": 4, "double": 8,
                 "float32": 4, "uint8": 1}
        stride = sum(sizes[p] for p in vprops)
        raw = np.frombuffer(data, np.uint8, n_v * stride, head_end)
        raw = raw.reshape(n_v, stride)
        verts = raw[:, :12].copy().view("<f4")
        off = head_end + n_v * stride
        tris = np.zeros((n_f, 3), np.int32)
        pos = off
        for i in range(n_f):
            cnt = data[pos]
            tris[i] = np.frombuffer(data, "<i4", 3, pos + 1)
            pos += 1 + 4 * cnt
        return verts.reshape(n_v, 3), tris
    # ascii
    body = data[head_end:].decode().split()
    k = len(vprops)
    vals = np.asarray(body[:n_v * k], np.float32).reshape(n_v, k)
    verts = vals[:, :3]
    rest = body[n_v * k:]
    tris = []
    pos = 0
    for _ in range(n_f):
        c = int(rest[pos])
        tris.append([int(x) for x in rest[pos + 1:pos + 4]])
        pos += c + 1
    return verts, np.asarray(tris, np.int32)


def sample_surface(verts, tris, n: int, rng=None):
    """Uniform area-weighted surface sampling."""
    rng = rng or np.random.default_rng(0)
    a = verts[tris[:, 0]]
    b = verts[tris[:, 1]]
    c = verts[tris[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = area / max(area.sum(), 1e-12)
    idx = rng.choice(len(tris), n, p=probs)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return a[idx] + u * (b[idx] - a[idx]) + v * (c[idx] - a[idx])


def eval_mesh(est_verts, est_tris, gt_verts, gt_tris, n_points: int = 200000,
              threshold: float = 0.05, rng=None):
    """Accuracy/completion (cm), ratios (%), F-score (mesher.py:390-421)."""
    from scipy.spatial import cKDTree

    rng = rng or np.random.default_rng(0)
    ps = sample_surface(est_verts, est_tris, n_points, rng)
    pg = sample_surface(gt_verts, gt_tris, n_points, rng)

    # every core queries (the same distances): a mesh far from the GT
    # makes each query visit much of the tree
    d_acc, _ = cKDTree(pg).query(ps, k=1, workers=-1)
    d_comp, _ = cKDTree(ps).query(pg, k=1, workers=-1)

    acc = d_acc.mean()
    comp = d_comp.mean()
    prec = (d_acc < threshold).mean()
    recall = (d_comp < threshold).mean()
    f1 = 2 * prec * recall / max(prec + recall, 1e-12)
    return {
        "accuracy_cm": 100 * acc,
        "completion_cm": 100 * comp,
        "precision_ratio": 100 * prec,
        "completion_ratio": 100 * recall,
        "f_score": 100 * f1,
    }


def align_mesh_icp(est_verts, gt_verts, init=None, iters: int = 20,
                   n_sample: int = 20000, rng=None):
    """Rigid ICP alignment of est -> gt vertices (mesher.py:339-357,
    replacing Open3D's ICP).  Returns the 4x4 transform."""
    from scipy.spatial import cKDTree

    from ..utils.evaluate import umeyama

    rng = rng or np.random.default_rng(0)
    T = np.eye(4) if init is None else np.asarray(init, np.float64).copy()
    tree = cKDTree(gt_verts)
    src0 = est_verts[rng.choice(len(est_verts),
                                min(n_sample, len(est_verts)),
                                replace=False)]
    for _ in range(iters):
        src = src0 @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(src, k=1, workers=-1)
        keep = d < np.percentile(d, 80)          # trim outliers
        s, R, t = umeyama(src[keep], gt_verts[idx[keep]], with_scale=False)
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = t
        T = dT @ T
        if np.linalg.norm(dT[:3, 3]) < 1e-7:
            break
    return T
