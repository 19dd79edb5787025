"""SLAMSystem: the pipeline, tracking and mapping.

Modes (``mode``): ``rgbd`` (images and depth), ``mono`` (images alone)
and ``stereo`` (a rectified pair of images a frame, whose self-edges
take the fixed baseline of ops/projective.py).

  per frame:     motion filter -> frontend (windowed BA; with
                 ``tracking.frontend.enable_loop`` every frontend update
                 ends in the backend's loop closing)
  per K kfs:     global dense BA (``tracking.global_ba_every``)
  per M kfs:     multiview filter -> one mapper round
                 (``mapping.mapping_every``; not with ``only_tracking``)
  terminate:     final dense BA x2, checkpoint (go.ckpt), trajectory
                 fill, ATE (Umeyama) or, without ground truth,
                 submission.txt; with mapping, the final filter
                 pass, ``post_processing_iters`` final mapping rounds,
                 and the mesh: extracted, culled, exported and evaluated

With ``make_video`` a low-resolution mesh is saved after every mapping
round (``mesh/<timestamp>_mesh.ply``, for ``tools/meshvideo.py``); with
``viz`` the headless ``LiveViewer`` is updated after every keyframe and
writes its point cloud and cameras at the end.

With a ``ShardMesh`` of two or more shards, global BA (and loop
closing) shards its edges and the mapper its rays over the mesh; the
per-frame tracking stays on one device.  The caller passes the mesh
(``mesh=``); without one, a system on the GPU builds one over every
visible GPU when there are several and ``multichip`` is on.

Frames are ingested synchronously.  They are quantized the way the JAX
package ships them to its device -- images to uint8, depth to fp16 -- so
both packages track the same inputs.  A failure inside global BA or a
mapping round, in the intermediate mesh or in the viewer propagates: it
is never swallowed.

The system runs on the GPU unless the caller passes ``device="cpu"``; it
raises when no GPU is visible and none was asked for.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Mapping, Optional

import numpy as np
import torch

from .config import default_config
from .mapping import mesher as M
from .mapping.mapper import Mapper
from .models.convert import (convert_mapping_params, is_flax_tree,
                             load_checkpoint)
from .models.droidnet import DroidNet, init_droidnet
from .ops import lie, projective
from .parallel import ShardMesh
from .tracking.backend import Backend
from .tracking.frontend import Frontend
from .tracking.motion_filter import MotionFilter
from .tracking.multiview_filter import MultiviewFilter
from .tracking.trajectory_filler import TrajectoryFiller
from .tracking.video import VideoBuffer
from .utils import evaluate, trace
from .utils.obb import OrientedBoundingBox
from .utils.visualization import LiveViewer


def resolve_device(device=None) -> torch.device:
    """`device` or, when None, the GPU; raises when the GPU is asked for
    (explicitly or by default) and none is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port runs on the GPU "
                "unless the caller asks for device='cpu'")
        # fp32 convolutions and matmuls mean fp32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def default_mesh(device: torch.device, cfg: dict) -> Optional[ShardMesh]:
    """The mesh a system builds when its caller gives none, where the JAX
    package builds one: on the GPU, with more than one visible and
    ``multichip`` on (the default), a mesh of every GPU; else None."""
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if n > 1 and cfg.get("multichip", True):
        return ShardMesh([torch.device("cuda", i) for i in range(n)])
    return None


@dataclasses.dataclass
class TrackingResult:
    poses_w2c: np.ndarray          # [N, 7] keyframe poses
    timestamps: np.ndarray         # [N]
    n_keyframes: int


class SLAMSystem:
    def __init__(self, cfg: Optional[dict] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 output: Optional[str] = None, only_tracking: bool = False,
                 device=None, mesh: Optional[ShardMesh] = None):
        trace.at_frame(0)
        with trace.span("slam.build"):
            self._build(cfg, state_dict, output, only_tracking, device,
                        mesh)

    def _build(self, cfg, state_dict, output, only_tracking, device, mesh):
        self.cfg = cfg or default_config()
        self.device = resolve_device(device)
        cam = self.cfg["cam"]
        tr = self.cfg["tracking"]

        self.mode = self.cfg.get("mode", "mono")
        self.only_tracking = only_tracking or self.cfg.get(
            "only_tracking", False)
        if self.mode not in ("mono", "stereo", "rgbd"):
            raise ValueError(f"mode {self.mode!r}: one of mono, stereo, "
                             f"rgbd")
        # global BA and the mapper shard over a mesh of two or more
        # shards: the caller's, or every visible GPU
        if mesh is None:
            mesh = default_mesh(self.device, self.cfg)
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        self.output = output or self.cfg["data"].get("output", "") or "output"
        os.makedirs(self.output, exist_ok=True)

        with trace.span("slam.build_net"):
            pre = tr.get("pretrained", "")
            if state_dict is None and pre and os.path.exists(pre):
                state_dict = load_checkpoint(pre)
            if state_dict is None:
                net = init_droidnet()
            else:
                net = DroidNet()
                net.load_state_dict(state_dict)
            net.weight_calib.fill_(float(tr.get("weight_calib", 1.0)))
            self.net = net.to(self.device).eval()

        with trace.span("slam.build_video"):
            self.video = VideoBuffer(tr["buffer"], cam["H_out"],
                                     cam["W_out"], self.device,
                                     stereo=self.mode == "stereo")
        with trace.span("slam.build_tracker"):
            self.motion_filter = MotionFilter(
                self.net, self.video, thresh=tr["motion_filter"]["thresh"])
            self.backend = Backend(self.net, self.video, self.cfg,
                                   mesh=self.mesh)
            self.frontend = Frontend(self.net, self.video, self.cfg,
                                     loop_closing=self.backend)
            self.traj_filler = TrajectoryFiller(self.net, self.video,
                                                self.motion_filter)

        if self.only_tracking:
            self.multiview_filter = self.mapper = None
        else:
            with trace.span("slam.build_mapper"):
                self.multiview_filter = MultiviewFilter(
                    self.video, self.cfg, warmup=tr["warmup"])
                self.mapper = Mapper(self.video, self.cfg, mesh=self.mesh)

        self.global_ba_every = tr.get("global_ba_every", 10)
        self.mapping_every = self.cfg["mapping"].get("mapping_every", 5)
        self._kf_since_ba = 0
        self._kf_since_map = 0
        self.frame_count = 0
        self.make_video = bool(self.cfg.get("make_video", False))
        self.viewer = None
        if self.cfg.get("viz", False):
            v = self.cfg.get("viz_options", {}) or {}
            self.viewer = LiveViewer(
                self.video, self.output,
                filter_thresh=v.get("filter_thresh", 0.005),
                filter_count=v.get("filter_count", 2),
                stride=v.get("stride", 1), save_every=v.get("save_every", 10))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def track(self, timestamp, image, depth=None, intrinsics=None,
              gt_pose=None):
        """Feed one frame: image [rig, ht, wd, 3] float in [0, 1] (or
        uint8; rig 2 in stereo, [left, right], else 1), depth [ht, wd]
        metres or None (mono and stereo), intrinsics [4] (fx fy cx cy) at
        full resolution, gt_pose a 4x4 c2w or None.  Returns the list of
        admit decisions this call produced (one entry)."""
        self.frame_count += 1
        trace.at_frame(self.frame_count)
        trace.add("frames")
        with trace.span("slam.track"):
            with trace.span("slam.ingest"):
                img = np.asarray(image)
                if img.ndim != 4 or img.shape[0] != self.video.rig:
                    raise ValueError(
                        f"mode {self.mode}: image of shape "
                        f"[{self.video.rig}, ht, wd, 3] expected, got "
                        f"{list(img.shape)}")
                if img.dtype != np.uint8:
                    img = np.clip(img * 255.0 + 0.5, 0, 255).astype(
                        np.uint8)
                img = torch.as_tensor(img, device=self.device).float() \
                    / 255.0
                dep = None
                if depth is not None:
                    dep = torch.as_tensor(
                        np.asarray(depth).astype(np.float16),
                        device=self.device).float()
            return [self._drain_one(timestamp, img, dep, intrinsics,
                                    gt_pose)]

    def _drain_one(self, timestamp, img, dep, intrinsics, gt_pose) -> bool:
        """Motion filter, frontend and, every `global_ba_every` keyframes,
        global BA, every `mapping_every` keyframes the multiview filter
        and, when it published, a mapper round (and with ``make_video``
        its mesh), then the viewer's update, for one quantized frame.
        Returns the admit decision."""
        is_kf = self.motion_filter.track(timestamp, img, dep, intrinsics,
                                         gt_pose)
        self.frontend()

        if is_kf and self.frontend.is_initialized:
            self._kf_since_ba += 1
            self._kf_since_map += 1
            if (self.global_ba_every > 0
                    and self._kf_since_ba >= self.global_ba_every):
                self._kf_since_ba = 0
                self.backend.dense_ba(0, self.video.counter, steps=2)
            if (self.mapper is not None
                    and self._kf_since_map >= self.mapping_every):
                self._kf_since_map = 0
                if self.multiview_filter():
                    self.mapper()
                    if self.make_video:
                        self._save_intermediate_mesh()
            if self.viewer is not None:
                self.viewer.update()
        return is_kf

    def _save_intermediate_mesh(self):
        """The map's mesh after a mapping round, for the mesh video: at
        resolution min(meshing.resolution, 192), cut to the bound, as
        mesh/<timestamp of the last keyframe>_mesh.ply."""
        cfg_m = self.cfg["meshing"]
        if float(np.abs(self.video.bound).sum()) < 1e-6:
            return
        bound = torch.as_tensor(self.video.bound, dtype=torch.float32,
                                device=self.device)
        v, t = M.extract_mesh(self.mapper.model, bound, bound,
                              resolution=min(int(cfg_m["resolution"]), 192),
                              level_set=cfg_m["level_set"])
        if len(t) == 0:
            return
        v, t = M.cull_by_bound(v, t, self.video.bound)
        ts = int(float(self.video.timestamp[self.video.counter - 1]))
        mesh_dir = os.path.join(self.output, "mesh")
        os.makedirs(mesh_dir, exist_ok=True)
        M.save_ply(os.path.join(mesh_dir, f"{ts:05d}_mesh.ply"), v, t)

    def flush(self):
        """Ingest is synchronous: nothing is in flight.  Kept so callers of
        the JAX package's pipelined API work unchanged."""

    # ------------------------------------------------------------------
    def finalize_tracking(self, final_steps: int = 6) -> TrackingResult:
        """Two final global BA passes over all keyframes."""
        n = self.video.counter
        if n > 2 and self.frontend.is_initialized:
            self.backend.dense_ba(0, n, steps=final_steps)
            self.backend.dense_ba(0, n, steps=final_steps)
        return TrackingResult(
            poses_w2c=self.video.poses[:n].cpu().numpy(),
            timestamps=self.video.timestamp[:n].cpu().numpy(),
            n_keyframes=n)

    def terminate(self, stream=None, eval_mesh_path: str = "") -> dict:
        """Final BA, the checkpoint ``go.ckpt``, trajectory fill over
        `stream` (the same items as track: timestamp, image, depth,
        intrinsics, gt_pose) and ATE; with mapping, the final mapping
        rounds and the mesh, evaluated against the PLY at
        `eval_mesh_path` when ``meshing.eval_rec`` is on.  Writes
        est_poses.npy (c2w [N,4,4]) and, with ground truth,
        metrics_traj.txt into the output directory, without it
        submission.txt (the TUM format, at the stream's own timestamps);
        with mapping, mesh/*.ply and metrics_mesh.txt; with ``viz`` the
        viewer's pointcloud/*_pc.ply and pointcloud/cameras.ply."""
        self.finalize_tracking()
        if self.viewer is not None:
            self.viewer.update()
            self.viewer.save_pointcloud()
            self.viewer.save_cameras()
        n = self.video.counter
        self.save_checkpoint(os.path.join(self.output, "go.ckpt"))
        gt_record, ts_record = [], []
        if stream is not None:
            def recording(s):
                for item in s:
                    ts_record.append(item[0])
                    gt_record.append(item[4])
                    yield item

            full_w2c = torch.as_tensor(self.traj_filler(recording(stream)))
            c2w = lie.matrix(lie.inv(full_w2c)).numpy()
        else:
            c2w = lie.matrix(lie.inv(self.video.poses[:n])).cpu().numpy()
            gt_record = list(self.video.poses_gt[:n].cpu().numpy()) \
                if self.video.has_gt else []
        np.save(os.path.join(self.output, "est_poses.npy"), c2w)

        metrics, trans_init = {}, None
        if gt_record and all(p is not None for p in gt_record):
            res = evaluate.ate_rmse(c2w, np.stack(gt_record),
                                    correct_scale=True)
            trans_init = res["alignment"]
            metrics["ate"] = {k: v for k, v in res.items()
                              if k != "alignment"}
            with open(os.path.join(self.output, "metrics_traj.txt"),
                      "w") as f:
                json.dump(metrics["ate"], f, indent=2)
        else:
            # the images' own timestamps: a benchmark server (ETH3D) takes
            # no other
            ts = np.asarray(ts_record, np.float64) if ts_record else \
                self.video.timestamp[:n].cpu().numpy().astype(np.float64)
            evaluate.write_tum_trajectory(
                os.path.join(self.output, "submission.txt"), ts[:len(c2w)],
                c2w)

        if self.mapper is not None:
            self.multiview_filter()
            # post_processing_iters final rounds, each at 10x the iterations
            for _ in range(int(self.cfg["mapping"].get(
                    "post_processing_iters", 10))):
                self.mapper(the_end=True)
            mesh_metrics = self.extract_final_mesh(
                eval_mesh_path, est_c2w_list=c2w, trans_init=trans_init)
            if mesh_metrics:
                metrics["mesh"] = mesh_metrics
        return metrics

    # ------------------------------------------------------------------
    def _filtered_obb(self):
        """OBB (+0.1 m margin) of the multiview-filtered points, without
        the far ones: the culling bound of the final mesh."""
        v, n = self.video, self.video.counter
        disps = v.disps_filtered[:n]
        mean_d = disps.reshape(n, -1).mean(dim=1)[:, None, None]
        masks = (v.mask_filtered[:n] > 0) & (disps > 0.01 * mean_d)
        if not bool(masks.any()):
            return None
        pts = projective.iproj_world(v.poses_filtered[:n],
                                     torch.clamp(disps, min=1e-6),
                                     v.intrinsics * v.device_scale)
        return OrientedBoundingBox.from_points(pts[masks].cpu().numpy(),
                                               extend=0.1)

    def extract_final_mesh(self, gt_mesh_path: str = "",
                           est_c2w_list=None, trans_init=None):
        """Final mesh: extract -> OBB + projection + component + forecast
        cull -> ICP alignment to the GT mesh (seeded with the ATE's Sim3)
        -> save -> evaluate the aligned forecast mesh.  Writes
        mesh/final_raw.ply, cull_mesh.ply and forecast_mesh.ply (with a
        GT mesh also the aligned meshes and metrics_mesh.txt); returns
        the mesh metrics or None."""
        cfg_m = self.cfg["meshing"]
        if float(np.abs(self.video.bound).sum()) < 1e-6:
            return None
        bound = torch.as_tensor(self.video.bound, dtype=torch.float32,
                                device=self.device)
        model = self.mapper.model
        v, t = M.extract_mesh(model, bound, bound,
                              resolution=cfg_m["resolution"],
                              level_set=cfg_m["level_set"])
        if len(t) == 0:
            return None

        mesh_dir = os.path.join(self.output, "mesh")
        os.makedirs(mesh_dir, exist_ok=True)
        colors = M.extract_vertex_colors(model, bound, v)
        M.save_ply(os.path.join(mesh_dir, "final_raw.ply"), v, t, colors)

        if est_c2w_list is None:
            est_c2w_list = self.keyframe_c2w()
        intr = (self.video.intrinsics * self.video.device_scale).cpu().numpy()
        (cv_, ct_), (fv, ft) = M.cull_mesh(
            v, t, est_c2w_list, intr, self.video.ht, self.video.wd,
            obb=self._filtered_obb(),
            forecast_radius=cfg_m["forecast_radius"],
            get_largest_components=cfg_m.get("get_largest_components",
                                             False),
            min_area_ratio=cfg_m["remove_small_geometry_threshold"])
        if len(ct_) == 0:
            return None
        M.save_ply(os.path.join(mesh_dir, "cull_mesh.ply"), cv_, ct_)
        M.save_ply(os.path.join(mesh_dir, "forecast_mesh.ply"), fv, ft)

        if not (cfg_m.get("eval_rec") and gt_mesh_path
                and os.path.exists(gt_mesh_path)):
            return None
        gv, gt_tris = M.load_ply(gt_mesh_path)
        T = M.align_mesh_icp(cv_, gv, init=trans_init)
        cva = cv_ @ T[:3, :3].T + T[:3, 3]
        M.save_ply(os.path.join(mesh_dir, "aligned_mesh.ply"),
                   cva.astype(np.float32), ct_)
        fva = (fv @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        M.save_ply(os.path.join(mesh_dir, "forecast_aligned_mesh.ply"),
                   fva, ft)
        res = M.eval_mesh(fva, ft, gv, gt_tris,
                          n_points=cfg_m["n_points_to_eval"],
                          threshold=cfg_m["mesh_threshold_to_eval"])
        with open(os.path.join(self.output, "metrics_mesh.txt"), "w") as f:
            json.dump(res, f, indent=2)
        return res

    def keyframe_c2w(self) -> np.ndarray:
        n = self.video.counter
        return lie.matrix(lie.inv(self.video.poses[:n])).cpu().numpy()

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str, full: bool = True):
        """go.ckpt, with the JAX package's keys: both networks' parameters
        (state dicts of numpy arrays), the keyframes' timestamps, poses
        and disparities and, with full=True, what tracking needs to
        resume: images (uint8), sensor disparities, features and context
        (float32), ground-truth poses and intrinsics."""
        def host(sd):
            return {k: t.detach().cpu().numpy() for k, t in sd.items()}

        v, n = self.video, self.video.counter
        state = {
            "tracking_params": host(self.net.state_dict()),
            "mapping_params": host(self.mapper.model.state_dict())
            if self.mapper is not None else None,
            "timestamps": v.timestamp[:n].cpu().numpy(),
            "poses": v.poses[:n].cpu().numpy(),
            "disps": v.disps[:n].cpu().numpy(),
            "counter": n,
        }
        if full and n:
            state.update({
                "images_u8": torch.clamp(v.images[:n] * 255.0 + 0.5, 0, 255)
                .to(torch.uint8).cpu().numpy(),
                "disps_sens": v.disps_sens[:n].cpu().numpy(),
                "fmaps": v.fmaps[:n].float().cpu().numpy(),
                "nets": v.nets[:n].float().cpu().numpy(),
                "inps": v.inps[:n].float().cpu().numpy(),
                "poses_gt": v.poses_gt[:n].cpu().numpy(),
                "has_gt": v.has_gt,
                "intrinsics": v.intrinsics.cpu().numpy(),
            })
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, path: str, resume_tracking: bool = True):
        """Restore a go.ckpt written by this package or by the JAX package
        (flax parameter trees go through models/convert).  A full
        checkpoint restores every field the factor graph needs, the
        motion filter's last keyframe and the frontend's state, so
        tracking continues.  With resume_tracking=True a checkpoint
        without the full fields raises; resume_tracking=False loads
        poses and parameters only.  The tracking network's parameters are
        not restored (the system's own are kept)."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        n = state["counter"]
        if resume_tracking and n and "fmaps" not in state:
            raise ValueError(
                f"checkpoint {path} lacks the full tracking fields "
                f"(fmaps/nets/inps) needed to resume; re-save with "
                f"save_checkpoint(full=True), or pass "
                f"resume_tracking=False to load poses/params only")
        if "fmaps" in state and n and np.shape(state["fmaps"])[1] != \
                self.video.rig:
            raise ValueError(
                f"checkpoint {path} holds {np.shape(state['fmaps'])[1]} "
                f"view(s) a keyframe; mode {self.mode!r} tracks "
                f"{self.video.rig}")

        def dev(key, dtype=torch.float32):
            a = np.asarray(state[key])
            if a.dtype != np.uint8:
                a = a.astype(np.float32)
            return torch.as_tensor(a, device=self.device).to(dtype)

        v = self.video
        v.counter = n
        v.poses[:n] = dev("poses")
        v.disps[:n] = dev("disps")
        v.timestamp[:n] = dev("timestamps")
        if "fmaps" in state and n:
            v.images[:n] = dev("images_u8") / 255.0
            v.disps_sens[:n] = dev("disps_sens")
            bf16 = torch.bfloat16
            v.fmaps[:n] = dev("fmaps", bf16)
            v.nets[:n] = dev("nets", bf16)
            v.inps[:n] = dev("inps", bf16)
            v.poses_gt[:n] = dev("poses_gt")
            v.has_gt = bool(state["has_gt"])
            v.intrinsics.copy_(dev("intrinsics"))
            # the motion filter resumes against the last keyframe, the
            # frontend past its initialization
            mf = self.motion_filter
            mf.fmap = v.fmaps[n - 1].float()
            mf.net = v.nets[n - 1][None].float()
            mf.inp = v.inps[n - 1][None].float()
            mf._seen_first = True
            self.frontend.is_initialized = (
                n >= self.cfg["tracking"]["warmup"])
            self.frontend.t1 = n
        params = state.get("mapping_params")
        if params is not None and self.mapper is not None:
            sd = convert_mapping_params(params) if is_flax_tree(params) \
                else {k: torch.as_tensor(np.asarray(a))
                      for k, a in params.items()}
            self.mapper.model.load_state_dict(sd)
        return state
