"""What decides ``correct``: the window's own steps, replayed by the plain
reference from the state each started from.

While the window runs, a sample of three kinds of calls, drawn from the
seed by reservoir sampling over every call the window makes, has its
starting state and its results captured on the device (clones, no host
synchronization):

  motion_filter  MotionFilter.track (not a system's first frame): the
                 frame, the last keyframe's features and context; the
                 encoders' outputs and the update iteration's flow
  update         FactorGraph.update of the frontend: the edges, hidden
                 states, targets, weights, the keyframes' poses,
                 disparities, features and context; the results
  global_ba      FactorGraph.update_lowmem (global BA and loop
                 closing), the same
  map_step       Mapper.train_step: the InstantNeuS's parameters and
                 AdamW's first moments, the ray batch and its jitter; the
                 loss terms and the first moments after

After the window the reference (``benchmark/reference``, fp32, TF32
off) computes each sampled step again from its starting state.  Each
number compared is the worst, over the sample, of relative gaps
||program - reference|| / ||reference||:

  motion_filter  the encoders' outputs (fnet of every view, cnet), and
                 the flow of the update iteration against the larger of
                 the reference's flow and the admit threshold's
  update         the frontend step's flow revision (target minus the
                 reprojection) and confidence weights
  dba            the frontend step's DBA (K1 and the Cholesky solve),
                 replayed by the reference from the program's own
                 targets, weights and damping after the step: the change
                 of the window's poses, and of its disparities, over the
                 step against the reference's change (a DBA that leaves
                 its state unchanged reads 1)
  global_ba      global BA's flow revision and weights after its steps
  map_step       a mapper train step (Mapper.train_step): its loss, and
                 by the worst parameter the norm of the clipped gradient
                 AdamW got, worked out from its first moment before and
                 after the step, against the larger of the parameter's
                 and the median parameter's reference norm

The reference follows the program step by step from the program's own
state: the start of each step is the program's.  The DBA is replayed
from the step's own outputs, since the change of a converged window's
poses is small and ill-conditioned: through the whole step it reads as
high on sound runs as under the control.
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch

# snapshots kept per kind of call
SAMPLE = {"motion_filter": 4, "update": 3, "global_ba": 2, "map_step": 2}


class Reservoir:
    """Keeps a uniform sample of at most k of the calls seen so far."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.n = k, rng, 0
        self.items: List[dict] = []

    def slot(self):
        """The slot the next call goes to, or None when it is not kept."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self.rng.randrange(self.n)
        return j if j < self.k else None


def _video_state(v) -> dict:
    n = v.counter
    return {"poses": v.poses.clone(), "disps": v.disps.clone(),
            "disps_sens": v.disps_sens.clone(),
            "damping": v.damping.clone(),
            "intrinsics": v.intrinsics.clone(),
            "fmaps": v.fmaps[:n].clone(), "inps": v.inps[:n].clone(),
            "buffer": v.buffer, "stereo": v.stereo}


def _graph_state(g) -> dict:
    s = {"ii": g.ii.copy(), "jj": g.jj.copy(), "valid": g.valid.copy(),
         "net": g.net.clone(), "target": g.target.clone(),
         "weight": g.weight.clone()}
    if g.cap_inac:
        s.update(ii_inac=g.ii_inac.copy(), jj_inac=g.jj_inac.copy(),
                 valid_inac=g.valid_inac.copy(),
                 target_inac=g.target_inac.clone(),
                 weight_inac=g.weight_inac.clone())
    else:
        z = np.zeros(0, np.int64)
        s.update(ii_inac=z, jj_inac=z, valid_inac=np.zeros(0, bool),
                 target_inac=g.target[:0].clone(),
                 weight_inac=g.weight[:0].clone())
    return s


def _results(g) -> dict:
    v = g.video
    return {"poses": v.poses.clone(), "disps": v.disps.clone(),
            "damping": v.damping.clone(), "target": g.target.clone(),
            "weight": g.weight.clone()}


def _exp_avg(m) -> list:
    """AdamW's first moment of each parameter (None before its first
    step)."""
    out = []
    for p in m.params:
        st = m.opt.state.get(p, {})
        out.append(st["exp_avg"].clone() if "exp_avg" in st else None)
    return out


def _mapper_state(m) -> dict:
    """The mapper's parameters and first moments before a step, and what
    the step's loss is computed with."""
    named = {id(p): n for n, p in m.model.named_parameters()}
    mc = m.cfg["mapping"]["model"]
    return {
        "state": {k: v.detach().clone()
                  for k, v in m.model.state_dict().items()},
        "order": [named[id(p)] for p in m.params],
        "beta1": m.opt.param_groups[0]["betas"][0],
        "exp_avg": _exp_avg(m),
        "cfg": {"model": {"d_out": mc["sdf_network"]["d_out"],
                          "d_hidden": mc["color_network"]["d_hidden"],
                          "n_layers": mc["color_network"]["n_layers"],
                          "init_val": mc["variance_network"]["init_val"],
                          "scale_factor":
                          mc["variance_network"]["scale_factor"]},
                "n_samples": m.n_samples, "n_surface": m.n_surface,
                "w_color": m.w_color, "w_sdf": m.w_sdf, "w_eik": m.w_eik,
                "uncertainty": m.uncertainty, "truncation": m.truncation,
                "sparse_factor": m.sparse_factor}}


class Capture:
    """Installs the capturing wrappers on the port's classes for the
    window (``install``/``remove``) and holds the sample."""

    def __init__(self, seed: int):
        rng = random.Random(int(seed) * 7919 + 17)
        self.res: Dict[str, Reservoir] = {
            k: Reservoir(n, random.Random(rng.random()))
            for k, n in SAMPLE.items()}
        self._orig = None

    def install(self):
        from goslam_tpu_torch.mapping.mapper import Mapper
        from goslam_tpu_torch.tracking.factor_graph import FactorGraph
        from goslam_tpu_torch.tracking.motion_filter import MotionFilter
        self._orig = (MotionFilter.track, FactorGraph.update,
                      FactorGraph.update_lowmem, Mapper.train_step)
        mf_track, fg_update, fg_lowmem, map_train = self._orig
        cap = self

        def track(mf, timestamp, image, depth=None, intrinsics=None,
                  gt_pose=None):
            slot = cap.res["motion_filter"].slot() if mf._seen_first \
                else None
            if slot is None:
                return mf_track(mf, timestamp, image, depth, intrinsics,
                                gt_pose)
            snap = {"image": image.clone(), "fmap": mf.fmap.clone(),
                    "net": mf.net.clone(), "inp": mf.inp.clone(),
                    "thresh": float(mf.thresh)}
            out = {}
            m = mf.model
            hooks = [
                m.fnet.register_forward_hook(
                    lambda mod, a, y: out.__setitem__("fnet", y.clone())),
                m.cnet.register_forward_hook(
                    lambda mod, a, y: out.__setitem__("cnet", y.clone())),
                m.update.register_forward_hook(
                    lambda mod, a, y: out.__setitem__("delta",
                                                      y[1].clone()))]
            try:
                r = mf_track(mf, timestamp, image, depth, intrinsics,
                             gt_pose)
            finally:
                for h in hooks:
                    h.remove()
            cap.res["motion_filter"].items[slot] = {"start": snap,
                                                    "out": out}
            return r

        def graph_call(kind, orig, args):
            def call(g, *a, **k):
                if not g.valid.any():
                    return orig(g, *a, **k)
                slot = cap.res[kind].slot()
                if slot is None:
                    return orig(g, *a, **k)
                snap = {"video": _video_state(g.video),
                        "graph": _graph_state(g),
                        "args": dict(zip(args, a)) | k,
                        "weight_calib": float(g.model.weight_calib)}
                r = orig(g, *a, **k)
                cap.res[kind].items[slot] = {"start": snap,
                                             "out": _results(g)}
                return r
            return call

        FactorGraph.update = graph_call(
            "update", fg_update,
            ("t0", "t1", "iters", "use_inactive", "motion_only", "ba_lm",
             "ba_ep"))
        FactorGraph.update_lowmem = graph_call(
            "global_ba", fg_lowmem,
            ("t0", "t1", "iters", "steps", "max_t", "ba_type",
             "motion_only"))
        MotionFilter.track = track

        def train_step(m, rays_o, rays_d, gt_color, gt_depth, bound,
                       realtime_bound, r=None):
            slot = cap.res["map_step"].slot()
            if slot is None:
                return map_train(m, rays_o, rays_d, gt_color, gt_depth,
                                 bound, realtime_bound, r)
            if r is None:
                r = m._jitter()        # the draw the step would make
            snap = _mapper_state(m)
            snap.update(rays_o=rays_o.clone(), rays_d=rays_d.clone(),
                        gt_color=gt_color.clone(), gt_depth=gt_depth.clone(),
                        bound=bound.clone(),
                        realtime_bound=realtime_bound.clone(),
                        r=None if r is None else r.clone())
            terms = map_train(m, rays_o, rays_d, gt_color, gt_depth, bound,
                              realtime_bound, r)
            cap.res["map_step"].items[slot] = {
                "start": snap, "out": {"terms": dict(terms),
                                       "exp_avg": _exp_avg(m)}}
            return terms

        Mapper.train_step = train_step

    def remove(self):
        if self._orig is None:
            return
        from goslam_tpu_torch.mapping.mapper import Mapper
        from goslam_tpu_torch.tracking.factor_graph import FactorGraph
        from goslam_tpu_torch.tracking.motion_filter import MotionFilter
        (MotionFilter.track, FactorGraph.update,
         FactorGraph.update_lowmem, Mapper.train_step) = self._orig
        self._orig = None

    def samples(self, kind: str) -> List[dict]:
        return [x for x in self.res[kind].items if x is not None]


_DEFAULTS = {"update": {"t0": None, "t1": None, "iters": 2,
                        "use_inactive": False, "motion_only": False,
                        "ba_lm": 1e-4, "ba_ep": 0.1},
             "global_ba": {"t0": None, "t1": None, "iters": 2, "steps": 8,
                           "max_t": None, "ba_type": "dense",
                           "motion_only": False}}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in fp64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _step_gaps(out, ref, start) -> dict:
    """Gaps of one update or global-BA step: program `out` against
    reference `ref`, both from `start`."""
    g = start["graph"]
    sel = torch.as_tensor(g["valid"].nonzero()[0],
                          device=ref["target"].device)
    return {"flow": rel(out["target"][sel] - ref["coords"],
                        ref["target"] - ref["coords"]),
            "weight": rel(out["weight"][sel], ref["weight"])}


def _dba_gaps(out, start) -> dict:
    """A frontend step's DBA, replayed by the reference from the
    program's targets, weights and damping after the step: the change of
    the window's poses and of its disparities over the step, each
    against the reference's change."""
    from reference import steps
    g, v = start["graph"], start["video"]
    _, _, base, P, _ = steps.window(start)
    win = slice(base, base + P)
    sel = torch.as_tensor(g["valid"].nonzero()[0],
                          device=out["target"].device)
    poses, disps = steps.update_dba(start, out["target"][sel],
                                    out["weight"][sel], out["damping"][win])
    p0, d0 = v["poses"][win], v["disps"][win]
    return {"poses": rel(out["poses"][win] - p0, poses - p0),
            "disps": rel(out["disps"][win] - d0, disps - d0)}


def reference_outputs(net, kind: str, start: dict):
    """What the reference computes for one captured step."""
    from reference import steps
    if kind == "motion_filter":
        return steps.motion_filter(net, start)
    if kind == "map_step":
        return steps.map_step(start)
    return (steps.update if kind == "update" else steps.lowmem)(net, start)


def _start(kind: str, start: dict) -> dict:
    if kind in ("motion_filter", "map_step"):
        return start
    return dict(start, args=_DEFAULTS[kind] | start["args"])


def _map_gaps(out, ref, start) -> dict:
    """The step's loss, and the gradient as AdamW got it (clipped),
    worked out from its first moment before and after the step: by the
    worst parameter, the gap between the program's norm and the
    reference's, against the larger of that parameter's reference norm
    and the median parameter's."""
    b1 = start["beta1"]
    # no first moment after the step: the optimizer never stepped
    g_prog = [torch.zeros_like(g) if a is None else
              (a - (0.0 if p is None else b1 * p)) / (1.0 - b1)
              for a, p, g in zip(out["exp_avg"], start["exp_avg"],
                                 ref["grads"])]
    nr = [float(g.double().norm()) for g in ref["grads"]]
    med = sorted(nr)[len(nr) // 2]
    grad = max(abs(float(gp.double().norm()) - n) / max(n, med, 1e-30)
               for gp, n in zip(g_prog, nr))
    return {"loss": rel(out["terms"]["total"], ref["terms"]["total"]),
            "grad": grad}


def gaps(kind: str, out: dict, ref: dict, start: dict) -> dict:
    if kind == "map_step":
        return _map_gaps(out, ref, start)
    if kind == "update":
        return _step_gaps(out, ref, start) | _dba_gaps(out, start)
    if kind != "motion_filter":
        return _step_gaps(out, ref, start)
    # the flow against the larger of the reference's and the admit
    # threshold's: the filter compares its mean length with the threshold
    d = ref["delta"].double()
    floor = start["thresh"] * (d[..., 0].numel() ** 0.5)
    return {"fnet": rel(out["fnet"], ref["fnet"]),
            "cnet": rel(out["cnet"], ref["cnet"]),
            "delta": float((out["delta"].double() - d).norm()
                           / max(float(d.norm()), floor))}


# each number compared: the kind of step it reads and the gaps whose
# worst it is
NUMBERS = {"motion_filter": ("motion_filter", ("fnet", "cnet", "delta")),
           "update": ("update", ("flow", "weight")),
           "dba": ("update", ("poses", "disps")),
           "global_ba": ("global_ba", ("flow", "weight")),
           "map_step": ("map_step", ("loss", "grad"))}


class _tf32:
    """TF32 on for fp32 matmuls and convolutions inside the block."""

    def __enter__(self):
        b = torch.backends
        self.old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.old


def compare(capture: Capture, net, against=None) -> Dict[str, dict]:
    """For each number with a sample: {"worst": the number, "per": each
    sampled step's gaps}.  With `against` (the control: the reference
    net in fp8, its fp32 parts in TF32), `against`'s outputs stand in
    for the program's, on the same captured starts."""
    per = {kind: [] for kind in SAMPLE}
    for kind in SAMPLE:
        for item in capture.samples(kind):
            start = _start(kind, item["start"])
            with torch.no_grad():
                ref = reference_outputs(net, kind, start)
                out = item["out"]
                if against is not None:
                    with _tf32():
                        out = _as_program(kind, reference_outputs(
                            against, kind, start), start)
                per[kind].append(gaps(kind, out, ref, start))
    return {name: {"worst": max(max(p[k] for k in keys) for p in per[kind]),
                   "per": per[kind]}
            for name, (kind, keys) in NUMBERS.items() if per[kind]}


def _as_program(kind, ref, start):
    """A reference result laid out as the program's captured results."""
    if kind == "motion_filter":
        return ref
    if kind == "map_step":
        b1 = start["beta1"]
        return {"terms": ref["terms"],
                "exp_avg": [(1.0 - b1) * g + (0.0 if p is None else b1 * p)
                            for g, p in zip(ref["grads"],
                                            start["exp_avg"])]}
    g = start["graph"]
    v = start["video"]
    sel = torch.as_tensor(g["valid"].nonzero()[0],
                          device=ref["target"].device)
    target = g["target"].clone()
    weight = g["weight"].clone()
    target[sel], weight[sel] = ref["target"], ref["weight"]
    w = slice(ref["base"], ref["base"] + ref["P"])
    poses, disps = v["poses"].clone(), v["disps"].clone()
    poses[w], disps[w] = ref["poses"], ref["disps"]
    damping = v["damping"].clone()
    if "damping" in ref:
        damping[w] = ref["damping"]
    return {"poses": poses, "disps": disps, "damping": damping,
            "target": target, "weight": weight}
