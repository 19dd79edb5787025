"""Train DroidNet on synthetic scenes (the JAX package's trainer in PyTorch).

The tracking checkpoint ``checkpoints/droid_synthetic.ckpt`` is not
DROID's pretrained ``droid.pth`` (which the repository does not carry):
it was trained from scratch on the analytic synthetic domain, and this
module trains or refines it.  A step renders nothing: clips come from a
pool of seeded scenes (``make_scene``).  It unrolls K update-operator
iterations with dense bundle adjustment in the loop, differentiating
through the damped Cholesky solve, and supervises

  * flow: predicted correspondences against the ground-truth
    reprojection,
  * pose: the geodesic distance to ground truth after each BA step,

with later iterations weighted higher (gamma^(K-1-k)).

Precision follows the JAX trainer's code: every convolution runs in
fp32 (the model's ``dtype=torch.float32``) on inputs that the unroll
rounds to bf16 once an iteration (hidden state, context, correlation and
motion features); the correlation volume is stored in bf16; the
geometry and BA are fp32.

The random draws of a step (photometric augmentation, the initial pose
and disparity perturbation, identity start, warm start) come from
``sample_draws`` and enter ``train_loss`` as arguments, so a test can
feed the JAX package's own draws.  The optimizer is optax's recipe:
the gradient clipped to a global norm, then AdamW with decoupled weight
decay on every parameter and a learning rate falling linearly to a tenth
of its start over ``steps``.  Checkpoints are the JAX trainer's pickle:
``{"params": <flax tree of fp32 numpy>, "config": asdict(TrainConfig)}``.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..data.synthetic import _ray_box_exit
from ..mapping.mapper import clip_by_global_norm
from ..models.convert import flax_to_state_dict, state_dict_to_flax
from ..models.droidnet import DroidNet, init_droidnet
from ..ops import corr, dba, lie, projective
from ..tracking.motion_filter import normalize_images

EPS_DAMP = 1e-7
MOTION_CLAMP = 64.0


@dataclasses.dataclass
class TrainConfig:
    ht: int = 64
    wd: int = 96
    n_frames: int = 7
    radius: int = 2          # graph |i-j| <= radius
    k_iters: int = 8         # unrolled update iterations
    ba_iters: int = 2
    # "mixed": ident_prob of the steps start every frame at frame 0's
    # pose (multi-pixel flows, the runtime's zero-motion extrapolation),
    # the rest from small perturbations of the ground truth (the
    # near-converged regime); "identity" or "gt_perturb" always one
    init_mode: str = "mixed"
    ident_prob: float = 0.25
    gamma: float = 0.9
    lr: float = 2.5e-4
    weight_decay: float = 1e-5
    steps: int = 4000
    n_scenes: int = 256
    seed: int = 0
    flow_w: float = 0.1
    pose_w: float = 10.0
    clip: float = 2.5
    # with warm_prob, warm_iters update and BA iterations run without
    # gradients first, so that the supervised unroll starts from a
    # partially converged state
    warm_prob: float = 0.3
    warm_iters: int = 3
    # exposure gain and bias per clip and pixel noise
    photo_aug: bool = True
    # further (ht, wd) resolutions mixed into the scene pool
    multires: tuple = ()
    # wide-baseline pairs added to the |i-j| <= radius graph (_edges)
    long_skips: tuple = (4, 6)


def _texture_rand(p, ph):
    """Synthetic room texture with randomized frequencies and phases."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.5 * np.sin(ph[0] * x + ph[1]) * np.cos(ph[2] * y + ph[3])
    g = 0.5 + 0.5 * np.sin(ph[4] * y + ph[5]) * np.cos(ph[6] * z + ph[7])
    b = 0.5 + 0.5 * np.sin(ph[8] * z + ph[9]) * np.cos(ph[10] * x + ph[11])
    return np.stack([r, g, b], axis=-1)


def make_scene(seed: int, cfg: TrainConfig):
    """Render one randomized room clip (numpy and scipy, bit for bit the
    JAX package's).

    Returns (images [N,ht,wd,3], poses_w2c [N,7], disps_gt [N,h8,w8],
    intrinsics_8 [4]), disparities at 1/8 resolution.  The camera moves
    in one of three regimes: an orbit, a translation, a pan in place."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    H, W, N = cfg.ht, cfg.wd, cfg.n_frames
    half = rng.uniform(2.0, 4.0)
    ph = np.empty(12)
    ph[0::2] = rng.uniform(1.2, 4.0, 6)
    ph[1::2] = rng.uniform(0.0, 6.28, 6)

    fx = fy = 0.9 * W
    cx, cy = W / 2 - 0.5, H / 2 - 0.5

    a0 = rng.uniform(0, 2 * np.pi)
    mode = rng.choice(["orbit", "translate", "rotate"],
                      p=[0.4, 0.35, 0.25])
    if mode == "orbit":
        da = rng.uniform(0.02, 0.15) * rng.choice([-1.0, 1.0])
        rad = rng.uniform(0.4, 0.25 * half)
        step_v = np.zeros(3)
    elif mode == "translate":
        da = rng.uniform(0.0, 0.03) * rng.choice([-1.0, 1.0])
        rad = 0.0
        v = rng.standard_normal(3)
        v[1] *= 0.3                      # mostly horizontal
        v /= np.linalg.norm(v) + 1e-9
        # the whole clip stays inside the room
        step_v = v * min(rng.uniform(0.05, 0.22), 0.3 * half / N)
    else:                                # a pan in place
        da = rng.uniform(0.05, 0.2) * rng.choice([-1.0, 1.0])
        rad = 0.0
        step_v = np.zeros(3)
    base_p = rng.uniform(-0.2 * half, 0.2 * half, 3)
    base_p[1] *= 0.5
    c2ws = []
    for k in range(N):
        a = a0 + da * k
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.asarray([
            [np.cos(a), 0, np.sin(a)],
            [0, 1, 0],
            [-np.sin(a), 0, np.cos(a)]], np.float32)
        if mode == "orbit":
            c2w[:3, 3] = [rad * np.sin(a) + rng.normal(0, 0.01),
                          0.3 * np.sin(2.5 * a) + rng.normal(0, 0.01),
                          rad * np.cos(a) - 0.3 + rng.normal(0, 0.01)]
        else:
            c2w[:3, 3] = base_p + step_v * k + rng.normal(0, 0.01, 3)
        c2ws.append(c2w)

    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], -1)

    imgs, depths = [], []
    for c2w in c2ws:
        dirs_w = dirs @ c2w[:3, :3].T
        o = c2w[:3, 3]
        t_exit = _ray_box_exit(o, dirs_w, half)
        pts = o[None, None, :] + dirs_w * t_exit[..., None]
        imgs.append(_texture_rand(pts, ph).astype(np.float32))
        depths.append((t_exit * dirs[..., 2]).astype(np.float32))

    images = np.stack(imgs)
    depth = np.stack(depths)
    # 1/8-resolution disparity, strided as the motion filter samples
    d8 = depth[:, 3::8, 3::8]
    disps_gt = 1.0 / np.maximum(d8, 1e-3)
    poses_w2c = np.empty((N, 7), np.float32)
    for k, m in enumerate(c2ws):
        Rw = m[:3, :3].T                      # w2c rotation
        tw = -Rw @ m[:3, 3]
        poses_w2c[k, :3] = tw
        poses_w2c[k, 3:] = Rotation.from_matrix(Rw).as_quat()  # x y z w
    intr8 = np.asarray([fx / 8, fy / 8, cx / 8, cy / 8], np.float32)
    return images, poses_w2c, disps_gt, intr8


def _edges(n: int, radius: int, long_skips: tuple = ()):
    """Dense |i-j| <= radius edges plus symmetric long-skip pairs (the
    backend proposes edges far beyond the frontend's window)."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = (ii != jj) & (np.abs(ii - jj) <= radius)
    pairs = {(int(a), int(b)) for a, b in zip(ii[keep], jj[keep])}
    for s in long_skips:
        for i in range(0, n - s):
            pairs.add((i, i + s))
            pairs.add((i + s, i))
    arr = np.asarray(sorted(pairs), np.int32)
    return arr[:, 0], arr[:, 1]


def _pose_loss(poses, poses_gt):
    """Geodesic loss on poses relative to frame 0 (gauge-fixed)."""
    ra = lie.rel(poses[0].expand_as(poses), poses)
    rb = lie.rel(poses_gt[0].expand_as(poses_gt), poses_gt)
    dxi = lie.log(lie.compose(ra, lie.inv(rb)))
    return torch.sqrt((dxi ** 2).sum(-1) + 1e-12).mean()


class Draws(NamedTuple):
    """The random draws of one train step."""
    gain: torch.Tensor       # [1, 1, 1, 3] exposure gain in [0.7, 1.3)
    bias: torch.Tensor       # [1, 1, 1, 3] exposure bias in [-0.1, 0.1)
    noise: torch.Tensor      # [N, ht, wd, 3] pixel noise, 0.02 N(0, 1)
    xi: torch.Tensor         # [N, 6] pose perturbation, 0.03 N(0, 1), row 0 zero
    log_disp: torch.Tensor   # [N, h8, w8] log-disparity noise, 0.2 N(0, 1)
    use_ident: bool          # start every pose at frame 0's
    do_warm: bool            # warm the state without gradients first

    def to(self, device) -> "Draws":
        return self._replace(**{k: getattr(self, k).to(device) for k in (
            "gain", "bias", "noise", "xi", "log_disp")})


def sample_draws(cfg: TrainConfig, ht: int, wd: int,
                 gen: torch.Generator) -> Draws:
    """A step's draws for clips of ht x wd from `gen`, on its device."""
    N = cfg.n_frames
    dev = gen.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def normal(shape, std):
        return std * torch.randn(shape, generator=gen, device=dev)

    gain = uniform((1, 1, 1, 3), 0.7, 1.3)
    bias = uniform((1, 1, 1, 3), -0.1, 0.1)
    noise = normal((N, ht, wd, 3), 0.02)
    xi = normal((N, 6), 0.03)
    xi[0] = 0.0
    log_disp = normal((N, ht // 8, wd // 8), 0.2)
    flags = torch.rand(2, generator=gen, device=dev).tolist()
    use_ident = (flags[0] < cfg.ident_prob if cfg.init_mode == "mixed"
                 else cfg.init_mode == "identity")
    return Draws(gain, bias, noise, xi, log_disp, use_ident,
                 flags[1] < cfg.warm_prob)


def train_loss(model: DroidNet, cfg: TrainConfig, images, poses_gt,
               disps_gt, intr8, draws: Draws):
    """The training loss of one clip: images [N,ht,wd,3] in [0, 1],
    poses_gt [N,7] (w2c), disps_gt [N,h8,w8], intr8 [4] (1/8 res), all on
    the model's device.  Returns (loss, {"flow_px", "pose_geo"} of the
    last iteration), scalar tensors."""
    dev = images.device
    f32, bf16 = torch.float32, torch.bfloat16
    N = cfg.n_frames
    ii_np, jj_np = _edges(N, cfg.radius, cfg.long_skips)
    ii = torch.as_tensor(ii_np, dtype=torch.long, device=dev)
    jj = torch.as_tensor(jj_np, dtype=torch.long, device=dev)
    valid = torch.ones(len(ii_np), dtype=torch.bool, device=dev)
    h8, w8 = disps_gt.shape[-2:]
    d = draws.to(dev)

    if cfg.photo_aug:
        images = (images * d.gain + d.bias + d.noise).clamp(0.0, 1.0)
    # the runtime's normalization (tracking/motion_filter.py)
    x = normalize_images(images)
    fmaps = model.fnet(x, f32)
    net0, inp = model.encode_context(x, f32)
    pyramid = corr.build_pyramid(fmaps[ii], fmaps[jj])
    gt_coords, _ = projective.transform(poses_gt, disps_gt, intr8, ii, jj)

    # frame 0 is fixed; BA optimizes the poses [1, N)
    poses = (poses_gt[0].expand_as(poses_gt) if d.use_ident
             else lie.compose(lie.exp(d.xi), poses_gt))
    disps = disps_gt * torch.exp(d.log_disp)
    net, inps = net0[ii], inp[ii]
    target = projective.transform(poses, disps, intr8, ii, jj)[0]
    grid = projective.coords_grid(h8, w8, dev)

    def update_iter(net, poses, disps, target):
        coords1, _ = projective.transform(poses, disps, intr8, ii, jj)
        motion = torch.cat([coords1 - grid, target - coords1], dim=-1) \
            .clamp(-MOTION_CLAMP, MOTION_CLAMP)
        corr_feat = corr.lookup(pyramid, coords1)
        net, delta, weight, eta, _, _ = model.update(
            net.to(bf16), inps.to(bf16), corr_feat.to(bf16),
            motion.to(bf16), dtype=f32, ii=ii, edge_valid=valid,
            num_frames=N)
        target = coords1 + delta.float()
        weight = weight.float()
        eta_ba = 0.2 * eta.float() + EPS_DAMP
        poses, disps = dba.ba(
            poses, disps, intr8, torch.zeros_like(disps), target, weight,
            eta_ba, ii, jj, valid, 1, N, iters=cfg.ba_iters, solver="chol",
            fused=False)
        return net, poses, disps, target, weight

    if cfg.warm_prob > 0 and cfg.warm_iters > 0 and d.do_warm:
        with torch.no_grad():
            for _ in range(cfg.warm_iters):
                net, poses, disps, target, _ = update_iter(net, poses, disps,
                                                           target)

    total = 0.0
    for k in range(cfg.k_iters):
        net, poses, disps, target, _ = update_iter(net, poses, disps, target)
        w_k = cfg.gamma ** (cfg.k_iters - 1 - k)
        fl = (target - gt_coords).abs().mean()
        pl = _pose_loss(poses, poses_gt)
        total = total + w_k * (cfg.flow_w * fl + cfg.pose_w * pl)
    return total, {"flow_px": fl.detach(), "pose_geo": pl.detach()}


def linear_schedule(lr: float, steps: int, count: int) -> float:
    """optax.linear_schedule(lr, 0.1 * lr, steps) at `count`, in fp32 as
    optax computes it."""
    f32 = np.float32
    frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
    return float(f32(lr - lr * 0.1) * frac + f32(lr * 0.1))


class Trainer:
    """Optimizer state and one train step of `model` (on its device)."""

    def __init__(self, cfg: TrainConfig, model: DroidNet):
        self.cfg = cfg
        self.model = model
        self.params = list(model.parameters())
        self.opt = torch.optim.AdamW(self.params, lr=cfg.lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        self.count = 0

    def gradients(self, images, poses_gt, disps_gt, intr8, draws: Draws):
        """(loss, metrics, gradients of every parameter) of one clip; a
        parameter the loss does not reach (the upsampling mask's head)
        gets a zero gradient."""
        loss, metrics = train_loss(self.model, self.cfg, images, poses_gt,
                                   disps_gt, intr8, draws)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        return loss.detach(), metrics, grads

    def apply(self, grads):
        """Clip to the global norm, then one AdamW step at the learning
        rate of the step count before the update."""
        lr = linear_schedule(self.cfg.lr, self.cfg.steps, self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        for p, g in zip(self.params, clip_by_global_norm(grads,
                                                          self.cfg.clip)):
            p.grad = g
        self.opt.step()
        for p in self.params:
            p.grad = None
        self.count += 1

    def step(self, images, poses_gt, disps_gt, intr8,
             draws: Draws) -> Dict[str, torch.Tensor]:
        """One train step; returns its metrics as tensors on the device
        (loss, flow_px, pose_geo, and gnorm, the gradient's global norm
        before clipping)."""
        loss, metrics, grads = self.gradients(images, poses_gt, disps_gt,
                                              intr8, draws)
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
        self.apply(grads)
        return dict(metrics, loss=loss, gnorm=gnorm)


def fit(cfg: TrainConfig, out_path: str, log_every: int = 50,
        model: Optional[DroidNet] = None, log_file: Optional[str] = None,
        device=None) -> DroidNet:
    """Train and save a checkpoint; `device` defaults to the GPU.  Each
    step draws its scene with numpy's generator seeded with cfg.seed, as
    the JAX trainer does, and its random draws from a torch generator
    seeded alike."""
    from ..system import resolve_device

    dev = resolve_device(device)
    model = (model if model is not None else init_droidnet()).to(dev)
    trainer = Trainer(cfg, model)

    print(f"rendering {cfg.n_scenes} scenes ...", flush=True)
    # the resolutions of multires take turns with (ht, wd)
    rescfgs = [cfg] + [dataclasses.replace(cfg, ht=h, wd=w)
                       for (h, w) in (cfg.multires or ())]
    scenes = [make_scene(cfg.seed * 10007 + s, rescfgs[s % len(rescfgs)])
              for s in range(cfg.n_scenes)]
    rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator().manual_seed(cfg.seed)
    t0 = time.time()
    logf = open(log_file, "a") if log_file else None
    try:
        for step in range(cfg.steps):
            images, poses_gt, disps_gt, intr8 = [
                torch.from_numpy(a).to(dev)
                for a in scenes[rng.integers(len(scenes))]]
            draws = sample_draws(cfg, images.shape[1], images.shape[2], gen)
            m = trainer.step(images, poses_gt, disps_gt, intr8, draws)
            if step % log_every == 0 or step == cfg.steps - 1:
                m = {k: float(v) for k, v in m.items()}
                line = (f"step {step:5d} loss {m['loss']:.4f} "
                        f"flow {m['flow_px']:.3f}px pose "
                        f"{m['pose_geo']:.5f} gnorm {m['gnorm']:.2f} "
                        f"({(time.time() - t0):.0f}s)")
                print(line, flush=True)
                if logf:
                    logf.write(line + "\n")
                    logf.flush()
                if not np.isfinite(m["loss"]):
                    raise RuntimeError("loss diverged")
                save_checkpoint(out_path, model, cfg)
        save_checkpoint(out_path, model, cfg)
    finally:
        if logf:
            logf.close()
    return model


def save_checkpoint(path: str, model: DroidNet, cfg: TrainConfig):
    """The JAX trainer's checkpoint: the flax tree of fp32 numpy arrays
    and the config, pickled."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = {"params": state_dict_to_flax(model.state_dict()),
             "config": dataclasses.asdict(cfg)}
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load_checkpoint(path: str):
    """(the port's state dict, the config dict) of a trainer checkpoint,
    the JAX trainer's or this one's."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    return flax_to_state_dict(state["params"]), state["config"]
