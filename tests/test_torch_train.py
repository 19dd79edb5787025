"""The port's DroidNet trainer against the JAX package's, on the CPU.

  * ``make_scene``, ``_edges`` and the learning-rate schedule bit for bit;
  * ``GradClip`` at the JAX package's three sites: the update operator's
    gradient under cotangents large enough to be cut, with a control
    without the clip that misses;
  * one train step (config 64x96, four frames, two unrolled iterations of
    two BA steps, one warm iteration) from the in-tree checkpoint, for a
    key that warms and one that does not: the loss, ``flow_px``,
    ``pose_geo``, ``gnorm`` and every parameter's gradient.  The JAX
    package's exact gradients come out of its own ``make_train_step``
    with an optimizer whose update is zero and whose state is the
    gradient; its random draws are made again from its key splits and
    handed to the port's loss.  A control with the edge system detached
    from the graph (what launching the edge-system kernel on inputs that
    require grad would do) misses the gradient tolerance;
  * the global-norm clip and AdamW over three steps against optax's chain;
  * ``init_droidnet``'s per-layer standard deviations against flax's init;
  * checkpoints both ways, and ``python -m goslam_tpu_torch.train``.

The JAX package's train step runs in a process of its own
(tests/jax_subprocess.py), compiled once for both keys.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jax_subprocess
from goslam_tpu.models import droidnet as jdroidnet
from goslam_tpu.train import trainer as jtrainer
from goslam_tpu_torch.models import droidnet
from goslam_tpu_torch.models.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from goslam_tpu_torch.ops import dba
from goslam_tpu_torch.train import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "droid_synthetic.ckpt")

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

CFG = dict(ht=64, wd=96, n_frames=4, k_iters=2, ba_iters=2, warm_iters=1)
SCENE_SEED = 3
# the port's step against the JAX package's: loss terms and gradient norm
# relative to the JAX value (readings 1.5e-5 to 4.8e-4), each leaf's
# gradient relative to the leaf's largest entry (readings: median 8e-4 to
# 2e-3, largest 2.6e-2, the correlation encoder's first kernel)
LOSS_TOL = 2e-3
GRAD_TOL = 5e-2
# the biases of fnet's convolutions that feed an instance norm, which
# removes them: their gradient is zero but for rounding (readings 1.1e-7
# of the largest gradient entry in either package), held below this share
ZERO_GRAD_TOL = 1e-5


def _zero_grad_leaf(key):
    return (key.startswith("['fnet']") and key.endswith("['bias']")
            and key != "['fnet']['conv2']['bias']")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads: the suite runs several test files at once, and
    more threads than cores slow torch's small operations many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_draws(key, cfg, images_shape, disps_shape):
    """The JAX train step's draws, made again by its own key splits
    (goslam_tpu/train/trainer.py, loss_fn)."""
    N = cfg.n_frames
    key, ka1, ka2, ka3 = jax.random.split(key, 4)
    gain = jax.random.uniform(ka1, (1, 1, 1, 3), minval=0.7, maxval=1.3)
    bias = jax.random.uniform(ka2, (1, 1, 1, 3), minval=-0.1, maxval=0.1)
    noise = 0.02 * jax.random.normal(ka3, images_shape)
    k1, k2, k3 = jax.random.split(key, 3)
    xi = (0.03 * jax.random.normal(k1, (N, 6))).at[0].set(0.0)
    use_ident = jax.random.uniform(k3, ()) < cfg.ident_prob
    log_disp = 0.2 * jax.random.normal(k2, disps_shape)
    key, kw = jax.random.split(key)
    do_warm = jax.random.uniform(kw, ()) < cfg.warm_prob
    return dict(gain=gain, bias=bias, noise=noise, xi=xi, log_disp=log_disp,
                use_ident=bool(use_ident), do_warm=bool(do_warm))


def _jax_main(out):
    """The JAX package's train step for a key that warms and one that does
    not, and its init's per-layer standard deviations; in a process of its
    own (jax_subprocess)."""
    # imported before the step is traced: the trainer imports it inside
    # its loss, and a first import there leaks its constants as tracers
    # into the next trace
    import goslam_tpu.tracking.motion_filter  # noqa: F401
    from goslam_tpu.system import init_params

    cfg = jtrainer.TrainConfig(**CFG)
    scene = jtrainer.make_scene(SCENE_SEED, cfg)
    with open(CKPT, "rb") as f:
        params = pickle.load(f)["params"]

    def zero_update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), zero_update)
    step = jtrainer.make_train_step(
        cfg, jdroidnet.DroidNet(num_frames=cfg.n_frames), tx)
    jparams = jax.tree.map(jnp.asarray, params)
    runs, seed = {}, 0
    while len(runs) < 2:
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, cfg, scene[0].shape, scene[2].shape)
        name = "warm" if draws["do_warm"] else "cold"
        if name not in runs:
            _, grads, m = step(jparams, tx.init(jparams),
                               *map(jnp.asarray, scene), key)
            runs[name] = dict(draws=draws, grads=grads,
                              metrics={k: float(v) for k, v in m.items()})
        seed += 1
    init = init_params(seed=0)
    stds = {k: float(np.std(v)) for k, v in _leaves(init).items()
            if k.endswith("['kernel']")}
    sizes = {k: np.size(v) for k, v in _leaves(init).items()}
    return dict(scene=scene, params=params, runs=runs, init_stds=stds,
                init_sizes=sizes,
                init_bias_max=max(float(np.abs(v).max()) for k, v in
                                  _leaves(init).items()
                                  if k.endswith("['bias']")))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return jax_subprocess.run("test_torch_train",
                              str(tmp_path_factory.mktemp("jax")))


def _port_step(jax_run, name, detach_ba=False, monkeypatch=None):
    """The port's loss and gradients for the JAX run's scene, parameters
    and draws."""
    cfg = trainer.TrainConfig(**CFG)
    model = droidnet.DroidNet()
    model.load_state_dict(flax_to_state_dict(jax_run["params"]))
    d = jax_run["runs"][name]["draws"]
    draws = trainer.Draws(**{k: torch.from_numpy(np.asarray(v))
                             if not isinstance(v, bool) else v
                             for k, v in d.items()})
    if detach_ba:
        plain = dba.build_edge_system_plain
        monkeypatch.setattr(dba, "build_edge_system_plain", lambda *a: (
            dba.EdgeSystem(*[t.detach() for t in plain(*a)])))
    loss, metrics, grads = trainer.Trainer(cfg, model).gradients(
        *[torch.from_numpy(a) for a in jax_run["scene"]], draws)
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    for p, g in zip(model.parameters(), grads):
        p.grad = g
    return (dict(loss=float(loss), gnorm=gnorm,
                 **{k: float(v) for k, v in metrics.items()}),
            _leaves(_flax_grads(model)))


def _grad_errors(port_grads, jax_grads):
    """Each leaf's error relative to its largest entry, but for the leaves
    whose gradient is zero up to rounding, which are held to be small in
    both packages instead."""
    want = _leaves(jax_grads)
    assert set(port_grads) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k in filter(_zero_grad_leaf, want):
        assert np.abs(want[k]).max() <= ZERO_GRAD_TOL * scale, k
        assert np.abs(port_grads[k]).max() <= ZERO_GRAD_TOL * scale, k
    return {k: _rel(port_grads[k], want[k]) for k in want
            if not _zero_grad_leaf(k)}


@pytest.mark.parametrize("name", ["warm", "cold"])
def test_train_step_matches_jax(jax_run, name):
    """Loss, flow_px, pose_geo and gnorm within LOSS_TOL of the JAX
    package's, every leaf's gradient within GRAD_TOL of the leaf's largest
    entry.  The "cold" key starts every pose at frame 0's: no baseline,
    so BA's disparity rows are damped by 1e-7 alone and amplify rounding
    by 1e7 (with every bf16 rounding taken out of both packages the loss
    still differs by 1.1e-4 there, against 2e-6 for the "warm" key; the
    JAX package's own BA, jitted and not, differs by as much).  Where the
    forward rounds to bf16 (the unroll's inputs, the correlation volume),
    an fp32 sum taken in another order can round the other way."""
    jr = jax_run["runs"][name]
    assert jr["draws"]["do_warm"] == (name == "warm")
    got, grads = _port_step(jax_run, name)
    for k in ("loss", "flow_px", "pose_geo", "gnorm"):
        assert abs(got[k] - jr["metrics"][k]) <= LOSS_TOL * abs(
            jr["metrics"][k]), (k, got[k], jr["metrics"][k])
    errs = _grad_errors(grads, jr["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_detached_edge_system_misses_the_gradient_tolerance(jax_run,
                                                           monkeypatch):
    """The control: with the edge system's outputs detached, BA passes no
    gradient back to the update operator's targets, weights and damping,
    and the gradients miss GRAD_TOL by far."""
    got, grads = _port_step(jax_run, "cold", detach_ba=True,
                            monkeypatch=monkeypatch)
    errs = _grad_errors(grads, jax_run["runs"]["cold"]["grads"])
    assert max(errs.values()) > 10 * GRAD_TOL


def test_edge_system_kernel_refuses_inputs_that_require_grad():
    """On a device other than the CPU, build_edge_system would launch the
    kernel, which has no backward: it raises for inputs that require grad
    (shapes on the meta device suffice, nothing is launched)."""
    E, P, h, w = 3, 2, 4, 5
    args = [torch.zeros(s, device="meta") for s in (
        (P, 7), (P, h, w), (4,), (E, h, w, 2), (E, h, w, 2))]
    idx = [torch.zeros(E, dtype=torch.long, device="meta")] * 2
    valid = torch.ones(E, dtype=torch.bool, device="meta")
    args[0].requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        dba.build_edge_system(*args, *idx, valid)
    with pytest.raises(ValueError, match="fused must be None or False"):
        dba.ba(*args[:3], args[1], *args[3:], args[1], *idx, valid, 0, 1,
               fused=True)


@pytest.mark.parametrize("clip", [True, False])
def test_update_module_grad_clip_matches_jax(monkeypatch, clip):
    """The update operator's gradient under unit cotangents on delta,
    weight and eta, which GradClip cuts at all three sites: the port's
    within 1e-4 of the JAX package's; without the port's GradClip
    (control) the delta and weight heads' gradients miss by far."""
    rng = np.random.default_rng(0)
    E, P, h, w = 3, 2, 3, 4
    with open(CKPT, "rb") as f:
        params = pickle.load(f)["params"]
    ins = [rng.standard_normal((E, h, w, c)).astype(np.float32)
           for c in (128, 128, 196, 4)]
    ii = np.asarray([0, 1, 1])
    cot = [rng.standard_normal(s).astype(np.float32)
           for s in ((E, h, w, 2), (E, h, w, 2), (P, h, w))]

    mod = jdroidnet.UpdateModule(num_frames=P)

    def f(p):
        _, delta, weight, eta, _, _ = mod.apply(
            {"params": p}, *map(jnp.asarray, ins), jnp.asarray(ii),
            jnp.ones(E, bool))
        return sum((a * jnp.asarray(c)).sum()
                   for a, c in zip((delta, weight, eta), cot))

    want = jax.grad(f)(jax.tree.map(jnp.asarray, params["update"]))
    if not clip:
        monkeypatch.setattr(droidnet, "grad_clip", lambda x: x)
    model = droidnet.DroidNet()
    model.load_state_dict(flax_to_state_dict(params))
    _, delta, weight, eta, _, _ = model.update(
        *[torch.from_numpy(a) for a in ins], dtype=torch.float32,
        ii=torch.from_numpy(ii), edge_valid=torch.ones(E, dtype=torch.bool),
        num_frames=P)
    sum((a * torch.from_numpy(c)).sum()
        for a, c in zip((delta, weight, eta), cot)).backward()
    got = _leaves(_flax_grads(model)["update"])
    errs = {k: _rel(got[k], v) for k, v in _leaves(want).items()}
    heads = [k for k in errs if "delta2" in k or "weight2" in k]
    assert heads
    if clip:
        assert max(errs.values()) <= 1e-4, errs
    else:
        assert min(errs[k] for k in heads) > 1e-1, errs


def _flax_grads(model):
    """The .grad of every parameter (zeros where none) as a flax tree."""
    sd = {n: torch.zeros_like(p) if p.grad is None else p.grad
          for n, p in model.named_parameters()}
    sd["weight_calib"] = torch.ones(())
    return state_dict_to_flax(sd)


def _motion_mode(seed):
    """make_scene's motion regime for a seed (its first draws, replayed)."""
    rng = np.random.default_rng(seed)
    rng.uniform(2.0, 4.0)
    rng.uniform(1.2, 4.0, 6)
    rng.uniform(0.0, 6.28, 6)
    rng.uniform(0, 2 * np.pi)
    return str(rng.choice(["orbit", "translate", "rotate"],
                          p=[0.4, 0.35, 0.25]))


def test_make_scene_edges_and_schedule_are_the_jax_packages():
    """make_scene at two resolutions and all three motion regimes, the
    edge lists with and without long skips, and the learning rate at
    every step count: bit for bit."""
    seeds = (0, 1, 4, 7, 11)
    assert {_motion_mode(s) for s in seeds} == {"orbit", "translate",
                                                 "rotate"}
    for seed, (ht, wd) in zip(seeds, ((64, 96), (64, 96), (48, 64),
                                      (48, 64), (64, 96))):
        cfg = trainer.TrainConfig(ht=ht, wd=wd, n_frames=5)
        jcfg = jtrainer.TrainConfig(ht=ht, wd=wd, n_frames=5)
        for a, b in zip(trainer.make_scene(seed, cfg),
                        jtrainer.make_scene(seed, jcfg)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for n, radius, skips in ((4, 2, ()), (7, 2, (4, 6)), (9, 1, (3,))):
        for a, b in zip(trainer._edges(n, radius, skips),
                        jtrainer._edges(n, radius, skips)):
            np.testing.assert_array_equal(a, b)
    sched = optax.linear_schedule(2.5e-4, 2.5e-5, 100)
    for count in (0, 1, 37, 99, 100, 150):
        assert trainer.linear_schedule(2.5e-4, 100, count) == \
            float(sched(count))
    assert dataclasses.asdict(trainer.TrainConfig()) == \
        dataclasses.asdict(jtrainer.TrainConfig())


def test_clip_and_adamw_match_optax_over_three_steps():
    """Three steps of the port's clip and AdamW against optax's chain on
    the same gradients (one step clipped, two not), at the schedule's
    learning rates: parameters within 1e-6 of their scale."""
    rng = np.random.default_rng(1)
    cfg = trainer.TrainConfig(lr=1e-2, steps=3, clip=2.5,
                              weight_decay=1e-2)
    model = droidnet.DroidNet()
    names = [n for n, _ in model.named_parameters()][:4]
    params = {n: rng.standard_normal(p.shape).astype(np.float32)
              for n, p in model.named_parameters() if n in names}
    gseq = [{n: (s * rng.standard_normal(v.shape)).astype(np.float32)
             for n, v in params.items()} for s in (1.0, 1e-3, 1e-2)]
    tx = optax.chain(optax.clip_by_global_norm(cfg.clip), optax.adamw(
        optax.linear_schedule(cfg.lr, cfg.lr * 0.1, cfg.steps),
        weight_decay=cfg.weight_decay))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jp)

    class Params(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.p = torch.nn.ParameterList(
                [torch.nn.Parameter(torch.from_numpy(params[n].copy()))
                 for n in names])

    mod = Params()
    tr = trainer.Trainer(cfg, mod)
    for g in gseq:
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        tr.apply([torch.from_numpy(g[n]) for n in names])
        for n, p in zip(names, mod.p):
            assert _rel(p.detach().numpy(), jp[n]) <= 1e-6, n
    assert tr.count == 3


def test_init_matches_flax_init_statistics(jax_run):
    """Per layer, the standard deviation of init_droidnet's kernels within
    five standard errors of flax's (both draw lecun-normal kernels,
    truncated at two standard deviations), and zero biases."""
    model = droidnet.init_droidnet(seed=0)
    sd = {n: t for n, t in model.state_dict().items()}
    ours = _leaves(state_dict_to_flax(sd))
    stds, sizes = jax_run["init_stds"], jax_run["init_sizes"]
    assert set(stds) == {k for k in ours if k.endswith("['kernel']")}
    for k, s in stds.items():
        se = s / np.sqrt(2 * sizes[k])
        assert abs(np.std(ours[k]) - s) <= 5 * np.sqrt(2) * se, k
    assert jax_run["init_bias_max"] == 0.0
    assert all(not ours[k].any() for k in ours if k.endswith("['bias']"))


def test_checkpoints_round_trip_both_ways(tmp_path, jax_run):
    """flax -> state dict -> flax is bit-exact on the in-tree checkpoint;
    a checkpoint the port writes after a train step is read by the JAX
    package's load_checkpoint leaf for leaf, and by the port's
    load_checkpoint equal to the parameters in memory."""
    params = jax_run["params"]
    back = state_dict_to_flax(flax_to_state_dict(params))
    a, b = _leaves(params), _leaves(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])

    cfg = trainer.TrainConfig(**dict(CFG, k_iters=1))
    model = droidnet.DroidNet()
    model.load_state_dict(flax_to_state_dict(params))
    tr = trainer.Trainer(cfg, model)
    gen = torch.Generator().manual_seed(0)
    tr.step(*[torch.from_numpy(x) for x in jax_run["scene"]],
            trainer.sample_draws(cfg, CFG["ht"], CFG["wd"], gen))
    path = str(tmp_path / "t.ckpt")
    trainer.save_checkpoint(path, model, cfg)
    jp, jcfg = jtrainer.load_checkpoint(path)
    ours = _leaves(state_dict_to_flax(model.state_dict()))
    theirs = _leaves(jp)
    assert ours.keys() == theirs.keys()
    assert any(not np.array_equal(ours[k], a[k]) for k in ours)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert jcfg == dataclasses.asdict(cfg)
    sd, pcfg = trainer.load_checkpoint(path)
    for n, t in model.state_dict().items():
        assert torch.equal(sd[n], t), n


def test_train_entry_point_writes_a_checkpoint_the_system_loads(tmp_path):
    """python -m goslam_tpu_torch.train --device cpu --steps 2 trains and
    writes a checkpoint that SLAMSystem loads and tracks with."""
    out = str(tmp_path / "droid.ckpt")
    res = subprocess.run(
        [sys.executable, "-m", "goslam_tpu_torch.train", "--device", "cpu",
         "--steps", "2", "--ht", "64", "--wd", "96", "--scenes", "2",
         "--multires", "", "--resume", CKPT, "--out", out,
         "--log", str(tmp_path / "log.txt")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "resumed from" in res.stdout and "saved" in res.stdout
    with open(tmp_path / "log.txt") as f:
        assert len(f.read().splitlines()) == 2

    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem
    cfg = update_recursive(default_config(), {
        "dataset": "synthetic", "mode": "rgbd", "only_tracking": True,
        "cam": {"H": 64, "W": 96, "H_out": 64, "W_out": 96,
                "H_edge": 0, "W_edge": 0},
        "data": {"input_folder": "", "n_frames": 3},
        "tracking": {"buffer": 8, "motion_filter": {"thresh": -1.0},
                     "frontend": {"enable_loop": False}}})
    sd = load_checkpoint(out)
    slam = SLAMSystem(cfg, state_dict=sd, output=str(tmp_path),
                      device="cpu")
    for n, t in slam.net.state_dict().items():
        assert torch.equal(t, sd[n]), n
    ds = Synthetic(cfg)
    for i in range(len(ds)):
        _, img, depth, intr, gt = ds[i]
        slam.track(float(i), img, depth, intr, gt)
    assert slam.video.counter == 3
    assert torch.isfinite(slam.video.poses[:3]).all()
