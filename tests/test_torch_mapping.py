"""The port's mapping modules against the JAX package, on the CPU.

Hash grid (indices, features and both gradients), InstantNeuS with
converted parameters (outputs and parameter gradients), z sampling with
the JAX package's draws, the SDF losses, one optimizer step, one pose-BA
step, the masked ray sampling with the JAX package's keys and the frame
schedule of three mapper rounds.  Inputs are made with numpy from a seed;
where the JAX package draws on its device, its draws are passed to the
port's functions (their device draws are arguments for that reason).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goslam_tpu.config import default_config as jdefault_config
from goslam_tpu.mapping import mapper as jmapper
from goslam_tpu.mapping.hashgrid import HashGrid as JHashGrid
from goslam_tpu.mapping.instant_neus import InstantNeuS as JNeuS
from goslam_tpu.mapping.instant_neus import \
    compute_sdf_losses as jcompute_sdf_losses
from goslam_tpu.mapping import renderer as jrenderer
from goslam_tpu.mapping.renderer import sample_z_vals as jsample_z_vals
from goslam_tpu.ops import lie as jlie
from goslam_tpu.tracking.video import VideoBuffer as JVideo
from goslam_tpu_torch.config import default_config, update_recursive
from goslam_tpu_torch.mapping import mapper, renderer
from goslam_tpu_torch.mapping.hashgrid import HashGrid
from goslam_tpu_torch.mapping.instant_neus import (InstantNeuS,
                                                   compute_sdf_losses)
from goslam_tpu_torch.mapping.renderer import sample_z_vals
from goslam_tpu_torch.models.convert import convert_mapping_params
from goslam_tpu_torch.tracking.video import VideoBuffer

BOUND = np.asarray([[-2.0, 2.0], [-1.5, 2.5], [-2.0, 1.0]], np.float32)


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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_grads(got: dict, expect: dict, fp64: dict):
    """The port's fp32 gradients (got) against the JAX package's
    (expect), by parameter name: each within 1e-5 of the JAX package's,
    relative to its largest entry.  Where fp32 rounding is larger than
    that (a sample near a cell boundary of a fine level, a ReLU at its
    kink, a sum over all samples with cancellation), the port is no
    farther from the fp64 gradient on the same inputs (fp64: the port's,
    which _assert_fp64_grads holds to the JAX package's) than 1e-4, or
    than four times the JAX package is.  The variance's gradient is one
    number summed over every sample, some of whose alphas sit at their
    clip, where a rounding moves a sample's whole share: within 1e-3 of
    the JAX package's."""
    assert got.keys() == expect.keys() == fp64.keys()
    for n in got:
        if _rel(got[n], expect[n]) <= 1e-5:
            continue
        if got[n].ndim == 0:
            assert _rel(got[n], expect[n]) <= 1e-3, n
            continue
        assert _rel(got[n], fp64[n]) <= max(
            1e-4, 4 * _rel(expect[n], fp64[n])), n


def _assert_fp64_grads(port: dict, jax_: dict):
    """In fp64 the port computes the JAX package's gradient: on the same
    inputs (the JAX package run with 64-bit floats, its jitter drawn as
    float64), every gradient within 1e-8 of its largest entry; readings
    are 1e-15 to 5e-10, the largest on sums over every sample."""
    assert port.keys() == jax_.keys()
    for n in port:
        assert _rel(port[n], jax_[n]) <= 1e-8, n


def _jax64(fn, *args):
    """fn(*args) in the JAX package with 64-bit floats: the floating
    arrays of args (pytrees of numpy or JAX arrays) cast to float64, the
    result's arrays returned as float64 numpy."""
    def cast(a):
        a = jnp.asarray(a)
        return a.astype(jnp.float64) if jnp.issubdtype(
            a.dtype, jnp.floating) else a

    with jax.enable_x64(True):
        out = fn(*jax.tree.map(cast, args))
        return jax.tree.map(lambda a: np.asarray(a, np.float64), out)


def _assert_losses(met: dict, expect: dict):
    """Loss terms within 1e-5 of the JAX package's; the depth term,
    weighted by 1 / sqrt(depth variance + 1e-10), within 1e-4."""
    for k in ("color", "depth", "sdf", "eikonal", "total"):
        tol = 1e-4 if k in ("depth", "total") else 1e-5
        assert _rel(met[k].numpy(), expect[k]) <= tol, k


def _port_grads(model, dt, loss_fn) -> dict:
    """{name: gradient} of loss_fn(model in dtype dt, dt) (float64
    numpy), on a copy of the model."""
    model = copy.deepcopy(model).to(dt)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss_fn(model, dt), list(model.parameters()))
    return {n: g.double().numpy() for n, g in zip(names, grads)}


def _by_name(tree) -> dict:
    """A JAX package parameter tree (a gradient) by the port's parameter
    names, as float64 numpy.  convert_mapping_params makes fp32 tensors,
    so a float64 tree goes through it as its fp32 rounding plus the fp32
    remainder (together exact to about 1e-14)."""
    hi = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    lo = jax.tree.map(lambda a, h: np.asarray(np.asarray(a, np.float64) - h,
                                              np.float32), tree, hi)
    lo = convert_mapping_params(lo)
    return {n: v.double().numpy() + lo[n].double().numpy()
            for n, v in convert_mapping_params(hi).items()}


# ---------------------------------------------------------------------------
# hash grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log2T,base", [(10, 4), (8, 16)])
def test_hashgrid_indices_are_the_jax_packages(rng, log2T, base):
    """The rows each point gathers, and their weights, read off the JAX
    grid's gradient with respect to its table (nonzero exactly at the
    gathered rows, the weights summed over repeated rows).  (10, 4): the
    first three levels dense, the rest hashed; (8, 16): the default
    levels, all hashed, coordinates up to ~4,100 at level 15."""
    L, F = 16, 2
    T = 1 << log2T
    x = rng.uniform(-0.05, 1.05, (24, 3)).astype(np.float32)
    jg = JHashGrid(n_levels=L, log2_table=log2T, base_res=base)
    params = jg.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def one(p, xi):
        return jg.apply(p, xi[None])[0, ::F].sum()   # feature 0, all levels

    jac = jax.vmap(jax.grad(one), (None, 0))(params, jnp.asarray(x))
    jw = np.asarray(jac["params"]["table"])[..., 0]  # [N, L, T]

    g = HashGrid(n_levels=L, log2_table=log2T, base_res=base)
    idx, w = g.indices(torch.from_numpy(x))         # [N, L, 8]
    assert int(idx.min()) >= 0 and int(idx.max()) < T
    tw = torch.zeros((len(x), L, T), dtype=torch.float64)
    tw.scatter_add_(2, idx, w.double())
    assert np.array_equal(tw.numpy() != 0, jw != 0)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=1e-6)


def test_hashgrid_features_and_gradients_are_the_jax_packages(rng):
    """The full-size grid (16 x 2^19 x 2): features within 1e-6, d/dx
    and d/dtable within 1e-5 of each one's largest entry."""
    x = rng.uniform(-0.02, 1.02, (1000, 3)).astype(np.float32)
    cot = rng.standard_normal((1000, 32)).astype(np.float32)
    jg = JHashGrid()
    params = jg.init(jax.random.PRNGKey(3), jnp.asarray(x))
    table = np.asarray(params["params"]["table"])

    def loss(p, xx):
        return (jg.apply(p, xx) * cot).sum()

    jout = np.asarray(jg.apply(params, jnp.asarray(x)))
    jgp, jgx = jax.grad(loss, (0, 1))(params, jnp.asarray(x))

    g = HashGrid()
    g.table.data = _t(table)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = g(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    assert np.abs(out.detach().numpy() - jout).max() <= 1e-6
    assert _rel(xt.grad.numpy(), jgx) <= 1e-5
    assert _rel(g.table.grad.numpy(), jgp["params"]["table"]) <= 1e-5


# ---------------------------------------------------------------------------
# InstantNeuS, sampling and losses
# ---------------------------------------------------------------------------

def _params(table: float, seed: int = 5) -> dict:
    """An InstantNeuS parameter tree in the JAX package's layout, made
    with numpy: hash-table entries uniform in +-table, and the grid
    columns of the SDF layer nonzero, so that the table has a gradient.
    With entries of 0.05 the finest levels (4,100 cells across the
    bound) dominate d sdf / dx, which then moves by 1e-4 when a sample's
    depth moves by one rounding; the mapper's tests take the init's
    1e-4, where it does not."""
    r = np.random.default_rng(seed)

    def dense(d_in, d_out, scale):
        return {"kernel": (scale * r.standard_normal((d_in, d_out))
                           ).astype(np.float32),
                "bias": (0.05 * r.standard_normal(d_out)).astype(np.float32)}

    return {
        "sdf_network": {
            "encoding": {"table": r.uniform(-table, table, (16, 1 << 19, 2)
                                            ).astype(np.float32)},
            "sdf_layer": dense(35, 32, 0.3)},
        "color_network": {
            "B": (25.0 * r.standard_normal((3, 33))).astype(np.float32),
            "hidden0": dense(67, 64, 67 ** -0.5),
            "hidden1": dense(64, 64, 64 ** -0.5),
            "out": dense(64, 3, 64 ** -0.5)},
        "variance": np.asarray(0.3, np.float32)}


@pytest.fixture(scope="module")
def neus():
    """The JAX model with _params(0.05) and the port's model holding
    them."""
    params = jax.tree.map(jnp.asarray, _params(0.05))
    tm = InstantNeuS()
    tm.load_state_dict(convert_mapping_params(
        jax.tree.map(np.asarray, params)))
    return JNeuS(), params, tm


def _rays(rng, R, S):
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.05, 3.0, (R, S)), axis=1).astype(np.float32)
    dist = np.concatenate([np.diff(z, axis=1), np.full((R, 1), 0.05)],
                          axis=1).astype(np.float32)
    return o, d, z, dist


def test_instant_neus_outputs_and_gradients_match_jax(neus, rng):
    """Every output of a render (NeuS compositing, masks, eikonal error)
    within 1e-5 of its largest entry, and the gradient of a loss on all
    of them with respect to every parameter (_assert_grads).  A tighter
    realtime bound masks part of the samples."""
    jm, params, tm = neus
    o, d, z, dist = _rays(rng, 64, 12)
    rt = BOUND * 0.7
    names = ("color", "depth", "depth_variance", "normal", "weight_sum",
             "sdf", "z_vals", "gradient_error")
    cot = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("color", (64, 3)), ("depth", (64, 1)), ("depth_variance", (64, 1)),
        ("normal", (64, 3)), ("weight_sum", (64, 1)), ("sdf", (64, 12)),
        ("gradient_error", (1,)))}

    def jloss(p, *arrays):
        ret = jm.apply({"params": p}, *arrays)
        return sum((ret[k] * cot[k]).sum() for k in cot), ret

    arrays = (o, d, z, dist, BOUND, rt)
    (_, jret), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        params, *map(jnp.asarray, arrays))
    jgrad64 = _jax64(jax.grad(lambda *a: jloss(*a)[0]), params, *arrays)
    ret = tm(*map(torch.from_numpy, (o, d, z, dist)), _t(BOUND), _t(rt))
    for k in names:
        assert _rel(ret[k].detach().numpy(), jret[k]) <= 1e-5, k
    masked = (np.asarray(jret["sdf"]) == 100.0).mean()
    assert 0.1 < masked < 0.9

    def loss(model, dt):
        ret = model(*[torch.from_numpy(a).to(dt) for a in (o, d, z, dist)],
                    _t(BOUND).to(dt), _t(rt).to(dt))
        return sum((ret[k] * torch.from_numpy(cot[k]).to(dt)).sum()
                   for k in cot)

    port64 = _port_grads(tm, torch.float64, loss)
    _assert_fp64_grads(port64, _by_name(jgrad64))
    _assert_grads(_port_grads(tm, torch.float32, loss), _by_name(jgrad),
                  port64)


def test_sdf_and_colour_queries_match_jax(neus, rng):
    """The mesher's queries: sdf_grid (100 outside the realtime bound)
    and color_at (through d sdf / dx) at points in and around the
    bound."""
    jm, params, tm = neus
    pts = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    b, rt = jnp.asarray(BOUND), jnp.asarray(BOUND * 0.8)
    jsdf = jm.apply({"params": params}, jnp.asarray(pts), b, rt,
                    method=jm.sdf_grid)
    jcol = jm.apply({"params": params}, jnp.asarray(pts), b,
                    method=jm.color_at)
    with torch.no_grad():
        sdf = tm.sdf_grid(torch.from_numpy(pts), _t(BOUND), _t(BOUND * 0.8))
        col = tm.color_at(torch.from_numpy(pts), _t(BOUND))
    assert _rel(sdf.numpy(), jsdf) <= 1e-5
    assert _rel(col.numpy(), jcol) <= 1e-5
    assert not col.requires_grad


@pytest.mark.parametrize("with_depth", [True, False])
def test_sample_z_vals_with_the_jax_packages_draws(rng, with_depth):
    """Stratified samples with JAX's jitter r, the surface band, the far
    clamp; rays without depth sample up to the batch's largest depth."""
    R, S, Ss = 50, 24, 48
    o = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d[3] = [0.0, 0.0, 1.0]                      # axis-parallel ray
    gt = rng.uniform(0.5, 4.0, R).astype(np.float32)
    if not with_depth:
        gt[::3] = 0.0
    key = jax.random.PRNGKey(7)
    jz, jdist = jsample_z_vals(key, *map(jnp.asarray, (o, d, gt, BOUND)),
                               S, Ss, 1.0)
    r = np.asarray(jax.random.uniform(key, (S,)))
    z, dist = sample_z_vals(torch.from_numpy(r), *map(torch.from_numpy,
                                                      (o, d, gt, BOUND)),
                            S, Ss)
    assert _rel(z.numpy(), jz) <= 1e-6
    assert _rel(dist.numpy(), jdist) <= 1e-6


def test_render_helpers_match_jax(neus, rng):
    """build_ray_dirs and rays_from_pixels, sample_pdf with JAX's draws,
    within 1e-5 of each one's largest entry; and render_img (a whole
    image in ray chunks, the last one padded) within 1e-4: its samples
    come from sample_z_vals, and a sample that moves by one rounding
    moves the normal (so the colour) by 1e-4 where the finest levels of
    this model's table dominate d sdf / dx (see _params)."""
    jm, params, tm = neus
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.asarray(jlie.quat_to_matrix(jnp.asarray(
        [0.1, -0.2, 0.05, 0.97]) / np.linalg.norm([0.1, -0.2, 0.05, 0.97])))
    c2w[:3, 3] = [0.2, -0.1, 0.3]
    intr = (9.0, 9.0, 5.5, 3.5)
    dirs = renderer.build_ray_dirs(8, 12, *intr)
    jdirs = jrenderer.build_ray_dirs(8, 12, *intr)
    assert _rel(dirs.numpy(), jdirs) <= 1e-6
    py, px = rng.integers(0, 8, 20), rng.integers(0, 12, 20)
    for a, b in zip(renderer.rays_from_pixels(
            torch.from_numpy(c2w), dirs, torch.from_numpy(py),
            torch.from_numpy(px)),
            jrenderer.rays_from_pixels(jnp.asarray(c2w), jdirs,
                                       jnp.asarray(py), jnp.asarray(px))):
        assert _rel(a.numpy(), b) <= 1e-6

    bins = np.sort(rng.uniform(0.1, 3.0, (30, 9)), axis=1).astype(np.float32)
    w = rng.random((30, 9)).astype(np.float32)
    w[0] = 0.0
    key = jax.random.PRNGKey(4)
    expect = jrenderer.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 16)
    u = np.asarray(jax.random.uniform(key, (30, 16)))
    got = renderer.sample_pdf(torch.from_numpy(u), torch.from_numpy(bins),
                              torch.from_numpy(w))
    assert _rel(got.numpy(), expect) <= 1e-5

    gt = rng.uniform(0.5, 2.0, (8, 12)).astype(np.float32)
    expect = jrenderer.render_img(jm, params, c2w, 8, 12, *intr,
                                  jnp.asarray(BOUND), jnp.asarray(BOUND),
                                  gt_depth=gt, n_samples=8, n_surface=8,
                                  ray_chunk=64)
    got = renderer.render_img(tm, c2w, 8, 12, *intr, _t(BOUND), _t(BOUND),
                              gt_depth=gt, n_samples=8, n_surface=8,
                              ray_chunk=64)
    assert got.keys() == expect.keys()
    for k in got:
        assert got[k].shape == expect[k].shape
        assert _rel(got[k], expect[k]) <= 1e-4, k


def test_sdf_losses_match_jax(rng):
    R, S = 40, 30
    sdf = rng.uniform(-0.3, 0.5, (R, S)).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 4.0, (R, S)), axis=1).astype(np.float32)
    gt = rng.uniform(0.5, 3.5, R).astype(np.float32)
    gt[::4] = 0.0
    expect = jcompute_sdf_losses(*map(jnp.asarray, (sdf, z, gt)), 0.16, 5.0)
    got = compute_sdf_losses(*map(torch.from_numpy, (sdf, z, gt)), 0.16, 5.0)
    for a, b in zip(got, expect):
        assert _rel(a.numpy(), b) <= 1e-6


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

HT, WD = 32, 48


def _cfg(**mapping):
    over = {"mapping": {"pixels": 256, "mapping_window_size": 6,
                        **mapping},
            "rendering": {"N_samples": 8, "N_surface": 16}}
    return (update_recursive(jdefault_config(), over),
            update_recursive(default_config(), over))


def _videos(rng, n=14, masked=1.0):
    """A JAX and a port video with the same filtered state for n
    keyframes: images, disparities 0.3-0.8, masks keeping a share
    `masked` of the pixels, poses near identity, a bound."""
    jv = JVideo(buffer=16, ht=HT, wd=WD)
    tv = VideoBuffer(16, HT, WD, "cpu")
    intr = np.asarray([6.0, 6.0, 2.9, 1.9], np.float32)
    images = rng.random((n, HT, WD, 3)).astype(np.float32)
    disps = rng.uniform(0.3, 0.8, (n, HT, WD)).astype(np.float32)
    masks = (rng.random((n, HT, WD)) < masked).astype(np.float32)
    poses = np.asarray(jlie.exp(jnp.asarray(
        0.05 * rng.standard_normal((n, 6)).astype(np.float32))))
    jv.intrinsics = jnp.asarray(intr)
    jv.counter = jv.filtered_id = n
    jv.images = jv.images.at[:n].set(images)
    jv.disps_filtered = jv.disps_filtered.at[:n].set(disps)
    jv.mask_filtered = jv.mask_filtered.at[:n].set(masks)
    jv.poses_filtered = jv.poses_filtered.at[:n].set(poses)
    jv.bound = np.asarray([[-3, 3], [-3, 3], [-3, 3]], np.float32)
    tv.intrinsics[:] = _t(intr)
    tv.counter = tv.filtered_id = n
    tv.images[:n] = _t(images)
    tv.disps_filtered[:n] = _t(disps)
    tv.mask_filtered[:n] = _t(masks)
    tv.poses_filtered[:n] = _t(poses)
    tv.bound = jv.bound.copy()
    return jv, tv


def _mappers(jcfg, cfg, jv, tv):
    params = _params(1e-4)
    jm = jmapper.Mapper(jv, jcfg, params=jax.tree.map(jnp.asarray, params))
    tm = mapper.Mapper(tv, cfg)
    tm.model.load_state_dict(convert_mapping_params(params))
    return jm, tm


def _jitter(k, x64: bool = False) -> torch.Tensor:
    """The stratified jitter the JAX package draws from step key k (as
    float64 when it runs with 64-bit floats)."""
    with jax.enable_x64(x64):
        return torch.from_numpy(np.asarray(jax.random.uniform(k, (8,))))


def _jax_clipped(opt_state) -> dict:
    """The JAX package's clipped gradient after one step, read off its
    first Adam moment (over 1 - b1 = 0.1), by the port's names."""
    groups = opt_state[1].inner_states
    tree = jax.tree.map(np.asarray, groups["net"].inner_state[0].mu)
    tree["sdf_network"]["encoding"]["table"] = np.asarray(
        groups["grid"].inner_state[0].mu["sdf_network"]["encoding"]["table"])
    return {n: np.asarray(v / 0.1) for n, v in _by_name(tree).items()}


def _port_clipped(tm) -> dict:
    """The port's clipped gradient after one step, read off its first
    Adam moment."""
    names = {p: n for n, p in tm.model.named_parameters()}
    return {names[p]: np.asarray(tm.opt.state[p]["exp_avg"].double().numpy()
                                 / 0.1) for p in tm.params}


def _clipped64(model, loss_fn) -> dict:
    """The port's fp64 gradient after the global-norm clip."""
    g = _port_grads(model, torch.float64, loss_fn)
    clipped = mapper.clip_by_global_norm(
        [torch.from_numpy(v) for v in g.values()], mapper.GRAD_CLIP)
    return {n: c.numpy() for n, c in zip(g, clipped)}


def _recording(m, name):
    """Wrap m's step method `name` to keep its arguments."""
    calls, step = [], getattr(m, name)

    def recording(*a, **k):
        calls.append(a)
        return step(*a, **k)

    setattr(m, name, recording)
    return calls


@pytest.mark.parametrize("R", [512, 600])
def test_optimize_step_matches_optax(rng, R):
    """One step of _optimize: the loss terms (_assert_losses), and
    each parameter's gradient after the global-norm clip at 35
    (_assert_grads); R = 600 rays are padded to 768 (repeats of the first
    rays, depth 0) in both.  Then the port's AdamW, fed the JAX package's
    clipped gradient, gives optax's parameters within 1e-5 of each one's
    largest entry.  (Its own gradient would not: Adam's first update is
    g / (|g| + 1e-8) x lr, so a gradient entry near zero whose rounding
    differs moves its parameter by up to the learning rate.)"""
    jcfg, cfg = _cfg()
    jv, tv = _videos(rng)
    jm, tm = _mappers(jcfg, cfg, jv, tv)
    init = copy.deepcopy(tm.model)
    o, d, _, _ = _rays(rng, R, 1)
    gc = rng.random((R, 3)).astype(np.float32)
    gd = rng.uniform(0.5, 2.5, R).astype(np.float32)
    gd[::7] = 0.0
    b = jnp.asarray(jv.bound)
    r = _jitter(jax.random.split(jm.key)[1])
    jcalls = _recording(jm, "_train_step")
    jmet = jm._optimize(tuple(map(jnp.asarray, (o, d, gc, gd))), b, b, 1)
    tm._jitter = lambda: r
    calls = _recording(tm, "train_step")
    met = tm._optimize(tuple(map(torch.from_numpy, (o, d, gc, gd))),
                       _t(jv.bound), _t(jv.bound), 1)
    _assert_losses(met, jmet)
    ro, rd, bc, bd, bb, _ = calls[0]
    assert len(bd) == mapper.bucket(R) and (bd[R:] == 0).all()
    k = jcalls[0][2]

    def jstep(p, *a):
        return jm._train_step(p, jm.tx.init(p), k, *a)[1]

    def loss(model, dt, r=r):
        ret = mapper.render_rays(model, r.to(dt), ro.to(dt), rd.to(dt),
                                 bd.to(dt), bb.to(dt), bb.to(dt), 8, 16)
        return tm.losses(ret, bc.to(dt), bd.to(dt))[0]

    _assert_fp64_grads(
        _clipped64(init, lambda m, dt: loss(m, dt, _jitter(k, True))),
        _jax_clipped(_jax64(jstep, _params(1e-4), *(
            t.numpy() for t in (ro, rd, bc, bd, bb, bb)))))
    jg = _jax_clipped(jm.opt_state)
    _assert_grads(_port_clipped(tm), jg, _clipped64(init, loss))

    fresh = mapper.Mapper(tv, cfg)
    fresh.model.load_state_dict(init.state_dict())
    names = {p: n for n, p in fresh.model.named_parameters()}
    mapper._step(fresh.opt, fresh.params,
                 [torch.from_numpy(jg[names[p]]).float()
                  for p in fresh.params])
    expect = convert_mapping_params(jax.tree.map(np.asarray, jm.params))
    for n, p in fresh.model.named_parameters():
        assert _rel(p.detach().numpy(), expect[n]) <= 1e-5, n


def test_clip_by_global_norm_is_optaxs():
    import optax
    g = [np.full((3,), 30.0, np.float32), np.full((2, 2), 10.0, np.float32)]
    for scale in (1.0, 0.1):
        gs = [a * scale for a in g]
        expect, _ = optax.clip_by_global_norm(35.0).update(gs, None)
        got = mapper.clip_by_global_norm([torch.from_numpy(a) for a in gs],
                                         35.0)
        for a, e in zip(got, expect):
            np.testing.assert_allclose(a.numpy(), e, rtol=1e-6)


def test_pose_ba_step_matches_jax(rng):
    """mapping.BA: the revisit window refines one se(3) increment per
    keyframe with the map, rays rebuilt from the refined poses.  The same
    numpy generator picks the same pixels in both; JAX's jitter is
    passed in.  One joint step (iters 1): the loss terms
    (_assert_losses), the map's clipped gradients (_assert_grads), the
    same priority decay."""
    jcfg, cfg = _cfg(BA=True, iters=1)
    jv, tv = _videos(rng)
    jm, tm = _mappers(jcfg, cfg, jv, tv)
    init = copy.deepcopy(tm.model)
    jm.last_visit = tm.last_visit = 12      # the BA branch needs >= 10
    r = _jitter(jax.random.split(jm.key)[1])
    tm._jitter = lambda: r
    calls = _recording(tm, "train_step_ba")
    jcalls = _recording(jm, "_train_step_ba")
    jmet = jm()
    met = tm()
    assert met is not None and len(calls) == len(jcalls) == 1
    assert tm.global_step == jm.global_step == 1
    _assert_losses(met, jmet)
    _, _, c2w_base, fo, dc, gc, gd, bb, _ = calls[0]
    k = jcalls[0][4]

    def jstep(p, d, *a):
        return jm._train_step_ba(p, d, jm.tx.init(p), jm._cam_tx.init(d), k,
                                 *a)[2]

    def loss(model, dt, r=r):
        deltas = torch.zeros((len(c2w_base), 6), dtype=dt)
        Gr = mapper.lie.retr(c2w_base.to(dt), deltas)[fo]
        ret = mapper.render_rays(
            model, r.to(dt), Gr[:, :3],
            mapper.lie.quat_rotate(Gr[:, 3:7], dc.to(dt)), gd.to(dt),
            bb.to(dt), bb.to(dt), 8, 16)
        return tm.losses(ret, gc.to(dt), gd.to(dt))[0]

    _assert_fp64_grads(
        _clipped64(init, lambda m, dt: loss(m, dt, _jitter(k, True))),
        _jax_clipped(_jax64(jstep, _params(1e-4), np.zeros(
            (len(c2w_base), 6)), *(t.numpy() for t in (
                c2w_base, fo, dc, gc, gd, bb, bb)))))
    _assert_grads(_port_clipped(tm), _jax_clipped(jm.opt_state),
                  _clipped64(init, loss))
    np.testing.assert_allclose(tv.update_priority, jv.update_priority)


def test_sample_rays_with_the_jax_packages_keys(rng):
    """The device ray sampler with JAX's keys picks the same pixels:
    frame 3 has fewer masked pixels (40) than n_per (96), so it picks
    among ties at -1 (lowest index first, as lax.top_k) and those rays
    get depth 0; a padding frame (-1) gives depth 0 everywhere."""
    jv, tv = _videos(rng, masked=0.6)
    m = np.zeros((HT, WD), np.float32)
    m.reshape(-1)[rng.choice(HT * WD, 40, replace=False)] = 1.0
    jv.mask_filtered = jv.mask_filtered.at[3].set(m)
    tv.mask_filtered[3] = _t(m)
    frames = np.asarray([5, 3, 0, -1])
    key = jax.random.PRNGKey(11)
    expect = jmapper._sample_rays_kernel(
        key, jnp.asarray(frames, jnp.int32), jv.images, jv.disps_filtered,
        jv.mask_filtered, jv.poses_filtered, jv.pose_compensate,
        jv.intrinsics, n_per=96, scale=8)
    keys = torch.from_numpy(np.asarray(jax.random.uniform(key,
                                                          (4, HT, WD))))
    got = mapper.sample_rays(torch.from_numpy(frames), keys, tv.images,
                             tv.disps_filtered, tv.mask_filtered,
                             tv.poses_filtered, tv.pose_compensate,
                             tv.intrinsics, 96, 8)
    for a, e in zip(got, expect):
        assert _rel(a.numpy(), e) <= 1e-6
    depth = got[3].numpy().reshape(4, 96)
    assert (depth[1] > 0).sum() == 40 and (depth[3] == 0).all()


def test_frame_schedule_of_three_rounds_matches_jax(rng):
    """Three rounds as the filter publishes 6, 10 and 14 keyframes: the
    unvisited bursts (x10 on the first), the revisit windows (newest
    two, top-10 priority, random) and the priority decay, with the
    training steps left out."""
    jcfg, cfg = _cfg(mapping_window_size=14)
    jv, tv = _videos(rng)
    prio = rng.random(16).astype(np.float32)
    jv.update_priority[:] = prio
    tv.update_priority[:] = prio
    jm, tm = _mappers(jcfg, cfg, jv, tv)
    seen = {"jax": [], "port": []}
    for name, m in (("jax", jm), ("port", tm)):
        sample = m._sample_rays

        def recording(frames, n_per, sample=sample, name=name):
            seen[name].append((list(frames), n_per))
            return sample(frames, n_per)

        m._sample_rays = recording
        m._optimize = lambda *a: None
    for n in (6, 10, 14):
        jv.filtered_id = tv.filtered_id = n
        jm()
        tm()
    assert seen["port"] == seen["jax"]
    assert len(seen["port"]) == 20 + 2 + 2 + 2 + 2 + 2
    np.testing.assert_allclose(tv.update_priority, jv.update_priority,
                               rtol=1e-6)
