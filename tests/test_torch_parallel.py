"""The port's sharded paths against the JAX package's and against its own
single-device paths, on the CPU.

The port's mesh is ``ShardMesh([cpu] * S)``; the JAX package's is S of
the virtual CPU devices that tests/conftest.py sets up.  Covered: the two
partition functions (bit for bit), ``ShardMesh.psum`` (the fixed-order
sum), the mesh's copies of a module on other devices, sharded BA, one
sharded low-memory step of global BA (RGB-D and stereo, fp32), the
ray-sharded mapping step (also over two devices, with the mapper's
pose-BA step between two sharded steps), and global BA through
``SLAMSystem`` with and without a mesh.  ``ShardMesh(["cpu", "cpu:1"])``
is a mesh of two devices to the port (its tensors share the CPU's
memory): it runs the code that copies modules between devices.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from goslam_tpu.ops import lie as jlie
from goslam_tpu.ops import projective as jprojective
from goslam_tpu.parallel import sharded_ba as jsharded_ba
from goslam_tpu_torch.ops import dba
from goslam_tpu_torch.parallel import ShardMesh
from goslam_tpu_torch.parallel import sharded_ba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "droid_synthetic.ckpt")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_mesh(S: int, axis: str = "edges") -> Mesh:
    devs = jax.devices()
    assert len(devs) >= S, "tests/conftest.py sets up 8 CPU devices"
    return Mesh(np.asarray(devs[:S]), (axis,))


def _cpu_mesh(S: int) -> ShardMesh:
    return ShardMesh(["cpu"] * S)


# ---------------------------------------------------------------------------
# partitioning and the mesh's collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 3, 4])
def test_partitions_are_the_jax_packages(S):
    """Both partition functions, bit for bit, on edges whose sources all
    lie in the first half of the frames (the last shards get no edge)
    and on edges spread over all frames."""
    rng = np.random.default_rng(S)
    for hi in (8, 16):
        ii = rng.integers(0, hi, 120).astype(np.int32)
        jj = rng.integers(0, 16, 120).astype(np.int32)
        valid = rng.random(120) > 0.2
        got = sharded_ba.partition_edges_by_source(ii, jj, valid, 16, S)
        want = jsharded_ba.partition_edges_by_source(ii, jj, valid, 16, S)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        slots = sharded_ba.partition_edge_slots(ii, valid, 16, S)
        jslots = jsharded_ba.partition_edge_slots(ii, valid, 16, S)
        assert slots.dtype == jslots.dtype and np.array_equal(slots, jslots)
        if hi == 8 and S == 4:
            assert not got[2][2:].any()          # shards 2 and 3 are empty


def test_psum_is_the_fixed_order_sum():
    """psum adds the shards' tensors in shard order on the first shard's
    device: the same bits as ((p0 + p1) + p2) + p3, in every call, on
    every shard; pmax is the elementwise maximum; replicate makes one
    copy per distinct device."""
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(1000, generator=g) * 10 ** k for k in range(4)]
    mesh = _cpu_mesh(4)
    first, again = mesh.psum(parts), mesh.psum(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    for a, b in zip(first, again):
        assert torch.equal(a, want) and torch.equal(b, want)
    assert not torch.equal(want, ((parts[3] + parts[2]) + parts[1])
                           + parts[0])           # the order shows
    assert torch.equal(mesh.pmax(parts)[2], torch.stack(parts).amax(0))
    t = torch.zeros(3)
    assert all(r is t for r in mesh.replicate(t))
    assert mesh.size == 4 and _cpu_mesh(1).size == 1


def test_replicate_module_copies_once_and_holds_the_modules_weights():
    """replicate_module gives the module itself on its own device and one
    copy on each other device ("cpu:1" is another device to the mesh,
    though its tensors share the CPU's memory), the same copy at every
    call (made once for the mesh's life), holding the module's weights
    and buffers as they are at the call."""
    net = torch.nn.BatchNorm1d(3)
    mesh = ShardMesh(["cpu", "cpu:1", "cpu:1"])
    a, b, c = mesh.replicate_module(net)
    assert a is net and b is c and b is not net
    with torch.no_grad():
        net.weight.add_(1.0)
        net.running_mean.fill_(2.0)
    again = mesh.replicate_module(net)
    assert again[1] is b
    assert torch.equal(b.weight, net.weight)
    assert torch.equal(b.running_mean, net.running_mean)
    assert all(x is net for x in _cpu_mesh(2).replicate_module(net))


# ---------------------------------------------------------------------------
# sharded BA
# ---------------------------------------------------------------------------

def _ba_problem(Pn=10, ht=6, wd=8):
    """tests/test_parallel.py's problem, made with numpy from seed 43."""
    rng = np.random.default_rng(43)
    poses = np.asarray(jax.vmap(jlie.exp)(jnp.asarray(
        0.05 * rng.standard_normal((Pn, 6)), jnp.float32)))
    disps = (0.4 + 0.2 * rng.random((Pn, ht, wd))).astype(np.float32)
    intr = np.asarray([8.0, 8.0, wd / 2, ht / 2], np.float32)
    ii, jj = np.meshgrid(np.arange(Pn), np.arange(Pn), indexing="ij")
    keep = (ii != jj) & (np.abs(ii - jj) <= 3)
    ii, jj = ii[keep].astype(np.int32), jj[keep].astype(np.int32)
    valid = np.ones(len(ii), bool)
    valid[-3:] = False
    coords, _ = jprojective.transform(jnp.asarray(poses), jnp.asarray(disps),
                                      jnp.asarray(intr), jnp.asarray(ii),
                                      jnp.asarray(jj))
    target = (np.asarray(coords) + 0.3 * rng.standard_normal(
        coords.shape)).astype(np.float32)
    weight = (0.5 + 0.5 * rng.random(coords.shape)).astype(np.float32)
    eta = np.full((Pn, ht, wd), 1e-4, np.float32)
    return poses, disps, intr, target, weight, eta, ii, jj, valid


def _shard_edges(target, weight, ii, jj, valid, Pn, S):
    """The problem's edges in shard layout."""
    ii_s, jj_s, ok_s = sharded_ba.partition_edges_by_source(ii, jj, valid,
                                                            Pn, S)
    lut = {(int(a), int(b)): k for k, (a, b) in enumerate(zip(ii, jj))}
    idx = np.vectorize(lambda a, b: lut.get((int(a), int(b)), 0))(ii_s,
                                                                   jj_s)
    tg = np.where(ok_s[..., None, None, None], target[idx], 0)
    ww = np.where(ok_s[..., None, None, None], weight[idx], 0)
    return tg.astype(np.float32), ww.astype(np.float32), ii_s, jj_s, ok_s


@pytest.mark.parametrize("S", [1, 2, 3])
def test_sharded_ba_matches_jax_and_the_single_solver(S):
    """ba_sharded on S CPU shards against the JAX package's ba_sharded on
    S devices and against the port's dba.ba: poses within 2e-5,
    disparities within 2e-4 (tests/test_parallel.py's tolerances)."""
    poses, disps, intr, target, weight, eta, ii, jj, valid = _ba_problem()
    Pn = poses.shape[0]
    sens = np.zeros_like(disps)
    tg, ww, ii_s, jj_s, ok_s = _shard_edges(target, weight, ii, jj, valid,
                                            Pn, S)
    def t(a):
        return torch.from_numpy(np.array(a))

    got = sharded_ba.ba_sharded(_cpu_mesh(S), t(poses), t(disps), t(intr),
                                t(sens), t(tg), t(ww), t(eta), ii_s, jj_s,
                                ok_s, 1, Pn, iters=2)
    want = jsharded_ba.ba_sharded(
        _jax_mesh(S), *map(jnp.asarray, (poses, disps, intr, sens, tg, ww,
                                         eta, ii_s, jj_s, ok_s)),
        1, Pn, iters=2)
    single = dba.ba(t(poses), t(disps), t(intr), t(sens), t(target),
                    t(weight), t(eta), t(ii.astype(np.int64)),
                    t(jj.astype(np.int64)), t(valid), 1, Pn, iters=2)
    for ref in (want, single):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=2e-4)
    assert np.abs(got[0].numpy() - poses).max() > 1e-3     # BA moved them


# ---------------------------------------------------------------------------
# the sharded low-memory step
# ---------------------------------------------------------------------------

N, HT, WD, BUF = 10, 64, 96, 16


def _lowmem_state(stereo: bool) -> dict:
    """A keyframe store of N frames at 64x96 made with numpy from a seed:
    features, poses near identity, disparities, RGB-D sensor disparities,
    and a band graph (with self-edges in stereo)."""
    rng = np.random.default_rng(7 + stereo)
    rig = 2 if stereo else 1
    h8, w8 = HT // 8, WD // 8

    def bf16(shape):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return a.to(torch.bfloat16).float().numpy()

    dxi = 0.03 * rng.standard_normal((N, 6)).astype(np.float32)
    dxi[0] = 0
    disps = rng.uniform(0.3, 0.6, (N, h8, w8)).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    keep = (np.abs(ii - jj) <= 2) & ((ii != jj) | stereo)
    return dict(
        stereo=stereo, fmaps=bf16((N, rig, h8, w8, 128)),
        nets=bf16((N, h8, w8, 128)), inps=bf16((N, h8, w8, 128)),
        poses=np.asarray(jax.vmap(jlie.exp)(jnp.asarray(dxi))),
        disps=disps,
        sens=np.zeros_like(disps) if stereo else disps * 1.02,
        intr=np.asarray([12.0, 12.0, 6.0, 4.0], np.float32),
        ii=ii[keep], jj=jj[keep])


def _jax_lowmem(st: dict, S: int) -> dict:
    from goslam_tpu.system import load_pretrained
    from goslam_tpu.tracking.factor_graph import FactorGraph
    from goslam_tpu.tracking.video import VideoBuffer

    v = VideoBuffer(buffer=BUF, ht=HT, wd=WD, stereo=st["stereo"])
    for name, key in (("poses", "poses"), ("disps", "disps"),
                      ("disps_sens", "sens"), ("nets", "nets"),
                      ("inps", "inps"), ("fmaps", "fmaps")):
        full = np.array(getattr(v, name).astype(jnp.float32))
        full[:N] = st[key]
        setattr(v, name, jnp.asarray(full, getattr(v, name).dtype))
    v.intrinsics = jnp.asarray(st["intr"])
    v.counter = N
    graph = FactorGraph(v, load_pretrained(CKPT), max_factors=64,
                        corr_impl="alt", inac_capacity=-1,
                        compute_dtype=jnp.float32, mesh=_jax_mesh(S))
    graph.add_factors(st["ii"].astype(np.int32), st["jj"].astype(np.int32))
    assert graph.mesh is not None
    graph.update_lowmem(t0=1, t1=N, steps=1, max_t=N)
    return dict(poses=np.asarray(v.poses[:N]), disps=np.asarray(v.disps[:N]),
                damping=np.asarray(v.damping[:N]))


def _port_lowmem(st: dict, mesh) -> dict:
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.models.droidnet import DroidNet
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph
    from goslam_tpu_torch.tracking.video import VideoBuffer

    net = DroidNet()
    net.load_state_dict(load_checkpoint(CKPT))
    net.eval()
    v = VideoBuffer(BUF, HT, WD, "cpu", stereo=st["stereo"])
    t = torch.from_numpy
    v.poses[:N] = t(st["poses"])
    v.disps[:N] = t(st["disps"])
    v.disps_sens[:N] = t(st["sens"])
    for name in ("fmaps", "nets", "inps"):
        getattr(v, name)[:N] = t(st[name]).to(torch.bfloat16)
    v.intrinsics.copy_(t(st["intr"]))
    v.counter = N
    graph = FactorGraph(v, net, max_factors=64, corr_impl="alt",
                        inac_capacity=-1, compute_dtype=torch.float32,
                        mesh=mesh)
    calls = []
    step = graph._lowmem_step_sharded
    graph._lowmem_step_sharded = lambda *a: calls.append(a) or step(*a)
    with torch.no_grad():
        graph.add_factors(st["ii"], st["jj"])
        graph.update_lowmem(t0=1, t1=N, steps=1, max_t=N)
    return dict(poses=v.poses[:N].numpy(), disps=v.disps[:N].numpy(),
                damping=v.damping[:N].numpy(), sharded=len(calls),
                net=graph.net.float().numpy(),
                target=graph.target.numpy())


@pytest.mark.skipif(not os.path.exists(CKPT), reason="no checkpoint")
@pytest.mark.parametrize("stereo", [False, True], ids=["rgbd", "stereo"])
def test_sharded_lowmem_step_matches_jax(stereo):
    """One low-memory step of global BA (alt-corr GRU, GraphAgg, DBA) in
    fp32 on 2 shards from the same keyframe store, in the JAX package
    (its _lowmem_step_sharded on 2 devices) and in the port: poses within
    1e-4, disparities within 1e-3 (tests/test_parallel.py's tolerances
    for the system).  The port's step on 3 shards (blocks of uneven
    size), on 2 devices ("cpu:1" is another device to the mesh: its
    shard runs the network's copy), and its single-device step, give its
    2-shard step's result."""
    st = _lowmem_state(stereo)
    want = _jax_lowmem(st, 2)
    got = _port_lowmem(st, _cpu_mesh(2))
    assert got["sharded"] == 1
    np.testing.assert_allclose(got["poses"], want["poses"], atol=1e-4)
    np.testing.assert_allclose(got["disps"], want["disps"], atol=1e-3)
    # GraphAgg's damping, psum'd over the shards; the two frameworks'
    # fp32 convolutions round differently
    np.testing.assert_allclose(got["damping"], want["damping"], rtol=1e-2,
                               atol=1e-6)
    assert np.abs(want["poses"][1:] - st["poses"][1:]).max() > 1e-3
    for mesh, n_sharded in ((_cpu_mesh(3), 1),
                            (ShardMesh(["cpu", "cpu:1"]), 1), (None, 0)):
        other = _port_lowmem(st, mesh)
        assert other["sharded"] == n_sharded
        np.testing.assert_allclose(other["poses"], got["poses"], atol=1e-5)
        np.testing.assert_allclose(other["disps"], got["disps"], atol=1e-4)
        np.testing.assert_allclose(other["damping"], got["damping"],
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(other["net"], got["net"], atol=1e-6)
        np.testing.assert_allclose(other["target"], got["target"],
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the ray-sharded mapping step
# ---------------------------------------------------------------------------

def _map_cfgs():
    from goslam_tpu.config import default_config as jdefault_config
    from goslam_tpu_torch.config import default_config, update_recursive
    over = {"mapping": {"pixels": 64, "mapping_window_size": 2},
            "rendering": {"N_samples": 6, "N_surface": 8, "perturb": 0.0}}
    return (update_recursive(jdefault_config(), copy.deepcopy(over)),
            update_recursive(default_config(), over))


def _params(grid: bool = True, seed: int = 5) -> dict:
    """An InstantNeuS parameter tree in the JAX package's layout, made
    with numpy (tests/test_torch_mapping.py's, with hash-table entries in
    +-1e-4).  With `grid` the SDF layer's rows for the grid features are
    nonzero, so that the table has a gradient; without, they are zero,
    as in the mapper's initial parameters."""
    r = np.random.default_rng(seed)

    def dense(d_in, d_out, scale):
        return {"kernel": (scale * r.standard_normal((d_in, d_out))
                           ).astype(np.float32),
                "bias": (0.05 * r.standard_normal(d_out)).astype(np.float32)}

    tree = {
        "sdf_network": {
            "encoding": {"table": r.uniform(-1e-4, 1e-4, (16, 1 << 19, 2)
                                            ).astype(np.float32)},
            "sdf_layer": dense(35, 32, 0.3)},
        "color_network": {
            "B": (25.0 * r.standard_normal((3, 33))).astype(np.float32),
            "hidden0": dense(67, 64, 67 ** -0.5),
            "hidden1": dense(64, 64, 64 ** -0.5),
            "out": dense(64, 3, 64 ** -0.5)},
        "variance": np.asarray(0.3, np.float32)}
    if not grid:     # the layer's input is [xyz, grid features]
        tree["sdf_network"]["sdf_layer"]["kernel"][3:] = 0.0
    return tree


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _map_rays():
    """48 rays made with numpy from seed 43, one without depth, and the
    bound (tests/test_parallel.py's)."""
    rng = np.random.default_rng(43)
    R = 48
    ro = (0.1 * rng.standard_normal((R, 3))).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    gc = rng.random((R, 3)).astype(np.float32)
    gd = (0.5 + rng.random(R)).astype(np.float32)
    gd[5] = 0.0
    bound = np.asarray([[-2, 2], [-2, 2], [-2, 2]], np.float32)
    return (ro, rd, gc, gd), bound


def _mapper(cfg, state_dict, mesh=None, dtype=torch.float32):
    from goslam_tpu_torch.mapping.mapper import Mapper
    from goslam_tpu_torch.tracking.video import VideoBuffer
    m = Mapper(VideoBuffer(4, 16, 24, "cpu"), cfg, mesh=mesh)
    m.model.load_state_dict(state_dict)
    if dtype != torch.float32:
        names = {p: n for n, p in m.model.named_parameters()}
        m.model.to(dtype)
        by_name = dict(m.model.named_parameters())
        m.params = [by_name[names[p]] for p in m.params]
    return m


def _single_grads(m, rays, b):
    """The single-device loss terms and gradient of mapper m."""
    from goslam_tpu_torch.mapping.renderer import render_rays
    dt = m.params[0].dtype
    ro, rd, gc, gd = (t.to(dt) for t in rays)
    with torch.enable_grad():
        ret = render_rays(m.model, None, ro, rd, gd, b.to(dt), b.to(dt),
                          m.n_samples, m.n_surface)
        total, terms = m.losses(ret, gc, gd)
        return terms, torch.autograd.grad(total, m.params)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_map_step(S):
    """One ray-sharded mapping step on S CPU shards (48 rays, one without
    depth, perturb 0) against the single-device step from the same
    weights: the loss terms within rtol 2e-4; each parameter's gradient
    before the clip within 1e-5 of the single-device gradient, relative
    to its largest entry, but where fp32 rounding is larger than that
    (the variance's gradient, one number summed over every sample with
    cancellation: the single fp32 gradient is itself 1e-5 from the fp64
    one) no farther from the fp64 gradient than four times the single
    one; in fp64 every gradient within 1e-12 of the single-device one
    (the same gradient, not S times it).  Then one step against the JAX
    package's sharded step from its mapper's initial weights: the loss
    terms within rtol 2e-4 and the weights within 5e-4
    (tests/test_parallel.py's tolerances)."""
    from goslam_tpu.mapping.mapper import Mapper as JMapper
    from goslam_tpu.parallel.sharded_mapping import (
        make_sharded_map_step_from_cfg, shard_rays as jshard_rays)
    from goslam_tpu.tracking.video import VideoBuffer as JVideo
    from goslam_tpu_torch.models.convert import convert_mapping_params
    from goslam_tpu_torch.parallel.sharded_mapping import shard_rays

    arrays, bound = _map_rays()
    rays = [torch.from_numpy(a) for a in arrays]
    b = torch.from_numpy(bound)
    jcfg, cfg = _map_cfgs()

    sd = convert_mapping_params(_params())
    grads = {}
    for dt in (torch.float32, torch.float64):
        terms1, g1 = _single_grads(_mapper(cfg, sd, dtype=dt), rays, b)
        sharded = _mapper(cfg, sd, _cpu_mesh(S), dt)
        padded = [t.to(dt) for t in shard_rays(S, *rays)]
        terms, g = sharded.sharded_step.grads(*padded, b.to(dt), b.to(dt))
        grads[dt] = (g1, g)
        for k in terms1:
            np.testing.assert_allclose(float(terms[k]), float(terms1[k]),
                                       rtol=2e-4, err_msg=k)
    (g1, g), (g64, gs64) = grads[torch.float32], grads[torch.float64]
    assert float(g1[0].abs().max()) > 0          # the table has a gradient
    for k in range(len(g1)):
        assert _rel(gs64[k], g64[k]) <= 1e-12, k
        if _rel(g[k], g1[k]) > 1e-5:
            assert _rel(g[k], g64[k]) <= 4 * _rel(g1[k], g64[k]), k

    # one step against the JAX package's sharded step, without the
    # table's gradient: Adam's first update moves every entry by the
    # learning rate times the sign of its gradient, so an entry whose
    # gradient is zero but for rounding moves either way
    params = _params(grid=False)
    jm = JMapper(JVideo(buffer=4, ht=16, wd=24), jcfg,
                 params=jax.tree.map(jnp.asarray, params))
    init = convert_mapping_params(params)
    sharded = _mapper(cfg, init, _cpu_mesh(S))
    terms = sharded.sharded_step(*shard_rays(S, *rays), b, b)
    jstep = make_sharded_map_step_from_cfg(_jax_mesh(S, "rays"), jm)
    jp, _, jmet = jstep(jm.params, jm.opt_state, jax.random.PRNGKey(7),
                        *jshard_rays(S, *map(jnp.asarray, arrays)),
                        jnp.asarray(bound), jnp.asarray(bound))
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(jmet[k]),
                                   rtol=2e-4, err_msg=k)
    want = convert_mapping_params(jax.tree.map(np.asarray, jp))
    moved = 0.0
    for n, p in sharded.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=5e-4, err_msg=n)
        moved = max(moved, float((p.detach() - init[n]).abs().max()))
    assert moved > 1e-3


@pytest.mark.parametrize("devices", [("cpu", "cpu:1"), ("cpu:1", "cpu")])
def test_sharded_map_steps_on_two_devices_follow_the_mapper(devices):
    """Ray-sharded steps over two devices ("cpu:1" is another device to
    the mesh: its shard renders through a copy of the model): a sharded
    step, the mapper's pose-BA step (the mapper's model alone), then the
    gradient of a second sharded step and that step, against the same
    sequence on one device, in fp64: the gradient within 1e-12 and the
    weights within 1e-12 of the single device's.  A copy that kept its
    weights from before the pose-BA step would render another map."""
    from goslam_tpu_torch.mapping.mapper import make_optimizer
    from goslam_tpu_torch.models.convert import convert_mapping_params
    from goslam_tpu_torch.ops import lie
    from goslam_tpu_torch.parallel.sharded_mapping import shard_rays

    arrays, bound = _map_rays()
    dt = torch.float64
    rays = [torch.from_numpy(a).to(dt) for a in arrays]
    b = torch.from_numpy(bound).to(dt)
    _, cfg = _map_cfgs()
    sd = convert_mapping_params(_params())
    c2w = lie.identity((2,)).to(dt)
    c2w[1, :3] = torch.tensor([0.05, -0.02, 0.01], dtype=dt)
    frame_of_ray = torch.arange(48) % 2

    def mapper(mesh):
        m = _mapper(cfg, sd, mesh, dt)
        m.opt = make_optimizer(m.params, m.net_lr, m.grid_lr)
        return m

    def pose_ba(m):
        deltas = torch.zeros((2, 6), dtype=dt, requires_grad=True)
        cam_opt = torch.optim.Adam([deltas], lr=1e-3)
        m.train_step_ba(deltas, cam_opt, c2w, frame_of_ray, rays[1],
                        rays[2], rays[3], b, b)

    single = mapper(None)
    mesh = ShardMesh(list(devices))
    sharded = mapper(mesh)
    single.train_step(*rays, b, b)
    sharded.sharded_step(*shard_rays(2, *rays), b, b)
    pose_ba(single)
    pose_ba(sharded)
    _, g1 = _single_grads(single, rays, b)
    _, g = sharded.sharded_step.grads(*rays, b, b)
    for k in range(len(g1)):
        assert _rel(g[k], g1[k]) <= 1e-12, k
    single.train_step(*rays, b, b)
    sharded.sharded_step(*rays, b, b)
    copy_, = [x for x in mesh.replicate_module(sharded.model)
              if x is not sharded.model]
    want = dict(single.model.named_parameters())
    for n, p in sharded.model.named_parameters():
        assert _rel(p.detach(), want[n].detach()) <= 1e-12, n
        assert torch.equal(dict(copy_.named_parameters())[n], p)


def test_shard_rays_pads_with_depthless_copies_of_ray_0():
    from goslam_tpu_torch.parallel.sharded_mapping import shard_rays
    rays = [torch.arange(21 * k, dtype=torch.float32).reshape(21, k)
            for k in (3, 3, 3)] + [torch.ones(21)]
    out = shard_rays(4, *rays)
    assert out[0].shape == (24, 3) and out[3].shape == (24,)
    assert torch.equal(out[1][21:], rays[1][:1].expand(3, 3))
    assert (out[3][21:] == 0).all() and (out[3][:21] == 1).all()
    assert all(a is b for a, b in zip(shard_rays(3, *rays), rays))


# ---------------------------------------------------------------------------
# the system
# ---------------------------------------------------------------------------

def _tracking_cfg():
    """tests/test_parallel.py's configuration, cut to 8 frames: 64x96,
    global BA only when asked, fp32 update operator (bf16 rounding would
    be amplified by the host's greedy edge proposal)."""
    from goslam_tpu_torch.config import default_config, update_recursive
    return update_recursive(default_config(), {
        "dataset": "synthetic", "mode": "rgbd",
        "cam": {"H": 64, "W": 96, "H_out": 64, "W_out": 96,
                "H_edge": 0, "W_edge": 0},
        "data": {"input_folder": "", "n_frames": 8, "output": ""},
        "tracking": {
            "buffer": 32, "warmup": 4, "upsample": False,
            "motion_filter": {"thresh": -1.0},
            "frontend": {"window": 6, "max_factors": 24,
                         "enable_loop": False, "keyframe_thresh": 0.0},
            "global_ba_every": 0, "compute_dtype": "float32",
        },
    })


def test_slam_system_sharded_global_ba_matches_single(tmp_path,
                                                     monkeypatch):
    """Global BA through SLAMSystem(mesh=ShardMesh([cpu] * 2)) against the
    same system without a mesh (tests/test_parallel.py's check of the JAX
    package): both resume the checkpoint of one tracking run, then run
    global BA: the same keyframe and edge counts, the sharded step taken,
    poses within 1e-4 and disparities within 1e-3."""
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.droidnet import init_droidnet
    from goslam_tpu_torch.system import SLAMSystem

    cfg = _tracking_cfg()
    sd = init_droidnet().state_dict()
    ds = Synthetic(cfg)

    def system(mesh, name):
        return SLAMSystem(copy.deepcopy(cfg), state_dict=sd,
                          output=str(tmp_path / name), only_tracking=True,
                          device="cpu", mesh=mesh)

    tracked = system(_cpu_mesh(2), "tracked")
    for i in range(len(ds)):
        _, img, depth, intr, gt = ds[i]
        tracked.track(float(i), img, depth, intr, gt)
    ckpt = str(tmp_path / "go.ckpt")
    tracked.save_checkpoint(ckpt)
    runs = [system(None, "single"), system(_cpu_mesh(2), "sharded")]
    for slam in runs:
        slam.load_checkpoint(ckpt)
    assert runs[0].backend.mesh is None
    assert runs[1].backend.mesh.size == 2

    sharded = []
    step = sharded_ba.ba_shard_gn
    monkeypatch.setattr(sharded_ba, "ba_shard_gn", lambda *x, **k: (
        sharded.append(1) or step(*x, **k)))
    n = tracked.video.counter
    counts = [s.backend.dense_ba(0, n, steps=2) for s in runs]
    assert counts[0] == counts[1] == (n, counts[0][1]) and counts[0][1] > 0
    assert n >= 6 and len(sharded) == 2          # one call a step
    a, b = (s.video for s in runs)
    pb, db = b.poses[:n].numpy(), b.disps[:n].numpy()
    assert np.isfinite(pb).all() and np.isfinite(db).all()
    np.testing.assert_allclose(a.poses[:n].numpy(), pb, atol=1e-4)
    np.testing.assert_allclose(a.disps[:n].numpy(), db, atol=1e-3)
    assert np.abs(pb - tracked.video.poses[:n].numpy()).max() > 1e-5
