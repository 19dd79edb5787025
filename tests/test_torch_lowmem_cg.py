"""``FactorGraph.update_lowmem`` on a window of 192 poses, where global BA
switches to the PCG solver, in the port and in the JAX package.

130 keyframes of the ``Synthetic`` scene at 64x96 (the smallest size
whose 1/8-resolution maps still have four correlation levels) are
written into both packages' keyframe stores: features from the in-tree checkpoint's
encoders (computed once, by the port, and handed to both), ground-truth
poses with seeded noise, sensor disparities with seeded noise.  Both
build the same band graph and run one low-memory step (alt-corr, chunked
GRU, whole-graph GraphAgg, DBA) in fp32.  ``bucket(130) = 192``, so both
solve with ``solver="cg"``; on the CPU the JAX package's matvec is its XLA
expression with Eij in fp32, the port's carries Eij as bf16.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints", "droid_synthetic.ckpt")

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

N, HT, WD, BUF = 130, 64, 96, 192


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs several workers on one machine; PyTorch's default of
    one thread per core in each of them makes them all wait on each
    other.  Two threads per worker for this file, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    """Per-keyframe state as numpy arrays, from seed 5."""
    from goslam_tpu.ops import lie as jlie
    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.models.droidnet import DroidNet
    from goslam_tpu_torch.tracking.motion_filter import normalize_images

    rng = np.random.default_rng(5)
    cfg = update_recursive(default_config(), {
        "cam": {"H_out": HT, "W_out": WD},
        "data": {"n_frames": N, "orbit_fraction": 1.6}})
    ds = Synthetic(cfg)
    items = [ds[i] for i in range(N)]
    net = DroidNet()
    net.load_state_dict(load_checkpoint(CKPT))
    net.eval()
    images = normalize_images(torch.from_numpy(
        np.concatenate([it[1] for it in items])))
    with torch.no_grad():
        fmaps = net.fnet(images, torch.float32)
        nets, inps = net.encode_context(images, torch.float32)
    bf = lambda a: a.to(torch.bfloat16).float().numpy()
    depth = np.stack([it[2][3::8, 3::8] for it in items])
    sens = (1.0 / depth).astype(np.float32)
    w2c = np.stack([np.linalg.inv(it[4]) for it in items]).astype(np.float32)
    poses = np.asarray(jlie.from_matrix(jnp.asarray(w2c)))
    dxi = (0.01 * rng.standard_normal((N, 6))).astype(np.float32)
    dxi[0] = 0
    poses = np.asarray(jlie.compose(jlie.exp(jnp.asarray(dxi)),
                                    jnp.asarray(poses)))
    disps = (sens * (1 + 0.05 * rng.standard_normal(sens.shape))).astype(
        np.float32)
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    keep = (ii != jj) & (np.abs(ii - jj) <= 2)
    return dict(net=net, fmaps=bf(fmaps), nets=bf(nets), inps=bf(inps),
                sens=sens, poses=poses, disps=disps,
                intr=items[0][3] / 8.0, ii=ii[keep], jj=jj[keep])


def _fill(rows, full):
    out = np.array(full)
    out[:len(rows)] = rows
    return out


@pytest.fixture(scope="module")
def port_run(state):
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph
    from goslam_tpu_torch.tracking.video import VideoBuffer

    v = VideoBuffer(BUF, HT, WD, "cpu")
    v.poses[:N] = torch.from_numpy(state["poses"].copy())
    v.disps[:N] = torch.from_numpy(state["disps"])
    v.disps_sens[:N] = torch.from_numpy(state["sens"])
    v.fmaps[:N, 0] = torch.from_numpy(state["fmaps"]).to(torch.bfloat16)
    v.nets[:N] = torch.from_numpy(state["nets"]).to(torch.bfloat16)
    v.inps[:N] = torch.from_numpy(state["inps"]).to(torch.bfloat16)
    v.intrinsics.copy_(torch.from_numpy(state["intr"]))
    v.counter = N
    graph = FactorGraph(v, state["net"], max_factors=600, corr_impl="alt",
                        inac_capacity=-1, compute_dtype=torch.float32)
    solvers = []
    ba = graph._window_ba
    graph._window_ba = lambda *a, **k: solvers.append(k["solver"]) or ba(
        *a, **k)
    with torch.no_grad():
        graph.add_factors(state["ii"], state["jj"])
        graph.update_lowmem(t0=1, t1=N, steps=1, max_t=N)
    return dict(poses=v.poses[:N].numpy(), disps=v.disps[:N].numpy(),
                n_edges=graph.n_edges(), solvers=solvers)


@pytest.fixture(scope="module")
def jax_run(state):
    from goslam_tpu.system import load_pretrained
    from goslam_tpu.tracking.factor_graph import FactorGraph
    from goslam_tpu.tracking.video import VideoBuffer

    v = VideoBuffer(buffer=BUF, ht=HT, wd=WD)
    for name, key in (("poses", "poses"), ("disps", "disps"),
                      ("disps_sens", "sens"), ("nets", "nets"),
                      ("inps", "inps")):
        full = getattr(v, name)
        setattr(v, name, jnp.asarray(_fill(state[key], full),
                                     full.dtype))
    fm = np.array(v.fmaps.astype(jnp.float32))
    fm[:N, 0] = state["fmaps"]
    v.fmaps = jnp.asarray(fm, jnp.bfloat16)
    v.intrinsics = jnp.asarray(state["intr"])
    v.counter = N
    graph = FactorGraph(v, load_pretrained(CKPT), max_factors=600,
                        corr_impl="alt", inac_capacity=-1,
                        compute_dtype=jnp.float32)
    graph.add_factors(state["ii"].astype(np.int32),
                      state["jj"].astype(np.int32))
    graph.update_lowmem(t0=1, t1=N, steps=1, max_t=N)
    return dict(poses=np.asarray(v.poses[:N]), disps=np.asarray(v.disps[:N]),
                n_edges=graph.n_edges())


def test_window_of_192_poses_runs_the_pcg_solver(state, port_run):
    """A global-BA window of P >= 192 no longer raises: it solves with
    PCG and moves the poses."""
    assert port_run["solvers"] == ["cg"]
    assert port_run["n_edges"] == len(state["ii"]) == 4 * N - 6
    assert np.isfinite(port_run["poses"]).all()
    assert np.isfinite(port_run["disps"]).all()
    moved = np.abs(port_run["poses"][1:, :3] - state["poses"][1:, :3]).max()
    assert moved > 1e-3
    np.testing.assert_array_equal(port_run["poses"][0], state["poses"][0])


def test_lowmem_cg_step_matches_jax(state, port_run, jax_run):
    """Poses and disparities after the step.  The update operator runs in
    fp32 in both; the two PCG solves (32 iterations at most, two
    Gauss-Newton steps) differ in summation order and in the port's bf16
    Eij: 2e-3 on translations of ~1 m and on the quaternion, 1 % plus
    2e-3 on disparities of ~0.4."""
    assert port_run["n_edges"] == jax_run["n_edges"]
    p, jp = port_run["poses"], jax_run["poses"]
    np.testing.assert_allclose(p[:, :3], jp[:, :3], atol=2e-3)
    sign = np.sign((p[:, 3:] * jp[:, 3:]).sum(-1, keepdims=True))
    np.testing.assert_allclose(p[:, 3:] * sign, jp[:, 3:], atol=2e-3)
    np.testing.assert_allclose(port_run["disps"], jax_run["disps"],
                               rtol=1e-2, atol=2e-3)
    # the step is no identity: what is compared is a real update
    assert np.abs(jp[1:, :3] - state["poses"][1:, :3]).max() > 1e-3
