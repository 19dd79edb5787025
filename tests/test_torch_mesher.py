"""The port's multiview filter and mesher against the JAX package, on the CPU.

The depth-consistency counts and world points, the bilinear resize, the
filter's published state (masks, bound, priorities) with upsampled
disparities and without, the SDF grid and vertex colours of a model with
the same parameters, the port's own native marching tetrahedra and depth
rasterizer against the JAX package's on the same grid and mesh, and the
host mesh stack (culling, evaluation, ICP, PLY) on the same inputs.
Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goslam_tpu import native as jnative
from goslam_tpu.config import default_config as jdefault_config
from goslam_tpu.data.synthetic import Synthetic as JSynthetic
from goslam_tpu.mapping import mesher as jmesher
from goslam_tpu.mapping.instant_neus import InstantNeuS as JNeuS
from goslam_tpu.ops import lie as jlie
from goslam_tpu.ops import projective as jprojective
from goslam_tpu.tracking.multiview_filter import \
    MultiviewFilter as JMultiviewFilter
from goslam_tpu.tracking.video import VideoBuffer as JVideo
from goslam_tpu.utils.obb import OrientedBoundingBox as JOBB
from goslam_tpu_torch import native
from goslam_tpu_torch.config import default_config, update_recursive
from goslam_tpu_torch.data.synthetic import Synthetic
from goslam_tpu_torch.mapping import mesher
from goslam_tpu_torch.mapping.instant_neus import InstantNeuS
from goslam_tpu_torch.models.convert import convert_mapping_params
from goslam_tpu_torch.ops import projective
from goslam_tpu_torch.tracking.multiview_filter import (MultiviewFilter,
                                                        resize_bilinear)
from goslam_tpu_torch.tracking.video import VideoBuffer
from goslam_tpu_torch.utils.obb import OrientedBoundingBox

HT, WD = 48, 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads: the suite runs several test files at once, and
    more threads than cores slow torch's small operations many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(rng, T=10):
    """T poses along a short path with small rotations, full-resolution
    disparities of a slanted wall with noise, intrinsics."""
    xi = np.zeros((T, 6), np.float32)
    xi[:, 0] = 0.03 * np.arange(T)
    xi[:, 3:] = 0.01 * rng.standard_normal((T, 3))
    poses = np.asarray(jlie.exp(jnp.asarray(xi)))
    u = np.linspace(0, 1, WD, dtype=np.float32)
    disps = 0.5 + 0.2 * u[None, None, :] + 0.0 * rng.random((T, HT, 1))
    disps = (disps + 0.01 * rng.standard_normal((T, HT, WD))).astype(
        np.float32)
    intr = np.asarray([50.0, 50.0, WD / 2 - 0.5, HT / 2 - 0.5], np.float32)
    return poses, disps, intr


def test_depth_consistency_count_and_world_points_match_jax(rng):
    poses, disps, intr = _scene(rng)
    thresh = np.linspace(0.02, 0.2, len(poses)).astype(np.float32)
    for t in (0.05, thresh):
        expect = np.asarray(jprojective.depth_consistency_count(
            *map(jnp.asarray, (poses, disps, intr)), jnp.asarray(t)))
        got = projective.depth_consistency_count(
            *map(torch.from_numpy, (poses, disps, intr)), torch.tensor(t))
        np.testing.assert_array_equal(got.numpy(), expect)
        assert 0 < expect.mean() < 6
    expect = np.asarray(jprojective.iproj_world(
        *map(jnp.asarray, (poses, disps, intr))))
    got = projective.iproj_world(*map(torch.from_numpy,
                                      (poses, disps, intr)))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-6, atol=1e-6)


def test_bilinear_resize_is_jax_images(rng):
    """jax.image.resize(..., "bilinear") at the 8x upsampling of the
    filter's fallback, borders included: within 1e-6."""
    x = rng.uniform(0.1, 1.0, (3, 6, 8)).astype(np.float32)
    expect = np.asarray(jax.image.resize(jnp.asarray(x), (3, 48, 64),
                                         "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), 48, 64).numpy()
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-6)


def _filter_cfg(upsample, kernel_size):
    over = {"tracking": {"upsample": upsample, "multiview_filter": {
        "thresh": 0.05, "kernel_size": kernel_size}}}
    return (update_recursive(jdefault_config(), over),
            update_recursive(default_config(), over))


@pytest.mark.parametrize("upsample,kernel_size", [(True, 1), (True, 3),
                                                   (False, 1), (False, 4)])
def test_multiview_filter_publishes_what_jax_does(rng, upsample,
                                                  kernel_size):
    """Two passes (10 keyframes, then 13 after the poses moved): the
    masks exactly (the frames past the counter in the padded batch take
    part as neighbours), the bound within 1e-5, the priorities, filtered
    poses and disparities.  upsample False resizes the 1/8-resolution
    disparities (jax.image's bilinear weights)."""
    poses, disps, intr = _scene(rng, 13)
    disps8 = disps[:, 3::8, 3::8].copy()
    jcfg, cfg = _filter_cfg(upsample, kernel_size)
    jv = JVideo(buffer=16, ht=HT, wd=WD)
    tv = VideoBuffer(16, HT, WD, "cpu")
    jv.intrinsics = jnp.asarray(intr / 8)
    tv.intrinsics[:] = torch.from_numpy(intr / 8)
    jf = JMultiviewFilter(jv, jcfg, warmup=4)
    tf = MultiviewFilter(tv, cfg, warmup=4)
    for n, moved in ((10, 0.0), (13, 0.02)):
        p = poses.copy()
        p[:, :3] += moved
        jv.counter = tv.counter = n
        jv.poses = jv.poses.at[:n].set(p[:n])
        jv.disps = jv.disps.at[:n].set(disps8[:n])
        jv.disps_up = jv.disps_up.at[:n].set(disps[:n])
        tv.poses[:n] = torch.from_numpy(p[:n])
        tv.disps[:n] = torch.from_numpy(disps8[:n])
        tv.disps_up[:n] = torch.from_numpy(disps[:n])
        assert jf() and tf()
        assert tv.filtered_id == jv.filtered_id == n
        np.testing.assert_array_equal(tv.mask_filtered.numpy(),
                                      np.asarray(jv.mask_filtered))
        assert 0.05 < float(tv.mask_filtered[:n].mean()) < 1.0
        np.testing.assert_allclose(tv.bound, jv.bound, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tv.update_priority, jv.update_priority,
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tv.disps_filtered.numpy(),
                                   np.asarray(jv.disps_filtered), atol=1e-6)
        np.testing.assert_array_equal(tv.poses_filtered.numpy(),
                                      np.asarray(jv.poses_filtered))
    assert tv.update_priority[:13].max() > 0
    assert not tf() and not jf()          # nothing new to publish


# ---------------------------------------------------------------------------
# field extraction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """A JAX InstantNeuS parameter tree drawn with numpy as its init
    draws (hash table +-1e-4, the SDF layer's xyz rows Gaussian and its
    grid rows zero, B ~ N(0, 25^2)), and the port's model holding it."""
    r = np.random.default_rng(0)

    def dense(d_in, d_out):
        return {"kernel": (r.standard_normal((d_in, d_out))
                           / np.sqrt(d_in)).astype(np.float32),
                "bias": np.zeros(d_out, np.float32)}

    sdf = np.zeros((35, 32), np.float32)
    sdf[:3] = r.standard_normal((3, 32)) * np.sqrt(2.0 / 32)
    params = {
        "sdf_network": {
            "encoding": {"table": r.uniform(-1e-4, 1e-4, (16, 1 << 19, 2)
                                            ).astype(np.float32)},
            "sdf_layer": {"kernel": sdf, "bias": np.zeros(32, np.float32)}},
        "color_network": {
            "B": (25.0 * r.standard_normal((3, 33))).astype(np.float32),
            "hidden0": dense(67, 64), "hidden1": dense(64, 64),
            "out": dense(64, 3)},
        "variance": np.asarray(0.2, np.float32)}
    tm = InstantNeuS()
    tm.load_state_dict(convert_mapping_params(params))
    return JNeuS(), jax.tree.map(jnp.asarray, params), tm


def test_sdf_grid_mesh_and_colours_match_jax(models):
    """extract_sdf_grid at resolution 20 over a bound that cuts the
    init's SDF (a tilted plane through the xyz columns), with a tighter
    realtime bound: within 1e-5; the marching-tetrahedra mesh of it, and
    its vertex colours (through d sdf / dx) within one uint8 step."""
    jm, params, tm = models
    bound = np.asarray([[-1.0, 1.2], [-0.8, 1.0], [-1.1, 0.9]], np.float32)
    rt = bound * 0.9
    expect = jmesher.extract_sdf_grid(jm, params, jnp.asarray(bound),
                                      jnp.asarray(rt), 20)
    got = mesher.extract_sdf_grid(tm, torch.from_numpy(bound),
                                  torch.from_numpy(rt), 20)
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-5)
    assert (got == -100).any() and (got != -100).any()
    jv_, jt = jmesher.extract_mesh(jm, params, jnp.asarray(bound),
                                   jnp.asarray(bound), 20)
    v, t = mesher.extract_mesh(tm, torch.from_numpy(bound),
                               torch.from_numpy(bound), 20)
    assert len(t) > 100
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(v, jv_, atol=1e-5)
    expect = jmesher.extract_vertex_colors(jm, params, jnp.asarray(bound),
                                           jv_)
    got = mesher.extract_vertex_colors(tm, torch.from_numpy(bound), v)
    assert np.abs(got.astype(int) - expect).max() <= 1


# ---------------------------------------------------------------------------
# native helpers and the host mesh stack
# ---------------------------------------------------------------------------

def _blob_grid(rng, n=24):
    """A noisy sphere's signed distance on an n^3 grid."""
    c = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) - 0.6
            + 0.05 * rng.standard_normal((n, n, n))).astype(np.float32)


def test_native_marching_and_raster_are_the_jax_packages(rng):
    """The port builds its own copies of the C++ sources: the same
    vertices and triangles, and the same rendered depths, bit for bit."""
    grid = _blob_grid(rng)
    v, t = native.marching_cubes(grid, 0.0)
    jv_, jt = jnative.marching_cubes(grid, 0.0)
    assert len(t) > 500
    np.testing.assert_array_equal(v, jv_)
    np.testing.assert_array_equal(t, jt)
    assert native.build("marching").startswith(native.BUILD_DIR)

    verts = v / 12.0 - 1.0 + np.asarray([0, 0, 3], np.float32)
    w2c = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    w2c[1, :3, 3] = [0.3, -0.2, 0.5]
    w2c[2, :3, :3] = np.asarray(jlie.quat_to_matrix(jnp.asarray(
        [0.0, 0.1, 0.0, 0.995])))
    intr = (40.0, 40.0, 31.5, 23.5)
    got = native.render_depth(verts, t, w2c, intr, HT, WD)
    expect = jnative.render_depth(verts, t, w2c, intr, HT, WD)
    np.testing.assert_array_equal(got, expect)
    assert (got > 0).mean() > 0.05


def _room_mesh(rng):
    """The synthetic room's GT mesh, a little noise on its vertices and
    a small blob far outside it."""
    cfg = default_config()
    v, t = Synthetic(cfg).gt_mesh(subdiv=24)
    v = v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
    bv, bt = native.marching_cubes(_blob_grid(rng, 10), 0.0)
    bv = (bv * 0.02 + 5.0).astype(np.float32)
    return (np.concatenate([v, bv]).astype(np.float32),
            np.concatenate([t, bt + len(v)]).astype(np.int32))


def test_cull_eval_icp_and_ply_are_the_jax_packages(rng, tmp_path):
    """cull_mesh with the OBB of the points and a forecast radius,
    cull_small_components, eval_mesh, align_mesh_icp (seeded and not),
    and a PLY with colours written and read back: the same arrays and
    numbers as the JAX package's on the same inputs."""
    v, t = _room_mesh(rng)
    c2w = []
    for a in np.linspace(0, 1.5, 6):
        m = np.eye(4)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.3 * np.sin(a), 0.0, 0.3 * np.cos(a) - 0.5]
        c2w.append(m)
    intr = np.asarray([40.0, 40.0, 31.5, 23.5])
    pts = v[rng.choice(len(v), 400, replace=False)]
    obb, jobb = (OrientedBoundingBox.from_points(pts, extend=0.1),
                 JOBB.from_points(pts, extend=0.1))
    for kw in ({"obb": obb, "forecast_radius": 10.0}, {"forecast_radius": 0},
               {"bound": np.asarray([[-3, 3], [-3, 3], [-3, 3]])}):
        jkw = dict(kw, obb=jobb) if "obb" in kw else kw
        got = mesher.cull_mesh(v, t, c2w, intr, HT, WD, **kw)
        expect = jmesher.cull_mesh(v, t, c2w, intr, HT, WD, **jkw)
        for a, b in zip(got, expect):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert len(got[0][1]) > 10
    for largest in (False, True):
        for a, b in zip(mesher.cull_small_components(v, t, 0.2, largest),
                        jmesher.cull_small_components(v, t, 0.2, largest)):
            np.testing.assert_array_equal(a, b)

    gv, gt = Synthetic(default_config()).gt_mesh()
    assert mesher.eval_mesh(v, t, gv, gt, n_points=5000) == \
        jmesher.eval_mesh(v, t, gv, gt, n_points=5000)
    init = np.eye(4)
    init[:3, 3] = [0.05, -0.02, 0.01]
    for i in (None, init):
        np.testing.assert_array_equal(
            mesher.align_mesh_icp(v + 0.05, gv, init=i, n_sample=2000),
            jmesher.align_mesh_icp(v + 0.05, gv, init=i, n_sample=2000))

    colors = rng.integers(0, 256, (len(v), 3)).astype(np.uint8)
    mesher.save_ply(str(tmp_path / "a.ply"), v, t, colors)
    jmesher.save_ply(str(tmp_path / "b.ply"), v, t, colors)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    rv, rt = mesher.load_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(rv, v)
    np.testing.assert_array_equal(rt, t)


def test_gt_mesh_is_the_jax_packages():
    cfg = update_recursive(default_config(), {"data": {
        "room_half_size": 2.5}})
    for subdiv in (3, 8):
        got = Synthetic(cfg).gt_mesh(subdiv)
        expect = JSynthetic(cfg).gt_mesh(subdiv)
        for a, b in zip(got, expect):
            np.testing.assert_array_equal(a, b)
