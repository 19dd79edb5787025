"""Port parity on the CPU: ops/lie.py, ops/projective.py and the volume
correlation of ops/corr.py against the JAX package's functions.

Inputs are made with numpy from a seed and handed to both.  Everything is
fp32 in both packages; tolerances cover transcendental functions and
summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goslam_tpu.ops import corr as jcorr
from goslam_tpu.ops import lie as jlie
from goslam_tpu.ops import projective as jproj
from goslam_tpu_torch.ops import corr, lie, projective

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _poses(rng, n, rot=0.5, trans=1.0):
    xi = np.concatenate([trans * rng.standard_normal((n, 3)),
                         rot * rng.standard_normal((n, 3))], -1)
    return np.array(jax.vmap(jlie.exp)(jnp.asarray(xi, jnp.float32)))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-6, 0.0])
def test_exp_log_match_jax(rng, scale):
    """exp/log on ordinary and Taylor-range (tiny and zero) rotations."""
    xi = (scale * rng.standard_normal((16, 6))).astype(np.float32)
    np.testing.assert_allclose(lie.exp(_t(xi)).numpy(),
                               np.asarray(jlie.exp(jnp.asarray(xi))), **TOL)
    p = _poses(rng, 16, rot=scale, trans=scale)
    np.testing.assert_allclose(lie.log(_t(p)).numpy(),
                               np.asarray(jlie.log(jnp.asarray(p))),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("op", ["act", "inv", "compose", "rel", "retr",
                                "adjT", "matrix", "interp", "quat_inv"])
def test_group_ops_match_jax(rng, op):
    a, b = _poses(rng, 8), _poses(rng, 8)
    X = rng.standard_normal((8, 4)).astype(np.float32)
    xi = (0.3 * rng.standard_normal((8, 6))).astype(np.float32)
    w = rng.random(8).astype(np.float32)
    args = {
        "act": (a, X), "inv": (a,), "compose": (a, b), "rel": (a, b),
        "retr": (a, xi), "adjT": (a, xi), "matrix": (a,),
        "interp": (a, b, w), "quat_inv": (a[:, 3:],),
    }[op]
    got = getattr(lie, op)(*[_t(x) for x in args])
    expect = getattr(jlie, op)(*[jnp.asarray(x) for x in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-5)


def _scene(rng, T=4, ht=6, wd=8, far=False):
    poses = _poses(rng, T, rot=0.05, trans=0.1)
    lo = 0.02 if far else 0.3
    disps = (lo + 0.5 * rng.random((T, ht, wd))).astype(np.float32)
    intr = np.asarray([7.0, 7.5, wd / 2 - 0.5, ht / 2 - 0.5], np.float32)
    # regular edges, a stereo edge (ii == jj) and a repeated pair
    ii = np.array([0, 1, 2, 3, 1, 2], np.int64)
    jj = np.array([1, 2, 3, 0, 1, 0], np.int64)
    return poses, disps, intr, ii, jj


def test_coords_grid_iproj_proj_match_jax(rng):
    poses, disps, intr, ii, jj = _scene(rng)
    np.testing.assert_array_equal(projective.coords_grid(6, 8).numpy(),
                                  np.asarray(jproj.coords_grid(6, 8)))
    X = projective.iproj(_t(disps), _t(intr))
    np.testing.assert_allclose(
        X.numpy(), np.asarray(jproj.iproj(jnp.asarray(disps),
                                          jnp.asarray(intr))), **TOL)
    # Z below 0.5 * MIN_DEPTH is replaced by 1 in both
    Xs = rng.standard_normal((5, 6, 8, 4)).astype(np.float32)
    for depth in (False, True):
        np.testing.assert_allclose(
            projective.proj(_t(Xs), _t(intr), depth).numpy(),
            np.asarray(jproj.proj(jnp.asarray(Xs), jnp.asarray(intr),
                                  depth)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("return_depth", [False, True])
def test_transform_matches_jax(rng, return_depth):
    poses, disps, intr, ii, jj = _scene(rng)
    c, v = projective.transform(_t(poses), _t(disps), _t(intr), _t(ii),
                                _t(jj), return_depth=return_depth)
    jc, jv = jproj.transform(jnp.asarray(poses), jnp.asarray(disps),
                             jnp.asarray(intr), jnp.asarray(ii),
                             jnp.asarray(jj), return_depth=return_depth)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("far", [False, True])
def test_frame_distance_matches_jax(rng, far):
    """far=True puts points behind the MIN_DEPTH cut, so pairs with fewer
    than 75% valid pixels take the 1000 sentinel."""
    poses, disps, intr, ii, jj = _scene(rng, far=far)
    if far:
        poses[0, 2] -= 3.0
    d = projective.frame_distance(_t(poses), _t(disps), _t(intr), _t(ii),
                                  _t(jj), beta=0.3)
    jd = jproj.frame_distance(jnp.asarray(poses), jnp.asarray(disps),
                              jnp.asarray(intr), jnp.asarray(ii),
                              jnp.asarray(jj), beta=0.3)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    if far:
        assert (d.numpy() == 1000.0).any()


def test_build_pyramid_and_lookup_match_jax(rng):
    E, H, W, C = 3, 8, 12, 32
    f1 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    jpyr = jcorr.build_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    pyr = corr.build_pyramid(_t(f1), _t(f2))
    for jl, tl in zip(jpyr.levels, pyr):
        assert tl.dtype == torch.bfloat16 and tl.shape == jl.shape
        # the fp32 volume may round to a neighbouring bf16 value
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl.astype(jnp.float32)),
                                   rtol=1e-2, atol=1e-2)

    # lookup on identical (JAX-built) volumes: interior and
    # out-of-bounds coordinates
    coords = rng.uniform(-4, 15, size=(E, H, W, 2)).astype(np.float32)
    same = [_t(jl.astype(jnp.float32)).to(torch.bfloat16)
            for jl in jpyr.levels]
    got = corr.lookup(same, _t(coords))
    expect = jcorr.lookup(jpyr, jnp.asarray(coords))
    assert got.shape == (E, H, W, 4 * 49)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-5)
