"""The plain versions of the port's two CUDA kernels against the JAX
package's references, on the CPU.

  K1 ``dba.build_edge_system_plain`` (plain version of csrc/edge_system.cu)
     vs JAX ``dba.build_edge_system`` and the Pallas kernel
     ``build_edge_system_fused`` run in interpret mode;
  K2 ``corr.alt_corr_plain`` (plain version of csrc/alt_corr.cu) vs JAX
     ``corr.alt_corr``, ``alt_corr_fused`` in interpret mode, and
     ``alt_corr_mxu`` (what the JAX package runs on the CPU).

Inputs are made with numpy from a seed and handed to both packages.  On
CPU tensors the public wrappers take the plain versions; on any other
device they launch the kernel or raise, never fall back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goslam_tpu.ops import corr as jcorr
from goslam_tpu.ops import dba as jdba
from goslam_tpu.ops import lie as jlie
from goslam_tpu.ops.pallas_corr import alt_corr_fused
from goslam_tpu.ops.pallas_kernels import build_edge_system_fused
from goslam_tpu_torch.ops import corr, dba


def _t(a):
    return torch.from_numpy(np.array(a))


def _edge_problem(rng, Pn=6, ht=8, wd=16):
    """Poses near identity, stereo (ii == jj) and invalid (padding)
    edges among the regular ones, as tests/test_pallas_kernels.py."""
    xi = (0.05 * rng.standard_normal((Pn, 6))).astype(np.float32)
    poses = np.asarray(jax.vmap(jlie.exp)(jnp.asarray(xi)))
    disps = (0.4 + 0.3 * rng.random((Pn, ht, wd))).astype(np.float32)
    intr = np.asarray([12.0, 13.0, wd / 2, ht / 2], np.float32)
    ii = np.array([0, 1, 2, 3, 4, 5, 2, 3, 0], np.int64)
    jj = np.array([1, 2, 3, 4, 5, 0, 4, 1, 0], np.int64)
    valid = np.ones(len(ii), bool)
    valid[3] = False
    E = len(ii)
    tgt = (rng.random((E, ht, wd, 2)) * wd).astype(np.float32)
    wgt = rng.random((E, ht, wd, 2)).astype(np.float32)
    return poses, disps, intr, tgt, wgt, ii, jj, valid


def _assert_close_scaled(port, ref, names, atol):
    """Per output, |port - ref| relative to the output's largest entry:
    the sums over pixels run in another order in each framework."""
    for name, a, b in zip(names, port, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_edge_system_plain_matches_jax(rng, ref):
    prob = _edge_problem(rng)
    poses, disps, intr, tgt, wgt, ii, jj, valid = prob
    jargs = [jnp.asarray(a) for a in prob]
    jargs[5], jargs[6] = jargs[5].astype(jnp.int32), jargs[6].astype(
        jnp.int32)
    with jax.default_matmul_precision("highest"):
        if ref == "xla":
            expect = jdba.build_edge_system(*jargs)
        else:
            expect = build_edge_system_fused(*jargs, eb=4, interpret=True)
    got = dba.build_edge_system(*[_t(a) for a in prob])
    # fp32 everywhere; 1e-5 of each output's range covers the reordered
    # sums over 128 pixels
    _assert_close_scaled(got, expect, dba.EdgeSystem._fields, 1e-5)
    # stereo edge (index 8) constrains depth only; invalid edge (index 3)
    # contributes nothing
    assert float(got.H[8].abs().max()) == 0.0
    assert float(got.Cii[8].abs().max()) > 0.0
    assert float(got.H[3].abs().max()) == 0.0
    assert float(got.Cii[3].abs().max()) == 0.0


def _corr_problem(rng, T=3, H=8, W=12, C=128, E=4, levels=4):
    fmaps = rng.normal(size=(T, H, W, C)).astype(np.float32)
    ii = np.array([0, 2, 1, 2], np.int64)[:E]
    jj = np.array([1, 0, 1, 2], np.int64)[:E]
    # interior and out-of-bounds coordinates, to reach the zero-OOB taps
    coords = rng.uniform(-3, max(H, W) + 2, size=(E, H, W, 2)).astype(
        np.float32)
    jfp = jcorr.build_feature_pyramid(jnp.asarray(fmaps), num_levels=levels)
    fp = corr.build_feature_pyramid(_t(fmaps), num_levels=levels)
    return jfp, fp, coords, ii, jj


def test_feature_pyramid_matches_jax(rng):
    jfp, fp, *_ = _corr_problem(rng)
    for jl, tl in zip(jfp.levels, fp):
        # the kernel reads each level as a dense [T, h, w, 128] array
        assert tl.dtype == torch.bfloat16 and tl.is_contiguous()
        # both pool in fp32 and round once to bf16
        np.testing.assert_array_equal(np.asarray(jl.astype(jnp.float32)),
                                      tl.float().numpy())


@pytest.mark.parametrize("levels", [2, 4])
def test_alt_corr_plain_matches_jax_alt_corr(rng, levels):
    jfp, fp, coords, ii, jj = _corr_problem(rng, levels=levels)
    expect = jcorr.alt_corr(jfp, jnp.asarray(coords),
                            jnp.asarray(ii, jnp.int32),
                            jnp.asarray(jj, jnp.int32))
    got = corr.alt_corr(fp, _t(coords), _t(ii), _t(jj))
    assert got.shape == (4, 8, 12, levels * 49)
    # same exact bf16 x bf16 products summed in fp32 in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-5)


def test_alt_corr_plain_matches_pallas_interpret(rng):
    jfp, fp, coords, ii, jj = _corr_problem(rng, levels=2)
    expect = alt_corr_fused(tuple(jfp.levels), jnp.asarray(coords),
                            jnp.asarray(ii, jnp.int32),
                            jnp.asarray(jj, jnp.int32), interpret=True)
    got = corr.alt_corr(fp, _t(coords), _t(ii), _t(jj))
    # the Pallas kernel forms the whole volume with a bf16 MXU product
    # accumulated in fp32: the same numbers up to summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)


def test_alt_corr_plain_matches_alt_corr_mxu(rng):
    jfp, fp, coords, ii, jj = _corr_problem(rng)
    expect = jcorr.alt_corr_mxu(jfp, jnp.asarray(coords),
                                jnp.asarray(ii, jnp.int32),
                                jnp.asarray(jj, jnp.int32))
    got = corr.alt_corr(fp, _t(coords), _t(ii), _t(jj))
    # alt_corr_mxu rounds its volume to bf16 before the window gather
    # (goslam_tpu/ops/corr.py:246); the port does not: bf16 tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=2e-2,
                               atol=2e-2)


def test_alt_corr_clamps_frame_indices_like_a_jax_gather(rng):
    """JAX gathers clamp an out-of-range frame index; the port clamps
    explicitly (a torch gather would raise)."""
    jfp, fp, coords, ii, jj = _corr_problem(rng, levels=2)
    ii_bad, jj_bad = ii.copy(), jj.copy()
    ii_bad[0], jj_bad[1] = 7, -5
    expect = jcorr.alt_corr(jfp, jnp.asarray(coords),
                            jnp.asarray(ii_bad, jnp.int32),
                            jnp.asarray(jj_bad, jnp.int32))
    got = corr.alt_corr(fp, _t(coords), _t(ii_bad), _t(jj_bad))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("which", ["edge_system", "alt_corr"])
def test_wrappers_never_fall_back_off_the_cpu(rng, which):
    """A tensor that is not on the CPU goes to the kernel or raises:
    meta tensors reach the kernel path, which cannot run here."""
    if which == "edge_system":
        prob = [_t(a).to("meta") for a in _edge_problem(rng)]
        call = lambda: dba.build_edge_system(*prob)
    else:
        _, fp, coords, ii, jj = _corr_problem(rng)
        args = ([lv.to("meta") for lv in fp], _t(coords).to("meta"),
                _t(ii).to("meta"), _t(jj).to("meta"))
        call = lambda: corr.alt_corr(*args)
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        call()
