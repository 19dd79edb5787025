"""The plain versions of the port's CUDA kernels against the JAX
package's references, on the CPU (K3, the Schur matvec, is held to the
JAX package in tests/test_torch_cg.py).

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
from goslam_tpu_torch.ops import corr, dba, kernels


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


def _edge_case(rng, case):
    """The edge-system inputs of one case: mixed (regular, stereo and
    invalid edges), behind (frame 0 moved 1.5 forward: part of frame 5
    lands at z < MIN_DEPTH on edge 5 -> 0), ragged (a 7x11 frame),
    invalid (every edge invalid), single (E=1).  The same kinds of input
    chip_smoke.py gives the CUDA kernel on the card."""
    if case == "ragged":
        return _edge_problem(rng, ht=7, wd=11)
    prob = list(_edge_problem(rng))
    if case == "behind":
        prob[0] = prob[0].copy()
        prob[0][0, 2] -= 1.5
    elif case == "invalid":
        prob[7] = np.zeros_like(prob[7])
    elif case == "single":
        prob[3:] = [a[:1] for a in prob[3:]]
    return tuple(prob)


EDGE_CASES = ["mixed", "behind", "ragged", "invalid", "single"]


# the mixed case keeps the ids "xla" and "pallas_interpret"
@pytest.mark.parametrize("ref,case", [
    pytest.param(ref, case, id=ref if case == "mixed" else f"{ref}-{case}")
    for case in EDGE_CASES for ref in ("xla", "pallas_interpret")])
def test_edge_system_plain_matches_jax(rng, ref, case):
    prob = _edge_case(rng, case)
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
    if case == "mixed":
        # stereo edge (index 8) constrains depth only; invalid edge
        # (index 3) contributes nothing
        assert float(got.H[8].abs().max()) == 0.0
        assert float(got.Cii[8].abs().max()) > 0.0
        assert float(got.H[3].abs().max()) == 0.0
        assert float(got.Cii[3].abs().max()) == 0.0
    elif case == "behind":
        # edge 5 -> 0 sees some pixels behind MIN_DEPTH, not all
        assert bool((got.Cii[5] == 0).any()) and bool((got.Cii[5] > 0).any())
    elif case == "invalid":
        assert all(float(t.abs().max()) == 0.0 for t in got)


def test_edge_system_cuda_wrapper_is_one_launch_without_host_data(
        rng, monkeypatch):
    """On a tensor off the CPU, dba.build_edge_system checks, allocates
    and launches the kernel once on the raw arguments: no host data turned
    into a tensor, no device value read (meta tensors have none), so it
    never synchronizes."""
    prob = [_t(a).to("meta") for a in _edge_problem(rng)]
    E, (ht, wd) = prob[5].shape[0], prob[1].shape[1:]
    hw = ht * wd
    calls = []
    monkeypatch.setattr(kernels, "edge_system",
                        lambda *a: calls.append(a))

    def refuse(*a, **k):
        raise AssertionError("the wrapper touched host data or a device "
                             "value")

    monkeypatch.setattr(torch.Tensor, "new_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = dba.build_edge_system(*prob)
    monkeypatch.undo()
    assert len(calls) == 1
    args = calls[0]
    assert len(args) == 14
    assert all(got is want for got, want in zip(args[:8], prob))
    assert [tuple(t.shape) for t in args[8:]] == [
        (E, 12, 12), (E, 12), (E, 6, hw), (E, 6, hw), (E, hw), (E, hw)]
    assert all(t.dtype == torch.float32 and t.device.type == "meta"
               and t.is_contiguous() for t in args[8:])
    assert all(o is a for o, a in zip(out, args[8:]))


def test_edge_system_cuda_wrapper_checks_its_arguments(rng):
    """The checks run on metadata alone: a wrong type, shape or layout
    raises before anything is allocated or launched."""
    prob = [_t(a).to("meta") for a in _edge_problem(rng)]
    bad = [
        ("poses", prob[0][:, :6]),
        ("target", prob[3].transpose(1, 2)),
        ("weight", prob[4].double()),
        ("ii", prob[5].int()),
        ("jj", prob[6].int()),
        ("valid", prob[7].float()),
        ("valid", prob[7].to(torch.uint8)),
        ("intrinsics", prob[2][:3]),
    ]
    names = ["poses", "disps", "intrinsics", "target", "weight", "ii",
             "jj", "valid"]
    for name, t in bad:
        args = list(prob)
        args[names.index(name)] = t
        with pytest.raises(ValueError):
            dba.check_edge_args(*args)
    assert dba.check_edge_args(*prob) == (prob[5].shape[0], 8 * 16)


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


def _adversarial_coords(rng, kind, coords, H=8, W=12):
    """Coordinates that test the alt-corr kernel's reduction of a pixel
    tile's windows to the box of target rows and columns they touch (its
    tiles are 64 pixels: the first 64 of the 96 here):
      nan       some x, some y, some both NaN: their outputs are NaN;
      far       some coordinates at +-1e6: all their taps out of bounds;
      tile_out  the first 64 pixels of every edge with windows that miss
                the image at every level; the rest spans the frame;
      border    coordinates at and around the last value whose window
                still touches the image, on each side, at each level."""
    c = coords.copy()
    flat = c.reshape(-1, 2)
    if kind == "nan":
        pick = rng.random(flat.shape) < 0.08
        flat[pick] = np.nan
    elif kind == "far":
        pick = rng.random(flat.shape) < 0.3
        flat[pick] = rng.choice([-1e6, 1e6], size=int(pick.sum()))
    elif kind == "tile_out":
        E = c.shape[0]
        tile = c.reshape(E, -1, 2)[:, :64]
        tile[...] = rng.uniform(-200, -40, size=tile.shape)
        right = tile[1::2, :, 0]
        right[...] = rng.uniform(8 * (W + 4), 300, size=right.shape)
    else:
        vals = []
        for size in (W, H):
            vals.append([s * 2 ** l + d for l in range(4)
                         for s in (-4, -3, size + 2, size + 3)
                         for d in (-0.25, 0.0, 0.25)])
        for a in range(2):
            flat[:, a] = rng.choice(vals[a], size=flat.shape[0])
        keep = rng.random(flat.shape[0]) < 0.3
        flat[keep] = coords.reshape(-1, 2)[keep]
    return c


@pytest.mark.parametrize("kind", ["nan", "far", "tile_out", "border"])
def test_alt_corr_plain_matches_jax_at_adversarial_coords(rng, kind):
    jfp, fp, coords, ii, jj = _corr_problem(rng)
    coords = _adversarial_coords(rng, kind, coords)
    expect = np.asarray(jcorr.alt_corr(jfp, jnp.asarray(coords),
                                       jnp.asarray(ii, jnp.int32),
                                       jnp.asarray(jj, jnp.int32)))
    got = corr.alt_corr(fp, _t(coords), _t(ii), _t(jj)).numpy()
    # a NaN coordinate gives NaN outputs for its pixel in both, and only
    # there; elsewhere the same exact bf16 x bf16 products summed in fp32
    # in another order
    bad = np.isnan(coords).any(-1)
    assert np.isnan(got).any(-1).tolist() == bad.tolist()
    assert np.isnan(got).all(-1).tolist() == bad.tolist()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    if kind in ("far", "tile_out"):
        out = np.abs(coords).max(-1) >= 1e6 if kind == "far" else \
            np.arange(96).reshape(8, 12)[None] < 64
        assert np.all(got[np.broadcast_to(out, got.shape[:-1])] == 0)
    if kind == "border":
        assert np.count_nonzero(got) > 0


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


@pytest.mark.parametrize("which", ["edge_system", "alt_corr",
                                   "schur_matvec"])
def test_wrappers_never_fall_back_off_the_cpu(rng, which):
    """A tensor that is not on the CPU goes to the kernel or raises:
    meta tensors reach the kernel path, which cannot run here."""
    if which == "edge_system":
        prob = [_t(a).to("meta") for a in _edge_problem(rng)]
        call = lambda: dba.build_edge_system(*prob)
    elif which == "schur_matvec":
        P, E, hw = 4, 6, 16
        args = [torch.zeros(shape, dtype=dt, device="meta")
                for shape, dt in (((P, 6), torch.float32),
                                  ((P, 6, hw), torch.float32),
                                  ((P, hw), torch.float32),
                                  ((E, 12, 12), torch.float32),
                                  ((E, 6, hw), torch.bfloat16),
                                  ((E,), torch.int32),
                                  ((P + 1,), torch.int32),
                                  ((P + 1,), torch.int32),
                                  ((E,), torch.int32))]
        call = lambda: dba.schur_matvec(*args, dba.schur_work(P, E, "meta"))
    else:
        _, fp, coords, ii, jj = _corr_problem(rng)
        args = ([lv.to("meta") for lv in fp], _t(coords).to("meta"),
                _t(ii).to("meta"), _t(jj).to("meta"))
        call = lambda: corr.alt_corr(*args)
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        call()
