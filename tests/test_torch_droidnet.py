"""DroidNet in the port against the flax modules, on the CPU.

Parameters come from ``goslam_tpu.system.init_params`` and are carried
over by ``models.convert.flax_to_state_dict``; inputs are made with numpy
from a seed.  Both sides compute in fp32 (JAX at "highest" matmul
precision, set in conftest.py), so what is left is summation order inside
the convolutions: tolerances are relative to each output's largest entry.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goslam_tpu.models import droidnet as jdn
from goslam_tpu.system import init_params, load_pretrained
from goslam_tpu_torch.models import convert, droidnet

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints", "droid_synthetic.ckpt")


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, init_params(seed=3))


@pytest.fixture(scope="module")
def net(jparams):
    m = droidnet.DroidNet()
    m.load_state_dict(convert.flax_to_state_dict(jparams))
    return m.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, expect, tol, name=""):
    got = got.detach().float().numpy()
    expect = np.asarray(expect, np.float32)
    assert got.shape == expect.shape, (name, got.shape, expect.shape)
    scale = np.abs(expect).max() + 1e-12
    np.testing.assert_allclose(got / scale, expect / scale, atol=tol,
                               err_msg=name)


def test_convert_carries_every_leaf(jparams):
    """Every flax conv becomes one weight and one bias, HWIO -> OIHW, and
    the state dict loads strictly into the port's modules."""
    leaves = jax.tree_util.tree_leaves(jparams)
    sd = convert.flax_to_state_dict(jparams)
    assert len(sd) == len(leaves) + 1            # + weight_calib
    k = jparams["fnet"]["conv1"]["kernel"]       # [7, 7, 3, 32] HWIO
    np.testing.assert_array_equal(sd["fnet.conv1.weight"].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    droidnet.DroidNet().load_state_dict(sd, strict=True)
    assert float(sd["weight_calib"]) == 1.0
    calib = dict(jparams, weight_calib=np.float32(0.5))
    assert float(convert.flax_to_state_dict(calib)["weight_calib"]) == 0.5


@pytest.mark.skipif(not os.path.exists(CKPT), reason="no checkpoint")
def test_load_checkpoint_matches_the_jax_loader():
    """The port reads the trainer's pickle with pickle alone and gets the
    same numbers the JAX loader gives."""
    sd = convert.load_checkpoint(CKPT)
    expect = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, load_pretrained(CKPT)))
    assert sd.keys() == expect.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), expect[k].numpy(), k)


def test_instance_norm_matches_jax(rng):
    x = rng.standard_normal((2, 6, 9, 5)).astype(np.float32) * 3 + 1
    got = droidnet.instance_norm(_t(x).permute(0, 3, 1, 2))
    expect = jdn.instance_norm(jnp.asarray(x))
    _close(got.permute(0, 2, 3, 1), expect, 1e-6)


@pytest.mark.parametrize("which", ["fnet", "cnet"])
def test_encoder_matches_jax(rng, jparams, net, which):
    x = rng.random((2, 64, 96, 3)).astype(np.float32)
    out_dim, norm = (128, "instance") if which == "fnet" else (256, "none")
    expect = jdn.BasicEncoder(out_dim, norm).apply(
        {"params": jparams[which]}, jnp.asarray(x))
    got = getattr(net, which)(_t(x), torch.float32)
    # 14 conv layers deep, fp32 with reordered sums
    _close(got, expect, 1e-4, which)


def test_encoder_bf16_matches_jax(rng, jparams, net):
    """The motion filter's encoders run in bf16 in both packages; each
    conv's output is rounded to bf16 (8 bits of mantissa) in another
    place, so the tolerance is a few bf16 steps of the output's range."""
    x = rng.random((1, 64, 96, 3)).astype(np.float32)
    expect = jdn.BasicEncoder(128, "instance", jnp.bfloat16).apply(
        {"params": jparams["fnet"]}, jnp.asarray(x))
    got = net.fnet(_t(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, expect.astype(jnp.float32), 5e-2, "fnet bf16")


def test_conv_gru_matches_jax(rng, jparams, net):
    h = np.tanh(rng.standard_normal((3, 8, 12, 128))).astype(np.float32)
    inp = rng.standard_normal((3, 8, 12, 320)).astype(np.float32)
    expect = jdn.ConvGRU(128).apply(
        {"params": jparams["update"]["gru"]}, jnp.asarray(h),
        jnp.asarray(inp))
    got = net.update.gru(_t(h).permute(0, 3, 1, 2),
                         _t(inp).permute(0, 3, 1, 2), torch.float32)
    _close(got.permute(0, 2, 3, 1), expect, 1e-5)


@pytest.mark.parametrize("with_agg", [False, True])
def test_update_module_matches_jax(rng, jparams, net, with_agg):
    """UpdateModule with 196 correlation channels; with_agg adds GraphAgg
    (edge features, segment mean over source frames with an invalid
    edge, fp32 frame head)."""
    E, P = 5, 4
    h = np.tanh(rng.standard_normal((E, 8, 12, 128))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((E, 8, 12, 128)), 0).astype(
        np.float32)
    corr = rng.standard_normal((E, 8, 12, 196)).astype(np.float32)
    flow = rng.standard_normal((E, 8, 12, 4)).astype(np.float32)
    ii = np.array([0, 0, 2, 3, 3], np.int64)
    valid = np.array([True, True, True, False, True])
    jargs = [jnp.asarray(a) for a in (h, inp, corr, flow)]
    targs = [_t(a) for a in (h, inp, corr, flow)]
    if with_agg:
        expect = jdn.UpdateModule(num_frames=P).apply(
            {"params": jparams["update"]}, *jargs,
            jnp.asarray(ii, jnp.int32), jnp.asarray(valid))
        got = net.update(*targs, dtype=torch.float32, ii=_t(ii),
                         edge_valid=_t(valid), num_frames=P)
        names = ["net", "delta", "weight", "eta", "upmask"]
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(expect[5]))
        assert got[5].tolist() == [True, False, True, True]
    else:
        expect = jdn.UpdateModule().apply({"params": jparams["update"]},
                                          *jargs)
        got = net.update(*targs, dtype=torch.float32)
        names = ["net", "delta", "weight"]
    for name, g, e in zip(names, got, expect):
        _close(g, e, 1e-5, name)


def test_upsample_disp_matches_jax(rng):
    disp = rng.random((2, 4, 6)).astype(np.float32)
    mask = rng.standard_normal((2, 4, 6, 576)).astype(np.float32)
    got = droidnet.upsample_disp(_t(disp), _t(mask))
    expect = jdn.upsample_disp(jnp.asarray(disp), jnp.asarray(mask))
    assert got.shape == (2, 32, 48)
    _close(got, expect, 1e-6)
