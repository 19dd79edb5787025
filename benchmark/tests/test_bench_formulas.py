"""The frozen FLOP and byte formulas against torch's FLOP counter on the
port's DroidNet and against the tensors' own sizes."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import formulas


@pytest.fixture(scope="module")
def droidnet():
    from goslam_tpu_torch.models.droidnet import init_droidnet
    return init_droidnet(0).eval()


def _count(fn) -> int:
    with FlopCounterMode(display=False) as m, torch.no_grad():
        fn()
    return m.get_total_flops()


@pytest.mark.parametrize("b,h,w", [(1, 32, 48), (2, 40, 56), (1, 37, 61)])
def test_encoder_flops(droidnet, b, h, w):
    x = torch.rand(b, h, w, 3)
    assert _count(lambda: droidnet.fnet(x)) == \
        formulas.encoder_flops(b, h, w, 128)
    assert _count(lambda: droidnet.cnet(x)) == \
        formulas.encoder_flops(b, h, w, 256)


@pytest.mark.parametrize("e,h,w", [(1, 4, 6), (3, 5, 7)])
def test_update_and_graphagg_flops(droidnet, e, h, w):
    net = torch.rand(e, h, w, 128)
    inp = torch.rand(e, h, w, 128)
    corr = torch.rand(e, h, w, 196)
    flow = torch.rand(e, h, w, 4)
    u = droidnet.update
    assert _count(lambda: u(net, inp, corr, flow)) == \
        formulas.update_flops(e, h, w)
    assert _count(lambda: u.agg.edge_features(net, torch.float32)) == \
        formulas.edge_features_flops(e, h, w)
    for up in (True, False):
        assert _count(lambda: u.agg.frame_head(net, up)) == \
            formulas.frame_head_flops(e, h, w, up)
    # with ii the update operator also runs GraphAgg: both parts count
    ii = torch.arange(e) % 2
    valid = torch.ones(e, dtype=torch.bool)
    assert _count(lambda: u(net, inp, corr, flow, ii=ii, edge_valid=valid,
                            num_frames=2)) == \
        formulas.update_flops(e, h, w) \
        + formulas.edge_features_flops(e, h, w) \
        + formulas.frame_head_flops(2, h, w, True)


def test_edge_system_bytes_are_the_tensors_read_and_written():
    """Every edge valid, every frame a source: the formula's bytes are
    the sizes of the kernel's inputs and outputs, each once."""
    P, E, ht, wd = 4, 8, 3, 5
    hw = ht * wd
    ii = torch.arange(E) % P
    jj = (ii + 1) % P
    ins = [torch.zeros(P, hw), torch.zeros(E, ht, wd, 2),
           torch.zeros(E, ht, wd, 2), torch.zeros(P, 7), ii, jj,
           torch.ones(E, dtype=torch.bool), torch.zeros(4)]
    outs = [torch.zeros(E, 12, 12), torch.zeros(E, 12),
            torch.zeros(E, 6, hw), torch.zeros(E, 6, hw),
            torch.zeros(E, hw), torch.zeros(E, hw)]
    nbytes, flop = formulas.edge_system_work(P, P, E, E, hw)
    assert nbytes == sum(t.nbytes for t in ins + outs)
    assert flop == E * hw * formulas.K1_FLOP_PER_PX
    # invalid slots read no target or weight; their outputs are written
    nb2, flop2 = formulas.edge_system_work(P, P, E, E - 2, hw)
    assert nbytes - nb2 == 2 * 2 * hw * 2 * 4
    assert flop2 == (E - 2) * hw * formulas.K1_FLOP_PER_PX


def test_alt_corr_bytes_are_the_tensors_read_and_written():
    E, h, w, L = 3, 8, 12, 4
    levels = [torch.zeros(5, h // 2 ** l, w // 2 ** l, 128,
                          dtype=torch.bfloat16) for l in range(L)]
    coords = torch.zeros(E, h, w, 2)
    ii32, jj32 = torch.zeros(E, dtype=torch.int32), torch.ones(
        E, dtype=torch.int32)
    out = torch.zeros(E, h, w, L * 49)
    map_bytes = sum(lv.nbytes for lv in levels)
    nbytes, f16, f32 = formulas.alt_corr_work(map_bytes, E, h * w, L, 100)
    assert nbytes == map_bytes + coords.nbytes + ii32.nbytes + jj32.nbytes \
        + out.nbytes
    assert f16 == 100 * 128 * 2
    assert f32 == E * h * w * L * 49 * formulas.K2_FLOP_PER_CH
