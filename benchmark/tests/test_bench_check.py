"""The check that decides ``correct``, driven through a whole run of a
cell at a tiny size on the CPU (the harness's look for a chip skipped):
a sound run passes, the control (the reference in fp8 in the program's
place) fails, and so does a run whose timed path is broken underneath."""
from __future__ import annotations

import pytest
import torch

import run
from harness import cells

# 64x96 frames, a small buffer, a filter threshold that admits keyframes
# at that size: every layer the check covers runs within seconds
TINY = {"cam": {"H_out": 64, "W_out": 96},
        "tracking": {"buffer": 96, "warmup": 6,
                     "motion_filter": {"thresh": 0.5}},
        "only_tracking": True}
# with the mapper on, at 256 rays over a window of 4 keyframes
TINY_MAP = dict(TINY, only_tracking=False,
                mapping={"pixels": 256, "iters": 1,
                         "mapping_window_size": 4})
SECONDS = 10
SEED = 2 ** 31 + 77


def _spec(workload="replica-rgbd.scan"):
    spec = cells.find(cells.load_benchmark(), workload)
    spec["traffic"] = dict(spec["traffic"], warmup_frames=30)
    return spec


def _run(overrides=TINY, seconds=SECONDS, **kw):
    return run.run_cell(_spec(), SEED, seconds, False, device="cpu",
                        overrides=overrides, **kw)


@pytest.fixture(scope="module")
def sound():
    return _run(TINY_MAP, 30, control=True)


def test_a_sound_run_is_correct_and_checks_every_layer(sound):
    assert sound["correct"], sound["numbers"]
    assert set(sound["numbers"]) == {"motion_filter", "update", "dba",
                                     "global_ba", "map_step"}


def test_the_control_fails(sound):
    limits = {k: n["limit"] for k, n in sound["numbers"].items()}
    assert any(sound["control"][k] > limits[k] for k in limits), \
        (sound["control"], limits)


def _no_op(self, *a, **k):
    return None


def _half_the_edges(orig):
    def step(self, *a, **k):
        keep = self.valid.copy()
        on = keep.nonzero()[0]
        self.valid[on[::2]] = False
        try:
            return orig(self, *a, **k)
        finally:
            self.valid[:] = keep
    return step


def _altered_flow(orig):
    def fwd(self, *a, **k):
        out = orig(self, *a, **k)
        return (out[0], out[1] + 0.25) + tuple(out[2:])
    return fwd


def _dba_unchanged(poses, disps, *a, **k):
    return poses.clone(), disps.clone()


def test_a_map_step_that_leaves_its_state_unchanged_is_not_correct(
        monkeypatch):
    from goslam_tpu_torch.mapping import mapper
    monkeypatch.setattr(mapper, "_step", lambda opt, params, grads: None)
    res = _run(TINY_MAP, 30)
    assert "map_step" in res["numbers"]
    assert not res["correct"], res["numbers"]


@pytest.mark.parametrize("fault", ["update_unchanged", "global_ba_unchanged",
                                   "dba_unchanged", "half_the_edges",
                                   "flow_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    from goslam_tpu_torch.models.droidnet import UpdateModule
    from goslam_tpu_torch.tracking import factor_graph
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph
    if fault == "dba_unchanged":
        # the DBA returns the poses and disparities it was given: the
        # flow and weights stay right, so the dba number has to see it
        monkeypatch.setattr(factor_graph.dba, "ba", _dba_unchanged)
    elif fault == "update_unchanged":
        monkeypatch.setattr(FactorGraph, "update", _no_op)
    elif fault == "global_ba_unchanged":
        monkeypatch.setattr(FactorGraph, "update_lowmem", _no_op)
    elif fault == "half_the_edges":
        monkeypatch.setattr(FactorGraph, "update",
                            _half_the_edges(FactorGraph.update))
    else:
        monkeypatch.setattr(UpdateModule, "forward",
                            _altered_flow(UpdateModule.forward))
    res = _run()
    assert not res["correct"], res["numbers"]
    if fault == "dba_unchanged":
        n = res["numbers"]["dba"]
        assert n["value"] > n["limit"], res["numbers"]


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    res = run.run_cell(_spec("euroc-stereo.fast"), SEED, 5, True)
    assert res["correct"], res["numbers"]
    assert res["busy_s"] > 0
