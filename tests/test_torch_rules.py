"""Rules of the PyTorch port that hold whatever the numbers say.

  * Import rule: ``goslam_tpu_torch``, every one of its modules and
    ``chip_smoke.py`` import neither JAX nor anything of ``goslam_tpu``.
  * Device rule: the entry points (the system, ``run`` and the trainer)
    run on the GPU unless the caller asks for the CPU, and raise when no
    GPU is visible and none was asked for.
  * The command-line entry point runs end to end on the CPU when asked
    to, and writes the trajectory files (and, with mapping, the meshes
    and their metrics).
  * A failure in global BA or in a mapping round propagates.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import goslam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(goslam_tpu_torch.__path__,
                                               "goslam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "goslam_tpu"))
print(json.dumps({"modules": names, "foreign": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_goslam_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # the package has some forty modules; all of them were imported,
    # the sharded paths, the viewer and the tools among them
    assert len(res["modules"]) >= 40
    assert {"goslam_tpu_torch.parallel",
            "goslam_tpu_torch.parallel.sharded_ba",
            "goslam_tpu_torch.parallel.sharded_mapping",
            "goslam_tpu_torch.tools.meshvideo",
            "goslam_tpu_torch.utils.visualization",
            "goslam_tpu_torch.utils.logger"} <= set(res["modules"])
    assert res["foreign"] == []


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg():
    from goslam_tpu_torch.config import default_config, update_recursive
    return update_recursive(default_config(), {
        "dataset": "synthetic", "mode": "rgbd", "only_tracking": True,
        "cam": {"H_out": 64, "W_out": 96},
        "tracking": {"buffer": 8, "frontend": {"enable_loop": False}}})


def test_slam_system_needs_a_gpu_unless_asked_for_the_cpu(no_gpu, tmp_path):
    from goslam_tpu_torch.system import SLAMSystem, resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SLAMSystem(_cfg(), output=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SLAMSystem(_cfg(), output=str(tmp_path), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    slam = SLAMSystem(_cfg(), output=str(tmp_path), device="cpu")
    assert slam.video.poses.device.type == "cpu"


def test_run_entry_point_needs_a_gpu_unless_asked(no_gpu, tmp_path):
    from goslam_tpu_torch import run
    cfg = os.path.join(ROOT, "configs", "Demo", "synthetic.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([cfg, "--only_tracking", "--output", str(tmp_path),
                  "--max_frames", "2"])


def test_train_entry_point_needs_a_gpu_unless_asked(no_gpu, tmp_path):
    from goslam_tpu_torch.train import __main__ as train_main
    from goslam_tpu_torch.train import trainer
    out = str(tmp_path / "droid.ckpt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(["--steps", "1", "--scenes", "1", "--out", out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.fit(trainer.TrainConfig(steps=1, n_scenes=1), out)
    assert not os.path.exists(out)


@pytest.mark.parametrize("device,gpus,multichip,size", [
    ("cuda", 4, True, 4), ("cuda", 1, True, None), ("cuda", 4, False, None),
    ("cpu", 4, True, None)])
def test_default_mesh_is_the_jax_packages(device, gpus, multichip, size,
                                          monkeypatch):
    """A system given no mesh builds one where the JAX package does: on
    the GPU, with more than one visible and multichip on, over every GPU;
    on one GPU, with multichip off, or on the CPU, none."""
    from goslam_tpu_torch.system import default_mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    mesh = default_mesh(torch.device(device), {"multichip": multichip})
    if size is None:
        assert mesh is None
    else:
        assert mesh.devices == [torch.device("cuda", i) for i in range(size)]


@pytest.mark.parametrize("what", ["make_video", "viz", "mesh"])
def test_former_unported_paths_build_a_system(what, tmp_path):
    """The mesh video, the live viewer and a sharded system (the paths a
    system refused before they were ported) build on the CPU."""
    from goslam_tpu_torch.parallel import ShardMesh
    from goslam_tpu_torch.system import SLAMSystem
    cfg, mesh = _cfg(), None
    cfg["only_tracking"] = False
    if what == "mesh":
        mesh = ShardMesh(["cpu"] * 2)
    else:
        cfg[what] = True
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu", mesh=mesh)
    assert slam.make_video == (what == "make_video")
    assert (slam.viewer is not None) == (what == "viz")
    sharded = what == "mesh"
    assert (slam.backend.mesh is mesh) and (slam.mapper.mesh is mesh)
    assert (slam.mapper.sharded_step is not None) == sharded


def test_loop_closing_config_builds_a_system(tmp_path):
    """``enable_loop: True`` is the default of the configuration: the
    frontend gets the backend as its loop closer."""
    from goslam_tpu_torch.config import default_config
    from goslam_tpu_torch.system import SLAMSystem
    assert default_config()["tracking"]["frontend"]["enable_loop"] is True
    cfg = _cfg()
    cfg["tracking"]["frontend"]["enable_loop"] = True
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    assert slam.frontend.enable_loop
    assert slam.frontend.loop_closing is slam.backend
    assert slam.frontend.last_loop_t == -1
    assert slam.backend.total_loop_accepts == 0


def test_global_ba_failure_propagates(tmp_path):
    """The JAX package's SLAMSystem._safe logs and swallows any exception
    from global BA, and tracking carries on; the port lets it through."""
    from goslam_tpu_torch.system import SLAMSystem
    cfg = _cfg()
    cfg["tracking"]["global_ba_every"] = 1
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    slam.motion_filter.track = lambda *a: True
    slam.frontend = lambda: None
    slam.frontend.is_initialized = True

    def broken(*a, **k):
        raise FloatingPointError("global BA failed")

    slam.backend.dense_ba = broken
    with pytest.raises(FloatingPointError, match="global BA failed"):
        slam._drain_one(0.0, None, None, None, None)


def test_mapping_failure_propagates(tmp_path):
    """The JAX package's _safe also swallows a failed mapping round; the
    port lets it through, out of track's per-frame step."""
    from goslam_tpu_torch.system import SLAMSystem
    cfg = _cfg()
    cfg["only_tracking"] = False
    cfg["mapping"]["mapping_every"] = 1
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    slam.motion_filter.track = lambda *a: True
    slam.frontend = lambda: None
    slam.frontend.is_initialized = True
    slam.multiview_filter = lambda: True

    def broken(*a, **k):
        raise FloatingPointError("mapping failed")

    slam.mapper = broken
    with pytest.raises(FloatingPointError, match="mapping failed"):
        slam._drain_one(0.0, None, None, None, None)


def test_run_entry_point_maps_on_the_cpu(tmp_path):
    """python -m goslam_tpu_torch.run without --only_tracking: the demo
    config at 64x96, 14 frames, with the mapping load cut for the CPU
    (a config inheriting from the demo's: 256 rays, 8 + 8 samples, one
    final round of one iteration, meshing at resolution 32).  It tracks,
    maps, meshes and evaluates against the room's GT mesh."""
    demo = os.path.join(ROOT, "configs", "Demo", "synthetic.yaml")
    cfg = tmp_path / "cut.yaml"
    cfg.write_text(
        f"inherit_from: {demo}\n"
        "mapping: {pixels: 256, iters: 1, post_processing_iters: 1}\n"
        "rendering: {N_samples: 8, N_surface: 8}\n"
        "meshing: {resolution: 32, n_points_to_eval: 20000}\n")
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "goslam_tpu_torch.run", str(cfg),
         "--device", "cpu", "--output", str(out), "--max_frames", "14",
         "--image_size", "64", "96"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    for f in ("metrics_traj.txt", "metrics_mesh.txt", "mesh/final_raw.ply",
              "mesh/cull_mesh.ply", "mesh/forecast_mesh.ply",
              "est_poses.npy", "go.ckpt"):
        assert (out / f).exists(), f
    with open(out / "metrics_mesh.txt") as f:
        mesh = json.load(f)
    assert all(np.isfinite(v) for v in mesh.values())
    assert 0 <= mesh["f_score"] <= 100


def test_run_entry_point_on_the_cpu(tmp_path):
    """python -m goslam_tpu_torch.run on the demo config, cut to 10
    frames at 64x96: it writes est_poses.npy (c2w of every frame) and
    metrics_traj.txt (ATE against the synthetic ground truth)."""
    cfg = os.path.join(ROOT, "configs", "Demo", "synthetic.yaml")
    out = subprocess.run(
        [sys.executable, "-m", "goslam_tpu_torch.run", cfg,
         "--only_tracking", "--device", "cpu", "--output", str(tmp_path),
         "--max_frames", "10", "--image_size", "64", "96"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        # two threads: the suite's other workers share the machine
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    est = np.load(tmp_path / "est_poses.npy")
    assert est.shape == (10, 4, 4) and np.isfinite(est).all()
    with open(tmp_path / "metrics_traj.txt") as f:
        ate = json.load(f)
    assert ate["n_poses"] == 10 and np.isfinite(ate["rmse"])
