"""Runs the JAX package's side of a parity test in a process of its own.

The JAX package's CPU results depend on what its process ran before: the
same tracking run ends millimetres elsewhere after other test files'
JAX work in the same pytest worker (the port's result does not move),
and the parity trajectories amplify that.  A fresh process gives the
oracle the result of a run alone, whatever the order the suite's workers
take the files in.

    run("test_torch_slice", out)

imports the test module in a new interpreter, calls its
``_jax_main(out)`` (with the test suite's JAX settings) and returns the
dict it returned, passed back through ``out/jax_run.pkl``.
"""
import os
import pickle
import subprocess
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


def run(module: str, out: str, timeout: int = 900) -> dict:
    res = subprocess.run(
        [sys.executable, "-c", "import jax_subprocess as h; "
         f"h.main({module!r}, {out!r})"], cwd=TESTS, capture_output=True,
        text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, TESTS])))
    assert res.returncode == 0, res.stderr[-3000:]
    with open(os.path.join(out, "jax_run.pkl"), "rb") as f:
        return pickle.load(f)


def main(module: str, out: str):
    import importlib

    import jax
    import numpy as np

    # tests/conftest.py's setting for the JAX package
    jax.config.update("jax_default_matmul_precision", "highest")
    state = importlib.import_module(module)._jax_main(out)
    state = jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, state)
    with open(os.path.join(out, "jax_run.pkl"), "wb") as f:
        pickle.dump(state, f)
