"""The import rule: no file of the benchmark imports JAX or the JAX
package, compared by whole top-level names, and the reference imports
nothing of the program."""
from __future__ import annotations

import ast
import os
import sys

import pytest

import run
from harness import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "goslam_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    top = os.path.join(cells.HERE, sub)
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_files()))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files("reference")))
def test_the_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & {"goslam_tpu_torch", "harness"}


def test_the_runtime_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "goslam_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "goslam_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["goslam_tpu.ops", "jax"]
