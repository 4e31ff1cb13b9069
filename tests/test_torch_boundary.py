"""The port's import boundary and device rule: ``acav100m_torch``,
``chip_smoke`` and the distributed tests' rank helper load no
jax/flax/optax/acav100m_tpu module, and an entry
point left on its default device (cuda) raises when no CUDA device exists;
``acav100m_torch.data``, which spawned decode workers import, loads no
torch."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import acav100m_torch
names = [m.name for m in pkgutil.walk_packages(acav100m_torch.__path__, "acav100m_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import tests.torch_dist_workers
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "acav100m_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("acav100m_torch.pipeline.feature_extraction",
                "acav100m_torch.pipeline.clustering",
                "acav100m_torch.pipeline.subset_selection",
                "acav100m_torch.ops.kmeans_kernel",
                "acav100m_torch.ops.bottleneck_kernel", "acav100m_torch.cli",
                "acav100m_torch.runtime.mesh"):
        assert mod in res["modules"]


def test_data_imports_no_torch():
    probe = ("import importlib, json, pkgutil, sys\n"
             "import acav100m_torch.data as d\n"
             "for m in pkgutil.walk_packages(d.__path__, 'acav100m_torch.data.'):\n"
             "    importlib.import_module(m.name)\n"
             "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'torch')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("verb", ["extract", "cluster", "select"])
def test_default_device_raises_without_cuda(verb, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from acav100m_torch import cli

    key = "data.media.path" if verb == "extract" else "data.path"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([verb, f"{key}={tmp_path}/shard-000000.x",
                  f"data.output.path={tmp_path}/out"])


def test_resolve_device_cpu():
    from acav100m_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
