"""The PyTorch port stands alone: it imports without JAX and without the
JAX package, its entry points refuse to fall back to the CPU on their own,
and its kernel wrappers refuse tensors they cannot launch on."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module of both slices


def test_training_imports_with_jax_and_repro_blocked():
    """The training package and the example that drives it, imported in a
    process where ``import jax`` and ``import repro`` fail."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.training as t\n"
        "from repro_torch.examples import train_lm\n"
        "print(sorted(t.__all__))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(sorted([
        "latest_step", "restore", "save", "DataConfig", "batch_for_step",
        "OptConfig", "apply_updates", "init_opt_state", "make_train_step",
        "sharding_trees", "train"]))


def test_sharding_and_launch_import_with_jax_and_repro_blocked():
    """The mesh, the sharded paths and the launchers, imported in a process
    where ``import jax`` and ``import repro`` fail."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.models import sharding\n"
        "from repro_torch.launch import mesh, specs, serve, train, ranks\n"
        "print(sharding.P(('data',), None))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "P('data', None)"


def test_cost_tools_import_with_jax_and_repro_blocked():
    """The dry run, the cost accounting, the roofline and the report,
    imported in a process where ``import jax`` and ``import repro`` fail:
    importing them sets no environment variable (the reference's dry run
    sets ``XLA_FLAGS``), starts no process group and touches no device."""
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "env = dict(os.environ)\n"
        "from repro_torch.launch import dryrun, hlo_cost, report, roofline\n"
        "import torch\n"
        "assert dict(os.environ) == env\n"
        "assert not torch.distributed.is_initialized()\n"
        "assert not torch.cuda.is_initialized()\n"
        "print(roofline.PEAK_FLOPS, dryrun.count_cell.__name__,\n"
        "      hlo_cost.count.__name__, report.summary.__name__)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["989000000000000.0", "count_cell",
                                  "count", "summary"]


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & FORBIDDEN_ROOTS


def test_generate_without_a_card_raises(monkeypatch):
    from repro_torch.sql import generate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(0.01, 2, 0)
    cat = generate(0.01, 2, 0, device="cpu")
    assert all(t.valid.device.type == "cpu" for t in cat.tables.values())


def test_from_numpy_without_a_card_raises(monkeypatch):
    import numpy as np

    from repro_torch.joins import from_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        from_numpy({"k": np.arange(4)})


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor launchable raises; only a
    CPU tensor takes the plain version."""
    from repro_torch.kernels.bitonic_sort import bitonic_sort_tile
    from repro_torch.kernels.bloom import bloom_build, bloom_probe
    from repro_torch.kernels.move_rows import move_rows
    from repro_torch.kernels.partition_hist import partition_hist
    from repro_torch.kernels.tiled_probe import tiled_probe, tiled_probe3
    from repro_torch.kernels.zone_map import key_range
    meta = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        partition_hist(meta[0], nd=4)
    with pytest.raises(ValueError, match="expected cuda"):
        tiled_probe(meta, meta)
    with pytest.raises(ValueError, match="expected cuda"):
        bitonic_sort_tile(meta, meta)
    with pytest.raises(ValueError, match="expected cuda"):
        bloom_build(meta, m_bits=64, k=2)
    with pytest.raises(ValueError, match="expected cuda"):
        bloom_probe(meta, meta[0], k=2)
    with pytest.raises(ValueError, match="expected cuda"):
        key_range(meta)
    with pytest.raises(ValueError, match="expected cuda"):
        tiled_probe3(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="expected cuda"):
        move_rows({"a": meta}, meta)


def test_kernel_sources_export_every_declared_entry_point():
    from repro_torch.kernels import build
    names = {s.name for s in build.sources()}
    assert names == {"partition_hist.cu", "tiled_probe.cu",
                     "bitonic_sort.cu", "bloom.cu", "zone_map.cu",
                     "tiled_probe3.cu", "move_rows.cu"}
    text = "".join(s.read_text() for s in build.sources())
    for entry in (*build.SIGNATURES, "repro_error_string"):
        assert f" {entry}(" in text
    # The cache key follows the sources and the flags.
    assert build.source_hash() == build.source_hash()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
