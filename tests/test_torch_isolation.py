"""parquet_tpu_torch and chip_smoke.py stand alone: neither imports JAX nor
anything of parquet_tpu."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "parquet_tpu")


def _port_files():
    pkg = os.path.join(ROOT, "parquet_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_in_source(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def _port_sources():
    """Every source of the port: its Python, its ``csrc/`` (kernels, host
    C++ and headers) and chip_smoke.py."""
    pkg = os.path.join(ROOT, "parquet_tpu_torch")
    for dirpath, dirs, names in os.walk(pkg):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for name in names:
            if name.endswith((".py", ".cpp", ".cu", ".cuh", ".h")):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_names_the_reference_native_shim(path):
    """The port keeps its own C++ and never loads or builds the JAX
    package's native library."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for name in ("parquet_tpu/native", "_native.so"):
        assert name not in text, f"{os.path.relpath(path, ROOT)} names {name}"


def test_import_loads_neither_jax_nor_parquet_tpu():
    code = (
        "import sys\n"
        "import parquet_tpu_torch\n"
        "import parquet_tpu_torch.parallel.device_reader\n"
        "import parquet_tpu_torch.parallel.host_scan\n"
        "import parquet_tpu_torch.io.planner\n"
        "import parquet_tpu_torch.algebra.expr\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert callable(chip_smoke.main)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA card the script exits non-zero and prints no result."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "import chip_smoke\n"
            "sys.exit(chip_smoke.main([]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _reference_exports():
    """``(module, name)`` of each name the JAX package's ``__init__``
    imports from one of its own modules."""
    path = os.path.join(ROOT, "parquet_tpu", "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1 \
                and node.module:
            for alias in node.names:
                yield node.module, alias.name


def test_exports_follow_the_reference():
    """Every name the JAX package exports from a module the port has, and
    which that module of the port defines, is exported by the port too
    (the names of modules not yet ported are left out)."""
    import importlib

    import parquet_tpu_torch as pqt

    missing = []
    for module, name in _reference_exports():
        base = os.path.join(ROOT, "parquet_tpu_torch", *module.split("."))
        if not (os.path.exists(base + ".py")
                or os.path.exists(os.path.join(base, "__init__.py"))):
            continue
        mod = importlib.import_module(f"parquet_tpu_torch.{module}")
        if hasattr(mod, name) and not hasattr(pqt, name):
            missing.append(f"{module}.{name}")
    assert not missing, missing
    assert all(hasattr(pqt, n) for n in pqt.__all__)
    for name in ("Expr", "col", "And", "Or", "Not", "ScanPlanner",
                 "ScanPlan", "ParquetWriter", "ColumnData", "schema_of",
                 "Schema", "KeyHits", "LookupResult", "MmapSource",
                 "RowGroupReader", "CorruptedError", "read_row_range",
                 "pages_overlapping", "find", "clear_caches", "cache_stats",
                 "CacheStats"):
        assert name in pqt.__all__, name
