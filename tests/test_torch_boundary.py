"""Import boundary and device rules of the PyTorch port (``repro_torch``).

The port imports ``torch`` and numpy, never ``jax`` or anything of the
JAX package ``repro``; its entry points run on CUDA unless asked for the
CPU, and raise rather than drop to the CPU on their own.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PY_FILES = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _banned(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_all_submodules_loads_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("rel", PY_FILES)
def test_source_has_no_jax_or_repro_import(rel):
    tree = ast.parse((PKG / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_banned(n) for n in names), (rel, names)


def test_chip_smoke_imports_no_jax_or_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(_banned(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _banned(node.module or "")


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_entry_points_raise_without_cuda_and_device():
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.kvcache import PackedKVCache
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

    _needs_no_cuda()
    cfg = SMOLLM_135M.reduced(n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pack_tree(cfg, params, QuantSpec(bits=3, group_size=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        PackedKVCache.create(cfg, bits=3, page_tokens=4, n_slots=1,
                             max_seq=8)


def test_serve_cli_refuses_without_cuda():
    from repro_torch.launch import serve

    _needs_no_cuda()
    with pytest.raises(SystemExit, match="CUDA"):
        serve.main(["--arch", "smollm-135m", "--reduced", "--packed"])
    with pytest.raises(SystemExit, match="packed"):
        serve.main(["--arch", "smollm-135m", "--device", "cpu"])


def test_kernel_wrappers_never_fall_back():
    """Only CPU tensors take the plain version; any other device raises
    (here: ``meta`` tensors, which no plain path could compute on)."""
    from repro_torch.kernels.stream_matmul import stream_matmul
    from repro_torch.kvcache.stream_attention import stream_attention

    meta = torch.device("meta")
    x = torch.empty((2, 64), device=meta)
    words = torch.empty((100,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        stream_matmul(x, words, torch.empty((64, 8), dtype=torch.int32,
                                            device=meta),
                      torch.empty((2, 8), dtype=torch.int32, device=meta),
                      bits=3, group_size=32)
    q = torch.empty((1, 1, 2, 4), dtype=torch.bfloat16, device=meta)
    tab = torch.empty((4, 1, 4), dtype=torch.int32, device=meta)
    stab = torch.empty((4, 1), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        stream_attention(torch.empty((1, 10), dtype=torch.int32,
                                     device=meta),
                         torch.zeros((1,), dtype=torch.int64, device=meta),
                         q, torch.zeros((1,), dtype=torch.int64,
                                        device=meta),
                         tab, stab, tab, stab, bits=3)


def test_offset_tables_must_fit_int32():
    from repro_torch.kernels.ref import table_tensor

    ok = table_tensor(np.array([0, (1 << 31) - 1], np.uint32), "cpu")
    assert ok.dtype == torch.int32 and int(ok[1]) == (1 << 31) - 1
    with pytest.raises(ValueError, match="int32"):
        table_tensor(np.array([1 << 31], np.uint32), "cpu")
