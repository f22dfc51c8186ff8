"""The port's boundary: no JAX, nothing of the JAX package, no silent CPU.

The card's machine has no JAX, so `repro_torch` and `chip_smoke.py` must
import neither `jax` nor anything under `repro.`; and its entry points
run on CUDA unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_model_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.models.model, repro_torch.launch.serve, "
            "repro_torch.models.weights, repro_torch.launch.train, "
            "repro_torch.launch.equalize; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_modules_import_without_jax_cuda_or_build():
    """The contract checks and the block-VP and dequant wrappers import
    with JAX blocked and no card, and importing loads no kernel library
    (nvcc runs at the first launch, never at import)."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.analysis.bitwidth, "
            "repro_torch.analysis.contracts, "
            "repro_torch.kernels.vp_block_matmul, "
            "repro_torch.kernels.vp_dequant, repro_torch.kernels.ops; "
            "from repro_torch.kernels import block_vp_matmul, vp_dequant, "
            "build; print(len(build._LIBS), sorted(build.LAUNCHES))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Run alone, outside the repo and without a card, the script exits
    non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
