"""PyTorch port, import hygiene: the port stands alone.

``src/repro_torch/**`` and ``chip_smoke.py`` import neither JAX nor anything
of the JAX package ``repro`` (the port keeps its own copies of what it
needs); the whole package imports in a process where ``jax`` and ``repro``
cannot be imported; and an entry point asked for no device raises when
there is no GPU instead of quietly running on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "repro"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and _forbidden(node.module or ""):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_package_imports_with_jax_and_reference_blocked():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro', 'triton'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k in sys.modules if sys.modules[k])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousEngine, ServingEngine
    cfg = ModelConfig(num_layers=1, d_model=64, num_heads=2, num_kv_heads=1,
                      d_ff=128, vocab_size=64)
    model = T.init(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ContinuousEngine(cfg, model, num_blocks=4)
    with pytest.raises(RuntimeError):
        ServingEngine(cfg, model)
    with pytest.raises(RuntimeError):
        T.init(cfg)
    with pytest.raises(RuntimeError):
        T.init_paged_cache(cfg, 4, 8)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import train
    with pytest.raises(RuntimeError):
        train(cfg, TrainConfig(total_steps=1))
    # asked for, the CPU is used
    ContinuousEngine(cfg, model, num_blocks=4, block_size=8, device="cpu")


def test_serving_exports_the_reference_names():
    """``repro_torch.serving`` exports what ``repro.serving`` does, apart
    from ``bind_dp_router`` (it binds ``async_rl.router``, not ported yet);
    ``repro_torch.async_rl`` exports the heartbeat monitor."""
    import repro.serving as ref
    import repro_torch.async_rl as port_rl
    import repro_torch.serving as port
    names = {n for n in vars(ref) if not n.startswith("_")
             and not isinstance(getattr(ref, n), type(ast))}
    missing = sorted(names - {"bind_dp_router"} - set(vars(port)))
    assert not missing, missing
    assert port_rl.HeartbeatMonitor.__module__ == \
        "repro_torch.async_rl.heartbeat"
