"""The port stands alone: nothing in ``src/repro_torch``, ``chip_smoke.py``
or the example twins ``examples/torch_*.py`` imports JAX or the JAX
package."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("torch_*.py")))


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert path.exists()
    assert not _top_level_imports(path) & FORBIDDEN


def test_import_and_prefill_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        import torch
        from repro_torch.configs import get_config
        from repro_torch.models.model import make_model
        model = make_model(get_config("llama3.2-3b").reduced(), device="cpu")
        model.init_params(torch.Generator().manual_seed(0))
        logits, cache = model.prefill_step(torch.zeros(2, 8, dtype=torch.long))
        assert logits.shape == (2, 1, 256) and torch.isfinite(logits).all()
        model = make_model(get_config("mamba2-2.7b").reduced(), device="cpu")
        model.init_params(torch.Generator().manual_seed(0))
        logits, cache = model.prefill_step(torch.zeros(2, 12, dtype=torch.long))
        assert logits.shape == (2, 1, 256) and torch.isfinite(logits).all()
        assert cache["ssm"].shape == (2, 2, 8, 16, 16)
        assert not any(m.split(".")[0] in ("jax", "repro") and sys.modules[m] is not None
                       for m in sys.modules)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_import_and_schedule_with_jax_blocked():
    """The scheduler slice builds, matches and scans with no JAX."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        from repro_torch.core import Jobspec, Matcher, build_cluster
        g = build_cluster(nodes=16, device="cpu")
        js = Jobspec.hpc(nodes=2, sockets=4, cores=32)
        paths = Matcher(g, use_flat=True).match(js)
        assert paths is not None and len(paths) == 2 + 4 + 32
        g.set_allocated(paths, "job")
        mask = g.flat().feasible_roots_batch(js.resources)
        assert mask.shape == (1, len(g)) and mask.sum() == 16 - 2
        assert g.flat().verify_against(g)
        assert not any(m.split(".")[0] in ("jax", "repro") and sys.modules[m] is not None
                       for m in sys.modules)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_import_and_train_with_jax_blocked():
    """The training slice runs its loop, control plane included, with no JAX."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        import math
        from repro_torch.launch.train import run_training
        res = run_training("llama3.2-3b", steps=3, grow_at=1, fail_at=2, device="cpu")
        assert all(math.isfinite(l) for l in res["losses"])
        assert [e.kind for e in res["events"]].count("rebind") == 3
        assert not any(m.split(".")[0] in ("jax", "repro") and sys.modules[m] is not None
                       for m in sys.modules)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
