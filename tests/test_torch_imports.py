"""Import guard: the PyTorch port stands alone.

No module of ``distributed_llm_scheduler_tpu_torch`` (nor ``chip_smoke.py``,
which drives it on the GPU) may import ``jax`` or the JAX package
``distributed_llm_scheduler_tpu``.  Names are compared exactly: the port's
own name starts with the JAX package's, so a prefix test would be wrong
both ways.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "distributed_llm_scheduler_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "distributed_llm_scheduler_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def top_level_imports(path: Path):
    """Top-level module names of every absolute import in ``path``."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_guard_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text(
        "import distributed_llm_scheduler_tpu_torch.ops\n"
        "from distributed_llm_scheduler_tpu.core import graph\n"
    )
    assert top_level_imports(f) == {
        "distributed_llm_scheduler_tpu_torch", "distributed_llm_scheduler_tpu"
    }


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import distributed_llm_scheduler_tpu_torch\n"
        "import distributed_llm_scheduler_tpu_torch.utils.costmodel\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'distributed_llm_scheduler_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
