"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` may import JAX or the JAX package (``repro``), and every
package they import is one the GPU machine has: the standard library, torch,
numpy, scipy, einops, triton or the port itself (a stray ``import msgpack``
would pass every CPU test here and fail on the card)."""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
ALLOWED = frozenset(sys.stdlib_module_names) | {"torch", "numpy", "scipy", "einops", "triton", "repro_torch"}
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_rule_spares_the_port_itself():
    assert not _forbidden("repro_torch.core.lsp")
    assert _forbidden("repro.core.lsp") and _forbidden("jax.numpy") and _forbidden("jaxlib")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _allowed(module: str) -> bool:
    return module.split(".")[0] in ALLOWED


def test_allowlist_spares_the_stdlib_and_the_card_machines_packages():
    assert all(_allowed(m) for m in ("os.path", "concurrent.futures", "torch.cuda", "numpy", "triton.language",
                                     "repro_torch.serve", "struct", "__future__"))
    assert not any(_allowed(m) for m in ("msgpack", "jax", "repro.core", "zstandard", "ml_dtypes", "pytest"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_only_what_the_gpu_machine_has(path):
    bad = [m for m in _imported_modules(path) if not _allowed(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}, which the GPU machine does not have"
