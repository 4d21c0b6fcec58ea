"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, its configs are the reference's, its entry points refuse to run
without a GPU unless asked for the CPU, and chip_smoke.py fails (with no
result line) where there is no GPU or no repository beside it."""
import ast
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config        # noqa: E402
from repro.configs import get_smoke_config as jax_smoke       # noqa: E402
from repro_torch import configs, resolve_device               # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, (path, bad)


def test_ported_config_is_the_reference_config():
    for get_t, get_j in ((configs.get_config, jax_get_config),
                         (configs.get_smoke_config, jax_smoke)):
        assert dataclasses.asdict(get_t("starcoder2_3b")) == \
            dataclasses.asdict(get_j("starcoder2_3b"))
    cfg = configs.get_config("starcoder2_3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.padded_vocab) == \
        (30, 3072, 24, 2, 128, 12288, 49152)


def test_every_reference_arch_is_ported():
    assert set(configs.PORTED) == set(configs.ARCH_IDS)
    assert not configs._ROADMAP_ITEM
    for arch in configs.ARCH_IDS:
        assert configs.get_smoke_config(arch).arch_id == f"{arch}_smoke"


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real there")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Without the repository beside it the script has nothing to run."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
