"""Guards of the port: it imports neither JAX nor the JAX package, its
trainer runs on the CPU only when asked to, and the chip smoke script
refuses to run without a card."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="")


def test_launcher_cpu_run_prints_finite_losses():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "qwen3-1.7b-smoke", "--sync", "async", "--compressor",
         "topk", "--steps", "3", "--seq", "32", "--batch", "4",
         "--log-every", "1"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    losses = [float(line.split()[3]) for line in proc.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3
    assert all(l == l and abs(l) < 1e3 for l in losses), losses


def test_launcher_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1"])


def test_chip_smoke_refuses_without_a_card():
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=_env(), capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
