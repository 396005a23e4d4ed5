"""The port's package boundary and its device contract.

``src/repro_torch/`` (``core/timing.py`` and ``core/baselines.py``
included), ``chip_smoke.py``, ``benchmarks_torch/`` and
``examples_torch/`` import neither jax nor any
module of the JAX package ``repro`` (numpy-only ones included: importing
``repro.core`` pulls jax in).  The entry points run on the card and raise,
rather than carry on on the CPU, when no GPU is present and the caller did
not ask for ``device="cpu"``.
"""
import ast
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    p for d in ("src/repro_torch", "benchmarks_torch", "examples_torch")
    for p in (ROOT / d).rglob("*.py")
) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args and isinstance(node.args[0], ast.Constant)
        ):
            names.add(str(node.args[0].value))
    return names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_imports_neither_jax_nor_repro(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


BENCH_MODULES = sorted(
    f"benchmarks_torch.{p.stem}" for p in (ROOT / "benchmarks_torch").glob(
        "*.py")
)


def test_port_import_loads_no_jax(tmp_path):
    """Importing the port's packages, its timing and baselines, and every
    module of ``benchmarks_torch`` loads neither jax nor ``repro``."""
    import subprocess

    mods = [
        "repro_torch.launch.serve", "repro_torch.vortex",
        "repro_torch.kernels", "repro_torch.launch.scheduler",
        "repro_torch.core.timing", "repro_torch.core.baselines",
    ] + BENCH_MODULES
    code = (
        f"import sys, importlib; [importlib.import_module(m) for m in "
        f"{mods!r}]; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, env={
            "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
        },
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "benchmarks_torch.run" in BENCH_MODULES
    assert "benchmarks_torch.bench_workloads" in BENCH_MODULES


def test_bench_runner_raises_without_gpu(no_gpu):
    """The benches run on the card by default: with no GPU they raise
    before measuring anything, rather than carry on on the CPU."""
    from benchmarks_torch.bench_workloads import serving_payload

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving_payload(True)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_config_raises_without_gpu(no_gpu):
    from repro_torch.vortex import Engine, EngineConfig

    with pytest.raises(RuntimeError, match="device='cpu'"):
        EngineConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine()
    cfg = EngineConfig(device="cpu")
    assert (cfg.device, cfg.impl, cfg.hardware) == ("cpu", "torch", "h100_sxm")


@pytest.mark.parametrize("arch", ["paper-gpt2-124m", "granite-moe-1b-a400m"])
def test_server_raises_without_gpu(no_gpu, arch):
    from repro_torch.launch.serve import VortexServer
    from repro_torch.models.registry import get_smoke_config

    smoke = get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VortexServer(smoke)
    server = VortexServer(smoke, device="cpu", max_cache=64)
    assert server.device.type == "cpu"
    assert server.engine.config.impl == "torch"


def test_wallclock_profiler_defaults_to_the_card(no_gpu):
    from repro_torch.core import WallClockProfiler

    with pytest.raises(RuntimeError, match="device='cpu'"):
        WallClockProfiler()
    prof = WallClockProfiler(device="cpu", repeats=1)
    assert prof.measure_l0((4, 4, 4), "simd") > 0


def test_serve_main_raises_without_gpu(no_gpu, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main()


def test_kernel_wrappers_take_cuda_tensors_or_cpu_only():
    from repro_torch.kernels.gemm import vortex_gemm
    from repro_torch.kernels.grouped_gemm import vortex_grouped_gemm

    a = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        vortex_gemm(a.to("meta"), a.to("meta"), block_m=4, block_n=4, block_k=4)
    x = torch.zeros(2, 4, 4, device="meta")
    with pytest.raises(ValueError):
        vortex_grouped_gemm(x, x, [4, 4], block_m=4, block_n=4, block_k=4)
