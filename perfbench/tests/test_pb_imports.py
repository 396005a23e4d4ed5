"""Nothing perfbench imports is JAX or the JAX package, by whole
top-level name (the port, ``repro_torch``, is allowed), and the
reference imports nothing of the program."""
import os
import subprocess
import sys

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)

PROBE = r"""
import importlib.util, os, sys
pb, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [pb, os.path.join(root, "src")]
only_reference = sys.argv[3] == "reference"
mods = ["reference.decoder", "reference.matmul", "reference.hybrid"]
if not only_reference:
    mods += ["kit.traffic", "kit.layout", "kit.counts", "kit.weights",
             "kit.stats", "kit.trace", "kit.spec", "kit.judge",
             "kit.program_trace", "kit.serving", "kit.gemm_stream",
             "kit.runner"]
for m in mods:
    importlib.import_module(m)
if not only_reference:
    from kit import spec
    for f in sorted(os.listdir(os.path.join(pb, "metrics"))):
        if f.endswith(".py"):
            spec.reader(f[:-3])
    spec_ = importlib.util.spec_from_file_location(
        "pbrun", os.path.join(pb, "run.py"))
    spec_.loader.exec_module(importlib.util.module_from_spec(spec_))
    # What a run imports of the program.
    import repro_torch.launch.scheduler, repro_torch.launch.serve  # noqa
    import repro_torch.vortex  # noqa
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _tops(which):
    out = subprocess.run([sys.executable, "-c", PROBE, PB, ROOT, which],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_no_jax_and_no_jax_package():
    tops = _tops("all")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    tops = _tops("reference")
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                       "kit"}


def test_whole_name_check():
    sys.path.insert(0, PB)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "pbrun_check", os.path.join(PB, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = dict(sys.modules)
    try:
        for m in [k for k in sys.modules if k.split(".")[0] in mod.FORBIDDEN]:
            del sys.modules[m]
        sys.modules["repro_torch_probe"] = object()
        assert mod.loaded_forbidden() == []
        sys.modules["repro.something"] = object()
        assert mod.loaded_forbidden() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
