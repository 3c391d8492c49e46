"""No JAX and no JAX package: the check by whole top-level name, and, in a
fresh process, what the harness and the reference load."""

import subprocess
import sys

from benchmark.harness.modules import forbidden_loaded

from benchmark.harness.spec import ROOT


def test_whole_top_level_names():
    assert forbidden_loaded(["sanafe_tpu_torch", "sanafe_tpu_torch.ops",
                             "jaxtyping", "flax_like.x", "numpy"]) == []
    assert forbidden_loaded(["sanafe_tpu.chip", "jax", "jaxlib.xla",
                             "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                "sanafe_tpu"]


def loaded_after(code: str) -> set:
    script = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
              "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    """Every module under reference/: the LIF chip, the shared NoC sweep
    and whatever reference a configuration brings."""
    names = sorted(p.stem for p in (ROOT / "benchmark" / "reference")
                   .glob("*.py") if p.stem != "__init__")
    assert {"chip", "noc"} <= set(names)
    tops = loaded_after("import " + ", ".join(
        f"benchmark.reference.{name}" for name in names))
    assert not tops & {"jax", "jaxlib", "flax", "sanafe_tpu",
                       "sanafe_tpu_torch"}


def test_a_run_loads_no_jax():
    tops = loaded_after(
        "import time; from benchmark.harness import spec, runner; "
        "cell = spec.Cell(spec.load_benchmark(), 'full.simple'); "
        "cell.config = dict(cell.config, cores=4, neurons_per_core=32); "
        "runner.run_cell(cell, 3, 0.1, False, 'cpu', time.perf_counter(), "
        "log=lambda t: None)")
    assert "sanafe_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "sanafe_tpu"}
