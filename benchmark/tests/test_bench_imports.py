"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``csm_tpu_torch`` begins with ``csm_tpu``), the
references load nothing of the program, and the drivers and the weight
maker reach what is particular to a model only through its family."""

import os
import re
import subprocess
import sys

import pytest

from benchmark import spec


def test_names_are_compared_whole():
    mods = ["csm_tpu_torch", "csm_tpu_torch.serving", "jaxtyping", "flaxen", "numpy"]
    assert spec.forbidden_loaded(mods) == []
    assert spec.forbidden_loaded(mods + ["jax.numpy", "csm_tpu", "csm_tpu.models", "optax",
                                         "orbax.checkpoint", "jaxlib", "flax.linen"]) == [
        "csm_tpu", "csm_tpu.models", "flax.linen", "jax.numpy", "jaxlib", "optax",
        "orbax.checkpoint"]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join(sys.modules))"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_harness_and_the_program_load_no_jax():
    code = ("import benchmark.run, benchmark.drivers.serve, benchmark.drivers.train, "
            "benchmark.trace\n"
            "import csm_tpu_torch.serving, csm_tpu_torch.train.loop, csm_tpu_torch.codec\n"
            "from benchmark import spec\n"
            "b = spec.load_benchmark()\n"
            "[spec.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
            "[spec.family(spec.cell(b, w['name'])['config']) for w in b['workloads']]")
    assert spec.forbidden_loaded(_modules_after(code)) == []


def test_the_references_load_nothing_of_the_program():
    mods = _modules_after("import benchmark.reference.csm, benchmark.reference.mimi")
    assert not [m for m in mods if m.split(".")[0] in ("csm_tpu_torch",) + spec.FORBIDDEN]


@pytest.mark.parametrize("path", ["drivers/serve.py", "drivers/train.py", "weights.py",
                                  "knee.py", "control.py"])
def test_model_specifics_come_through_the_family(path):
    with open(os.path.join(spec.HERE, path)) as f:
        src = f.read()
    assert not re.search(r"reference(\.| import )csm|csm_shapes|CSMConfig|"
                         r"yardstick\.(prefill|frame|train_sequence|request)_flops|"
                         r"flash_train_work\(cfg", src.replace("fam.flash_train_work(cfg", ""))
