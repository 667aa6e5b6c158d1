"""The benchmark loads neither JAX nor the JAX package, and its reference
takes nothing from the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
REPO = ROOT.parent


@pytest.mark.parametrize("modules, found", [
    (["ammcnet_aaai2021_torch", "ammcnet_aaai2021_torch.ops"], []),
    (["jax"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["ammcnet_aaai2021_tpu.models"], ["ammcnet_aaai2021_tpu.models"]),
    (["jax_like", "flaxen", "ammcnet_aaai2021_tpux"], []),
])
def test_forbidden_names_compared_whole(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_nothing_the_benchmark_loads_is_jax():
    code = (
        "import sys, importlib\n"
        "import benchmark.run, benchmark.control, benchmark.faults\n"
        "from benchmark import harness\n"
        "from benchmark.drivers import score, train\n"
        "import ammcnet_aaai2021_torch.eval.export, "
        "ammcnet_aaai2021_torch.eval.infer, "
        "ammcnet_aaai2021_torch.models.quantized, "
        "ammcnet_aaai2021_torch.models.flownet_sd, "
        "ammcnet_aaai2021_torch.train.loop, "
        "ammcnet_aaai2021_torch.train.steps, "
        "ammcnet_aaai2021_torch.train.state\n"
        "for m in harness.manifest()['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "print(harness.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for name in _imports(path):
        top = name.lstrip(".").split(".", 1)[0]
        if name.startswith("."):
            assert name.startswith(".") and top in ("", "model", "train",
                                                    "score", "quantized",
                                                    "precision"), name
        else:
            assert top in ("torch", "numpy", "typing", "__future__",
                           "math"), name


def test_reference_loads_no_port_module():
    code = ("import sys\n"
            "import benchmark.reference.model, benchmark.reference.train, "
            "benchmark.reference.score, benchmark.reference.quantized, "
            "benchmark.reference.precision\n"
            "print(sorted(m for m in sys.modules if m.startswith('ammcnet')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, check=True)
    assert out.stdout.strip() == "[]"
