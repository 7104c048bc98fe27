"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Top-level module names are
compared whole: ``repro_torch`` is not ``repro``."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN_A_CELL = r"""
import json, sys
sys.path.insert(0, "src")
import torch
torch.set_num_threads(1)
import canalbench.run, canalbench.tracing
from canalbench import harness
from canalbench.test_canalbench_cells import small_cell
bench = harness.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.load_metric(m["name"])
for w in bench["workloads"]:
    harness.load_kind(harness.load_traffic(w["traffic"])["kind"])
bench, cell, config, traffic = small_cell("amber_rv.east")
out = harness.run_cell(bench, cell, 1, 0.1, True, 0.0, device="cpu",
                       use_kernels=False, config=config, traffic=traffic)
assert out["correct"]
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

REFERENCE = r"""
import json, sys
import canalbench.reference, canalbench.roofline
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _top_modules(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    tops = _top_modules(RUN_A_CELL)
    assert "repro_torch" in tops and "canalbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "canal",
                       "benchmarks", "chip_smoke"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _top_modules(REFERENCE)
    assert "numpy" in tops
    assert not tops & {"repro_torch", "canal_torch", "jax", "jaxlib",
                       "repro", "canal", "torch"}


def test_forbidden_modules_compares_whole_names():
    from canalbench import harness
    ok = ["repro_torch.core", "canal_torch", "canalbench.run", "jaxtyping"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + ["jax.numpy", "repro.core"]) \
        == ["jax", "repro"]
