"""Nothing the benchmark runs imports JAX or the JAX package: top-level
module names compared whole (the port's name begins with the JAX
package's)."""

import ast
import subprocess
import sys

from _perfbench_util import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_no_source_imports_a_forbidden_module():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_run_path_loads_no_forbidden_module():
    """Import every module a run loads, in a fresh process, and look at
    ``sys.modules`` as the run does before it prints."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
import harness.cells, harness.serve, harness.trace
import reference.llama, reference.deepseek_v2
import counts.flops, counts.topk_gather, counts.peaks
import repro_torch.launch.serve
from harness.spec import load_benchmark, metric_reader
for m in load_benchmark().get("per_layer"):
    metric_reader(m["name"])
sys.path.insert(0, {str(BENCH)!r})
import run
print(sorted({{n.split('.')[0] for n in sys.modules}} & set({sorted(FORBIDDEN)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
