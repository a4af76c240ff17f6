"""What a run loads: never JAX or the JAX package (top-level names
compared whole: anyseq_tpu_torch is not anyseq_tpu), and the plain
reference nothing of the program."""
import json
import subprocess
import sys

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(root, body: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(root), body=body)],
                         capture_output=True, text=True, check=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program(root):
    mods = _loaded(root, "from benchmark.reference import alignment, dp\n"
                         "from benchmark import control")
    assert not mods & {"jax", "jaxlib", "flax", "anyseq_tpu",
                       "anyseq_tpu_torch"}


def test_a_run_loads_no_jax(root):
    body = """
from benchmark import harness
from pathlib import Path
import copy
cell = harness.load_cell(Path({root!r}), "contig100k.align")
cell.config["sequences"]["length"] = 200
cell.traffic["profile_calls"] = 1
result, checks = harness.run_cell(cell, 9, 0.2, True, "cpu")
assert result["correct"], checks
assert harness.forbidden_modules() == []
""".format(root=str(root))
    mods = _loaded(root, body)
    assert "anyseq_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "anyseq_tpu"}


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "anyseq_tpu_torch_fake", sys)
    assert "anyseq_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
