"""What the benchmark's process loads: never JAX or the JAX package, and
the reference nothing of the program. Each check imports in a fresh
interpreter and reads ``sys.modules`` by top-level name, compared whole
(``hyptokenizer_tpu_torch`` begins with ``hyptokenizer_tpu``)."""

import json
import os
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROBE = """
import json, sys
for m in {mods!r}:
    __import__(m)
from portbench import registry
if {metrics!r}:
    for name in registry.names("metrics", ".py"):
        registry.metric(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(mods, metrics=False):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(mods=mods, metrics=metrics)],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True,
        timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mods,metrics", [
    (["portbench.run", "portbench.controls",
      "portbench.jobs.enhanced_training", "portbench.jobs.embed_pretrain",
      "hyptokenizer_tpu_torch.tokenizer",
      "hyptokenizer_tpu_torch.tokenizer.embed_train"], True),
])
def test_the_run_loads_no_jax(mods, metrics):
    loaded = _top_level(mods, metrics)
    assert not loaded & {"jax", "jaxlib", "flax", "hyptokenizer_tpu"}
    assert "hyptokenizer_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(["portbench.reference.corpus_training",
                         "portbench.reference.embed",
                         "portbench.reference.corpus",
                         "portbench.reference.geometry"])
    assert not loaded & {"jax", "jaxlib", "flax", "hyptokenizer_tpu",
                         "hyptokenizer_tpu_torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    for name in ("hyptokenizer_tpu_torch", "hyptokenizer_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    monkeypatch.setitem(sys.modules, "hyptokenizer_tpu.ops",
                        types.ModuleType("hyptokenizer_tpu.ops"))
    assert run.forbidden_modules() == ["hyptokenizer_tpu", "jaxlib"]
