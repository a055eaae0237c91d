"""PyTorch port: configs and error taxonomy equal the JAX package's, the
port never imports JAX or the JAX package, and its entry points need an
explicit ``device="cpu"`` to run off the card."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro.configs as jcfg
import repro.errors as jerr
import repro_torch.configs as tcfg
import repro_torch.errors as terr

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("name", jcfg.list_configs())
def test_config_and_smoke_equal_reference(name):
    ref, port = jcfg.get_config(name), tcfg.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.smoke()) == dataclasses.asdict(ref.smoke())
    assert (port.resolved_head_dim, port.q_per_kv, port.pattern()) == (
        ref.resolved_head_dim, ref.q_per_kv, ref.pattern())


def test_registry_equal_reference():
    assert tcfg.list_configs() == jcfg.list_configs()
    assert tcfg.ASSIGNED == jcfg.ASSIGNED
    assert tcfg.INPUT_SHAPES == jcfg.INPUT_SHAPES
    run_p = tcfg.make_run(tcfg.get_config("llama2-7b"), "decode_32k", "swa")
    run_r = jcfg.make_run(jcfg.get_config("llama2-7b"), "decode_32k", "swa")
    assert dataclasses.asdict(run_p) == dataclasses.asdict(run_r)
    assert run_p.num_pages == run_r.num_pages


def test_error_taxonomy_equal_reference():
    names = [n for n, v in vars(jerr).items()
             if isinstance(v, type) and issubclass(v, Exception)]
    assert names
    for n in names:
        ref, port = getattr(jerr, n), getattr(terr, n)
        assert ([c.__name__ for c in port.__mro__]
                == [c.__name__ for c in ref.__mro__]), n
    e = terr.Backpressure("full", rid=3, retry_after_steps=2, queue_depth=5,
                          pool_util=0.123456)
    r = jerr.Backpressure("full", rid=3, retry_after_steps=2, queue_depth=5,
                          pool_util=0.123456)
    assert str(e) == str(r) and isinstance(e, terr.EngineError)


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_reference_statically():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print(len(names))
"""


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20


def test_engine_defaults_to_cuda_and_refuses_without_it():
    from repro_torch.serving import Engine
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tcfg.get_smoke("llama2-7b")
    with pytest.raises(terr.EngineConfigError, match="no CUDA device"):
        Engine(cfg)
    Engine(cfg, device="cpu", max_slots=1, max_seq_len=16)
    from repro_torch.models import params_from_numpy
    with pytest.raises(terr.EngineConfigError, match="no CUDA device"):
        params_from_numpy({"embed": {}, "ln_f": {}})
    assert params_from_numpy({"embed": {}, "ln_f": {}},
                             device="cpu")["layers"] == []


@pytest.mark.parametrize("impl", ["pallas", "jnp", "kernels"])
def test_entry_points_refuse_unknown_impl(impl):
    """``impl`` is "kernel" or "ref" at every entry point; a JAX name
    or a typo raises instead of silently running a plain path."""
    from repro_torch.core import attention
    from repro_torch.kernels.flex_attention.ops import flex_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.serving import Engine
    x = torch.zeros(1, 4, 2, 8)
    pages = torch.zeros(2, 4, 2, 8)
    one = torch.ones(1, dtype=torch.int32)
    calls = [
        lambda: attention.prefill_attention(x, x, x, impl=impl),
        lambda: attention.decode_attention(x[:, 0], pages, pages,
                                           one[:, None] - 1, one, impl=impl),
        lambda: paged_attention(x[:, 0], pages, pages, one[:, None] - 1, one,
                                impl=impl),
        lambda: flex_attention(x, x, x, impl=impl),
        lambda: Engine(tcfg.get_smoke("llama2-7b"), device="cpu", impl=impl),
    ]
    for call in calls:
        with pytest.raises(terr.EngineConfigError, match="impl"):
            call()
