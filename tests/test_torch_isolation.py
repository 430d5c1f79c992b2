"""The PyTorch port stands alone: no port module, nor ``chip_smoke.py`` or
``scripts/torch_*.py``, nor a test module that must run without JAX,
imports jax, jaxlib, flax, optax or the JAX package
(``network_distributed_pytorch_tpu``), and the whole port imports and runs
one CPU training step with those blocked.

Based on ``scripts/lint_jax_free.py``: an AST walk over every file (imports
at any scope), then the transitive check in a fresh interpreter with a
meta-path hook that raises on a banned import. The JAX package's name is
matched exactly or with a dot, so ``network_distributed_pytorch_tpu_torch``
itself is not mistaken for it.
"""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "network_distributed_pytorch_tpu_torch"
BANNED_ROOTS = ("jax", "jaxlib", "flax", "optax")
JAX_PACKAGE = "network_distributed_pytorch_tpu"


def banned(name: str) -> bool:
    return (
        name.split(".", 1)[0] in BANNED_ROOTS
        or name == JAX_PACKAGE
        or name.startswith(JAX_PACKAGE + ".")
    )


def port_files():
    for dirpath, _, files in os.walk(os.path.join(REPO, PORT)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    # the port's measuring scripts, which run on the card's machine
    for f in sorted(os.listdir(os.path.join(REPO, "scripts"))):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(REPO, "scripts", f)
    # test modules that run where there is no JAX: spawned ranks, card tests
    yield os.path.join(REPO, "tests", "torch_worker.py")
    yield os.path.join(REPO, "tests", "torch_model_parallel_worker.py")
    yield os.path.join(REPO, "tests", "test_torch_cuda.py")


def violations(path):
    with open(path, "rb") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if banned(alias.name):
                    yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if banned(node.module):
                yield node.lineno, node.module


def test_name_match_is_exact():
    assert banned("jax.numpy") and banned("flax") and banned(JAX_PACKAGE)
    assert banned(JAX_PACKAGE + ".parallel.comm")
    assert not banned(PORT) and not banned(PORT + ".ops") and not banned("jaxtyping")


def test_no_port_file_imports_jax_or_the_jax_package():
    files = list(port_files())
    assert len(files) > 15
    found = [f"{os.path.relpath(p, REPO)}:{line} {name}" for p in files for line, name in violations(p)]
    assert not found, found


SERVING_MODULES = (
    "ops/paged.py", "observe/__init__.py", "observe/events.py", "observe/memory.py", "resilience/__init__.py",
    "resilience/supervisor.py", "serving/__init__.py", "serving/request.py", "serving/blocks.py",
    "serving/cache.py", "serving/engine.py", "serving/frontend.py", "experiments/serve_gpt.py",
)


def test_serving_modules_are_checked():
    """The serving slice's modules, including the port's own copies of the
    JAX package's modules that import no jax (``serving/blocks.py``,
    ``request.py``, ``frontend.py``, ``observe/events.py``,
    ``resilience/supervisor.py``), are among the files walked above and
    import none of it."""
    files = {os.path.relpath(p, os.path.join(REPO, PORT)) for p in port_files()}
    assert set(SERVING_MODULES) <= files
    for rel in SERVING_MODULES:
        assert not list(violations(os.path.join(REPO, PORT, rel))), rel


def test_port_imports_and_trains_with_jax_blocked():
    """In a fresh interpreter, block the banned imports, import every port
    module, and run one CPU PowerSGD step of the small ResNet-18."""
    script = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        BANNED = {BANNED_ROOTS!r}
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".", 1)[0] in BANNED or name == {JAX_PACKAGE!r} or name.startswith({JAX_PACKAGE!r} + "."):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Blocker())
        import {PORT} as port
        mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
        for m in mods:
            importlib.import_module(m)
        for m in ("ops.paged", "observe.events", "observe.memory", "resilience.supervisor", "serving.blocks",
                  "serving.cache", "serving.engine", "serving.frontend", "serving.request", "experiments.serve_gpt"):
            assert {PORT!r} + "." + m in mods, m
        import torch
        torch.set_num_threads(1)  # a small step; the suite's workers share the cores
        from {PORT}.experiments import powersgd_cifar10 as pc
        cfg = pc.default_config()
        cfg.global_batch_size = 4
        model, step, state = pc.build(cfg, "small", "cpu", None)
        x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
        state, loss = step(state, (x, torch.arange(4)))
        assert torch.isfinite(loss)
        bad = [m for m in sys.modules if m.split(".")[0] in BANNED or m == {JAX_PACKAGE!r} or m.startswith({JAX_PACKAGE!r} + ".")]
        assert not bad, bad
        print("OK", len(mods))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules >= 20, proc.stdout
