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
import json
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
    yield os.path.join(REPO, "tests", "torch_adaptive_worker.py")
    yield os.path.join(REPO, "tests", "test_torch_cuda.py")
    # the supervisor tests' toy worker, which imports neither torch nor jax
    # unless its telemetry is on (then the port's observe, never jax)
    yield os.path.join(REPO, "tests", "torch_toy_supervised_worker.py")
    # the fleet tests' toy serving worker (the port's serving, never jax)
    yield os.path.join(REPO, "tests", "torch_toy_serving_worker.py")


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


# the run directory and the live plane: the supervising parent runs them in
# its poll loop, so they import no torch themselves (observe/__init__.py
# does, for the spans and the memory sampler), nor do the fabric model and
# the overlap extract they read
LIVE_PLANE_MODULES = (
    "observe/runlog.py", "observe/health.py", "observe/analytics.py", "observe/live.py", "utils/bandwidth.py",
    "utils/overlap.py",
)


def module_level_imports(path):
    """The modules a file imports outside any function or class body."""
    with open(path, "rb") as f:
        tree = ast.parse(f.read(), filename=path)
    out = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            out += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.append("." * node.level + node.module)
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Import):
                    out += [alias.name for alias in sub.names]
                elif isinstance(sub, ast.ImportFrom) and sub.module:
                    out.append("." * sub.level + sub.module)
    return out


def test_live_plane_modules_import_neither_jax_nor_torch():
    files = {os.path.relpath(p, os.path.join(REPO, PORT)) for p in port_files()}
    assert set(LIVE_PLANE_MODULES) <= files
    for rel in LIVE_PLANE_MODULES:
        path = os.path.join(REPO, PORT, rel)
        assert not list(violations(path)), rel
        imported = module_level_imports(path)
        assert imported, rel
        assert not [m for m in imported if m.split(".")[0] == "torch"], (rel, imported)
        # nor a module of the port that does (observe's are events, runlog, analytics, health, sinks)
        for m in imported:
            if m.startswith("."):
                assert m.lstrip(".").split(".")[0] in (
                    "events", "runlog", "analytics", "health", "sinks", "utils"), (rel, m)
    toy = os.path.join(REPO, "tests", "torch_toy_supervised_worker.py")
    assert not list(violations(toy))
    assert not [m for m in module_level_imports(toy) if m.split(".")[0] == "torch" or ".observe" in m]


# the offline analyses: like the live plane's modules, they import no torch
# (the report and the planner run anywhere a run directory is copied)
OFFLINE_MODULES = ("observe/mfu.py", "observe/critpath.py", "observe/fabric.py", "observe/costmodel.py")
OFFLINE_SCRIPTS = ("torch_report.py", "torch_plan.py", "torch_gate.py")


def test_offline_analyses_import_neither_jax_nor_torch():
    files = {os.path.relpath(p, os.path.join(REPO, PORT)) for p in port_files()}
    scripts = {os.path.basename(p) for p in port_files()}
    assert set(OFFLINE_MODULES) <= files and set(OFFLINE_SCRIPTS) <= scripts
    for rel in OFFLINE_MODULES:
        path = os.path.join(REPO, PORT, rel)
        assert not list(violations(path)), rel
        imported = module_level_imports(path)
        assert not [m for m in imported if m.split(".")[0] == "torch"], (rel, imported)
        for m in imported:
            if m.startswith("."):
                assert m.lstrip(".").split(".")[0] in ("events", "analytics", "utils"), (rel, m)
    for name in OFFLINE_SCRIPTS:
        path = os.path.join(REPO, "scripts", name)
        assert not list(violations(path)), name
        assert not [m for m in module_level_imports(path) if m.split(".")[0] == "torch"], name
    # the gate reads JSON alone: the standard library and nothing else
    gate = module_level_imports(os.path.join(REPO, "scripts", "torch_gate.py"))
    assert gate and not [m for m in gate if m.split(".")[0] not in sys.stdlib_module_names], gate


def test_report_and_planner_run_with_jax_blocked(tmp_path):
    """In a fresh interpreter with the banned imports blocked, the planner
    plans from a report and the report script reads a run directory."""
    report = tmp_path / "report.json"
    report.write_text(json.dumps({
        "run_dir": "r", "step_p50_s": 0.05, "world_size": 2,
        "bandwidth": {"total": {"payload_bytes": 1 << 20, "count": 1}, "attribution": {"exposed_fraction": 1.0}},
        "compile": {"comm_config": {"reducer": "exact"}}, "mfu": [], "spans": None,
    }))
    script = textwrap.dedent(
        f"""
        import sys
        BANNED = {BANNED_ROOTS!r}
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".", 1)[0] in BANNED or name == {JAX_PACKAGE!r} or name.startswith({JAX_PACKAGE!r} + "."):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Blocker())
        sys.path.insert(0, "scripts")
        import torch_gate, torch_plan, torch_report
        assert torch_plan.main(["--report", {str(report)!r}, "--out", {str(tmp_path / "plan.json")!r},
                                "--events-out", {str(tmp_path / "pred.jsonl")!r}]) == 0
        from {PORT}.observe import runlog
        run_dir = {str(tmp_path / "run")!r}
        runlog.new_manifest("r", 1).save(run_dir)
        text, doc = torch_report.run_report(run_dir)
        assert doc["world_size"] == 1 and doc["critpath"] is None
        assert torch_gate.main(["--report", {str(report)!r}, "--baseline", {str(report)!r}]) == 0
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]
    plan = json.loads((tmp_path / "plan.json").read_text())
    assert list(plan["fabrics"]) == ["1GbE", "10GbE", "100GbE", "NVLink4(H100)"]


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
        for m in ("ops.paged", "observe.events", "observe.memory", "observe.costmodel", "resilience.supervisor",
                  "resilience.chaos", "resilience.guards", "resilience.controller", "parallel.hierarchical",
                  "experiments.common", "data.partition", "serving.blocks",
                  "serving.cache", "serving.engine", "serving.frontend", "serving.request", "experiments.serve_gpt",
                  "observe.runlog", "observe.health", "observe.analytics", "observe.live", "observe.mfu",
                  "observe.critpath", "observe.fabric"):
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


def test_parent_modules_import_with_torch_blocked():
    """The supervising parent holds no card: ``resilience/supervisor.py``,
    ``resilience/chaos.py``, ``guards.py``, ``controller.py`` and the fleet
    scheduler (and the package around them) and the toy test worker import
    with torch blocked too."""
    script = textwrap.dedent(
        f"""
        import importlib, sys
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".", 1)[0] in ("torch",) + {BANNED_ROOTS!r} or name.startswith({JAX_PACKAGE!r}):
                    if not name.startswith({PORT!r}):
                        raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Blocker())
        for m in ("resilience", "resilience.supervisor", "resilience.chaos", "resilience.guards",
                  "resilience.controller", "resilience.scheduler"):
            importlib.import_module({PORT!r} + "." + m)
        sys.path.insert(0, "tests")
        import torch_toy_supervised_worker
        assert "torch" not in sys.modules
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr[-3000:]


def test_fleet_modules_are_checked_and_run_with_jax_blocked(tmp_path):
    """The fleet control plane: ``resilience/scheduler.py`` (the port's own
    copy of a JAX package module that imports no jax) and the toy serving
    worker are among the files walked above; the scheduler imports no torch
    at module level (its events, live plane, cost model and spool are
    imported where used); and ``launch fleet`` runs a job and quarantines a
    crash-looper in a fresh interpreter with the banned imports blocked."""
    files = set(port_files())
    scheduler = os.path.join(REPO, PORT, "resilience", "scheduler.py")
    toy = os.path.join(REPO, "tests", "torch_toy_serving_worker.py")
    assert {scheduler, toy} <= files
    for path in (scheduler, toy):
        assert not list(violations(path)), path
    imported = module_level_imports(scheduler)
    assert [m for m in imported if m.startswith(".")] == [".supervisor"], imported
    assert not [m for m in imported if m.split(".")[0] == "torch"], imported
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps([
        {"job_id": "ok", "argv": [sys.executable, "-c", "pass"], "priority": 1},
        {"job_id": "looper", "argv": [sys.executable, "-c", "raise SystemExit(43)"], "max_restarts": 0},
    ]))
    script = textwrap.dedent(
        f"""
        import sys
        BANNED = {BANNED_ROOTS!r}
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".", 1)[0] in BANNED or name == {JAX_PACKAGE!r} or name.startswith({JAX_PACKAGE!r} + "."):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Blocker())
        from {PORT} import launch
        out = launch.main(["fleet", "--spool-dir", {str(tmp_path / "spool")!r}, "--devices", "2",
                           "--submit", {str(jobs)!r}, "--run-dir", {str(tmp_path / "run")!r}])
        assert out == {{"fleet_rc": 0}}, out
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]
    with open(tmp_path / "spool" / "quarantine" / "looper.json") as f:
        assert json.load(f)["last_rc"] == 43


DATA_PLANE_FILES = (
    os.path.join(PORT, "native", "__init__.py"), os.path.join(PORT, "native", "build.py"),
    os.path.join(PORT, "native", "loader.py"), os.path.join(PORT, "data", "multihost.py"),
    os.path.join(PORT, "data", "loader.py"), os.path.join(PORT, "hostenv.py"),
    os.path.join("scripts", "torch_loader_smoke.py"),
)


def test_data_plane_files_are_checked():
    """The host data plane (the native runtime, ``data/multihost.py``,
    ``data/loader.py``, ``hostenv.py`` and the loader smoke) is among the
    files walked above, and imports none of the banned modules."""
    files = {os.path.relpath(p, REPO) for p in port_files()}
    assert set(DATA_PLANE_FILES) <= files
    for rel in DATA_PLANE_FILES:
        assert not list(violations(os.path.join(REPO, rel))), rel


def _code_strings(path):
    """The string constants of a Python file's code, docstrings left out
    (they cite the JAX package's files as the kernels' and modules'
    originals), or a C++/CUDA source's ``#include`` lines."""
    with open(path, "rb") as f:
        text = f.read().decode("utf-8")
    if not path.endswith(".py"):
        return [line for line in text.splitlines() if line.lstrip().startswith("#include")]
    tree = ast.parse(text, filename=path)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docstrings.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docstrings]


def test_no_port_file_names_a_path_into_the_jax_package():
    """No code of the port package (its Python, and the ``#include``s of its
    C++ and CUDA sources) nor of a ``scripts/torch_*.py`` names the JAX
    package as a path or a path's part, so no build of the port can read
    its sources: the native runtime compiles its own
    ``native/dataloader.cpp``."""
    import re

    pattern = re.compile(r"(?:^|[/\\\"'<\s])" + JAX_PACKAGE + r"(?:[/\\]|$|[\"'>])")
    paths = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(REPO, PORT)) for f in fs
             if "__pycache__" not in d and "_build" not in d and f.endswith((".py", ".cpp", ".cu", ".cuh"))]
    paths += [os.path.join(REPO, "scripts", f) for f in os.listdir(os.path.join(REPO, "scripts"))
              if f.startswith("torch_") and f.endswith(".py")]
    assert any(p.endswith("dataloader.cpp") for p in paths) and any(p.endswith("build.py") for p in paths)
    found = [f"{os.path.relpath(p, REPO)}: {s!r}" for p in paths for s in _code_strings(p) if pattern.search(s)]
    assert not found, found
    for bad in (f"{JAX_PACKAGE}/native/dataloader.cpp", f"../../{JAX_PACKAGE}/native", JAX_PACKAGE,
                f'#include "{JAX_PACKAGE}/x.h"'):
        assert pattern.search(bad), bad
    assert not pattern.search(f"{PORT}/native/dataloader.cpp") and not pattern.search(PORT)


def test_data_plane_runs_with_jax_blocked(tmp_path):
    """In a fresh interpreter with the banned imports blocked: the native
    runtime builds from the port's own source and runs an epoch, the
    multihost placement and the preflight run, and the loader smoke exits 0
    on the CPU."""
    script = textwrap.dedent(
        f"""
        import runpy, sys
        BANNED = {BANNED_ROOTS!r}
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".", 1)[0] in BANNED or name == {JAX_PACKAGE!r} or name.startswith({JAX_PACKAGE!r} + "."):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Blocker())
        import numpy as np
        from {PORT} import hostenv
        from {PORT}.data import NativeBatchLoader, global_batch_from_local, merge_tokenized_shards
        from {PORT}.native import build, native_available
        assert native_available() and build._SRC.endswith("{PORT}/native/dataloader.cpp")
        x, y = np.arange(48, dtype=np.float32).reshape(12, 4), np.arange(12, dtype=np.int32)
        loader = NativeBatchLoader(x, y, 4, seed=1)
        assert len(list(loader.epoch(0))) == 3 and loader.last_stats["native"]
        assert global_batch_from_local((x, y), "cpu")[0].shape == (12, 4)
        assert merge_tokenized_shards([{{"a": y[:5]}}, {{"a": y[5:]}}])["a"].tolist() == y.tolist()
        assert set(hostenv.backend_preflight(timeout_s=30, attempts=1)) >= {{"ok", "cause"}}
        sys.argv = ["torch_loader_smoke.py", "--device", "cpu", "--n", "256", "--batch", "32",
                    "--json-out", {str(tmp_path / "smoke.json")!r}]
        try:
            runpy.run_path("scripts/torch_loader_smoke.py", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = [m for m in sys.modules if m.split(".")[0] in BANNED or m == {JAX_PACKAGE!r} or m.startswith({JAX_PACKAGE!r} + ".")]
        assert not bad, bad
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "NDP_TPU_NO_NATIVE")}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]
    smoke = json.loads((tmp_path / "smoke.json").read_text())
    assert smoke["native"] and smoke["labels_ok"] and smoke["overlapped_steps"] == 8


# the accuracy study and the bandwidth artifact: the port's scripts of the
# JAX package's two headline results
STUDY_SCRIPTS = ("torch_accuracy_study.py", "torch_bandwidth_artifact.py")


def test_study_scripts_are_checked_and_run_with_jax_blocked(tmp_path):
    """Both scripts are among the files walked above and import none of the
    banned modules; in a fresh interpreter with those blocked, the accuracy
    study's ``main`` runs the wide IMDb task for an epoch on the CPU and the
    bandwidth artifact projects a structure record."""
    scripts = {os.path.basename(p) for p in port_files()}
    assert set(STUDY_SCRIPTS) <= scripts
    for name in STUDY_SCRIPTS:
        assert not list(violations(os.path.join(REPO, "scripts", name))), name
    structure = {"structure": {"num_devices": 8, "projected_workers": 8, "results": {
        "exact": {"recorded_bits_per_step": 800_000_000, "collectives": {"all-reduce": 2}, "measured_step_s": 0.1},
        "powersgd_r4": {"recorded_bits_per_step": 8_000_000, "collectives": {"all-reduce": 4}, "measured_step_s": 0.1},
    }}}
    (tmp_path / "bw.json").write_text(json.dumps(structure))
    script = textwrap.dedent(
        f"""
        import json, sys
        BANNED = {BANNED_ROOTS!r}
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".", 1)[0] in BANNED or name == {JAX_PACKAGE!r} or name.startswith({JAX_PACKAGE!r} + "."):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Blocker())
        sys.path.insert(0, "scripts")
        import torch
        torch.set_num_threads(2)
        import torch_accuracy_study, torch_bandwidth_artifact
        out = {str(tmp_path / "acc.json")!r}
        assert torch_accuracy_study.main(["--task", "imdb_wide", "--max-epochs", "1", "--patience", "1",
                                          "--device", "cpu", "--out", out]) == 0
        rec = json.load(open(out))["imdb_wide"]
        assert rec["gradient_bytes_ratio"] == 9.2 and rec["nvidia_smi"] is None and rec["device"] == "cpu"
        assert torch_bandwidth_artifact.main(["project", "--out", {str(tmp_path / "bw.json")!r}]) == 0
        bad = [m for m in sys.modules if m.split(".")[0] in BANNED or m == {JAX_PACKAGE!r} or m.startswith({JAX_PACKAGE!r} + ".")]
        assert not bad, bad
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]
    # the study's one slim line, before the projection's table
    slim = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"imdb_wide"')]
    assert len(slim) == 1 and set(slim[0]["imdb_wide"]) >= {"accuracy_delta_pts", "gradient_bytes_ratio"}
    assert json.load(open(tmp_path / "bw.json"))["speedup_vs_exact"]["powersgd_r4"]["1GbE"] > 1
