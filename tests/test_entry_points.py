"""The measurement entry points (chip_smoke.py, bench.py) and the helpers
they share: they refuse to run without a GPU, print the agreed last line,
keep the compile cache where the rule says, and every script imports only
package modules and names that exist."""

import ast
import importlib
import json
import pathlib

import jax
import pytest

from navierstokes_project_nm4pde_tpu.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = "navierstokes_project_nm4pde_tpu"


@pytest.mark.parametrize("env", [None, "/somewhere/else/cache"],
                         ids=["unset", "set"])
def test_compile_cache_rule(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        if env is None:
            # a fixed path in the checkout: no pid, time or tempdir in it
            assert got == str(ROOT / ".jax_cache")
            assert got == compile_cache.compile_cache_dir()
            assert jax.config.jax_compilation_cache_dir == got
        else:
            # JAX reads the variable itself; nothing is set in code
            assert got == env == compile_cache.compile_cache_dir()
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_chip_smoke_device_check_fails_on_cpu():
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device()


def test_chip_smoke_prints_no_result_without_gpu(capsys):
    import chip_smoke

    with pytest.raises(RuntimeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_last_line_format():
    import chip_smoke

    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "extra": "ignored"}
    )
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert line.startswith('{"ok": true, "device": {"platform": "gpu"')


def test_bench_refuses_to_run_without_gpu(capsys):
    import bench

    with pytest.raises(RuntimeError, match="no GPU"):
        bench.measure()
    assert "{" not in capsys.readouterr().out


ENTRY_FILES = sorted(
    [ROOT / "bench.py", ROOT / "chip_smoke.py"]
    + list((ROOT / "scripts").glob("*.py")),
)


@pytest.mark.parametrize(
    "path", ENTRY_FILES, ids=[str(p.relative_to(ROOT)) for p in ENTRY_FILES]
)
def test_script_imports_exist(path):
    """Read (not run) the script: every `import` / `from ... import` of the
    package names a module and attributes that exist."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
            node.module.split(".")[0] == PACKAGE
        ):
            mod = importlib.import_module(node.module)
            for alias in node.names:
                if not hasattr(mod, alias.name):
                    importlib.import_module(f"{node.module}.{alias.name}")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == PACKAGE:
                    importlib.import_module(alias.name)
