"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's scripts under ``tools/`` import neither JAX nor anything of the JAX
package ``repro``."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCRIPTS = ([ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
            ROOT / "examples" / "train_lm_cada_torch.py"]
           + sorted((ROOT / "tools").glob("*.py")))


def _port_files():
    return sorted(PORT.rglob("*.py")) + SCRIPTS


def _modules():
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _refused(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_no_jax_or_repro_import_in_the_source():
    """Every import statement of the port and its scripts, read from the
    syntax tree."""
    for f in _port_files():
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _refused(n)]
            where = f"{f.relative_to(ROOT)}:{node.lineno}"
            assert not bad, f"{where} imports {bad}"


def test_every_module_imports_with_jax_and_repro_refused():
    """In a fresh interpreter whose import hook refuses jax, jaxlib and
    repro (but not repro_torch), every port module and every script imports.
    The scripts are imported as modules, so their ``__main__`` code does not
    run."""
    code = textwrap.dedent(f"""
        import importlib, importlib.util, sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(ROOT / "src")!r})
        for mod in {_modules()!r}:
            importlib.import_module(mod)
        for i, path in enumerate({[str(s) for s in SCRIPTS]!r}):
            spec = importlib.util.spec_from_file_location(f"script{{i}}", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not loaded, loaded
        print("ok", len({_modules()!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_the_serving_slice_is_covered():
    """The two tests above walk every module of the port; the serving
    slice's modules are among them."""
    assert {"repro_torch.configs", "repro_torch.configs.zamba2_2_7b",
            "repro_torch.models.config", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.ssm",
            "repro_torch.models.model", "repro_torch.kernels.ssm_scan",
            "repro_torch.kernels.flash_attention",
            "repro_torch.launch.serve"} <= set(_modules())


def test_the_trainer_slice_is_covered():
    """... and so are the trainer slice's modules."""
    assert {"repro_torch.distributed", "repro_torch.distributed.trainer",
            "repro_torch.launch.train", "repro_torch.configs.stablelm_1_6b",
            "repro_torch.configs.llama3_405b",
            "repro_torch.configs.yi_34b"} <= set(_modules())


def test_the_delta_rule_and_checkpoint_slice_is_covered():
    """... and so are the modules of the delta-payload rules, the
    checkpoint and the paper's remaining problems."""
    assert {"repro_torch.core.local_update", "repro_torch.checkpoint",
            "repro_torch.checkpoint.io", "repro_torch.models.small",
            "repro_torch.data.synthetic",
            "repro_torch.data.partition"} <= set(_modules())


def test_the_telemetry_and_cohort_slice_is_covered():
    """... and so are the telemetry copy and the modules that carry the
    cohort plane, its pipelined driver and their converters; the
    telemetry imports neither torch nor numpy's neighbours beyond numpy."""
    assert {"repro_torch.obs", "repro_torch.obs.trace",
            "repro_torch.obs.metrics", "repro_torch.obs.export",
            "repro_torch.core.flat", "repro_torch.core.engine",
            "repro_torch.distributed.trainer",
            "repro_torch.convert"} <= set(_modules())
    for f in sorted((PORT / "obs").glob("*.py")):
        tree = ast.parse(f.read_text(), filename=str(f))
        tops = {a.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names}
        tops |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.level == 0}
        assert tops <= {"__future__", "json", "time", "typing", "argparse",
                        "sys", "numpy"}, (f.name, tops)


def test_chip_smoke_prints_no_result_without_a_card_or_the_checkout(
        tmp_path):
    """chip_smoke.py exits non-zero with no result line when it finds no
    CUDA device, and when it is alone in a directory without the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
