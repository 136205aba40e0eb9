"""The port's public surface against the JAX package's: every public name
of each JAX subpackage's ``__init__.py`` (read with ``ast``, not imported)
exists in the port's counterpart, and the modules the JAX package has for
the multi-device layer, the tools, the samples, the utilities and the
native baseline exist in the port under their JAX names."""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "genomeworks_tpu")


def _packages():
    out = []
    for dirpath, _, files in sorted(os.walk(JAX_PKG)):
        if "__init__.py" in files and "__pycache__" not in dirpath:
            rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
            out.append(rel)
    return out


def _public_names(init_path):
    tree = ast.parse(open(init_path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return sorted(n for n in names if not n.startswith("_"))


@pytest.mark.parametrize("package", _packages())
def test_public_names_exist_in_the_port(package):
    init = os.path.join(ROOT, *package.split("."), "__init__.py")
    port = importlib.import_module(package.replace("genomeworks_tpu", "genomeworks_tpu_torch", 1))
    missing = [n for n in _public_names(init) if not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"


@pytest.mark.parametrize("module", [
    "parallel.mesh", "parallel.sharded", "parallel.sharded_mapper", "parallel.multihost",
    "poa.native_baseline", "utils.utilities", "tools.evaluate_paf",
    "tools.genome_simulator", "tools.alignment_visualizer", "samples.sample_aligner",
    "samples.sample_poa", "samples.sample_mapper", "samples.sample_extender",
])
def test_module_exists_under_its_jax_name(module):
    importlib.import_module(f"genomeworks_tpu_torch.{module}")


def test_version_matches_jax():
    import genomeworks_tpu
    import genomeworks_tpu_torch

    assert genomeworks_tpu_torch.version() == genomeworks_tpu.version() == "0.1.0"


def test_every_port_module_imports_without_jax():
    """Each module of the port imports with JAX and the JAX package
    blocked, and imports neither."""
    import subprocess
    import sys

    code = (
        "import importlib, os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genomeworks_tpu'] = None\n"
        "root = os.path.join(os.getcwd(), 'genomeworks_tpu_torch')\n"
        "n = 0\n"
        "for d, _, fs in sorted(os.walk(root)):\n"
        "    for f in sorted(fs):\n"
        "        if f.endswith('.py'):\n"
        "            rel = os.path.relpath(os.path.join(d, f), os.getcwd())[:-3]\n"
        "            importlib.import_module(rel.replace(os.sep, '.').removesuffix('.__init__'))\n"
        "            n += 1\n"
        "assert not any(k == 'genomeworks_tpu' or k.startswith(('genomeworks_tpu.', 'jax.'))"
        " for k, v in sys.modules.items() if v is not None), 'reference package imported'\n"
        "print(n)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 79
