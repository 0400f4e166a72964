"""What the harness and the reference import: never JAX or the JAX
package (top-level names compared whole), and the reference nothing of
the program under test."""
import ast
import glob
import os
import subprocess
import sys

from conftest import BENCH, ROOT

BLOCK = ('class _Block:\n'
         '    def find_spec(self, name, path=None, target=None):\n'
         '        if name.split(".")[0] in ("jax", "jaxlib", "flax", '
         '"rvspecfit_tpu"):\n'
         '            raise ImportError("blocked: " + name)\n'
         'import sys; sys.meta_path.insert(0, _Block())\n')


def _run(code):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([BENCH, ROOT]))
    return subprocess.run([sys.executable, '-c', BLOCK + code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_harness_and_readers_import_without_jax():
    mods = ['benchlib.' + os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(BENCH, 'benchlib', '*.py')) if '__init__' not in p]
    code = ''.join(f'import {m}\n' for m in mods) + (
        'from benchlib import spec\n'
        'import glob, os\n'
        f'for p in glob.glob(os.path.join({BENCH!r}, "*", "*.py")) + '
        f'glob.glob(os.path.join({BENCH!r}, "kernels", "*", "*.py")):\n'
        '    if "/tests/" not in p: spec.load_module(p)\n'
        'import rvspecfit_torch.survey.desi, rvspecfit_torch.fit.vel_fit\n'
        'bad = {m.split(".")[0] for m in sys.modules} & '
        '{"jax", "jaxlib", "flax", "rvspecfit_tpu"}\n'
        'assert not bad, bad\n')
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_reference_imports_nothing_of_the_program():
    names = set()
    for f in ('reference.py', 'reference_ccf.py'):
        src = open(os.path.join(BENCH, 'benchlib', f)).read()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                names |= {a.name.split('.')[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add(node.module or '')
    assert names <= {'math', 'numpy', 'scipy', 'torch', 'benchlib'}, names
    out = _run('import benchlib.reference, benchlib.reference_ccf\n'
               'bad = {m.split(".")[0] for m in sys.modules} & '
               '{"rvspecfit_torch", "rvspecfit_tpu", "jax"}\n'
               'assert not bad, bad\n')
    assert out.returncode == 0, out.stderr


def test_run_refuses_without_a_card_and_without_the_program(tmp_path):
    from conftest import copy_benchmark
    copy_benchmark(str(tmp_path))
    cmd = [sys.executable, 'benchmark/run.py', '--workload',
           'desi_petal_norot.tile500', '--seed', '1', '--seconds', '1',
           '--trace', '0']
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ''
