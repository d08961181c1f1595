"""Helpers of the tests that hold the scripts of examples_torch/ to the
reference's examples/: load a script from its file, run a script's main
with its printed lines captured, check in a fresh interpreter that a
script imports neither JAX nor the reference package, and check that a
script without a card and without ``--device cpu`` stops before it
writes anything."""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def load(path, name):
    """The module of the script at ``path`` (relative to the repository
    root), imported under ``name``."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args):
    """(fn(*args), the lines it printed to stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def ref_main(mod, argv):
    """The reference script's ``main()`` (which reads ``sys.argv``) run
    with ``argv``: the lines it printed."""
    saved = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        return printed(mod.main)[1]
    finally:
        sys.argv = saved


_TIMES = (re.compile(r"in \d+(\.\d+)?s\b"),
          re.compile(r"\(\d+(\.\d+)? (tok|docs)/s[^)]*\)"))


def untimed(lines):
    """The lines with their wall times ("in 1.2s") and rates ("(123
    docs/s ...)", "(45 tok/s)") blanked."""
    out = []
    for line in lines:
        for pat in _TIMES:
            line = pat.sub("<t>", line)
        out.append(line)
    return out


def start_import_guard(path, module):
    """Start loading the script at ``path`` in a fresh interpreter, which
    checks that it imports no ``jax`` and no ``repro`` module and does
    import ``module``; ``assert_import_guard`` waits for the verdict (a
    test starts it early, so that it runs beside the slower ones)."""
    code = (
        "import sys, importlib.util\n"
        "spec = importlib.util.spec_from_file_location('script', "
        "sys.argv[1])\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        f"assert {module!r} in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code, str(ROOT / path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def assert_import_guard(proc):
    """The verdict of ``start_import_guard``'s interpreter."""
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err


def assert_no_card_stops(run, args, directory):
    """Without a card, ``run(args)`` (a script's, ``args`` without
    ``--device cpu``) raises "no CUDA device" and leaves ``directory``
    empty."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(SystemExit, match="no CUDA device"):
        run(args)
    assert not any(Path(directory).iterdir())
