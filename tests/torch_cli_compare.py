"""Shared helpers of the tests that hold the port's file-only entry points
against the JAX package's repo-root ``cli/`` scripts on the CPU: both
scripts' ``main(argv)`` run in process on the same inputs, each writing into
a directory of its own; their exit codes, printed lines (the output
directory's path aside) and every file they write must be equal byte for
byte."""

import argparse
import contextlib
import importlib
import io
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def jax_cli(name):
    return importlib.import_module(f"cli.{name}")


def port_cli(name):
    return importlib.import_module(f"obvi_slam_tpu_torch.cli.{name}")


def run_main(module, argv, replace=()):
    """(exit code, stdout, stderr) of ``module.main(argv)`` in process; a
    SystemExit is its code, a None return 0; each (path, label) of
    ``replace`` is replaced in the printed text."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = module.main(argv)
        except SystemExit as e:
            code = e.code
    texts = [out.getvalue(), err.getvalue()]
    for path, label in replace:
        texts = [t.replace(str(path), label) for t in texts]
    return (code or 0, *texts)


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def assert_same_tree(a, b):
    ta, tb = tree(a), tree(b)
    assert ta.keys() == tb.keys()
    for name in ta:
        assert ta[name] == tb[name], name


def run_both(name, argv_for, tmp_path, prepare=None):
    """``name``'s JAX script and its port on ``argv_for(out)``, ``out`` a
    fresh directory per package (``prepare(out)`` fills it first, e.g. with
    inputs that the script rewrites): asserts equal exit codes, printed
    text and written trees; returns the port's (code, stdout, stderr) and
    its directory."""
    results = {}
    for label, module in (("jax", jax_cli(name)), ("port", port_cli(name))):
        out = Path(tmp_path) / label
        out.mkdir(parents=True)
        if prepare is not None:
            prepare(out)
        results[label] = run_main(module, argv_for(out), replace=((out, "<out>"),))
    assert results["jax"] == results["port"]
    assert_same_tree(Path(tmp_path) / "jax", Path(tmp_path) / "port")
    return results["port"], Path(tmp_path) / "port"


class _Parsed(Exception):
    pass


def cli_arguments(module):
    """(option strings, positional names) of the parser that
    ``module.main`` builds: its first ``parse_args`` is stopped."""
    parse = argparse.ArgumentParser.parse_args

    def grab(self, *args, **kwargs):
        raise _Parsed(self)

    argparse.ArgumentParser.parse_args = grab
    try:
        module.main([])
    except _Parsed as e:
        parser = e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = parse
    return (set(parser._option_string_actions),
            [a.dest for a in parser._actions if not a.option_strings])


def all_cli_names():
    return sorted(p.stem for p in (REPO / "cli").glob("*.py"))

