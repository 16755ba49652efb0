"""The reference's own test suites, run with the port in place.

``suite_on_port("test_wal.py")`` loads a reference suite from this
directory with every ``mysticeti_tpu`` import pointed at
``mysticeti_tpu_torch`` (and ``helpers`` at its port copy, loaded the same
way), and returns its namespace.  A ``tests/test_torch_*.py`` file puts
that namespace in its globals, so pytest collects each reference case,
with its fixtures, marks, margins and timeouts unchanged, as a case of the
port's file.  ``renames`` swaps a name the port spells differently (each
must occur in the source); ``leave_out`` drops the cases that a port
test holds in another form, so that the caller names where.

Assertions are rewritten as pytest rewrites a test module's, so a failing
case reports its operands.
"""
import ast
import os
import re
import sys
import types

TESTS = os.path.dirname(os.path.abspath(__file__))
_PACKAGE = re.compile(r"\bmysticeti_tpu\b")
_HELPERS = "torch_reference_helpers"


def port_source(name, renames=()):
    """The reference suite's source with the port in place of the package."""
    with open(os.path.join(TESTS, name)) as f:
        source = f.read()
    source = _PACKAGE.sub("mysticeti_tpu_torch", source)
    source = source.replace("from helpers import", f"from {_HELPERS} import")
    for old, new in renames:
        assert old in source, f"{name} has no {old!r} to rename"
        source = source.replace(old, new)
    return source


def _load(name, module_name, renames=()):
    path = os.path.join(TESTS, name)
    source = port_source(name, renames)
    tree = ast.parse(source, path)
    try:
        from _pytest.assertion.rewrite import rewrite_asserts

        rewrite_asserts(tree, source.encode(), path)
    except ImportError:  # plain asserts still fail the case
        pass
    module = types.ModuleType(module_name)
    module.__file__ = path
    sys.modules[module_name] = module
    exec(compile(tree, path, "exec"), module.__dict__)
    return module


def suite_on_port(name, renames=(), leave_out=()):
    """The reference suite ``name``'s public namespace, on the port."""
    if _HELPERS not in sys.modules:
        _load("helpers.py", _HELPERS)
    module = _load(name, f"torch_reference_{name[:-3]}", renames)
    for case in leave_out:
        assert case in module.__dict__, f"{name} has no case {case}"
    return {key: value for key, value in module.__dict__.items()
            if not key.startswith("__") and key not in leave_out}
