"""The port imports no JAX: an AST scan of every module of
``roadsurf_tpu_torch`` (a subprocess import would not do: the test
environment may import jax at interpreter start)."""
import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parent.parent / "roadsurf_tpu_torch"
FORBIDDEN = ("jax", "roadsurf_tpu")
MODULES = sorted(PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    # exact module or a submodule of it: roadsurf_tpu_torch shares the
    # prefix of roadsurf_tpu and must not match
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_package_has_modules():
    names = {p.relative_to(PKG).as_posix() for p in MODULES}
    assert {"__init__.py", "model.py", "production.py", "interop.py",
            "coupling.py", "ops/scan_kernel.py", "ops/build.py",
            "io/gridsource.py"} <= names


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def _entry_points():
    from roadsurf_tpu_torch import interop, model, production
    conv = ("to_torch", "point_params", "raw_forcing", "state", "prepared",
            "coupling_vars", "packed")
    return ([model.Model, production.StationExpander,
             production.GridExpander, production.CompositeExpander,
             production.run_production, production.run_production_coupled]
            + [getattr(interop, n) for n in conv])


@pytest.mark.parametrize("fn", _entry_points(), ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(fn):
    """No public entry point of the port defaults its device to the CPU:
    a caller gets the card unless it asks for the CPU."""
    import inspect
    params = inspect.signature(fn).parameters
    dev = params.get("device")
    if dev is None:
        # the composite and the runs take the device of their expander
        assert fn.__name__ in ("CompositeExpander", "run_production",
                               "run_production_coupled"), fn
        return
    default = dev.default
    if default is inspect.Parameter.empty:
        return                          # the caller must name one
    assert torch.device(default).type == "cuda", (fn, default)


def test_matcher_is_exact():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("roadsurf_tpu") and _forbidden("roadsurf_tpu.model")
    assert not _forbidden("roadsurf_tpu_torch")
    assert not _forbidden("roadsurf_tpu_torch.model")
    assert not _forbidden("jaxlib_free")
