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
            "io/gridsource.py", "io/writer.py", "parallel/sharding.py",
            "parallel/distributed.py", "observability.py", "runner.py",
            "io/interp.py", "io/native.py", "io/sources.py",
            "io/skyview.py", "io/masks.py", "io/points.py", "io/driver.py",
            "io/smartmet.py"} <= names


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def _entry_points():
    from roadsurf_tpu_torch import interop, model, production, runner
    conv = ("to_torch", "point_params", "raw_forcing", "state", "prepared",
            "coupling_vars", "packed")
    return ([model.Model, production.StationExpander,
             production.GridExpander, production.CompositeExpander,
             production.run_production, production.run_production_coupled,
             runner.run, runner.run_production_config]
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


def _device_list_entry_points():
    from roadsurf_tpu_torch import production
    from roadsurf_tpu_torch.parallel import sharding
    return [production.run_production, production.run_production_coupled,
            sharding.scan_sharded, sharding.make_mesh]


@pytest.mark.parametrize("fn", _device_list_entry_points(),
                         ids=lambda f: f.__name__)
def test_device_lists_default_to_the_visible_cards(fn):
    """``devices`` defaults to None on every entry point that takes a
    device list, and None means every visible CUDA device: where there is
    none it is an error, never the CPU.  (Only an expander that the caller
    built on the CPU runs there without a list.)"""
    import inspect
    from roadsurf_tpu_torch import production
    from roadsurf_tpu_torch.parallel import sharding
    assert inspect.signature(fn).parameters["devices"].default is None
    if torch.cuda.is_available():
        mesh = sharding.make_mesh(None)
        assert len(mesh) == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh.devices)
        assert production._run_devices(None, "cuda").devices == mesh.devices
        return
    with pytest.raises(RuntimeError, match="every visible CUDA device"):
        sharding.make_mesh(None)
    with pytest.raises(RuntimeError, match="every visible CUDA device"):
        production._run_devices(None, torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="every visible CUDA device"):
        sharding.scan_sharded([torch.zeros(24, 128)], [torch.zeros(16, 128)],
                              [torch.zeros(4, 16, 128)], None, None, None)
    # the caller's own CPU choice: one block there
    assert production._run_devices(None, "cpu").devices == [
        torch.device("cpu")]
    assert [d.type for d in sharding.make_mesh(["cpu"] * 3).devices] == [
        "cpu"] * 3


def test_sharded_launch_refuses_cpu_blocks():
    """The C++ sharded launch takes CUDA blocks or raises: nothing gives
    way to the plain version."""
    from roadsurf_tpu_torch.ops import scan_kernel as sk
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sk.scan_cuda_sharded([torch.zeros(24, 128)], [torch.zeros(16, 128)],
                             [torch.zeros(4, 16, 128)], None, None, None,
                             [None])


def test_matcher_is_exact():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("roadsurf_tpu") and _forbidden("roadsurf_tpu.model")
    assert not _forbidden("roadsurf_tpu_torch")
    assert not _forbidden("roadsurf_tpu_torch.model")
    assert not _forbidden("jaxlib_free")
