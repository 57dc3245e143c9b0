"""The port's coupled run over a grid forecast with station obs
(``run_production_coupled`` through a CompositeExpander: phases A and C
on the tile-major route, K3 with the in-kernel decay; phase B from the
composite's [wck, P] window) against the JAX package's
``run_production_coupled(interpret=True)``, float32 on both sides, at rtol
2e-4 / atol 2e-3 with equal failed masks (tests/test_production_grid.py:
216-318).  The inputs are tests/test_torch_production_grid.py's."""
import numpy as np
import pytest
import torch

from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from test_torch_production_grid import (_assert_match, _assert_same,
                                       _jax_reference, _setup)

torch.set_num_threads(1)


@pytest.mark.parametrize("out_stride", [1, 6])
def test_port_coupled_grid_matches_jax(out_stride):
    """Grid forecast + station obs, coupled: phases A and C through the
    tile-major route with the in-kernel decay, phase B from the composite's
    [wck, P] window (tests/test_production_grid.py:216-318)."""
    (_, texp, settings, cal, pts, state0), want = _jax_reference(
        "composite", coupled=True)
    assert (np.asarray(pts.coupling_end) >= 1).sum() > 500
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    metrics = tprod.RunMetrics()
    got = tprod.run_production_coupled(
        tm, texp, pts, cal, interop.state(state0, "cpu"), chunk_t=32,
        out_stride=out_stride, metrics=metrics)
    assert metrics.counters["coupling_reruns"] > 0
    _assert_match(got, want, out_stride)


@pytest.mark.parametrize("config", ["composite", "station_sky"])
def test_port_coupled_window_slices_equal_one_launch(config):
    """Phase B over point slices (a window budget of 0: each slice
    prepares its own points' window, from the expander's block of them)
    against one launch of the whole block, bit for bit: the grid + station
    composite and the stations with sky view, the routes whose window
    table is the points' prepared window."""
    _, texp, settings, cal, pts, state0 = _setup(
        config, T=49, use_coupling=True, with_jax=False)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    runs = []
    for budget in (4e9, 0):
        metrics = tprod.RunMetrics()
        runs.append(tprod.run_production_coupled(
            tm, texp, pts, cal, interop.state(state0, "cpu"), chunk_t=32,
            metrics=metrics, wcache_bytes=budget))
        assert metrics.counters["coupling_window_cached"] == (budget > 0)
        assert metrics.counters["coupling_points"] > 0
    _assert_same(*runs)
