"""The port's host grid extraction (``roadsurf_tpu_torch.io.gridsource``)
against the JAX package's (``roadsurf_tpu.io.gridsource``) on the same
numpy inputs, at 1e-12 (the JAX side may extract through its native
library, expression-identical up to rounding): the cases of
tests/test_gridsource.py:34-131 (corners, descending latitudes, a missing
corner, points outside the grid, the gap cap, the tie to the later sample)
and a seeded random grid through every function."""
import numpy as np
import pytest
import torch

from roadsurf_tpu.io import gridsource as jgs
from roadsurf_tpu_torch.io import gridsource as tgs

torch.set_num_threads(1)

MISSING = -9999.9
TOL = dict(rtol=1e-12, atol=1e-12)

LATS = np.array([60.0, 61.0])
LONS = np.array([24.0, 25.0])
SPATIAL = [
    ("corners", np.array([[1.0, 2.0], [3.0, 4.0]]), LATS, LONS,
     np.array([60.0, 61.0, 60.5]), np.array([24.0, 25.0, 24.5])),
    ("descending", np.array([[3.0, 4.0], [1.0, 2.0]]), LATS[::-1], LONS,
     np.array([60.0, 61.0]), np.array([24.0, 24.0])),
    ("missing_corner", np.array([[1.0, MISSING], [3.0, 5.0]]), LATS, LONS,
     np.array([60.5]), np.array([24.5])),
    ("outside", np.ones((2, 2)), LATS, LONS, np.array([59.0, 62.0, 60.5]),
     np.array([24.5, 24.5, 26.0])),
    ("time_major", np.stack([np.full((2, 2), 1.0), np.full((2, 2), 2.0)]),
     LATS, LONS, np.array([60.5]), np.array([24.5])),
]


@pytest.mark.parametrize("case", SPATIAL, ids=[c[0] for c in SPATIAL])
@pytest.mark.parametrize("fn", ["bilinear_at_points",
                                "nearest_corner_at_points"])
def test_spatial_matches_jax(case, fn):
    _, field, lats, lons, plat, plon = case
    got = getattr(tgs, fn)(field, lats, lons, plat, plon)
    want = getattr(jgs, fn)(field, lats, lons, plat, plon)
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, want, **TOL)


H = 3600
TEMPORAL = [
    ("basic_exact", [0, H, 2 * H], [0, H // 2, H], [1.0, 3.0, 5.0]),
    ("skips_missing", [0, H, 2 * H], [H], [1.0, MISSING, 5.0]),
    ("gap_cap", [0, 4 * H], [H], [1.0, 5.0]),
    ("at_cap", [0, 3 * H], [H], [1.0, 4.0]),
    ("before_start", [H, 2 * H], [0, H], [2.0, 4.0]),
    ("after_end", [0, H], [H, 2 * H], [2.0, 4.0]),
    ("tie_later", [0, H], [1800, 1700, 1900], [1.0, 2.0]),
    ("no_missing_search", [0, H, 2 * H], [3000], [1.0, MISSING, 5.0]),
]


@pytest.mark.parametrize("case", TEMPORAL, ids=[c[0] for c in TEMPORAL])
@pytest.mark.parametrize("fn", ["interpolate_gapped", "nearest_gapped"])
def test_temporal_matches_jax(case, fn):
    _, rt, st, vals = case
    args = (np.asarray(rt, np.int64), np.asarray(st, np.int64),
            np.asarray(vals))
    got = getattr(tgs, fn)(*args)
    np.testing.assert_allclose(got, getattr(jgs, fn)(*args), **TOL)


def test_is_missing_matches_jax():
    a = np.array([0.0, -9000.0, -8999.0, np.nan, MISSING, 5.0])
    np.testing.assert_array_equal(tgs._is_missing(a), jgs._is_missing(a))


def test_random_grid_pipeline_matches_jax():
    """A seeded [K, ny, nx] grid with missing cells, one all-missing sample
    and a 4-hour hole, descending latitudes and points partly off the grid,
    through both spatial extractions and timeseries_at_points (the clamps
    and the Tdew/RH completion from each side)."""
    rng = np.random.default_rng(17)
    hours = np.array([0, 1, 2, 3, 4, 8, 9, 10, 11, 12], np.int64)
    times = 1575244800 + 3600 * hours
    K, ny, nx, P = len(times), 5, 6, 300
    lats = np.linspace(61.0, 60.0, ny)
    lons = np.linspace(24.0, 25.5, nx)
    shp = (K, ny, nx)
    fields = {
        "tair": -3.0 + rng.normal(0, 2.0, shp),
        "rhz": np.clip(85.0 + rng.normal(0, 30.0, shp), -20, 140),
        "tdew": -6.0 + rng.normal(0, 2.0, shp),
        "prec": np.where(rng.random(shp) < 0.2,
                         rng.uniform(0, 150.0, shp), 0.0),
        "prec_phase": rng.integers(0, 4, shp).astype(float),
    }
    for name in fields:
        fields[name] = np.where(rng.random(shp) < 0.15, MISSING,
                                fields[name])
    fields["tdew"][3:6] = MISSING            # completion from RH there
    fields["rhz"][6] = MISSING               # completion from Tdew there
    fields["tair"][2] = MISSING
    plat = 59.9 + rng.uniform(0, 1.3, P)
    plon = 23.9 + rng.uniform(0, 1.8, P)
    sim = times[0] + 300 * np.arange(160, dtype=np.int64)
    pv_t, pv_j = {}, {}
    for name, f in fields.items():
        fn = ("nearest_corner_at_points" if name == "prec_phase"
              else "bilinear_at_points")
        pv_t[name] = getattr(tgs, fn)(f, lats, lons, plat, plon).T
        pv_j[name] = getattr(jgs, fn)(f, lats, lons, plat, plon).T
        np.testing.assert_allclose(pv_t[name], pv_j[name], err_msg=name,
                                   **TOL)
    got = tgs.timeseries_at_points(times, pv_t, sim)
    want = jgs.timeseries_at_points(times, pv_j, sim)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOL)
    assert (got["rhz"] > 100.0).sum() == 0
    assert ((got["prec"] > 100.0) & (got["prec"] > -9000.0)).sum() == 0


@pytest.mark.parametrize("sel", [[0], [200], [47, 48], [0, 100, 239],
                                 list(range(240)), [239, 3, 3, 130]],
                         ids=["first", "last", "pair", "spread", "all",
                              "unsorted"])
def test_host_at_extracts_only_the_rows_it_needs(sel):
    """``GridExpander.host_at`` extracts only the raw rows within the gap
    cap of the selected steps and one more on either side; its values
    equal the whole series' pipeline bit for bit, prec_phase's nearest
    pick and a missing-sample search that crosses the window's edge
    included (irregular raw times, gaps over the cap, missing runs)."""
    from roadsurf_tpu_torch import production
    rng = np.random.default_rng(8)
    times = 1575244800 + np.cumsum(rng.choice([1200, 3600, 4 * 3600], 30,
                                              p=[0.3, 0.6, 0.1]))
    lats, lons = np.linspace(60.0, 61.0, 4), np.linspace(24.0, 25.5, 5)
    shp = (len(times), 4, 5)
    fields = {"tair": rng.normal(-2.0, 3.0, shp),
              "rhz": rng.uniform(60.0, 110.0, shp),
              "vz": rng.uniform(0.0, 8.0, shp),
              "prec_phase": rng.integers(0, 4, shp).astype(float)}
    for name in fields:
        fields[name] = np.where(rng.random(shp) < 0.25, MISSING,
                                fields[name])
    fields["tair"][10:13] = MISSING                # a run over the cap
    P = 256
    plat = 59.95 + rng.uniform(0, 1.1, P)
    plon = 23.95 + rng.uniform(0, 1.6, P)
    sim = times[0] - 1800 + 600 * np.arange(240, dtype=np.int64)
    exp = production.GridExpander(times, lats, lons, fields, plat, plon,
                                  sim, "cpu", chunk_t=16, extract="host")
    names = ("tair", "tdew", "rhz", "vz", "prec_phase")
    got = exp.host_at(np.asarray(sel), names)
    pv = {n: (tgs.nearest_corner_at_points if n == "prec_phase"
              else tgs.bilinear_at_points)(f, lats, lons, plat, plon).T
          for n, f in fields.items()}
    want = tgs.timeseries_at_points(times, pv, sim[np.asarray(sel)])
    for n in names:
        w = want.get(n, np.full(got[n].shape, MISSING))
        assert got[n].dtype == w.dtype, n
        np.testing.assert_array_equal(got[n], w, err_msg=n)
