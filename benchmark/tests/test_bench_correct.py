"""The comparison that decides ``correct``, on the CPU at the sizes of
``conftest.SMALL`` (64 points, 601 steps a cycle).

* The reference agrees with the program's CPU plain path: a whole run
  (set-up, warm-up cycle, one window cycle, the comparison) comes out
  correct, far inside the limits.
* The control, the reference in bfloat16 in the program's place, comes
  out not correct.
* A run whose timed path is broken underneath comes out not correct, for
  each fault a one-card forecast cycle can have: a cycle that returns its
  state unchanged, half of the points left out, an answer altered where
  it is produced.  (The exchange between chips does not exist on one
  card.)
"""
import numpy as np
import pytest
import torch

from benchmark import check, control, manifest, run
from benchmark.tests.conftest import SMALL

CELLS = sorted(SMALL)
SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")


def measure(cell, fault=None, seed=SEED):
    return run.measure(cell, seed, 0.0, False, CPU, sizes=SMALL[cell],
                       fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell):
    res = measure(cell)
    numbers = {n: c["value"] for n, c in res["checks"].items()}
    assert res["correct"], res["checks"]
    # float32 against float64 over a 5-hour cycle: far inside the limits
    assert numbers["tsurf_K"] < 1e-3
    assert numbers["storage_mm"] < 1e-3
    assert numbers["profile_K"] < 1e-2
    assert numbers["failed_points"] == 0
    assert res["attempted"] == 1
    assert list(res["checks"]) == list(check.NUMBERS)
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = control.readings(cell, SEED, sizes=SMALL[cell])
    assert r["fails"], r["numbers"]


def unchanged(cycle):
    """Each cycle returns its state as it came in, and rows of it."""
    def f(dep, state, metrics):
        res = cycle(dep, state, metrics)
        host = type(res.state)(*(x.detach().cpu() for x in state))
        n_out = len(res.out_steps)
        same = {"tsurf": host.tsurf_ave, "wat": host.wat, "snow": host.snow,
                "ice": host.ice, "ice2": host.ice2, "dep": host.dep}
        fields = {n: np.repeat(same[n].numpy()[None].astype(np.float32),
                               n_out, axis=0) for n in res.fields}
        return res._replace(state=host, fields=fields)
    return f


def half(cycle):
    """The second half of the points never computed: their rows and final
    state stay as allocated (zeros)."""
    def f(dep, state, metrics):
        res = cycle(dep, state, metrics)
        P = res.fields["tsurf"].shape[1]
        fields = {n: v.copy() for n, v in res.fields.items()}
        for v in fields.values():
            v[:, P // 2:] = 0.0
        st = type(res.state)(*(torch.cat([x[:P // 2],
                                          torch.zeros_like(x[P // 2:])])
                               for x in res.state))
        return res._replace(state=st, fields=fields)
    return f


def altered(cycle):
    """One output row's road temperature 0.25 K off where it is made."""
    def f(dep, state, metrics):
        res = cycle(dep, state, metrics)
        fields = {n: v.copy() for n, v in res.fields.items()}
        fields["tsurf"][len(res.out_steps) // 2] += 0.25
        return res._replace(fields=fields)
    return f


@pytest.mark.parametrize("fault", [unchanged, half, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault):
    res = measure(cell, fault=fault)
    assert not res["correct"], res["checks"]


def test_a_large_seed_gives_the_same_sizes():
    """Seeds past 32 bits draw the same shapes: the kept points and the
    warm start's draws differ, their count does not."""
    a = check.sample_points(2 ** 33 + 5, 3, 1024, 8)
    b = check.sample_points(7, 3, 1024, 8)
    assert len(a) == len(b) == 8 and not np.array_equal(a, b)
    tr = manifest.traffic("coupled")
    from benchmark import warm
    d = warm.draws(2 ** 33 + 5, 3, 100, "cpu", tr["warm_start"])
    assert d["tsurf_K"].abs().max() <= tr["warm_start"]["tsurf_K"]
    assert (d["snow_mm"] >= 0).all()
