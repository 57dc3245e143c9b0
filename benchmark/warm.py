"""Each cycle's warm start, made from the seed and the cycle's index.

A forecast service starts each cycle from the state the last one left (the
runner's ``--checkpoint-in``).  Here each cycle's state is the cold start
changed by draws of its own: the ground profile and the surface
temperature shifted by ``tsurf_K`` at most, and water, snow and ice laid
on the road, up to ``wat_mm``, ``snow_mm`` and ``ice_mm``.  So no two
cycles of a run have the same inputs, and none can be served from another.
The draws are made on the run's device in one call; the program and the
reference apply the same values to their own cold start.
"""
from __future__ import annotations

from typing import Dict

import torch

#: the draws of one cycle, in this order
NAMES = ("tsurf_K", "wat_mm", "snow_mm", "ice_mm")


def draws(seed: int, cycle: int, n: int, device, amp: Dict[str, float]):
    """{name: float32 [n]} of cycle ``cycle``: ``tsurf_K`` uniform in
    [-amp, amp], the storages uniform in [0, amp]."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(cycle) * 7919 + 17) % 2 ** 63)
    u = torch.rand((len(NAMES), n), generator=g, device=device,
                   dtype=torch.float32)
    out = {}
    for i, name in enumerate(NAMES):
        a = float(amp.get(name, 0.0))
        out[name] = (2.0 * u[i] - 1.0) * a if name == "tsurf_K" else u[i] * a
    return out


def apply(state, d: Dict[str, torch.Tensor]):
    """``state`` (the program's or the reference's ``State``) with the draws
    ``d`` applied: the ground nodes 1..N and the surface average shifted,
    the storages added.  The air node 0 and the climatological bottom node
    stay as they are."""
    dt = state.tmp.dtype
    put = lambda x: x.to(device=state.tmp.device, dtype=dt)
    tmp = state.tmp.clone()
    tmp[..., 1:-1] += put(d["tsurf_K"])[..., None]
    return state._replace(
        tmp=tmp,
        tsurf_ave=state.tsurf_ave + put(d["tsurf_K"]),
        wat=state.wat + put(d["wat_mm"]),
        snow=state.snow + put(d["snow_mm"]),
        ice=state.ice + put(d["ice_mm"]))
