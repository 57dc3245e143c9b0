"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: builds the
hand-written scan kernel (K1, point-major; K2, slim; K3, tile-major; K3
fused, tile-major with the forcing prepared in the kernel from the raw
series: modes of one source), its sharded launch (K4) and the coupling
window kernel (K5, phase B of the coupled run, and K5 fused, its form
that prepares the window's forcing in the kernel) from this checkout,
holds each against its plain torch version, drives the station-fed
production forecast end to end at 1,048,576 points x 8,881 steps (the
operational 74-hour run at dt 30 s), uncoupled and observation-coupled, and the NWP-grid and
grid+station forecasts with sky view at the same size, then the same
forecasts over several point blocks and over two processes, then the
runner CLI end to end on the example generators' inputs, and prints a
JSON summary.

    python3 chip_smoke.py            # every phase (one card)
    python3 chip_smoke.py 3c 4c      # only the named phases, no summary
    python3 chip_smoke.py 3w 9d      # K5 and K5 fused alone, and the
                                     # shipped coupled example1 config
                                     # through the CLI
    python3 chip_smoke.py 3f 3w 7s   # the fused kernels at 16,384 points
                                     # and a sub-hourly grid at full width
    python3 chip_smoke.py 3w 6 --variant lb8=build/lb8/scan_kernel.cu
                                     # K5 from an edited copy beside this
                                     # build, on 3w's and phase 6's inputs
    python3 chip_smoke.py 3d 8 8b    # the sharded launch and paths alone
    python3 chip_smoke.py 3e --variant old=build/old/scan_kernel.cu
                                     # another source of the kernel beside
                                     # this one, both orders, in turns
    python3 chip_smoke.py 3c 7w 7s --stage 16
                                     # the fused kernels at a stage width
                                     # of 16 beside the rule's, in turns
    python3 chip_smoke.py 2s         # the fused time loops' SASS by part
                                     # of the in-kernel prep (this build's
                                     # and each --variant source's)

Phases (each fails the run on any error; nothing falls back to the CPU or to
the plain version):

 1. toolchain and device: torch, CUDA, nvcc, the card's name and power limit;
 2. build csrc/scan_kernel.cu for sm_90a (ops/build.py), with ptxas's
    register, stack-frame and spill counts and the SASS instruction counts
    (cuobjdump: the body, the time loop, the boundary-layer loop) of every
    instantiation;
 3. K1 against scan_reference on the card: 65,536 points x 128 steps (two
    scenarios, output stride 1 and 4, one chunk with a global offset and
    nsteps < T; the same chunk for each setting in VARIANTS, so every
    template instantiation and physics branch runs), then one main-path
    chunk of 1,048,576 points x 64 steps (stride 120, offset 448) with both
    timed;
 3b. K2 against scan_reference on the card: 65,536 points x 128 steps,
    slim without the coefficient decay, and slim with it on an offset chunk
    that crosses window ends, holds the run's last step and has
    nsteps < T; K2 with the decay against K1 fed forcing.cof_window's rows,
    bit for bit; then one 1,048,576 x 64 chunk of each mode from the
    coupled configuration of phase 6, timed beside the plain version;
 4. run_production (station-level prepared channels; K2, and K1 with
    slim=False) against the port's Model.run on the card: 8,192 points, 64
    stations, some out of radius, 97 steps, (chunk_t, out_stride) = (32, 6)
    and (16, 7);
 4b. run_production_coupled against the port's Model.run_coupled (the
    per-point-PC engine) on the card: the same stations and points, window
    [11, 40] with an obs target below the air temperature, the same
    (chunk_t, out_stride) pairs; kernel tolerances, equal failed masks;
 5. the main path at full size: 2,048 stations -> 1,048,576 points, 8,881
    steps, hourly output, chunk 64, through K2 (the default) and through
    K1 (slim=False), each at production.PIPELINE_DEPTH 1 and 2 (held to
    each other bit for bit; per run the stream and output seconds, the
    card's busy share of the stream from CUDA events, the host's issue,
    wait and row-copy milliseconds a chunk, the peak memory); kernel
    launches counted over each run; the K2 run
    (its block in station order) against a run whose caller passes the
    points in station order (the block's sort then the identity), mapped
    through that order, bit for bit; a 64-point
    sample re-run through Model.run over the whole horizon in float32 and
    float64, the kernel path held to twice the float32 run's error against
    float64;
 6. the coupled main path at full size: phase 5's stations and points with
    relaxation and a 180-minute coupling window ending in the last 20
    minutes of a 24 h analysis, every 7th station without obs:
    run_production_coupled (phase A and C through K2, phase B through K5,
    its seconds, the steps of its slowest lane and K5's launches printed;
    K5 timed again on the run's own window inputs, and its plain version
    run on the first 65,536 points of them, against the run's own K5
    results and the new launch's, bit for bit; K5's bound from the run's
    lane steps at the boundary-layer iterations a step that plain
    version counted), with a 64-point
    sample of coupled points re-run through Model.run_coupled on the host
    in float32 and float64 under the same bound;
 3w. K5 against window_reference on the card, bit for bit with equal
    failed masks: 32,768 points in station order over a 240-step run,
    30-step windows ending at staggered steps (every 5th at the last), obs
    below the air temperature so the control iterates, every 7th point
    without obs; output strides 1 and 7, with and without the output
    depth, on the station table and on the identity table (equal bit for
    bit); then K5 against the eager run_window_passes on the same card
    and inputs (max |err|, the points whose re-run count differs, bitwise
    or not); the steps of a lane and of its warp (the divergence factor);
    K5 and its plain version timed, with K5's bound.  Then K5 fused, on the
    coupled runs of 16,384 points x 140 steps (the timed grid case 65,536)
    of a grid, a grid + station composite with sky view (without and with
    relaxation) and stations with sky view, with and without the output
    depth (8-step windows from step 63, 16-step chunks: five window
    chunks), and the 8-channel grid on a 5-minute clock at 15 and 20
    layers, at 48-step chunks (SPAN 6) and at 192-step chunks over 360
    steps (SPAN 21, above the stage width, the window over two window
    chunks, the first holding several stages of segment lines; each
    launch's stage width, registers, blocks an SM and shared memory
    printed, the blocks what its registers allow): each run's phase B
    goes through one K5 fused launch and builds no window table; K5 fused
    on the inputs the run handed it, and the run's own results, against
    its plain version (window_reference on the window's eager table), bit
    for bit; the grid case timed beside its plain version and its bound;
 3c. K3 against its plain version and against K1 / K2 on the same values,
    bit for bit, at tile widths 128, 1024 and 8192: 65,536 points x 128
    steps, both channel sets, with and without the decay, on an offset
    chunk with nsteps < T that holds the run's last step; then one
    1,048,576 x 64 chunk of phase 7's grid forecast at each tile width,
    timed beside K2 on the same values.  K3 fused against the unfused route
    (the eager prep into K3) and its plain version (the eager prep into
    scan_reference), at the kernel tolerances with equal failed masks,
    each case reported bitwise or not: 16,384 points, a 128-step chunk at
    offset 40 with 100 steps and the run's last step, phase 7's grid with
    relaxation, phase 7b's composite (the offset chunk's series as its
    stations) with sky view, coupling and the decay, without and with
    relaxation, the stations alone with sky view at night and by day
    (3f, which runs alone when named), and the 8-channel grid on a 5-minute
    clock, 16,384 points at 256-step chunks (SPAN above the stage width:
    the segment lines in stages) at 15 and 20 layers, bit for bit, each
    launch's stage width, registers, blocks an SM (what its registers
    allow) and shared memory printed; then one
    1,048,576 x 64 chunk of phase 7's grid, timed beside the unfused
    route's prep and K3 with K3 fused's bound;
 4c. the tile-major production path small on the card: 8,192 points, 97
    steps, (chunk_t, out_stride) = (32, 6) and (16, 7), for a grid, a
    grid+station composite and a station expander with sky view (each
    through K3 fused) and a grid under two station networks with sky view
    (a composite K3 fused does not take: K3 on the eager prep), uncoupled
    and coupled (the coupling window and obs from last_valid_scan of the
    merged obs), each through its own route and the generic K1 route,
    against Model.run / Model.run_coupled fed host_at's merged forcing and
    against each other; K3's launches count here;
 7. the NWP-grid forecast at full size through K3 fused (no prepare_window
    call), at PIPELINE_DEPTH 1 and 2 as phase 5's runs: the JAX package's
    grid
    configuration (tools/gen_production.py --grid-source: a 300 x 400 grid
    of 75 hourly samples over 59.6-70.1 N, 20.5-31.6 E, its field formulas
    at seed 7) at 1,048,576 points on a 1024 x 1024 raster, 8,881 steps,
    hourly output, chunk 64; a 64-point sample re-run through Model.run on
    forcing from io/gridsource on those points alone, under phase 5's
    bound, and held to the float32 Model.run at the kernel tolerances;
 7b. phase 7's grid overlaid by phase 5's 2,048 stations' road-surface
    obs, wind, direct shortwave and net longwave (the grid carries neither
    radiation component, and sky view reads both), with sky view 0.6 and
    U(0, 25) degree horizons on every third point, at the same size and
    under the same bounds, after its 1,048,576 x 64 chunk is held and timed
    as phase 7's in 3c; the float32 sample's tsurf error against float64
    is printed (the sun's time terms from the float64 Julian day);
 7w. phase 7's grid coupled at full size (180-minute windows ending in
    the last 20 minutes of a 24 h analysis, obs below the grid's air
    temperature, every 7th point without): phase B through K5 fused (no
    window table, one launch at the default 4 GB budget and at 0) against
    the table route (the points' prepared window, about 27 GB, through
    production._Engine.force_window_table) in one launch and over the
    point slices of the default budget, bit for bit, each run's wall,
    phase seconds, launches, window tables built and peak memory printed;
    K5 fused timed again at this size.
 7s. a sub-hourly NWP feed at full width: phase 7's grid resampled to a
    5-minute clock (8 channels, as 3w's wide grid) over 2,048 steps from
    08:00 UTC at 512-step chunks (SPAN above the stage width, printed),
    1,048,576 points: the uncoupled run through K3 fused (one launch a
    chunk, no prepare_window call; wall, stream, peak memory), its second
    chunk's K3 fused launch timed beside its bound and its first 65,536
    points held to the plain version bit for bit; then the coupled run of
    7w's window shape ending a 16 h analysis at midnight, phase B through
    one K5 fused launch at a budget of 0 (no window table; phase B, wall,
    peak), K5 fused timed again beside its bound and held to
    window_reference on its first 65,536 points bit for bit.

 3d. K4 against its plain version and against one launch: the offset chunk
    of phases 3b/3c (65,536 points x 128 steps) for K1, K2 with the decay
    and K3 (TP 1024), at 2, 4 and 8 blocks on the card, each block on a
    stream of its own (and, with more cards visible, one block a card):
    scan_sharded against one scan launch bit for bit, and at 2 blocks
    against scan_sharded_reference at the kernel tolerances with equal
    failed masks; then
    phase 5's 1,048,576 x 64 chunk (K2) in station order at 1, 2, 4 and 8
    blocks, with new outputs and into the caller's (out=, as the main
    path launches it), bit for bit against one launch, timed beside it in
    five rounds (each round one launch and every block count both ways in
    turn; the median and range of each, and of the host's seconds to
    issue each call);
 3e. K2 and K1 on phase 5's 1,048,576 x 64 station chunk in the caller's
    point order and in station order (a run's blocks sort their points by
    station, so a warp's lanes share a station and leave the boundary-layer
    loop together): the same kernel, the station-order results mapped back
    equal bit for bit, the boundary-layer iterations of a lane and of a
    warp (the divergence factor), both orders timed in turns, and the row
    gathers in both orders;
 8. the sharded main path at full width and depth: phase 5's station cell
    and phase 7b's grid + stations with sky view, each through
    run_production(devices=[the card] * 4) (or the visible cards) at
    PIPELINE_DEPTH 1 and 2 as phase 5's runs, each against the one-block
    run, bit for bit over every output row and the final
    state (the station one also against phase 5's station-order caller,
    mapped); phase 4b's coupled station case at 4 blocks against 1, bit for
    bit (phase B through K5 on each block); stream seconds, point-steps/s,
    launches and peak memory per device are printed;
 8b. two processes on the card: the script starts itself twice as a worker
    (rendezvous on 127.0.0.1, the gloo backend); each takes its
    host_point_range of the station cell at 1,048,576 points x 961 steps,
    output stride 120, runs run_production(drain="shard") on two blocks,
    writes its shard and a per-shard checkpoint into a temporary directory,
    and joins the failed-count reduction; the parent merges the shards,
    restores the checkpoints, and holds both to a one-process run bit for
    bit.  A worker that fails fails the run.

 9t. (only when named: python3 chip_smoke.py 9t) the measurement behind
    production.auto_chunk_t: phase 5's station stream (K2) at 1,048,576
    and at 65,536 points at chunk 32, 64, 128 and 256, two rounds in turns,
    stream seconds and peak device memory;
 9. the runner CLI end to end on inputs the two example generators write
    into a temporary directory: the native data-plane library built
    (make -C native) or not; 9a examples/example1/make_data.py --stations
    2048 --analysis 24 --forecast 50, example_config.json uncoupled at dt
    30 s with a 1024 x 1024 points.grid (8,881 steps, hourly output) run as
    runner.main(["-c", config, "-t", "20191202T0000"]) in this process,
    through K2 and K4; 9b examples/example2/make_data.py --ny 300 --nx 400
    --analysis 24 --forecast 50, grid_config.json with a 1024 x 1024
    points.grid and no mask, through K3 fused and K4; each with its
    runner phases, point-steps/s, time to first chunk, peak device memory
    and auto chunk length, 9a at PIPELINE_DEPTH 1 and 2 as phase 5's runs
    (the two runs' outputs and final states bit for bit; 9b at depth 2,
    whose route phase 7 holds at both), and a 64-point
    sample of the depth-2 run re-run through the
    runner's scan engine on the card (a points.coordinates config of those
    points) in float32 and float64, under phase 5's bound; 9c the same
    configurations at 2,048 stations or 64 x 64 points over 4 h at dt
    120 s on the card, kernel engine against scan engine at rtol 1e-4 / atol
    5e-3 with equal failed masks (example1 in stations mode with sky view,
    relaxation and coupling; example2 uncoupled and coupled), the JSON,
    npz and checkpoint files read back, a warm-start cycle, and python -m
    roadsurf_tpu_torch.runner in a process of its own;
 9d. (with 9, or named alone) 9a's inputs and raster under
    examples/example1/example_config.json as shipped (coupling and
    relaxation on, the 180-minute window; no sky-view files, keyed by
    station id), 1,048,576 points x 8,881 steps through K2, K5 and K4 at
    PIPELINE_DEPTH 2: the runner phases, phase B's seconds, time to first
    chunk, peak memory; its outputs and final state against the
    library-level run_production_coupled called on the arguments the
    runner handed it, bit for bit; a 64-point sample as 9a's.

``--variant LABEL=PATH`` (repeatable) builds another source of the kernel
(an earlier copy, or an edited one, put under the gitignored build/; its
FuseArgs must be this build's, which ops/build.py checks by size) into a
library of its own; phase 2s splits its fused time loops as this build's;
phases 3e (K1, K2), 3w and 6 (K5), 3c's grid chunk
(K3 fused), 7w (K5 fused) and 7s (K3 fused, K5 fused) print its ptxas and
SASS counts, hold it to this build bit for bit and time it in the same
turns.  ``--stage W`` (repeatable) does the same for this build's fused
kernels at the stage width W (a power of two) in place of
ops/scan_kernel.py:stage_width's, in 3c, 7w and 7s: the width of the
segment lines never changes a bit, only the blocks an SM and the lines
recomputed.

Every run_production launch goes through K4 (one sharded launch a chunk,
whatever the number of blocks), so K4's launches are counted over every
main-path run.  Phases run in the order 1, 2, 3, 3e, 3b, 3w, 3d, 4, 4b,
5, 6, 7 (with 3c and 3f before its run), 7w, 4c, 7b, 8, (9t,) 8b, 9
(9d first), 7s.  The 64-point sample
re-runs of phases 5, 6, 7 and 7b are plain torch on the host, phase 9's
the scan engine on the card: each starts in worker processes when its
full-size run ends, runs beside the phases that follow, and is checked at
the end, and the streams of phases 5, 7, 8 and 9 at both depths are
summed up.  The last three lines of standard output are the kernel
summary (JSON), the card's name and power limit, and the device line
(JSON); with phases named on the command line they are not printed.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import importlib.util
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device "
                     "(torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import calendar as callib  # noqa: E402

from roadsurf_tpu_torch.config import ModelSettings  # noqa: E402
from roadsurf_tpu_torch.forcing import (Calendar, RawForcing,  # noqa: E402
                                        cof_window, valid_threshold)
from roadsurf_tpu_torch.io import gridsource  # noqa: E402
from roadsurf_tpu_torch.io import native, points, sources  # noqa: E402
from roadsurf_tpu_torch.io.synthetic import synthetic_raw  # noqa: E402
from roadsurf_tpu_torch.model import Model  # noqa: E402
from roadsurf_tpu_torch.observability import Progress, RunMetrics  # noqa: E402
from roadsurf_tpu_torch.ops import build  # noqa: E402
from roadsurf_tpu_torch.ops import scan_kernel as sk  # noqa: E402
from roadsurf_tpu_torch.ops import window_kernel as wk  # noqa: E402
from roadsurf_tpu_torch import coupling  # noqa: E402
from roadsurf_tpu_torch import production, runner  # noqa: E402
from roadsurf_tpu_torch.io import writer  # noqa: E402
from roadsurf_tpu_torch.parallel import distributed, sharding  # noqa: E402
from roadsurf_tpu_torch.tools import sass  # noqa: E402
from roadsurf_tpu_torch.forcing import relax_anchors  # noqa: E402
from roadsurf_tpu_torch.state import (PointParams, State,  # noqa: E402
                                      default_point_params)

DEV = torch.device("cuda", 0)
# tests/test_pallas_step.py:47-57 (tsurf and the profile; the storages)
TOL_T = dict(rtol=2e-5, atol=2e-4)
TOL_S = dict(rtol=2e-5, atol=2e-3)
# settings that reach the kernel's other template instantiations (layer
# capacity 32; a global output depth) and physics branches (the flag
# combinations of tests/test_triad_lockstep.py:37-43)
VARIANTS = ({"tsurf_output_depth": 0.03}, {"nlayers": 20},
            {"nlayers": 20, "tsurf_output_depth": 0.5},
            {"force_snow_melting": True, "force_ice_melting": True},
            {"melting_can_change_temperature": False}, {"force_tsurf": True})
# tsurf's allowance for one storage run-out event between two float32 paths
# (a local jump of about 1e-3 K; PERF.md)
RUNOUT_T = 1e-3
# the tile widths K3 is held and timed at
TILE_WIDTHS = (128, 1024, 8192)
# NVIDIA's data sheet for one H100 SXM: HBM rate and the float32 rate
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# float32 operations of one point-step of the kernel, counted from
# csrc/scan_kernel.cu (each add, multiply, divide, min/max, sqrt, log and
# exp one operation; both arms of an arithmetic select): the step outside
# the layer loop and the boundary-layer loop, each stencil layer, each
# boundary-layer iteration, and the in-kernel coefficient decay
OPS_STEP = 141
OPS_LAYER = 26
OPS_BL_ITER = 25
OPS_DECAY = 10
# K3 fused's prep, counted from csrc/scan_kernel.cu:fused_prep the same way:
# float32 operations of every point-step (the wind floor, the sw_dir clamp,
# prec_step, the Koistinen interpretation, forcing_thermo), of each grid
# channel a point-step (grid_value), of each grid channel and segment a
# point per chunk (grid_segments), of a point-step whose sky view is active
# (the sun's per-point part and modify_radiation); float64 operations of a
# point-step with relaxation on (the decay, the three relaxed fields, the
# Koistinen interpretation), over the card's float64 rate
OPS_PREP = 29
OPS_GRID_CH = 3
OPS_SEGMENT = 7
OPS_SKY = 45
OPS_RELAX_F64 = 19
PEAK_F64_OPS_S = 34e12
T0 = time.perf_counter()


def log(msg):
    print(msg, flush=True)


#: sharded launches (K4) of the main-path runs, summed as each run is read
MAIN_PATH_K4 = [0]


def reset_counts():
    """Every launch count to 0, just before a main-path run."""
    sk.LAUNCHES = sk.LAUNCHES_SLIM = sk.LAUNCHES_TM = 0
    sk.LAUNCHES_TM_FUSED = sk.LAUNCHES_SHARDED = 0
    wk.LAUNCHES = wk.LAUNCHES_FUSED = 0


#: K5's launches of the main-path runs (phase 6 and 9d) and K5 fused's
#: (phase 7w's fused runs), summed as each run is read
MAIN_PATH_K5 = [0]
MAIN_PATH_K5F = [0]


def read_window_count(main_path=False, fused=False):
    """K5's launches (K5 fused's with ``fused``) since reset_counts, just
    after a coupled run; it fails where the run launched none of them, or
    any of the other.  ``main_path``: add them to MAIN_PATH_K5 (or
    MAIN_PATH_K5F)."""
    n, other = ((wk.LAUNCHES_FUSED, wk.LAUNCHES) if fused
                else (wk.LAUNCHES, wk.LAUNCHES_FUSED))
    name = "K5 fused" if fused else "K5"
    assert n > 0, f"the coupled run launched no window kernel ({name})"
    assert other == 0, f"the coupled run launched the other window kernel"
    if main_path:
        (MAIN_PATH_K5F if fused else MAIN_PATH_K5)[0] += n
    return n


def read_counts(n_chunks=None):
    """(K1, K2, K3, K3 fused) launches since reset_counts, just after a
    main-path run; the run's sharded launches (one a chunk, whatever its
    blocks) go to MAIN_PATH_K4."""
    if n_chunks is not None:
        assert sk.LAUNCHES_SHARDED == n_chunks, (sk.LAUNCHES_SHARDED,
                                                 n_chunks)
    assert sk.LAUNCHES_SHARDED > 0
    MAIN_PATH_K4[0] += sk.LAUNCHES_SHARDED
    return (sk.LAUNCHES, sk.LAUNCHES_SLIM, sk.LAUNCHES_TM,
            sk.LAUNCHES_TM_FUSED)


class PrepCalls:
    """Counts forcing.prepare_window's calls from the production engine
    while in the block (the fused route makes none)."""

    def __enter__(self):
        self.n = 0
        self._orig = production.prepare_window

        def counted(*a, **k):
            self.n += 1
            return self._orig(*a, **k)
        production.prepare_window = counted
        return self

    def __exit__(self, *exc):
        production.prepare_window = self._orig


class WindowTables:
    """Counts ``_Engine.window_table``'s calls (the window's eager table,
    which K5 fused never builds) while in the block."""

    def __enter__(self):
        self.n = 0
        self._orig = orig = production._Engine.window_table

        def counted(eng, *a, **k):
            self.n += 1
            return orig(eng, *a, **k)
        production._Engine.window_table = counted
        return self

    def __exit__(self, *exc):
        production._Engine.window_table = self._orig


@contextlib.contextmanager
def window_table_route():
    """Phase B of the K3 fused routes on the window's eager table (the
    reference K5 fused is held to) in the block."""
    production._Engine.force_window_table = True
    try:
        yield
    finally:
        production._Engine.force_window_table = False


class StreamProbe:
    """The card's busy time over the production runs made in the block:
    CUDA events on each block's stream around its chunk forcing
    (``_Engine.kernel_inputs``) and around every sharded launch; the busy
    time is the union of those spans on the card's clock (the forcing's
    kernels and the launch are each issued in one go, so a span holds no
    wait for the host).  The drain's copies are not counted."""

    def __enter__(self):
        self.spans = []
        new = lambda: torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        self.ref = new()
        self.ref.record()
        self._orig = inputs, launch = (production._Engine.kernel_inputs,
                                       sharding.scan_sharded)

        def timed_inputs(eng, *a, **k):
            e0 = new()
            e0.record()
            res = inputs(eng, *a, **k)
            e1 = new()
            e1.record()
            self.spans.append((e0, e1))
            return res

        def timed_launch(*a, **k):
            mesh = sharding.make_mesh(a[6] if len(a) > 6 else k["devices"])
            streams = [mesh.stream(b) for b in range(len(mesh))]
            starts = [new() for _ in streams]
            for e, s in zip(starts, streams):
                e.record(s)
            res = launch(*a, **k)
            for e0, s in zip(starts, streams):
                e1 = new()
                e1.record(s)
                self.spans.append((e0, e1))
            return res
        production._Engine.kernel_inputs = timed_inputs
        sharding.scan_sharded = timed_launch
        return self

    def __exit__(self, *exc):
        production._Engine.kernel_inputs, sharding.scan_sharded = self._orig

    def busy_s(self) -> float:
        torch.cuda.synchronize()
        spans = sorted((self.ref.elapsed_time(a), self.ref.elapsed_time(b))
                       for a, b in self.spans)
        busy, end = 0.0, -np.inf
        for lo, hi in spans:
            if hi > end:
                busy += hi - max(lo, end)
                end = hi
        return busy / 1e3


def stream_line(label, depth, m, probe, peak, wall=None):
    """One run's stream at one pipeline depth: walls, the card's busy share
    of the stream, the host's issue, wait and row-copy seconds a chunk, the
    output phase and the peak memory.  Returns the figures as a dict."""
    c = m.counters
    n = int(c["stream_chunks"])
    stream = m.phases["stream"]
    fig = dict(depth=depth, wall=wall, stream=stream,
               output=m.phases["output"], busy=probe.busy_s(),
               issue_ms=1e3 * c["stream_issue_s"] / n,
               wait_ms=1e3 * c["stream_wait_s"] / n,
               rows_ms=1e3 * c["stream_rows_s"] / n, chunks=n,
               peak=peak / 2**30)
    log(f"  [{card_line()}] {label}, PIPELINE_DEPTH {depth}: "
        + (f"wall {wall:.3f} s, " if wall is not None else "")
        + f"stream {stream:.3f} s, output {fig['output']:.3f} s; card busy "
        f"{fig['busy']:.3f} s = {100 * fig['busy'] / stream:.1f}% of the "
        f"stream; host a chunk ({n} chunks): issue {fig['issue_ms']:.3f} "
        f"ms, wait {fig['wait_ms']:.3f} ms, rows to step order "
        f"{fig['rows_ms']:.3f} ms; peak device memory "
        f"{fig['peak']:.2f} GiB")
    return fig


@contextlib.contextmanager
def pipeline_depth(depth):
    """production.PIPELINE_DEPTH set to ``depth`` in the block."""
    old = production.PIPELINE_DEPTH
    production.PIPELINE_DEPTH = depth
    try:
        yield
    finally:
        production.PIPELINE_DEPTH = old


#: every stream_line of the run, by label
STREAMS = {}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()


def check_close(name, got, want, tol):
    """Assert |got - want| <= atol + rtol |want| elementwise (NaN equal
    NaN); return the largest absolute error over finite pairs."""
    got, want = got.double(), want.double()
    both_nan = torch.isnan(got) & torch.isnan(want)
    err = (got - want).abs()
    bad = ~both_nan & ~(err <= tol["atol"] + tol["rtol"] * want.abs())
    if bool(bad.any()):
        idx = bad.nonzero()[0].tolist()
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside {tol}; first at "
            f"{idx}: got {got[tuple(idx)].item()!r} want "
            f"{want[tuple(idx)].item()!r}")
    finite = torch.isfinite(err)
    return float(err[finite].max()) if bool(finite.any()) else 0.0


def compare_scan(label, got, want, nlayers):
    """Kernel vs plain results: profile, outputs, equal failed masks."""
    tmp_g, scal_g, out_g = got
    tmp_w, scal_w, out_w = want
    errs = [check_close(f"{label} tmp", tmp_g[:nlayers + 2],
                        tmp_w[:nlayers + 2], TOL_T),
            check_close(f"{label} tsurf", out_g[:, 0], out_w[:, 0], TOL_T)]
    for k, name in enumerate(("wat", "snow", "ice", "ice2", "dep"), 1):
        errs.append(check_close(f"{label} {name}", out_g[:, k], out_w[:, k],
                                TOL_S))
    if not torch.equal(scal_g[sk.R_FAILED], scal_w[sk.R_FAILED]):
        raise AssertionError(f"{label}: failed masks differ")
    return max(errs)


def assert_bitwise(label, got, want):
    """K2 with the in-kernel decay against K1 fed cof_window's rows: the
    same bits everywhere (the NaN of the padded profile rows included)."""
    for name, g, w in zip(("tmp", "scal", "out"), got, want):
        n_diff = int((g.view(torch.int32) != w.view(torch.int32)).sum())
        if n_diff:
            raise AssertionError(
                f"{label}: {n_diff} elements of {name} differ, max |diff| "
                f"{float((g - w).abs().max()):.3e}")
    log(f"  {label}: equal bit for bit")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def scan_bound(args, kw, stats, nlayers):
    """(bound_ms, bound_by) of one kernel call: the larger of the bytes it
    must move over the card's HBM rate and the float32 operations these
    inputs need over the card's float32 rate (``stats`` from
    scan_reference: the point-steps run and their boundary-layer
    iterations; OPS_* above).  The bytes count only what the physics reads
    and writes, not the layout's padding: the forcing channels it reads
    (15 of K1's 16, the 11 slim ones) once per step, the L+3 profile rows
    and the 13 state rows read and written once, the aux rows and TRF read
    once, and 6 fields of each output row it writes."""
    tmp0, scal0, forc = args[:3]
    P = tmp0.shape[1]
    nsteps, off, stride = kw["nsteps"], kw["out_offset"], kw["out_stride"]
    rows = len(range(-(-off // stride) * stride, off + nsteps, stride))
    n_ch = sk.NCH_SLIM if forc.shape[-2] == sk.NCH_SLIM else sk.C_AIRVCAP + 1
    n_bytes = 4 * P * (n_ch * nsteps + 2 * (nlayers + 3 + sk.R_FAILED + 1)
                       + rows * 6)
    if kw.get("aux_rows") is not None:
        n_bytes += 4 * (kw["aux_rows"].numel() + nsteps)
    per_step = (OPS_STEP + OPS_LAYER * nlayers
                + (OPS_DECAY if kw.get("aux_cofs") else 0))
    n_ops = (stats["point_steps"] * per_step
             + stats["bl_iters"] * OPS_BL_ITER)
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * n_ops / PEAK_F32_OPS_S
    log(f"  bound: {n_bytes / 1e9:.3f} GB -> {t_bytes:.3f} ms at 3.35 TB/s; "
        f"{n_ops / 1e9:.2f} G f32 ops ({iterations(stats)}) -> "
        f"{t_ops:.3f} ms at 67 TFLOP/s")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def iterations(stats):
    """The boundary-layer iterations of scan_reference's ``stats``: a lane's
    and a warp's (the slowest of its 32 lanes) per point-step, and their
    ratio, the divergence factor."""
    lane = stats["bl_iters"] / stats["point_steps"]
    warp = stats["bl_warp_iters"] / stats["point_steps"]
    return (f"boundary-layer iterations a point-step: {lane:.3f} a lane, "
            f"{warp:.3f} issued by its warp, divergence factor "
            f"{warp / lane:.3f}")


def packed_inputs(model, npoints, sim_len, scenario, seed):
    """Packed kernel inputs from the port's own prep of synthetic forcing.
    The padded profile rows hold NaN, which neither version may read."""
    raw, cal = synthetic_raw(npoints, sim_len, seed=seed, scenario=scenario,
                             dtype=np.float32)
    pts = default_point_params(npoints)
    prep = model.prepare(raw, pts, cal)
    state = model.init(raw, cal, dtype=torch.float32)
    ones = torch.ones(prep.tair.shape, dtype=torch.float32, device=DEV)
    obs = torch.tensor(pts.coupling_tsurf, dtype=torch.float32, device=DEV)
    tmp0, scal0 = sk.pack_state(state)
    tmp0[model.settings.nlayers + 2:] = float("nan")
    return tmp0, scal0, sk.pack_forcing(prep, ones, ones, obs)


def phase_kernel_small(npoints=65536):
    max_err = 0.0
    off, stride, nsteps = 5, 4, 100
    n_out = len(range(-(-off // stride) * stride, off + nsteps, stride))
    partial = dict(out_stride=stride, nsteps=nsteps, out_offset=off,
                   n_out=n_out)
    runs = [("winter_mix", {}, [dict(out_stride=1), dict(out_stride=4),
                                partial]),
            ("cold_snow", {}, [dict(out_stride=1), dict(out_stride=4)])]
    runs += [("winter_mix", v, [partial]) for v in VARIANTS]
    for scenario, variant, cases in runs:
        model = Model(ModelSettings(sim_len=128, dt=30.0, **variant),
                      device=DEV)
        packed = packed_inputs(model, npoints, 128, scenario, seed=21)
        for kw in cases:
            got = sk.scan_cuda(*packed, model.cfg, model.params, model.grid,
                               **kw)
            torch.cuda.synchronize()
            want = sk.scan_reference(*packed, model.cfg, model.params,
                                     model.grid, **kw)
            label = f"{scenario} {variant or 'defaults'} {kw}"
            err = compare_scan(label, got, want, model.settings.nlayers)
            log(f"  kernel vs plain, {npoints} x 128, {label}: "
                f"max |err| {err:.3e}")
            max_err = max(max_err, err)
    return max_err


def phase_kernel_slim_small(npoints=65536, T=128):
    """K2 on 65,536 points x 128 steps: without the decay over the whole
    chunk; with it at global offset 40, 100 of 128 steps, in a run of 140
    steps (the chunk holds the lastValues step), window ends before and
    inside the chunk and at the last step.  The coupling flag is set at
    random, so the melting guard reads the obs aux row."""
    model = Model(ModelSettings(sim_len=T, dt=30.0), device=DEV)
    raw, cal = synthetic_raw(npoints, T, seed=21, scenario="winter_mix",
                             dtype=np.float32)
    prep = model.prepare(raw, default_point_params(npoints), cal)
    rng = np.random.default_rng(5)
    dev_f = lambda a: torch.tensor(np.asarray(a, np.float32), device=DEV)
    prep = prep._replace(in_coupling=torch.tensor(
        rng.random((T, npoints)) < 0.5, device=DEV))
    state = model.init(raw, cal, dtype=torch.float32)
    tmp0, scal0 = sk.pack_state(state)
    tmp0[model.settings.nlayers + 2:] = float("nan")
    forc, trf = sk.pack_forcing_slim(prep)
    obs = dev_f(rng.uniform(-3.0, 1.0, npoints))
    off, nsteps, stride = 40, 100, 4
    t_total = off + nsteps
    cend = rng.integers(20, t_total, npoints)
    cend[::9] = -99
    cend[1::9] = t_total - 1
    aux = sk.pack_aux(obs, dev_f(rng.uniform(-0.4, 0.6, npoints)),
                      dev_f(rng.uniform(-0.4, 0.6, npoints)), dev_f(cend))
    trf_g = torch.zeros(off + T, dtype=torch.float32, device=DEV)
    trf_g[off:] = trf
    geo = dict(out_stride=stride, nsteps=nsteps, out_offset=off,
               n_out=len(range(-(-off // stride) * stride, off + nsteps,
                               stride)))
    cof_kw = dict(slim_trf=trf_g, aux_rows=aux, aux_cofs=True,
                  t_total=t_total,
                  cof_red=model.settings.coupling_effect_reduction)
    cases = [("slim", dict(out_stride=1, slim_trf=trf,
                           aux_rows=sk.pack_aux(obs))),
             ("slim + decay, offset chunk", dict(geo, **cof_kw))]
    max_err = 0.0
    args = (tmp0, scal0, forc, model.cfg, model.params, model.grid)
    for label, kw in cases:
        got = sk.scan_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = sk.scan_reference(*args, **kw)
        err = compare_scan(label, got, want, model.settings.nlayers)
        log(f"  K2 vs plain, {npoints} x {T}, {label}: max |err| "
            f"{err:.3e}")
        max_err = max(max_err, err)
    # the same chunk through K1 fed forcing.cof_window's rows (on the card)
    swc, lwc = cof_window(aux[0], aux[1], aux[2].to(torch.int32), off, T,
                          t_total, model.settings, torch.float32)
    k1_forc = sk.pack_forcing(prep._replace(trf_fric=trf_g[off:]), swc, lwc,
                              obs)
    k1 = sk.scan_cuda(tmp0, scal0, k1_forc, model.cfg, model.params,
                      model.grid, **geo)
    assert_bitwise(f"K2 + decay vs K1 fed cof_window, {npoints} x {T}",
                   got, k1)
    return max_err


def full_size_setup(metrics, S=2048, npoints=1048576, T=8881, chunk_t=64):
    """The operational configuration: 2,048 stations -> 1,048,576 points,
    8,881 steps of 30 s, hourly output (bench.py:130-148 at full length)."""
    t0 = time.perf_counter()
    raw_st, cal = synthetic_raw(S, T, dt=30.0, seed=7,
                                scenario="winter_mix", dtype=np.float32)
    rng = np.random.default_rng(7)
    st_idx = rng.integers(0, S, size=npoints)
    settings = ModelSettings(sim_len=T, dt=30.0, output_step_minutes=60,
                             use_relaxation=False)
    model = Model(settings, device=DEV)
    log(f"  synthetic station forcing [{S}, {T}] in "
        f"{time.perf_counter() - t0:.1f} s")
    ctx = {"st_pts": default_point_params(S + 1), "anchors": None,
           "settings": settings, "params": model.params, "hour": cal.hour,
           "t_total": T}
    with metrics.phase("expander"):
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                         chunk_t=chunk_t, prep_ctx=ctx)
        torch.cuda.synchronize()
    pts = default_point_params(npoints)
    first = RawForcing(**{n: exp.first_host[n][:, None]
                          for n in RawForcing._fields})
    with metrics.phase("init"):
        state0 = model.init(first, cal, dtype=torch.float32)
        torch.cuda.synchronize()
    return dict(model=model, exp=exp, pts=pts, cal=cal, state0=state0,
                raw_st=raw_st, st_idx=st_idx, chunk_t=chunk_t, T=T,
                npoints=npoints, ctx=ctx)


def coupled_full_setup(cfg, metrics, window_min=180, init_h=24):
    """Phase 5's stations and points with the reference's operating mode
    (examples/example1/example_config.json: relaxation and coupling on, a
    24 h analysis, a 180-minute coupling window): each station's last valid
    obs falls at a step drawn from the last 20 minutes of the analysis,
    coupling_end is that step and coupling_start 360 steps before it; the
    obs target is the station's air temperature there minus U(0.5, 2.5) K,
    so the control iterates; every 7th station has no obs.  Relaxation
    anchors at the end of the analysis.  Every point takes its station's
    values (the fast-path contract)."""
    raw_st, cal, st_idx, T = cfg["raw_st"], cfg["cal"], cfg["st_idx"], cfg["T"]
    S = raw_st.tair.shape[0]
    settings = ModelSettings(sim_len=T, dt=30.0, output_step_minutes=60,
                             use_relaxation=True, use_coupling=True,
                             coupling_minutes=window_min)
    model = Model(settings, device=DEV)
    il = int(init_h * 3600 / settings.dt)               # 2,880
    wl = settings.coupling_len_steps                     # 360
    rng = np.random.default_rng(17)
    end = rng.integers(il - 39, il + 1, S).astype(np.int32)   # [2841, 2880]
    rows = np.arange(S)
    obs = raw_st.tair[rows, end - 1] - rng.uniform(0.5, 2.5, S)
    no_obs = rows % 7 == 0
    obs = np.where(no_obs, -9999.9, obs)
    tsurf_obs = raw_st.tsurf_obs.copy()
    tsurf_obs[no_obs] = -9999.9
    raw_st = raw_st._replace(tsurf_obs=tsurf_obs)
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    st_pts = default_point_params(S + 1)._replace(
        init_len=np.full(S + 1, il, np.int32),
        tair_relax=app(raw_st.tair[rows, il] + 0.4, -9999.9),
        vz_relax=app(raw_st.vz[rows, il] + 0.1, -9999.9),
        rh_relax=app(raw_st.rhz[rows, il] - 2.0, -9999.9),
        coupling_start=app(np.where(no_obs, -99, end - wl), -99).astype(
            np.int32),
        coupling_end=app(np.where(no_obs, -99, end), -99).astype(np.int32),
        coupling_tsurf=app(obs, -9999.9))
    vz_a = raw_st.vz[:, :il].copy()
    vz_a[:, 0] = np.maximum(vz_a[:, 0], 0.4)
    anch_st = (app(raw_st.tair[rows, il - 1], -9999.9),
               app(vz_a[rows, il - 1], -9999.9),
               app(raw_st.rhz[rows, il - 1], -9999.9))
    ctx = {"st_pts": st_pts, "anchors": anch_st, "settings": settings,
           "params": model.params, "hour": cal.hour, "t_total": T}
    with metrics.phase("expander_coupled"):
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                         chunk_t=cfg["chunk_t"],
                                         prep_ctx=ctx)
        torch.cuda.synchronize()
    pts = default_point_params(len(st_idx))._replace(**{
        n: np.asarray(getattr(st_pts, n))[st_idx] for n in (
            "init_len", "tair_relax", "vz_relax", "rh_relax",
            "coupling_start", "coupling_end", "coupling_tsurf")})
    anchors = tuple(a[st_idx] for a in anch_st)
    first = RawForcing(**{n: exp.first_host[n][:, None]
                          for n in RawForcing._fields})
    state0 = model.init(first, cal, dtype=torch.float32)
    log(f"  coupled configuration: {int((~no_obs).sum())} of {S} stations "
        f"with obs, window ends in [{end.min()}, {end.max()}], "
        f"{wl} window steps, init_len {il}")
    return dict(cfg, model=model, exp=exp, pts=pts, state0=state0,
                raw_st=raw_st, anchors=anchors, st_pts=st_pts)


def phase_kernel_chunk(cfg):
    """One main-path chunk (1,048,576 points x 64 steps, stride 120,
    global offset 448), K1 and plain version timed on the card."""
    model = cfg["model"]
    eng = production._Engine(model, cfg["exp"], cfg["pts"], cfg["cal"],
                             cfg["state0"], chunk_t=cfg["chunk_t"])
    t0 = 7 * cfg["chunk_t"]
    forc = eng.chunk_forcing(t0)
    args = (eng.tmp0, eng.scal0, forc, model.cfg, model.params, model.grid)
    kw = dict(out_stride=eng.os_, nsteps=cfg["chunk_t"], out_offset=t0,
              n_out=eng.k_alloc)
    got = sk.scan_cuda(*args, **kw)
    torch.cuda.synchronize()
    stats = {}
    want = sk.scan_reference(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    err = compare_scan("1M chunk", got, want, model.settings.nlayers)
    scan_bound(args, kw, stats, model.settings.nlayers)
    ms = cuda_ms(lambda: sk.scan_cuda(*args, **kw), reps=10)
    plain_ms = cuda_ms(lambda: sk.scan_reference(*args, **kw), reps=2)
    rate = cfg["npoints"] * cfg["chunk_t"] / (ms * 1e-3)
    log(f"  K1 vs plain, {cfg['npoints']} x 64 main-path chunk: max |err| "
        f"{err:.3e}; kernel {ms:.3f} ms ({rate:.4g} point-steps/s), "
        f"plain {plain_ms:.1f} ms")
    # the other two layers of a stream chunk, for the time breakdown
    gather_ms = cuda_ms(lambda: eng.chunk_forcing(t0), reps=5)
    row = got[2][:1, :6]
    drain_ms = cuda_ms(lambda: row.cpu(), reps=5)
    log(f"  [{card_line()}] per K1 chunk: forcing gather {gather_ms:.3f} ms, "
        f"kernel {ms:.3f} ms, drain of one output row {drain_ms:.3f} ms")
    del forc, got, want, eng
    torch.cuda.empty_cache()
    return err, plain_ms


def phase_kernel_slim_chunk(cfg6):
    """One 1,048,576 x 64 chunk of each K2 mode from the coupled
    configuration: without the decay at offset 448 (phase A), with it at
    the first chunk past every window end (offset 2,944, phase C); kernel
    and plain version
    timed on the card, and the decay chunk against K1 fed cof_window."""
    model = cfg6["model"]
    eng = production._Engine(model, cfg6["exp"], cfg6["pts"], cfg6["cal"],
                             cfg6["state0"], anchors=cfg6["anchors"],
                             chunk_t=cfg6["chunk_t"])
    assert eng.slim
    rng = np.random.default_rng(3)
    cofs = tuple(torch.tensor(rng.uniform(-0.3, 0.3, eng.P_pad)
                              .astype(np.float32), device=DEV)
                 for _ in range(2))
    res, errs = {}, []
    ct = cfg6["chunk_t"]
    t0_c = (int(np.max(cfg6["pts"].coupling_end)) // ct + 1) * ct
    for label, t0, c in (("slim", 7 * ct, None), ("slim + decay", t0_c, cofs)):
        forc, skw = eng.kernel_inputs(t0, c)
        args = (eng.tmp0, eng.scal0, forc, model.cfg, model.params,
                model.grid)
        kw = dict(out_stride=eng.os_, nsteps=cfg6["chunk_t"], out_offset=t0,
                  n_out=eng.k_alloc, **skw)
        got = sk.scan_cuda(*args, **kw)
        torch.cuda.synchronize()
        stats = {}
        want = sk.scan_reference(*args, stats=stats, **kw)
        torch.cuda.synchronize()
        errs.append(compare_scan(f"1M {label} chunk", got, want,
                                 model.settings.nlayers))
        scan_bound(args, kw, stats, model.settings.nlayers)
        ms = cuda_ms(lambda: sk.scan_cuda(*args, **kw), reps=10)
        plain_ms = cuda_ms(lambda: sk.scan_reference(*args, **kw), reps=2)
        gather_ms = cuda_ms(lambda: eng.kernel_inputs(t0, c), reps=5)
        rate = cfg6["npoints"] * cfg6["chunk_t"] / (ms * 1e-3)
        log(f"  [{card_line()}] K2 vs plain, {cfg6['npoints']} x 64 chunk, "
            f"{label}: max |err| {errs[-1]:.3e}; kernel {ms:.3f} ms "
            f"({rate:.4g} point-steps/s), plain {plain_ms:.1f} ms, slim "
            f"forcing gather {gather_ms:.3f} ms")
        res[label] = (ms, plain_ms)
        if c is not None:
            k1 = sk.scan_cuda(eng.tmp0, eng.scal0, eng.chunk_forcing(t0, c),
                              model.cfg, model.params, model.grid,
                              out_stride=eng.os_, nsteps=cfg6["chunk_t"],
                              out_offset=t0, n_out=eng.k_alloc)
            assert_bitwise("1M K2 + decay chunk vs K1 fed cof_window", got,
                           k1)
            del k1
        del forc, got, want
    del eng
    torch.cuda.empty_cache()
    return max(errs), res


# ---------------------------------------------------------------------------
# the kernel's builds and the station order (phases 2 and 3e)
# ---------------------------------------------------------------------------

def kernel_label(mangled):
    """``scan_kernel<LM, DEPTH, SLIM, FUSED, CS>`` or ``window_kernel<LM,
    DEPTH, FUSED, CS>`` of a mangled instantiation name (fewer arguments
    for a kernel from an earlier source)."""
    m = re.search(r"\d+(scan_kernel|window_kernel)I"
                  r"((?:Li\d+E|Lb[01]E)+)E", mangled)
    if not m:
        return mangled
    args = [a[2:] if a.startswith("Li") else
            ("true" if a == "Lb1" else "false")
            for a in re.findall(r"(Li\d+|Lb[01])E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def log_build(label, info):
    """ptxas's registers, stack and spills and the SASS instruction counts
    of every instantiation in one built library: the whole body, the time
    loop (the longest loop) and the boundary-layer loop (the innermost loop
    that holds a MUFU.RSQ: its sqrtf; logf compiles to no MUFU), with the
    MUFU / FCHK / CALL / BRA counts."""
    counts = sass.library_sass(info["path"])
    usage = {k: rest for k, *rest in build.ptxas_usage(info["log"])}
    for kname in sorted(set(usage) | set(counts)):
        regs, frame, st, ld = usage.get(kname, (None,) * 4)
        line = (f"  [{label}] {kernel_label(kname)}: {regs} registers, stack "
                f"frame {frame} B, spill stores {st} B, spill loads {ld} B")
        k = counts.get(kname)
        if k:
            loops = k["loops"]
            bl = next((lp for lp in loops
                       if lp["opcodes"].get("MUFU.RSQ")), None)
            line += (f"; SASS {k['instructions']} instructions "
                     f"{json.dumps(k['opcodes'])}")
            if loops:
                line += f", time loop {loops[-1]['instructions']}"
            if bl:
                line += (f", boundary-layer loop {bl['instructions']} "
                         f"{json.dumps(bl['opcodes'])}")
        log(line)


#: the extra nvcc flags of phase 2s's build
LINEINFO = ("-lineinfo",)
#: the parts of the fused prep by the marker comments that open them in
#: csrc/scan_kernel.cu:fused_prep, and the helper functions each part calls
PREP_MARKERS = (("grid values", "// ---- raw values"),
                ("merge", "// ---- the merge in source order"),
                ("CheckValues", "// ---- forcing.prepare_window"),
                ("sky view", "// sky view"),
                ("wind floor", "// day/night wind floor"),
                ("relaxation, rain probability", "// relaxation"),
                ("precipitation type", "// calc_prec_type"),
                ("obs and coupling flags", "// obs forcing"),
                ("thermo", "// forcing_thermo"))
PREP_HELPERS = (("channel tests", ("grid_has",)),
                ("step values", ("grid_step", "grid_seg", "stage_of")),
                ("grid values", ("grid_value", "tdew_from_rh", "rh_from_tdew",
                                 "esat_air")),
                ("segment lines", ("grid_segments",)),
                ("prep, the helpers", ("div_s", "clampf", "clampi")),
                ("step body", ("step_body",)))


def prep_parts(path):
    """[(part, first line, last line)] of csrc/scan_kernel.cu: fused_prep's
    lines that test a channel's pointer ("channel tests", with grid_has)
    first, the helper functions next (a function from its signature to its
    closing brace at column 0), then fused_prep cut at its marker
    comments."""
    src = open(path).read().splitlines()

    def body(name):
        i = next((k for k, x in enumerate(src)
                  if re.search(rf"\b{name}\(", x) and not x.startswith(" ")
                  and not x.startswith("//")), None)
        if i is None:
            return None
        j = next(k for k in range(i, len(src)) if src[k] == "}")
        return i + 1, j + 1
    lo, hi = body("fused_prep")
    parts = [("channel tests", k + 1, k + 1) for k in range(lo - 1, hi)
             if "!= nullptr" in src[k]]
    parts += [(part, *body(f)) for part, fs in PREP_HELPERS for f in fs
              if body(f)]
    marks = [(next(k for k in range(lo - 1, hi) if src[k].strip()
                   .startswith(m)) + 1, part) for part, m in PREP_MARKERS]
    ends = [m[0] - 1 for m in marks[1:]] + [hi]
    parts += [(part, a, b) for (a, part), b in zip(marks, ends)]
    return parts + [("prep, the rest", lo, hi)]


def phase_sass_split(variants=()):
    """Phase 2s (only when named): this build's source, and each source of
    ``variants`` (label, sources), built again with -lineinfo, each fused
    instantiation's time loop split by part of the prep (``prep_parts``),
    the step body and the rest, in SASS instructions; each listing (about
    30 MB) goes beside its library."""
    for label, sources in [("this build", build.SOURCES)] + [
            v for v in variants if not isinstance(v[1], int)]:
        info = build.build(sources, extra=LINEINFO)
        text = sass.library_listing(info["path"])
        with open(info["path"] + ".sass.txt", "w") as f:
            f.write(text)
        src = Path(sources[0])
        parts = prep_parts(src)
        for name, rows in sorted(sass.line_listing(text).items()):
            kname = kernel_label(name)
            if not re.search(r"(scan_kernel<\d+, \w+, true, true(, \d+)?>|"
                             r"window_kernel<\d+, \w+, true(, \d+)?>)",
                             kname):
                continue
            lines = sass.loop_lines(rows)
            split = sass.part_split(lines, parts, src.name)
            log(f"  [{label}] {kname}: time loop {sum(lines.values())} "
                f"instructions, by part: " + json.dumps(dict(sorted(
                    split.items(), key=lambda kv: -kv[1]))))


def parse_variants(argv):
    """``--variant LABEL=PATH`` options (another source of the kernel, e.g.
    an earlier copy, built into a library of its own) and ``--stage W``
    options (this build's fused kernels at the stage width W, a power of
    two, in place of ``sk.stage_width``'s); returns (the other arguments,
    [(label, sources or the width)])."""
    rest, variants = [], []
    it = iter(argv)
    for a in it:
        if a == "--stage":
            w = int(next(it))
            variants.append((f"stage {w}", w))
        elif a == "--variant":
            label, _, path = next(it).partition("=")
            variants.append((label, (path,)))
        else:
            rest.append(a)
    return rest, variants


@contextlib.contextmanager
def kernel_library(lib, stage=None):
    """``sk.scan_cuda`` launches ``lib`` (another build of the kernel)
    inside the block, the fused kernels at the stage width ``stage`` when
    given."""
    saved, rule = build.load, sk.stage_width
    build.load = lambda *a, **k: lib
    if stage is not None:
        sk.stage_width = lambda *a, **k: stage
    try:
        yield
    finally:
        build.load, sk.stage_width = saved, rule


def launch_line(kind, label=""):
    """The stage width and occupancy of the last launch of ``kind`` ("K3
    fused" or "K5 fused"); returns its ``sk.FusedLaunch``."""
    f = sk.LAST_LAUNCH[kind]
    log(f"  [{card_line()}] {kind}{' ' + label if label else ''}: stage "
        f"width {f.stage}, {f.regs} registers, {f.blocks} blocks an SM "
        f"(its registers allow {f.blocks_regs}), shared memory a block "
        f"{f.smem} B of segment lines + {f.static_smem} B static, channel "
        f"set {sk.CHANNEL_SETS[f.channel_set]}")
    return f


def station_order(st_idx, n_stations):
    """(perm, inv) on the card: the stable sort of the points by station
    (out-of-radius points last) that one block of a run places them in,
    and its inverse."""
    key = np.where(st_idx >= 0, st_idx, n_stations)
    perm = torch.as_tensor(np.argsort(key, kind="stable"), device=DEV)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(len(perm), device=DEV)
    return perm, inv


def phase_station_order(cfg, variants=()):
    """Phase 3e: K2 and K1 on phase 5's 1,048,576 x 64 station chunk
    (offset 448) in the caller's point order and in station order (tmp0,
    scal0, the forcing and the aux rows permuted with index_select; the
    kernel is the same): the station-order results mapped back equal the
    caller-order ones bit for bit; the boundary-layer iterations of a lane
    and of a warp in each order (scan_reference's stats); the kernel and
    the forcing gathers timed in turns (caller, station, station, caller).
    Each of ``variants`` (label, sources) is built into a library
    of its own, its ptxas and SASS counts printed, and its results held to
    this build's bit for bit in both orders and timed in the same turns.
    Returns {"K1" / "K2": (station-order ms, caller-order ms, bound)}."""
    model, ct = cfg["model"], cfg["chunk_t"]
    exp = cfg["exp"]
    eng = production._Engine(model, exp, cfg["pts"], cfg["cal"],
                             cfg["state0"], chunk_t=ct)
    assert eng.slim and getattr(exp, "point_perm", None) is None
    perm, inv = station_order(cfg["st_idx"], cfg["raw_st"].tair.shape[0])
    t0 = 7 * ct
    rest = (model.cfg, model.params, model.grid)
    geo = eng.scan_kwargs(t0, ct)
    to_st = lambda x, d: x.index_select(d, perm)
    back = lambda r: (r[0].index_select(1, inv), r[1].index_select(1, inv),
                      r[2].index_select(2, inv))
    forc2, kw2 = eng.kernel_inputs(t0)
    cases = {"K2": (forc2, kw2), "K1": (eng.chunk_forcing(t0), {})}
    calls = {}
    for mode, (forc, kw) in cases.items():
        kw_s = dict(kw)
        if "aux_rows" in kw:
            kw_s["aux_rows"] = to_st(kw["aux_rows"], 1)
        calls[mode] = {
            "caller": ((eng.tmp0, eng.scal0, forc), kw),
            "station": ((to_st(eng.tmp0, 1), to_st(eng.scal0, 1),
                         to_st(forc, 2)), kw_s)}
    del forc2, cases

    def launch(mode, order):
        args, kw = calls[mode][order]
        return sk.scan_cuda(*args, *rest, **geo, **kw)

    libs = [("this build", build.load())]
    for label, sources in variants:
        if isinstance(sources, int):
            continue                     # a stage width: no fused kernel
        info = build.build(sources)
        log_build(label, info)
        libs.append((label, build.load(sources)))
    out = {}
    for mode in calls:
        want = launch(mode, "caller")
        for label, lib in libs:
            with kernel_library(lib):
                got_c, got_s = launch(mode, "caller"), launch(mode, "station")
            torch.cuda.synchronize()
            assert_bitwise(f"{mode} 1M station chunk, {label}, caller order, "
                           f"vs this build", got_c, want)
            assert_bitwise(f"{mode} 1M station chunk, {label}, station order "
                           f"mapped back, vs caller order", back(got_s), want)
            del got_c, got_s
        del want
    stats = {}
    for order in ("caller", "station"):
        args, kw = calls["K2"][order]
        stats[order] = {}
        sk.scan_reference(*args, *rest, stats=stats[order], **geo, **kw)
        log(f"  [{card_line()}] K2 station chunk, {order} order: "
            f"{iterations(stats[order])}")
    assert stats["caller"]["bl_iters"] == stats["station"]["bl_iters"]
    turns = [(label, lib, order) for label, lib in libs
             for order in ("caller", "station")]
    for mode in calls:
        ms = {(label, order): [] for label, _, order in turns}
        for seq in (turns, turns[::-1]):
            for label, lib, order in seq:
                with kernel_library(lib):
                    ms[(label, order)].append(cuda_ms(
                        lambda: launch(mode, order), reps=10))
        args, kw = calls[mode]["station"]
        bound = scan_bound(args, dict(geo, **kw), stats["station"],
                           model.settings.nlayers)
        log(f"  [{card_line()}] {mode} per 1M x 64 station chunk (ms, two "
            f"readings in turns): " + json.dumps(
                {f"{label}, {order}": [round(v, 4) for v in vals]
                 for (label, order), vals in ms.items()}))
        mean = lambda key: sum(ms[key]) / len(ms[key])
        out[mode] = (mean(("this build", "station")),
                     mean(("this build", "caller")), bound)
    # the per-chunk row gathers in both orders (neighbouring lanes read one
    # station's row in station order)
    exp_s = copy.copy(exp)
    exp_s.prep_data = dict(exp.prep_data, sidx=to_st(exp.prep_data["sidx"],
                                                     0))
    gathers = {}
    for order, e, obs in (("caller", exp, eng.obs_dev),
                          ("station", exp_s, to_st(eng.obs_dev, 0)),
                          ("station", exp_s, to_st(eng.obs_dev, 0)),
                          ("caller", exp, eng.obs_dev)):
        gathers.setdefault(f"slim, {order}", []).append(round(cuda_ms(
            lambda: e.slim_window(t0, ct), reps=5), 4))
        gathers.setdefault(f"packed, {order}", []).append(round(cuda_ms(
            lambda: e.packed_window(t0, ct, 1.0, 1.0, obs), reps=5), 4))
    log(f"  [{card_line()}] station row gathers per 1M x 64 chunk (ms, in "
        f"turns): " + json.dumps(gathers))
    del calls, eng, exp_s
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# K5, the coupling window (phase 3w)
# ---------------------------------------------------------------------------

def window_case(depth, npoints=32768, T=240, S=512, wlen=30, seed=19):
    """Phase 3w's inputs: ``S`` stations' synthetic winter_mix forcing over
    ``T`` steps, coupling on, relaxation off (with ``depth`` a global
    output depth, the kernel's DEPTH instantiation); ``npoints`` points in
    station order (a run's block order), each with its own ``wlen``-step
    window ending at a step drawn from [150, T-1], every 5th at T-1; the obs
    target the air temperature at the window end minus U(0.5, 2.5) K, so
    the control iterates, every 7th point without obs.  The state after
    phase A comes from K1 on the card; the station-rank prepared channels
    (init_len 1: no window row forces the obs) hold for every point.
    Returns the engine, the state after phase A, the window span's
    arguments and the per-point window inputs."""
    settings = ModelSettings(
        sim_len=T, dt=30.0, use_relaxation=False, use_coupling=True,
        **({"tsurf_output_depth": 0.03} if depth else {}))
    model = Model(settings, device=DEV)
    raw_st, cal = synthetic_raw(S, T, dt=30.0, seed=seed,
                                scenario="winter_mix", dtype=np.float32)
    rng = np.random.default_rng(seed)
    st_idx = np.sort(rng.integers(0, S, npoints))
    end = rng.integers(150, T, npoints)
    end[::5] = T - 1
    obs = raw_st.tair[st_idx, end - 1] - rng.uniform(0.5, 2.5, npoints)
    obs[::7] = -9999.9
    pts = default_point_params(npoints)._replace(
        coupling_start=(end - wlen + 1).astype(np.int32),
        coupling_end=end.astype(np.int32), coupling_tsurf=obs)
    ctx = {"st_pts": default_point_params(S + 1), "anchors": None,
           "settings": settings, "params": model.params, "hour": cal.hour,
           "t_total": T}
    exp = production.StationExpander(raw_st, st_idx, DEV, chunk_t=T,
                                     prep_ctx=ctx)
    first = RawForcing(**{n: exp.first_host[n][:, None]
                          for n in RawForcing._fields})
    state0 = model.init(first, cal, dtype=torch.float32, pts=pts)
    eng = production._Engine(model, exp, default_point_params(npoints), cal,
                             state0, chunk_t=T)
    _, (ws, we_b) = coupling.window_span(settings, pts)
    tmp, scal, _ = sk.scan_cuda(eng.tmp0, eng.scal0, eng.chunk_forcing(0),
                                model.cfg, model.params, model.grid,
                                nsteps=ws - 1)
    on = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt, device=DEV)
    pts_dev = eng.pts_dev._replace(
        coupling_start=on(pts.coupling_start, torch.int32),
        coupling_end=on(pts.coupling_end, torch.int32),
        coupling_tsurf=on(pts.coupling_tsurf, torch.float32))
    torch.cuda.synchronize()
    return dict(model=model, eng=eng, exp=exp, tmp=tmp, scal=scal, ws=ws,
                we_b=we_b, T=T, pts_dev=pts_dev,
                wpts=wk.window_points(pts_dev, settings))


def window_span_of(c, stride):
    return wk.WindowSpan(c["ws"], c["we_b"], c["T"], stride,
                         c["model"].settings.coupling_effect_reduction)


def window_args(c, table, span):
    m = c["model"]
    return (c["tmp"], c["scal"], table, c["wpts"], m.cfg, m.params, m.grid,
            span)


def assert_window_bitwise(label, got, want):
    """Two WindowOut (or their slices), bit for bit (floats by their
    bits).  Returns the largest |difference| of their float fields, found
    before the check, with the points whose failed masks (the state's or
    the control's) or re-run counts differ printed beside it."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want)
              if g.dtype == torch.float32)
    failed = lambda o: (o.scal[sk.R_FAILED] > 0.5) | o.cv_failed
    n_failed = int((failed(got) != failed(want)).sum())
    n_reruns = int((got.reruns != want.reruns).sum())
    log(f"  {label}: max |err| {err:.3e}, points whose failed masks differ "
        f"{n_failed}, whose re-run counts differ {n_reruns}")
    for name, g, w in zip(got._fields, got, want):
        same = (torch.equal(g.view(torch.int32), w.view(torch.int32))
                if g.dtype == torch.float32 else torch.equal(g, w))
        if not same:
            raise AssertionError(f"{label}: {name} differs")
    return err


def window_part(out, sl):
    """The points ``sl`` of a WindowOut (the point axis is every field's
    last)."""
    return wk.WindowOut(*(x[..., sl] for x in out))


def window_stats(steps):
    """(lane steps, warp steps, slowest lane) of K5's per-point steps: a
    warp issues 32 x its slowest lane's steps."""
    lane = int(steps.sum())
    warp = int(32 * steps.view(-1, 32).amax(dim=1).sum())
    return lane, warp, int(steps.max())


def window_bound(c, span, table, stats, n_points):
    """(bound_ms, bound_by) of one K5 call: the bytes it must move (the
    state and the profile read and written once, the table's ten read
    channels and the TRF rows read once, the per-point inputs read and
    results written once, the output rows written once; the snapshot
    stays in shared memory) over the card's HBM rate, against the float32
    operations
    of the steps these inputs take (window_reference's stats: each step's
    body, its boundary-layer iterations) over its float32 rate."""
    L = c["model"].grid.nlayers
    tab = table[0]
    n_bytes = (4 * n_points * 2 * (L + 3 + sk.R_FAILED + 1)
               + 4 * 10 * tab.shape[0] * tab.shape[2] + 4 * tab.shape[0]
               + n_points * (4 * 4 + 1) + n_points * (4 * 4 + 1)
               + 4 * span.n_out * 6 * n_points)
    n_ops = (stats["point_steps"] * (OPS_STEP + OPS_LAYER * L)
             + stats["bl_iters"] * OPS_BL_ITER)
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * n_ops / PEAK_F32_OPS_S
    log(f"  K5 bound: {n_bytes / 1e9:.4f} GB -> {t_bytes:.4f} ms at 3.35 "
        f"TB/s; {n_ops / 1e9:.3f} G f32 ops ({stats['point_steps']} steps "
        f"taken, {stats['bl_iters']} boundary-layer iterations) -> "
        f"{t_ops:.4f} ms at 67 TFLOP/s")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_window_small(variants=()):
    """Phase 3w: K5 against window_reference on the card (32,768 points, a
    240-step run, 30-step windows ending at staggered steps, some at T-1),
    bit for bit with equal failed masks, at output strides 1 and 7, with
    and without the output depth, on the station table and on the identity
    table (both equal); then K5 against the eager run_window_passes on the
    same card and inputs; lane and warp steps; K5 and its plain version
    timed, and beside K5 each of ``variants`` (held to this build bit for
    bit, in turns).  Returns {"err", "ms", "plain_ms", "bound"}, "err" the
    largest max |err| of K5 against its plain version."""
    res = {"err": 0.0}
    for depth in (False, True):
        c = window_case(depth)
        eng = c["eng"]
        P = eng.P_pad
        tab_st = eng.window_table(window_span_of(c, 1), 0, P)
        eng_id = copy.copy(eng)
        eng_id.fast = False
        tab_id = eng_id.window_table(window_span_of(c, 1), 0, P)
        log(f"  3w case{' with the output depth' if depth else ''}: {P} "
            f"points, T {c['T']}, window [{c['ws']}, {c['we_b']}], station "
            f"table {tuple(tab_st[0].shape)}, identity table "
            f"{tuple(tab_id[0].shape)}")
        for stride in (1, 7):
            span = window_span_of(c, stride)
            got = wk.window_cuda(*window_args(c, tab_st, span))
            got_id = wk.window_cuda(*window_args(c, tab_id, span))
            torch.cuda.synchronize()
            assert_window_bitwise(f"3w K5 station table vs identity table "
                                  f"(depth {depth}, stride {stride})", got,
                                  got_id)
            stats = {}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            want = wk.window_reference(*window_args(c, tab_st, span),
                                       stats=stats)
            ev[1].record()
            torch.cuda.synchronize()
            res["err"] = max(res["err"], assert_window_bitwise(
                f"3w K5 vs window_reference (depth {depth}, stride "
                f"{stride})", got, want))
            lane, warp, slow = window_stats(got.steps)
            log(f"  [{card_line()}] 3w depth {depth}, stride {stride}: K5 "
                f"== window_reference bit for bit (rows, state, "
                f"corrections, failed masks, re-runs) on both tables; "
                f"re-runs: most {int(got.reruns.max())}, points re-run "
                f"{int((got.reruns > 0).sum())}; coupling failed "
                f"{int(got.cv_failed.sum())}; steps a lane {lane / P:.2f}, "
                f"issued a lane by its warp {warp / P:.2f} (divergence "
                f"factor {warp / lane:.3f}), slowest lane {slow}")
            if not depth and stride == 1:
                args = window_args(c, tab_st, span)
                res["ms"] = cuda_ms(lambda: wk.window_cuda(*args), reps=5)
                # the plain version's one call above, on the card's clock
                res["plain_ms"] = ev[0].elapsed_time(ev[1])
                res["bound"] = window_bound(c, span, tab_st, stats, P)
                log(f"  [{card_line()}] 3w K5 {res['ms']:.3f} ms, plain "
                    f"version {res['plain_ms']:.1f} ms ({P} points)")
                if variants:
                    window_variants("3w, K5 on the station table", args, {},
                                    got, variants, reps=5)
                # the eager counterpart of the JAX engine on the same card
                ws, we_b = c["ws"], c["we_b"]
                t0 = time.perf_counter()
                st = sk.unpack_state(c["tmp"], c["scal"],
                                     c["model"].grid.nlayers, eng.template)
                eager = coupling.run_window_passes(
                    st, lambda t: c["exp"].prepared_window(t, 64),
                    c["exp"].prepared_window(ws - 1, we_b - ws + 2).valid,
                    ws, we_b, c["pts_dev"], c["model"].settings,
                    c["model"].cfg, c["model"].grid, c["model"].params,
                    out_stride=1, wchunk=64)
                torch.cuda.synchronize()
                t_eager = time.perf_counter() - t0
                rows_e = eager.out.permute(0, 2, 1)
                err = float((got.rows - rows_e).abs().max())
                est = sk.pack_state(eager.state, lpad=c["tmp"].shape[0])
                err_t = float((got.tmp[:c["model"].grid.nlayers + 2]
                               - est[0][:c["model"].grid.nlayers + 2])
                              .abs().max())
                n_it = int((got.reruns != eager.point_reruns).sum())
                bitwise = (torch.equal(got.rows, rows_e)
                           and torch.equal(got.tmp[:c["model"].grid.nlayers
                                                   + 2],
                                           est[0][:c["model"].grid.nlayers
                                                  + 2]))
                same_failed = torch.equal(got.cv_failed, eager.cv.failed) \
                    and torch.equal(got.scal[sk.R_FAILED] > 0.5,
                                    eager.state.failed)
                log(f"  [{card_line()}] 3w K5 vs the eager "
                    f"run_window_passes on the card ({t_eager:.1f} s, "
                    f"{eager.reruns} re-run passes, {eager.rows} rows): "
                    f"max |err| rows {err:.3e}, profile {err_t:.3e}; points "
                    f"whose re-run count differs {n_it}; failed masks "
                    f"{'equal' if same_failed else 'DIFFER'}; "
                    f"{'bitwise' if bitwise else 'not bitwise'}")
                assert int(got.reruns.max()) > 0
            del got, got_id, want
        del c, tab_st, tab_id, eng, eng_id
        torch.cuda.empty_cache()
    return res


#: the built libraries of the ``--variant`` sources, by label
VARIANT_LIBS = {}


def load_variants(variants):
    """[(label, library, stage width or None)] of ``variants`` (label,
    sources or a stage width), each source built once and its ptxas and
    SASS counts printed at its first use; a width runs this build."""
    out = []
    for label, sources in variants:
        if isinstance(sources, int):
            out.append((label, build.load(), sources))
            continue
        if label not in VARIANT_LIBS:
            log_build(label, build.build(sources))
            VARIANT_LIBS[label] = build.load(sources)
        out.append((label, VARIANT_LIBS[label], None))
    return out


def window_variants(label, args, kw, want, variants, reps):
    """K5 from each of ``variants`` (label, sources or a stage width) on
    ``args``: held to this build's results ``want`` bit for bit, then
    timed beside this build in turns (this build and each variant, then
    the reverse)."""
    libs = [("this build", build.load(), None)] + load_variants(variants)
    for name, lib, stage in libs[1:]:
        with kernel_library(lib, stage):
            got = wk.window_cuda(*args, **kw)
        torch.cuda.synchronize()
        assert_window_bitwise(f"{label}: {name} vs this build", got, want)
        del got
    ms = {name: [] for name, _, _ in libs}
    for seq in (libs, libs[::-1]):
        for name, lib, stage in seq:
            with kernel_library(lib, stage):
                ms[name].append(cuda_ms(
                    lambda: wk.window_cuda(*args, **kw), reps=reps))
    log(f"  [{card_line()}] {label}: K5 ms a launch, in turns: "
        + json.dumps({k: [round(v, 4) for v in vals]
                      for k, vals in ms.items()}))


#: phase 3w's K5 fused cases: (configuration, relaxation)
WINDOW_FUSED_CASES = (("grid", False), ("composite", False),
                      ("station", False), ("composite", True))
#: phase 3w's wide grid cases (``wide_grid``: 8 channels at SPAN 6 and at
#: SPAN 21, the lines in stages) and 3f's, by ground layers: the default 15
#: and 20 (the <32> instantiation)
WINDOW_WIDE_LAYERS = (15, 20)


def window_fused_bound(c, forc, span, stats, n_points):
    """(bound_ms, bound_by) of one K5 fused call: K5's bytes
    (``window_bound``) with the raw inputs read once in place of the table
    (the grid part's raw rows of every window chunk, the station part's
    series rows of the window, the per-point parameters and time
    machinery, as ``fused_bound`` counts them for a chunk), against the
    body's float32 operations at the steps these inputs take and the
    prep's (OPS_*: every prepared row, the segment lines of each stage a
    lane enters, ``window_lines`` a channel, sky view on its points,
    relaxation's float64)."""
    eng = forc.engine
    a = forc.kernel_args()
    P, L, W1 = n_points, c["model"].grid.nlayers, span.rows
    n_g = sum(1 for n in a["g"] if n != "prec_phase")
    n_s = len(a["s"])
    sky = np.asarray(eng.pts_dev.sky_view.cpu())
    sky_share = (float(np.mean((sky < 1.0) & (sky > -0.01)))
                 if eng.enable_sky else 0.0)
    n_bytes = (4 * P * 2 * (L + 3 + sk.R_FAILED + 1)
               + P * (4 * 4 + 1) + P * (4 * 4 + 1)
               + 4 * span.n_out * 6 * P + 4 * W1)
    if a["g"]:
        lo = a["wrows"][:, 1]
        rows = int(lo.max()) + a["KW"] - int(lo.min())
        n_bytes += 4 * P * len(a["g"]) * rows + 4 * W1 * 7
    if n_s:
        S = eng.fused_parts[1].channels.tair.shape[0]
        n_bytes += 4 * S * W1 * n_s + 9 * P
    n_bytes += 4 * P * (4 + (2 if eng.enable_sky else 0)
                        + (6 if a["relax"] else 0))
    n_bytes += 4 * W1 * (1 + (4 if eng.enable_sky else 0))
    preps = stats["window_preps"]
    if eng.enable_sky and not eng.flat_horizons:
        n_bytes += 4 * preps * sky_share
    ops = (stats["point_steps"] * (OPS_STEP + OPS_LAYER * L)
           + stats["bl_iters"] * OPS_BL_ITER
           + preps * (OPS_PREP + OPS_GRID_CH * n_g + OPS_SKY * sky_share)
           + stats["window_lines"] * n_g * OPS_SEGMENT)
    ops64 = preps * OPS_RELAX_F64 if a["relax"] else 0
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * (ops / PEAK_F32_OPS_S + ops64 / PEAK_F64_OPS_S)
    log(f"  K5 fused bound: {n_bytes / 1e9:.4f} GB -> {t_bytes:.4f} ms at "
        f"3.35 TB/s; {ops / 1e9:.3f} G f32 + {ops64 / 1e9:.3f} G f64 ops "
        f"({stats['point_steps']} steps taken, {stats['bl_iters']} "
        f"boundary-layer iterations, {preps} rows prepared, "
        f"{stats['window_segments']} stage entries, "
        f"{stats['window_lines']} segment lines a channel, SPAN "
        f"{a.get('span', 0)}) -> {t_ops:.4f} ms at 67 / 34 TFLOP/s")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_window_fused_small():
    """Phase 3w's K5 fused cases: the coupled run of each of
    WINDOW_FUSED_CASES (``fused_small_inputs``: 16,384 points, 140 steps,
    8-step windows ending at steps drawn from [70, 140), so ws is 63;
    16-step chunks, so the window spans five window chunks; most points
    rewind until the control gives up at 25), with and without the output
    depth, output stride 4: phase B goes through K5
    fused once, and no window table is built; its inputs, held as the run
    hands them over, run again through K5 fused and through its plain
    version (``window_reference`` on the window's eager table), the run's
    own results and the new launch's equal to it bit for bit.  The grid
    case without depth runs at 65,536 points and is timed, beside its
    plain version and its bound (the plain version takes most of the
    phase's time: the others run at a quarter of the points).  Then the
    wide grid at each of WINDOW_WIDE_LAYERS, without depth, at 48-step
    chunks (the window spans two window chunks): the most dynamic shared
    memory a launch of these cases asks for; and at 192-step chunks over
    360 steps, 8-step windows ending at steps drawn from [170, 360), so ws
    is 163: SPAN above the stage width, the window over two window chunks,
    the first holding several stages of segment lines, rewinds across
    them.  Each launch's stage width and occupancy are printed, and its
    blocks an SM must be what its registers allow.  Returns {"err", "ms",
    "plain_ms", "bound"}."""
    res = {"err": 0.0}
    cases = [(config, relax, depth, None, False)
             for depth in (False, True) for config, relax in
             WINDOW_FUSED_CASES]
    cases += [("grid", False, False, n, staged) for staged in (False, True)
              for n in WINDOW_WIDE_LAYERS]
    for config, relax, depth, layers, staged in cases:
        wide = layers is not None
        timed = config == "grid" and not depth and not wide
        chunk_t = 192 if staged else 48 if wide else 16
        c = fused_small_inputs(config, side=256 if timed else 128,
                               relax=relax, coupled=True, depth=depth,
                               chunk_t=chunk_t, T=360 if staged else 140,
                               cend_lo=170 if staged else 70, wlen=8,
                               wide=wide, nlayers=layers)
        label = (f"3w K5 fused, {config}"
                 f"{', sky view' if config != 'grid' else ''}"
                 f"{', relaxation' if relax else ''}"
                 f"{', output depth' if depth else ''}")
        if wide:
            g = c["exp"]
            assert g.SPAN >= 6 and len(g.var_names) >= 7, (
                g.SPAN, g.var_names)
            label += (f", {len(g.var_names)} channels at SPAN "
                      f"{g.SPAN}, {layers} layers")
        reset_counts()
        with WindowTables() as tables, window_calls([]) as kept:
            production.run_production_coupled(
                c["model"], c["exp"], c["pts"], c["cal"], c["state0"],
                anchors=c["anchors"], chunk_t=chunk_t, out_stride=4)
        n_k5f = read_window_count(fused=True)
        assert tables.n == 0 and n_k5f == 1, (tables.n, n_k5f)
        (args, kw, sl, run_part), = kept
        del kept
        forc = args[2]
        assert isinstance(forc, production.FusedWindow)
        span, P = args[-1], args[0].shape[1]
        assert sl == slice(0, P)
        got = wk.window_cuda(*args, **kw)
        f = launch_line("K5 fused", f"(3w, {label})")
        assert f.blocks == f.blocks_regs, f
        if staged:
            assert c["exp"].SPAN > f.stage, (c["exp"].SPAN, f)
        stats = {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want = wk.window_reference(*args, **kw, stats=stats, stage=f.stage)
        ev[1].record()
        torch.cuda.synchronize()
        err = max(assert_window_bitwise(f"{label}: the run's K5 fused "
                                        f"vs window_reference", run_part,
                                        want),
                  assert_window_bitwise(f"{label}: K5 fused again vs "
                                        f"window_reference", got, want))
        res["err"] = max(res["err"], err)
        lane, warp, slow = window_stats(got.steps)
        log(f"  [{card_line()}] {label}: window [{span.ws}, "
            f"{span.we_b}], {forc.tc}-row window chunks, "
            f"{P} points; K5 fused == window_reference bit for bit (rows, "
            f"state, corrections, failed masks, re-runs, steps); no "
            f"window table, one K5 fused launch; re-runs: most "
            f"{int(got.reruns.max())}, points re-run "
            f"{int((got.reruns > 0).sum())}; coupling failed "
            f"{int(got.cv_failed.sum())}; steps a lane {lane / P:.2f}, "
            f"issued a lane by its warp {warp / P:.2f} (divergence "
            f"factor {warp / max(lane, 1):.3f}), slowest lane {slow}; "
            f"stage entries a point {stats['window_segments'] / P:.2f}, "
            f"segment lines a point a channel "
            f"{stats['window_lines'] / P:.2f}")
        assert int(got.reruns.max()) > 0
        if staged:
            assert span.rows > forc.tc, (span.rows, forc.tc)
            ms = cuda_ms(lambda: wk.window_cuda(*args, **kw), reps=3)
            bound = window_fused_bound({"model": c["model"]}, forc, span,
                                       stats, P)
            log(f"  [{card_line()}] {label}: K5 fused {ms:.3f} ms against "
                f"its bound {bound[0]:.4f} ms ({bound[1]}), plain version "
                f"{ev[0].elapsed_time(ev[1]):.1f} ms")
        if timed:
            res["ms"] = cuda_ms(lambda: wk.window_cuda(*args, **kw),
                                reps=5)
            res["plain_ms"] = ev[0].elapsed_time(ev[1])
            res["bound"] = window_fused_bound(
                {"model": c["model"]}, forc, span, stats, P)
            log(f"  [{card_line()}] {label}: K5 fused {res['ms']:.3f} "
                f"ms, plain version (the eager table and "
                f"window_reference) {res['plain_ms']:.1f} ms")
        del got, want, run_part, args, kw, forc, c
        torch.cuda.empty_cache()
    return res


def _small_station_case(S=64, P=8192, T=97, seed=11):
    """Station-fed setup with relaxation and out-of-radius points
    (tests/test_production.py:20-57 and :106-140, sky view off)."""
    settings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=True)
    raw_st, cal = synthetic_raw(S, T, seed=seed, dtype=np.float32)
    rng = np.random.default_rng(seed)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::97] = -1
    ok = st_idx >= 0
    raw_pt = RawForcing(*(
        np.where(ok[:, None], np.asarray(getattr(raw_st, n))[
            np.where(ok, st_idx, 0)], -9999 if n == "prec_phase"
            else np.float32(-9999.9)) for n in RawForcing._fields))
    il = 25
    rows = np.arange(S)
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    st_pts = default_point_params(S + 1)._replace(
        init_len=np.full(S + 1, il, np.int32),
        tair_relax=app(raw_st.tair[rows, il] + 0.4, -9999.9),
        vz_relax=app(raw_st.vz[rows, il] + 0.1, -9999.9),
        rh_relax=app(raw_st.rhz[rows, il] - 2.0, -9999.9))
    sidx = np.where(ok, st_idx, S)
    pts = default_point_params(P)._replace(
        init_len=np.full(P, il, np.int32),
        tair_relax=np.asarray(st_pts.tair_relax)[sidx],
        vz_relax=np.asarray(st_pts.vz_relax)[sidx],
        rh_relax=np.asarray(st_pts.rh_relax)[sidx])
    vz_a = raw_st.vz.copy()
    vz_a[:, 0] = np.maximum(vz_a[:, 0], 0.4)
    anch_st = (app(raw_st.tair[rows, il - 1], -9999.9),
               app(vz_a[rows, il - 1], -9999.9),
               app(raw_st.rhz[rows, il - 1], -9999.9))
    return settings, raw_st, raw_pt, cal, pts, st_idx, st_pts, anch_st


def compare_fields(label, res, out_ref, final_ref, steps):
    """run_production(_coupled) rows against a reference [T, P] per field
    (or [n, P, 6] rows), kernel tolerances, equal failed masks."""
    errs = []
    for k, name in enumerate(production.OUT_FIELD_ROWS):
        ref = (out_ref[:, :, k] if isinstance(out_ref, torch.Tensor)
               else getattr(out_ref, name)[steps])
        errs.append(check_close(f"{label} {name}",
                                torch.from_numpy(res.fields[name]),
                                ref.cpu(), TOL_T if k == 0 else TOL_S))
    check_close(f"{label} final tmp", res.state.tmp, final_ref.tmp.cpu(),
                TOL_T)
    if not torch.equal(res.state.failed, final_ref.failed.cpu()):
        raise AssertionError(f"{label}: failed masks differ")
    # the reported error leaves out the profiles of failed points: the
    # failing step runs on the missing sentinels and leaves values of order
    # 1e6, held above at the relative tolerance
    ok = ~res.state.failed
    errs.append(check_close(f"{label} final tmp", res.state.tmp[ok],
                            final_ref.tmp.cpu()[ok], TOL_T))
    return max(errs)


def phase_main_small(P=8192):
    (settings, raw_st, raw_pt, cal, pts, st_idx, st_pts,
     anch_st) = _small_station_case(P=P)
    model = Model(settings, device=DEV)
    final_ref, out_ref = model.run(raw_pt, pts, cal)
    state0 = model.init(raw_pt, cal, dtype=torch.float32)
    anchors = relax_anchors(raw_pt, pts)
    ctx = {"st_pts": st_pts, "anchors": anch_st, "settings": settings,
           "params": model.params, "hour": cal.hour,
           "t_total": settings.sim_len}
    for chunk_t, stride, slim in ((32, 6, True), (16, 7, True),
                                  (32, 6, False)):
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                         chunk_t=chunk_t, prep_ctx=ctx,
                                         slim=slim)
        before = (sk.LAUNCHES, sk.LAUNCHES_SLIM)
        res = production.run_production(
            model, exp, pts, cal, state0, anchors=anchors, chunk_t=chunk_t,
            out_stride=stride)
        n_chunks = -(-settings.sim_len // chunk_t)
        launched = (sk.LAUNCHES - before[0], sk.LAUNCHES_SLIM - before[1])
        assert launched == ((0, n_chunks) if slim else (n_chunks, 0)), \
            launched
        want = np.arange(0, settings.sim_len, stride)
        assert np.array_equal(res.out_steps, want), res.out_steps
        err = compare_fields("run_production", res, out_ref, final_ref, want)
        log(f"  run_production ({'K2' if slim else 'K1'}) vs Model.run, {P} "
            f"pts / 64 stations / 97 steps, (chunk_t, out_stride) = "
            f"({chunk_t}, {stride}): max |err| {err:.3e}, failed "
            f"{int(res.state.failed.sum())}")


def _small_coupled_case(S=64, P=8192, T=97, seed=11, ws=11, we=40):
    """phase 4's stations and points with coupling: window [ws, we], obs
    target below the station's air temperature at we
    (tests/test_production.py:279-294), station 2 without obs;
    station-derived values (relaxation off)."""
    (settings, raw_st, raw_pt, cal, _, st_idx, _, _) = _small_station_case(
        S=S, P=P, T=T, seed=seed)
    settings = ModelSettings(sim_len=T, dt=30.0, use_coupling=True)
    ok = st_idx >= 0
    sidx = np.where(ok, st_idx, S)
    rng = np.random.default_rng(5)
    obs_st = raw_st.tair[:, we - 1] - rng.uniform(0.5, 2.5, S)
    obs_st[2] = -9999.9
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    st_pts = default_point_params(S + 1)._replace(
        coupling_start=app(np.full(S, ws, np.int32), -99).astype(np.int32),
        coupling_end=app(np.full(S, we, np.int32), -99).astype(np.int32),
        coupling_tsurf=app(obs_st, -9999.9))
    pts = default_point_params(P)._replace(
        coupling_start=np.asarray(st_pts.coupling_start)[sidx],
        coupling_end=np.asarray(st_pts.coupling_end)[sidx],
        coupling_tsurf=np.asarray(st_pts.coupling_tsurf)[sidx])
    return settings, raw_st, raw_pt, cal, pts, st_idx, st_pts


def phase_coupled_small(P=8192):
    settings, raw_st, raw_pt, cal, pts, st_idx, st_pts = \
        _small_coupled_case(P=P)
    model = Model(settings, device=DEV)
    t0 = time.perf_counter()
    final_pc, out_pc = model.run_coupled(raw_pt, pts, cal)
    log(f"  Model.run_coupled (per-point PC) on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    state0 = model.init(raw_pt, cal, dtype=torch.float32, pts=pts)
    ctx = {"st_pts": st_pts, "anchors": None, "settings": settings,
           "params": model.params, "hour": cal.hour,
           "t_total": settings.sim_len}
    for chunk_t, stride in ((32, 6), (16, 7)):
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                         chunk_t=chunk_t, prep_ctx=ctx)
        metrics = RunMetrics()
        reset_counts()
        res = production.run_production_coupled(
            model, exp, pts, cal, state0, chunk_t=chunk_t, out_stride=stride,
            metrics=metrics)
        assert sk.LAUNCHES_SLIM > 0
        k5 = read_window_count()
        want = np.arange(0, settings.sim_len, stride)
        assert np.array_equal(res.out_steps, want), res.out_steps
        c = metrics.counters
        assert c["coupling_reruns"] > 0, c
        err = compare_fields("run_production_coupled", res,
                             out_pc[torch.as_tensor(want)], final_pc, want)
        log(f"  run_production_coupled vs Model.run_coupled, {P} pts / 64 "
            f"stations / 97 steps, window [11, 40], (chunk_t, out_stride) = "
            f"({chunk_t}, {stride}): max |err| {err:.3e}, K5 launches "
            f"{k5}, reruns {c['coupling_reruns']}, coupled "
            f"{c['coupling_points']}, "
            f"succeeded {c['coupling_succeeded']}, failed "
            f"{c['coupling_failed']}")


def station_sorted_setup(cfg):
    """Phase 5's configuration with its points passed in station order:
    the caller of the reference run, whose blocks' sort is the identity
    (every block keeps the caller's order).  Returns (the configuration,
    the order as a numpy permutation of phase 5's points)."""
    S = cfg["raw_st"].tair.shape[0]
    order = station_order(cfg["st_idx"], S)[0].cpu().numpy()
    idx = torch.as_tensor(order)
    exp = production.StationExpander(cfg["raw_st"], cfg["st_idx"][order],
                                     DEV, chunk_t=cfg["chunk_t"],
                                     prep_ctx=cfg["ctx"])
    sort = lambda e: production.station_sorted(e.block(0, cfg["npoints"],
                                                       DEV))
    assert sort(exp).point_perm is None
    assert sort(cfg["exp"]).point_perm is not None
    state0 = type(cfg["state0"])(*(x[idx.to(x.device)]
                                   for x in cfg["state0"]))
    pts = PointParams(*(np.asarray(x)[order] for x in cfg["pts"]))
    return dict(cfg, exp=exp, pts=pts, state0=state0,
                st_idx=cfg["st_idx"][order]), order


def mapped(res, order):
    """A production result with its points taken in ``order`` (the
    numpy permutation of station_sorted_setup): the result the caller of
    that order would see."""
    idx = torch.as_tensor(order)
    return res._replace(
        fields={k: v[:, order] for k, v in res.fields.items()},
        state=type(res.state)(*(x[idx] for x in res.state)))


def phase_main_full(cfg, metrics, exp, depth=None):
    """The uncoupled main path at full size through ``exp``: K2 when it is
    slim, else K1, at PIPELINE_DEPTH ``depth`` (the package's by default).
    Returns (result, K1 launches, K2 launches, peak bytes, failed share,
    the run's StreamProbe)."""
    model, T = cfg["model"], cfg["T"]
    slim = exp.slim
    torch.cuda.reset_peak_memory_stats(DEV)
    n_chunks = -(-T // cfg["chunk_t"])
    reset_counts()
    with StreamProbe() as probe, \
            pipeline_depth(depth or production.PIPELINE_DEPTH):
        res = production.run_production(
            model, exp, cfg["pts"], cfg["cal"], cfg["state0"],
            chunk_t=cfg["chunk_t"], metrics=metrics,
            progress=Progress(T, every_s=2.0))
    launches = read_counts(n_chunks)[:2]
    peak = torch.cuda.max_memory_allocated(DEV)
    assert launches == ((0, n_chunks) if slim else (n_chunks, 0)), launches
    check_outputs(res, cfg)
    failed = float(res.state.failed.float().mean())
    return res, launches, peak, failed, probe


def check_outputs(res, cfg):
    T = cfg["T"]
    assert np.array_equal(res.out_steps, np.arange(0, T, 120)), \
        res.out_steps
    for name, f in res.fields.items():
        assert f.shape == (len(range(0, T, 120)), cfg["npoints"]), \
            (name, f.shape)
        assert np.all(np.isfinite(f) | (f == -9999.0)), name


def sample_reference(settings, pts, cal, raw, coupled, steps):
    """One plain re-run of a sample of points over the whole horizon, on the
    host, in the float type of ``raw`` (a worker process of SampleRuns):
    Model.run, or Model.run_coupled (the per-point-PC engine).  Returns
    (failed [n] bool, {field: [len(steps), n]}) as numpy, the rows at the
    0-based output steps ``steps``."""
    torch.set_num_threads(1)
    model = Model(settings, device="cpu")
    if coupled:
        final, out = model.run_coupled(raw, pts, cal, settings.output_stride)
        rows = {name: out[:, :, k].numpy()
                for k, name in enumerate(production.OUT_FIELD_ROWS)}
    else:
        final, out = model.run(raw, pts, cal)
        rows = {name: getattr(out, name)[steps].numpy()
                for name in production.OUT_FIELD_ROWS}
    return final.failed.numpy(), rows


def cli_sample(cfg_path, dtype, steps):
    """One sample re-run of phase 9 (a worker process of SampleRuns): the
    runner's scan engine on the card (``Model.run`` over the whole
    horizon) on a ``points.coordinates`` config of the sample's points, in
    ``dtype``.  Returns (failed [n], {field: [len(steps), n]})."""
    torch.set_num_threads(1)
    state, fields = runner.run(cfg_path, CLI_TIME, verbose=False,
                               device="cuda", engine="scan",
                               dtype=getattr(torch, dtype))
    return state.failed.cpu().numpy(), {
        name: np.asarray(fields[name])[steps]
        for name in production.OUT_FIELD_ROWS}


class SampleRuns:
    """The long sample re-runs, made in worker processes on the host while
    the card goes on with the next phases: ``start`` hands a full-size run's
    sample to two workers (float32 and float64), ``finish`` waits for them
    all and holds each run to its bound.  At 64 points the plain torch
    step is dispatch-bound on one core, so the re-runs cost no card time and
    little of the host's."""

    def __init__(self, workers=4):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"))
        self.pending = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def start(self, cfg, res, n=64, coupled=False, raw_fn=None,
              hold_f32=False, label=""):
        """A sample of ``n`` points of the run ``res`` re-run through
        Model.run (Model.run_coupled when ``coupled``) over the whole
        horizon, in float32 and in float64.  ``raw_fn(idx)`` gives the
        sample's float64 forcing ([n, T] RawForcing), by default the station
        series of its points.  ``hold_f32``: see ``finish``."""
        if coupled:
            cand = np.nonzero(np.asarray(cfg["pts"].coupling_end) >= 1)[0]
            idx = cand[np.linspace(0, len(cand) - 1, n).astype(np.int64)]
        else:
            idx = np.linspace(0, cfg["npoints"] - 1, n).astype(np.int64)
        if raw_fn is None:
            raw = RawForcing(*(np.asarray(getattr(cfg["raw_st"], f))[
                cfg["st_idx"][idx]] for f in RawForcing._fields))
        else:
            raw = raw_fn(idx)
        cast = lambda dt: RawForcing(*(
            x.astype(dt) if x.dtype.kind == "f" else x for x in raw))
        pts = PointParams(*(np.asarray(x)[idx] for x in cfg["pts"]))
        settings = cfg["model"].settings
        jobs = [self.pool.submit(sample_reference, settings, pts, cfg["cal"],
                                 cast(dt), coupled, res.out_steps)
                for dt in (np.float32, np.float64)]
        self._add(jobs, n, cfg["T"], res.state.failed[idx].numpy(),
                  {name: res.fields[name][:, idx].copy()
                   for name in production.OUT_FIELD_ROWS},
                  label, coupled=coupled, hold_f32=hold_f32)

    def start_cli(self, cfg_path, n, T, failed, got, steps, label):
        """A sample given as a ``points.coordinates`` config of its points:
        the runner's scan engine on the card (``cli_sample``), float32 and
        float64; ``failed`` [n] and ``got`` {field: [rows, n]} are the
        full-size run's at those points."""
        jobs = [self.pool.submit(cli_sample, cfg_path, dt, steps)
                for dt in ("float32", "float64")]
        self._add(jobs, n, T, failed, got, label, what="the scan engine")

    def _add(self, jobs, n, T, failed, got, label, coupled=False,
             hold_f32=False, what=None):
        self.pending.append(dict(
            jobs=jobs, n=n, T=T, coupled=coupled, hold_f32=hold_f32,
            label=label, what=what, t0=time.perf_counter(), failed=failed,
            got=got))

    def finish(self):
        """Wait for every sample and check it.  Over 8,881 steps no two
        float32 implementations agree at the kernel tolerances: where a
        storage runs out (the last ice melts, wet snow turns to water) the
        step and the remainder hang on rounding accumulated over thousands
        of steps, and tsurf or water jumps there.  So the bound is
        relative: per field, the kernel path's largest error against the
        float64 run is at most twice the float32 plain run's own, plus the
        field's tolerance; the failed masks are equal.  ``hold_f32`` also
        holds the kernel path to the float32 run elementwise at the kernel
        tolerances, tsurf's atol widened by RUNOUT_T for one storage
        run-out event: where both float32 paths carry the same large error
        against float64 (sky view's correction reads the float32 Julian
        day), that is the check that can see a wrong correction.  The
        station phases do not take it: over their 8,881 steps the two
        float32 paths see run-out events in the storages too (PERF.md)."""
        errs = []
        for s in self.pending:
            (failed32, out32), (failed64, out64) = (
                j.result(timeout=600) for j in s["jobs"])
            secs = time.perf_counter() - s["t0"]
            assert np.array_equal(failed32, s["failed"]), "failed masks"
            assert np.array_equal(failed64, s["failed"]), "failed masks"
            err, err32, err_k32 = {}, {}, {}
            for k, name in enumerate(production.OUT_FIELD_ROWS):
                ref, got = out64[name], s["got"][name]
                err[name] = float(np.abs(got - ref).max())
                err32[name] = float(np.abs(out32[name] - ref).max())
                err_k32[name] = float(np.abs(got - out32[name]).max())
                tol = TOL_T if k == 0 else TOL_S
                assert err[name] <= 2.0 * err32[name] + tol["atol"], \
                    (name, err[name], err32[name])
                if s["hold_f32"]:
                    check_close(
                        f"{s['n']}-point sample {name} vs float32 {name}",
                        torch.from_numpy(got), torch.from_numpy(out32[name]),
                        dict(tol, atol=tol["atol"] + (RUNOUT_T if k == 0
                                                      else 0.0)))
            fmt = lambda e: json.dumps({k: float(f"{v:.3e}")
                                        for k, v in e.items()})
            what = s["what"] or ("Model.run_coupled" if s["coupled"]
                                 else "Model.run")
            log(f"  {s['label'] + ': ' if s['label'] else ''}"
                f"{s['n']}-point sample over {s['T']} steps (ready "
                f"{secs:.0f} s after its run), max |err| against float64 "
                f"{what}: kernel path {fmt(err)}; float32 {what} "
                f"{fmt(err32)}; kernel path against float32 {what} "
                f"{fmt(err_k32)}")
            errs.append(err)
        self.pending = []
        return errs


@contextlib.contextmanager
def window_calls(kept, n_check=65536):
    """``wk.window`` records in ``kept`` its first call's arguments (the
    state after phase A cloned: the run reuses its room) and, cloned as
    the call returns, its results for the first ``n_check`` points of that
    call (the slice ``sl``), so that K5 can be timed again and held to its
    plain version on the run's own inputs after the run."""
    orig = wk.window

    def recorded(*a, **k):
        first = not kept
        if first:
            args = (a[0].clone(), a[1].clone()) + tuple(a[2:])
        out = orig(*a, **k)
        if first:
            lo = k.get("lo", 0)
            n = a[0].shape[1] if wk.is_fused(a[2]) else a[2][1].shape[0]
            sl = slice(lo, lo + min(n_check, n))
            kept.append((args, dict(k), sl, wk.WindowOut(
                *(x.clone() for x in window_part(out, sl)))))
        return out
    wk.window = recorded
    try:
        yield kept
    finally:
        wk.window = orig


class FusedHead:
    """The first ``n`` points of the fused window ``forc`` as its plain
    version reads them (``window_reference`` on a fused window): their
    eager table (``_Engine.window_table`` of those points, the table
    route's) in the fused window's chunks, as one tile."""

    def __init__(self, forc, n):
        self.forc, self.n, self.tc = forc, n, forc.tc
        self.tile_geom = (1, n)
        self.kernel_args = forc.kernel_args

    def table(self):
        return self.forc.engine.window_table(self.forc.span, 0, self.n)


def fused_head_check(label, args, kw, sl, run_part, again, model):
    """K5 fused's plain version on the first points ``sl`` of a run's
    window (``FusedHead``), against the run's own K5 fused results and a
    new launch's (``again``) on those points, bit for bit; and the bound
    of the whole launch (``window_fused_bound``): the run's lane steps,
    each with the boundary-layer iterations, prepared rows, stage entries
    and segment lines a lane step that the plain version counted on its
    points.  Returns {"err", "bound", "plain_s"}."""
    tmp0, scal0, forc, pts = args[:4]
    assert sl.start == 0
    n = sl.stop
    kw = {k: v for k, v in kw.items() if k not in ("lo", "out")}
    stats = {}
    t0 = time.perf_counter()
    want = wk.window_reference(
        tmp0[:, :n].contiguous(), scal0[:, :n].contiguous(),
        FusedHead(forc, n), wk.WindowPoints(*(x[:n] for x in pts)),
        *args[4:], **kw, stats=stats, stage=sk.LAST_LAUNCH["K5 fused"].stage)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max(assert_window_bitwise(
        f"{label}: K5 fused of the run vs window_reference on points "
        f"[0, {n})", run_part, want), assert_window_bitwise(
        f"{label}: K5 fused again on the run's inputs vs window_reference "
        f"on points [0, {n})", window_part(again, sl), want))
    lane = int(again.steps.sum())
    per_step = {k: v / stats["point_steps"] for k, v in stats.items()}
    whole = {k: round(v * lane) for k, v in per_step.items()}
    log(f"  [{card_line()}] {label}: K5 fused == window_reference bit for "
        f"bit on {n} points of the run's window (rows, state, "
        f"corrections, failed masks, re-runs: most "
        f"{int(want.reruns.max())}, steps of the slowest lane "
        f"{int(want.steps.max())}; plain version {plain_s:.1f} s); a lane "
        f"step there: {per_step['bl_iters']:.3f} boundary-layer "
        f"iterations, {per_step['window_preps']:.4f} rows prepared, "
        f"{per_step['window_segments']:.5f} stage entries, "
        f"{per_step['window_lines']:.5f} segment lines a channel")
    bound = window_fused_bound({"model": model}, forc, args[-1], whole,
                               again.steps.shape[0])
    return dict(err=err, bound=bound, plain_s=plain_s)


def phase_coupled_full(cfg6, metrics, variants=()):
    """Phase 6: the coupled run at full size, phase B through K5; K5 timed
    again on the run's own window inputs (beside each of ``variants``, held
    to this build bit for bit, in turns), its bound from the steps the run
    took and the boundary-layer iterations a step of its plain version on
    the first 65,536 points.  Returns (result, (K1, K2) launches, K5's
    figures)."""
    model, T = cfg6["model"], cfg6["T"]
    torch.cuda.reset_peak_memory_stats(DEV)
    reset_counts()
    t0 = time.perf_counter()
    with window_calls([]) as kept:
        res = production.run_production_coupled(
            model, cfg6["exp"], cfg6["pts"], cfg6["cal"], cfg6["state0"],
            anchors=cfg6["anchors"], chunk_t=cfg6["chunk_t"],
            metrics=metrics, progress=Progress(T, every_s=5.0))
    launches = read_counts()[:2]
    k5 = read_window_count(main_path=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV)
    check_outputs(res, cfg6)
    c, ph = metrics.counters, metrics.phases
    assert c["coupling_reruns"] > 0, c
    assert launches[1] > 0, launches
    log(f"  [{card_line()}] run_production_coupled wall {wall:.2f} s: phase A "
        f"{ph['phase_a']:.2f} s, phase B {ph['phase_b']:.2f} s, phase C "
        f"{ph['phase_c']:.2f} s; stream {ph['stream']:.2f} s = "
        f"{res.point_steps_per_s:.6g} point-steps/s")
    log(f"  coupling: window steps {c['coupling_window_steps']}, most "
        f"re-runs of a point {c['coupling_reruns']}, steps of the slowest "
        f"lane {c['coupling_window_rows']}, one K5 launch a block "
        f"{bool(c['coupling_window_cached'])}; points coupled "
        f"{c['coupling_points']}, succeeded {c['coupling_succeeded']}, "
        f"failed {c['coupling_failed']}; K1 launches {launches[0]}, K2 "
        f"launches {launches[1]}, K5 launches {k5}; peak device memory "
        f"{peak / 2**30:.2f} GiB; failed share "
        f"{float(res.state.failed.float().mean()):.6f}")
    # K5 again on the run's window inputs (its time at this size), and its
    # plain version on the first 65,536 points of that launch, against the
    # run's own K5 results and the new launch's, bit for bit
    (args, kw, sl, run_part), = kept
    del kept
    again = wk.window_cuda(*args, **kw)
    t0 = time.perf_counter()
    lo = kw.get("lo", 0)
    table, fidx, trf = args[2]
    stats = {}
    want = wk.window_reference(
        *args[:2], (table, fidx[sl.start - lo:sl.stop - lo], trf), *args[3:],
        lo=sl.start, stats=stats)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    want = window_part(want, sl)
    err = max(assert_window_bitwise(
        f"6, K5 of the run vs window_reference on points [{sl.start}, "
        f"{sl.stop})", run_part, want), assert_window_bitwise(
        f"6, K5 again on the run's inputs vs window_reference on points "
        f"[{sl.start}, {sl.stop})", window_part(again, sl), want))
    log(f"  [{card_line()}] 6: K5 == window_reference bit for bit on "
        f"{sl.stop - sl.start} points of the run's window (rows, state, "
        f"corrections, failed masks, re-runs: most "
        f"{int(want.reruns.max())}, steps of the slowest lane "
        f"{int(want.steps.max())}; plain version {plain_s:.1f} s)")
    del want, run_part
    ms = cuda_ms(lambda: wk.window_cuda(*args, **kw), reps=3)
    lane, warp, slow = window_stats(again.steps)
    n = again.steps.shape[0]
    # the bound: the run's lane steps, each with the boundary-layer
    # iterations a step that the plain version counted on its points
    L = model.grid.nlayers
    iters = stats["bl_iters"] / stats["point_steps"]
    t_ops = 1e3 * lane * (OPS_STEP + OPS_LAYER * L + iters * OPS_BL_ITER) \
        / PEAK_F32_OPS_S
    t_bytes = 1e3 * (4 * n * 2 * (L + 3 + sk.R_FAILED + 1)
                     + 4 * 10 * table.shape[0] * table.shape[2]) \
        / PEAK_BYTES_S
    bound = max(t_ops, t_bytes)
    floor = 1e3 * lane * (OPS_STEP + OPS_LAYER * L + 5 * OPS_BL_ITER) \
        / PEAK_F32_OPS_S
    log(f"  [{card_line()}] K5 at this size: {ms:.3f} ms a launch ({n} "
        f"points; steps a lane {lane / n:.2f}, issued a lane by its warp "
        f"{warp / n:.2f}, divergence factor {warp / max(lane, 1):.3f}, "
        f"slowest lane {slow}); bound {bound:.3f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}: {lane} lane "
        f"steps at {iters:.3f} boundary-layer iterations a step, measured "
        f"by the plain version on {sl.stop - sl.start} points; the floor "
        f"of 5 gave {floor:.3f} ms)")
    if variants:
        window_variants("6, K5 on the run's window inputs", args, kw, again,
                        variants, reps=3)
    del again, args, kw
    return res, launches, dict(ms=ms, launches=k5, err=err, bound=bound)


# ---------------------------------------------------------------------------
# K3 and the tile-major production path (phases 3c, 4c, 7, 7b)
# ---------------------------------------------------------------------------

def utc(s):
    return callib.timegm(time.strptime(s, "%Y-%m-%d %H:%M"))


def offset_chunk_case(npoints=65536, T=128):
    """The offset chunk of phases 3c and 3d: 65,536 points x 128 steps at
    global offset 40, 100 of 128 steps, in a run of 140 steps (the chunk
    holds the lastValues step), window ends before and inside the chunk and
    at the last step, the coupling flag set at random.  Returns (model,
    tmp0, scal0, [(label, point-major forcing, slim keyword arguments)] for
    K1, K2 and K2 with the decay, chunk geometry)."""
    model = Model(ModelSettings(sim_len=T, dt=30.0), device=DEV)
    raw, cal = synthetic_raw(npoints, T, seed=21, scenario="winter_mix",
                             dtype=np.float32)
    prep = model.prepare(raw, default_point_params(npoints), cal)
    rng = np.random.default_rng(5)
    dev_f = lambda a: torch.tensor(np.asarray(a, np.float32), device=DEV)
    prep = prep._replace(in_coupling=torch.tensor(
        rng.random((T, npoints)) < 0.5, device=DEV))
    state = model.init(raw, cal, dtype=torch.float32)
    tmp0, scal0 = sk.pack_state(state)
    tmp0[model.settings.nlayers + 2:] = float("nan")
    slim, trf = sk.pack_forcing_slim(prep)
    obs = dev_f(rng.uniform(-3.0, 1.0, npoints))
    off, nsteps, stride = 40, 100, 4
    t_total = off + nsteps
    cend = rng.integers(20, t_total, npoints)
    cend[::9] = -99
    cend[1::9] = t_total - 1
    trf_g = torch.zeros(off + T, dtype=torch.float32, device=DEV)
    trf_g[off:] = trf
    ones = torch.ones((T, npoints), dtype=torch.float32, device=DEV)
    k1 = sk.pack_forcing(prep._replace(trf_fric=trf_g[off:]), ones, ones,
                         obs)
    geo = dict(out_stride=stride, nsteps=nsteps, out_offset=off,
               n_out=len(range(-(-off // stride) * stride, off + nsteps,
                               stride)))
    decay = dict(slim_trf=trf_g, aux_cofs=True, t_total=t_total,
                 cof_red=model.settings.coupling_effect_reduction,
                 aux_rows=sk.pack_aux(
                     obs, dev_f(rng.uniform(-0.4, 0.6, npoints)),
                     dev_f(rng.uniform(-0.4, 0.6, npoints)), dev_f(cend)))
    modes = (("K1", k1, {}),
             ("K2", slim, dict(slim_trf=trf_g, aux_rows=sk.pack_aux(obs))),
             ("K2 + decay", slim, decay))
    return model, tmp0, scal0, modes, geo


def phase_kernel_tm_small(npoints=65536, T=128):
    """K3 on 65,536 points x 128 steps at each tile width: the 16-channel
    forcing against K1, the slim one without and with the decay against
    K2, bit for bit, on the offset chunk of ``offset_chunk_case``, and each
    against its plain version on the tile-major forcing."""
    model, tmp0, scal0, modes, geo = offset_chunk_case(npoints, T)
    rest = (model.cfg, model.params, model.grid)
    max_err = 0.0
    for label, forc, kw in modes:
        pm = sk.scan_cuda(tmp0, scal0, forc, *rest, **geo, **kw)
        for tp in TILE_WIDTHS:
            f4 = sk.to_tile_major(forc, tp)
            got = sk.scan_cuda(tmp0, scal0, f4, *rest, **geo, **kw)
            torch.cuda.synchronize()
            assert_bitwise(f"K3 ({label} channels, TP {tp}) vs {label}, "
                           f"{npoints} x {T}", got, pm)
            want = sk.scan_reference(tmp0, scal0, f4, *rest, **geo, **kw)
            err = compare_scan(f"K3 {label} TP {tp}", got, want,
                               model.settings.nlayers)
            log(f"  K3 vs plain, {npoints} x {T}, {label}, TP {tp}: max "
                f"|err| {err:.3e}")
            max_err = max(max_err, err)
            del f4, got, want
    return max_err


# ---------------------------------------------------------------------------
# K4, the sharded launch, and the sharded paths (phases 3d, 8, 8b)
# ---------------------------------------------------------------------------

def device_lists(counts=(2, 4, 8)):
    """The device lists K4 is held at: 2, 4 and 8 blocks on the first card
    (each block on a stream of its own), and with more than one card
    visible, one block on each."""
    lists = [[DEV] * n for n in counts]
    if torch.cuda.device_count() > 1:
        lists.append([torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())])
    return lists


def shard_call(packed, kw, devices):
    """scan_sharded's per-block arguments from whole packed tensors."""
    tmp0, scal0, forc, trf, aux = sharding.shard_packed(
        *packed, devices, slim_trf=kw.get("slim_trf"),
        aux_rows=kw.get("aux_rows"))
    kw = dict(kw)
    if aux is not None:
        kw.update(slim_trf=trf, aux_rows=aux)
    return (tmp0, scal0, forc), kw


def joined(results):
    """Per-block (tmp, scal, out) joined on the points axis on DEV."""
    return tuple(sharding.gather_blocks([r[k] for r in results], device=DEV)
                 for k in range(3))


def phase_kernel_sharded_small(npoints=65536, T=128):
    """K4 on the offset chunk of phases 3b/3c, for K1, K2 with the decay
    and K3 (TP 1024) at each device list against one launch of the whole,
    bit for bit, and at 2 blocks (and over the visible cards) against its
    plain version (a loop of scan_reference over the blocks) at the kernel
    tolerances with equal failed masks.  The plain version's cost is its
    count of block runs, eager and launch-bound; 4 and 8 blocks equal one
    launch bit for bit, which phases 3, 3b and 3c hold to the plain
    version."""
    model, tmp0, scal0, modes, geo = offset_chunk_case(npoints, T)
    rest = (model.cfg, model.params, model.grid)
    k1, _, k2d = modes
    cases = (("K1", k1[1], k1[2]), ("K2 + decay", k2d[1], k2d[2]),
             ("K3 TP 1024", sk.to_tile_major(k2d[1], 1024), k2d[2]))
    max_err = 0.0
    for label, forc, kw in cases:
        packed = (tmp0, scal0, forc)
        one = sk.scan_cuda(*packed, *rest, **geo, **kw)
        for devices in device_lists():
            mesh = sharding.make_mesh(devices)
            blocks, bkw = shard_call(packed, kw, mesh)
            before = sk.LAUNCHES_SHARDED
            got = sharding.scan_sharded(*blocks, *rest, mesh, **geo, **bkw)
            torch.cuda.synchronize()
            assert sk.LAUNCHES_SHARDED == before + 1
            what = (f"{len(mesh)} blocks on "
                    f"{len(set(mesh.devices))} card(s)")
            assert_bitwise(f"K4 ({label}, {what}) vs one launch, "
                           f"{npoints} x {T}", joined(got), one)
            if len(mesh) == 2 or len(set(mesh.devices)) > 1:
                want = sharding.scan_sharded_reference(*blocks, *rest, **geo,
                                                       **bkw)
                err = compare_scan(f"K4 {label} {what}", joined(got),
                                   joined(want), model.settings.nlayers)
                log(f"  K4 vs plain, {npoints} x {T}, {label}, {what}: max "
                    f"|err| {err:.3e}")
                max_err = max(max_err, err)
                del want
            del blocks, got
    return max_err


#: rounds of phase 3d's block-count timing (each round times one launch
#: and every block count in turn)
ROUNDS_3D = 5


def phase_kernel_sharded_chunk(cfg):
    """The 1,048,576 x 64 main-path chunk of phase 5 (K2, offset 448) in
    station order, as a block of the main path places it, through K4 at 1,
    2, 4 and 8 blocks on the card (and over the visible cards), each
    against one launch bit for bit, with new outputs and into the caller's
    (``out=``, as the main path's blocks launch it); at 4 blocks against
    the plain version, which is timed too.  Then ROUNDS_3D rounds, each
    timing (CUDA events) one launch and every block count in turn, both
    ways, and the host's seconds to issue each call (no synchronisation);
    the median and range of each are printed.  K4's time is its 4-block
    median with ``out=``."""
    model = cfg["model"]
    blk = production.station_sorted(cfg["exp"].block(0, cfg["npoints"], DEV))
    eng = production._Engine(model, blk, cfg["pts"], cfg["cal"],
                             cfg["state0"], chunk_t=cfg["chunk_t"])
    assert eng.slim and eng.perm is not None
    t0 = 7 * cfg["chunk_t"]
    forc, skw = eng.kernel_inputs(t0)
    packed = (eng.tmp0, eng.scal0, forc)
    rest = (model.cfg, model.params, model.grid)
    geo = eng.scan_kwargs(t0, cfg["chunk_t"])
    one = sk.scan_cuda(*packed, *rest, **geo, **skw)
    stats = {}
    sk.scan_reference(*packed, *rest, stats=stats, **geo, **skw)
    bound = scan_bound(packed, dict(geo, **skw), stats,
                       model.settings.nlayers)
    one_run = lambda: sk.scan_cuda(*packed, *rest, **geo, **skw)
    runs, err, plain_ms = {"one launch": one_run}, None, None
    for devices in device_lists((1, 2, 4, 8)):
        mesh = sharding.make_mesh(devices)
        blocks, bkw = shard_call(packed, skw, mesh)
        run = (lambda blocks=blocks, bkw=bkw, mesh=mesh:
               sharding.scan_sharded(*blocks, *rest, mesh, **geo, **bkw))
        key = (f"{len(mesh)}" if len(set(mesh.devices)) == 1
               else f"{len(mesh)} cards")
        assert_bitwise(f"1M K2 chunk through K4, {key} blocks, vs one "
                       f"launch", joined(run()), one)
        runs[key] = run
        # the same launch into the caller's outputs, as the main path's
        # blocks make it (out=, a set reused for every call)
        out = [tuple(torch.empty_like(x) for x in r) for r in run()]
        run_out = (lambda blocks=blocks, bkw=bkw, mesh=mesh, out=out:
                   sharding.scan_sharded(*blocks, *rest, mesh, out=out,
                                         **geo, **bkw))
        assert_bitwise(f"1M K2 chunk through K4 out=, {key} blocks, vs one "
                       f"launch", joined(run_out()), one)
        runs[f"{key} out="] = run_out
        if key == "4":
            # the plain version is eager torch, four times the operations
            # of the whole at a quarter of the size each: it is run once,
            # and that run is the one timed
            torch.cuda.synchronize()
            t_plain = time.perf_counter()
            want = sharding.scan_sharded_reference(*blocks, *rest, **geo,
                                                   **bkw)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t_plain)
            err = compare_scan("1M K4 chunk, 4 blocks", joined(run()),
                               joined(want), model.settings.nlayers)
            del want
        del blocks, bkw, out
    torch.cuda.empty_cache()
    times = {k: [] for k in runs}
    issue = {k: [] for k in runs}
    for _ in range(ROUNDS_3D):
        for key, run in runs.items():
            times[key].append(cuda_ms(run, reps=10))
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            run()
            issue[key].append(1e3 * (time.perf_counter() - h0))
            torch.cuda.synchronize()
    med = {k: float(np.median(v)) for k, v in times.items()}
    stat = lambda v: (f"{np.median(v):.4f} [{min(v):.4f}-{max(v):.4f}]")
    log(f"  [{card_line()}] K4 per 1M x 64 chunk (K2, offset {t0}, station "
        f"order), {ROUNDS_3D} rounds, ms median [range]: "
        + "; ".join(f"{k}: {stat(v)}" for k, v in times.items()))
    log(f"  [{card_line()}] K4 host seconds to issue one call (ms median "
        f"[range]): " + "; ".join(f"{k}: {stat(v)}"
                                  for k, v in issue.items()))
    log(f"  plain (4 blocks) {plain_ms:.1f} ms; K4 vs plain max |err| "
        f"{err:.3e}")
    del forc, one, eng, runs
    torch.cuda.empty_cache()
    return dict(err=err, ms=med["4 out="], plain_ms=plain_ms, bound=bound,
                times=times, one_ms=times["one launch"])


def assert_same_result(label, got, want):
    """Two production results, bit for bit: every output row of every
    field, every leaf of the final state, steps and point range."""
    assert np.array_equal(got.out_steps, want.out_steps), label
    assert got.point_range == want.point_range, (label, got.point_range)
    bits = lambda a: np.ascontiguousarray(a).view(np.int32)
    for name in production.OUT_FIELD_ROWS:
        n_diff = int((bits(got.fields[name]) != bits(want.fields[name])).sum())
        if n_diff:
            raise AssertionError(f"{label}: {n_diff} values of {name} differ")
    for name, g, w in zip(got.state._fields, got.state, want.state):
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: final state {name} differs")
    log(f"  {label}: equal bit for bit ({len(got.out_steps)} rows x "
        f"{got.fields['tsurf'].shape[1]} points x 6 fields and the final "
        f"state)")


def run_devices():
    """Phase 8's device list: the visible cards, or 4 blocks of the one."""
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [DEV] * 4)


def phase_sharded_run(cfg, label, ref=None, **kw):
    """``cfg``'s full-size run over ``run_devices()`` at PIPELINE_DEPTH 1
    and 2, each against the one-block run ``ref`` (made here when not
    given), bit for bit; the sharded launches and the per-mode launches are
    counted over each run.  Returns the depth-2 run."""
    T = cfg["T"]
    n_chunks = -(-T // cfg["chunk_t"])
    args = (cfg["model"], cfg["exp"], cfg["pts"], cfg["cal"], cfg["state0"])
    if ref is None:
        ref = production.run_production(*args, chunk_t=cfg["chunk_t"], **kw)
    devices = run_devices()
    for depth in (1, 2):
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)
        metrics = RunMetrics(announce=True)
        reset_counts()
        t0 = time.perf_counter()
        with PrepCalls() as calls, StreamProbe() as probe, \
                pipeline_depth(depth):
            res = production.run_production(*args, devices=devices,
                                            chunk_t=cfg["chunk_t"],
                                            metrics=metrics,
                                            progress=Progress(T, every_s=5.0),
                                            **kw)
        launches = read_counts(n_chunks)
        assert calls.n == 0, calls.n
        wall = time.perf_counter() - t0
        assert sum(launches) == n_chunks * len(devices), launches
        check_outputs(res, cfg)
        peaks = {k[len("peak_device_bytes_"):]: v
                 for k, v in metrics.counters.items()
                 if k.startswith("peak_device_bytes_")}
        log(f"  [{card_line()}] run_production ({label}, {len(devices)} "
            f"blocks on {len(set(devices))} card(s), PIPELINE_DEPTH {depth}) "
            f"wall {wall:.2f} s, stream {metrics.phases['stream']:.2f} s = "
            f"{res.point_steps_per_s:.6g} point-steps/s, kernel launches K1 "
            f"{launches[0]} K2 {launches[1]} K3 {launches[2]} K3 fused "
            f"{launches[3]}, sharded launches {n_chunks}, prepare_window "
            f"calls {calls.n}, peak device memory (GiB) "
            + json.dumps({k: round(v / 2**30, 2) for k, v in peaks.items()}))
        log(f"  [{card_line()}] phases (s): " + json.dumps(
            {k: round(v, 3) for k, v in metrics.phases.items()}))
        STREAMS[f"8, {label}, {len(devices)} blocks", depth] = stream_line(
            f"8, {label}, {len(devices)} blocks", depth, metrics, probe,
            max(peaks.values()), wall)
        assert_same_result(f"{label}, {len(devices)} blocks vs 1, "
                           f"PIPELINE_DEPTH {depth}", res, ref)
        if depth == 1:
            del res
    return res


def phase_sharded_coupled_small(P=8192):
    """Phase 4b's coupled station case (8,192 points x 97 steps, window
    [11, 40]) on 4 blocks against 1, bit for bit."""
    settings, raw_st, raw_pt, cal, pts, st_idx, st_pts = \
        _small_coupled_case(P=P)
    model = Model(settings, device=DEV)
    state0 = model.init(raw_pt, cal, dtype=torch.float32, pts=pts)
    ctx = {"st_pts": st_pts, "anchors": None, "settings": settings,
           "params": model.params, "hour": cal.hour,
           "t_total": settings.sim_len}
    exp = production.StationExpander(raw_st, st_idx, DEV, chunk_t=32,
                                     prep_ctx=ctx)
    runs = {}
    for n in (1, 4):
        metrics = RunMetrics()
        reset_counts()
        runs[n] = production.run_production_coupled(
            model, exp, pts, cal, state0, devices=[DEV] * n, chunk_t=32,
            out_stride=6, metrics=metrics)
        launches = read_counts()
        k5 = read_window_count()
        c = metrics.counters
        assert c["coupling_reruns"] > 0 and launches[1] > 0, (c, launches)
        log(f"  run_production_coupled, {P} points x 97 steps, {n} "
            f"block(s): K2 launches {launches[1]}, K5 launches {k5}, reruns "
            f"{c['coupling_reruns']}, window rows {c['coupling_window_rows']}"
            f", coupled {c['coupling_points']}, failed "
            f"{c['coupling_failed']}")
    assert_same_result("coupled station run, 4 blocks vs 1", runs[4],
                       runs[1])


# ---- phase 8b: two processes on the card ----------------------------------

MP_T, MP_STRIDE, MP_BLOCKS = 961, 120, 2
MP_EPOCH = 1575244800                 # synthetic_raw's 2019-12-02T00:00Z


def mp_case():
    """Phase 8b's station cell: phase 5's 2,048 stations and 1,048,576
    points over 961 steps, output stride 120."""
    cfg = full_size_setup(RunMetrics(), T=MP_T)
    cfg["point_ids"] = 1000000 + np.arange(cfg["npoints"])
    return cfg


def mp_run(cfg, devices, drain):
    return production.run_production(
        cfg["model"], cfg["exp"], cfg["pts"], cfg["cal"], cfg["state0"],
        devices=devices, chunk_t=cfg["chunk_t"], out_stride=MP_STRIDE,
        drain=drain)


def mp_worker(port, nproc, rank, outdir):
    """One process of phase 8b: joins the group (gloo, 127.0.0.1), runs its
    half of the points on two blocks of the card, writes its shard and its
    checkpoint, and joins the failed-count reduction."""
    distributed.initialize(f"127.0.0.1:{port}", nproc, rank)
    cfg = mp_case()
    build.load()
    reset_counts()
    t0 = time.perf_counter()
    res = mp_run(cfg, [DEV] * MP_BLOCKS, "shard")
    wall = time.perf_counter() - t0
    lo, hi = res.point_range
    assert (lo, hi) == distributed.host_point_range(cfg["npoints"])
    writer.write_shard_npz(os.path.join(outdir, f"shard_{rank}.npz"),
                           res.point_range, res.out_steps, res.fields,
                           epochs=MP_EPOCH + 30 * res.out_steps)
    writer.save_checkpoint(os.path.join(outdir, f"ckpt_{rank}.npz"),
                           res.state, cfg["point_ids"][lo:hi],
                           MP_EPOCH + 30 * MP_T)
    count, ratio = sharding.failure_stats(res.state.failed)
    with open(os.path.join(outdir, f"stats_{rank}.json"), "w") as f:
        json.dump({"range": [lo, hi], "wall": wall, "count": count,
                   "ratio": ratio, "local": int(res.state.failed.sum()),
                   "rate": res.point_steps_per_s,
                   "sharded": sk.LAUNCHES_SHARDED,
                   "k2": sk.LAUNCHES_SLIM,
                   "peak": torch.cuda.max_memory_allocated(DEV)}, f)
    distributed.shutdown()
    print(f"WORKER_OK {rank}", flush=True)


def phase_two_processes(nproc=2):
    """Phase 8b (see the module docstring)."""
    cfg = mp_case()
    ref = mp_run(cfg, [DEV], "gather")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as outdir:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, me, "--worker", str(port), str(nproc), str(i),
             outdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(nproc)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=300)
                outs.append(out.decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"WORKER_OK {i}" not in out:
                raise AssertionError(f"worker {i} failed (exit code "
                                     f"{p.returncode}):\n{out[-4000:]}")
        secs = time.perf_counter() - t0
        stats = []
        for i in range(nproc):
            with open(os.path.join(outdir, f"stats_{i}.json")) as f:
                stats.append(json.load(f))
        per = cfg["npoints"] // nproc
        assert [s["range"] for s in stats] == [
            [i * per, (i + 1) * per] for i in range(nproc)], stats
        n_chunks = -(-MP_T // cfg["chunk_t"])
        for s in stats:
            assert s["sharded"] == n_chunks, s
            assert s["k2"] == n_chunks * MP_BLOCKS, s
        # the failed-count reduction saw both ranks
        n_failed = int(ref.state.failed.sum())
        assert sum(s["local"] for s in stats) == n_failed, stats
        assert all(s["count"] == n_failed for s in stats), stats
        log(f"  [{card_line()}] {nproc} processes x {MP_BLOCKS} blocks on "
            f"the card, {cfg['npoints']} points x {MP_T} steps: workers' "
            f"wall {secs:.1f} s (start, set-up, run and writes), their "
            f"run_production walls "
            f"{[round(s['wall'], 2) for s in stats]} s, point-steps/s "
            f"{[round(s['rate']) for s in stats]}, peak device "
            f"memory {[round(s['peak'] / 2**30, 2) for s in stats]} GiB a "
            f"process, failed points {[s['local'] for s in stats]} of "
            f"{n_failed}")
        steps, fields, epochs = writer.merge_shards(
            [os.path.join(outdir, f"shard_{i}.npz") for i in range(nproc)])
        assert np.array_equal(steps, ref.out_steps)
        assert np.array_equal(epochs, MP_EPOCH + 30 * steps)
        merged = production.ProductionResult(
            state=ref.state, out_steps=steps, fields=fields,
            point_steps_per_s=0.0, point_range=ref.point_range)
        # the checkpoints, restored in turn onto a zero template
        state = type(ref.state)(*(torch.zeros_like(x) for x in ref.state))
        for i in range(nproc):
            state = writer.restore_state(
                os.path.join(outdir, f"ckpt_{i}.npz"), cfg["point_ids"],
                state)
        assert_same_result(
            "merged shards and restored checkpoints of 2 processes vs the "
            "one-process run", merged._replace(state=state), ref)
    del cfg, ref
    torch.cuda.empty_cache()


def chunk_pieces(eng, t0, label):
    """The three layers of one chunk at ``t0`` on the unfused tile-major
    route, timed alone with CUDA events: the forcing (raw window, prep and
    stack), the kernel (K3), and the drain of one output row."""
    src, kw = eng.kernel_inputs(t0)
    forc = sk.pack_forcing_slim_tm(src.prepared())[0]
    geo = dict(out_stride=eng.os_, nsteps=eng.chunk_t, out_offset=t0,
               n_out=eng.k_alloc)
    rest = (eng.cfg, eng.params, eng.grid)
    prep_ms = cuda_ms(lambda: sk.pack_forcing_slim_tm(src.prepared()),
                      reps=3)
    kern_ms = cuda_ms(lambda: sk.scan_cuda(eng.tmp0, eng.scal0, forc, *rest,
                                           **geo, **kw), reps=5)
    row = sk.scan_cuda(eng.tmp0, eng.scal0, forc, *rest, **geo, **kw)[2]
    drain_ms = cuda_ms(lambda: row[:1, :6].cpu(), reps=5)
    log(f"  [{card_line()}] per chunk ({label}, offset {t0}): forcing "
        f"(window + prep + stack) {prep_ms:.3f} ms, kernel {kern_ms:.3f} ms, "
        f"drain of one output row {drain_ms:.3f} ms")
    return forc, kw, geo, (prep_ms, kern_ms, drain_ms)


def chunk_lines(a, off, nsteps, stage):
    """The segment lines a lane of K3 fused computes for each grid channel
    on the chunk of kernel arguments ``a`` at global step ``off``: those of
    its first stage before the first step, then those of each stage of
    ``stage`` segments a step enters (the steps run forward)."""
    span = a.get("span", 0)
    if not span:
        return 0
    pos = a["pos"][off:off + nsteps].long().cpu().numpy()
    st = np.clip(pos - a["k0"], 0, span - 1)
    stages = set((st // stage * stage).tolist()) | {0}
    return sum(min(stage, span - s0) for s0 in stages)


def fused_bound(eng, src, geo, stats):
    """(bound_ms, bound_by) of one K3 fused call: the larger of the bytes it
    must read and write once over the card's HBM rate and its operations
    over the float32 and float64 rates.  Bytes: the grid part's window
    rows (KW raw rows of each channel it carries) and [T_pad] time
    machinery of the chunk, the station part's chunk of each channel it
    reads, its station index and mask, the per-point parameters the prep
    reads (the horizon table only at the entries this chunk's sky-active
    point-steps need), the sun terms, hour and TRF of the chunk, and the
    state, profile, aux rows and outputs as ``scan_bound``.  Operations:
    the body's (``stats`` from the plain version) and the prep's (OPS_*;
    the segment lines of each stage the chunk enters, ``chunk_lines``)."""
    a = src.kernel_args()
    P = eng.P_pad
    nsteps, off, stride = geo["nsteps"], geo["out_offset"], geo["out_stride"]
    L = eng.grid.nlayers
    rows = len(range(-(-off // stride) * stride, off + nsteps, stride))
    n_g = sum(1 for n, x in a["g"].items() if n != "prec_phase")
    lines = chunk_lines(a, off, nsteps, sk.LAST_LAUNCH["K3 fused"].stage)
    g_all = len(a["g"])
    n_s = len(a["s"])
    sky = np.asarray(eng.pts_dev.sky_view.cpu())
    sky_share = (float(np.mean((sky < 1.0) & (sky > -0.01)))
                 if eng.enable_sky else 0.0)
    n_bytes = 4 * P * (2 * (L + 3 + sk.R_FAILED + 1) + rows * 6 + 4)
    n_bytes += 4 * P * g_all * a.get("KW", 0) + 4 * nsteps * 7
    if n_s:
        S = eng.fused_parts[1].channels.tair.shape[0]
        n_bytes += 4 * S * nsteps * n_s + 9 * P
    n_bytes += 4 * P * (4 + (2 if eng.enable_sky else 0)
                        + (6 if a["relax"] else 0))
    n_bytes += 4 * nsteps * (2 + (4 if eng.enable_sky else 0))
    if eng.enable_sky and not eng.flat_horizons:
        n_bytes += 4 * stats["point_steps"] * sky_share
    ops = (stats["point_steps"] * (OPS_STEP + OPS_LAYER * L + OPS_PREP
                                   + OPS_GRID_CH * n_g
                                   + OPS_SKY * sky_share)
           + stats["bl_iters"] * OPS_BL_ITER
           + P * n_g * lines * OPS_SEGMENT)
    ops64 = stats["point_steps"] * OPS_RELAX_F64 if a["relax"] else 0
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * (ops / PEAK_F32_OPS_S + ops64 / PEAK_F64_OPS_S)
    log(f"  K3 fused bound: {n_bytes / 1e9:.3f} GB -> {t_bytes:.3f} ms at "
        f"3.35 TB/s; {ops / 1e9:.2f} G f32 + {ops64 / 1e9:.2f} G f64 ops "
        f"({iterations(stats)}; {lines} segment lines a lane a channel, "
        f"SPAN {a.get('span', 0)}) -> {t_ops:.3f} ms at 67 / 34 TFLOP/s")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scan_diff(got, want, nlayers):
    """(largest |difference| over the profile and the six output fields,
    elements outside the kernel tolerances, bitwise equal, failed masks
    equal) of two scan results; raises nothing."""
    pairs = [(got[0][:nlayers + 2], want[0][:nlayers + 2], TOL_T),
             (got[2][:, 0], want[2][:, 0], TOL_T),
             (got[2][:, 1:6], want[2][:, 1:6], TOL_S)]
    err, bad = 0.0, 0
    for g, w, tol in pairs:
        g, w = g.double(), w.double()
        d = (g - w).abs()
        nan = torch.isnan(g) & torch.isnan(w)
        bad += int((~nan & ~(d <= tol["atol"] + tol["rtol"] * w.abs()))
                   .sum())
        fin = torch.isfinite(d)
        if bool(fin.any()):
            err = max(err, float(d[fin].max()))
    same = all(g.dtype == w.dtype and bool(torch.equal(
        g.view(torch.int32), w.view(torch.int32))) for g, w in zip(got, want))
    return err, bad, same, torch.equal(got[1][sk.R_FAILED],
                                       want[1][sk.R_FAILED])


def fused_vs_routes(label, eng, src, kw, geo, stats=None, bitwise=False):
    """K3 fused on ``src`` against the unfused route (the eager prep into
    K3) and its plain version (the same eager prep into scan_reference, on
    the card), each at the kernel tolerances with equal failed masks;
    whether each is bitwise, and the unfused route against the plain
    version beside them; ``bitwise``: K3 fused must equal its plain
    version bit for bit.  Returns (max |err| against the plain version,
    the fused results)."""
    args = (eng.tmp0, eng.scal0)
    rest = (eng.cfg, eng.params, eng.grid)
    L = eng.grid.nlayers
    got = sk.scan_cuda_fused(*args, src, *rest, **geo, **kw)
    forc = sk.pack_forcing_slim_tm(src.prepared())[0]
    unf = sk.scan_cuda(*args, forc, *rest, **geo, **kw)
    want = sk.scan_reference(*args, forc, *rest, stats=stats, **geo, **kw)
    torch.cuda.synchronize()
    del forc
    d = {"fused vs plain": scan_diff(got, want, L),
         "fused vs unfused": scan_diff(got, unf, L),
         "unfused vs plain": scan_diff(unf, want, L)}
    log(f"  {label}: " + "; ".join(
        f"{k} max |err| {v[0]:.3e}, {v[1]} outside the tolerances, bitwise "
        f"{v[2]}, failed masks equal {v[3]}" for k, v in d.items()))
    for k, v in d.items():
        assert v[1] == 0 and v[3], (label, k, v)
    assert d["fused vs plain"][2] or not bitwise, (label, d["fused vs plain"])
    return d["fused vs plain"][0], got


def fused_small_case(config, chunk_t=128, **kw):
    """An engine of K3 fused on ``fused_small_inputs``' configuration with
    a ``chunk_t``-step chunk.  Returns (engine, cofs or None)."""
    c = fused_small_inputs(config, chunk_t=chunk_t, **kw)
    eng = production._Engine(c["model"], c["exp"], c["pts"], c["cal"],
                             c["state0"], anchors=c["anchors"],
                             chunk_t=chunk_t)
    assert eng.fused, config
    return eng, c["cofs"]


def wide_grid(times, fields, h_lo, h_hi, minutes=5):
    """The grid's fields from its hour ``h_lo`` to its hour ``h_hi``, on a
    ``minutes`` raw clock (linear in time between the hourly fields), with
    a dew point (the air temperature less a fifth of the humidity's
    deficit) and direct shortwave (0.7 of the shortwave) added: 8 channels,
    whose segment lines span 6 raw rows at 48-step chunks of 30 s steps
    and more than 16 from 256-step chunks on.  Returns (times,
    fields)."""
    h = np.arange(h_lo, h_hi + 1)
    n = (len(h) - 1) * 60 // minutes + 1
    t = times[h[0]] + 60 * minutes * np.arange(n, dtype=np.int64)
    w = (t - times[h[0]]) / 3600.0
    i = np.minimum(w.astype(np.int64), len(h) - 2)
    f = (w - i).astype(np.float32)[:, None, None]
    out = {k: v[h][i] * (1.0 - f) + v[h][i + 1] * f
           for k, v in fields.items()}
    out["tdew"] = out["tair"] - (100.0 - out["rhz"]) / 5.0
    out["sw_dir"] = 0.7 * out["sw"]
    return t, {k: np.asarray(v, np.float32) for k, v in out.items()}


def fused_small_inputs(config, side=256, T=140, chunk_t=128, relax=None,
                       coupled=None, start_h=10, depth=False, cend_lo=20,
                       wlen=31, wide=False, nlayers=None):
    """A configuration K3 fused takes at ``side`` x ``side`` points, its
    expanders at ``chunk_t``-step chunks: ``grid``, phase 7's grid on a
    raster over its box; ``composite``, that grid under the offset chunk's
    series (the synthetic winter_mix forcing of phases 3b-3d, seed 21, one
    series a point, every 83rd point without) as station obs, wind and
    radiation components, as in phase 7b, with sky view, horizons,
    relaxation and coupling; ``station``, those series alone with sky
    view.  The run starts at ``start_h`` UTC, 30 s steps, the series on
    its clock: at 10 the sun is up and their shortwave on, at 0 it is
    night.  Coupled: each point's ``wlen``-step window ends at a step
    drawn from [``cend_lo``, T) (every 9th point uncoupled, every 9th from
    the 2nd at T-1) with an obs target of U(-3, 1) C; ``depth``: a global
    output depth (the kernels' DEPTH instantiations).  Returns {model,
    exp, pts, cal, state0, anchors, cofs (coefficient corrections of the
    decay, or None)}.  ``wide``: the grid's fields as ``wide_grid`` makes
    them, two hours before the start to four after; ``nlayers``: the
    ground layers (default the settings')."""
    P = side * side
    times, glats, glons, fields = grid_fields_gen_production()
    lat1, lon1, lat2, lon2 = BBOX
    glat, glon = np.meshgrid(np.linspace(lat1, lat2, side),
                             np.linspace(lon1, lon2, side), indexing="ij")
    plat, plon = glat.ravel(), glon.ravel()
    sim = times[0] + 3600 * start_h + 30 * np.arange(T, dtype=np.int64)
    if wide:
        times, fields = wide_grid(times, fields, start_h - 2, start_h + 4)
    cal = Calendar.from_epochs(sim)
    relax = config == "composite" if relax is None else relax
    coupled = config == "composite" if coupled is None else coupled
    settings = ModelSettings(
        sim_len=T, dt=30.0, use_relaxation=relax, use_coupling=coupled,
        **({"tsurf_output_depth": 0.03} if depth else {}),
        **({"nlayers": nlayers} if nlayers else {}))
    model = Model(settings, device=DEV)
    raw_st, _ = synthetic_raw(P, T, dt=30.0, seed=21,
                              start_epoch=int(sim[0]),
                              scenario="winter_mix", dtype=np.float32)
    rng = np.random.default_rng(23)
    st_idx = np.arange(P)
    st_idx[::83] = -1
    grid = lambda: production.GridExpander(times, glats, glons, fields,
                                           plat, plon, sim, DEV,
                                           chunk_t=chunk_t)
    if config == "grid":
        exp = grid()
    elif config == "composite":
        exp = production.CompositeExpander([grid(), production.StationExpander(
            _only(raw_st, {"tsurf_obs", "vz", "sw_dir", "lw_net"}), st_idx,
            DEV, chunk_t=chunk_t)])
    else:
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                          chunk_t=chunk_t)
    pts = default_point_params(P)._replace(lat=plat, lon=plon)
    anchors = cofs = None
    if config != "grid":
        hor = np.zeros((P, 360), np.float32)
        hor[::3] = rng.uniform(0, 25, (len(hor[::3]), 360))
        pts = pts._replace(sky_view=np.where(np.arange(P) % 3 == 0, 0.6,
                                             1.0), horizons=hor)
    if relax:
        # phase 4's relaxation (tests/test_production.py:20-57): the anchor
        # at step 25, the targets 0.4 K, 0.1 m/s and -2 % off it
        vals = exp.host_at(np.arange(T), RawForcing._fields)
        pts = pts._replace(init_len=np.full(P, 25, np.int32))
        anchors = relax_anchors(RawForcing(**vals), pts)
        pts = pts._replace(tair_relax=anchors[0] + 0.4,
                           vz_relax=anchors[1] + 0.1,
                           rh_relax=anchors[2] - 2.0)
    if coupled:
        cend = rng.integers(cend_lo, T, P)
        cend[::9] = -99
        cend[1::9] = T - 1
        pts = pts._replace(
            coupling_start=np.maximum(cend - (wlen - 1), 1).astype(
                np.int32),
            coupling_end=cend.astype(np.int32),
            coupling_tsurf=rng.uniform(-3.0, 1.0, P))
        cofs = tuple(torch.tensor(rng.uniform(-0.4, 0.6, P),
                                  dtype=torch.float32, device=DEV)
                     for _ in range(2))
    first = RawForcing(**{n: np.asarray(exp.first_host[n])[:, None]
                          for n in RawForcing._fields})
    state0 = model.init(first, cal, dtype=torch.float32, pts=pts)
    return dict(model=model, exp=exp, pts=pts, cal=cal, state0=state0,
                anchors=anchors, cofs=cofs)


def phase_kernel_fused_small():
    """K3 fused on 16,384 points (``fused_small_case``), the 128-step chunk
    at global offset 40 with 100 steps (nsteps < the chunk, the run's
    lastValues step 139 in it), output stride 4, against the unfused route
    and its plain version: the grid with relaxation; the composite with sky
    view, coupling and the coefficient decay, without and with relaxation;
    the station source with sky view at night and by day (the sun's branch
    with shortwave, where snow melts out: a storage run-out event that
    rounding decides, so only a body that rounds as the plain version does
    holds there).  Then the wide grid (``wide_grid``: 8 channels on a
    5-minute clock) on 16,384 points at 256-step chunks over 300 steps,
    SPAN above the stage width, at each of WINDOW_WIDE_LAYERS, the
    256-step chunk at offset 40: its steps cross from the first stage of
    segment lines into the next, and K3 fused must equal its plain version
    bit for bit.  Each launch's stage width and occupancy are printed, and
    its blocks an SM must be what its registers allow."""
    max_err = 0.0
    cases = [(config, relax, coupled, start_h, None)
             for config, relax, coupled, start_h in (
                 ("grid", True, False, 10),
                 ("composite", False, True, 10),
                 ("composite", True, True, 10),
                 ("station", False, False, 0),
                 ("station", False, False, 10))]
    cases += [("grid", False, False, 10, n) for n in WINDOW_WIDE_LAYERS]
    for config, relax, coupled, start_h, layers in cases:
        wide = layers is not None
        off, nsteps, stride = 40, 256 if wide else 100, 4
        geo = dict(out_stride=stride, nsteps=nsteps, out_offset=off,
                   n_out=len(range(-(-off // stride) * stride, off + nsteps,
                                   stride)))
        eng, cofs = fused_small_case(
            config, side=128, relax=relax, coupled=coupled, start_h=start_h,
            **(dict(chunk_t=256, T=300, wide=True, nlayers=layers)
               if wide else {}))
        src, kw = eng.kernel_inputs(off, cofs)
        span = src.kernel_args().get("span", "-")
        extra = f", {layers} layers" if wide else ""
        label = (f"{config}{', sky view' if eng.enable_sky else ''}"
                 f"{', relaxation' if relax else ''}"
                 f"{', coupling, decay' if cofs else ''}, from {start_h:02d}"
                 f":00 UTC, {eng.P_pad} x {eng.chunk_t} (offset {off}, "
                 f"{nsteps} steps, SPAN {span}{extra})")
        err, _ = fused_vs_routes(label, eng, src, kw, geo, bitwise=wide)
        f = launch_line("K3 fused", f"(3f, {label})")
        assert f.blocks == f.blocks_regs, f
        if wide:
            lines = chunk_lines(src.kernel_args(), off, nsteps, f.stage)
            log(f"  3f: {lines} segment lines a lane a channel")
            assert span > f.stage and len(eng.fused_parts[0]
                                          .var_names) >= 8, (span, f)
        max_err = max(max_err, err)
        del eng, src
        torch.cuda.empty_cache()
    return max_err


def phase_fused_chunk(cfg, label, variants=()):
    """One 1,048,576 x 64 chunk (offset 448) of a full-size tile-major
    configuration: K3 fused against its plain version and the unfused
    route, and timed beside that route's pieces (the eager prep with its
    stack, and K3 on the result) with the fused bound; each of
    ``variants`` held to K3 fused bit for bit and timed beside it."""
    eng = production._Engine(cfg["model"], cfg["exp"], cfg["pts"],
                             cfg["cal"], cfg["state0"],
                             chunk_t=cfg["chunk_t"])
    assert eng.fused, f"{label}: the engine is not on K3 fused"
    t0 = 7 * cfg["chunk_t"]
    src, kw = eng.kernel_inputs(t0)
    geo = eng.scan_kwargs(t0, eng.chunk_t)
    stats = {}
    err, _ = fused_vs_routes(f"1M x 64 {label} chunk", eng, src, kw, geo,
                             stats)
    f = launch_line("K3 fused", f"({label} chunk)")
    # phase 7's grid, with or without 7b's stations: the NWP grid's channels
    assert f.channel_set == 1, f
    bound = fused_bound(eng, src, geo, stats)
    args = (eng.tmp0, eng.scal0)
    rest = (eng.cfg, eng.params, eng.grid)
    fused = lambda: sk.scan_cuda_fused(*args, src, *rest, **geo, **kw)
    prep = lambda: sk.pack_forcing_slim_tm(src.prepared())[0]
    forc = prep()
    k3 = lambda: sk.scan_cuda(*args, forc, *rest, **geo, **kw)
    ms = {"fused": [], "prep": [], "K3": []}
    for turn in ("fused", "prep", "K3", "K3", "prep", "fused"):
        fn = {"fused": fused, "prep": prep, "K3": k3}[turn]
        ms[turn].append(cuda_ms(fn, reps=3 if turn == "prep" else 10))
    if variants:
        fused_variants(f"{label} chunk", fused, variants, reps=10)
    plain_ms = cuda_ms(lambda: sk.scan_fused_reference(
        *args, src, *rest, **geo, **kw), reps=1)
    log(f"  [{card_line()}] {label} chunk (1M x 64, offset {t0}): K3 fused "
        f"{ms['fused'][0]:.4f} / {ms['fused'][1]:.4f} ms; unfused route: "
        f"eager prep + stack {ms['prep'][0]:.3f} / {ms['prep'][1]:.3f} ms, "
        f"K3 {ms['K3'][0]:.4f} / {ms['K3'][1]:.4f} ms; plain version "
        f"(eager prep + scan_reference) {plain_ms:.1f} ms; bound "
        f"{bound[0]:.4f} ms ({bound[1]})")
    del forc, eng, src
    torch.cuda.empty_cache()
    return dict(err=err, ms=min(ms["fused"]), plain_ms=plain_ms,
                bound=bound, unfused_ms=min(ms["prep"]) + min(ms["K3"]))


def phase_kernel_tm_chunk(cfg7):
    """One 1,048,576 x 64 chunk of phase 7's grid forecast (offset 448):
    K3 against its plain version, and at each tile width against K2 on the
    same values, bit for bit; K3 timed at each width beside K2 (K2, the
    widths, K2), and the plain version."""
    eng = production._Engine(cfg7["model"], cfg7["exp"], cfg7["pts"],
                             cfg7["cal"], cfg7["state0"],
                             chunk_t=cfg7["chunk_t"])
    assert eng.fused, "phase 7's engine is not on the tile-major path"
    t0 = 7 * cfg7["chunk_t"]
    forc, kw, geo, _ = chunk_pieces(eng, t0, "grid")
    tp0 = forc.shape[3]
    args = (eng.tmp0, eng.scal0)
    rest = (eng.cfg, eng.params, eng.grid)
    got = sk.scan_cuda(*args, forc, *rest, **geo, **kw)
    torch.cuda.synchronize()
    stats = {}
    want = sk.scan_reference(*args, forc, *rest, stats=stats, **geo, **kw)
    torch.cuda.synchronize()
    err = compare_scan("1M K3 chunk", got, want, eng.grid.nlayers)
    bound = scan_bound(args + (forc,), dict(geo, **kw), stats,
                       eng.grid.nlayers)
    del want
    pm = sk.to_point_major(forc)
    k2 = sk.scan_cuda(*args, pm, *rest, **geo, **kw)
    k2_ms = [cuda_ms(lambda: sk.scan_cuda(*args, pm, *rest, **geo, **kw),
                     reps=10)]
    times = {}
    for tp in sorted(set(TILE_WIDTHS) | {tp0}):
        f4 = forc if tp == tp0 else sk.to_tile_major(pm, tp)
        assert_bitwise(f"1M K3 chunk, TP {tp}, vs K2",
                       sk.scan_cuda(*args, f4, *rest, **geo, **kw), k2)
        times[tp] = cuda_ms(lambda: sk.scan_cuda(*args, f4, *rest, **geo,
                                                 **kw), reps=10)
        del f4
    k2_ms.append(cuda_ms(lambda: sk.scan_cuda(*args, pm, *rest, **geo,
                                              **kw), reps=10))
    plain_ms = cuda_ms(lambda: sk.scan_reference(*args, forc, *rest, **geo,
                                                 **kw), reps=2)
    log(f"  [{card_line()}] K3 per 1M x 64 chunk by tile width (ms): "
        + json.dumps({str(k): round(v, 4) for k, v in times.items()})
        + f"; K2 on the same values {k2_ms[0]:.4f} / {k2_ms[1]:.4f} ms; "
        f"plain {plain_ms:.1f} ms; K3 vs plain max |err| {err:.3e}; the "
        f"engine's width {tp0}")
    del forc, pm, got, k2, eng
    torch.cuda.empty_cache()
    return dict(err=err, ms=times[tp0], plain_ms=plain_ms, bound=bound,
                times=times, k2_ms=k2_ms)


def _host_raw(exp, T):
    """Every field of an expander's merged forcing on the host, [P, T],
    float32 (prec_phase int32, -9999 missing): the input of the port's
    Model.run beside the streamed run."""
    vals = exp.host_at(np.arange(T), RawForcing._fields)
    return RawForcing(*(
        np.where(vals[n] <= -9000.0, -9999, vals[n]).astype(np.int32)
        if n == "prec_phase" else np.asarray(vals[n], np.float32)
        for n in RawForcing._fields))


def _tm_small_case(P=8192, T=97, seed=3, dt=120):
    """Inputs of phase 4c (tests/test_production_fused_generic.py:35-75,
    :163-174, :279-299 at 8,192 points): a 3 x 4 grid of 10 hourly samples
    whose road-surface obs end at 02:00; 7 stations (every 83rd point out
    of radius, obs 60% missing); sky view 0.6 with U(0, 25) degree
    horizons on every third point."""
    t0 = utc("2019-12-02 00:00")
    times = t0 + 3600 * np.arange(10, dtype=np.int64)
    sim = t0 + dt * np.arange(T, dtype=np.int64)
    rng = np.random.default_rng(seed)
    shp = (10, 3, 4)
    hr = np.arange(10)[:, None, None]
    fields = {
        "tair": -3.0 + 0.5 * hr + rng.normal(0, 0.3, shp),
        "rhz": np.clip(85.0 + rng.normal(0, 30.0, shp), -20, 140),
        "vz": np.abs(rng.normal(3.0, 1.0, shp)),
        "prec": np.where(rng.random(shp) < 0.2,
                         rng.uniform(0, 150.0, shp), 0.0),
        "sw": np.abs(rng.normal(20.0, 10.0, shp)),
        "lw": 290.0 + rng.normal(0, 5.0, shp),
        "sw_dir": np.zeros(shp),
        "lw_net": -10.0 + rng.normal(0, 2.0, shp),
        "tsurf_obs": -4.0 + 0.5 * hr + rng.normal(0, 0.3, shp),
        "prec_phase": rng.integers(0, 4, shp).astype(float),
    }
    fields["tsurf_obs"][3:] = -9999.9
    plat = np.clip(59.9 + rng.uniform(0, 1.3, P), 60.0, 61.0)
    plon = np.clip(23.9 + rng.uniform(0, 1.8, P), 24.0, 25.5)
    S = 7
    st_idx = rng.integers(0, S, size=P)
    st_idx[::83] = -1
    mk = lambda lo, hi, mf=0.1: np.where(
        rng.random((S, T)) < mf, -9999.9, rng.uniform(lo, hi, (S, T)))
    raw_st = RawForcing(
        tair=mk(-20, 5), tdew=mk(-25, 2), vz=mk(0, 10), rhz=mk(10, 100),
        prec=mk(0, 5), sw=mk(0, 300), lw=mk(200, 350), sw_dir=mk(0, 200),
        lw_net=mk(-50, 30), tsurf_obs=mk(-15, 5, 0.6),
        prec_phase=rng.integers(-1, 4, (S, T)))
    sky = np.where(np.arange(P) % 3 == 0, 0.6, 1.0)
    hor = np.zeros((P, 360))
    hor[::3] = rng.uniform(0, 25, (len(hor[::3]), 360))
    st_idx2 = rng.integers(0, S, size=P)
    st_idx2[::5] = -1
    return dict(times=times, sim=sim, fields=fields, plat=plat, plon=plon,
                lats=np.linspace(60.0, 61.0, 3),
                lons=np.linspace(24.0, 25.5, 4), st_idx=st_idx,
                st_idx2=st_idx2, raw_st=raw_st, sky=sky, hor=hor, P=P, T=T)


def _only(raw, keep):
    """A RawForcing with only the ``keep`` channels, the rest missing."""
    return RawForcing(*(
        getattr(raw, n) if n in keep
        else np.full_like(np.asarray(getattr(raw, n)),
                          -9999 if n == "prec_phase" else -9999.9)
        for n in RawForcing._fields))


def _tm_small_expander(c, config, chunk_t):
    """Phase 4c's expander of ``config``."""
    def grid(fields):
        return production.GridExpander(
            c["times"], c["lats"], c["lons"], fields, c["plat"], c["plon"],
            c["sim"], DEV, chunk_t=chunk_t)

    def station(raw):
        return production.StationExpander(raw, c["st_idx"], DEV,
                                          chunk_t=chunk_t)
    if config == "grid":
        return grid(c["fields"])
    if config in ("composite", "composite_2st"):
        fields = {k: v for k, v in c["fields"].items() if k != "tsurf_obs"}
        parts = [grid(fields), station(_only(c["raw_st"],
                                             {"tsurf_obs", "vz"}))]
        if config == "composite_2st":
            # a second station network, radiation only, on its own sites
            parts.append(production.StationExpander(
                _only(c["raw_st"], {"sw", "sw_dir", "lw_net"}),
                c["st_idx2"], DEV, chunk_t=chunk_t))
        return production.CompositeExpander(parts)
    return station(c["raw_st"])


#: K3 launches (the unfused tile-major route) of phase 4c's production runs
TM_SMALL_K3 = [0]
#: phase 4c's configurations and the kernel each engine's own route
#: launches (read_counts' index): K3 fused for a grid, a station source or a
#: composite of one of each; K3 on the eager tile-layout prep for a
#: composite K3 fused does not take (here two station networks over a grid)
TM_SMALL_ROUTES = {"grid": 3, "composite": 3, "station_sky": 3,
                   "composite_2st": 2}


def phase_tm_small():
    """Phase 4c (see the module docstring); returns the largest error."""
    c = _tm_small_case()
    P, T = c["P"], c["T"]
    cal = Calendar.from_epochs(c["sim"])
    max_err = 0.0
    for config, own in TM_SMALL_ROUTES.items():
        base = default_point_params(P)._replace(lat=c["plat"],
                                                lon=c["plon"])
        if config in ("station_sky", "composite_2st"):
            base = base._replace(sky_view=c["sky"], horizons=c["hor"])
        probe = _tm_small_expander(c, config, 32)
        assert ((production.fused_parts(probe) is None)
                == (own == 2)), config
        raw_host = _host_raw(probe, T)
        first = RawForcing(**{n: np.asarray(probe.first_host[n])[:, None]
                              for n in RawForcing._fields})
        for coupled in (False, True):
            settings = ModelSettings(sim_len=T, dt=120.0,
                                     use_relaxation=False,
                                     use_coupling=coupled,
                                     coupling_minutes=30.0)
            model = Model(settings, device=DEV)
            pts = base
            if coupled:
                # the coupling window and obs from the merged obs's last
                # valid step (coupling_window_from_last of the JAX package)
                last, val = production.last_valid_scan(
                    probe, T, chunk_t=32)["tsurf_obs"]
                cl = settings.coupling_len_steps
                use = last >= cl
                pts = pts._replace(
                    coupling_start=np.where(use, np.maximum(last - cl, 1),
                                            -99).astype(np.int32),
                    coupling_end=np.where(use, last, -99).astype(np.int32),
                    coupling_tsurf=np.where(use, val, -9999.9))
                final_ref, out_ref = model.run_coupled(raw_host, pts, cal)
            else:
                final_ref, out_ref = model.run(raw_host, pts, cal)
            state0 = model.init(first, cal, dtype=torch.float32, pts=pts)
            run = (production.run_production_coupled if coupled
                   else production.run_production)
            for chunk_t, stride in ((32, 6), (16, 7)):
                want = np.arange(0, T, stride)
                ref = out_ref[torch.as_tensor(want)] if coupled else out_ref
                res = {}
                exp = _tm_small_expander(c, config, chunk_t)
                # the engine's own route, and the generic K1 route (the
                # engine's switch)
                for route in ("own", "K1"):
                    reset_counts()
                    metrics = RunMetrics()
                    production._Engine.force_generic = route == "K1"
                    try:
                        with PrepCalls() as calls:
                            r = run(model, exp, pts, cal, state0,
                                    chunk_t=chunk_t, out_stride=stride,
                                    metrics=metrics)
                    finally:
                        production._Engine.force_generic = False
                    launched = read_counts()
                    k = own if route == "own" else 0
                    if coupled:
                        # phase B through K5 fused on the K3 fused route
                        read_window_count(fused=k == 3)
                    assert launched[k] > 0 and sum(launched) == launched[k], (
                        config, route, launched)
                    TM_SMALL_K3[0] += launched[2]
                    # K3 fused, with K5 fused in phase B, prepares nothing
                    # outside the kernels
                    if k == 3:
                        assert calls.n == 0, calls.n
                    name = {0: "K1", 2: "K3", 3: "K3 fused"}[k]
                    assert np.array_equal(r.out_steps, want), r.out_steps
                    label = (f"{config} {'coupled ' if coupled else ''}"
                             f"{name} ({chunk_t}, {stride})")
                    err = compare_fields(label, r, ref, final_ref, want)
                    max_err = max(max_err, err)
                    res[route] = r
                    cpl = metrics.counters
                    log(f"  {label}: vs Model.run"
                        f"{'_coupled' if coupled else ''} max |err| "
                        f"{err:.3e}; launches K1/K2/K3/K3 fused {launched}, "
                        f"prepare_window calls {calls.n}"
                        + (f"; coupled {cpl.get('coupling_points')}, "
                           f"reruns {cpl.get('coupling_reruns')}"
                           if coupled else ""))
                a, b = res["own"], res["K1"]
                errs = [check_close(
                    f"{config} own route vs K1 {name}",
                    torch.from_numpy(a.fields[name]),
                    torch.from_numpy(b.fields[name]),
                    TOL_T if k == 0 else TOL_S)
                    for k, name in enumerate(production.OUT_FIELD_ROWS)]
                if not torch.equal(a.state.failed, b.state.failed):
                    raise AssertionError(f"{config}: its route and K1's "
                                         f"failed masks differ")
                same = all(np.array_equal(a.fields[n], b.fields[n])
                           for n in production.OUT_FIELD_ROWS)
                log(f"  {config}{' coupled' if coupled else ''} "
                    f"({chunk_t}, {stride}): its route vs the K1 route max "
                    f"|diff| {max(errs):.3e}"
                    + (" (equal bit for bit)" if same else ""))
    return max_err


BBOX = (59.6, 20.5, 70.1, 31.6)     # tools/gen_production.py:26


def grid_fields_gen_production(seed=7, stations=2048, ny=300, nx=400,
                               hours=74):
    """The NWP grid of tools/gen_production.py --grid-source (its formulas
    at :95-121, copied): the station scatter's draws come first from the
    same generator (:83-95), so the fields are the file's at the same
    seed.  Returns (times [hours+1], lats [ny], lons [nx], fields
    {name: [hours+1, ny, nx] float32}, as the generator saves them)."""
    lat1, lon1, lat2, lon2 = BBOX
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(stations)))
    rng.uniform(-0.02, 0.02, (side, side))
    rng.uniform(-0.04, 0.04, (side, side))
    gy_s = np.linspace(lat1, lat2, ny)
    gx_s = np.linspace(lon1, lon2, nx)
    LA, LO = np.meshgrid(gy_s, gx_s, indexing="ij")
    h = np.arange(hours + 1, dtype=np.float64)[:, None, None]
    hod = h % 24.0
    diurnal = np.cos((hod - 14.0) / 24.0 * 2 * np.pi)
    north = (LA - lat1) / (lat2 - lat1)
    tair = (-2.0 - 6.0 * north + 4.0 * diurnal
            + 0.6 * np.sin(h / 7.0 + 3.0 * LO / (lon2 - lon1))
            + rng.normal(0, 0.2, (hours + 1, 1, 1)))
    rhz = np.clip(80.0 + 10.0 * np.sin(h / 5.0 + 2 * north)
                  + rng.normal(0, 1.5, (hours + 1, 1, 1)), 45.0, 100.0)
    vz = np.clip(3.0 + 2.0 * np.sin(h / 9.0 + LO) + north
                 + rng.normal(0, 0.3, (hours + 1, 1, 1)), 0.2, 18.0)
    prec = np.where(np.sin(h / 11.0 + 4 * LO) > 0.8,
                    np.abs(rng.normal(0.6, 0.3, (hours + 1, 1, 1))), 0.0)
    elev = np.maximum(
        0.0, np.sin((hod - 12.0) / 24.0 * 2 * np.pi + 0.4) - 0.75)
    sw = 420.0 * elev * (1.0 - 0.3 * north)
    lw = 255.0 + 25.0 * np.sin(h / 13.0) + 5.0 * north
    fields = {"tair": tair, "rhz": rhz, "vz": vz, "prec": prec,
              "sw": sw + 0.0 * LA, "lw": lw + 0.0 * LA}
    times = utc("2019-12-01 00:00") + 3600 * np.arange(hours + 1,
                                                       dtype=np.int64)
    return times, gy_s, gx_s, {k: np.asarray(v, np.float32)
                               for k, v in fields.items()}


def grid_full_setup(metrics, side=1024, T=8881, chunk_t=64):
    """Phase 7's configuration: the generator's grid, 1,048,576 points on
    a 1024 x 1024 raster over its box (io/points.py:70-75, grid mode),
    8,881 steps of 30 s from the grid's first sample, hourly output,
    relaxation and coupling off (gen_production.py:125-128)."""
    t0 = time.perf_counter()
    times, glats, glons, fields = grid_fields_gen_production()
    lat1, lon1, lat2, lon2 = BBOX
    glat, glon = np.meshgrid(np.linspace(lat1, lat2, side),
                             np.linspace(lon1, lon2, side), indexing="ij")
    plat, plon = glat.ravel(), glon.ravel()
    sim = times[0] + 30 * np.arange(T, dtype=np.int64)
    cal = Calendar.from_epochs(sim)
    settings = ModelSettings(sim_len=T, dt=30.0, output_step_minutes=60,
                             use_relaxation=False, use_coupling=False)
    model = Model(settings, device=DEV)
    log(f"  NWP grid {fields['tair'].shape} and the {side} x {side} raster "
        f"in {time.perf_counter() - t0:.1f} s")
    with metrics.phase("grid_setup"):
        t0 = time.perf_counter()
        exp = production.GridExpander(times, glats, glons, fields, plat,
                                      plon, sim, DEV, chunk_t=chunk_t)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    log(f"  [{card_line()}] GridExpander setup (host geometry, device "
        f"extraction of {len(exp.var_names)} fields, first-step values) "
        f"{setup_s:.2f} s; K {exp.K}, KW {exp.KW}, SPAN {exp.SPAN}, tile "
        f"geometry {exp.tile_geom}")
    pts = default_point_params(len(plat))._replace(lat=plat, lon=plon)
    first = RawForcing(**{n: np.asarray(exp.first_host[n])[:, None]
                          for n in RawForcing._fields})
    state0 = model.init(first, cal, dtype=torch.float32)
    return dict(model=model, exp=exp, pts=pts, cal=cal, state0=state0,
                T=T, npoints=len(plat), chunk_t=chunk_t, times=times,
                glats=glats, glons=glons, fields=fields, plat=plat,
                plon=plon, sim=sim)


def grid_sample_raw(cfg7, overlay=None):
    """``raw_fn`` of SampleRuns.start for the grid paths: the sample's
    forcing from io/gridsource on its points alone (the host_at pipeline:
    bilinear / nearest-corner extraction, then the time interpolation,
    clamps and completion), float64; ``overlay`` (raw_st, st_idx): station
    series overlaid per valid value (merge_windows' rule)."""
    def raw_fn(idx):
        pv = {n: (gridsource.nearest_corner_at_points
                  if n == "prec_phase" else gridsource.bilinear_at_points)(
                      np.asarray(f, np.float64), cfg7["glats"],
                      cfg7["glons"], cfg7["plat"][idx], cfg7["plon"][idx]).T
              for n, f in cfg7["fields"].items()}
        vals = gridsource.timeseries_at_points(cfg7["times"], pv,
                                               cfg7["sim"])
        shape = (len(idx), len(cfg7["sim"]))
        out = {n: np.asarray(vals.get(n, np.full(shape, -9999.9)),
                             np.float64) for n in RawForcing._fields}
        if overlay is not None:
            raw_st, st_idx = overlay
            for n in RawForcing._fields:
                v = np.asarray(getattr(raw_st, n), np.float64)[st_idx[idx]]
                out[n] = np.where(v > valid_threshold(n), v, out[n])
        out["prec_phase"] = np.where(out["prec_phase"] <= -9000.0, -9999,
                                     out["prec_phase"]).astype(np.int32)
        return RawForcing(**out)
    return raw_fn


def phase_grid_full(cfg, metrics, label, depth=None):
    """A full-size run through the tile-major path at PIPELINE_DEPTH
    ``depth`` (the package's by default): K3 launched once a chunk and no
    K1 / K2 launch; returns (result, K3 launches, its stream_line)."""
    T = cfg["T"]
    torch.cuda.reset_peak_memory_stats(DEV)
    n_chunks = -(-T // cfg["chunk_t"])
    reset_counts()
    t0 = time.perf_counter()
    with PrepCalls() as calls, StreamProbe() as probe, \
            pipeline_depth(depth or production.PIPELINE_DEPTH):
        res = production.run_production(
            cfg["model"], cfg["exp"], cfg["pts"], cfg["cal"], cfg["state0"],
            chunk_t=cfg["chunk_t"], metrics=metrics,
            progress=Progress(T, every_s=5.0))
    launches = read_counts(n_chunks)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV)
    assert launches == (0, 0, 0, n_chunks), launches
    assert calls.n == 0, calls.n
    check_outputs(res, cfg)
    log(f"  [{card_line()}] run_production ({label}) wall {wall:.2f} s, "
        f"stream {metrics.phases['stream']:.2f} s = "
        f"{res.point_steps_per_s:.6g} point-steps/s, peak device memory "
        f"{peak / 2**30:.2f} GiB, failed share "
        f"{float(res.state.failed.float().mean()):.6f}, kernel launches "
        f"K1 {launches[0]} K2 {launches[1]} K3 {launches[2]} K3 fused "
        f"{launches[3]}, prepare_window calls {calls.n} "
        f"({calls.n / n_chunks:g} a chunk)")
    log(f"  [{card_line()}] phases (s): " + json.dumps(
        {k: round(v, 3) for k, v in metrics.phases.items()}))
    launch_line("K3 fused", f"({label}, the run's last launch)")
    fig = stream_line(label, production.PIPELINE_DEPTH if depth is None
                      else depth, metrics, probe, peak, wall)
    return res, launches[3], fig


def grid_coupled_setup(cfg7, window_min=180, init_h=24, seed=29):
    """Phase 7w's configuration: phase 7's grid and raster with coupling on
    (relaxation off): each point's 180-minute window ends at a step drawn
    from the last 20 minutes of an ``init_h`` analysis (24 h; 7s's 16 h),
    its obs the grid's air temperature 40 steps before the analysis ends
    minus U(0.5, 2.5) K (so the control iterates), none on every 7th
    point."""
    T = cfg7["T"]
    settings = ModelSettings(sim_len=T, dt=30.0, output_step_minutes=60,
                             use_relaxation=False, use_coupling=True,
                             coupling_minutes=window_min)
    model = Model(settings, device=DEV)
    n = cfg7["npoints"]
    il = int(init_h * 3600 / settings.dt)               # 2,880
    wl = settings.coupling_len_steps                     # 360
    rng = np.random.default_rng(seed)
    end = rng.integers(il - 39, il + 1, n).astype(np.int32)
    tair = cfg7["exp"].window(il - 40, 1).tair[0, :n].cpu().numpy()
    obs = tair - rng.uniform(0.5, 2.5, n)
    obs[::7] = -9999.9
    pts = cfg7["pts"]._replace(coupling_start=end - wl, coupling_end=end,
                               coupling_tsurf=obs)
    first = RawForcing(**{k: np.asarray(cfg7["exp"].first_host[k])[:, None]
                          for k in RawForcing._fields})
    state0 = model.init(first, cfg7["cal"], dtype=torch.float32)
    log(f"  coupled grid: {int((obs > -100).sum())} of {n} points with "
        f"obs, window ends in [{end.min()}, {end.max()}], {wl} window "
        f"steps")
    return dict(cfg7, model=model, pts=pts, state0=state0)


#: phase 7w's runs of phase B: (label, window budget, the table route)
GRID_COUPLED_RUNS = (("K5 fused", 4e9, False),
                     ("the table route, one launch", 64e9, True),
                     ("the table route, point slices", 4e9, True),
                     ("K5 fused at a budget of 0", 0.0, False))


def phase_grid_coupled(cfg7, runs=GRID_COUPLED_RUNS, init_h=24, ph="7w",
                       variants=()):
    """Phase 7w: the coupled grid at full size.  Phase B through K5 fused
    (the window's forcing prepared in the kernel) at the default budget
    and at a budget of 0, against the table route (the reference switch:
    the points' prepared window, about 27 GB at 1M points) in one launch
    and over the point slices of the default budget, every run bit for bit
    equal to the first; each run's wall, phase seconds, launches,
    window-table calls and peak memory; K5 fused and K5 on the table (one
    launch) timed again on their runs' window inputs; K5 fused's run at a
    budget of 0 held to its plain version on its first 65,536 points
    (``fused_head_check``), which gives the bound of its launch.  Phase
    7s runs only the last, on its own grid (``runs``, the analysis's end
    ``init_h`` and the phase's name ``ph``); each of ``variants`` is held
    to K5 fused and timed beside it.  Returns (K3 fused launches,
    K5 fused's figures: err, ms, table_ms, bound, and the last run's wall,
    phase B seconds and peak bytes)."""
    c = grid_coupled_setup(cfg7, init_h=init_h)
    T = c["T"]
    ref, n_k3, fig = None, 0, {"err": 0.0}
    for label, budget, table in runs:
        m = RunMetrics(announce=True)
        torch.cuda.reset_peak_memory_stats(DEV)
        reset_counts()
        t0 = time.perf_counter()
        # the runs timed again keep their window call's inputs (the state
        # after phase A copied, 0.14 GB at 1M points: in their peak)
        timed = not budget or budget > 4e9
        with (window_table_route() if table else contextlib.nullcontext()), \
                WindowTables() as tables, (
                    window_calls([], n_check=0 if table else 65536)
                    if timed else contextlib.nullcontext()) as kept:
            res = production.run_production_coupled(
                c["model"], c["exp"], c["pts"], c["cal"], c["state0"],
                chunk_t=c["chunk_t"], metrics=m, wcache_bytes=budget,
                progress=Progress(T, every_s=5.0))
        launches = read_counts()
        # the table route's K5 launches are the reference's, not the main
        # path's
        k5 = read_window_count(main_path=not table, fused=not table)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(DEV)
        check_outputs(res, c)
        cnt, phs = m.counters, m.phases
        assert cnt["coupling_reruns"] > 0, cnt
        assert launches[:3] == (0, 0, 0) and launches[3] > 0, launches
        if table:
            assert tables.n == k5 and cnt["coupling_window_cached"] == (
                budget > 4e9), (tables.n, k5, cnt)
        else:
            assert tables.n == 0 and k5 == 1, (tables.n, k5)
            assert cnt["coupling_window_cached"] == 1, cnt
        n_k3 += launches[3]
        log(f"  [{card_line()}] {ph}, coupled grid, phase B through {label} "
            f"({budget / 1e9:.0f} GB a device): wall {wall:.2f} s, phase "
            f"A {phs['phase_a']:.2f} s, phase B {phs['phase_b']:.2f} s, "
            f"phase C {phs['phase_c']:.2f} s; K3 fused launches "
            f"{launches[3]}, {'K5' if table else 'K5 fused'} launches {k5}, "
            f"window tables built {tables.n}; window steps "
            f"{cnt['coupling_window_steps']}, most re-runs of a point "
            f"{cnt['coupling_reruns']}, steps of the slowest lane "
            f"{cnt['coupling_window_rows']}; points coupled "
            f"{cnt['coupling_points']}, failed {cnt['coupling_failed']}; "
            f"peak device memory {peak / 2**30:.2f} GiB")
        fig.update(wall=wall, phase_b=phs["phase_b"], peak=peak)
        if ref is None:
            ref = res
        else:
            assert_same_result(f"{ph}, coupled grid: {label} vs K5 fused",
                               res, ref)
        if timed:
            # the window kernel of this run timed again on its inputs, here
            # (inputs kept through a later run would count in its peak)
            args, kw, sl, run_part = kept[0]
            again = wk.window_cuda(*args, **kw)
            if not table:
                f = launch_line("K5 fused", f"({ph})")
                assert f.blocks == f.blocks_regs or ph != "7s", f
                # 7w couples phase 7's grid, 7s a grid of 8 channels
                assert f.channel_set == (ph != "7s"), f
            ms = cuda_ms(lambda: wk.window_cuda(*args, **kw), reps=3)
            lane, warp, slow = window_stats(again.steps)
            n = again.steps.shape[0]
            log(f"  [{card_line()}] {ph}: {'K5' if table else 'K5 fused'} at "
                f"this size {ms:.3f} ms a launch ({n} points; steps a lane "
                f"{lane / n:.2f}, issued a lane by its warp {warp / n:.2f}, "
                f"divergence factor {warp / max(lane, 1):.3f}, slowest lane "
                f"{slow}; {1e9 * ms / max(lane, 1):.2f} ps a lane step)")
            fig["table_ms" if table else "ms"] = ms
            if not table:
                head = fused_head_check(ph, args, kw, sl, run_part, again,
                                        c["model"])
                fig["err"], fig["bound"] = head["err"], head["bound"]
                if variants:
                    window_variants(f"{ph}, K5 fused on the run's window "
                                    f"inputs", args, kw, again, variants,
                                    reps=3)
                log(f"  [{card_line()}] {ph}: K5 fused {ms:.3f} ms a launch "
                    f"against its bound {head['bound'][0]:.3f} ms "
                    f"({head['bound'][1]})")
            del args, kw, again, run_part
        del res, kept
        torch.cuda.empty_cache()
    del ref
    return n_k3, fig


def subhourly_setup(metrics, side=1024, T=2048, chunk_t=512, minutes=5,
                    start_h=8):
    """Phase 7s's configuration, a sub-hourly NWP feed (a 15-minute
    nowcast's kind, at a 5-minute clock): phase 7's grid resampled to a
    ``minutes`` raw clock over the run's hours (``wide_grid``: 8 channels),
    1,048,576 points on phase 7's raster, ``T`` steps of 30 s from the
    grid's hour ``start_h`` (so a 16 h analysis ends at midnight, as 7w's
    24 h one does), hourly output, ``chunk_t``-step chunks: SPAN above the
    stage width, so each lane computes its segment lines in stages."""
    t0 = time.perf_counter()
    times, glats, glons, fields = grid_fields_gen_production()
    times, fields = wide_grid(times, fields, start_h,
                              start_h + -(-T * 30 // 3600) + 1, minutes)
    lat1, lon1, lat2, lon2 = BBOX
    glat, glon = np.meshgrid(np.linspace(lat1, lat2, side),
                             np.linspace(lon1, lon2, side), indexing="ij")
    plat, plon = glat.ravel(), glon.ravel()
    sim = times[0] + 30 * np.arange(T, dtype=np.int64)
    cal = Calendar.from_epochs(sim)
    settings = ModelSettings(sim_len=T, dt=30.0, output_step_minutes=60,
                             use_relaxation=False, use_coupling=False)
    model = Model(settings, device=DEV)
    with metrics.phase("subhourly_setup"):
        exp = production.GridExpander(times, glats, glons, fields, plat,
                                      plon, sim, DEV, chunk_t=chunk_t)
        torch.cuda.synchronize()
    rows_gb = 4 * exp.K * len(plat) * len(exp.var_names) / 1e9
    log(f"  [{card_line()}] sub-hourly grid {fields['tair'].shape} on a "
        f"{minutes}-minute clock, {len(exp.var_names)} channels, the "
        f"{side} x {side} raster: setup {time.perf_counter() - t0:.1f} s; "
        f"K {exp.K}, KW {exp.KW}, SPAN {exp.SPAN} at {chunk_t}-step "
        f"chunks (grid_span {production.grid_span(times, sim, chunk_t)}), "
        f"raw rows on the card {rows_gb:.2f} GB")
    pts = default_point_params(len(plat))._replace(lat=plat, lon=plon)
    first = RawForcing(**{n: np.asarray(exp.first_host[n])[:, None]
                          for n in RawForcing._fields})
    state0 = model.init(first, cal, dtype=torch.float32)
    return dict(model=model, exp=exp, pts=pts, cal=cal, state0=state0,
                T=T, npoints=len(plat), chunk_t=chunk_t)


def fused_variants(label, fused, variants, reps):
    """K3 fused (``fused()`` launches it) from each of ``variants`` (label,
    sources): held to this build's profile and state bit for bit, then
    timed beside this build in turns (this build and each variant, then
    the reverse)."""
    libs = [("this build", build.load(), None)] + load_variants(variants)
    want = fused()
    for name, lib, stage in libs[1:]:
        with kernel_library(lib, stage):
            got = fused()
        torch.cuda.synchronize()
        assert all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got[:2], want[:2])), (label, name)
        del got
    ms = {name: [] for name, _, _ in libs}
    for seq in (libs, libs[::-1]):
        for name, lib, stage in seq:
            with kernel_library(lib, stage):
                ms[name].append(cuda_ms(fused, reps=reps))
    log(f"  [{card_line()}] {label}: K3 fused ms a launch, in turns: "
        + json.dumps({k: [round(v, 4) for v in vals]
                      for k, vals in ms.items()}))


def subhourly_chunk(c, n=65536, variants=()):
    """7s's second chunk (its steps cross stages of segment lines) through
    K3 fused at full width, timed, with its bound; its first ``n`` points
    against the plain version (the eager prep of those points, from an
    engine of their block, into scan_reference), bit for bit; each of
    ``variants`` (label, sources) held to this build bit for bit and timed
    beside it in turns.  Returns {"err", "ms", "plain_ms", "bound"}."""
    eng = production._Engine(c["model"], c["exp"], c["pts"], c["cal"],
                             c["state0"], chunk_t=c["chunk_t"])
    assert eng.fused
    t0, tc = c["chunk_t"], c["chunk_t"]
    src, kw = eng.kernel_inputs(t0)
    geo = eng.scan_kwargs(t0, tc)
    rest = (eng.cfg, eng.params, eng.grid)
    fused = lambda: sk.scan_cuda_fused(eng.tmp0, eng.scal0, src, *rest,
                                       **geo, **kw)
    got = fused()
    f = launch_line("K3 fused", "(7s)")
    assert f.blocks == f.blocks_regs and c["exp"].SPAN > f.stage, f
    ms = cuda_ms(fused, reps=5)
    if variants:
        fused_variants(f"7s, the 1M x {tc} chunk", fused, variants, reps=3)
    sub = production._Engine(
        c["model"], c["exp"].block(0, n, DEV),
        PointParams(*(np.asarray(x)[:n] for x in c["pts"])), c["cal"],
        State(*(x[:n] for x in c["state0"])), chunk_t=c["chunk_t"])
    ssrc, skw = sub.kernel_inputs(t0)
    stats = {}
    e0 = time.perf_counter()
    want = sk.scan_fused_reference(sub.tmp0, sub.scal0, ssrc, *rest,
                                   **geo, **skw, stats=stats)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - e0)
    rows = len(range(-(-t0 // eng.os_) * eng.os_, t0 + tc, eng.os_))
    part = (got[0][:, :n], got[1][:, :n], got[2][:rows, :6, :n])
    ref = (want[0], want[1], want[2][:rows, :6])
    for g, w in zip(part, ref):
        assert torch.equal(g.contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32)), \
            "7s: K3 fused vs its plain version"
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(part, ref))
    scale = eng.P_pad / n
    bound = fused_bound(eng, src, geo, {k: v * scale
                                        for k, v in stats.items()})
    log(f"  [{card_line()}] 7s K3 fused, 1M x {tc} chunk at offset {t0} "
        f"(SPAN {src.kernel_args()['span']}, "
        f"{chunk_lines(src.kernel_args(), t0, tc, f.stage)} segment lines "
        f"a lane a "
        f"channel): {ms:.3f} ms against its bound {bound[0]:.3f} ms "
        f"({bound[1]}; the plain version's counts on {n} points, scaled); "
        f"== its plain version bit for bit on points [0, {n}) (profile, "
        f"state, output rows; plain version {plain_ms:.1f} ms)")
    del got, want, eng, sub, src, ssrc
    torch.cuda.empty_cache()
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound)


def phase_subhourly(metrics, variants=()):
    """Phase 7s (see the module docstring); ``variants`` are timed beside
    K3 fused and K5 fused.  Returns (K3 fused launches, {"k3":
    subhourly_chunk's figures, "k5": phase_grid_coupled's})."""
    c = subhourly_setup(metrics)
    res, n_k3, fig = phase_grid_full(c, RunMetrics(announce=True),
                                     "7s, sub-hourly grid")
    STREAMS["7s, sub-hourly grid", production.PIPELINE_DEPTH] = fig
    del res
    torch.cuda.empty_cache()
    k3 = subhourly_chunk(c, variants=variants)
    n_cpl, k5 = phase_grid_coupled(c, runs=GRID_COUPLED_RUNS[-1:],
                                   init_h=16, ph="7s", variants=variants)
    del c
    torch.cuda.empty_cache()
    return n_k3 + n_cpl, {"k3": k3, "k5": k5}


def composite_sky_setup(cfg7, cfg):
    """Phase 7b's configuration: phase 7's grid overlaid by phase 5's
    2,048 stations' road-surface obs (the operational overlay,
    examples/example2/src/roadrunner.cpp:763-792), wind, and the direct
    shortwave and net longwave that the sky-view correction reads and the
    grid lacks; sky view 0.6 and U(0, 25) degree horizons on every third
    point."""
    P = cfg7["npoints"]
    raw_obs = _only(cfg["raw_st"], {"tsurf_obs", "vz", "sw_dir", "lw_net"})
    sexp = production.StationExpander(raw_obs, cfg["st_idx"][:P], DEV,
                                      chunk_t=cfg7["chunk_t"])
    exp = production.CompositeExpander([cfg7["exp"], sexp])
    assert exp.tile_geom == cfg7["exp"].tile_geom
    rng = np.random.default_rng(29)
    sky = np.where(np.arange(P) % 3 == 0, 0.6, 1.0)
    hor = np.zeros((P, 360), np.float32)
    hor[::3] = rng.uniform(0, 25, (len(hor[::3]), 360))
    pts = cfg7["pts"]._replace(sky_view=sky, horizons=hor)
    first = RawForcing(**{n: np.asarray(exp.first_host[n])[:, None]
                          for n in RawForcing._fields})
    state0 = cfg7["model"].init(first, cfg7["cal"], dtype=torch.float32)
    return dict(cfg7, exp=exp, pts=pts, state0=state0,
                overlay=(raw_obs, cfg["st_idx"][:P]))


# ---------------------------------------------------------------------------
# the runner CLI end to end (phase 9)
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples")
#: the example data's forecast time (make_data.py --now 201912020000)
CLI_TIME = "20191202T0000"
#: the full-size runs' points.grid: 1024 x 1024 = 1,048,576 points
CLI_SIDE = 1024
#: phase 9a's raster: over the 86 stations make_data places below 90 N
#: (station k at 60.2 + 0.35 k N, 24.9 + 0.55 k E; the other 1,962 of the
#: 2,048 lie past the pole), with a radius that gives every point one
EX1_BBOX = [60.15, 24.85, 89.5, 71.2]
EX1_RADIUS_KM = 2500.0


def make_example(name, outdir, args):
    """examples/<name>/make_data.py into ``outdir``; returns its seconds."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_make_data", os.path.join(EXAMPLES, name, "make_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        mod.main(list(args) + ["--outdir", outdir])
    return time.perf_counter() - t0


def write_json(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def ex1_config(outdir, side=CLI_SIDE, analysis=24, forecast=50, dt=30,
               coupling=0, sky=False, coupling_minutes=None):
    """examples/example1/example_config.json over make_data's files in
    ``outdir``: the points a ``side`` x ``side`` raster (stations mode for
    side 0), uncoupled unless asked, sky view only in stations mode (the
    files are keyed by station id), no output file."""
    cfg = sources.read_json_tolerant(
        os.path.join(EXAMPLES, "example1", "example_config.json"))
    cfg["time"].update(analysis=analysis, forecast=forecast)
    if coupling_minutes:
        cfg["time"]["coupling_minutes"] = coupling_minutes
    cfg["model"].update(DTSecs=dt, use_coupling=coupling)
    for src in cfg["input"]:
        src["path"] = os.path.join(outdir, os.path.basename(src["path"]))
    if sky:
        cfg["parameters"].update(
            sky_view_file=os.path.join(outdir, "skyview.txt"),
            local_horizon_file=os.path.join(outdir, "horizons.txt"))
    else:
        cfg["parameters"] = {}
    del cfg["output"]["filename"]
    if side:
        cfg["points"] = {"grid": {"bbox": EX1_BBOX, "ny": side, "nx": side},
                         "max_radius_km": EX1_RADIUS_KM}
    return cfg


def ex2_config(outdir, side=CLI_SIDE, analysis=24, forecast=50, dt=30,
               coupling=0, coupling_minutes=None):
    """examples/example2/grid_config.json over make_data's files in
    ``outdir`` (the NWP grid and the ASCII road station), its points.grid
    at ``side`` x ``side`` over the same box, no mask (make_data's masks
    are at the NWP grid's size), no output file."""
    cfg = sources.read_json_tolerant(
        os.path.join(EXAMPLES, "example2", "grid_config.json"))
    cfg["time"].update(analysis=analysis, forecast=forecast)
    if coupling_minutes:
        cfg["time"]["coupling_minutes"] = coupling_minutes
    cfg["model"].update(DTSecs=dt, use_coupling=coupling)
    cfg["points"]["grid"].update(ny=side, nx=side)
    del cfg["points"]["mask"]
    cfg["input"][0]["path"] = os.path.join(outdir, "forecast_grid.npz")
    cfg["input"][1]["path"] = os.path.join(outdir, "road_station.txt")
    del cfg["output"]["filename"]
    return cfg


def run_cli(argv, metrics):
    """``runner.main(argv)`` in this process, with ``metrics`` handed to
    its run and the run's (state, fields) kept; also the seconds from the
    call to the first sharded launch (the first chunk)."""
    kept = {}
    run, scan_sharded = runner.run, sharding.scan_sharded

    def keep_run(*a, **k):
        kept["res"] = run(*a, metrics=metrics, **k)
        return kept["res"]

    def first_chunk(*a, **k):
        kept.setdefault("first", time.perf_counter())
        return scan_sharded(*a, **k)

    runner.run, sharding.scan_sharded = keep_run, first_chunk
    t0 = time.perf_counter()
    try:
        runner.main(argv)
    finally:
        runner.run, sharding.scan_sharded = run, scan_sharded
    return kept["res"], kept["first"] - t0


def phase_cli_full(label, cfg, outdir, samples, route, depths=(1, 2)):
    """The CLI at full size: ``runner.main(["-c", cfg, "-t", CLI_TIME])``
    as an operator types it, at each PIPELINE_DEPTH of ``depths`` (1 and
    then 2, held to each other bit for bit), with each run's launches
    counted (K2 or K3 fused by ``route``, K4 once a chunk); a 64-point
    sample of the last run re-run through the scan engine on the card
    (``start_cli``).  Returns the launches of the runs (K1, K2, K3, K3
    fused) and their K4 launches."""
    cfg_path = write_json(cfg, os.path.join(outdir, f"{label}.json"))
    P, T = CLI_SIDE * CLI_SIDE, 8881
    total, k4_total, kept = [0, 0, 0, 0], 0, None
    for depth in depths:
        m = RunMetrics(announce=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(DEV)
        reset_counts()
        t0 = time.perf_counter()
        with StreamProbe() as probe, pipeline_depth(depth):
            (state, fields), first = run_cli(["-c", cfg_path, "-t",
                                              CLI_TIME], m)
        wall = time.perf_counter() - t0
        chunk_t = int(m.counters["chunk_t"])
        n_chunks = -(-T // chunk_t)
        k4 = sk.LAUNCHES_SHARDED
        launches = read_counts(n_chunks)
        peak = torch.cuda.max_memory_allocated(DEV)
        want = (0, n_chunks, 0, 0) if route == "K2" else (0, 0, 0, n_chunks)
        assert launches == want, (label, launches, want)
        total = [a + b for a, b in zip(total, launches)]
        k4_total += k4
        steps = fields["steps"]
        assert np.array_equal(steps, np.arange(0, T, 120)), steps
        for name in production.OUT_FIELD_ROWS:
            f = fields[name]
            assert f.shape == (len(steps), P), (name, f.shape)
            assert np.all(np.isfinite(f) | (f == -9999.0)), name
        failed = float(state.failed.float().mean())
        ph = {k: round(v, 3) for k, v in m.phases.items()}
        log(f"  [{card_line()}] {label}, PIPELINE_DEPTH {depth}: runner.main "
            f"wall {wall:.2f} s, {P} points x {T} steps, chunk_t {chunk_t} "
            f"(auto_chunk_t), stream {m.phases['stream']:.2f} s = "
            f"{m.counters['point_steps_per_s']:.6g} point-steps/s, time to "
            f"first chunk {first:.2f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB, failed share {failed:.6f}, native "
            f"data-plane library "
            f"{'taken' if native.load() else 'not built'}; launches K1 "
            f"{launches[0]} K2 {launches[1]} K3 {launches[2]} K3 fused "
            f"{launches[3]} K4 {k4}")
        log(f"  [{card_line()}] {label} phases (s): " + json.dumps(ph))
        STREAMS[f"9, {label}", depth] = stream_line(
            f"9, {label}", depth, m, probe, peak, wall)
        if kept is None and depth != depths[-1]:
            kept = (state, fields)
            del state, fields
    bits = lambda a: np.ascontiguousarray(a).view(np.int32)
    if kept is not None:
        for name in production.OUT_FIELD_ROWS:
            if not np.array_equal(bits(fields[name]), bits(kept[1][name])):
                raise AssertionError(f"9, {label}: {name} differs between "
                                     f"PIPELINE_DEPTH 2 and 1")
        for name, g, w in zip(state._fields, state, kept[0]):
            if not torch.equal(g, w):
                raise AssertionError(f"9, {label}: final state {name} "
                                     f"differs between PIPELINE_DEPTH 2 and 1")
        log(f"  9, {label}: PIPELINE_DEPTH 2 vs 1 equal bit for bit (every "
            f"output row and the final state)")
    del kept

    # the sample: a points.coordinates config of 64 of the raster's points
    idx = np.linspace(0, P - 1, 64).astype(np.int64)
    pset = points.parse_points_full(cfg)
    coords = dict(cfg, points={
        "coordinates": [[float(pset.lats[i]), float(pset.lons[i])]
                        for i in idx],
        "max_radius_km": cfg["points"]["max_radius_km"]})
    samples.start_cli(
        write_json(coords, os.path.join(outdir, f"{label}_sample.json")),
        64, T, state.failed[idx].numpy(),
        {name: fields[name][:, idx].copy()
         for name in production.OUT_FIELD_ROWS}, steps,
        f"9, {label}")
    return total, k4_total


def hold_engines(label, kernel, scan, tol=dict(rtol=1e-4, atol=5e-3)):
    """A kernel-engine run against the scan engine (float64) of the same
    config, at the output steps (tests/test_production.py:215-262's
    tolerances); equal failed masks.  Returns the largest |err|."""
    (ks, kf), (ss, sf) = kernel, scan
    err = 0.0
    for name in production.OUT_FIELD_ROWS:
        err = max(err, check_close(
            f"{label} {name}", torch.from_numpy(np.asarray(kf[name])),
            torch.from_numpy(np.asarray(sf[name])[kf["steps"]]), tol))
    if not torch.equal(ks.failed.cpu(), ss.failed.cpu()):
        raise AssertionError(f"{label}: failed masks differ")
    return err


def same_checkpoints(label, a, b, tol=dict(rtol=1e-4, atol=5e-3)):
    """Two checkpoint files through the port's reader: equal ids and
    epoch, the states at ``tol``."""
    fa, ia, ea = writer.load_checkpoint(a)
    fb, ib, eb = writer.load_checkpoint(b)
    assert np.array_equal(ia, ib) and ea == eb and set(fa) == set(fb), label
    for k in fa:
        if fa[k].dtype.kind == "b":
            assert np.array_equal(fa[k], fb[k]), (label, k)
        else:
            check_close(f"{label} {k}", torch.from_numpy(fa[k]),
                        torch.from_numpy(fb[k]), tol)


def same_json_files(label, a, b, tol=dict(rtol=1e-4, atol=5e-3)):
    """Two forecast JSON files: equal ids, locations and times, values at
    ``tol``."""
    with open(a) as fa, open(b) as fb:
        da, db = json.load(fa), json.load(fb)
    assert len(da) == len(db), label
    for ra, rb in zip(da, db):
        assert (ra["statId"], ra["lat"], ra["lon"], ra["time"]) == (
            rb["statId"], rb["lat"], rb["lon"], rb["time"]), label
        for k in ("RoadTemperature", "Water", "Snow", "Ice", "Deposit"):
            check_close(f"{label} {k}", torch.tensor(ra[k]),
                        torch.tensor(rb[k]), tol)
    return len(da)


def phase_cli_small(ex1_dir, ex2_dir):
    """Phase 9c: the CLI's configurations at a few thousand points on the
    card, 2 h of analysis and 2 h of forecast at dt 120 s, the kernel
    engine against the scan engine (float64 on the card) at rtol 1e-4 /
    atol 5e-3 with equal failed masks, and the files each writes read
    back; the warm-start cycle; one run of the console entry in a process
    of its own."""
    tmp = tempfile.mkdtemp(prefix="cli_small_", dir=ex1_dir)
    small = dict(analysis=2, forecast=2, dt=120)
    path = lambda name: os.path.join(tmp, name)

    def both(label, cfg, **kw):
        cfg_path = write_json(cfg, path(f"{label}.json"))
        out = {}
        for engine in ("kernel", "scan"):
            k = {n: v.format(engine=engine) for n, v in kw.items()}
            t0 = time.perf_counter()
            out[engine] = runner.run(cfg_path, k.pop("t", CLI_TIME),
                                     verbose=False, device="cuda",
                                     engine=engine, **k)
            out[engine + "_s"] = time.perf_counter() - t0
        err = hold_engines(label, out["kernel"], out["scan"])
        n = out["kernel"][1]["tsurf"].shape[1]
        log(f"  [{card_line()}] 9c {label}: {n} points, kernel engine "
            f"{out['kernel_s']:.2f} s, scan engine {out['scan_s']:.2f} s, "
            f"max |err| {err:.3e}")
        return cfg_path, out

    # example1 in stations mode with its whole feature set: sky view and
    # horizons on half the stations, relaxation, coupling (a 60-minute
    # window inside the analysis): K3 fused around phase B
    _, o1 = both("ex1 stations, sky view, coupled",
                 ex1_config(ex1_dir, side=0, sky=True, coupling=1,
                            coupling_minutes=60, **small),
                 output_path=path("ex1_{engine}.json"),
                 checkpoint_out=path("ex1_{engine}_ck.npz"))
    n = same_json_files("9c example1 JSON", path("ex1_kernel.json"),
                        path("ex1_scan.json"))
    same_checkpoints("9c example1 checkpoints", path("ex1_kernel_ck.npz"),
                     path("ex1_scan_ck.npz"))
    assert n == 2048, n
    # example2: the NWP grid under the road station's obs at 64 x 64
    # points (K3 fused), uncoupled and coupled, the gridded npz written
    both("ex2 grid + station", ex2_config(ex2_dir, side=64, **small),
         output_path=path("ex2_{engine}.npz"))
    za, zb = np.load(path("ex2_kernel.npz")), np.load(path("ex2_scan.npz"))
    assert za.files == zb.files
    for k in za.files:
        if za[k].dtype.kind == "f":
            check_close(f"9c example2 npz {k}", torch.from_numpy(za[k]),
                        torch.from_numpy(zb[k]), dict(rtol=1e-4, atol=5e-3))
        else:
            assert np.array_equal(za[k], zb[k]), k
    assert za["tsurf"].shape == (5, 64, 64), za["tsurf"].shape
    _, oc = both("ex2 grid + station, coupled",
                 ex2_config(ex2_dir, side=64, coupling=1,
                            coupling_minutes=60, **small))
    # the warm-start cycle: example1's stations on a 64 x 64 raster (K2),
    # checkpoint out at 00 UTC, in at 01 UTC
    cyc = ex1_config(ex1_dir, side=64, **small)
    cyc_path, c1 = both("ex1 raster, cycle 1", cyc,
                        checkpoint_out=path("cyc_{engine}.npz"))
    same_checkpoints("9c cycle checkpoints", path("cyc_kernel.npz"),
                     path("cyc_scan.npz"))
    _, c2 = both("ex1 raster, cycle 2 (warm)", cyc, t="20191202T0100",
                 checkpoint_in=path("cyc_{engine}.npz"),
                 output_path=path("cyc2_{engine}.json"))
    _, cold = both("ex1 raster, cycle 2 (cold)", cyc, t="20191202T0100")
    assert not np.allclose(c2["kernel"][1]["tsurf"][0],
                           cold["kernel"][1]["tsurf"][0])
    # the console entry in a process of its own, on the card: the same
    # file as the in-process warm run
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "roadsurf_tpu_torch.runner", "-c", cyc_path,
         "-t", "20191202T0100", "--checkpoint-in", path("cyc_kernel.npz"),
         "-o", path("cyc2_cli.json")],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"python -m roadsurf_tpu_torch.runner exit "
                             f"code {res.returncode}:\n{res.stderr[-4000:]}")
    with open(path("cyc2_cli.json"), "rb") as fa, \
            open(path("cyc2_kernel.json"), "rb") as fb:
        assert fa.read() == fb.read(), "console entry's file differs"
    log(f"  [{card_line()}] 9c python -m roadsurf_tpu_torch.runner (warm "
        f"cycle 2 on the card): exit code 0 in "
        f"{time.perf_counter() - t0:.1f} s, its JSON equal byte for byte "
        f"to the in-process run's")


def phase_chunk_sweep(cfg, counts=(1048576, 65536), chunks=(32, 64, 128, 256),
                      rounds=2):
    """Phase 9t, the measurement behind ``production.auto_chunk_t``: phase
    5's station stream (K2) at 1,048,576 and 65,536 points at each chunk
    length, in turns, with its stream seconds and peak device memory
    (phase 5's expander stays resident; the resident bytes before each run
    are printed beside the peak)."""
    rows = {}
    for r in range(rounds):
        for P in counts:
            for c in chunks:
                exp = production.StationExpander(
                    cfg["raw_st"], cfg["st_idx"][:P], DEV, chunk_t=c,
                    prep_ctx=cfg["ctx"])
                pts = PointParams(*(np.asarray(x)[:P] for x in cfg["pts"]))
                state0 = State(*(x[:P] for x in cfg["state0"]))
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated(DEV)
                torch.cuda.reset_peak_memory_stats(DEV)
                m = RunMetrics()
                res = production.run_production(
                    cfg["model"], exp, pts, cfg["cal"], state0, chunk_t=c,
                    metrics=m)
                peak = torch.cuda.max_memory_allocated(DEV)
                rows.setdefault((P, c), []).append(
                    (m.phases["stream"], res.point_steps_per_s, peak,
                     resident))
                del exp, res, state0
                torch.cuda.empty_cache()
    for (P, c), rs in rows.items():
        log(f"  [{card_line()}] 9t station stream, {P} points, chunk {c}: "
            f"stream {[round(x[0], 3) for x in rs]} s = "
            f"{[float(f'{x[1]:.4g}') for x in rs]} point-steps/s, peak "
            f"device memory {[round(x[2] / 2**30, 2) for x in rs]} GiB "
            f"({rs[0][3] / 2**30:.2f} GiB resident before)")
    return rows


def phase_cli_coupled(outdir, samples):
    """Phase 9d: examples/example1/example_config.json as shipped (coupling
    and relaxation on, the 180-minute window) over 9a's inputs and its
    1024 x 1024 raster, 1,048,576 points x 8,881 steps, at PIPELINE_DEPTH 2,
    through K2, K5 and K4; its outputs and final state against the
    library-level run_production_coupled called again on the arguments the
    runner handed it (the same expander, points, state, anchors and
    geometry), bit for bit; a 64-point sample as 9a's.  Returns the run's
    launches (K1, K2, K3, K3 fused) and its K4 launches."""
    label = "example1 raster, coupled"
    cfg = ex1_config(outdir, coupling=1)
    assert cfg["model"]["use_relaxation"] and cfg["time"][
        "coupling_minutes"] == 180, cfg
    cfg_path = write_json(cfg, os.path.join(outdir, "example1_coupled.json"))
    side, t = cfg["points"]["grid"]["nx"], cfg["time"]
    P = side * cfg["points"]["grid"]["ny"]
    T = int((t["analysis"] + t["forecast"]) * 3600
            // cfg["model"]["DTSecs"]) + 1
    kept = {}
    lib_run = production.run_production_coupled

    def keep(*a, **k):
        kept["args"] = (a, k)
        return lib_run(*a, **k)
    m = RunMetrics(announce=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    reset_counts()
    production.run_production_coupled = keep
    try:
        t0 = time.perf_counter()
        with StreamProbe() as probe, pipeline_depth(2):
            (state, fields), first = run_cli(["-c", cfg_path, "-t",
                                              CLI_TIME], m)
        wall = time.perf_counter() - t0
    finally:
        production.run_production_coupled = lib_run
    k4 = sk.LAUNCHES_SHARDED
    launches = read_counts()
    k5 = read_window_count(main_path=True)
    peak = torch.cuda.max_memory_allocated(DEV)
    assert launches[1] > 0 and launches[1] == sum(launches), launches
    steps = fields["steps"]
    stride = int(cfg["output"]["step"] * 60 // cfg["model"]["DTSecs"])
    assert np.array_equal(steps, np.arange(0, T, stride)), steps
    for name in production.OUT_FIELD_ROWS:
        f = fields[name]
        assert f.shape == (len(steps), P), (name, f.shape)
        assert np.all(np.isfinite(f) | (f == -9999.0)), name
    c, ph = m.counters, m.phases
    assert c["coupling_reruns"] > 0, c
    log(f"  [{card_line()}] {label}, PIPELINE_DEPTH 2: runner.main wall "
        f"{wall:.2f} s, {P} points x {T} steps, chunk_t "
        f"{int(c['chunk_t'])}, stream {ph['stream']:.2f} s (phase A "
        f"{ph['phase_a']:.2f}, phase B {ph['phase_b']:.2f}, phase C "
        f"{ph['phase_c']:.2f}), time to first chunk {first:.2f} s, peak "
        f"device memory {peak / 2**30:.2f} GiB, failed share "
        f"{float(state.failed.float().mean()):.6f}; launches K2 "
        f"{launches[1]} K4 {k4} K5 {k5}; coupling: window steps "
        f"{c['coupling_window_steps']}, most re-runs of a point "
        f"{c['coupling_reruns']}, steps of the slowest lane "
        f"{c['coupling_window_rows']}, points coupled "
        f"{c['coupling_points']}, succeeded {c['coupling_succeeded']}, "
        f"failed {c['coupling_failed']}")
    log(f"  [{card_line()}] {label} phases (s): " + json.dumps(
        {k: round(v, 3) for k, v in ph.items()}))
    STREAMS[f"9d, {label}", 2] = stream_line(f"9d, {label}", 2, m, probe,
                                             peak, wall)
    # the library-level run on the runner's own arguments
    a, k = kept.pop("args")
    with pipeline_depth(2):
        lib = lib_run(*a, **dict(k, metrics=RunMetrics(), progress=None))
    del a, k
    bits = lambda x: np.ascontiguousarray(x).view(np.int32)
    diff = [name for name in production.OUT_FIELD_ROWS
            if not np.array_equal(bits(fields[name]), bits(lib.fields[name]))]
    diff += [name for name, g, w in zip(state._fields, state, lib.state)
             if not torch.equal(g, w)]
    if diff:
        raise AssertionError(f"9d: the CLI and the library-level "
                             f"run_production_coupled differ in {diff}")
    log(f"  9d: the CLI == the library-level run_production_coupled on the "
        f"same inputs, bit for bit (every output row and the final state)")
    del lib
    idx = np.linspace(0, P - 1, 64).astype(np.int64)
    pset = points.parse_points_full(cfg)
    coords = dict(cfg, points={
        "coordinates": [[float(pset.lats[i]), float(pset.lons[i])]
                        for i in idx],
        "max_radius_km": cfg["points"]["max_radius_km"]})
    samples.start_cli(
        write_json(coords, os.path.join(outdir, "example1_coupled_sample"
                                                ".json")),
        64, T, state.failed[idx].numpy(),
        {name: fields[name][:, idx].copy()
         for name in production.OUT_FIELD_ROWS}, steps, f"9d, {label}")
    return launches, k4


def phase_cli(samples, run9=True, run9d=False):
    """Phase 9: the runner CLI end to end on inputs from the two example
    generators (see the module docstring); 9a-9c with ``run9``, 9d with
    ``run9d``."""
    base = tempfile.mkdtemp(prefix="cli_")
    ex1_dir, ex2_dir = (os.path.join(base, n) for n in ("ex1", "ex2"))
    os.makedirs(ex1_dir)
    os.makedirs(ex2_dir)
    t0 = time.perf_counter()
    lib = native.load(build_if_missing=True)
    log(f"  native data-plane library (make -C native): "
        f"{'built and loaded' if lib else 'unavailable, numpy paths'} in "
        f"{time.perf_counter() - t0:.1f} s")
    s1 = make_example("example1", ex1_dir, ["--stations", "2048",
                                            "--analysis", "24",
                                            "--forecast", "50"])
    log(f"  make_data: example1 2,048 stations in {s1:.1f} s")
    launched = {}
    if run9d:
        log("== 9d. the CLI at full size on example1's shipped config, "
            "coupled: 1048576 points x 8881 steps")
        launched["9d"] = phase_cli_coupled(ex1_dir, samples)
        torch.cuda.empty_cache()
    if not run9:
        return base, launched
    s2 = make_example("example2", ex2_dir, ["--ny", "300", "--nx", "400",
                                            "--analysis", "24",
                                            "--forecast", "50"])
    log(f"  make_data: example2 300 x 400 x 75 grid in {s2:.1f} s")
    log("== 9a. the CLI at full size, station-fed (example1): 1048576 "
        "points x 8881 steps")
    launched["9a"] = phase_cli_full("example1 raster", ex1_config(ex1_dir),
                                    ex1_dir, samples, "K2")
    torch.cuda.empty_cache()
    log("== 9b. the CLI at full size, NWP grid + station obs (example2): "
        "1048576 points x 8881 steps")
    # 9b at depth 2 only: phase 7 holds the K3 fused route's depths to each
    # other, 9a the CLI's
    launched["9b"] = phase_cli_full("example2 raster", ex2_config(ex2_dir),
                                    ex2_dir, samples, "K3 fused", depths=(2,))
    torch.cuda.empty_cache()
    log("== 9c. the CLI's configurations small on the card, kernel engine "
        "against scan engine")
    phase_cli_small(ex1_dir, ex2_dir)
    return base, launched


def main():
    with SampleRuns() as samples:
        run_phases(samples)


def run_phases(samples):
    args, variants = parse_variants(sys.argv[1:])
    sel = set(args)
    known = {"2s", "3", "3b", "3c", "3d", "3e", "3f", "3w", "4", "4b", "4c",
             "5", "6", "7", "7b", "7s", "7w", "8", "8b", "9", "9d", "9t"}
    if sel - known:
        raise SystemExit(f"unknown phases {sorted(sel - known)}; "
                         f"phases: {sorted(known)}")
    want = lambda ph: not sel or ph in sel
    # 9t, the chunk sweep behind production.auto_chunk_t, only when named
    named = lambda ph: ph in sel
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log("== 1. toolchain and device")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log("  " + nvcc.stdout.strip().splitlines()[-1])
    log(f"  card: {card}")

    log("== 2. build")
    # every library this run builds, one nvcc each, all started together
    jobs = [((), ())] + [((src,), ()) for _, src in variants
                         if not isinstance(src, int)]
    jobs += [(j[0], LINEINFO) for j in jobs] if named("2s") else []
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        built = [ex.submit(lambda j: build.build(*j[0] or (build.SOURCES,),
                                                 extra=j[1]), j)
                 for j in jobs]
        info = built[0].result()
        for f in built[1:]:
            f.result()
    log(f"  {info['path']}: {'built' if info['built'] else 'reused'} in "
        f"{info['seconds']:.2f} s ({len(jobs)} libraries built together)")
    log_build("this build", info)
    build.load()
    stamp = lambda: log(f"  ({time.perf_counter() - T0:.0f} s since start)")
    if named("2s"):
        log("== 2s. the fused kernels' time loops in SASS, by part")
        phase_sass_split(variants)

    metrics = RunMetrics(announce=True)      # phase lines on stderr
    cfg = cfg6 = cfg7 = None
    if any(want(ph) for ph in ("3", "3b", "3d", "3e", "5", "6", "7b", "8")
           ) or named("9t"):
        cfg = full_size_setup(metrics)
    if want("3"):
        log("== 3. K1 against its plain version")
        err_small = phase_kernel_small()
        err_chunk, plain_ms = phase_kernel_chunk(cfg)
        stamp()
    if want("3e"):
        log("== 3e. K2 and K1 on the station chunk in caller and in station "
            "order")
        st_order = phase_station_order(cfg, variants)
        stamp()
    if want("3b") or want("6"):
        cfg6 = coupled_full_setup(cfg, metrics)
    if want("3b"):
        log("== 3b. K2 against its plain version")
        err_slim_small = phase_kernel_slim_small()
        err_slim_chunk, slim_times = phase_kernel_slim_chunk(cfg6)
        stamp()
    if want("3w"):
        log("== 3w. K5, the coupling window, against its plain version and "
            "the eager window engine")
        k5w = phase_window_small(variants)
        stamp()
        k5fw = phase_window_fused_small()
        stamp()
    if want("3d"):
        log("== 3d. K4, the sharded launch, against its plain version and "
            "against one launch")
        err_k4_small = phase_kernel_sharded_small()
        stamp()
        k4 = phase_kernel_sharded_chunk(cfg)
        stamp()
    if want("4"):
        log("== 4. main path, small, against Model.run on the card")
        phase_main_small()
    if want("4b"):
        log("== 4b. coupled path, small, against Model.run_coupled on the "
            "card")
        phase_coupled_small()
        stamp()

    launched = [0, 0]
    res5 = res7b = cfg7b = res_sorted = None
    if want("5"):
        log("== 5. main path at full size: 1048576 points x 8881 steps")
        # K2 (the default, slim expander) and K1 (slim=False, a second
        # expander on the same stations), in turns, each at pipeline depth
        # 1 and 2: the first run pays the allocator's growth, and it is a
        # depth-2 run
        exps = {"K2": cfg["exp"], "K1": production.StationExpander(
            cfg["raw_st"], cfg["st_idx"], DEV, chunk_t=cfg["chunk_t"],
            prep_ctx=cfg["ctx"], slim=False)}
        runs = {}
        for label, depth in (("K1", 2), ("K2", 1), ("K2", 2), ("K1", 1)):
            m = RunMetrics(announce=True)
            t0 = time.perf_counter()
            res, launches, peak, failed, probe = phase_main_full(
                cfg, m, exps[label], depth)
            wall = time.perf_counter() - t0
            launched = [a + b for a, b in zip(launched, launches)]
            log(f"  [{card}] run_production ({label}) wall {wall:.2f} s, "
                f"stream {m.phases['stream']:.2f} s, "
                f"{res.point_steps_per_s:.6g} point-steps/s (stream), "
                f"peak device memory {peak / 2**30:.2f} GiB, failed share "
                f"{failed:.6f}, kernel launches K1 {launches[0]} K2 "
                f"{launches[1]}")
            log(f"  [{card}] phases (s): " + json.dumps(
                {k: round(v, 3) for k, v in m.phases.items()}))
            STREAMS[f"5, station {label}", depth] = stream_line(
                f"5, station {label}", depth, m, probe, peak, wall)
            runs[label, depth] = res
        for label in ("K1", "K2"):
            assert_same_result(f"5, station {label}: PIPELINE_DEPTH 2 vs 1",
                               runs[label, 2], runs[label, 1])
        diff = max(float(np.abs(runs["K2", 2].fields[k]
                                - runs["K1", 2].fields[k]).max())
                   for k in production.OUT_FIELD_ROWS)
        log(f"  K2 vs K1 main path, all output rows: max |diff| {diff:.3e}")
        del exps, runs["K1", 1], runs["K1", 2], runs["K2", 1]
        torch.cuda.empty_cache()
        res5 = runs["K2", 2]
        samples.start(cfg, res5)
        del runs
        # the blocks ran their points in station order: against a caller
        # that passes them in that order (the sort then the identity)
        cfg_sorted, order5 = station_sorted_setup(cfg)
        m = RunMetrics(announce=True)
        res_sorted, launches, _, _, _ = phase_main_full(cfg_sorted, m,
                                                        cfg_sorted["exp"])
        launched = [a + b for a, b in zip(launched, launches)]
        log(f"  [{card}] run_production (K2, the caller's points in station "
            f"order) stream {m.phases['stream']:.2f} s, "
            f"{res_sorted.point_steps_per_s:.6g} point-steps/s")
        assert_same_result("station-order blocks of the random-order caller "
                           "vs the station-order caller, mapped",
                           mapped(res5, order5), res_sorted)
        del cfg_sorted
        torch.cuda.empty_cache()
        stamp()

    if want("6"):
        log("== 6. coupled main path at full size: 1048576 points x 8881 "
            "steps")
        res6, launches6, k5_6 = phase_coupled_full(
            cfg6, RunMetrics(announce=True), variants)
        samples.start(cfg6, res6, coupled=True)
        launched = [a + b for a, b in zip(launched, launches6)]
        del res6
        stamp()

    k3_launches = 0
    if any(want(ph) for ph in ("3c", "7", "7w", "7b", "8")):
        log("== 7. setup: the NWP-grid forecast at full size")
        cfg7 = grid_full_setup(metrics)
        stamp()
    if want("3c"):
        log("== 3c. K3 against its plain version and against K1 / K2")
        err_tm_small = phase_kernel_tm_small()
        tm = phase_kernel_tm_chunk(cfg7)
        stamp()
        fz7 = phase_fused_chunk(cfg7, "NWP grid", variants)
        stamp()
    if want("3c") or named("3f"):
        log("== 3f. K3 fused against its plain version and the unfused "
            "route, 16,384 points")
        err_fused_small = phase_kernel_fused_small()
        stamp()
    if want("7"):
        log("== 7. the NWP-grid forecast at full size through K3: "
            "1048576 points x 8881 steps")
        for depth in (1, 2):
            res7, n7, STREAMS["7, NWP grid", depth] = phase_grid_full(
                cfg7, RunMetrics(announce=True), "7, NWP grid", depth)
            k3_launches += n7
            if depth == 1:
                res7_1 = res7
                del res7
                torch.cuda.empty_cache()
        assert_same_result("7, NWP grid: PIPELINE_DEPTH 2 vs 1", res7,
                           res7_1)
        del res7_1
        samples.start(cfg7, res7, raw_fn=grid_sample_raw(cfg7),
                      hold_f32=True, label="7, NWP grid")
        del res7
        torch.cuda.empty_cache()
        stamp()
    if want("7w"):
        log("== 7w. the coupled NWP grid at full size: K5 fused against the "
            "table route in one launch and over point slices")
        n7w, k5f7 = phase_grid_coupled(cfg7, variants=variants)
        k3_launches += n7w
        stamp()
    if want("4c"):
        log("== 4c. the tile-major path, small, against Model.run / "
            "Model.run_coupled and the generic K1 route on the card")
        err_tm_paths = phase_tm_small()
        log(f"  4c max |err| against the Model runs {err_tm_paths:.3e}")
        stamp()
    if want("7b"):
        log("== 7b. grid + station obs with sky view at full size through "
            "K3: 1048576 points x 8881 steps")
        cfg7b = composite_sky_setup(cfg7, cfg)
        fz7b = phase_fused_chunk(cfg7b, "grid + stations, sky view")
        res7b, n7b, _ = phase_grid_full(cfg7b, RunMetrics(announce=True),
                                        "7b, grid + stations, sky view")
        k3_launches += n7b
        samples.start(cfg7b, res7b, raw_fn=grid_sample_raw(
            cfg7b, overlay=cfg7b["overlay"]), hold_f32=True,
            label="7b, grid + stations, sky view")
        stamp()
    if want("8"):
        log("== 8. the sharded main path at full size, against the "
            "one-block runs")
        res8 = phase_sharded_run(cfg, "station, K2", ref=res5)
        if res_sorted is not None:
            assert_same_result("4 blocks in station order vs the "
                               "station-order caller, mapped",
                               mapped(res8, order5), res_sorted)
        del res5, res8, res_sorted
        stamp()
        cfg7b = cfg7b or composite_sky_setup(cfg7, cfg)
        phase_sharded_run(cfg7b, "grid + stations, sky view, K3", ref=res7b)
        del res7b
        phase_sharded_coupled_small()
        stamp()
    if named("9t"):
        log("== 9t. the station stream at 1048576 and 65536 points by chunk "
            "length (auto_chunk_t)")
        phase_chunk_sweep(cfg)
        stamp()
    del cfg, cfg6, cfg7, cfg7b
    torch.cuda.empty_cache()
    if want("8b"):
        log("== 8b. two processes on the card, per-process shards and "
            "checkpoints")
        phase_two_processes()
        stamp()
    cli_dir = None
    if want("9") or want("9d"):
        log("== 9. the runner CLI end to end on the example generators' "
            "inputs")
        cli_dir, l9 = phase_cli(samples, want("9"), want("9d"))
        launched[1] += l9.get("9a", ((0, 0, 0, 0),))[0][1]
        launched[1] += l9.get("9d", ((0, 0, 0, 0),))[0][1]
        k3_launches += l9.get("9b", ((0, 0, 0, 0),))[0][3]
        stamp()
    # last: its host set-up and plain checks overlap the sample re-runs
    if want("7s"):
        log("== 7s. a sub-hourly grid at full width, SPAN above one stage "
            "of segment lines: K3 fused and K5 fused")
        n7s, fig7s = phase_subhourly(metrics, variants)
        k3_launches += n7s
        stamp()
    log("== the 64-point samples of the full-size runs, re-run beside the "
        "phases above")
    samples.finish()
    if STREAMS:
        log(f"== the streams at PIPELINE_DEPTH 1 and 2 [{card}] (s: stream, "
            f"output; card busy share of the stream; host issue ms a chunk; "
            f"peak GiB)")
    for label in dict.fromkeys(k[0] for k in STREAMS):
        log(f"  {label}: " + "; ".join(
            f"depth {f['depth']}: {f['stream']:.3f} + {f['output']:.3f}, "
            f"busy {100 * f['busy'] / f['stream']:.1f}%, issue "
            f"{f['issue_ms']:.3f}, peak {f['peak']:.2f}"
            for f in (STREAMS.get((label, d)) for d in (1, 2)) if f))
    if cli_dir:
        shutil.rmtree(cli_dir, ignore_errors=True)
    stamp()
    if sel:
        log(f"phases {sorted(sel)} passed; the summary needs every phase")
        return

    # K1's and K2's times are phase 3e's, on phase 5's station chunk in
    # station order, the order the main path's blocks run it in
    k1 = {"name": "scan_kernel", "launches": launched[0],
          "max_abs_err": max(err_small, err_chunk), "ms": st_order["K1"][0],
          "plain_ms": plain_ms, "bound": st_order["K1"][2]}
    k2 = {"name": "scan_kernel_slim", "launches": launched[1],
          "max_abs_err": max(err_slim_small, err_slim_chunk),
          "ms": st_order["K2"][0], "plain_ms": slim_times["slim"][1],
          "bound": st_order["K2"][2]}
    # K3 on the eager prep runs where K3 fused does not take the expander;
    # its launches are phase 4c's runs on that route
    k3 = {"name": "scan_kernel_tm", "launches": TM_SMALL_K3[0],
          "max_abs_err": max(err_tm_small, tm["err"]), "ms": tm["ms"],
          "plain_ms": tm["plain_ms"], "bound": tm["bound"]}
    k3f = {"name": "scan_kernel_tm_fused", "launches": k3_launches,
           "max_abs_err": max(err_fused_small, fz7["err"], fz7b["err"],
                              fig7s["k3"]["err"]),
           "ms": fz7["ms"], "plain_ms": fz7["plain_ms"],
           "bound": fz7["bound"]}
    # K4's time is its 4-block launch of the K2 chunk; its bound is K2's on
    # that chunk (the blocks share one card's memory)
    k4 = {"name": "scan_kernel_sharded", "launches": MAIN_PATH_K4[0],
          "max_abs_err": max(err_k4_small, k4["err"]), "ms": k4["ms"],
          "plain_ms": k4["plain_ms"], "bound": k4["bound"],
          "replaces": "roadsurf_tpu/parallel/sharding.py:73"}
    # K5 has no Pallas counterpart: it is the port's counterpart of phase
    # B's one jit; its time, plain time and bound are phase 3w's (32,768
    # points, the station table), where the plain version can be timed
    k5 = {"name": "window_kernel", "launches": MAIN_PATH_K5[0],
          "max_abs_err": max(k5w["err"], k5_6["err"]), "ms": k5w["ms"],
          "plain_ms": k5w["plain_ms"], "bound": k5w["bound"],
          "replaces": "roadsurf_tpu/production.py:2041"}
    # K5 fused's time, plain time and bound are 3w's grid case (65,536
    # points, where the plain version runs whole), its launches 7w's and
    # 7s's K5 fused runs; its error the largest of 3w's cases and of 7w's
    # and 7s's runs held to its plain version on 65,536 points at the main
    # path's shapes
    k5f = {"name": "window_kernel_fused", "launches": MAIN_PATH_K5F[0],
           "max_abs_err": max(k5fw["err"], k5f7["err"], fig7s["k5"]["err"]),
           "ms": k5fw["ms"],
           "plain_ms": k5fw["plain_ms"], "bound": k5fw["bound"],
           "replaces": "roadsurf_tpu/production.py:2041"}
    kernels = []
    for k in (k1, k2, k3, k3f, k4, k5, k5f):
        assert k["launches"] > 0, k
        bound_ms, bound_by = k.pop("bound")
        kernels.append(dict(
            name=k.pop("name"), route="cuda",
            source="roadsurf_tpu_torch/csrc/scan_kernel.cu",
            replaces=k.pop("replaces",
                           "roadsurf_tpu/ops/pallas_step.py:694"), **k,
            bound_ms=bound_ms, bound_by=bound_by,
            # a per-point time loop with a data-dependent fixed point: no
            # one PyTorch call computes the same function
            library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        mp_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
    else:
        main()
