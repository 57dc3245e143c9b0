"""Sizes a CPU test run holds: an 8 x 8 raster and a 5-hour forecast
cycle (4 h analysis, 1 h forecast), with 8 stations over a box cut to
match or a small NWP grid; everything else as the cell runs it."""
import pytest
import torch

SMALL = {
    "station_example1.coupled": {
        "time": {"analysis": 4, "forecast": 1},
        "points": {"grid": {"ny": 8, "nx": 8,
                            "bbox": [60.0, 24.0, 60.5, 25.0]}},
        "generator": {"args": {"stations": 8,
                               "bbox": "60.0,24.0,60.5,25.0"}}},
    "grid_example2.hourly": {
        "time": {"analysis": 4, "forecast": 1},
        "points": {"grid": {"ny": 8, "nx": 8}},
        "generator": {"args": {"ny": 12, "nx": 16}}},
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
