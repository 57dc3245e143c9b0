"""SmartMet timeseries HTTP source.

Re-derivation of example2's SmartMetSource
(examples/example2/src/SmartMetSource.cpp): fetches a JSON timeseries from a
SmartMet server (query by keyword, station-id list, or lonlat;
:133-232), parses the row stream (consecutive rows per fmisid, :300-420)
and interpolates to the simulation grid.

Config mirrors the reference (:528-575): ``host``/``protocol``/``plugin``/
``producer``/``keyword``/``fmisid``/``timemargin`` plus field-name mappings
(``airtemperature``, ``roadtemperature``, ``dewpoint``, ``humidity``,
``windspeed``, ``longwaveradiation``, ``shortwaveradiation``,
``precipitation``, ``precipitationform``).  Fetching uses urllib (the
reference uses cpr); tests run against a local fixture server.

The counterpart of ``roadsurf_tpu/io/smartmet.py``: the same host numpy, so the
same values bit for bit.
"""
from __future__ import annotations

import json as jsonlib
import time as timelib
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

import numpy as np

from .interp import MISSING
from .sources import Source, StationData

# config key -> our variable name (field-name mapping keys of :538-546)
FIELD_KEYS = {
    "roadtemperature": "tsurf_obs",
    "airtemperature": "tair",
    "dewpoint": "tdew",
    "humidity": "rhz",
    "windspeed": "vz",
    "longwaveradiation": "lw",
    "shortwaveradiation": "sw",
    "precipitation": "prec",
    "precipitationform": "prec_phase",
}


def format_smartmet_time(epoch: int, margin_minutes: int = 0) -> str:
    """YYYYMMDDTHHMM (format_smartmet_time, SmartMetSource.cpp:30-39)."""
    t = timelib.gmtime(epoch + margin_minutes * 60)
    return timelib.strftime("%Y%m%dT%H%M", t)


def parse_iso_time(s: str) -> int:
    import calendar
    s = s.strip().rstrip("Z")
    for fmt in ("%Y%m%dT%H%M%S", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%dT%H:%M"):
        try:
            return calendar.timegm(timelib.strptime(s, fmt))
        except ValueError:
            continue
    raise ValueError(f"Unparseable SmartMet time: {s!r}")


class SmartMetSource(Source):
    """HTTP timeseries source with the reference's query protocol."""

    def __init__(self, config: dict, sim_times: np.ndarray,
                 start_epoch: Optional[int] = None,
                 end_epoch: Optional[int] = None,
                 is_observation: bool = True, fetcher=None):
        self.is_observation = is_observation
        self.config = config
        self.fields = {config.get(k, ""): v for k, v in FIELD_KEYS.items()
                       if config.get(k)}
        start_epoch = int(start_epoch if start_epoch is not None
                          else sim_times[0])
        end_epoch = int(end_epoch if end_epoch is not None else sim_times[-1])
        margin = int(config.get("timemargin", 10))

        params = {
            "param": ",".join(["fmisid", "time", "longitude", "latitude"]
                              + list(self.fields.keys())),
            "format": "json",
            "lang": "fi",
            "starttime": format_smartmet_time(start_epoch, -margin),
            "endtime": format_smartmet_time(end_epoch, +margin),
            "producer": config.get("producer", "observations_fmi"),
            "precision": "full",
            "tz": "UTC",
        }
        if config.get("keyword"):
            params["keyword"] = str(config["keyword"])
        elif config.get("fmisid"):
            ids = config["fmisid"]
            params["fmisid"] = (",".join(str(i) for i in ids)
                                if isinstance(ids, (list, tuple)) else str(ids))
        elif config.get("lonlat"):
            lon, lat = config["lonlat"]
            params["lonlat"] = f"{lon},{lat}"

        url = (f"{config.get('protocol', 'http')}://{config['host']}"
               f"/{config.get('plugin', 'timeseries')}"
               f"?{urllib.parse.urlencode(params)}")
        self.url = url
        text = (fetcher or self._fetch)(url)
        self._stations = self._parse(text, sim_times)

    @staticmethod
    def _fetch(url: str, timeout: float = 60.0) -> str:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            if r.status != 200:
                raise RuntimeError(
                    f"SmartMet server returned {r.status} for {url}")
            return r.read().decode()

    def _parse(self, text: str, sim_times) -> List[StationData]:
        if not text.strip():
            return []
        rows = jsonlib.loads(text)
        # group consecutive rows per fmisid (SmartMetSource.cpp:300-320)
        stations: Dict[int, dict] = {}
        order: List[int] = []
        for row in rows:
            sid = int(row["fmisid"])
            if sid not in stations:
                stations[sid] = {"lat": float(row.get("latitude", MISSING)),
                                 "lon": float(row.get("longitude", MISSING)),
                                 "times": [], "vals": {v: [] for v in
                                                       self.fields.values()}}
                order.append(sid)
            st = stations[sid]
            st["times"].append(parse_iso_time(str(row["time"])))
            for fname, vname in self.fields.items():
                v = row.get(fname)
                st["vals"][vname].append(
                    float(v) if v is not None and v != "" else MISSING)
        series = []
        for sid in order:
            st = stations[sid]
            t = np.asarray(st["times"], np.int64)
            ordr = np.argsort(t, kind="stable")
            series.append((t[ordr],
                           {k: np.asarray(v, np.float64)[ordr]
                            for k, v in st["vals"].items()}))
        from .sources import batch_interpolate_stations
        interped = batch_interpolate_stations(series, np.asarray(sim_times))
        return [StationData(sid, stations[sid]["lat"], stations[sid]["lon"],
                            full)
                for sid, full in zip(order, interped)]

    def stations(self):
        return self._stations
