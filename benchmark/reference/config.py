"""Frozen copy of ``roadsurf_tpu_torch/config.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Configuration trees for the PyTorch/CUDA road-weather framework.

A copy of ``roadsurf_tpu/config.py`` (numpy-free, jax-free): the reference's
layered configuration system (compiled defaults -> JSON overrides -> CLI
overrides) as frozen dataclasses:

* ``ModelSettings``  -- run geometry / feature switches
  (reference: examples/example1/src/InputSettings.h:13-26,
  src/InputSettings.f90.inc:4-18)
* ``PhysicsParams`` -- ~60 physical tunables with the reference defaults
  (reference: examples/example1/src/InputParameters.h:18-111) plus the
  derived storage limits (examples/example1/src/InputParameters.cpp:11-22).

All parameters are plain Python floats: torch ops take them as scalars and
the CUDA scan kernel receives them in its by-value constant struct
(``ops/scan_kernel.py``).  Per-point parameters (lat, lon, sky view,
horizons, relaxation anchors, coupling obs) live in
``roadsurf_tpu_torch.state.PointParams`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

MISSING = -9999.9


def _override(obj: Any, json: Optional[Mapping[str, Any]], field_names) -> Any:
    """Return a dataclasses.replace()-d copy with any JSON-provided fields."""
    if not json:
        return obj
    updates = {}
    for name in field_names:
        if name in json:
            cur = getattr(obj, name)
            val = json[name]
            updates[name] = type(cur)(val) if cur is not None else val
    return dataclasses.replace(obj, **updates) if updates else obj


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    """Run geometry and feature switches.

    Defaults follow examples/example1/src/InputSettings.h:13-26.
    """

    sim_len: int = 0                      #: number of simulation steps
    dt: float = 30.0                      #: timestep seconds (DTSecs)
    nlayers: int = 15                     #: ground layers (excl. air + clim nodes)
    use_coupling: bool = False
    use_relaxation: bool = False
    force_tsurf: bool = False             #: force obs tsurf for whole run
    tsurf_output_depth: float = MISSING   #: output temperature depth (m), <0 = (T1+T2)/2
    coupling_minutes: int = 180
    coupling_effect_reduction: float = 4.0 * 3600.0
    output_step_minutes: int = 60

    # Melt-control switches (library API: forced melting under salt treatment;
    # src/RoadCondParameters.f90.inc:57-60, default off)
    force_ice_melting: bool = False
    force_snow_melting: bool = False
    melting_can_change_temperature: bool = True

    @property
    def tph(self) -> float:
        """Hours per timestep (reference calls this Tph; Initialization.f90:92)."""
        return self.dt / 3600.0

    @property
    def coupling_len_steps(self) -> int:
        """Coupling window length in steps (Coupling.f90:512)."""
        return int(self.coupling_minutes * 60 / self.dt)

    @property
    def output_stride(self) -> int:
        return max(1, int(self.output_step_minutes * 60 / self.dt))

    @classmethod
    def from_json(cls, json: Mapping[str, Any]) -> "ModelSettings":
        """Build from a reference-format config dict (the 'model'/'output'/'time'
        sections of example_config.json)."""
        model = json.get("model", {}) or {}
        out = json.get("output", {}) or {}
        time = json.get("time", {}) or {}
        s = cls()
        s = _override(s, {
            "use_coupling": bool(model.get("use_coupling", 0)),
            "use_relaxation": bool(model.get("use_relaxation", 0)),
            "force_tsurf": bool(model.get("force_tsurf", 0)),
        }, ("use_coupling", "use_relaxation", "force_tsurf"))
        updates = {}
        # maintenance/salt melt-control switches (the library's forced-melt
        # API surface; src/RoadCondParameters.f90.inc:57-60)
        for key, field in (("force_snow_melting", "force_snow_melting"),
                           ("force_ice_melting", "force_ice_melting"),
                           ("melting_can_change_temperature",
                            "melting_can_change_temperature")):
            if key in model:
                updates[field] = bool(model[key])
        if "DTSecs" in model:
            updates["dt"] = float(model["DTSecs"])
        if "NLayers" in model:
            updates["nlayers"] = int(model["NLayers"])
        if "tsurfOutputDepth" in model:
            updates["tsurf_output_depth"] = float(model["tsurfOutputDepth"])
        if "couplingEffectReduction" in model:
            updates["coupling_effect_reduction"] = float(model["couplingEffectReduction"])
        if "step" in out:
            updates["output_step_minutes"] = int(out["step"])
        if int(time.get("coupling_minutes", 0) or 0) > 0:
            updates["coupling_minutes"] = int(time["coupling_minutes"])
        return dataclasses.replace(s, **updates)


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Physical parameters; defaults per examples/example1/src/InputParameters.h.

    Derived limits (min/max storage, wear limits) are computed by
    ``derive(dt)`` following examples/example1/src/InputParameters.cpp:11-22.
    """

    # time dependent / traffic
    night_on: float = 19.0        #: hour UTC night traffic begins (NightOn)
    night_off: float = 4.0        #: hour UTC night traffic ends (NightOff)
    calm_lim_day: float = 1.5     #: min wind speed day (m/s)
    calm_lim_ngt: float = 0.4     #: min wind speed night (m/s)
    trf_fric_ngt: float = 5.0     #: traffic friction heat night (W/m2)
    trf_fric_day: float = 10.0    #: traffic friction heat day (W/m2)

    # physical constants
    grav: float = 9.81
    sb_const: float = 5.67e-8
    vk_const: float = 0.4
    lvap: float = 2.452e6         #: latent heat of vaporisation (J/kg)
    lfus: float = 0.334e6         #: latent heat of fusion (J/kg)
    wat_dens: float = 999.87      #: water density at 0C
    snow_dens: float = 100.0
    ice_dens: float = 920.0
    dep_dens: float = 920.0
    wat_m_heat: float = 333000.0  #: heat of ablation (J/kg)
    por_eva_f: float = 1.0        #: pore evaporation resistance factor

    # point physical properties
    zref_w: float = 10.0          #: wind reference height (m)
    zref_t: float = 2.0           #: temperature reference height (m)
    zero_disp: float = 0.0        #: zero displacement height (m)
    zmom: float = 0.4             #: momentum roughness (m)
    zheat: float = 0.001          #: heat roughness (m)
    emiss: float = 0.95
    albedo: float = 0.10          #: dry ground albedo (initial)
    albedo_surroundings: float = 0.15
    max_por_mms: float = 1.0      #: max water in asphalt pores (mm)
    t_clim_g: float = 6.4         #: climatological bottom temperature (C)
    damp_depth: float = 2.7       #: damping depth (m)
    omega: float = 2.0 * math.pi / 365.0
    az: float = 0.6               #: bottom-temperature annual amplitude
    damp_wear_f: float = 0.5
    alb_dry: float = 0.1
    alb_snow: float = 0.6
    vsh1: float = 1.94e6          #: dry volumetric heat capacity, surface layers
    vsh2: float = 1.28e6          #: dry volumetric heat capacity, deep layers
    poro1: float = 0.1
    poro2: float = 0.4
    rhob1: float = 2.11           #: bulk density, surface layers
    rhob2: float = 1.6
    silt1: float = 0.1
    silt2: float = 0.8

    # limits
    t_lim_freeze: float = -0.25       #: freezing_limit_normal
    t_lim_melt_snow: float = 0.25     #: snow_melting_limit_normal
    t_lim_melt_ice: float = 0.25      #: ice_melting_limit_normal
    t_lim_melt_dep: float = 1.25      #: frost_melting_limit_normal
    t_lim_dew: float = 0.25           #: frost_formation_limit_normal
    t4melt_normal: float = 0.25
    t_lim_cold_h: float = -19.0
    t_lim_cold_l: float = -21.0
    wet_snow_form_r: float = 0.1
    wet_snow_melt_r: float = 0.6
    p_lim_snow: float = 0.3
    p_lim_rain: float = 0.7
    max_snow_mms: float = 100.0
    max_dep_mms: float = 2.0
    max_ice_mms: float = 50.0
    max_ext_mms: float = 1.0
    miss_val_i: float = -9999.0
    miss_val_r: float = -99.99
    snow_to_ice_fac: float = 0.5

    # derived (filled by derive()); reference InputParameters.cpp:11-22
    min_prec_mm: float = 0.05 * 30.0 / 3600.0
    min_wat_mms: float = 0.01 * 30.0 / 3600.0
    min_snow_mms: float = 0.1 * 30.0 / 3600.0
    max_wat_mms: float = 2.0
    w_damp_lim: float = 0.1
    w_wet_lim: float = 0.9
    w_wear_lim: float = 0.1
    min_dep_mms: float = 0.01 * 30.0 / 3600.0
    min_ice_mms: float = 0.05 * 30.0 / 3600.0

    def derive(self, dt: float) -> "PhysicsParams":
        """Recompute dt-scaled storage thresholds
        (examples/example1/src/InputParameters.cpp:11-22)."""
        return dataclasses.replace(
            self,
            min_prec_mm=0.05 * dt / 3600.0,
            min_wat_mms=0.01 * dt / 3600.0,
            min_snow_mms=0.1 * dt / 3600.0,
            max_wat_mms=self.max_por_mms + self.max_ext_mms,
            w_damp_lim=0.1 * self.max_por_mms,
            w_wet_lim=0.9 * self.max_por_mms,
            w_wear_lim=0.1 * self.max_por_mms,
            min_dep_mms=0.01 * dt / 3600.0,
            min_ice_mms=0.05 * dt / 3600.0,
        )

    # precomputed log profile factors (Initialization.f90:330-337)
    @property
    def log_mom(self) -> float:
        return math.log((self.zref_w + self.zmom) / self.zmom)

    @property
    def log_heat(self) -> float:
        return math.log((self.zref_w + self.zheat) / self.zheat)

    @property
    def log_cond(self) -> float:
        return math.log((self.zref_w - self.zero_disp + self.zheat) / self.zheat)

    @property
    def log_ustar(self) -> float:
        return math.log((self.zref_w - self.zero_disp + self.zmom) / self.zmom)

    # Campbell conductivity coefficients (BalanceModel.f90:158-186)
    def campbell_coeffs(self, layer_class: int):
        """(A,B,C,D,E) conductivity coefficients for layer class 1 (surface,
        layers 1-2) or 2 (deep)."""
        rhob = self.rhob1 if layer_class == 1 else self.rhob2
        silt = self.silt1 if layer_class == 1 else self.silt2
        a = 0.65 - 0.78 * rhob + 0.60 * rhob * rhob
        b = 1.06 * rhob
        c = 1.0 + 2.6 / math.sqrt(silt) if silt > 1e-5 else 0.0
        d = 0.03 + 0.1 * rhob * rhob
        e = 4.0
        return a, b, c, d, e

    _JSON_KEYS = {
        # json-name -> field-name (reference InputParameters.cpp:40-109)
        "NightOn": "night_on", "NightOff": "night_off",
        "CalmLimDay": "calm_lim_day", "CalmLimNgt": "calm_lim_ngt",
        "TrfFricNgt": "trf_fric_ngt", "TrFfricDay": "trf_fric_day",
        "Grav": "grav", "SB_Const": "sb_const", "VK_Const": "vk_const",
        "LVap": "lvap", "LFus": "lfus", "WatDens": "wat_dens",
        "SnowDens": "snow_dens", "IceDens": "ice_dens", "DepDens": "dep_dens",
        "WatMHeat": "wat_m_heat", "PorEvaF": "por_eva_f",
        "ZRefW": "zref_w", "ZRefT": "zref_t", "ZeroDisp": "zero_disp",
        "ZMom": "zmom", "ZHeat": "zheat", "Emiss": "emiss",
        "Albedo": "albedo", "Albedo_Surroundings": "albedo_surroundings",
        "MaxPormms": "max_por_mms", "TClimG": "t_clim_g",
        "DampDpth": "damp_depth", "Omega": "omega", "AZ": "az",
        "DampWearF": "damp_wear_f", "AlbDry": "alb_dry", "AlbSnow": "alb_snow",
        "vsh1": "vsh1", "vsh2": "vsh2", "Poro1": "poro1", "Poro2": "poro2",
        "RhoB1": "rhob1", "RhoB2": "rhob2", "Silt1": "silt1", "Silt2": "silt2",
        "freezing_limit_normal": "t_lim_freeze",
        "snow_melting_limit_normal": "t_lim_melt_snow",
        "ice_melting_limit_normal": "t_lim_melt_ice",
        "frost_melting_limit_normal": "t_lim_melt_dep",
        "frost_formation_limit_normal": "t_lim_dew",
        "T4Melt_normal": "t4melt_normal",
        "TLimColdH": "t_lim_cold_h", "TLimColdL": "t_lim_cold_l",
        "WetSnowFormR": "wet_snow_form_r", "WetSnowMeltR": "wet_snow_melt_r",
        "PLimSnow": "p_lim_snow", "PLimRain": "p_lim_rain",
        "MaxSnowmms": "max_snow_mms", "MaxDepmms": "max_dep_mms",
        "MaxIcemms": "max_ice_mms", "MaxExtmms": "max_ext_mms",
        "Snow2IceFac": "snow_to_ice_fac",
    }

    @classmethod
    def from_json(cls, settings: ModelSettings,
                  json: Optional[Mapping[str, Any]] = None) -> "PhysicsParams":
        """Defaults + dt-derived limits + JSON 'parameters' overrides."""
        p = cls().derive(settings.dt)
        if json:
            updates = {}
            for jname, fname in cls._JSON_KEYS.items():
                if jname in json:
                    updates[fname] = float(json[jname])
            if updates:
                p = dataclasses.replace(p, **updates)
                p = p.derive(settings.dt)  # limits depend on MaxPormms
        return p


# Precipitation phase codes (reference src/Constants.h)
PRECIPITATION_NONE = 0
PRECIPITATION_RAIN = 1
PRECIPITATION_SLEET = 2
PRECIPITATION_SNOW = 3
PRECIPITATION_FREEZING_DRIZZLE = 4
PRECIPITATION_FREEZING_RAIN = 5
PRECIPITATION_HAIL = 6

SURFACE_SNOW_DRY = 1
SURFACE_SNOW_WET = 2
