"""Typed configuration for solver runs (the dataclass config the reference
lacks — physics constants were hardcoded per driver and partially duplicated
inside kernels, SURVEY.md §5 "Config / flag system").

``SimulationConfig`` collects every tunable of the planar3d-class workloads
and builds the model/case; serializes to/from JSON for reproducible runs and
checkpoint metadata.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class PhysicsConfig:
    speed_of_sound: float = 1500.0       # c0 (m/s)
    source_frequency: float = 0.5e6      # f0 (Hz)
    pressure_amplitude: float = 60000.0  # p0 (Pa)
    window_periods: float = 4.0          # source ramp length (alpha)


@dataclass
class DomainConfig:
    ncells: tuple[int, int, int] = (64, 32, 32)
    domain_length: float = 0.1           # L (m)
    width: float | None = None           # transverse width (defaults cubic cells)
    degree: int = 4                      # basis degree p
    source_tag: int = 1
    abc_tag: int = 2
    #: imported-mesh mode (the reference's actual planar3d workflow,
    #: demo/cpu_planar3d/main.cpp:39-45): XDMF mesh + facet meshtags.
    #: When ``mesh_path`` is set, ``ncells``/``domain_length``/``width``
    #: are ignored and the model is the explicit-dofmap GeneralLinearWave.
    mesh_path: str | None = None
    meshtags_path: str | None = None


@dataclass
class TimeConfig:
    cfl: float = 0.5
    n_tail_periods: float = 8.0
    t0: float = 0.0
    #: 'rk4' (reference parity, LinearGLL.hpp:198-287) or 'leapfrog'
    #: (2nd order, ONE stiffness apply/step; dt auto-scaled by 0.71 —
    #: solvers/leapfrog.py)
    integrator: str = "rk4"


@dataclass
class RunConfig:
    dtype: str = "f32"                   # f32 | bf16 | f64
    ndev: int = 1
    checkpoint_dir: str | None = None
    checkpoint_every_steps: int = 1000
    log_every_steps: int = 50
    #: write final u/v as XDMF (rectilinear grid for box runs, p-refined
    #: sub-hex grid for imported meshes); sharded runs skip it
    output_path: str | None = None


@dataclass
class SimulationConfig:
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    domain: DomainConfig = field(default_factory=DomainConfig)
    time: TimeConfig = field(default_factory=TimeConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SimulationConfig":
        d = json.loads(s)
        return cls(
            physics=PhysicsConfig(**d.get("physics", {})),
            domain=DomainConfig(**{
                **d.get("domain", {}),
                "ncells": tuple(d.get("domain", {}).get("ncells", (64, 32, 32))),
            }),
            time=TimeConfig(**d.get("time", {})),
            run=RunConfig(**d.get("run", {})),
        )

    def build_case(self):
        """Construct the Planar3DCase for this config."""
        from ..benchmarks.common import resolve_dtype
        from ..models.planar3d import planar3d_case, planar3d_case_xdmf

        if self.domain.mesh_path is not None:
            return planar3d_case_xdmf(
                self.domain.mesh_path,
                self.domain.meshtags_path,
                degree=self.domain.degree,
                speed_of_sound=self.physics.speed_of_sound,
                source_frequency=self.physics.source_frequency,
                pressure_amplitude=self.physics.pressure_amplitude,
                cfl=self.time.cfl,
                n_tail_periods=self.time.n_tail_periods,
                source_tag=self.domain.source_tag,
                abc_tag=self.domain.abc_tag,
                dtype=resolve_dtype(self.run.dtype),
            )
        return planar3d_case(
            ncells=tuple(self.domain.ncells),
            domain_length=self.domain.domain_length,
            width=self.domain.width,
            degree=self.domain.degree,
            speed_of_sound=self.physics.speed_of_sound,
            source_frequency=self.physics.source_frequency,
            pressure_amplitude=self.physics.pressure_amplitude,
            cfl=self.time.cfl,
            n_tail_periods=self.time.n_tail_periods,
            dtype=resolve_dtype(self.run.dtype),
        )
