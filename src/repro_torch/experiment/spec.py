"""Declarative experiment specs (port of ``repro.experiment.spec``).

``Experiment`` is the front door over the sweep engine: named axes
expand into the ``SimConfig`` grid, the runner dedups / chunks /
launches it, and the caller gets a labeled ``Results``::

    Experiment(
        traces={"milc_like": batch, ...},      # labeled trace axis
        axes={"mechanism": ["base", "chargecache"],
              "capacity": (32, 128, 1024)},    # cartesian config axes
    ).run().sel(mechanism="chargecache", capacity=128)

It runs on the card (the ``sim_step`` kernel) unless ``device="cpu"``
names the plain engine; it never falls back from one to the other.

Axis semantics live in ``AXIS_BUILDERS`` — small ``(cfg, value) -> cfg``
functions keyed by axis name, extensible with ``@register_axis`` (the
mechanism axis itself defers to the mechanism registry, so a freshly
registered policy is sweepable with zero changes here).  Axis values may
be plain labels, a ``{label: value}`` mapping, or ``(label, value)``
pairs when the applied value should differ from the coordinate label
(e.g. per-core HCRAC capacities labeled by the per-core count).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.aldram import ThermalConfig
from repro_torch.core.dram import DRAMConfig, InterleaveConfig
from repro_torch.core.simulator import SimConfig
from repro_torch.core.timing import lowered_for_duration, ms_to_cycles
from repro_torch.core.traces import WORKLOAD_BY_NAME, WorkloadSpec
from repro_torch.experiment.results import DEFAULT_METRICS, Results

AXIS_BUILDERS: dict[str, Callable[[SimConfig, Any], SimConfig]] = {}

#: Named DRAM geometries for the ``geometry`` axis — Table 5.1's
#: channel-sensitivity variants plus bank-count studies.  All pad into
#: one ``DRAMEnvelope`` inside a sweep, so a geometry axis rides the
#: same launch as every other axis.
GEOMETRY_PRESETS: dict[str, DRAMConfig] = {
    "ddr3_1ch": DRAMConfig(n_channels=1),
    "ddr3_2ch": DRAMConfig(n_channels=2),
    "ddr3_1ch_4bank": DRAMConfig(n_channels=1, n_banks=4),
    "ddr3_1ch_16bank": DRAMConfig(n_channels=1, n_banks=16),
    "ddr3_2ch_16bank": DRAMConfig(n_channels=2, n_banks=16),
}


def register_axis(name: str):
    """Register an axis builder: ``fn(cfg, value) -> new cfg``."""
    def deco(fn):
        AXIS_BUILDERS[name] = fn
        return fn
    return deco


@register_axis("mechanism")
def _axis_mechanism(cfg: SimConfig, kind: str) -> SimConfig:
    return dataclasses.replace(
        cfg, mech=dataclasses.replace(cfg.mech, kind=kind))


@register_axis("capacity")
def _axis_capacity(cfg: SimConfig, n_entries: int) -> SimConfig:
    hcrac = dataclasses.replace(cfg.mech.hcrac, n_entries=int(n_entries))
    return dataclasses.replace(
        cfg, mech=dataclasses.replace(cfg.mech, hcrac=hcrac))


@register_axis("duration_ms")
def _axis_duration(cfg: SimConfig, ms: float) -> SimConfig:
    """Caching duration: sets the HCRAC expiry *and* the lowered timing
    set the charge model derives for that duration (Table 6.1)."""
    hcrac = dataclasses.replace(cfg.mech.hcrac,
                                caching_cycles=ms_to_cycles(ms))
    mech = dataclasses.replace(cfg.mech, hcrac=hcrac,
                               lowered=lowered_for_duration(ms))
    return dataclasses.replace(cfg, mech=mech)


@register_axis("geometry")
def _axis_geometry(cfg: SimConfig, geom) -> SimConfig:
    """DRAM geometry: a ``GEOMETRY_PRESETS`` name or a ``DRAMConfig``.

    Per-point data (``GeomParams``), so a channel/bank sweep shares one
    launch; trace addresses fold into each active geometry by modular
    arithmetic (``repro_torch.core.dram.fold_address``).
    """
    if isinstance(geom, str):
        if geom not in GEOMETRY_PRESETS:
            raise ValueError(f"unknown geometry preset {geom!r}; "
                             f"known: {tuple(GEOMETRY_PRESETS)}")
        geom = GEOMETRY_PRESETS[geom]
    if not isinstance(geom, DRAMConfig):
        raise TypeError(f"geometry axis value {geom!r} is not a DRAMConfig")
    return dataclasses.replace(cfg, dram=geom)


@register_axis("temperature")
def _axis_temperature(cfg: SimConfig, temp_c) -> SimConfig:
    """AL-DRAM operating temperature (°C): sets the module profile the
    ``aldram`` policy derives its per-bank timing table from
    (``repro_torch.core.aldram``).  Mechanisms that do not consume the
    ``aldram`` knob dedup across this axis — a ``base`` or
    ``chargecache`` point is the same run at every temperature."""
    ald = dataclasses.replace(cfg.mech.aldram, temperature_c=float(temp_c))
    return dataclasses.replace(
        cfg, mech=dataclasses.replace(cfg.mech, aldram=ald))


#: Named temperature schedules for the ``temp_drift`` axis.  Start
#: times are milliseconds of *stream* time — short presets (tens of µs)
#: so the drift is observable inside benchmark-sized streams; serving /
#: mega-sweep studies pass their own ``ThermalConfig`` at real scales.
THERMAL_PRESETS: dict[str, ThermalConfig] = {
    "none": ThermalConfig(),
    "cool": ThermalConfig(points=((0.0, 55.0),)),
    "ramp": ThermalConfig(points=((0.0, 55.0), (0.02, 70.0),
                                  (0.04, 85.0))),
    "hot": ThermalConfig(points=((0.0, 85.0),)),
}


@register_axis("refresh_mode")
def _axis_refresh_mode(cfg: SimConfig, mode: str) -> SimConfig:
    """Refresh model tier: ``"stateful"`` (the rolling-refresh state —
    REF issued on the per-group schedule, tRFC blackout on all three
    bank ready clocks, leak clock keyed to the actual last REF) or
    ``"legacy"`` (the closed-form ``refresh_adjust`` approximation).
    Per-point data, so a refresh × mechanism grid shares one launch."""
    return dataclasses.replace(cfg, refresh_mode=mode)


@register_axis("controller")
def _axis_controller(cfg: SimConfig, mode: str) -> SimConfig:
    """Memory-controller tier: ``"inorder"`` (the per-bank in-order
    engine) or ``"frfcfs"`` (``repro``'s bounded-window row-hit-first
    tier), which ``SimConfig`` refuses until that tier is ported."""
    return dataclasses.replace(cfg, controller=mode)


@register_axis("window")
def _axis_window(cfg: SimConfig, depth) -> SimConfig:
    """FR-FCFS request-window depth.  Only the frfcfs tier reads it, and
    ``SimConfig`` refuses that tier until it is ported, so every point
    here is in-order and the axis leaves it as it is: in-order points
    are one run at every depth, as ``repro``'s dedup makes them."""
    if int(depth) < 1:
        raise ValueError(f"window depth must be >= 1, not {depth!r}")
    return cfg


@register_axis("temp_drift")
def _axis_temp_drift(cfg: SimConfig, value) -> SimConfig:
    """Temperature drift along the stream: a ``THERMAL_PRESETS`` name or
    a ``ThermalConfig``.  Per-segment leak multipliers scale the NUAT /
    refresh8ms leak clock and re-derive the AL-DRAM per-bank tables per
    segment; mechanisms that consume neither knob dedup across this axis
    (``registry.canonical_mech``)."""
    if isinstance(value, str):
        if value not in THERMAL_PRESETS:
            raise ValueError(f"unknown temp_drift preset {value!r}; "
                             f"known: {tuple(THERMAL_PRESETS)}")
        value = THERMAL_PRESETS[value]
    if not isinstance(value, ThermalConfig):
        raise TypeError(f"temp_drift value {value!r} is not a "
                        f"ThermalConfig")
    return dataclasses.replace(
        cfg, mech=dataclasses.replace(cfg.mech, thermal=value))


@register_axis("workload")
def _axis_workload(cfg: SimConfig, value) -> SimConfig:
    """Synthetic workload: a profile name (single core),
    a *list* of names (multiprogrammed mix, one per core — prefer the
    ``{label: [names]}`` mapping form so the coordinate label stays a
    scalar; a bare 2-tuple would be read as the generic ``(label,
    value)`` axis convention), or a full ``WorkloadSpec``.  Name values
    inherit ``n_req``/``seed`` from the base config's spec (set
    ``base.workload`` to size the streams).  The workload is generated
    on the device per grid point (``sweep_synth``); use
    ``Experiment(traces=None, ...)`` so the runner takes the streamed
    path."""
    if isinstance(value, WorkloadSpec):
        spec = value
    else:
        names = (value,) if isinstance(value, str) else tuple(value)
        prev = cfg.workload
        spec = WorkloadSpec(names=names,
                            n_req=prev.n_req if prev is not None else 20_000,
                            seed=prev.seed if prev is not None else 0)
    return dataclasses.replace(cfg, workload=spec)


@register_axis("interleave")
def _axis_interleave(cfg: SimConfig, value) -> SimConfig:
    """Channel-interleave policy for on-device address composition: an
    ``INTERLEAVE_KINDS`` name or an ``InterleaveConfig``.  Per-point data
    (``InterleaveParams``), so an interleave sweep shares the launch;
    trace-driven points (no workload) and single-channel geometries dedup
    across this axis — the policy only matters where a generated stream
    has channels to spread."""
    il = (value if isinstance(value, InterleaveConfig)
          else InterleaveConfig(kind=value))
    return dataclasses.replace(cfg, interleave=il)


@register_axis("policy")
def _axis_policy(cfg: SimConfig, policy: str) -> SimConfig:
    """Polymorphic policy axis: ``"open"``/``"closed"`` select the DRAM
    row policy (Table 5.1); any registered *serving* policy name (fifo /
    charge_aware / preempting, ``repro_torch.serving.loop.policies``)
    selects the serving loop's admission policy instead — the grid point
    must then carry a ``ServingSpec`` (``base.serving``)."""
    if policy in ("open", "closed"):
        return dataclasses.replace(cfg, policy=policy)
    from repro_torch.serving.loop import policies as serving_policies
    if policy not in serving_policies.names():
        raise ValueError(
            f"unknown policy {policy!r}: not a row policy (open/closed) "
            f"and not a registered serving policy "
            f"{serving_policies.names()}")
    if cfg.serving is None:
        raise ValueError(
            f"serving policy axis value {policy!r} needs base.serving set "
            f"(a repro_torch.serving.loop.ServingSpec)")
    return dataclasses.replace(
        cfg, serving=dataclasses.replace(cfg.serving, policy=policy))


def _replace_arrival(cfg: SimConfig, **kw) -> SimConfig:
    if cfg.serving is None:
        raise ValueError("arrival axes need base.serving set (a "
                         "ServingSpec)")
    arr = dataclasses.replace(cfg.serving.arrival, **kw)
    return dataclasses.replace(
        cfg, serving=dataclasses.replace(cfg.serving, arrival=arr))


@register_axis("arrival_rate")
def _axis_arrival_rate(cfg: SimConfig, rate) -> SimConfig:
    """Mean request arrivals per serving step (an ``ArrivalParams`` leaf
    — the load knob of the serving grid)."""
    return _replace_arrival(cfg, rate=float(rate))


@register_axis("burstiness")
def _axis_burstiness(cfg: SimConfig, b) -> SimConfig:
    """ON/OFF burstiness of the arrival process (>= 1; per-point data).
    Moves variance, not load: the long-run mean rate is unchanged."""
    return _replace_arrival(cfg, burstiness=float(b))


@register_axis("backend")
def _axis_backend(cfg: SimConfig, backend: str) -> SimConfig:
    """``repro``'s engine-tier axis.  The port has no engine field: it
    picks its engine by device (``Experiment(device=...)``: the
    ``sim_step`` kernel on the card, the plain engine with
    ``device="cpu"``), so this axis refuses every value."""
    raise ValueError(
        f"backend axis value {backend!r}: the port picks its engine by "
        f"device — Experiment(device='cuda') launches the sim_step "
        f"kernel, device='cpu' runs the plain engine")


@register_axis("timing")
def _axis_timing(cfg: SimConfig, timing) -> SimConfig:
    return dataclasses.replace(cfg, timing=timing)


def _axis_items(values) -> list[tuple[Any, Any]]:
    """Normalize one axis spec to ``[(label, applied value), ...]``."""
    if isinstance(values, Mapping):
        return list(values.items())
    out = []
    for v in values:
        if isinstance(v, tuple) and len(v) == 2:
            out.append((v[0], v[1]))
        else:
            out.append((v, v))
    return out


@dataclasses.dataclass
class Experiment:
    """A declarative evaluation grid: traces × named config axes.

    - ``traces``: one ``TraceBatch``, a ``{label: batch}`` mapping (adds
      a leading ``trace_dim`` to the Results), a sequence (labeled by
      index), or ``None`` — the *synthetic* mode: every grid point must
      carry a ``WorkloadSpec`` (a ``workload`` axis or ``base.workload``)
      and its stream is generated on the device (``sweep_synth``) — no
      host trace exists at any point — or, with ``base.serving`` set,
      the serving closed loop (``sweep_serving``).
    - ``axes``: ``{axis_name: values}`` expanded cartesian, in insertion
      order, through ``AXIS_BUILDERS`` on top of ``base``.
    - ``chunk_size`` / ``memory_budget_mb``: the runner splits the config
      grid into launches of this many points (or an estimate that fits
      the budget: the card's free memory, ``runner.DEFAULT_BUDGET_MB`` on
      the CPU); the tail chunk is padded by repeating its last point.
    - ``trace_metrics``: extra per-trace scalars (e.g. a scheduler's
      hot-page hit rate) merged into every cell of that trace row.
    - ``dedup``: launch each *behaviourally distinct* config once (grid
      points differing only in knobs their mechanism ignores — see
      ``registry.canonical_mech`` — share one run, bitwise-identically).
    - ``reduce``: the streaming contract.  A tuple of metric names
      (registered in ``repro_torch.experiment.metrics`` or raw reducible
      stat keys): each chunk launch lowers just those metrics' integer
      ingredients on the device and the host receives a ``[chunk,
      n_deps]`` array — never a per-point stats dict — and assembles a
      *streamed* ``Results`` (``res.data``).  ``None`` (the default)
      keeps the full-stats object-cell path.  Incompatible with ``rltl``
      / ``trace_metrics``.
    - ``aggregate``: ``{result_name: (aggregation, metric)}`` streaming
      reductions over the whole grid (``mean``/``min``/``max``/
      ``argbest`` or any ``register_aggregation`` name), folded per
      drained chunk and reported in ``meta["aggregates"]``; only valid
      with ``reduce``.
    - ``pipeline_depth``: launches kept in flight before the runner
      waits on the oldest one's drain — 0 = launch then drain, one at a
      time; 2 = the default.
    - ``device``: where the grid runs; ``None`` means CUDA (the
      ``sim_step`` kernel, and ``run()`` raises where there is no card),
      ``"cpu"`` the plain engine.
    """
    traces: Any
    axes: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    metrics: Sequence[str] = DEFAULT_METRICS
    base: SimConfig = dataclasses.field(default_factory=SimConfig)
    rltl: bool = False
    trace_dim: str = "trace"
    chunk_size: int | None = None
    memory_budget_mb: float | None = None
    trace_metrics: Mapping[Any, Mapping[str, Any]] | None = None
    dedup: bool = True
    reduce: Sequence[str] | None = None
    aggregate: Mapping[str, tuple[str, str]] | None = None
    pipeline_depth: int = 2
    device: Any = None

    def expand(self):
        """The config grid: ``(dims, coords, configs)`` with ``configs``
        flat in C order over the axis coords (trace axis excluded)."""
        dims = tuple(self.axes)
        items = {d: _axis_items(self.axes[d]) for d in dims}
        coords = {d: tuple(l for l, _ in items[d]) for d in dims}
        for d in dims:
            if d not in AXIS_BUILDERS:
                raise ValueError(f"unknown axis {d!r}; registered: "
                                 f"{tuple(AXIS_BUILDERS)}")
            if not items[d]:
                raise ValueError(f"empty axis {d!r}")
        # ambiguity guard on the RAW axis values (before the generic
        # (label, value) tuple normalization, which would make a
        # homogeneous pair indistinguishable from a scalar): a bare
        # tuple of profile names on the workload axis was almost
        # certainly meant as a multi-core mix, but the tuple convention
        # would silently run a single-core stream under a wrong label
        if "workload" in dims and not isinstance(self.axes["workload"],
                                                 Mapping):
            for v in self.axes["workload"]:
                if (isinstance(v, tuple) and v
                        and all(isinstance(n, str) and n in WORKLOAD_BY_NAME
                                for n in v)):
                    raise ValueError(
                        f"ambiguous workload axis value {v!r}: a tuple of "
                        f"profile names reads as the generic (label, "
                        f"value) pair; write mixes as lists or as "
                        f"{{label: [names]}} mappings")
        configs = []

        def rec(cfg, rest):
            if not rest:
                configs.append(cfg)
                return
            d, *tail = rest
            for _, value in items[d]:
                rec(AXIS_BUILDERS[d](cfg, value), tail)

        rec(self.base, list(dims))
        return dims, coords, configs

    def trace_items(self):
        """``(labeled, [(label, batch), ...])``; unlabeled single batches
        get no trace dim in the Results; ``traces=None`` (the synthetic
        streamed-generation mode) yields no trace items at all."""
        t = self.traces
        if t is None:  # synthetic: workloads are grid axes, not traces
            return False, []
        if hasattr(t, "gap"):  # a single TraceBatch (NamedTuple, so check
            return False, [(None, t)]  # before the tuple branch)
        if isinstance(t, Mapping):
            return True, list(t.items())
        if isinstance(t, (list, tuple)):
            return True, list(enumerate(t))
        return False, [(None, t)]

    def reduce_metrics(self) -> tuple[str, ...]:
        """The metric names a ``reduce=`` run streams: the explicit
        tuple, or — ``reduce=True`` shorthand — the experiment's
        ``metrics`` declaration."""
        if self.reduce is None:
            raise ValueError("reduce_metrics() of an experiment without "
                             "reduce=")
        if self.reduce is True:
            return tuple(self.metrics)
        return tuple(self.reduce)

    def run(self, progress: Callable[[int, int], None] | None = None,
            stream_to: str | None = None) -> Results:
        """Run the grid.  ``progress(done, total)`` is called after
        every drained launch (monotone, mode-uniform — see
        ``run_experiment``); ``stream_to`` additionally appends every
        drained chunk to a ``ResultsWriter`` JSONL file at that path."""
        from repro_torch.experiment.runner import run_experiment
        return run_experiment(self, progress=progress,
                              stream_to=stream_to)
