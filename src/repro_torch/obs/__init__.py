"""Run telemetry: the per-round flight recorder with drop-cause attribution,
counters and exclusive phase timers, pluggable sinks, the sketch-mode
report, health monitors, Chrome trace export, the live dashboard and the
report renderer.  The modules are copies of ``repro/obs``.

Turn it on with ``FFTConfig(telemetry=True | "full" | "sketch")``; add
``telemetry_log=<path>`` for the NDJSON event log (the same schema and
version as the JAX package's, so a log written by either loads in the
other), ``telemetry_trace=<path>`` for Chrome trace-event JSON,
``telemetry_console=True``, ``telemetry_dashboard=True`` and
``telemetry_health`` (on by default).  After ``runner.run(...)`` the
record is ``runner.report``; ``reconcile(runner.report, runner)`` checks it
against the run's own accounting.  Off (the default), the hub is the falsy
``NULL_TELEMETRY``: a run makes only its no-op calls, and no device sync.
"""
from repro_torch.obs.chrometrace import (  # noqa: F401
    ChromeTraceError, ChromeTraceRecorder, load_trace, self_times,
    verify_trace)
from repro_torch.obs.dashboard import (  # noqa: F401
    DashboardSink, render_dashboard, sparkline, watch)
from repro_torch.obs.health import (  # noqa: F401
    HealthConfig, HealthMonitors, health_record)
from repro_torch.obs.report import (  # noqa: F401
    ReconcileError, reconcile, render_markdown)
from repro_torch.obs.sinks import (  # noqa: F401
    TELEMETRY_SCHEMA, TELEMETRY_VERSION, TELEMETRY_VERSIONS_READABLE,
    ConsoleSink, NdjsonSink, RunReport, Sink, load_report,
    peek_telemetry_mode, read_telemetry_records)
from repro_torch.obs.sketch import (  # noqa: F401
    SKETCH_EPS, ExactSum, GKQuantiles, Reservoir, SketchReport, SketchState)
from repro_torch.obs.telemetry import (  # noqa: F401
    AGGREGATED, BUFFERED, EVICTED, LINK_DOWN, MISSED_DEADLINE, NOT_SELECTED,
    NULL_TELEMETRY, OUTCOMES, SKIPPED_STRAGGLER, NullTelemetry, Telemetry,
    beta_row)
