"""Flight recorder: structured tracing, metrics, and audit manifests.

See DESIGN.md §14. Public surface:

- :func:`get_recorder` / :func:`install` / :class:`tracing` — the
  process-ambient recorder and the ``with tracing() as rec:`` entry
  point.
- :class:`TraceRecorder` / :class:`NullRecorder` / :class:`Span` — the
  recorder protocol.
- :class:`MetricsRegistry` — counters/histograms fed by the same
  instrumentation sites.
- ``manifest`` helpers — commit-anchored run manifests
  (``Catalog.run_manifest`` reads these back).
- ``export`` helpers — JSON and Chrome trace-event (Perfetto) output.

Invariant (test-gated): nothing in this package is consulted by
``engine.cache_key`` or any backend ``cache_token`` — tracing observes
execution, it never changes what executes or what a result hashes to.
"""
from repro_torch.obs.export import (
    to_chrome_trace,
    to_json,
    write_chrome_trace,
)
from repro_torch.obs.manifest import (
    MANIFEST_FORMAT,
    MANIFEST_REF_PREFIX,
    build_manifest,
    load_manifest,
    store_manifest,
)
from repro_torch.obs.metrics import NULL_METRICS, Counter, Histogram, MetricsRegistry
from repro_torch.obs.trace import (
    NullRecorder,
    Recorder,
    Span,
    TraceRecorder,
    get_recorder,
    install,
    tracing,
)

__all__ = [
    "Span", "Recorder", "NullRecorder", "TraceRecorder",
    "get_recorder", "install", "tracing",
    "Counter", "Histogram", "MetricsRegistry", "NULL_METRICS",
    "MANIFEST_REF_PREFIX", "MANIFEST_FORMAT",
    "build_manifest", "store_manifest", "load_manifest",
    "to_json", "to_chrome_trace", "write_chrome_trace",
]
