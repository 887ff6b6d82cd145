"""Flight recorder: structured tracing, metrics, and audit manifests.

See DESIGN.md §14. Public surface:

- :func:`get_recorder` / :func:`install` / :class:`tracing` — the
  process-ambient recorder and the ``with tracing() as rec:`` entry
  point.
- :class:`TraceRecorder` / :class:`NullRecorder` / :class:`Span` — the
  recorder protocol.
- :class:`MetricsRegistry` — counters/histograms fed by the same
  instrumentation sites, and device tallies (``MetricsRegistry.tally``)
  counted on the card without a sync.
- ``manifest`` helpers — commit-anchored run manifests
  (``Catalog.run_manifest`` reads these back).
- ``export`` helpers — JSON and Chrome trace-event (Perfetto) output.
- ``device_time`` — device time by a CUDA source's kernels
  (``device_ms``) and by span (``span_times``).

The model stack records spans too: ``model.forward`` /
``model.decode_step``, ``model.head``, ``attn.prefill`` /
``attn.decode``, ``moe.route`` / ``moe.dispatch`` / ``moe.experts`` /
``moe.combine``, with the tally ``moe.pairs_kept`` and the counter
``moe.slots``. While ``torch.profiler`` is on, every ``span()`` of a
:class:`TraceRecorder` is also a profiler range of its name, so
``torch.profiler`` around ``with tracing():`` gives one Chrome trace
(``prof.export_chrome_trace``) with the program's layers over the
device's kernels, and ``span_times`` the device and idle time of each
layer.

Invariant (test-gated): nothing in this package is consulted by
``engine.cache_key`` or any backend ``cache_token`` — tracing observes
execution, it never changes what executes or what a result hashes to.
Nor does it change a model's numbers: logits, K/V and caches are bitwise
the same with tracing on and off, and with it off the model stack opens
no range and launches nothing.
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
