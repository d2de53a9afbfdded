"""Shared observability machinery.

The counterpart of `kubernetes_tpu/obs/__init__.py`: the flight recorder's
idioms (O(1) per-batch taps on perf_counter, bounded record rings, windowed
log-bucket stage histograms with exact-while-complete percentiles, measured
self-time against a <2% budget), factored out of scheduler/flightrec.py so
the rest of the control plane inherits the same machinery:

  obs.recorder   — StageClock + RingRecorder (the generic bounded ring with
                   per-stage totals/histograms and the p50/p99 stage table).
  obs.reconcile  — ReconcileRecorder: per-loop reconcile spans for the
                   controllers (controllers/base.py), plus the
                   live-controller registry.
  obs.timeseries — TimeSeriesRecorder: fixed-interval windows over the batch
                   pipeline (per-stage p50/p99, pods/s, probe columns) plus
                   the fit_slope/drift_ratio trend math the leak gates in
                   scheduler/slo.py consume.
  obs.resource   — ResourceSampler: RSS / GC / live-object / per-thread CPU
                   sampling with a measured-clock honesty flag.
  obs.critpath   — the additive submit→bound decomposition of sampled pods.
  obs.tracebuf   — the trace-event ring and its Chrome export.
"""

from .recorder import (  # noqa: F401
    STAGE_P_BUCKETS,
    RingRecorder,
    StageClock,
    nearest_rank,
)
from .timeseries import (  # noqa: F401
    TimeSeriesRecorder,
    drift_ratio,
    fit_slope,
)
from .resource import ResourceSampler  # noqa: F401
