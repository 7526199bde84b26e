from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS_MS,  # noqa: F401
                                     Histogram, MetricsRegistry, StatsView)
from repro_torch.obs.trace import (Tracer,  # noqa: F401
                                   validate_chrome_trace, validate_trace_file)
