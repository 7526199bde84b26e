from repro_torch.serving.engine import (Request, ServingEngine,  # noqa: F401
                                        sample_token)
from repro_torch.serving.errors import (DeadlineExceeded,  # noqa: F401
                                        EngineOverloaded, EngineRestarted,
                                        MigrationFailed, RequestCancelled,
                                        RequestShed, ServingError)
from repro_torch.serving.paged import (CacheFull, PagedKVCache,  # noqa: F401
                                       blocks_for)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.serving.scheduler import ContinuousEngine  # noqa: F401
