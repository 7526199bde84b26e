from repro_torch.serving.disagg import DisaggServer  # noqa: F401
from repro_torch.serving.engine import (Request, ServingEngine,  # noqa: F401
                                        sample_token)
from repro_torch.serving.errors import (DeadlineExceeded,  # noqa: F401
                                        EngineOverloaded, EngineRestarted,
                                        MigrationFailed, RequestCancelled,
                                        RequestShed, ServingError)
from repro_torch.serving.frontend import (AsyncFrontend,  # noqa: F401
                                          AsyncSession, FrontendClosed,
                                          PollResult)
from repro_torch.serving.migrate import (MigrationChannel,  # noqa: F401
                                         MigrationPayload)
from repro_torch.serving.paged import (CacheFull, PagedKVCache,  # noqa: F401
                                       blocks_for)
from repro_torch.serving.pd_sim import (ServingConfig,  # noqa: F401
                                        Workload, simulate)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.serving.scheduler import ContinuousEngine  # noqa: F401
from repro_torch.serving.session import AgentSession  # noqa: F401
from repro_torch.serving.spill import HostSpillTier  # noqa: F401
from repro_torch.serving.speculative import measure_accept_length  # noqa: F401
