"""repro_torch.serve: continuous-batching inference on a paged KV cache,
with staleness-bounded parameter replicas (counterpart of
``repro.serve``)."""
from repro_torch.serve.engine import (StepEngine,  # noqa: F401
                                      validate_paged_support)
from repro_torch.serve.paged_cache import (PageAllocator,  # noqa: F401
                                           PagedCacheConfig, init_page_pool)
from repro_torch.serve.replica import ParamReplica  # noqa: F401
from repro_torch.serve.sampling import SampleConfig, sample_tokens  # noqa: F401
from repro_torch.serve.scheduler import (ContinuousScheduler,  # noqa: F401
                                         Request)
