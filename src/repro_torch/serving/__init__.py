from repro_torch.errors import (Backpressure, DeadlineExceeded, EngineError,
                                InternalError, InvalidRequest, NumericsError,
                                PoolExhausted, RequestTooLong,
                                SchedulerInvariantError)
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Status
from repro_torch.serving.sampler import (SampleParams, sample,
                                         validate_sample_params)
from repro_torch.serving.scheduler import Scheduler
