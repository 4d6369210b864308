from rtwc_tpu_torch.utils.telemetry import Telemetry, profiler_trace
from rtwc_tpu_torch.utils.timer import Timer

__all__ = ["Timer", "Telemetry", "profiler_trace"]
