from approx_counter_tpu_torch.io.logging import Log  # noqa: F401
from approx_counter_tpu_torch.io.fastx import Reads, read_fastx  # noqa: F401
from approx_counter_tpu_torch.io.export import export_counter, print_counters  # noqa: F401
