from approx_counter_tpu_torch.config.conf import parse_config  # noqa: F401
from approx_counter_tpu_torch.config.cli import build_parser, resolve_params  # noqa: F401
