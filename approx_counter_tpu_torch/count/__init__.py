# exact_count_select takes a row mask, so it also stands for the JAX
# package's exact_count_select_rows.
from approx_counter_tpu_torch.count.exact import exact_count_select  # noqa: F401
