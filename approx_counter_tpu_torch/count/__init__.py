from approx_counter_tpu_torch.count.exact import (  # noqa: F401
    exact_count_select,
    exact_count_select_rows,
)
