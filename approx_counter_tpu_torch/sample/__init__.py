from approx_counter_tpu_torch.sample.sampler import WindowBatch, sample_windows  # noqa: F401
