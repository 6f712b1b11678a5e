"""Examples of gen_tpu_torch, runnable with ``python -m gen_tpu_torch.examples.<name>``."""
