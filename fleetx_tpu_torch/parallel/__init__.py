"""Data and context parallelism of the port over ``torch.distributed``."""
