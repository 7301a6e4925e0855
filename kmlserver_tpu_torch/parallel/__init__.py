"""Multi-rank mining: one process per GPU under ``torch.distributed``."""
