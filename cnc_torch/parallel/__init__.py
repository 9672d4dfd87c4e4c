"""Data parallelism over rays (torch.distributed)."""
