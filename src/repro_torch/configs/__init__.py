"""repro_torch.configs — the workloads the port runs (heat3d)."""
