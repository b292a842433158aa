"""repro_torch.launch — step builders and the LM serving driver."""
