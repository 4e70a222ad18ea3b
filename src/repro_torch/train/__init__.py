"""repro_torch.train — the train step and the serving steps."""
