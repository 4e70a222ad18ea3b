"""repro_torch.train — the serving steps of the reference's
``repro.train.steps``; the train step comes with the training slice."""
