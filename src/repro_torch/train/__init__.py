"""Training: LR schedules, optimizers and the train step — the port of
`repro.train`."""
