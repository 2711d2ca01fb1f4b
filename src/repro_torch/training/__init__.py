"""Training on one card: the optimizers, the train step, checkpoints and
the straggler monitor (ports of ``repro.training``)."""
