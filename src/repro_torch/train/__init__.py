"""Training loop pieces (port of `repro.train`): the train step,
gradient compression, checkpoints and the fault-tolerance driver."""
