"""Frame-recurrent training: the trainer, its optimizers, checkpoints and
the device-resident clip dataset."""
