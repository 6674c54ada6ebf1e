"""Training: configs, the stage-1 loss, optimizer, checkpoints, the trainer."""
