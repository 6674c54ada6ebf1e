"""Plain PyTorch of FAL-net, its MED head, the stage-1 loss and Adam: the
yardstick of the benchmark's correctness check.  Imports nothing of the
program under test."""
