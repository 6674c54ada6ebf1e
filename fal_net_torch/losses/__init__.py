"""Losses of the training stages: masked L1 (+ VGG19 perceptual)
reconstruction, edge-aware smoothness, and the sparse EPE of evaluation."""
