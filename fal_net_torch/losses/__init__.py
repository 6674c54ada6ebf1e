"""Losses of the stage-1 path: masked L1 (+ perceptual) reconstruction and
edge-aware smoothness.  The VGG19 perceptual network waits until its
weights are in the repository."""
