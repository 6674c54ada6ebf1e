"""Host data path: normalization, stereo co-transforms, the bundled split
lists, the training dataset and the batch loader."""
