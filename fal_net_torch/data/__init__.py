"""Host data helpers of the serving path (normalization)."""
