"""training subpackage: MAP pretraining for warm starts."""
