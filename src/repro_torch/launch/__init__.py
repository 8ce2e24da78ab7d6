"""Step assembly (``repro.launch``): the serving steps."""
