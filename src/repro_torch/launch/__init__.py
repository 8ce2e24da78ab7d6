"""Step assembly (``repro.launch``): the train step and the serving
steps."""
