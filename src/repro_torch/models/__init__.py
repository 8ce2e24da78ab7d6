"""The LM substrate of the port (``repro.models``): configs, parameter
trees, layers, the decoder-only LM (dense, moe, ssm and hybrid
families), the encoder-decoder and the zoo's entry points; ``convert``
carries weights to and from ``repro``."""
