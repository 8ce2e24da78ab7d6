"""The LM substrate of the port (``repro.models``): configs, parameter
trees, layers, the dense decoder-only LM and the zoo's entry points;
``convert`` carries weights to and from ``repro``."""
