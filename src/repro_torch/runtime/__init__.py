"""The fault-tolerant runtime (port of ``repro.runtime``)."""
