"""Substrate package: the roofline terms (``roofline``) and the op counter
that feeds them (``opcount``, the counterpart of ``repro.analysis.hlo``)."""
