"""Serving, ported (the counterpart of ``repro.serving``): the host
continuous-batching scheduler with its hot-page tracker (``scheduler``,
``hot_pages``, ``study``) and the batched serving closed loop
(``loop``)."""
