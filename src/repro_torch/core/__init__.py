"""The simulator core, ported: a copy of ``repro.core`` without JAX.

HLO parsing (``hlo``), the unified cost pipeline (``cost``, ``memory``),
the occupancy and O3 engines (``engine``, ``schedule``/``compiled``),
hardware parameter files (``hwspec``, with the ``H100`` test chip),
calibration on the card (``calibrate``), the multi-core node engine
(``node``, its batched passes also as a scan kernel on the card), and
reporting (``roofline``, ``pa``, ``simulate``), sampled estimation
(``sample``), the cluster engine (``cluster``), the model zoo with its
cluster drivers (``zoo``), DSE (``dse``) and the serving simulator
(``serving``).
"""
