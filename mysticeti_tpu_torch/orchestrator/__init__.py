"""The port's counterpart of ``mysticeti_tpu.orchestrator``: so far only the
scrape parser (``measurement.iter_series``) that the fleet health plane
reads ``/metrics`` texts with."""
