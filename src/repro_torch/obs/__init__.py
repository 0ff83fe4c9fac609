"""Runtime observability (copies of `repro.obs` trace, metrics and slo)."""
