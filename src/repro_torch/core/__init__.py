"""ParalleX runtime substrate (copies of `repro.core` localities, AGAS,
LCOs and parcels)."""
