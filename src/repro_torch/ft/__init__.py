"""Fault tolerance: failure plans and the recovery budget."""
