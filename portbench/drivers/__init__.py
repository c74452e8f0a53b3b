"""Drivers: one module per traffic ``kind``, found by name."""
