"""Drivers, one a traffic kind: `make(config, traffic, seed, device)`
returns a cell object (see portbench/harness.py)."""
