"""Sharding annotations of program variables (no mesh in the port yet)."""
