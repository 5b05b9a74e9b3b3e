"""Sharding types the port's store needs (the scale-out itself is not
ported yet)."""
